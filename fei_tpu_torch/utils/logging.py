"""Per-module loggers with env/config-driven level/file and rotation.

Parity with reference fei/utils/logging.py:12-118 (setup_logging, get_logger,
env-driven level/file, 10 MB x 5 rotation). Level/file resolution order:
explicit argument > ``FEI_TPU_LOG_LEVEL``/``FEI_TPU_LOG_FILE`` env > the
``[log]`` section of the layered Config > WARNING.
"""

from __future__ import annotations

import logging
import logging.handlers
import os
import sys
import threading

_LOCK = threading.Lock()
_CONFIGURED = False

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"
_MAX_BYTES = 10 * 1024 * 1024
_BACKUP_COUNT = 5


def _resolve(option: str) -> str | None:
    env = os.environ.get(f"FEI_TPU_LOG_{option.upper()}") or os.environ.get(
        f"FEI_LOG_{option.upper()}"
    )
    if env:
        return env
    try:
        from fei_tpu_torch.utils.config import get_config

        return get_config().get("log", option)
    except Exception:
        return None


def setup_logging(
    level: int | str | None = None,
    log_file: str | None = None,
    stream=None,
) -> logging.Logger:
    """Configure the root 'fei_tpu_torch' logger. Safe to call more than once."""
    global _CONFIGURED
    root = logging.getLogger("fei_tpu_torch")
    with _LOCK:
        if level is None:
            level = _resolve("level") or "WARNING"
        if isinstance(level, str):
            level = getattr(logging, level.upper(), logging.WARNING)
        root.setLevel(level)
        log_file = log_file or _resolve("file")
        root.handlers.clear()
        handler: logging.Handler = logging.StreamHandler(stream or sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(handler)
        if log_file:
            os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
            fh = logging.handlers.RotatingFileHandler(
                log_file, maxBytes=_MAX_BYTES, backupCount=_BACKUP_COUNT
            )
            fh.setFormatter(logging.Formatter(_FORMAT))
            root.addHandler(fh)
        root.propagate = False
        _CONFIGURED = True
    return root


def get_logger(name: str) -> logging.Logger:
    """Child logger under the 'fei_tpu_torch' root (stdlib loggers are already
    process-wide singletons; no extra cache needed)."""
    if not name.startswith("fei_tpu_torch"):
        name = f"fei_tpu_torch.{name}"
    with _LOCK:
        configured = _CONFIGURED
    if not configured:
        setup_logging()
    return logging.getLogger(name)
