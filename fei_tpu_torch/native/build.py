"""On-demand build of the native scan engine (a copy of
fei_tpu/native/build.py with a cache of its own).

No pybind11 in the image, so the binding is plain C ABI + ctypes; the build
is one g++ invocation, cached under ``build/fei_tpu_torch/native`` beside
the package (``FEI_TPU_NATIVE_CACHE`` moves it) keyed by a hash of the
source and compiler, so the first import after a source change rebuilds and
every later import is a dlopen. The JAX package caches under
``~/.fei_tpu/native``, so the two builds never share a file.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading

from fei_tpu_torch.utils.logging import get_logger

log = get_logger("native.build")

_SRC = os.path.join(os.path.dirname(__file__), "scanner.cpp")
_CACHE_DIR = os.path.expanduser(os.environ.get(
    "FEI_TPU_NATIVE_CACHE",
    os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "..", "..", "build", "fei_tpu_torch", "native")),
))
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-D_GNU_SOURCE"]
_lock = threading.Lock()


def _compiler() -> str | None:
    for cc in (os.environ.get("CXX"), "g++", "clang++"):
        if cc and shutil.which(cc):
            return cc
    return None


def lib_path() -> str | None:
    """Path to the built .so, building it if needed; None if unbuildable."""
    cc = _compiler()
    if cc is None:
        log.info("no C++ compiler found; native scan disabled")
        return None
    try:
        with open(_SRC, "rb") as fh:
            digest = hashlib.sha256(
                fh.read() + cc.encode() + " ".join(_FLAGS).encode()
            ).hexdigest()[:16]
    except OSError:
        return None
    out = os.path.join(_CACHE_DIR, f"_scanner-{digest}.so")
    if os.path.exists(out):
        return out
    with _lock:
        if os.path.exists(out):
            return out
        os.makedirs(_CACHE_DIR, exist_ok=True)
        tmp = out + ".tmp"
        cmd = [cc, *_FLAGS, _SRC, "-o", tmp]
        try:
            subprocess.run(
                cmd, check=True, capture_output=True, text=True, timeout=120
            )
            os.replace(tmp, out)  # atomic publish
        except (subprocess.SubprocessError, OSError) as exc:
            detail = getattr(exc, "stderr", "") or str(exc)
            log.warning("native scanner build failed: %s", detail.strip()[:500])
            return None
    log.info("built native scanner: %s", out)
    return out
