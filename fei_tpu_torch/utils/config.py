"""Layered, schema-validated configuration.

Parity with reference fei/utils/config.py:45-701: a typed schema, an INI file
(default ``~/.fei_tpu.ini``), ``.env`` files, and environment variables, with
precedence **env > config file > schema default** (reference config.py:406-468)
and env lookups of the form ``FEI_TPU_<SECTION>_<OPTION>`` plus
``{PROVIDER}_API_KEY`` / ``LLM_API_KEY`` fallbacks (reference config.py:470-501).

Differences from the reference (deliberate fixes, see SURVEY.md appendix):
  - no global mutable singleton required for tests — ``Config`` instances are
    independent; ``get_config()`` is a convenience cache that tests can reset.
  - ``.env`` parsing never overrides variables already set in the process
    environment (reference preserved this too, config.py:320-365).
"""

from __future__ import annotations

import configparser
import os
import stat
import threading
from dataclasses import dataclass
from typing import Any, Callable

from fei_tpu_torch.utils.errors import ConfigError

# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------


@dataclass
class ConfigValue:
    """One schema'd option: type, default, optional validator/choices."""

    type: type = str
    default: Any = None
    choices: tuple | None = None
    validator: Callable[[Any], bool] | None = None
    secret: bool = False
    description: str = ""

    def coerce(self, raw: Any) -> Any:
        if raw is None:
            return None
        if self.type is bool:
            if isinstance(raw, bool):
                val = raw
            else:
                s = str(raw).strip().lower()
                if s in ("1", "true", "yes", "on"):
                    val = True
                elif s in ("0", "false", "no", "off"):
                    val = False
                else:
                    raise ConfigError(f"cannot parse boolean from {raw!r}")
        elif self.type is int:
            try:
                val = int(raw)
            except (TypeError, ValueError) as e:
                raise ConfigError(f"cannot parse int from {raw!r}") from e
        elif self.type is float:
            try:
                val = float(raw)
            except (TypeError, ValueError) as e:
                raise ConfigError(f"cannot parse float from {raw!r}") from e
        else:
            val = str(raw)
        if self.choices is not None and val not in self.choices:
            raise ConfigError(f"{val!r} not in allowed choices {self.choices}")
        if self.validator is not None and not self.validator(val):
            raise ConfigError(f"{val!r} failed validation")
        return val


# Mirrors the reference CONFIG_SCHEMA (config.py:45-72) plus engine options the
# TPU build introduces.
CONFIG_SCHEMA: dict[str, dict[str, ConfigValue]] = {
    "llm": {
        "provider": ConfigValue(str, "jax_local", description="LLM provider id"),
        "model": ConfigValue(str, "llama3-8b", description="model id for the provider"),
        "max_tokens": ConfigValue(int, 4000),
        "temperature": ConfigValue(float, 0.0),
        "top_p": ConfigValue(float, 1.0),
        "api_key": ConfigValue(str, None, secret=True),
    },
    "engine": {
        "checkpoint_dir": ConfigValue(str, None, description="dir with safetensors weights"),
        "tokenizer": ConfigValue(str, "byte", description="'byte' or path to tokenizer.json"),
        "max_seq_len": ConfigValue(int, 8192),
        "kv_page_size": ConfigValue(int, 128),
        "dtype": ConfigValue(str, "bfloat16", choices=("bfloat16", "float32", "float16")),
        "mesh_shape": ConfigValue(str, "", description="e.g. 'dp=1,tp=8'; empty = auto"),
        "use_pallas": ConfigValue(bool, True),
    },
    "jax_local": {
        "model": ConfigValue(str, "llama3-1b", description="engine model config name"),
        "checkpoint_dir": ConfigValue(str, None, description="HF safetensors dir"),
        "tokenizer": ConfigValue(str, None, description="'byte' or local tokenizer path"),
        "max_seq_len": ConfigValue(int, 8192),
        "paged": ConfigValue(bool, False, description="paged pool + continuous batching"),
        "batch_size": ConfigValue(int, 1, description="concurrent decode slots (paged)"),
        # modes validated by the engine (loud EngineError); no choices here
        # so a blank INI line means unset rather than a ConfigError
        "quantize": ConfigValue(str, None, description="weight-only 'int8' or 'int4'"),
        "kv_quant": ConfigValue(str, None, description="int8 KV pages ('int8', paged)"),
        "prefix_cache": ConfigValue(bool, False, description="reuse shared prompt-prefix pages (paged)"),
    },
    # the PyTorch/CUDA engine (fei_tpu_torch.agent.providers.TorchLocalProvider):
    # the same options as [jax_local]
    "torch_local": {
        "model": ConfigValue(str, "llama3-1b", description="engine model config name"),
        "checkpoint_dir": ConfigValue(str, None, description="HF safetensors dir"),
        "tokenizer": ConfigValue(str, None, description="'byte' or local tokenizer path"),
        "max_seq_len": ConfigValue(int, 8192),
        "paged": ConfigValue(bool, False, description="paged pool + continuous batching"),
        "batch_size": ConfigValue(int, 1, description="concurrent decode slots (paged)"),
        "quantize": ConfigValue(str, None, description="weight-only 'int8' or 'int4'"),
        "kv_quant": ConfigValue(str, None, description="int8 KV pages ('int8', paged)"),
        "prefix_cache": ConfigValue(bool, False, description="reuse shared prompt-prefix pages (paged)"),
    },
    "memdir": {
        "base_dir": ConfigValue(str, None),
        "server_url": ConfigValue(str, "http://localhost:5000"),
        "api_key": ConfigValue(str, None, secret=True),
        "port": ConfigValue(int, 5000),
    },
    "memorychain": {
        "node_url": ConfigValue(str, "http://localhost:6789"),
        "port": ConfigValue(int, 6789),
        "difficulty": ConfigValue(int, 2),
    },
    "tools": {
        "shell_allow": ConfigValue(str, "", description="extra comma-separated allowed commands"),
        "backup_dir": ConfigValue(str, ".fei_backups"),
    },
    "log": {
        "level": ConfigValue(str, "WARNING"),
        "file": ConfigValue(str, None),
    },
}

_ENV_PREFIX = "FEI_TPU"


def _parse_env_file(path: str) -> dict[str, str]:
    out: dict[str, str] = {}
    try:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                key, _, value = line.partition("=")
                key = key.strip()
                value = value.strip().strip("'\"")
                if key:
                    out[key] = value
    except OSError:
        pass
    return out


class Config:
    """Layered config. Precedence: env > config file > schema default."""

    def __init__(
        self,
        config_path: str | None = None,
        env_files: list[str] | None = None,
        environ: dict[str, str] | None = None,
    ):
        self._lock = threading.RLock()
        self._environ = environ if environ is not None else os.environ
        self.config_path = config_path or os.path.join(
            os.path.expanduser("~"), ".fei_tpu.ini"
        )
        self._parser = configparser.ConfigParser()
        if os.path.exists(self.config_path):
            self._secure_path(self.config_path)
            self._parser.read(self.config_path)
        # .env files: defaults mirror the reference's 3 locations
        # (reference config.py:320-365): cwd, ~/.fei_tpu/.env, package dir.
        if env_files is None:
            env_files = [
                os.path.join(os.getcwd(), ".env"),
                os.path.join(os.path.expanduser("~"), ".fei_tpu", ".env"),
            ]
        self._dotenv: dict[str, str] = {}
        for path in env_files:
            self._dotenv.update(_parse_env_file(path))

    # -- helpers ------------------------------------------------------------

    @staticmethod
    def _secure_path(path: str) -> None:
        """chmod g/o-rw on secret-bearing files (reference config.py:293-318)."""
        try:
            mode = os.stat(path).st_mode
            os.chmod(path, mode & ~(stat.S_IRWXG | stat.S_IRWXO))
        except OSError:
            pass

    def _schema_for(self, section: str, option: str) -> ConfigValue | None:
        return CONFIG_SCHEMA.get(section, {}).get(option)

    def _get_env(self, key: str) -> str | None:
        """Process env wins over .env files. Empty string counts as unset so
        ``FEI_TPU_X=`` in CI falls through to file/default."""
        val = self._environ.get(key)
        if val is None:
            val = self._dotenv.get(key)
        return val if val else None

    def _get_from_env(self, section: str, option: str) -> str | None:
        """FEI_TPU_<SECTION>_<OPTION>; api keys additionally try
        {PROVIDER}_API_KEY then LLM_API_KEY (reference config.py:470-501)."""
        val = self._get_env(f"{_ENV_PREFIX}_{section.upper()}_{option.upper()}")
        if val is not None:
            return val
        if option == "api_key":
            if section == "llm":
                provider = self.get("llm", "provider")
                val = self._get_env(f"{str(provider).upper()}_API_KEY")
                if val is not None:
                    return val
                return self._get_env("LLM_API_KEY")
            val = self._get_env(f"{section.upper()}_API_KEY")
            if val is not None:
                return val
        return None

    # -- public API ---------------------------------------------------------

    def get(self, section: str, option: str, fallback: Any = None) -> Any:
        """Resolve with precedence env > file > schema default > fallback."""
        with self._lock:
            schema = self._schema_for(section, option)
            env_val = self._get_from_env(section, option)
            if env_val is not None:
                return schema.coerce(env_val) if schema else env_val
            if self._parser.has_option(section, option):
                raw = self._parser.get(section, option)
                return schema.coerce(raw) if schema else raw
            if schema is not None and schema.default is not None:
                return schema.default
            return fallback

    def get_int(self, section: str, option: str, fallback: int = 0) -> int:
        val = self.get(section, option, fallback)
        return int(val) if val is not None else fallback

    def get_float(self, section: str, option: str, fallback: float = 0.0) -> float:
        val = self.get(section, option, fallback)
        return float(val) if val is not None else fallback

    def get_bool(self, section: str, option: str, fallback: bool = False) -> bool:
        val = self.get(section, option, fallback)
        if isinstance(val, bool):
            return val
        return ConfigValue(bool).coerce(val) if val is not None else fallback

    def set(self, section: str, option: str, value: Any) -> None:
        """Validate against schema and persist to the INI file
        (reference config.py:503-578)."""
        if value is None:
            # Persisting None would write an empty string that poisons typed
            # reads; treat as removal instead.
            self.delete(section, option)
            return
        with self._lock:
            schema = self._schema_for(section, option)
            if schema is not None:
                value = schema.coerce(value)
            if not self._parser.has_section(section):
                self._parser.add_section(section)
            self._parser.set(section, option, str(value))
            self._persist()

    def delete(self, section: str, option: str) -> bool:
        with self._lock:
            if self._parser.has_option(section, option):
                self._parser.remove_option(section, option)
                self._persist()
                return True
            return False

    def _persist(self) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(self.config_path)), exist_ok=True)
        with open(self.config_path, "w", encoding="utf-8") as f:
            self._parser.write(f)
        self._secure_path(self.config_path)

    def as_dict(self) -> dict[str, dict[str, Any]]:
        out: dict[str, dict[str, Any]] = {}
        for section, options in CONFIG_SCHEMA.items():
            out[section] = {}
            for option, schema in options.items():
                val = self.get(section, option)
                out[section][option] = "****" if (schema.secret and val) else val
        return out


_SINGLETON: Config | None = None
_SINGLETON_LOCK = threading.Lock()


def get_config(reload: bool = False) -> Config:
    """Convenience process-wide config (reference config.py:240). Tests should
    construct Config directly instead."""
    global _SINGLETON
    with _SINGLETON_LOCK:
        if _SINGLETON is None or reload:
            _SINGLETON = Config()
        return _SINGLETON


def reset_config() -> None:
    global _SINGLETON
    with _SINGLETON_LOCK:
        _SINGLETON = None
