"""ctypes binding for the native scan engine.

``grep_files(files, pattern, max_results)`` returns a list of
(path, line_number, line_text) or **None** when the native path does not
apply — regex patterns (Python re semantics stay authoritative), build
failure, or the engine being disabled — in which case the caller falls back
to the pure-Python scan. Fixed-string patterns (no regex metacharacters) are
the agent's common case and the one worth accelerating.

A copy of ``fei_tpu/native/scan.py`` that imports only the port.
"""

from __future__ import annotations

import ctypes
import os
import threading

_META = set(".^$*+?{}[]|()\\")

# the line pointer must be POINTER(c_char), not c_char_p: a NUL byte inside
# a line (files can pass the 4 KiB binary sniff and still contain one) would
# truncate a c_char_p and make string_at read past the shortened buffer
_CB_TYPE = ctypes.CFUNCTYPE(
    None, ctypes.c_char_p, ctypes.c_int32,
    ctypes.POINTER(ctypes.c_char), ctypes.c_int32,
)

_lib = None
_lib_lock = threading.Lock()
_ABI = 1


def _load():
    global _lib
    if _lib is not None:
        return _lib if _lib is not False else None
    with _lib_lock:
        if _lib is not None:
            return _lib if _lib is not False else None
        if os.environ.get("FEI_TPU_NATIVE", "1") == "0":
            _lib = False
            return None
        try:
            from fei_tpu_torch.native.build import lib_path

            path = lib_path()
            if path is None:
                _lib = False
                return None
            lib = ctypes.CDLL(path)
            if lib.fei_native_abi_version() != _ABI:
                _lib = False
                return None
            lib.fei_grep_files.restype = ctypes.c_int32
            lib.fei_grep_files.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_int32, ctypes.c_int32, _CB_TYPE,
            ]
            _lib = lib
        except Exception:  # noqa: BLE001 — native is always best-effort
            _lib = False
            return None
    return _lib


def is_fixed_string(pattern: str) -> bool:
    return not any(c in _META for c in pattern)


def grep_files(
    files: list[str], pattern: str, max_results: int = 1000
) -> list[tuple[str, int, str]] | None:
    if not files or not pattern or not is_fixed_string(pattern):
        return None
    # the C ABI joins paths with '\n'; a (legal, bizarre) newline in a
    # filename would silently split into bogus paths — full Python fallback
    if any("\n" in f for f in files):
        return None
    lib = _load()
    if lib is None:
        return None

    results: list[tuple[str, int, str]] = []

    @_CB_TYPE
    def on_match(path: bytes, line_no: int, line: bytes, line_len: int):
        text = ctypes.string_at(line, line_len).decode("utf-8", errors="replace")
        results.append((os.fsdecode(path), line_no, text))

    joined = "\n".join(files).encode("utf-8", errors="surrogateescape")
    rc = lib.fei_grep_files(
        joined, pattern.encode("utf-8"), max_results, 0, on_match
    )
    if rc < 0:
        return None
    return results
