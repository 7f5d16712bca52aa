"""Native (C++) runtime components, bound via ctypes with pure-Python
fallbacks everywhere — the package works identically without a compiler.

- scan: multi-threaded fixed-string grep engine (scanner.cpp), the agent's
  hottest host-side loop. Regex search stays in Python (re semantics are
  authoritative); the native path accelerates identifier-style searches.

Disable entirely with FEI_TPU_NATIVE=0.

A copy of ``fei_tpu/native/__init__.py`` that imports only the port.
"""

from fei_tpu_torch.native import scan

__all__ = ["scan"]
