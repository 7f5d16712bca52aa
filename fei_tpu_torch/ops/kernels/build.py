"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each source ``fei_tpu_torch/csrc/<name>.cu`` exposes a plain C interface
and is compiled on its own into ``build/fei_tpu_torch/lib<name>_<hash>.so``
at the repository root, where ``<hash>`` covers the source bytes, the
shared headers beside it and the compiler flags: an edited source builds anew, an unchanged one loads the
library already there. Nothing is built when a module is imported — only
when a kernel is first launched, or when a caller (``chip_smoke.py``)
asks for the build up front.

Each library's first load in the process goes through ``COMPILES``, a
``CompileObserver`` (obs/flight.py): it counts ``engine.compiles`` and
times the build or the cache hit into ``compile_seconds``; loading a name
again after its handle was dropped from ``_LOADED`` counts as
``engine.recompiles``, which must read zero once the kernels are warm.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

from fei_tpu_torch.obs.flight import CompileObserver

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "fei_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}
# the kernel libraries are process-wide, so one observer counts their loads
COMPILES = CompileObserver()


@dataclass
class BuildResult:
    name: str
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output (-Xptxas=-v: registers, shared memory, spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA toolkit is needed "
        "to build the fei_tpu_torch kernels"
    )


def library_path(name: str) -> Path:
    """The library's path; its hash covers the source, every shared header
    in csrc/ (``*.cuh``) and the flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str) -> BuildResult:
    """Compile ``csrc/<name>.cu`` unless it is built already; raises with
    nvcc's output if the compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = library_path(name)
    if out.exists():
        return BuildResult(name, out, 0.0, "")
    # compile to a private name, then rename: a concurrent process never
    # loads a half-written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"kernel build failed: {name}: nvcc exited "
                           f"{proc.returncode}\n{proc.stdout}")
    os.replace(tmp, out)
    return BuildResult(name, out, time.perf_counter() - t0, proc.stdout)


def _build_and_open(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name).path))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = _LOADED[name] = COMPILES.wrap("kernel", name, _build_and_open)(name)
        return lib
