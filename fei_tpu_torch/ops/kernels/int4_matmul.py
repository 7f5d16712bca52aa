"""Weight-only int4 matmul (K4): the CUDA kernel's wrapper and its plain version.

Counterpart of fei_tpu/ops/pallas/int4_matmul.py (``int4_mm`` over
``_int4_mm_kernel`` and ``_kernel``). The kernel is
``fei_tpu_torch/csrc/int4_matmul.cu`` (CUDA C++ for sm_90a, wgmma in every
product: for M <= 16 a fixed split of K into segments with an ordered
reduction, for larger M a loader warpgroup that dequantizes a cp.async ring
of packed bytes while two warpgroups multiply); its header says what bounds
it and what the design does about it.

``int4_mm`` launches the kernel for CUDA tensors and raises, naming the
shape or the type, where the kernel cannot take them — there is no
fallback on the card. Tensors on the CPU take the plain version
(``int4_mm_reference``). ``int4_mm.launches`` counts kernel launches.
``int4_mm_sharded`` is the tensor-parallel wrapper (K4 on the rank's
output columns, gathered).
``int4_mm_tolerance`` is the per-element bound the kernel is held to
against the plain version. ``split_plan`` is the kernel's cut of the
contraction into segments, summed in order, which depends on K alone.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from fei_tpu_torch.ops.kernels import build
from fei_tpu_torch.ops.quant import QTensor4, unpack4

KERNEL = "int4_matmul"
SEGMENT = 256  # packed rows per segment of the contraction (csrc/int4_matmul.cu SEG)
SPLIT_MAX_M = 16  # up to this many rows the kernel splits K across blocks

_FN = None
_COUNT_LOCK = threading.Lock()  # concurrent requests launch from threads


def _kernel():
    """The C entry point with its argument types (pointers and the stream
    as c_void_p so ctypes never truncates them to 32 bits)."""
    global _FN
    if _FN is None:
        lib = build.load(KERNEL)
        fn = lib.fei_int4_matmul
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        i64 = ctypes.c_longlong
        fn.argtypes = [vp, i64, vp, vp, vp, vp, i64, i32, i32, i32, i32, vp]
        fn.restype = ctypes.c_int
        lib.fei_cuda_error_string.argtypes = [ctypes.c_int]
        lib.fei_cuda_error_string.restype = ctypes.c_char_p
        _FN = (fn, lib.fei_cuda_error_string)
    return _FN


def _planes(w: QTensor4) -> tuple[torch.Tensor, torch.Tensor]:
    """The two bf16 weight planes [K/2, N] the kernel multiplies: each
    nibble times its group's fp32 scale, rounded to bf16."""
    K2, N = w.p.shape
    G = w.s.shape[0]
    gs = w.group_size
    lo, hi = unpack4(w.p)

    def scaled(plane, s_half):
        grouped = plane.float().reshape(G // 2, gs, N) * s_half[:, None, :]
        return grouped.reshape(K2, N).to(torch.bfloat16)

    return scaled(lo, w.s[: G // 2]), scaled(hi, w.s[G // 2:])


def int4_mm_reference(x: torch.Tensor, w: QTensor4) -> torch.Tensor:
    """The kernel's function in plain PyTorch: bf16 x against the two bf16
    planes, each half-contraction in fp32, the sum cast to x's dtype (the
    JAX fallback ``int4_mm_xla``'s arithmetic). Any leading dims of x."""
    K2 = w.p.shape[0]
    w_lo, w_hi = _planes(w)
    xb = x.to(torch.bfloat16).float()
    out = xb[..., :K2] @ w_lo.float() + xb[..., K2:] @ w_hi.float()
    return out.to(x.dtype)


def int4_mm_tolerance(x: torch.Tensor, w: QTensor4) -> torch.Tensor:
    """Per-element bound on |kernel - int4_mm_reference(x.float(), w)|.

    Both use the same bf16 weight values (the nibble times its fp32 scale,
    rounded to bf16, is exact IEEE arithmetic on either side), so they
    differ by two things only: the kernel rounds its fp32 sum to bf16 (at
    most half an ulp; one ulp of |reference| also covers a result that
    rounds across a power of two), and the two sum K products in another
    order, which moves an fp32 sum by at most K * 2^-24 * sum_k |x_k w_k|."""
    K2 = w.p.shape[0]
    w_lo, w_hi = _planes(w)
    xb = x.to(torch.bfloat16).float()
    ref = xb[..., :K2] @ w_lo.float() + xb[..., K2:] @ w_hi.float()
    absdot = xb[..., :K2].abs() @ w_lo.float().abs() + xb[..., K2:].abs() @ w_hi.float().abs()
    _, exp = torch.frexp(ref.abs().clamp_min(2.0 ** -126))
    ulp = torch.ldexp(torch.ones_like(ref), exp - 8)  # bf16 keeps 8 significant bits
    return ulp + 2 * K2 * 2.0 ** -24 * absdot


@functools.lru_cache(maxsize=None)
def split_plan(K: int) -> tuple[tuple[int, int], ...]:
    """The kernel's segments of the packed contraction rows, ``((start,
    stop), ...)`` over ``range(K // 2)``: each output element sums every
    segment in a fresh fp32 accumulator (16-row steps from its first row,
    the low plane's step before the high plane's) and adds the segments
    into a total that starts at 0, in this order. A function of K alone, so
    that a row's sum does not depend on M or on which kernel the call
    takes; for M <= ``SPLIT_MAX_M`` the segments run on separate blocks."""
    K2 = K // 2
    return tuple((a, min(a + SEGMENT, K2)) for a in range(0, K2, SEGMENT))


def _check(x2d: torch.Tensor, w: QTensor4) -> None:
    """Raise, naming the shape or type, on anything the kernel does not take."""
    M, K = x2d.shape
    K2, N = w.p.shape
    shape = f"x [{M}, {K}] @ int4 [{K}, {N}] (group {w.group_size})"
    if K % 256 or N % 8:
        raise ValueError(f"int4_mm kernel: {shape}: needs K % 256 == 0 and N % 8 == 0")
    if w.group_size % 128 or K2 % w.group_size:
        raise ValueError(f"int4_mm kernel: {shape}: needs a group size that is a "
                         "multiple of 128 and divides K/2")
    if w.p.dtype != torch.int8 or w.s.dtype != torch.float32:
        raise TypeError(f"int4_mm kernel: packed bytes must be int8 and scales "
                        f"float32; got {w.p.dtype}/{w.s.dtype}")
    for name, t in (("packed bytes", w.p), ("scales", w.s)):
        if t.device != x2d.device:
            raise ValueError(f"int4_mm kernel: {name} on {t.device}, x on {x2d.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int4_mm kernel: {name} must be contiguous and 16-byte aligned")
    if x2d.stride(1) != 1 or x2d.stride(0) % 8 or x2d.data_ptr() % 16:
        raise ValueError(f"int4_mm kernel: {shape}: x rows must be contiguous and "
                         f"16-byte aligned (strides {tuple(x2d.stride())})")


def int4_mm(x: torch.Tensor, w: QTensor4) -> torch.Tensor:
    """``x @ dequant(w)`` for a per-layer [K/2, N] ``QTensor4``; any leading
    dims of x. Returns x's dtype (the kernel computes on bf16 x and rounds
    its output to bf16, as the Pallas kernel does).

    CUDA tensors run the kernel on the current stream; CPU tensors run
    ``int4_mm_reference``."""
    if w.p.dim() != 2:
        raise ValueError(f"int4_mm expects a per-layer [K/2, N] QTensor4, got {tuple(w.p.shape)}")
    *lead, K = x.shape
    K2, N = w.p.shape
    if K != 2 * K2:
        raise ValueError(f"contraction mismatch: x {K} vs packed {2 * K2}")
    if x.device.type == "cpu":
        return int4_mm_reference(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"int4_mm runs on cuda or cpu, not {x.device}")
    x2d = x.reshape(-1, K).to(torch.bfloat16)
    _check(x2d, w)
    M = x2d.shape[0]
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return out.reshape(*lead, N).to(x.dtype)
    fn, err_str = _kernel()
    # the split's fp32 partial sums, one [M, N] slab per segment (the kernel
    # refuses scratch of any other size than its own plan's)
    part = (torch.empty((len(split_plan(K)), M, N), dtype=torch.float32, device=x.device)
            if M <= SPLIT_MAX_M else None)
    part_elems = 0 if part is None else part.numel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x2d.data_ptr(), x2d.stride(0), w.p.data_ptr(), w.s.data_ptr(),
                 out.data_ptr(), None if part is None else part.data_ptr(), part_elems,
                 M, N, K, w.group_size, stream)
    if err != 0:
        raise RuntimeError(f"int4_matmul launch failed: {err_str(err).decode()} ({err})")
    with _COUNT_LOCK:
        int4_mm.launches += 1
    return out.reshape(*lead, N).to(x.dtype)


int4_mm.launches = 0


def int4_mm_sharded(x: torch.Tensor, w: QTensor4, mesh, axis_name: str = "tp") -> torch.Tensor:
    """Tensor-parallel int4 matmul for a whole (replicated) ``QTensor4``:
    each rank runs K4 on its 1/tp of the output columns (packed bytes and
    scales sliced alike; the contraction axis is never split, nibble
    pairs span it), and the columns are all-gathered in rank order; the
    rows of x split over dp where they divide. Returns every column."""
    n = mesh.shape[axis_name]
    N = w.p.shape[-1]
    if N % n:
        raise ValueError(f"int4_mm_sharded: {N} output columns do not divide over "
                         f"{axis_name}={n}")
    step = N // n
    cols = slice(mesh.coords[axis_name] * step, (mesh.coords[axis_name] + 1) * step)
    local = QTensor4(p=w.p[..., cols].contiguous(), s=w.s[..., cols].contiguous())
    dp = mesh.shape["dp"]
    split = dp > 1 and x.shape[0] % dp == 0
    if split:
        m = x.shape[0] // dp
        x = x[mesh.coords["dp"] * m:(mesh.coords["dp"] + 1) * m]
    out = mesh.all_gather(int4_mm(x, local), axis_name, dim=-1)
    if split:
        out = mesh.all_gather(out, "dp", dim=0)
    return out
