"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of fei_tpu/ops/pallas/flash_attention.py (``flash_attention``,
the inference primal ``_fwd_impl(save_lse=False)`` over ``_fwd_kernel``).
The kernel is ``fei_tpu_torch/csrc/flash_attention_fwd.cu`` (CUDA C++ for
sm_90a, mma.sync tensor-core tiles, live-tile-only k loop); its header says
what bounds it and what the design does about it.

``flash_attention`` launches the kernel for CUDA tensors and raises when it
cannot; it takes the plain version (``flash_attention_reference``) only for
tensors on the CPU. ``flash_attention.launches`` counts kernel launches.
``flash_attention_tolerance`` is the per-element bound the kernel is held
to against the plain version.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from fei_tpu_torch.ops.attention import attention, attention_probs, visible_mask
from fei_tpu_torch.ops.kernels import build

KERNEL = "flash_attention_fwd"
HEAD_DIMS = (64, 80, 128, 256)

_FN = None
_COUNT_LOCK = threading.Lock()  # concurrent requests launch from threads


def _kernel():
    """The C entry point with its argument types (pointers and the stream
    as c_void_p so ctypes never truncates them to 32 bits)."""
    global _FN
    if _FN is None:
        lib = build.load(KERNEL)
        fn = lib.fei_flash_attention_fwd
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = (
            [vp] * 6 + [i32] * 6 + [i64] * 12 + [i32, ctypes.c_float, vp]
        )
        fn.restype = ctypes.c_int
        lib.fei_cuda_error_string.argtypes = [ctypes.c_int]
        lib.fei_cuda_error_string.restype = ctypes.c_char_p
        _FN = (fn, lib.fei_cuda_error_string)
    return _FN


def flash_attention_reference(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, S, K, D]
    v: torch.Tensor,
    q_start: torch.Tensor,  # [B] int: absolute position of the first query
    kv_length: torch.Tensor,  # [B] int: valid kv prefix (after cache write)
    scale: float | None = None,
    window: int = 0,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel: ``ops.attention.attention``
    at positions ``q_start + arange(T)``, with the kernel's rule that a
    query row with no live key is zeros."""
    T = q.shape[1]
    positions = q_start.to(torch.long)[:, None] + torch.arange(T, device=q.device)[None, :]
    out = attention(q, k, v, positions, kv_length, scale=scale, window=window)
    live = visible_mask(positions, kv_length, k.shape[1], window).any(dim=-1)
    return torch.where(live[:, :, None, None], out, torch.zeros_like(out))


def flash_attention_tolerance(q, k, v, q_start, kv_length, scale=None, window=0):
    """Per-element bound [B, T, H, D] on |kernel - reference| for bf16
    inputs, where the reference is ``flash_attention_reference`` in fp32 on
    the same values.

    The kernel differs from it by two roundings. It rounds each softmax
    weight p_j to bf16 before the P.V product (as the Pallas kernel casts
    p): an error of at most 2^-8 p_j |v_j| per key, independent from key
    to key. Four times the root-sum-square of those bounds is exceeded
    with a chance below 1e-10 per element (a rounding error is uniform,
    hence sub-Gaussian with its own variance), and it covers the worst
    case outright for rows of up to 16 keys. It then rounds the output to
    bf16, half an ulp; two ulps of |reference| also cover the fp32
    products' summation order. The bound follows each element's own size,
    so the many small outputs of long rows are held as tightly as the
    largest one."""
    T = q.shape[1]
    positions = q_start.to(torch.long)[:, None] + torch.arange(T, device=q.device)[None, :]
    probs = attention_probs(q, k, positions, kv_length, scale, window)
    spread = torch.einsum("btkgs,bskd->btkgd", probs.square(), v.float().square()).sqrt()
    del probs
    live = visible_mask(positions, kv_length, k.shape[1], window).any(dim=-1)
    spread = spread.reshape(q.shape) * live[:, :, None, None]
    ref = flash_attention_reference(q.float(), k.float(), v.float(), q_start, kv_length,
                                    scale, window)
    _, exp = torch.frexp(ref.abs().clamp_min(2.0 ** -126))
    ulp = torch.ldexp(torch.ones_like(ref), exp - 8)  # bf16 keeps 8 significant bits
    return 2 * ulp + 4 * 2.0 ** -8 * spread


def _check(q, k, v, q_start, kv_length, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q [B,T,H,D] and k, v [B,S,K,D]")
    B, T, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"q heads {H} are not a multiple of kv heads {k.shape[2]}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one the kernel is built for {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the kernel takes bf16; {name} is {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    for name, t in (("q_start", q_start), ("kv_length", kv_length)):
        if t.device != q.device or t.dtype != torch.int32 or t.shape != (B,):
            raise ValueError(f"{name} must be int32 [{B}] on {q.device}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def flash_attention(
    q: torch.Tensor,  # [B, T, H, D] bf16
    k: torch.Tensor,  # [B, S, K, D] bf16 (the whole cache buffer)
    v: torch.Tensor,
    q_start: torch.Tensor,  # [B] int32
    kv_length: torch.Tensor,  # [B] int32
    scale: float | None = None,
    window: int = 0,
) -> torch.Tensor:
    """Causal (optionally windowed) GQA attention against a KV buffer: key
    s is visible to the query at p = q_start + t iff s <= p, s < kv_length
    and, with ``window``, s > p - window. Returns [B, T, H, D] in q's dtype.

    CUDA tensors run the kernel on the current stream; CPU tensors run
    ``flash_attention_reference``."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, q_start, kv_length, scale, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    _check(q, k, v, q_start, kv_length, window)
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if T == 0:
        return out
    fn, err_str = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            q_start.data_ptr(), kv_length.data_ptr(),
            B, T, H, S, K, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            int(window), float(D ** -0.5 if scale is None else scale), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash_attention_fwd launch failed: {err_str(err).decode()} ({err})"
        )
    with _COUNT_LOCK:
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
