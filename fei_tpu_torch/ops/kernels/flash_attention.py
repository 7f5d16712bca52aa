"""Flash attention, forward and backward: the CUDA kernels' wrappers and
their plain versions.

Counterpart of fei_tpu/ops/pallas/flash_attention.py: ``flash_attention``
(the inference primal ``_fwd_impl(save_lse=False)`` over ``_fwd_kernel``)
and its ``custom_vjp`` (``_fwd_impl(save_lse=True)``, ``_bwd_impl`` over
``_dq_kernel`` and ``_dkv_kernel``). The kernels are
``fei_tpu_torch/csrc/flash_attention_fwd.cu`` (K1, with an optional
logsumexp output) and ``fei_tpu_torch/csrc/flash_attention_bwd.cu`` (K5a
dq, K5b dk/dv, K5b's key tiles paired so that causal blocks carry equal
work): wgmma with a cp.async producer warpgroup at D 64 and 128, mma.sync
tiles at D 80 and 256, in both directions, as ``DESIGNS`` says. CUDA C++
for sm_90a, live tiles only; their headers say what bounds them and what
the design does about it.

``flash_attention`` launches K1 for CUDA tensors and raises when it cannot;
it takes the plain version (``flash_attention_reference``) only for tensors
on the CPU. When q, k or v requires a gradient it goes through
``FlashAttention`` (a ``torch.autograd.Function``): the forward launches K1
with the logsumexp, the backward launches K5a and K5b
(``flash_attention_bwd``; on CPU tensors ``flash_attention_bwd_reference``).
Nothing on a CUDA tensor falls back to autograd through the plain
attention. ``flash_attention.launches``, ``flash_attention_bwd.launches_dq``
and ``.launches_dkv`` count kernel launches. ``flash_attention_tolerance``
and ``flash_attention_bwd_tolerance`` are the per-element bounds the kernels
are held to against the plain versions.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from fei_tpu_torch.ops.attention import (
    acc,
    attention,
    attention_probs,
    attention_scores,
    visible_mask,
)
from fei_tpu_torch.ops.kernels import build

KERNEL = "flash_attention_fwd"
KERNEL_BWD = "flash_attention_bwd"
HEAD_DIMS = (64, 80, 128, 256)
# the design of K1, K5a and K5b for each head dim (the switches in
# fei_flash_attention_fwd, fei_flash_attention_bwd_dq and _dkv)
DESIGNS = {64: "wgmma", 80: "mma.sync", 128: "wgmma", 256: "mma.sync"}
# K5b's tiles for each head dim: (keys per tile, query rows per step)
DKV_TILES = {64: (128, 64), 80: (64, 64), 128: (128, 64), 256: (32, 32)}

_FN = None
_FN_BWD = None
_COUNT_LOCK = threading.Lock()  # concurrent requests launch from threads

_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _error_string(lib):
    lib.fei_cuda_error_string.argtypes = [ctypes.c_int]
    lib.fei_cuda_error_string.restype = ctypes.c_char_p
    return lib.fei_cuda_error_string


def _kernel():
    """K1's C entry point with its argument types (pointers and the stream
    as c_void_p so ctypes never truncates them to 32 bits)."""
    global _FN
    if _FN is None:
        lib = build.load(KERNEL)
        fn = lib.fei_flash_attention_fwd
        fn.argtypes = [_VP] * 7 + [_I32] * 6 + [_I64] * 12 + [_I32, ctypes.c_float, _VP]
        fn.restype = ctypes.c_int
        _FN = (fn, _error_string(lib))
    return _FN


def _kernel_bwd():
    """K5a's and K5b's C entry points with their argument types."""
    global _FN_BWD
    if _FN_BWD is None:
        lib = build.load(KERNEL_BWD)
        tail = [_I32] * 6 + [_I64] * 9 + [_I32, ctypes.c_float, _VP]
        dq, dkv = lib.fei_flash_attention_bwd_dq, lib.fei_flash_attention_bwd_dkv
        dq.argtypes = [_VP] * 9 + tail
        dkv.argtypes = [_VP] * 11 + tail
        dq.restype = dkv.restype = ctypes.c_int
        _FN_BWD = (dq, dkv, _error_string(lib))
    return _FN_BWD


def kernel_design(D: int) -> str:
    """The design of K1, K5a and K5b that a head dim dispatches to:
    ``"wgmma"`` (the Hopper pipelines) or ``"mma.sync"`` (the first, simpler
    kernels)."""
    if D not in DESIGNS:
        raise ValueError(f"head dim {D} is not one the kernels are built for {HEAD_DIMS}")
    return DESIGNS[D]


def flash_attention_bwd_dkv_steps(T, S, H, K, D, q_start, kv_length, window=0,
                                  cluster=2) -> list[int]:
    """The (query head, q tile) steps each K5b block walks, one entry per
    block in launch order: the kernel's schedule in plain Python, so that
    its balance can be read without the card (``chip_smoke.py`` holds it
    against the counts the kernel reports). A key tile's steps are the
    group's H / K heads times the 64-row q tiles that see one of its keys
    (32-row at D = 256). The wgmma design gives a cluster of ``cluster``
    blocks (2, 4 or 8: the launch picks it from the card) the 128-key tiles
    j and n - 1 - j of one kv head, and block r of the cluster the steps i
    with i % cluster == r of each; the mma.sync design gives a block one
    key tile and all its steps. ``q_start`` and ``kv_length`` are per
    batch row."""
    bn, bm = DKV_TILES[D]
    n_kt, G, B = -(-S // bn), H // K, len(q_start)

    def steps(tile, qs, kl):
        k0, kv = tile * bn, min(kl, S)
        t_lo, t_hi = max(k0 - qs, 0), T - 1
        if window > 0:
            t_hi = min(t_hi, min(k0 + bn, kv) - 1 + window - 1 - qs)
        live = k0 < kv and t_lo <= t_hi
        return G * (t_hi // bm - t_lo // bm + 1) if live else 0

    if kernel_design(D) == "wgmma":  # block (pair j, batch row, kv head, rank r)
        pairs = [[j, n_kt - 1 - j] if n_kt - 1 - j != j else [j] for j in range(-(-n_kt // 2))]
        return [sum((steps(t, int(q_start[b]), int(kv_length[b])) - r + cluster - 1) // cluster
                    for t in tiles)
                for tiles in pairs for b in range(B) for _ in range(K) for r in range(cluster)]
    return [steps(t, int(q_start[b]), int(kv_length[b]))  # block (key tile, kv head, batch row)
            for b in range(B) for _ in range(K) for t in range(n_kt)]


def _positions(q_start: torch.Tensor, T: int) -> torch.Tensor:
    return q_start.to(torch.long)[:, None] + torch.arange(T, device=q_start.device)[None, :]


def flash_attention_reference(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, S, K, D]
    v: torch.Tensor,
    q_start: torch.Tensor,  # [B] int: absolute position of the first query
    kv_length: torch.Tensor,  # [B] int: valid kv prefix (after cache write)
    scale: float | None = None,
    window: int = 0,
    return_lse: bool = False,
):
    """The plain PyTorch version of K1: ``ops.attention.attention`` at
    positions ``q_start + arange(T)``, with the kernel's rule that a query
    row with no live key is zeros. ``return_lse`` also returns the
    logsumexp of each row's scaled, masked scores, [B, H, T] in natural-log
    units and +inf for a row with no live key (so that the backward's
    ``exp(s - lse)`` is 0 there)."""
    B, T, H, _ = q.shape
    positions = _positions(q_start.to(q.device), T)
    out = attention(q, k, v, positions, kv_length, scale=scale, window=window)
    live = visible_mask(positions, kv_length, k.shape[1], window).any(dim=-1)
    out = torch.where(live[:, :, None, None], out, torch.zeros_like(out))
    if not return_lse:
        return out
    scores = attention_scores(q, k, positions, kv_length, scale, window)
    lse = torch.logsumexp(scores, dim=-1).reshape(B, T, H)
    lse = torch.where(live[:, :, None], lse, torch.full_like(lse, float("inf")))
    return out, lse.permute(0, 2, 1).contiguous()


def _bf16_ulp(ref: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each element's size (bf16 keeps 8 significant bits)."""
    _, exp = torch.frexp(ref.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(ref), exp - 8)


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
    positions = _positions(q_start, q.shape[1])
    probs = attention_probs(q, k, positions, kv_length, scale, window)
    spread = torch.einsum("btkgs,bskd->btkgd", probs.square(), v.float().square()).sqrt()
    del probs
    live = visible_mask(positions, kv_length, k.shape[1], window).any(dim=-1)
    spread = spread.reshape(q.shape) * live[:, :, None, None]
    ref = flash_attention_reference(q.float(), k.float(), v.float(), q_start, kv_length,
                                    scale, window)
    return 2 * _bf16_ulp(ref) + 4 * 2.0 ** -8 * spread


def _bwd_p_ds(q, k, v, q_start, kv_length, out, lse, dout, scale, window, mutant=None):
    """The backward's recomputed softmax weights and score gradients, both
    [B, T, K, G, S] in the accumulation type: ``p = exp(s - lse)`` on the
    scaled, masked scores and ``ds = p * (dout.v - rowsum(dout * out))``.
    ``mutant`` breaks the function on purpose, to show that a bound can see
    it: ``"no_dsum"`` drops the row-sum term, ``"one_more"`` lets every
    query see one key more (and widens a window by one)."""
    B, T, H, D = q.shape
    K = k.shape[2]
    more = mutant == "one_more"
    positions = _positions(q_start.to(q.device), T) + more
    s = attention_scores(q, k, positions, kv_length, scale, window + (more and window > 0))
    row = lse.to(s.dtype).reshape(B, K, H // K, T).permute(0, 3, 1, 2)[..., None]
    p = torch.exp(s - row)  # 0 where masked (-1e30) and where lse is +inf
    dog = acc(dout).reshape(B, T, K, H // K, D)
    dp = torch.einsum("btkgd,bskd->btkgs", dog, acc(v))
    if mutant != "no_dsum":
        dp = dp - (dog * acc(out).reshape(dog.shape)).sum(dim=-1, keepdim=True)
    return p, p * dp


def _bwd_products(q, k, dout, p, ds, scale):
    """(dq, dk, dv) from the weights and score gradients: the three
    products of the backward, dk and dv summed over each GQA group."""
    B, T, H, D = q.shape
    K = k.shape[2]
    qg = acc(q).reshape(B, T, K, H // K, D)
    dog = acc(dout).reshape(B, T, K, H // K, D)
    dv = torch.einsum("btkgs,btkgd->bskd", p, dog)
    dk = torch.einsum("btkgs,btkgd->bskd", ds, qg) * scale
    dq = torch.einsum("btkgs,bskd->btkgd", ds, acc(k)).reshape(B, T, H, D) * scale
    return dq, dk, dv


def flash_attention_bwd_reference(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, S, K, D]
    v: torch.Tensor,
    q_start: torch.Tensor,  # [B] int
    kv_length: torch.Tensor,  # [B] int
    out: torch.Tensor,  # [B, T, H, D] the forward's output
    lse: torch.Tensor,  # [B, H, T] the forward's logsumexp (+inf: no live key)
    dout: torch.Tensor,  # [B, T, H, D]
    scale: float | None = None,
    window: int = 0,
    *,
    round_bf16: bool = False,
    mutant: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K5a and K5b: the recompute backward on
    whole tensors, ``(dq, dk, dv)`` in the inputs' dtypes. Keys at or past
    ``kv_length`` and keys no query sees get zero dk and dv; rows whose lse
    is +inf get zero dq. ``round_bf16`` rounds p and ds to bf16 before the
    products and the results to bf16, as the kernels do (to test the
    tolerance on the CPU); ``mutant`` is ``_bwd_p_ds``'s."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    p, ds = _bwd_p_ds(q, k, v, q_start, kv_length, out, lse, dout, scale, window, mutant)
    if round_bf16:
        p, ds = p.bfloat16().to(p.dtype), ds.bfloat16().to(ds.dtype)
    grads = _bwd_products(q, k, dout, p, ds, scale)
    if round_bf16:
        grads = tuple(g.bfloat16().to(g.dtype) for g in grads)
    return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v)))


def flash_attention_bwd_tolerance(q, k, v, q_start, kv_length, out, lse, dout,
                                  scale=None, window=0, return_cancel=False):
    """Per-element bounds ``(tol_dq, tol_dk, tol_dv)`` on |kernel -
    reference| for bf16 inputs, where the reference is
    ``flash_attention_bwd_reference`` in fp32 on the same values (the same
    ``out`` and ``lse`` too, so the forward's own roundings cancel).

    The kernels differ from it by the roundings the Pallas kernels make:
    ds is rounded to bf16 before ds.K (dq) and ds^T.Q (dk), p before
    p^T.dO (dv) — an error of at most 2^-8 |ds_ij k_j|, |ds_ij q_i| or
    |p_ij dO_i| per term, independent from term to term. As in
    ``flash_attention_tolerance``, four times the root-sum-square of those
    per-term bounds (over the keys of a row for dq; over the queries and
    the group's heads of a key for dk and dv) is exceeded with a chance
    below 1e-10 per element, and two bf16 ulps of |reference| cover the
    result's own rounding and the fp32 summation order of the last
    products. The exp2-based exponentials move p by parts in 1e5, far
    inside the first term. One more term matters where ds cancels:
    ``dout.v - rowsum(dout * out)`` is a difference of two fp32 sums of D
    terms taken in two orders, each off by up to D 2^-24 of the sum of its
    terms' sizes, and for a row with few keys (p near 1, out near v) the
    true difference is near zero while that error is not. It enters dq and
    dk through the same products, bounded term by term (no cancellation
    assumed); on average it supplies 0.7-6.8% of a dq or dk bound at the
    shapes ``chip_smoke.py`` checks (H100, T up to 4096), most at long rows
    and wide heads. Each
    bound follows its element's own size, so a gradient that is wrong only
    where it is small still fails. ``return_cancel`` also hands back that
    last term alone, ``(tols, cancels)``, so that a caller can state the
    share of each bound it supplies."""
    D = q.shape[-1]
    if scale is None:
        scale = D ** -0.5
    f = (q.float(), k.float(), v.float(), q_start, kv_length, out.float(), lse, dout.float())
    p, ds = _bwd_p_ds(*f, scale, window)
    refs = _bwd_products(f[0], f[1], f[7], p, ds, scale)
    spreads = _bwd_products(f[0].square(), f[1].square(), f[7].square(),
                            p.square(), ds.square(), scale * scale)
    del ds
    # |ds| error from the two fp32 sums: p * D 2^-24 * (sum|dout v| + sum|dout out|)
    B, T, H, _ = q.shape
    dog = f[7].abs().reshape(B, T, k.shape[2], H // k.shape[2], D)
    sums = torch.einsum("btkgd,bskd->btkgs", dog, f[2].abs())
    sums += (dog * f[5].abs().reshape(dog.shape)).sum(dim=-1, keepdim=True)
    sums *= p
    sums *= D * 2.0 ** -24
    cancel = _bwd_products(f[0].abs(), f[1].abs(), f[7], torch.zeros_like(p), sums, scale)
    tols = tuple(2 * _bf16_ulp(r) + 4 * 2.0 ** -8 * s.sqrt() + c
                 for r, s, c in zip(refs, spreads, cancel))
    return (tols, cancel) if return_cancel else tols


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


def _launch_fwd(q, k, v, q_start, kv_length, scale, window, want_lse):
    """Launch K1 on the current stream; returns (out, lse or None)."""
    _check(q, k, v, q_start, kv_length, window)
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device) if want_lse else None
    if T == 0:
        return out, lse
    fn, err_str = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if want_lse else None,
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
    return out, lse


def flash_attention_fwd(q, k, v, q_start, kv_length, scale=None, window=0):
    """The forward of the training path, ``(out, lse)``: K1 with its
    logsumexp output on CUDA tensors, ``flash_attention_reference(...,
    return_lse=True)`` on CPU tensors. ``out`` is what ``flash_attention``
    returns (bitwise, on the card)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, q_start, kv_length, scale, window,
                                         return_lse=True)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return _launch_fwd(q, k, v, q_start, kv_length, scale, window, want_lse=True)


def _bwd_args(q, k, v, q_start, kv_length, lse, dsum, dout, scale, window):
    """Check one backward kernel's inputs; returns the C call's leading
    pointers and its trailing scalars (the outputs go between them)."""
    if q.device.type != "cuda":
        raise ValueError(f"the backward kernels run on cuda, not {q.device}: CPU tensors "
                         "go through flash_attention_bwd")
    _check(q, k, v, q_start, kv_length, window)
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    if (dout.shape != q.shape or dout.dtype != torch.bfloat16 or dout.device != q.device
            or dout.stride() != q.stride()):
        raise ValueError(f"dout must be bf16 {tuple(q.shape)} on {q.device} with q's strides")
    for name, t in (("lse", lse), ("dsum", dsum)):
        if (t.shape != (B, H, T) or t.dtype != torch.float32 or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous fp32 [{B}, {H}, {T}] on {q.device}")
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
           lse.data_ptr(), dsum.data_ptr())
    tail = (
        q_start.data_ptr(), kv_length.data_ptr(), B, T, H, S, K, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(window), float(D ** -0.5 if scale is None else scale),
    )
    return ins, tail


def _launch_bwd(which: str, q, ins, outs, tail):
    fn_dq, fn_dkv, err_str = _kernel_bwd()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = (fn_dq if which == "dq" else fn_dkv)(*ins, *outs, *tail, stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention_bwd {which} launch failed: {err_str(err).decode()} ({err})")
    with _COUNT_LOCK:
        if which == "dq":
            flash_attention_bwd.launches_dq += 1
        else:
            flash_attention_bwd.launches_dkv += 1


def flash_attention_bwd_dq(q, k, v, q_start, kv_length, lse, dsum, dout,
                           scale=None, window=0) -> torch.Tensor:
    """K5a alone on CUDA tensors: dq [B, T, H, D] from the forward's ``lse``
    and ``dsum = rowsum(dout * out)``, both fp32 [B, H, T]."""
    ins, tail = _bwd_args(q, k, v, q_start, kv_length, lse, dsum, dout, scale, window)
    dq = torch.empty_like(q)
    if q.shape[1]:
        _launch_bwd("dq", q, ins, (dq.data_ptr(),), tail)
    return dq


def flash_attention_bwd_dkv(q, k, v, q_start, kv_length, lse, dsum, dout,
                            scale=None, window=0) -> tuple[torch.Tensor, torch.Tensor]:
    """K5b alone on CUDA tensors: dk and dv [B, S, K, D], each summed over
    its kv head's group of query heads inside the kernel."""
    ins, tail = _bwd_args(q, k, v, q_start, kv_length, lse, dsum, dout, scale, window)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.shape[1] == 0:
        return dk.zero_(), dv.zero_()
    _launch_bwd("dkv", q, ins, (dk.data_ptr(), dv.data_ptr(), None), tail)
    return dk, dv


def flash_attention_bwd_dkv_block_steps(q, k, v, q_start, kv_length, lse, dsum, dout,
                                        scale=None, window=0) -> list[int]:
    """K5b's wgmma kernel once, on CUDA tensors, with the (query head, q
    tile) steps each of its blocks walked as the kernel counts them, in
    launch order (``flash_attention_bwd_dkv_steps`` is the schedule they
    must follow). For ``chip_smoke.py``, which reads the balance from them."""
    ins, tail = _bwd_args(q, k, v, q_start, kv_length, lse, dsum, dout, scale, window)
    if kernel_design(q.shape[3]) != "wgmma":
        raise ValueError(f"only the wgmma design counts its steps, not D = {q.shape[3]}")
    S, K = k.shape[1], k.shape[2]
    most = -(-S // (2 * DKV_TILES[q.shape[3]][0])) * K * q.shape[0] * 8  # clusters of 8
    steps = torch.full((most,), -1, dtype=torch.int32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("dkv", q, ins, (dk.data_ptr(), dv.data_ptr(), steps.data_ptr()), tail)
    steps = steps.tolist()
    return steps[:steps.index(-1)] if -1 in steps else steps


def flash_attention_bwd(
    q: torch.Tensor,  # [B, T, H, D] bf16
    k: torch.Tensor,  # [B, S, K, D] bf16
    v: torch.Tensor,
    q_start: torch.Tensor,  # [B] int32
    kv_length: torch.Tensor,  # [B] int32
    out: torch.Tensor,  # [B, T, H, D] the forward's output
    lse: torch.Tensor,  # [B, H, T] fp32 the forward's logsumexp
    dout: torch.Tensor,  # [B, T, H, D]
    scale: float | None = None,
    window: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of ``flash_attention``: CUDA tensors launch K5a and
    K5b on the current stream (or raise), CPU tensors run
    ``flash_attention_bwd_reference``. ``rowsum(dout * out)`` is plain
    PyTorch in fp32, as the JAX package leaves it to XLA."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, q_start, kv_length, out, lse, dout,
                                             scale, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu, not {q.device}")
    if out.shape != q.shape or out.dtype != q.dtype or out.device != q.device:
        raise ValueError(f"out must be {q.dtype} {tuple(q.shape)} on {q.device}")
    dout = dout.contiguous()
    # fp32 x bf16 promotes exactly: the fp32 products, with one conversion less
    dsum = (dout.float() * out).sum(dim=-1).permute(0, 2, 1).contiguous()  # [B,H,T]
    args = (q, k, v, q_start, kv_length, lse, dsum, dout, scale, window)
    return (flash_attention_bwd_dq(*args), *flash_attention_bwd_dkv(*args))


flash_attention_bwd.launches_dq = 0
flash_attention_bwd.launches_dkv = 0


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its gradient: the forward saves
    ``(q, k, v, q_start, kv_length, out, lse)``, the backward recomputes the
    softmax weights from them (``flash_attention_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, q_start, kv_length, scale, window):
        out, lse = flash_attention_fwd(q, k, v, q_start, kv_length, scale, window)
        ctx.save_for_backward(q, k, v, q_start, kv_length, out, lse)
        ctx.scale, ctx.window = scale, window
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = flash_attention_bwd(*ctx.saved_tensors, dout, ctx.scale, ctx.window)
        return dq, dk, dv, None, None, None, None


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
    ``flash_attention_reference``. Differentiable in q, k and v: when one
    of them requires a gradient the call goes through ``FlashAttention``."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, q_start, kv_length, scale, window)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, q_start, kv_length, scale, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return _launch_fwd(q, k, v, q_start, kv_length, scale, window, want_lse=False)[0]


flash_attention.launches = 0
