"""Paged decode attention (K2): the CUDA kernel's wrapper and its plain version.

Counterpart of fei_tpu/ops/pallas/paged_attention.py (``paged_attention``
and ``paged_attention_block`` over ``_decode_kernel``). The kernel is
``fei_tpu_torch/csrc/paged_attention.cu`` (its body, shared with the
ragged kernel, is ``csrc/paged_attention.cuh``; the header says what bounds
it and what the design does about it).

Layouts are the JAX package's: pools ``[P, K, ps, D]`` (head-major pages),
int8 pools with per-slot fp32 scales ``[P, K, 1, ps]``, ``block_table``
``[B, max_pages]`` int32. Query position t of row b sees the key
positions below ``limit_b + t`` (and, with a window W, above
``limit_b - 1 + t - W``).

``paged_attention`` / ``paged_attention_block`` launch the kernel for CUDA
tensors and raise when they cannot; tensors on the CPU take the plain
version (``paged_rows_plain``). ``paged_attention_sharded`` /
``paged_attention_block_sharded`` are their tensor-parallel wrappers (the
reference's ``_sharded_paged``): each rank runs the same kernel on its kv
heads, and the heads (and dp rows) are gathered inside the wrapper. ``paged_attention.launches`` counts kernel
launches of both (``int8_launches`` those over int8 pools,
``block_launches`` those of the block form).
``paged_rows_tolerance`` is the per-element bound the kernel is held to
against the plain version.

The kernel splits each row's keys over blocks in fixed segments of
``SEGMENT_PAGES`` pages (``segment_plan``, ``row_segments``: a function of
absolute key positions alone) and adds a row's segments in index order;
``paged_rows_split`` is that split in plain PyTorch. The partials go
through fp32 scratch that ``launch`` sizes from the table width
(``scratch_elems``).
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from fei_tpu_torch.ops.attention import attention, attention_scores, visible_mask
from fei_tpu_torch.ops.kernels import build
from fei_tpu_torch.ops.kernels.flash_attention import flash_attention_tolerance

KERNEL = "paged_attention"
PAGE_SIZE = 64  # the page size the kernel is compiled for
HEAD_DIMS = (64, 80, 128, 256)
SEGMENT_PAGES = 16  # pages per key segment of a row (one block each)

_FNS: dict[str, tuple] = {}
_COUNT_LOCK = threading.Lock()  # concurrent requests launch from threads


def kernel_fn(name: str, symbol: str, n_row_arrays: int):
    """The C entry point ``symbol`` of ``csrc/<name>.cu`` with its argument
    types (pointers and the stream as c_void_p so ctypes never truncates
    them to 32 bits). ``n_row_arrays`` is the count of per-row int32
    arrays after the block table (limits; for K3 also q_lens and modes)."""
    if name not in _FNS:
        lib = build.load(name)
        fn = getattr(lib, symbol)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = (  # q k v ks vs o part, part_elems, table, its stride,
            # row arrays, B R H K D max_pages, strides, window scale int8 seg
            [vp] * 7 + [i64, vp, i64] + [vp] * n_row_arrays + [i32] * 6
            + [i64] * 6 + [i32, ctypes.c_float, i32, i32, vp]
        )
        fn.restype = ctypes.c_int
        lib.fei_cuda_error_string.argtypes = [ctypes.c_int]
        lib.fei_cuda_error_string.restype = ctypes.c_char_p
        _FNS[name] = (fn, lib.fei_cuda_error_string)
    return _FNS[name]


# ------------------------------------------------------------ plain version

def gather_pages(k_pages, v_pages, block_table, n_pages: int,
                 k_scales=None, v_scales=None):
    """Each row's first ``n_pages`` table entries as a contiguous
    ``[B, n_pages*ps, K, D]`` K/V view; int8 pools come back dequantized
    in fp32 (value times its slot's scale)."""
    bt = block_table[:, :n_pages].long()
    kg, vg = k_pages[bt], v_pages[bt]  # [B, n, K, ps, D]
    if k_scales is not None:
        kg = kg.float() * k_scales[bt].transpose(-1, -2)  # [B, n, K, ps, 1]
        vg = vg.float() * v_scales[bt].transpose(-1, -2)
    B, n, K, ps, D = kg.shape
    return (kg.transpose(2, 3).reshape(B, n * ps, K, D),
            vg.transpose(2, 3).reshape(B, n * ps, K, D))


def _live_pages(limits, q_lens, R: int, ps: int, width: int) -> int:
    """Table entries that hold any key a live row can see (at least 1)."""
    last = int((limits.long() + q_lens.long().clamp(min=1) - 1).max()) if len(limits) else 1
    return max(1, min(-(-last // ps), width))


def paged_rows_plain(
    q: torch.Tensor,  # [B, R, H, D]
    k_pages: torch.Tensor,  # [P, K, ps, D]
    v_pages: torch.Tensor,
    block_table: torch.Tensor,  # [B, max_pages] int32
    limits: torch.Tensor,  # [B] int: first query position's key limit
    q_lens: torch.Tensor | None = None,  # [B] live positions (None: all R)
    scale: float | None = None,
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
    window: int = 0,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: gather each row's pages into
    a contiguous view and run ``ops.attention.attention`` at positions
    ``limit - 1 + t``. Positions t >= q_len, and rows with no visible key,
    are zeros. Returns [B, R, H, D] in q's dtype."""
    B, R = q.shape[:2]
    if q_lens is None:
        q_lens = torch.full((B,), R, dtype=torch.int32, device=q.device)
    n = _live_pages(limits, q_lens, R, k_pages.shape[2], block_table.shape[1])
    kc, vc = gather_pages(k_pages, v_pages, block_table, n, k_scales, v_scales)
    t = torch.arange(R, device=q.device)
    pos = (limits.long() - 1)[:, None] + t[None, :]
    kv_len = limits.long() + R - 1
    out = attention(q, kc, vc, pos, kv_len, scale=scale, window=window)
    live = visible_mask(pos, kv_len, kc.shape[1], window).any(dim=-1)
    live &= t[None, :] < q_lens.long()[:, None]
    return torch.where(live[:, :, None, None], out, torch.zeros_like(out))


def paged_rows_tolerance(q, k_pages, v_pages, block_table, limits, q_lens=None,
                         scale=None, k_scales=None, v_scales=None, window=0):
    """Per-element bound [B, R, H, D] on |kernel - plain version in fp32|:
    ``flash_attention_tolerance`` on the gathered contiguous view (the
    kernel rounds each softmax weight to bf16 before the P.V product, and
    the output to bf16; int8 pools fold the v scale into the weight before
    that rounding, which the same bound covers with the dequantized v)."""
    B, R = q.shape[:2]
    if q_lens is None:
        q_lens = torch.full((B,), R, dtype=torch.int32, device=q.device)
    n = _live_pages(limits, q_lens, R, k_pages.shape[2], block_table.shape[1])
    kc, vc = gather_pages(k_pages, v_pages, block_table, n, k_scales, v_scales)
    q_start = (limits - 1).to(torch.int32)
    kv_len = (limits + R - 1).to(torch.int32)
    return flash_attention_tolerance(q.float(), kc.float(), vc.float(), q_start,
                                     kv_len, scale, window)


# ------------------------------------------------------- the key segments

@functools.lru_cache(maxsize=None)
def segment_plan(max_pages: int, seg_pages: int = SEGMENT_PAGES) -> tuple[tuple[int, int], ...]:
    """The kernel's segments of a table row, ``((first_page, stop_page),
    ...)`` over ``range(max_pages)``: page ``pi`` lies in segment ``pi //
    seg_pages``. A function of the table width alone, so that a query
    row's split does not depend on R, the batch or the other rows."""
    return tuple((a, min(a + seg_pages, max_pages)) for a in range(0, max_pages, seg_pages))


def row_segments(key_lo: int, key_hi: int, max_pages: int, page_size: int = PAGE_SIZE,
                 seg_pages: int = SEGMENT_PAGES) -> list[tuple[int, int, int]]:
    """The segments a query row whose visible keys are ``[key_lo, key_hi)``
    reads, in the order the combine adds them: ``(segment, first_page,
    stop_page)`` with the row's live pages of that segment. Keys past the
    table width are not there; a row with no visible key reads none."""
    key_hi = min(key_hi, max_pages * page_size)
    if key_hi <= key_lo:
        return []
    first, last = key_lo // page_size, (key_hi - 1) // page_size
    out = []
    for s, (a, z) in enumerate(segment_plan(max_pages, seg_pages)):
        if a <= last and z > first:
            out.append((s, max(a, first), min(z, last + 1)))
    return out


def scratch_elems(B: int, R: int, H: int, D: int, max_pages: int,
                  seg_pages: int = SEGMENT_PAGES) -> int:
    """fp32 elements of a call's partials: (m, l) and D accumulators for
    every (row, position, head, segment). The kernel refuses any other."""
    return B * R * H * len(segment_plan(max_pages, seg_pages)) * (D + 2)


def paged_rows_split(q, k_pages, v_pages, block_table, limits, q_lens=None, scale=None,
                     k_scales=None, v_scales=None, window=0, seg_pages=SEGMENT_PAGES,
                     mutant=None) -> torch.Tensor:
    """The kernel's split in plain PyTorch, in q's accumulation type: for
    every segment of ``segment_plan`` a row sees, the softmax state of its
    keys there (m_s the max score in the log2 domain, l_s = sum 2^(s - m_s),
    acc_s = sum 2^(s - m_s) v), then the segments added in index order, each
    sum starting from its first segment's term: m = max m_s, l = sum l_s
    2^(m_s - m), acc likewise, out = acc / l. Positions t >= q_len and rows
    with no visible key are zeros. ``mutant="drop_last"`` leaves out each
    row's last segment (it must break ``paged_rows_tolerance``). Returns
    [B, R, H, D]."""
    B, R, H, D = q.shape
    ps = k_pages.shape[2]
    if q_lens is None:
        q_lens = torch.full((B,), R, dtype=torch.int32, device=q.device)
    n = _live_pages(limits, q_lens, R, ps, block_table.shape[1])
    kc, vc = gather_pages(k_pages, v_pages, block_table, n, k_scales, v_scales)
    K = kc.shape[2]
    t = torch.arange(R, device=q.device)
    pos = (limits.long() - 1)[:, None] + t[None, :]
    kv_len = limits.long() + R - 1
    s = attention_scores(q, kc, pos, kv_len, scale, window) * math.log2(math.e)
    vis = visible_mask(pos, kv_len, kc.shape[1], window)[:, :, None, None, :]
    vis = vis & (t[None, :] < q_lens.long()[:, None])[:, :, None, None, None]
    vf = vc.to(s.dtype)
    segs = [(a * ps, min(z, n) * ps) for a, z in segment_plan(block_table.shape[1], seg_pages)
            if a < n]
    states = []
    for a, z in segs:
        sv = vis[..., a:z]
        m_s = torch.where(sv, s[..., a:z], -torch.inf).amax(dim=-1)  # -inf: no key here
        p = torch.where(sv, torch.exp2(s[..., a:z] - m_s[..., None]), 0.0)
        states.append((sv.any(dim=-1), m_s, p.sum(dim=-1),
                       torch.einsum("btkgs,bskd->btkgd", p, vf[:, a:z])))
    if mutant == "drop_last":
        # a segment is a row's last when no later segment holds its keys
        later = torch.zeros_like(states[0][0])
        for i in range(len(states) - 1, -1, -1):
            has, m_s, l_s, acc_s = states[i]
            states[i] = (has & later, m_s, l_s, acc_s)
            later = later | has
    elif mutant is not None:
        raise ValueError(f"unknown mutant {mutant!r}")
    m = torch.stack([torch.where(h, m_s, -torch.inf) for h, m_s, _, _ in states]).amax(dim=0)
    started = torch.zeros_like(states[0][0])
    l = torch.zeros_like(m)
    acc = torch.zeros(*m.shape, D, dtype=s.dtype, device=q.device)
    for has, m_s, l_s, acc_s in states:
        w = torch.where(has, torch.exp2(m_s - torch.where(has, m, 0.0)), 0.0)
        l = torch.where(has & ~started, l_s * w, torch.where(has, l + l_s * w, l))
        acc = torch.where((has & ~started)[..., None], acc_s * w[..., None],
                          torch.where(has[..., None], acc + acc_s * w[..., None], acc))
        started = started | has
    out = torch.where(started[..., None], acc / torch.where(started, l, 1.0)[..., None], 0.0)
    return out.reshape(B, R, H, D).to(q.dtype)


# ------------------------------------------------------------------ kernel

def check_inputs(q, k_pages, v_pages, block_table, row_arrays, k_scales, v_scales,
                 window):
    """Raise on anything the kernel does not take."""
    if q.dim() != 4 or k_pages.dim() != 4:
        raise ValueError("the kernel takes q [B,R,H,D] and pools [P,K,ps,D]")
    B, R, H, D = q.shape
    P, K, ps, Dk = k_pages.shape
    if v_pages.shape != k_pages.shape or Dk != D:
        raise ValueError(f"pools {tuple(k_pages.shape)} / {tuple(v_pages.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    if H % K:
        raise ValueError(f"q heads {H} are not a multiple of kv heads {K}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one the kernel is built for {HEAD_DIMS}")
    if ps != PAGE_SIZE:
        raise ValueError(f"page size {ps}: the kernel is built for {PAGE_SIZE}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bf16 queries; q is {q.dtype}")
    int8 = k_scales is not None
    want = torch.int8 if int8 else torch.bfloat16
    if k_pages.dtype != want or v_pages.dtype != want:
        raise TypeError(f"pools must be {want} here; got {k_pages.dtype}/{v_pages.dtype}")
    tensors = [("q", q), ("k_pages", k_pages), ("v_pages", v_pages)]
    if int8:
        if v_scales is None or k_scales.shape != (P, K, 1, ps) or v_scales.shape != (P, K, 1, ps):
            raise ValueError(f"int8 pools need k/v scales [{P},{K},1,{ps}]")
        for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
            if t.dtype != torch.float32:
                raise TypeError(f"{name} must be float32")
            tensors.append((name, t))
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if (block_table.dtype != torch.int32 or block_table.dim() != 2
            or block_table.shape[0] != B or block_table.stride(1) != 1
            or block_table.device != q.device):
        raise ValueError(f"block_table must be int32 [{B}, max_pages] on {q.device}")
    for name, t in row_arrays:
        if t.device != q.device or t.dtype != torch.int32 or t.shape != (B,) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be int32 [{B}] on {q.device}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def launch(name: str, symbol: str, q, k_pages, v_pages, block_table, row_arrays,
           scale, k_scales, v_scales, window, scratch=None,
           seg_pages: int = SEGMENT_PAGES) -> torch.Tensor:
    """Check, allocate the output (and the partials' scratch, unless one of
    exactly ``scratch_elems`` fp32 elements is given) and launch ``symbol``
    on the current stream; raises if the launch fails. ``seg_pages`` is the
    segment length of the split: the wrappers keep ``SEGMENT_PAGES``, other
    values serve to measure what the length costs."""
    check_inputs(q, k_pages, v_pages, block_table, row_arrays, k_scales, v_scales,
                 window)
    B, R, H, D = q.shape
    K = k_pages.shape[1]
    elems = scratch_elems(B, R, H, D, block_table.shape[1], seg_pages)
    if scratch is None:
        scratch = torch.empty(elems, dtype=torch.float32, device=q.device)
    elif (scratch.numel() != elems or scratch.dtype != torch.float32
          or scratch.device != q.device or not scratch.is_contiguous()):
        raise ValueError(f"scratch must be {elems} contiguous float32 elements on "
                         f"{q.device} (the plan of a table {block_table.shape[1]} pages "
                         f"wide in segments of {seg_pages}); got {scratch.numel()} "
                         f"{scratch.dtype} on {scratch.device}")
    out = torch.empty_like(q)
    if B == 0 or R == 0:
        return out
    fn, err_str = kernel_fn(name, symbol, len(row_arrays))
    int8 = k_scales is not None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scales.data_ptr() if int8 else None,
            v_scales.data_ptr() if int8 else None,
            out.data_ptr(), scratch.data_ptr(), scratch.numel(),
            block_table.data_ptr(), block_table.stride(0),
            *[t.data_ptr() for _, t in row_arrays],
            B, R, H, K, D, block_table.shape[1],
            *q.stride()[:3], *out.stride()[:3],
            int(window), float(D ** -0.5 if scale is None else scale), int(int8),
            int(seg_pages), stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {err_str(err).decode()} ({err})")
    return out


def _count(int8: bool, block: bool = False):
    with _COUNT_LOCK:
        paged_attention.launches += 1
        paged_attention.int8_launches += int(int8)
        paged_attention.block_launches += int(block)


def paged_attention(
    q: torch.Tensor,  # [B, H, D] one decode token per row
    k_pages: torch.Tensor,  # [P, K, ps, D]
    v_pages: torch.Tensor,
    block_table: torch.Tensor,  # [B, max_pages] int32
    lengths: torch.Tensor,  # [B] int32: valid kv length (keys < lengths)
    scale: float | None = None,
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
    window: int = 0,
) -> torch.Tensor:
    """Single-token attention over a paged KV cache. Returns [B, H, D]."""
    if q.device.type == "cpu":
        return paged_rows_plain(q[:, None], k_pages, v_pages, block_table, lengths,
                                None, scale, k_scales, v_scales, window)[:, 0]
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not {q.device}")
    out = launch(KERNEL, "fei_paged_attention", q[:, None].contiguous(), k_pages,
                 v_pages, block_table, [("lengths", lengths)], scale, k_scales,
                 v_scales, window)
    _count(k_scales is not None)
    return out[:, 0]


def paged_attention_block(
    q: torch.Tensor,  # [B, T, H, D] T consecutive query positions per row
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_table: torch.Tensor,
    lengths: torch.Tensor,  # [B] int32 kv length BEFORE the block
    scale: float | None = None,
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
    window: int = 0,
) -> torch.Tensor:
    """Multi-query paged attention: the block's K/V are already written at
    positions lengths..lengths+T-1 and query t sees keys < lengths + t + 1.
    Returns [B, T, H, D]."""
    limits = (lengths + 1).to(torch.int32)
    if q.device.type == "cpu":
        return paged_rows_plain(q, k_pages, v_pages, block_table, limits, None,
                                scale, k_scales, v_scales, window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_block runs on cuda or cpu, not {q.device}")
    out = launch(KERNEL, "fei_paged_attention", q, k_pages, v_pages, block_table,
                 [("limits", limits)], scale, k_scales, v_scales, window)
    _count(k_scales is not None, block=True)
    return out


paged_attention.launches = 0
paged_attention.int8_launches = 0
paged_attention.block_launches = 0


def _sharded_paged(local_fn, head_dim: int, q, k_pages, v_pages, block_table,
                   row_arrays: list, mesh, axis_name: str, k_scales, v_scales,
                   window: int, dp_axis: str = "dp"):
    """Shared tensor-parallel wrapper: ``q`` holds this rank's query heads
    (those of its ``k_pages.shape[1]`` kv heads) for every row, the pools
    this rank's kv heads. Where the rows divide the ``dp_axis``, each dp
    group attends its own rows (rows are independent, so the split is
    numerics-neutral). The kernel's per-rank output heads are all-gathered
    INSIDE the wrapper, in rank order, and the result is every head of
    every row on every rank: the ``wo`` that follows keeps the one-device
    summation order, and each head is the unsharded kernel's own value
    (heads are computed independently), so sharded decode stays bitwise."""
    if q.shape[head_dim] % k_pages.shape[1]:
        raise ValueError(f"{q.shape[head_dim]} query heads do not group over this "
                         f"rank's {k_pages.shape[1]} kv heads")
    dp = mesh.shape[dp_axis]
    split = dp > 1 and q.shape[0] % dp == 0
    if split:
        m = q.shape[0] // dp
        rs = slice(mesh.coords[dp_axis] * m, (mesh.coords[dp_axis] + 1) * m)
        q, block_table = q[rs], block_table[rs]
        row_arrays = [a[rs] for a in row_arrays]
    out = local_fn(q, k_pages, v_pages, block_table, *row_arrays,
                   k_scales=k_scales, v_scales=v_scales, window=window)
    out = mesh.all_gather(out, axis_name, dim=head_dim)
    if split:
        out = mesh.all_gather(out, dp_axis, dim=0)
    return out


def paged_attention_sharded(
    q: torch.Tensor,  # [B, H/tp, D] this rank's heads
    k_pages: torch.Tensor,  # [P, K/tp, ps, D] this rank's kv heads
    v_pages: torch.Tensor,
    block_table: torch.Tensor,
    lengths: torch.Tensor,
    mesh,
    axis_name: str = "tp",
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
    window: int = 0,
) -> torch.Tensor:
    """Tensor-parallel single-token paged attention (K2 on this rank's
    heads, see ``_sharded_paged``). Returns [B, H, D], every head."""
    return _sharded_paged(paged_attention, 1, q, k_pages, v_pages, block_table,
                          [lengths], mesh, axis_name, k_scales, v_scales, window)


def paged_attention_block_sharded(
    q: torch.Tensor,  # [B, T, H/tp, D]
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_table: torch.Tensor,
    lengths: torch.Tensor,
    mesh,
    axis_name: str = "tp",
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
    window: int = 0,
) -> torch.Tensor:
    """Tensor-parallel multi-query paged attention (K2's block form on
    this rank's heads). Returns [B, T, H, D]."""
    return _sharded_paged(paged_attention_block, 2, q, k_pages, v_pages, block_table,
                          [lengths], mesh, axis_name, k_scales, v_scales, window)
