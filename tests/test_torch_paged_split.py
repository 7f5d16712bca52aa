"""The paged kernels' split of each row's keys into fixed segments (K2, K3).

The kernels cut a row's keys into segments of ``SEGMENT_PAGES`` pages by
absolute page index, run the online softmax over each segment in its own
block and add the segments in index order. Here, on the CPU:

- the segment plan (``segment_plan``, ``row_segments``): every live page
  of a row in exactly one segment, in order, chosen by key position alone;
  dead and windowed-out segments empty;
- the split in plain PyTorch (``paged_rows_split``) against the plain
  version (``paged_rows_plain``) within fp32 rounding (atol 2e-6: the two
  orders of the same fp32 sums, outputs of size ~1), and against the
  Pallas kernels in interpret mode at the parity tests' tolerance (atol
  1e-5), for bf16-layout and int8 pools, windows, rows with no visible key
  and lengths at, one below and one above a segment boundary;
- the dropped-segment mutant breaks ``paged_rows_tolerance``;
- the launch path refuses scratch of any size but its plan's.

The ``cuda``-marked tests hold the kernels to the same boundary lengths on
the card and check that a decode row is bitwise the block form's row at the
same position (what a resumed sequence relies on).
jax is imported inside the parity tests only.
"""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import numpy as np
import pytest
import torch

from fei_tpu_torch.ops.kernels.paged_attention import (
    SEGMENT_PAGES,
    launch,
    paged_attention,
    paged_attention_block,
    paged_rows_plain,
    paged_rows_split,
    paged_rows_tolerance,
    row_segments,
    scratch_elems,
    segment_plan,
)
from fei_tpu_torch.ops.kernels.ragged_paged_attention import (
    effective_q_lens,
    ragged_paged_attention,
    ragged_paged_attention_plain,
)

P, K, PS, D, H = 32, 2, 8, 16, 4
SEG = 2  # pages per segment at this size: boundaries every 16 keys
# four rows of six pages each, non-contiguous; page 0 is the null page
TABLE = (np.random.default_rng(7).permutation(np.arange(1, 25)).reshape(4, 6)
         .astype(np.int32))


def _pools(int8: bool, seed=0):
    rng = np.random.default_rng(seed)
    if int8:
        kp = rng.integers(-127, 128, (P, K, PS, D)).astype(np.int8)
        vp = rng.integers(-127, 128, (P, K, PS, D)).astype(np.int8)
        ks = rng.uniform(0.002, 0.02, (P, K, 1, PS)).astype(np.float32)
        vs = rng.uniform(0.002, 0.02, (P, K, 1, PS)).astype(np.float32)
        return kp, vp, ks, vs
    kp = rng.standard_normal((P, K, PS, D)).astype(np.float32)
    vp = rng.standard_normal((P, K, PS, D)).astype(np.float32)
    return kp, vp, None, None


def _j(x):
    import jax.numpy as jnp

    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(x)


# ------------------------------------------------------------ the plan


@pytest.mark.parametrize("width,seg", [(6, 2), (7, 3), (128, 16), (5, 16), (1, 1)])
def test_segment_plan_tiles_the_table_in_order(width, seg):
    plan = segment_plan(width, seg)
    assert [a for a, _ in plan] == list(range(0, width, seg))
    pages = [pi for a, z in plan for pi in range(a, z)]
    assert pages == list(range(width))  # each page once, in order
    for s, (a, z) in enumerate(plan):
        assert all(pi // seg == s for pi in range(a, z))


@pytest.mark.parametrize("seg", [1, 2, 3, 16])
def test_row_segments_follow_key_positions_alone(seg):
    """A row's segments are its live pages grouped by page // seg: each live
    page in exactly one, in order; nothing outside [lo, hi); empty without
    a visible key."""
    width, ps = 10, 8
    for lo in range(0, 90, 3):
        for hi in range(0, 90, 5):
            segs = row_segments(lo, hi, width, ps, seg)
            live = (list(range(lo // ps, (min(hi, width * ps) - 1) // ps + 1))
                    if min(hi, width * ps) > lo else [])
            assert [pi for _, a, z in segs for pi in range(a, z)] == live
            assert [s for s, _, _ in segs] == sorted({pi // seg for pi in live})
            for s, a, z in segs:
                assert a // seg == s and (z - 1) // seg == s
            # windowed-out and dead segments are not listed
            assert all(s >= (lo // ps) // seg for s, _, _ in segs)
    # the same keys give the same segments whatever else is in the call
    assert row_segments(40, 70, width, ps, seg) == row_segments(40, 70, width, ps, seg)
    assert row_segments(5, 5, width, ps, seg) == []


def test_scratch_size_follows_the_plan():
    assert scratch_elems(8, 1, 32, 128, 128) == 8 * 32 * (128 // SEGMENT_PAGES) * 130
    assert scratch_elems(1, 256, 32, 128, 128, 16) == 256 * 32 * 8 * 130
    assert scratch_elems(2, 3, 4, 16, 7, 3) == 2 * 3 * 4 * 3 * 18


# ------------------------------------------------- the split against plain

# decode lengths one below, at and one above the 16- and 32-key boundaries,
# and 0 (no visible key)
BOUNDARY = np.array([15, 16, 17, 33], np.int32)


def _plain_and_split(q, pools, table, limits, q_lens=None, window=0, seg=SEG, mutant=None):
    kp, vp, ks, vs = (_t(a) for a in pools)
    args = (torch.from_numpy(q), kp.float() if ks is None else kp,
            vp.float() if ks is None else vp, _t(table), _t(limits),
            None if q_lens is None else _t(q_lens))
    kw = dict(k_scales=ks, v_scales=vs, window=window)
    return (paged_rows_plain(*args, **kw),
            paged_rows_split(*args, **kw, seg_pages=seg, mutant=mutant))


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("window", [0, 5, 20])
@pytest.mark.parametrize("seg", [1, 2, 3])
def test_split_matches_plain(int8, window, seg):
    pools = _pools(int8)
    rng = np.random.default_rng(1)
    # decode rows at the boundary lengths, plus a row with no visible key
    q = rng.standard_normal((4, 1, H, D)).astype(np.float32)
    for lengths in (BOUNDARY, np.array([0, 1, 32, 48], np.int32)):
        plain, split = _plain_and_split(q, pools, TABLE, lengths, window=window, seg=seg)
        np.testing.assert_allclose(split.numpy(), plain.numpy(), atol=2e-6, rtol=0)
        assert not split[lengths == 0].any()
    # a block of 6 positions per row starting on either side of a boundary,
    # one row with two dead positions
    q = rng.standard_normal((4, 6, H, D)).astype(np.float32)
    limits = np.array([11, 16, 27, 33], np.int32)
    q_lens = np.array([6, 6, 4, 6], np.int32)
    plain, split = _plain_and_split(q, pools, TABLE, limits, q_lens, window, seg)
    np.testing.assert_allclose(split.numpy(), plain.numpy(), atol=2e-6, rtol=0)
    assert not split[2, 4:].any()


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("window", [0, 6])
def test_split_matches_pallas_decode(int8, window):
    pytest.importorskip("jax")
    from fei_tpu.ops.pallas.paged_attention import paged_attention as jax_pa

    pools = _pools(int8)
    kp, vp, ks, vs = pools
    q = np.random.default_rng(2).standard_normal((4, H, D)).astype(np.float32)
    want = jax_pa(_j(q), _j(kp), _j(vp), _j(TABLE), _j(BOUNDARY), interpret=True,
                  k_scales=_j(ks), v_scales=_j(vs), window=window)
    _, split = _plain_and_split(q[:, None], pools, TABLE, BOUNDARY, window=window)
    np.testing.assert_allclose(split[:, 0].numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("window", [0, 5])
def test_split_matches_pallas_block(int8, window):
    pytest.importorskip("jax")
    from fei_tpu.ops.pallas.paged_attention import paged_attention_block as jax_pb

    pools = _pools(int8)
    kp, vp, ks, vs = pools
    T = 6
    before = np.array([10, 13, 15, 30], np.int32)  # blocks across the boundaries
    q = np.random.default_rng(3).standard_normal((4, T, H, D)).astype(np.float32)
    want = jax_pb(_j(q), _j(kp), _j(vp), _j(TABLE), _j(before), interpret=True,
                  k_scales=_j(ks), v_scales=_j(vs), window=window)
    _, split = _plain_and_split(q, pools, TABLE, before + 1, window=window)
    np.testing.assert_allclose(split.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("window", [0, 7])
def test_split_matches_pallas_ragged(int8, window):
    """Decode rows at the boundary lengths and chunk groups whose positions
    cross a boundary, one partial group and a dead row, in one call."""
    pytest.importorskip("jax")
    from fei_tpu.ops.pallas.ragged_paged_attention import (
        ragged_paged_attention as jax_ragged,
    )

    pools = _pools(int8)
    kp, vp, ks, vs = pools
    R = 4
    limits = np.array([16, 17, 14, 18, 33, 2], np.int32)
    q_lens = np.array([1, 1, 4, 4, 3, 0], np.int32)
    modes = np.array([1, 1, 0, 0, 0, 0], np.int32)
    table = TABLE[[0, 1, 2, 2, 3, 0]]
    q = np.random.default_rng(4).standard_normal((6, R, H, D)).astype(np.float32)
    want = np.asarray(jax_ragged(
        _j(q), _j(kp), _j(vp), _j(table), _j(limits), _j(q_lens), _j(modes),
        interpret=True, k_scales=_j(ks), v_scales=_j(vs), window=window))
    eff = effective_q_lens(_t(q_lens), _t(modes)).numpy()
    _, split = _plain_and_split(q, pools, table, limits, eff, window)
    split = split.numpy()
    for b in range(6):
        n = eff[b]
        np.testing.assert_allclose(split[b, :n], want[b, :n], atol=1e-5, rtol=0)
        assert not split[b, n:].any()
    got = ragged_paged_attention_plain(_t(q), *(_t(a) for a in (kp, vp, table, limits, q_lens,
                                                                 modes)),
                                       k_scales=_t(ks), v_scales=_t(vs), window=window)
    np.testing.assert_allclose(split, got.numpy(), atol=2e-6, rtol=0)


@pytest.mark.parametrize("window", [0, 9])
def test_dropped_segment_breaks_the_tolerance(window):
    """Leaving out a row's last segment is caught by the bound the kernels
    are held to, on rows that span several segments."""
    kp, vp, _, _ = (torch.from_numpy(a).bfloat16().float() if a is not None else None
                    for a in _pools(False))
    q = torch.randn(4, 3, H, D, generator=torch.Generator().manual_seed(0))
    lim = torch.tensor([17, 30, 40, 47], dtype=torch.int32)
    bt = torch.from_numpy(TABLE)
    tol = paged_rows_tolerance(q, kp, vp, bt, lim, window=window)
    ref = paged_rows_plain(q, kp, vp, bt, lim, window=window)
    split = paged_rows_split(q, kp, vp, bt, lim, window=window, seg_pages=SEG)
    assert ((split - ref).abs() <= tol).all()
    bad = paged_rows_split(q, kp, vp, bt, lim, window=window, seg_pages=SEG,
                           mutant="drop_last")
    assert ((bad - ref).abs() > tol).any(dim=(2, 3)).all()  # every row, every position


# --------------------------------------------------------------- scratch


@pytest.mark.parametrize("delta", [-1, 1, -(64 + 2)])
def test_launch_refuses_scratch_of_another_size(delta):
    """The launch path sizes the partials from the table width and refuses
    any scratch but exactly its plan's, before it loads a kernel."""
    kp = torch.zeros(P, K, 64, 64, dtype=torch.bfloat16)
    q = torch.zeros(2, 3, H, 64, dtype=torch.bfloat16)
    bt = torch.zeros(2, 40, dtype=torch.int32)
    lim = torch.ones(2, dtype=torch.int32)
    n = scratch_elems(2, 3, H, 64, 40)
    for bad in (torch.empty(n + delta), torch.empty(n, dtype=torch.float64)):
        with pytest.raises(ValueError, match="scratch must be"):
            launch("paged_attention", "fei_paged_attention", q, kp, kp, bt,
                   [("limits", lim)], None, None, None, 0, scratch=bad)


# ------------------------------------------------------------------- card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the paged kernels are CUDA C++ for sm_90a")
    return torch.device("cuda")


def _card_case(dev, lengths, Dh, int8, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    need = sum(-(-n // 64) for n in lengths)
    n_pages = need + 4
    width = max(-(-n // 64) for n in lengths) + 2
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(seed)) + 1
    bt = torch.zeros(len(lengths), width, dtype=torch.int32)
    used = 0
    for b, n in enumerate(lengths):
        bt[b, :-(-n // 64)] = perm[used:used + -(-n // 64)]
        used += -(-n // 64)
    if int8:
        kp = torch.randint(-127, 128, (n_pages, 2, 64, Dh), generator=gen, device=dev).to(torch.int8)
        vp = torch.randint(-127, 128, (n_pages, 2, 64, Dh), generator=gen, device=dev).to(torch.int8)
        ks = torch.rand(n_pages, 2, 1, 64, generator=gen, device=dev) * 0.02 + 0.002
        vs = torch.rand(n_pages, 2, 1, 64, generator=gen, device=dev) * 0.02 + 0.002
    else:
        kp = torch.randn(n_pages, 2, 64, Dh, generator=gen, device=dev).bfloat16()
        vp = torch.randn(n_pages, 2, 64, Dh, generator=gen, device=dev).bfloat16()
        ks = vs = None
    return kp, vp, ks, vs, bt.to(dev), gen


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_boundary_lengths_and_row_invariance_on_card(cuda_device, int8):
    """Decode rows one below, at and one above segment boundaries within the
    per-element tolerance; a decode row at position p bitwise the block
    form's row at p, for a row whose keys span several segments; two runs
    bitwise equal."""
    dev = cuda_device
    edge = SEGMENT_PAGES * 64
    lengths = [edge - 1, edge, edge + 1, 2 * edge + 1, 3 * edge + 70]
    kp, vp, ks, vs, bt, gen = _card_case(dev, lengths, 128, int8)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = torch.randn(len(lengths), 8, 128, generator=gen, device=dev).bfloat16()
    dec = paged_attention(q, kp, vp, bt, ln, k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    ref = paged_rows_plain(q[:, None].float(), kp if int8 else kp.float(),
                           vp if int8 else vp.float(), bt, ln, k_scales=ks, v_scales=vs)
    tol = paged_rows_tolerance(q[:, None], kp, vp, bt, ln, k_scales=ks, v_scales=vs)
    assert ((dec[:, None].float() - ref).abs() <= tol).all()
    assert torch.equal(paged_attention(q, kp, vp, bt, ln, k_scales=ks, v_scales=vs), dec)
    # the last row's final 40 positions as a block and one by one
    T, row = 40, len(lengths) - 1
    qb = torch.randn(1, T, 8, 128, generator=gen, device=dev).bfloat16()
    before = torch.tensor([lengths[row] - T], dtype=torch.int32, device=dev)
    blk = paged_attention_block(qb, kp, vp, bt[row:row + 1], before, k_scales=ks, v_scales=vs)
    for t in (0, 17, T - 1):
        one = paged_attention(qb[:, t], kp, vp, bt[row:row + 1], before + t + 1,
                              k_scales=ks, v_scales=vs)
        assert torch.equal(one, blk[:, t])
    rag = ragged_paged_attention(qb.reshape(5, 8, 8, 128), kp, vp,
                                 bt[row:row + 1].expand(5, -1).contiguous(),
                                 (before + 1 + 8 * torch.arange(5, device=dev)).int(),
                                 torch.full((5,), 8, dtype=torch.int32, device=dev),
                                 k_scales=ks, v_scales=vs)
    assert torch.equal(rag.reshape(1, T, 8, 128), blk)


@pytest.mark.cuda
def test_kernel_refuses_scratch_of_another_size_on_card(cuda_device):
    """The C entry point itself refuses scratch one segment short."""
    from fei_tpu_torch.ops.kernels.paged_attention import kernel_fn

    dev = cuda_device
    kp, vp, _, _, bt, gen = _card_case(dev, [3000], 128, False)
    q = torch.randn(1, 1, 8, 128, generator=gen, device=dev).bfloat16()
    out = torch.empty_like(q)
    n = scratch_elems(1, 1, 8, 128, bt.shape[1]) - 8 * 130
    short = torch.empty(n, dtype=torch.float32, device=dev)
    fn, _ = kernel_fn("paged_attention", "fei_paged_attention", 1)
    lim = torch.tensor([3000], dtype=torch.int32, device=dev)
    err = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), None, None, out.data_ptr(),
             short.data_ptr(), n, bt.data_ptr(), bt.stride(0), lim.data_ptr(),
             1, 1, 8, 2, 128, bt.shape[1], *q.stride()[:3], *out.stride()[:3],
             0, 128 ** -0.5, 0, SEGMENT_PAGES, torch.cuda.current_stream().cuda_stream)
    assert err != 0
