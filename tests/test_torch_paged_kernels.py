"""The port's paged kernels (K2 paged decode, K3 ragged) against the JAX
Pallas kernels.

On the CPU the wrappers run their plain versions (the kernels are CUDA
only); the JAX side runs ``fei_tpu.ops.pallas`` in interpret mode, as the
JAX package's own tests do. Inputs come from numpy with a fixed seed.
Tolerance: atol 1e-5 in fp32 for bf16-layout and int8 pools alike — the
int8 values and their scales are exact in fp32 on both sides, the Pallas
kernel folds the scales into the scores and weights where the plain
version dequantizes first, and the two orders differ by fp32 rounding
only (about 1e-7 at these sizes). The ``cuda``-marked tests hold the
kernels against the plain versions on the card and check the bitwise
identities K3 decode row == K2 (qt = 1) and K3 chunk group == K2 block.
jax is imported inside the parity tests only, so the ``cuda`` tests also
run where jax is not installed (``pytest -m cuda --noconftest``).
"""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import numpy as np
import pytest
import torch

from fei_tpu_torch.ops.kernels.paged_attention import (
    paged_attention,
    paged_attention_block,
    paged_rows_plain,
    paged_rows_tolerance,
)
from fei_tpu_torch.ops.kernels.ragged_paged_attention import (
    effective_q_lens,
    ragged_paged_attention,
)

P, K, PS, D, H = 16, 2, 8, 16, 4
TABLE = np.array([[3, 5, 1, 0, 0, 0], [7, 2, 9, 11, 14, 0], [4, 0, 0, 0, 0, 0],
                  [6, 8, 10, 12, 13, 15]], np.int32)


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


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("window", [0, 6])
def test_paged_attention_matches_pallas(int8, window):
    pytest.importorskip("jax")
    from fei_tpu.ops.pallas.paged_attention import paged_attention as jax_pa

    kp, vp, ks, vs = _pools(int8)
    lengths = np.array([13, 40, 1, 48], np.int32)  # ragged, page-padded
    q = np.random.default_rng(1).standard_normal((4, H, D)).astype(np.float32)
    want = jax_pa(_j(q), _j(kp), _j(vp), _j(TABLE), _j(lengths), interpret=True,
                  k_scales=_j(ks), v_scales=_j(vs), window=window)
    got = paged_attention(_t(q), _t(kp), _t(vp), _t(TABLE), _t(lengths),
                          k_scales=_t(ks), v_scales=_t(vs), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("window", [0, 5])
def test_paged_attention_block_matches_pallas(int8, window):
    pytest.importorskip("jax")
    from fei_tpu.ops.pallas.paged_attention import paged_attention_block as jax_pb

    kp, vp, ks, vs = _pools(int8)
    T = 6
    before = np.array([7, 30, 0, 40], np.int32)  # kv length before the block
    q = np.random.default_rng(2).standard_normal((4, T, H, D)).astype(np.float32)
    want = jax_pb(_j(q), _j(kp), _j(vp), _j(TABLE), _j(before), interpret=True,
                  k_scales=_j(ks), v_scales=_j(vs), window=window)
    got = paged_attention_block(_t(q), _t(kp), _t(vp), _t(TABLE), _t(before),
                                k_scales=_t(ks), v_scales=_t(vs), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("window", [0, 7])
def test_ragged_matches_pallas(int8, window):
    """Decode rows, chunk groups, a partial group and a dead row (q_len 0)
    in one call; live positions agree with the Pallas kernel, dead ones
    (which the Pallas kernel leaves as garbage) are zeros here."""
    pytest.importorskip("jax")
    from fei_tpu.ops.pallas.ragged_paged_attention import (
        ragged_paged_attention as jax_ragged,
    )

    kp, vp, ks, vs = _pools(int8)
    R = 4
    limits = np.array([14, 33, 37, 2], np.int32)
    q_lens = np.array([1, 4, 2, 0], np.int32)
    modes = np.array([1, 0, 0, 0], np.int32)
    table = TABLE[[0, 1, 1, 2]]
    q = np.random.default_rng(3).standard_normal((4, R, H, D)).astype(np.float32)
    want = np.asarray(jax_ragged(
        _j(q), _j(kp), _j(vp), _j(table), _j(limits), _j(q_lens), _j(modes),
        interpret=True, k_scales=_j(ks), v_scales=_j(vs), window=window))
    got = ragged_paged_attention(_t(q), _t(kp), _t(vp), _t(table), _t(limits),
                                 _t(q_lens), _t(modes), k_scales=_t(ks),
                                 v_scales=_t(vs), window=window).numpy()
    for b in range(4):
        n = q_lens[b]
        np.testing.assert_allclose(got[b, :n], want[b, :n], atol=1e-5, rtol=0)
        assert not got[b, n:].any()


def test_cpu_dispatch_takes_plain_path():
    """CPU tensors never reach a kernel: the launch counts do not move."""
    kp, vp, _, _ = _pools(False)
    q = torch.zeros(4, 2, H, D)
    before = (paged_attention.launches, ragged_paged_attention.launches)
    paged_attention_block(q, _t(kp), _t(vp), _t(TABLE), torch.tensor([1, 2, 3, 4],
                                                                     dtype=torch.int32))
    ragged_paged_attention(q, _t(kp), _t(vp), _t(TABLE), torch.ones(4, dtype=torch.int32),
                           torch.ones(4, dtype=torch.int32))
    assert (paged_attention.launches, ragged_paged_attention.launches) == before


def test_tolerance_catches_one_key_more():
    """The per-element bound the kernels are held to on the card cannot be
    met by attention that sees one key more per row."""
    kp, vp, _, _ = (torch.from_numpy(a).bfloat16().float() if a is not None else None
                    for a in _pools(False))
    q = torch.randn(4, 3, H, D, generator=torch.Generator().manual_seed(0))
    lim = torch.tensor([9, 20, 3, 30], dtype=torch.int32)
    bt = torch.from_numpy(TABLE)
    tol = paged_rows_tolerance(q, kp, vp, bt, lim)
    ref = paged_rows_plain(q, kp, vp, bt, lim)
    assert ((paged_rows_plain(q, kp, vp, bt, lim + 1) - ref).abs() > tol).any()
    assert torch.equal(effective_q_lens(torch.tensor([3, 3]), torch.tensor([1, 0])),
                       torch.tensor([1, 3], dtype=torch.int32))


# ------------------------------------------------------------------- card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the paged kernels are CUDA C++ for sm_90a")
    return torch.device("cuda")


def _card_pools(dev, n_pages, Kh, Dh, int8, gen):
    if int8:
        kp = torch.randint(-127, 128, (n_pages, Kh, 64, Dh), generator=gen,
                           device=dev).to(torch.int8)
        vp = torch.randint(-127, 128, (n_pages, Kh, 64, Dh), generator=gen,
                           device=dev).to(torch.int8)
        ks = torch.rand(n_pages, Kh, 1, 64, generator=gen, device=dev) * 0.02 + 0.002
        vs = torch.rand(n_pages, Kh, 1, 64, generator=gen, device=dev) * 0.02 + 0.002
        return kp, vp, ks, vs
    kp = torch.randn(n_pages, Kh, 64, Dh, generator=gen, device=dev).bfloat16()
    vp = torch.randn(n_pages, Kh, 64, Dh, generator=gen, device=dev).bfloat16()
    return kp, vp, None, None


def _table(dev, lengths, width, n_pages, gen):
    """Non-contiguous pages: a random permutation of 1..n_pages-1."""
    perm = torch.randperm(n_pages - 1, generator=gen, device="cpu") + 1
    bt = torch.zeros(len(lengths), width, dtype=torch.int32)
    used = 0
    for b, n in enumerate(lengths):
        need = -(-n // 64)
        bt[b, :need] = perm[used:used + need]
        used += need
    return bt.to(dev)


def _within(out, q, kp, vp, bt, lim, q_lens, ks, vs, window):
    ref = paged_rows_plain(q.float(), kp if ks is not None else kp.float(),
                           vp if ks is not None else vp.float(), bt, lim, q_lens,
                           k_scales=ks, v_scales=vs, window=window)
    tol = paged_rows_tolerance(q, kp, vp, bt, lim, q_lens, k_scales=ks, v_scales=vs,
                               window=window)
    return ((out.float() - ref).abs() <= tol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("D_", [64, 80, 128, 256])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_kernels_match_plain_and_each_other_on_card(cuda_device, D_, int8):
    """K2 (qt = 1 and block) and K3 within the per-element tolerance of the
    plain version; K3 decode rows bitwise K2 qt = 1, K3 chunk groups
    bitwise K2 block."""
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(0)
    cgen = torch.Generator().manual_seed(0)
    Kh, Hq, window = 2, 8, (96 if D_ == 80 else 0)
    lengths = [70, 300, 1, 129]
    n_pages = 40
    kp, vp, ks, vs = _card_pools(dev, n_pages, Kh, D_, int8, gen)
    bt = _table(dev, lengths, 8, n_pages, cgen)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = torch.randn(4, Hq, D_, generator=gen, device=dev).bfloat16()
    dec = paged_attention(q, kp, vp, bt, ln, k_scales=ks, v_scales=vs, window=window)
    torch.cuda.synchronize()
    assert _within(dec[:, None], q[:, None], kp, vp, bt, ln, None, ks, vs, window)

    T = 40  # a chunk of row 1 starting at 300 - T
    qb = torch.randn(1, T, Hq, D_, generator=gen, device=dev).bfloat16()
    before = torch.tensor([300 - T], dtype=torch.int32, device=dev)
    blk = paged_attention_block(qb, kp, vp, bt[1:2], before, k_scales=ks,
                                v_scales=vs, window=window)
    assert _within(blk, qb, kp, vp, bt[1:2], before + 1, None, ks, vs, window)

    R = 8
    nG = T // R
    qv = torch.cat([torch.nn.functional.pad(q[:, None], (0, 0, 0, 0, 0, R - 1)),
                    qb.reshape(nG, R, Hq, D_)]).contiguous()
    btv = torch.cat([bt, bt[1:2].expand(nG, -1)]).contiguous()
    limits = torch.cat([ln, 300 - T + 1 + R * torch.arange(nG, device=dev)]).int()
    q_lens = torch.tensor([1] * 4 + [R] * nG, dtype=torch.int32, device=dev)
    modes = torch.tensor([1] * 4 + [0] * nG, dtype=torch.int32, device=dev)
    rag = ragged_paged_attention(qv, kp, vp, btv, limits, q_lens, modes,
                                 k_scales=ks, v_scales=vs, window=window)
    torch.cuda.synchronize()
    assert torch.equal(rag[:4, 0], dec)
    assert torch.equal(rag[4:].reshape(1, T, Hq, D_), blk)
    assert not rag[:4, 1:].any()
