"""The port's weight-only quantization (``fei_tpu_torch.ops.quant``) and its
int4 matmul wrapper (K4, ``ops/kernels/int4_matmul.py``) against fei_tpu.

Inputs come from numpy with a fixed seed and go through both packages.
- Quantizers: int8 ``q`` and packed int4 ``p`` bit-equal, scales within
  rtol 1e-6 (both divide in fp32 and round half to even).
- int8 products (``mm``, ``tied_logits``, ``embed_lookup``): fp32 atol 1e-5.
- int4 product against the JAX Pallas kernel in interpret mode, bf16 x, at
  the shapes where that kernel runs on the CPU: within
  ``int4_mm_tolerance`` — one bf16 ulp of each output, plus the fp32
  summation-order term K·2⁻²⁴·Σ|x_k w_k|, which is what separates the two
  where an output sits near zero (the two packages' BLAS sum the K
  products in different orders).
- int4 product against the JAX fallback ``int4_mm_xla`` at fp32 x: atol 1e-5.
The kernel itself is held against ``int4_mm_reference`` by the
``cuda``-marked tests, which skip without a card, and by chip_smoke.py.
jax is imported inside the parity tests only, so that the ``cuda`` tests
also run where jax is not installed (``pytest -m cuda --noconftest``).
"""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import numpy as np
import pytest
import torch

from fei_tpu_torch.ops import quant as pq
from fei_tpu_torch.ops.kernels import int4_matmul as k4
from fei_tpu_torch.ops.kernels.int4_matmul import (
    int4_mm,
    int4_mm_reference,
    int4_mm_tolerance,
)


def _w(shape, seed=0, scale=0.05):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _np(t):
    return np.asarray(t, dtype=np.float32) if t.dtype.kind == "V" else np.asarray(t)


# ------------------------------------------------------------- quantizers

@pytest.mark.parametrize("shape", [(512, 256), (3, 1024, 128)], ids=["2d", "stacked"])
def test_quantize_bit_equal_to_jax(shape):
    jnp = pytest.importorskip("jax.numpy")
    from fei_tpu.ops import quant as jq

    w = _w(shape)
    want, got = jq.quantize(jnp.asarray(w)), pq.quantize(torch.from_numpy(w))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_allclose(got.s.numpy(), np.asarray(want.s), rtol=1e-6, atol=0)
    assert got.q.dtype == torch.int8 and got.s.dtype == torch.float32
    assert got.shape == want.shape and tuple(got.s.shape) == want.s.shape

    want, got = jq.quantize4(jnp.asarray(w)), pq.quantize4(torch.from_numpy(w))
    np.testing.assert_array_equal(got.p.numpy(), np.asarray(want.p))
    np.testing.assert_allclose(got.s.numpy(), np.asarray(want.s), rtol=1e-6, atol=0)
    assert got.shape == want.shape and got.group_size == want.group_size == 128


def test_quantize_embed_and_dequantize_match_jax():
    jnp = pytest.importorskip("jax.numpy")
    from fei_tpu.ops import quant as jq

    w = _w((64, 512), seed=1)
    want, got = jq.quantize_embed(jnp.asarray(w)), pq.quantize_embed(torch.from_numpy(w))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_allclose(got.s.numpy(), np.asarray(want.s), rtol=1e-6, atol=0)
    w = _w((2, 512, 64), seed=2)
    for jfn, pfn in ((jq.quantize, pq.quantize), (jq.quantize4, pq.quantize4)):
        want = jq.dequantize(jfn(jnp.asarray(w)), jnp.float32)
        got = pq.dequantize(pfn(torch.from_numpy(w)), torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


def test_nibbles_hold_minus_and_plus_seven_in_both_halves():
    """Each group's extreme lands on ±7 exactly: a column whose low-half
    groups hold -7/+7 and whose high-half groups hold +7/-7 packs to the
    JAX package's bytes and unpacks to the same levels."""
    jnp = pytest.importorskip("jax.numpy")
    from fei_tpu.ops import quant as jq

    K, N = 512, 16
    w = _w((K, N), seed=3, scale=0.01)
    for g in range(K // 128):  # one extreme per group and column, alternating sign
        sign = -1.0 if g % 2 == 0 else 1.0
        w[g * 128 + 5, :] = sign * 1.0
    packed = pq.quantize4(torch.from_numpy(w))
    np.testing.assert_array_equal(packed.p.numpy(), np.asarray(jq.quantize4(jnp.asarray(w)).p))
    lo, hi = pq.unpack4(packed.p)
    assert lo[5].tolist() == [-7] * N and lo[128 + 5].tolist() == [7] * N
    assert hi[5].tolist() == [-7] * N and hi[128 + 5].tolist() == [7] * N
    jlo, jhi = jq.unpack4(jnp.asarray(packed.p.numpy()))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))


def test_odd_contraction_rejected():
    with pytest.raises(ValueError, match="divisible"):
        pq.quantize4(torch.ones(100, 64))


# --------------------------------------------------------------- products

def test_int8_products_match_jax():
    jnp = pytest.importorskip("jax.numpy")
    from fei_tpu.ops import quant as jq

    x = np.random.default_rng(4).standard_normal((2, 5, 256)).astype(np.float32)
    w = _w((256, 96), seed=5)
    want = jq.mm(jnp.asarray(x), jq.quantize(jnp.asarray(w)))
    got = pq.mm(torch.from_numpy(x), pq.quantize(torch.from_numpy(w)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)

    table = _w((40, 256), seed=6)
    jemb, pemb = jq.quantize_embed(jnp.asarray(table)), pq.quantize_embed(torch.from_numpy(table))
    want = jq.tied_logits(jnp.asarray(x), jemb)
    got = pq.tied_logits(torch.from_numpy(x), pemb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    ids = np.array([[0, 39, 7], [12, 12, 3]], np.int32)
    want = jq.embed_lookup(jemb, jnp.asarray(ids), jnp.float32)
    got = pq.embed_lookup(pemb, torch.from_numpy(ids).long(), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # plain tables pass through both
    np.testing.assert_allclose(
        pq.tied_logits(torch.from_numpy(x), torch.from_numpy(table)).numpy(),
        np.asarray(jq.tied_logits(jnp.asarray(x), jnp.asarray(table))), atol=1e-5, rtol=0)


@pytest.mark.parametrize("M,K,N", [(1, 2048, 256), (33, 4096, 512)])
def test_int4_mm_matches_pallas_interpret(M, K, N):
    jnp = pytest.importorskip("jax.numpy")
    import fei_tpu.ops.pallas.int4_matmul as jk
    from fei_tpu.ops import quant as jq

    w = _w((K, N), seed=M)
    x = np.random.default_rng(M + 1).standard_normal((M, K)).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    before = jk._kernel_invocations
    want = jk.int4_mm(jnp.asarray(x).astype(jnp.bfloat16), jq.quantize4(jnp.asarray(w)))
    assert jk._kernel_invocations == before + 1  # the Pallas kernel, not its fallback
    pw = pq.quantize4(torch.from_numpy(w))
    got = int4_mm(xb, pw)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (M, N)
    diff = (got.float() - torch.from_numpy(_np(want))).abs()
    assert (diff <= int4_mm_tolerance(xb, pw)).all()


def test_int4_mm_matches_fallback_fp32():
    jnp = pytest.importorskip("jax.numpy")
    from fei_tpu.ops import quant as jq
    from fei_tpu.ops.pallas.int4_matmul import int4_mm_xla

    w = _w((512, 192), seed=7)
    x = np.random.default_rng(8).standard_normal((2, 3, 512)).astype(np.float32)
    want = int4_mm_xla(jnp.asarray(x), jq.quantize4(jnp.asarray(w)))
    got = pq.mm(torch.from_numpy(x), pq.quantize4(torch.from_numpy(w)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 3, 192)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_cpu_tensors_take_the_plain_version():
    w = pq.quantize4(torch.from_numpy(_w((512, 64), seed=9)))
    x = torch.randn(4, 512, generator=torch.Generator().manual_seed(0))
    before = int4_mm.launches
    out = int4_mm(x, w)
    assert int4_mm.launches == before  # no kernel on the CPU
    torch.testing.assert_close(out, int4_mm_reference(x, w), atol=0, rtol=0)
    with pytest.raises(ValueError, match="per-layer"):
        int4_mm(x, pq.QTensor4(w.p[None], w.s[None]))
    with pytest.raises(ValueError, match="contraction mismatch"):
        int4_mm(torch.ones(4, 256), w)


def test_kernel_checks_name_the_shape():
    """The wrapper's refusals (run before a launch) name what the kernel
    does not take: K % 256, N % 8, the types, a strided row."""
    x = torch.zeros(2, 512, dtype=torch.bfloat16)
    ok = pq.quantize4(torch.from_numpy(_w((512, 64))))
    k4._check(x, ok)  # passes
    with pytest.raises(ValueError, match=r"x \[2, 384\].*K % 256"):
        k4._check(torch.zeros(2, 384, dtype=torch.bfloat16),
                  pq.QTensor4(torch.zeros(192, 64, dtype=torch.int8), torch.ones(3, 64)))
    with pytest.raises(ValueError, match="N % 8"):
        k4._check(x, pq.QTensor4(ok.p[:, :60].contiguous(), ok.s[:, :60].contiguous()))
    with pytest.raises(TypeError, match="int8"):
        k4._check(x, pq.QTensor4(ok.p.to(torch.int32), ok.s))
    with pytest.raises(ValueError, match="contiguous"):
        k4._check(torch.zeros(2, 1024, dtype=torch.bfloat16)[:, ::2], ok)


def test_tolerance_holds_rounding_and_catches_mutants():
    """A kernel-like result (the reference's fp32 sum rounded to bf16) sits
    inside ``int4_mm_tolerance``; the two mutants the card run also shows —
    lo and hi planes swapped, each group read with the next group's scale —
    break it at most elements."""
    K, N = 1024, 128
    w = pq.quantize4(torch.from_numpy(_w((K, N), seed=10)))
    x = torch.randn(16, K, generator=torch.Generator().manual_seed(1)).bfloat16()
    ref = int4_mm_reference(x.float(), w)
    tol = int4_mm_tolerance(x, w)
    assert ((ref.bfloat16().float() - ref).abs() <= tol).all()
    swapped = pq.QTensor4(((w.p & 0xF) << 4) | ((w.p >> 4) & 0xF), w.s)
    next_scale = pq.QTensor4(w.p, torch.roll(w.s, -1, dims=0))
    for mutant in (swapped, next_scale):
        caught = ((int4_mm_reference(x.float(), mutant) - ref).abs() > tol).float().mean()
        assert caught > 0.5, caught


def _segmented(x: torch.Tensor, w: pq.QTensor4) -> torch.Tensor:
    """K4's summation order emulated on the CPU: per segment of
    ``split_plan`` a fresh fp32 accumulator takes the segment's 16-row
    steps in order, the low plane's before the high plane's (each product
    exact in fp32, added one at a time); the segments go into a total that
    starts at 0, in order; the total is rounded to bf16. Element by element,
    so no row's arithmetic can see another row."""
    K2 = w.p.shape[0]
    w_lo, w_hi = (plane.float() for plane in k4._planes(w))
    xb = x.to(torch.bfloat16).float()
    x_lo, x_hi = xb[:, :K2], xb[:, K2:]
    total = torch.zeros(x.shape[0], w.p.shape[1])
    for a, b in k4.split_plan(2 * K2):
        acc = torch.zeros_like(total)
        for k0 in range(a, b, 16):
            for xs, ws in ((x_lo, w_lo), (x_hi, w_hi)):
                for k in range(k0, k0 + 16):
                    acc.addcmul_(xs[:, k:k + 1], ws[k:k + 1])
        total += acc
    return total.bfloat16()


@pytest.mark.parametrize("K", [512, 2048, 4096, 14336])
def test_split_plan_depends_on_k_alone(K):
    """The segments cover the packed rows in order, 256 at a time (the last
    may be shorter, a multiple of 128), and are the plan for any M: the
    function sees K only, and the wrapper sizes the decode scratch from
    it."""
    import inspect

    assert list(inspect.signature(k4.split_plan).parameters) == ["K"]
    plan = k4.split_plan(K)
    assert plan[0][0] == 0 and plan[-1][1] == K // 2
    assert all(b == c for (_, b), (c, _) in zip(plan, plan[1:]))
    assert all(b - a == k4.SEGMENT for a, b in plan[:-1])
    assert (plan[-1][1] - plan[-1][0]) % 128 == 0
    assert k4.split_plan(K) == plan  # the same for an M = 1 and an M = 2048 call


@pytest.mark.parametrize("M,K,N", [(1, 2048, 256), (33, 4096, 512)])
def test_segmented_order_within_tolerance_and_row_invariant(M, K, N):
    """The kernel's segmented fp32 order, emulated, stays within
    ``int4_mm_tolerance`` of ``int4_mm_reference`` at the CPU test shapes,
    and a row's result is bitwise the same at M = 1 and at M = 64."""
    w = pq.quantize4(torch.from_numpy(_w((K, N), seed=M)))
    x = torch.from_numpy(np.random.default_rng(M + 1).standard_normal((64, K))
                         .astype(np.float32)).bfloat16()
    got = _segmented(x[:M], w)
    ref = int4_mm_reference(x[:M].float(), w)
    assert ((got.float() - ref).abs() <= int4_mm_tolerance(x[:M], w)).all()
    assert torch.equal(_segmented(x, w)[:1], _segmented(x[:1], w))


def test_leaf_selection_matches_jax(monkeypatch):
    """``quantize_params`` picks the same leaves as the JAX package: int4
    where the contraction divides by 256, int8 for an ineligible one and
    for lm_head unless opted in, norms and the embedding untouched."""
    jnp = pytest.importorskip("jax.numpy")
    from fei_tpu.ops import quant as jq

    shapes = {"wq": (2, 512, 256), "wk": (2, 100, 128), "attn_norm": (2, 512)}

    def kinds(lib, ones, **kw):
        tree = {"layers": {k: ones(s) for k, s in shapes.items()},
                "lm_head": ones((512, 1024)), "embed": ones((64, 512))}
        out = lib.quantize_params(tree, bits=4, **kw)
        name = lambda v: type(v).__name__ if isinstance(v, tuple) else "plain"  # noqa: E731
        return {**{k: name(v) for k, v in out["layers"].items()},
                "lm_head": name(out["lm_head"]), "embed": name(out["embed"])}

    jones, pones = (lambda s: jnp.ones(s, jnp.float32)), (lambda s: torch.ones(s))
    got = kinds(pq, pones)
    assert got == kinds(jq, jones) == {"wq": "QTensor4", "wk": "QTensor", "attn_norm": "plain",
                                       "lm_head": "QTensor", "embed": "plain"}
    # the opt-in: a keyword here, FEI_TPU_INT4_LM_HEAD=1 in the JAX package
    monkeypatch.setenv("FEI_TPU_INT4_LM_HEAD", "1")
    assert kinds(pq, pones, int4_lm_head=True) == kinds(jq, jones) == {**got, "lm_head": "QTensor4"}
    for key, shape, moe in (("lm_head", (512, 8), False), ("w_gate", (2, 512, 8), True),
                            ("w_up", (512, 8), False), ("wo", (384, 8), False)):
        w = type("W", (), {"shape": shape})()
        assert pq._int4_ok(key, w, moe, int4_lm_head=True) == jq._int4_ok(key, w, moe)


def test_param_bytes_matches_jax():
    jnp = pytest.importorskip("jax.numpy")
    from fei_tpu.ops import quant as jq

    w = _w((2, 512, 256))
    jt = jq.quantize_params({"layers": {"wq": jnp.asarray(w), "attn_norm": jnp.ones((2, 512))}},
                            bits=4)
    pt = pq.quantize_params({"layers": {"wq": torch.from_numpy(w),
                                        "attn_norm": torch.ones(2, 512)}}, bits=4)
    assert pq.param_bytes(pt) == jq.param_bytes(jt) == 2 * 256 * 256 + 2 * 4 * 256 * 4 + 2 * 512 * 4


# ------------------------------------------------------------------- card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K4 is CUDA C++ for sm_90a")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(1, 4096, 1024), (200, 14336, 4096)])
def test_kernel_matches_plain_on_card(cuda_device, M, K, N):
    """K4 within ``int4_mm_tolerance`` of its plain version at a decode and
    a prefill-sized shape, and row 0 of the larger call bitwise equal to a
    one-row call on that row (the kernel's k-order does not follow M)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    w = pq.quantize4(torch.randn(K, N, generator=gen, device=cuda_device) * 0.02)
    x = torch.randn(M, K, generator=gen, device=cuda_device).bfloat16()
    before = int4_mm.launches
    out = int4_mm(x, w)
    torch.cuda.synchronize()
    assert int4_mm.launches == before + 1
    ref = int4_mm_reference(x.float(), w)
    assert ((out.float() - ref).abs() <= int4_mm_tolerance(x, w)).all()
    assert torch.equal(int4_mm(x[:1], w), out[:1])
