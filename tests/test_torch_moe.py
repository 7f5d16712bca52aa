"""The port's MoE layer (``fei_tpu_torch/ops/moe.py``) and its int8 expert
helpers against fei_tpu's, on the CPU.

The same numpy inputs go through ``fei_tpu.ops.moe.moe_mlp`` /
``moe_mlp_routed`` and their counterparts: fp32 at atol 1e-5 (the two
sides compute the same sums in other orders, ~1e-7 apart); bf16 at one
bf16 ulp of the output's scale (2^-7 relative to its largest element:
XLA and PyTorch may round a bf16 product or the combine differently),
with bf16 and int8 ``QTensor`` experts. Inside the port the routed form
equals the dense oracle at 1e-5 in fp32, k = E is the full softmax
mixture, ties in the router take the lower expert first as
``jax.lax.top_k`` does, and two routed runs are bitwise equal. MoE
``quantize_params`` bytes and scales are bit-equal to the JAX package's,
and under int4 the experts stay int8.
"""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fei_tpu.models import llama as jax_llama
from fei_tpu.models.configs import get_model_config
from fei_tpu.ops import moe as jax_moe
from fei_tpu.ops import quant as jax_quant
from fei_tpu_torch.models import llama as pt_llama
from fei_tpu_torch.models.configs import get_model_config as pt_get_model_config
from fei_tpu_torch.models.convert import params_from_jax
from fei_tpu_torch.ops import moe
from fei_tpu_torch.ops.quant import (
    QTensor,
    QTensor4,
    quantize,
    quantize_params,
    scale_expert_out,
    scale_rows,
    wcast,
)

B, T, H, I, E = 2, 9, 32, 48, 4
FP32_ATOL = 1e-5


def _inputs(seed=0, k=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H)).astype(np.float32)
    router = rng.standard_normal((H, E)).astype(np.float32)
    experts = [(rng.standard_normal(s) * s[-2] ** -0.5).astype(np.float32)
               for s in ((E, H, I), (E, H, I), (E, I, H))]
    return x, router, experts, k


def _jax_experts(experts, kind):
    ws = [jnp.asarray(w) for w in experts]
    if kind == "bf16":
        return [w.astype(jnp.bfloat16) for w in ws]
    if kind == "int8":
        return [jax_quant.quantize(w) for w in ws]
    return ws


def _pt_experts(experts, kind):
    ws = [torch.from_numpy(w) for w in experts]
    if kind == "bf16":
        return [w.bfloat16() for w in ws]
    if kind == "int8":
        return [quantize(w) for w in ws]
    return ws


FORMS = {"dense": (jax_moe.moe_mlp, moe.moe_mlp),
         "routed": (jax_moe.moe_mlp_routed, moe.moe_mlp_routed)}


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("experts_kind", ["float", "int8"])
def test_fp32_matches_reference(form, experts_kind):
    x, router, experts, k = _inputs()
    jfn, pfn = FORMS[form]
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(router),
                          *_jax_experts(experts, experts_kind), k))
    got = pfn(torch.from_numpy(x), torch.from_numpy(router),
              *_pt_experts(experts, experts_kind), k)
    assert got.dtype == torch.float32 and got.shape == (B, T, H)
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("experts_kind", ["bf16", "int8"])
def test_bf16_matches_reference(form, experts_kind):
    x, router, experts, k = _inputs(seed=1)
    jfn, pfn = FORMS[form]
    want = np.asarray(jfn(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(router),
                          *_jax_experts(experts, experts_kind), k).astype(jnp.float32))
    got = pfn(torch.from_numpy(x).bfloat16(), torch.from_numpy(router),
              *_pt_experts(experts, experts_kind), k)
    assert got.dtype == torch.bfloat16
    tol = 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


@pytest.mark.parametrize("experts_kind", ["float", "int8"])
def test_routed_equals_dense_in_the_port(experts_kind):
    x, router, experts, k = _inputs(seed=2)
    args = (torch.from_numpy(x), torch.from_numpy(router), *_pt_experts(experts, experts_kind), k)
    np.testing.assert_allclose(moe.moe_mlp_routed(*args).numpy(), moe.moe_mlp(*args).numpy(),
                               atol=FP32_ATOL, rtol=0)


def test_k_equals_e_is_the_full_softmax_mixture():
    x, router, experts, _ = _inputs(seed=3)
    xt, rt = torch.from_numpy(x), torch.from_numpy(router)
    g, u, d = (torch.from_numpy(w) for w in experts)
    p = torch.softmax(xt @ rt, dim=-1)  # [B, T, E]
    mix = sum(p[..., e:e + 1] * ((torch.nn.functional.silu(xt @ g[e]) * (xt @ u[e])) @ d[e])
              for e in range(E))
    for fn in (moe.moe_mlp, moe.moe_mlp_routed):
        np.testing.assert_allclose(fn(xt, rt, g, u, d, E).numpy(), mix.numpy(),
                                   atol=FP32_ATOL, rtol=0)


def test_router_ties_take_the_lower_expert_first():
    """An all-zero router ties every expert: both packages pick experts 0
    and 1 with weight 1/2 each (``jax.lax.top_k``'s order)."""
    x, _, experts, k = _inputs(seed=4)
    zero = np.zeros((H, E), np.float32)
    w, idx = moe._route(torch.zeros(5, E), k)
    assert idx.tolist() == [[0, 1]] * 5 and torch.equal(w, torch.full((5, 2), 0.5))
    for form, (jfn, pfn) in FORMS.items():
        want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(zero), *_jax_experts(experts, "float"), k))
        got = pfn(torch.from_numpy(x), torch.from_numpy(zero), *_pt_experts(experts, "float"), k)
        np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL, rtol=0, err_msg=form)


def test_routed_runs_are_bitwise_equal_and_sync_once():
    x, router, experts, k = _inputs(seed=5)
    args = (torch.from_numpy(x).bfloat16(), torch.from_numpy(router),
            *_pt_experts(experts, "int8"), k)
    assert torch.equal(moe.moe_mlp_routed(*args), moe.moe_mlp_routed(*args))
    assert moe.ROUTED_SYNCS_PER_LAYER == 1


def test_grouped_mm_matches_blocks():
    rng = np.random.default_rng(6)
    xs = torch.from_numpy(rng.standard_normal((7, H)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((E, H, I)).astype(np.float32))
    counts = [3, 0, 4, 0]
    out = moe.grouped_mm(xs, w, counts)
    torch.testing.assert_close(out[:3], xs[:3] @ w[0], rtol=0, atol=0)
    torch.testing.assert_close(out[3:], xs[3:] @ w[2], rtol=0, atol=0)


def test_expert_scale_helpers_match_reference():
    rng = np.random.default_rng(7)
    w = rng.standard_normal((E, H, I)).astype(np.float32)
    jq, pq = jax_quant.quantize(jnp.asarray(w)), quantize(torch.from_numpy(w))
    out = rng.standard_normal((2, E, 5, I)).astype(np.float32)
    np.testing.assert_array_equal(
        scale_expert_out(torch.from_numpy(out), pq, 1).numpy(),
        np.asarray(jax_quant.scale_expert_out(jnp.asarray(out), jq, 1)))
    rows = rng.standard_normal((6, I)).astype(np.float32)
    ids = np.array([3, 0, 0, 2, 1, 3])
    np.testing.assert_array_equal(
        scale_rows(torch.from_numpy(rows), pq, torch.from_numpy(ids)).numpy(),
        np.asarray(jax_quant.scale_rows(jnp.asarray(rows), jq, jnp.asarray(ids))))
    np.testing.assert_array_equal(wcast(pq, torch.float32).numpy(),
                                  np.asarray(jax_quant.wcast(jq, jnp.float32)))
    plain = torch.from_numpy(w)
    assert wcast(plain, torch.float32) is plain
    assert scale_rows(plain, plain, torch.zeros(1, dtype=torch.long)) is plain
    with pytest.raises(TypeError, match="QTensor4"):
        wcast(QTensor4(torch.zeros(1, 1, dtype=torch.int8), torch.ones(1, 1)), torch.float32)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_moe_bit_equal(bits):
    """MoE trees (hidden 256 so int4 applies to the attention leaves):
    every leaf's bytes and scales equal the JAX package's; under int4 the
    stacked experts stay int8 ``QTensor`` [L, E, in, out] / [L, E, 1, out]."""
    cfg = get_model_config("tiny-moe", hidden_size=256, intermediate_size=256,
                           num_heads=4, num_kv_heads=2)
    jparams = jax_llama.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    want = jax.tree.map(np.asarray, jax_quant.quantize_params(jparams, bits=bits))
    got = quantize_params(params_from_jax(jax.tree.map(np.asarray, jparams)), bits=bits)
    for name in ("w_gate", "w_up", "w_down"):
        leaf = got["layers"][name]
        assert isinstance(leaf, QTensor) and leaf.q.dtype == torch.int8
        assert leaf.s.shape == (cfg.num_layers, cfg.num_experts, 1, leaf.q.shape[-1])
    assert isinstance(got["layers"]["wq"], QTensor4 if bits == 4 else QTensor)
    assert isinstance(got["layers"]["router"], torch.Tensor)
    for name, leaf in got["layers"].items():
        ref = want["layers"][name]
        if isinstance(leaf, torch.Tensor):
            np.testing.assert_array_equal(leaf.numpy(), ref, err_msg=name)
            continue
        assert type(leaf).__name__ == type(ref).__name__, name
        for f, rf in zip(leaf, ref):
            np.testing.assert_array_equal(f.numpy(), np.asarray(rf), err_msg=name)


@pytest.mark.parametrize("mode", [None, "int8", "int4"])
def test_init_params_draws_the_moe_leaves(mode):
    """``init_params`` on an MoE config (the case that raised before C2):
    the router and the stacked experts, int8 under either mode."""
    cfg = pt_get_model_config("tiny-moe", hidden_size=256, intermediate_size=256)
    params = pt_llama.init_params(cfg, seed=0, dtype=torch.float32, quantize=mode)
    L, E_, h, inter = cfg.num_layers, cfg.num_experts, cfg.hidden_size, cfg.intermediate_size
    lay = params["layers"]
    assert lay["router"].shape == (L, h, E_)
    shapes = {"w_gate": (L, E_, h, inter), "w_up": (L, E_, h, inter), "w_down": (L, E_, inter, h)}
    for name, shape in shapes.items():
        leaf = lay[name]
        if mode is None:
            assert leaf.shape == shape and leaf.dtype == torch.float32
        else:
            assert isinstance(leaf, QTensor) and leaf.q.shape == shape
            assert leaf.s.shape == (*shape[:-2], 1, shape[-1])
    if mode is not None:
        # each stacked leaf is the quantization of its drawn fp32 layer
        again = pt_llama.init_params(cfg, seed=0, dtype=torch.float32)
        q = quantize(again["layers"]["w_up"][1])
        assert torch.equal(lay["w_up"].q[1], q.q) and torch.equal(lay["w_up"].s[1], q.s)
    assert isinstance(lay["wq"], QTensor4 if mode == "int4" else (QTensor if mode else torch.Tensor))


@pytest.mark.parametrize("quant", [False, True])
def test_params_from_jax_carries_the_moe_leaves(quant):
    cfg = get_model_config("tiny-moe")
    jparams = jax_llama.init_params(cfg, jax.random.PRNGKey(1), dtype=jnp.bfloat16,
                                    quantize="int8" if quant else None)
    host = jax.tree.map(np.asarray, jparams)
    got = params_from_jax(host)
    for name in ("router", "w_gate", "w_up", "w_down"):
        ref, leaf = host["layers"][name], got["layers"][name]
        if isinstance(leaf, QTensor):
            np.testing.assert_array_equal(leaf.q.numpy(), ref.q)
            np.testing.assert_array_equal(leaf.s.numpy(), ref.s)
        else:
            assert leaf.dtype == torch.bfloat16
            np.testing.assert_array_equal(leaf.float().numpy(), ref.astype(np.float32))
    assert isinstance(got["layers"]["w_up"], QTensor) == quant
