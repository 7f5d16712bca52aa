"""The port's basic ops against fei_tpu's, on the same numpy inputs, in
fp32: rmsnorm (incl. the Gemma offset), the Phi LayerNorm, RoPE (incl.
partial rotary) and the plain GQA attention (ragged kv_length, window).
Tolerance: atol 1e-5 — both sides compute in fp32 and differ only in
summation order."""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fei_tpu.models import llama as jax_llama
from fei_tpu.models.configs import get_model_config
from fei_tpu.ops.attention import attention as jax_attention
from fei_tpu.ops.rmsnorm import rms_norm as jax_rms_norm
from fei_tpu.ops.rope import apply_rope as jax_apply_rope
from fei_tpu.ops.rope import compute_rope_freqs as jax_rope_freqs
from fei_tpu_torch.models import llama as pt_llama
from fei_tpu_torch.models.configs import get_model_config as pt_get_model_config
from fei_tpu_torch.ops.attention import attention as pt_attention
from fei_tpu_torch.ops.rmsnorm import rms_norm as pt_rms_norm
from fei_tpu_torch.ops.rope import apply_rope as pt_apply_rope
from fei_tpu_torch.ops.rope import compute_rope_freqs as pt_rope_freqs

ATOL = 1e-5


def _close(jax_out, pt_out, atol=ATOL):
    np.testing.assert_allclose(
        np.asarray(jax_out), pt_out.detach().numpy(), atol=atol, rtol=0
    )


@pytest.mark.parametrize("offset", [False, True])
def test_rms_norm(offset):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    _close(
        jax_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, offset=offset),
        pt_rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5, offset=offset),
    )


def test_phi_layernorm():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    jcfg = get_model_config("tiny-phi")
    pcfg = pt_get_model_config("tiny-phi")
    _close(
        jax_llama._norm(jnp.asarray(x), jnp.asarray(w), jcfg, b=jnp.asarray(b)),
        pt_llama._norm(torch.from_numpy(x), torch.from_numpy(w), pcfg,
                       b=torch.from_numpy(b)),
    )


def test_config_presets_match():
    """The port's configs module is a copy: every preset is field-equal."""
    from fei_tpu.models.configs import MODEL_CONFIGS as jax_cfgs
    from fei_tpu_torch.models.configs import MODEL_CONFIGS as pt_cfgs

    assert sorted(jax_cfgs) == sorted(pt_cfgs)
    for name, cfg in jax_cfgs.items():
        assert vars(cfg) == vars(pt_cfgs[name]), name


@pytest.mark.parametrize("rope_dim", [32, 8])  # full head, Phi partial rotary
def test_rope(rope_dim):
    rng = np.random.default_rng(2)
    D, S = 32, 64
    x = rng.standard_normal((2, 6, 4, D)).astype(np.float32)
    pos = np.stack([np.arange(6) + 3, np.arange(6) + 40]).astype(np.int32)
    jcos, jsin = jax_rope_freqs(rope_dim, S, 10000.0)
    pcos, psin = pt_rope_freqs(rope_dim, S, 10000.0)
    _close(jcos, pcos)
    _close(jsin, psin)
    _close(
        jax_llama._rope(jnp.asarray(x), jcos, jsin, jnp.asarray(pos), rope_dim),
        pt_llama._rope(torch.from_numpy(x), pcos, psin,
                       torch.from_numpy(pos).long(), rope_dim),
    )
    if rope_dim == D:
        _close(
            jax_apply_rope(jnp.asarray(x), jcos, jsin, jnp.asarray(pos)),
            pt_apply_rope(torch.from_numpy(x), pcos, psin, torch.from_numpy(pos).long()),
        )


@pytest.mark.parametrize(
    "kv_length,window",
    [([9, 9], 0), ([9, 5], 0), ([12, 7], 4)],
    ids=["gqa", "ragged", "window"],
)
def test_attention(kv_length, window):
    rng = np.random.default_rng(3)
    B, T, H, K, D, S = 2, 4, 8, 2, 16, 16
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, K, D)).astype(np.float32)
    v = rng.standard_normal((B, S, K, D)).astype(np.float32)
    kv = np.asarray(kv_length, dtype=np.int32)
    pos = (kv[:, None] - T + np.arange(T)[None, :]).astype(np.int32)
    _close(
        jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      jnp.asarray(pos), jnp.asarray(kv), window=window),
        pt_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                     torch.from_numpy(pos).long(), torch.from_numpy(kv),
                     window=window),
    )


def test_mlp_activations_match():
    """SwiGLU and the tanh-approximate GeGLU of both packages agree."""
    rng = np.random.default_rng(4)
    g = rng.standard_normal((3, 7)).astype(np.float32) * 4
    for name in ("tiny", "tiny-gemma"):
        _close(
            jax_llama._mlp_act(get_model_config(name), jnp.asarray(g)),
            pt_llama._mlp_act(pt_get_model_config(name), torch.from_numpy(g)),
        )


def test_unported_families_raise(monkeypatch):
    """Every model family is ported: MoE configs (C2) draw the router and
    the stacked experts, also on a dense preset given experts; expert
    parallelism over a mesh is ported (C4): ``_moe`` given a mesh with an
    ep axis takes the routed ep form (tp-composed on tp2ep2,
    ``FEI_TPU_EP_CAPACITY=dropless`` exact), a mesh without one the
    single-device forms."""
    params = pt_llama.init_params(pt_get_model_config("tiny-moe"))
    assert params["layers"]["router"].shape == (2, 64, 4)
    assert params["layers"]["w_down"].shape == (2, 4, 128, 64)
    cfg = replace(pt_get_model_config("tiny"), num_experts=2)
    lay = pt_llama.init_params(cfg, dtype=torch.float32)["layers"]
    assert lay["w_gate"].shape == (cfg.num_layers, 2, cfg.hidden_size, cfg.intermediate_size)
    from fei_tpu_torch.parallel import expert as pt_expert
    from fei_tpu_torch.parallel.mesh import Mesh

    seen = []
    monkeypatch.setattr(pt_expert, "moe_mlp_ep_routed",
                        lambda *a, **kw: seen.append((a[-1].shape, kw)) or torch.zeros_like(a[0]))
    monkeypatch.setenv("FEI_TPU_EP_CAPACITY", "dropless")
    lp = pt_llama.layer_params({"layers": lay}, 0)
    y = torch.zeros((1, 2, cfg.hidden_size))
    pt_llama._moe(cfg, y, lp, True, moe_mesh=Mesh({"tp": 2, "ep": 2}))
    assert seen == [({"dp": 1, "tp": 2, "ep": 2, "sp": 1, "pp": 1},
                     dict(dropless=True, tp_axis="tp",
                          intermediate_size=cfg.intermediate_size))]
    assert pt_llama._moe(cfg, y, lp, True, moe_mesh=Mesh({"tp": 2})).shape == y.shape
    assert len(seen) == 1
