"""Expert parallelism in the port (fei_tpu_torch/parallel/expert.py, the
model's ``moe_mesh`` route and the ep engines) against fei_tpu, at
``tiny-moe`` in fp32 with the same weights (``params_from_jax``).

The port's side runs in gloo ranks on the CPU (tests/torch_mesh_ranks.py:
the two-rank group runs ep2, the four-rank group tp2ep2); fei_tpu's runs
on the conftest's virtual CPU mesh of the same shape. Tolerance 1e-4 (the
same fp32 formulas in another summation order).

- ``moe_mlp_ep`` and ``moe_mlp_ep_routed`` (dropless, and at a capacity
  that drops) against fei_tpu's on ep2, and the routed form with tp-split
  experts on tp2ep2;
- the dropped assignments equal the reference's: each token's kept
  choices are read from each package's output (the subset of its top-k
  experts whose weighted outputs sum to it);
- the reference's ``E % n`` errors;
- the ep2 and tp2ep2 engines (dropless) stream fei_tpu's single-chip
  greedy tokens, dense and paged (the twin of
  tests/test_expert_parallel.py's end-to-end engine test);
- the routing rule: on a tp2 mesh the MoE layers take the dense oracle,
  as the reference's ``routed = mesh is None`` does.
"""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import itertools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fei_tpu.engine.engine import GenerationConfig as JaxGen
from fei_tpu.engine.engine import InferenceEngine as JaxEngine
from fei_tpu.models import llama as jax_llama
from fei_tpu.models.configs import get_model_config
from fei_tpu.models.llama import init_params
from fei_tpu.parallel.expert import expert_flops_share, moe_mlp_ep, moe_mlp_ep_routed
from fei_tpu.parallel.mesh import make_mesh
from fei_tpu_torch.parallel import expert as pt_expert

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_mesh_ranks import (  # noqa: E402
    DROP_CF, EP_PROMPT, MAX_SEQ, N_NEW, PROMPTS, SEED, moe_x, parallel_results,
)

ATOL = 1e-4


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    return parallel_results(tmp_path_factory)


@pytest.fixture(scope="module")
def layer():
    cfg = get_model_config("tiny-moe", num_layers=2)
    params = init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    lay = {k: v[0] for k, v in params["layers"].items()}
    return cfg, (lay["router"], lay["w_gate"], lay["w_up"], lay["w_down"])


def _ep2():
    return make_mesh({"ep": 2}, devices=jax.devices()[:2])


def _kept(x, weights, out, k):
    """Each token's kept choices (a [N, k] bool mask), read from ``out``:
    the subset of its top-k experts whose router-weighted SwiGLU outputs
    sum closest to the token's output row."""
    router, wg, wu, wd = (np.asarray(w, np.float64) for w in weights)
    xf = np.asarray(x, np.float64).reshape(-1, router.shape[0])
    logits = xf @ router
    order = np.argsort(-logits, axis=-1, kind="stable")[:, :k]
    top = np.take_along_axis(logits, order, -1)
    w = np.exp(top - top.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    rows = np.asarray(out, np.float64).reshape(xf.shape[0], -1)
    masks = np.array(list(itertools.product([False, True], repeat=k)))
    kept = []
    for n in range(xf.shape[0]):
        contrib = []
        for j in range(k):
            e = order[n, j]
            g = xf[n] @ wg[e]
            act = g / (1 + np.exp(-g)) * (xf[n] @ wu[e])
            contrib.append(w[n, j] * (act @ wd[e]))
        contrib = np.array(contrib)
        errs = [np.abs(m.astype(float) @ contrib - rows[n]).max() for m in masks]
        kept.append(masks[int(np.argmin(errs))])
    return np.array(kept)


@pytest.mark.parametrize("form", ["ep", "ep dropless", "ep capacity"])
def test_layer_matches_fei_tpu(groups, layer, form):
    cfg, w = layer
    x = jnp.asarray(moe_x())
    k = cfg.num_experts_per_tok
    if form == "ep":
        want = moe_mlp_ep(x, *w, k, _ep2())
    elif form == "ep dropless":
        want = moe_mlp_ep_routed(x, *w, k, _ep2(), dropless=True)
    else:
        want = moe_mlp_ep_routed(x, *w, k, _ep2(), capacity_factor=DROP_CF)
    for r in groups["two"]:
        np.testing.assert_allclose(r[form], np.asarray(want), atol=ATOL, rtol=0)


def test_dropped_assignments_equal_the_reference(groups, layer):
    cfg, w = layer
    x = moe_x()
    k = cfg.num_experts_per_tok
    want = moe_mlp_ep_routed(jnp.asarray(x), *w, k, _ep2(), capacity_factor=DROP_CF)
    ref_kept = _kept(x, w, want, k)
    got_kept = _kept(x, w, groups["two"][0]["ep capacity"], k)
    assert 0 < (~ref_kept).sum() < ref_kept.size, "the capacity must drop some, not all"
    np.testing.assert_array_equal(got_kept, ref_kept)
    assert _kept(x, w, groups["two"][0]["ep dropless"], k).all()


def test_tp_split_experts_on_tp2ep2_match_fei_tpu(groups, layer):
    cfg, w = layer
    mesh = make_mesh({"tp": 2, "ep": 2}, devices=jax.devices()[:4])
    want = moe_mlp_ep_routed(jnp.asarray(moe_x()), *w, cfg.num_experts_per_tok, mesh,
                             dropless=True, tp_axis="tp")
    for r in groups["four"]:
        np.testing.assert_allclose(r["tp2ep2 dropless"], np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("case,fn", [("err E % n", moe_mlp_ep),
                                     ("err E % n routed", moe_mlp_ep_routed)])
def test_experts_must_divide_the_axis(groups, layer, case, fn):
    cfg, w = layer
    with pytest.raises(ValueError) as err:
        fn(jnp.asarray(moe_x()), w[0][:, :3], *w[1:], cfg.num_experts_per_tok, _ep2())
    assert groups["two"][0][case] == str(err.value)


def test_expert_flops_share_is_the_reference():
    for args in ((4096, 8, 2, 4), (1500, 8, 2, 2), (9, 4, 2, 2)):
        for cf in (1.0, 2.0):
            assert pt_expert.expert_flops_share(*args, capacity_factor=cf) == \
                expert_flops_share(*args, capacity_factor=cf)


@pytest.fixture(scope="module")
def jax_streams():
    """fei_tpu's single-chip tiny-moe engine: EP_PROMPT's greedy stream and
    the paged tests' three greedy streams and seeded stream."""
    eng = JaxEngine.from_config("tiny-moe", dtype=jnp.float32, max_seq_len=MAX_SEQ,
                                num_layers=2)
    greedy = JaxGen(max_new_tokens=N_NEW, ignore_eos=True, chunk=1)
    seeded = JaxGen(max_new_tokens=N_NEW, ignore_eos=True, chunk=1, seed=SEED,
                    temperature=0.8, top_p=0.9)
    out = {i: list(eng.generate_stream(p, greedy)) for i, p in enumerate(PROMPTS)}
    out["seeded"] = list(eng.generate_stream(PROMPTS[0], seeded))
    out["ep"] = eng.generate(EP_PROMPT, greedy).token_ids
    return out


def test_ep2_engine_streams_fei_tpu_single_chip(groups, jax_streams):
    r0 = groups["two"][0]
    assert all(r["ep_experts"] == 2 for r in groups["two"])  # 2 of 4 experts a rank
    assert r0["ep_stream"] == jax_streams["ep"]
    assert r0["ep_paged"] == {k: v for k, v in jax_streams.items() if k != "ep"}


def test_tp2ep2_engine_streams_fei_tpu_single_chip(groups, jax_streams):
    r0 = groups["four"][0]
    assert r0["tag"] == "tp2ep2"
    # experts over ep, each one's intermediate dim over tp
    assert all(r["w_up"] == (2, 2, 64, 64) for r in groups["four"])
    assert r0["stream"] == jax_streams["ep"]
    assert r0["paged"] == {k: v for k, v in jax_streams.items() if k != "ep"}


def test_tp2_moe_layers_take_the_oracle_as_the_reference(groups, monkeypatch):
    """The reference's rule, ``routed = mesh is None``: on a tp mesh a
    20-token prefill's MoE layers take the dense oracle (the port took
    ``moe_mlp_routed`` there before it followed the rule)."""
    calls = {"routed": 0, "oracle": 0}
    for key, name in (("routed", "moe_mlp_routed"), ("oracle", "moe_mlp")):
        real = getattr(jax_llama, name)
        monkeypatch.setattr(jax_llama, name, lambda *a, _r=real, _k=key: (
            calls.__setitem__(_k, calls[_k] + 1), _r(*a))[1])
    eng = JaxEngine.from_config("tiny-moe", dtype=jnp.float32, max_seq_len=MAX_SEQ,
                                num_layers=2,
                                mesh=make_mesh({"tp": 2}, devices=jax.devices()[:2]))
    eng.prefill([list(range(20, 40))], eng.new_cache(1))
    assert calls["routed"] == 0 and calls["oracle"] > 0  # traced once for the layers
    assert groups["two"][0]["tp2_moe_calls"] == {"routed": 0, "oracle": 2}
