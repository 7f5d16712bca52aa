"""The port's training path against fei_tpu's, on the CPU in fp32.

The same weights (JAX init -> numpy -> ``params_from_jax``, norm and bias
leaves randomized) and the same token batch (numpy, fixed seed) go through
``fei_tpu.models.llama.forward_train`` / ``fei_tpu.engine.train`` and their
counterparts in ``fei_tpu_torch``; the optimizer state crosses through
``opt_state_from_jax``. Tolerances: logits atol 2e-4 (summation order
through a few layers, as tests/test_torch_model.py); loss, gradients,
clipped gradients and updated parameters atol 1e-5 in fp32 — the two sides
compute the same formulas and differ in summation order, which leaves
~1e-7 of noise on a gradient element. The moments are held tighter (mu
atol 1e-7, nu atol 5e-9: they are 0.1 g and 0.05 g^2 after a step). The
parameters are compared at the default learning rate 1e-4: Adam divides by
sqrt(nu) + 1e-8, so the few elements whose gradient is itself ~1e-7 move by
a noisy share of one step (up to 7% of 1e-4 seen); all but 0.1% of the
elements must agree to 1e-6, a hundredth of a step. The model checkpoints
(``engine/checkpoint.py``) are tested here too. The train step's test on
the card is in tests/test_torch_flash_bwd.py, which imports no jax at
module level.
"""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fei_tpu.engine import train as jax_train
from fei_tpu.models import llama as jax_llama
from fei_tpu.models.configs import get_model_config
from fei_tpu_torch.engine import latest_step, restore_checkpoint, save_checkpoint
from fei_tpu_torch.engine.train import (
    TrainConfig,
    loss_and_grads,
    make_optimizer,
    make_train_step,
)
from fei_tpu_torch.models import llama as pt_llama
from fei_tpu_torch.models.configs import get_model_config as pt_get_model_config
from fei_tpu_torch.models.convert import opt_state_from_jax, params_from_jax
from fei_tpu_torch.ops.quant import quantize_params
from fei_tpu_torch.utils.errors import CheckpointError, EngineError, TrainingError
from fei_tpu_torch.utils.tree import flatten, tree_map

REPO = Path(__file__).resolve().parents[1]
FAMILIES = ["tiny", "tiny-bias", "tiny-gemma", "tiny-phi", "tiny-swa"]
LOGITS_ATOL = 2e-4
ATOL = 1e-5


def _shared_params(name: str, **overrides):
    """JAX fp32 params with randomized norm/bias leaves: (jax tree, numpy tree)."""
    cfg = get_model_config(name, **overrides)
    params = jax_llama.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    host = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(0)

    def perturb(tree):
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                perturb(leaf)
            elif "norm" in key or key.startswith("b") or key.endswith("_b"):
                tree[key] = (leaf + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    perturb(host)
    return jax.tree.map(jnp.asarray, host), host


def _tokens(cfg, B, T, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)


def _assert_tree_close(got: dict, want, atol, what):
    want = flatten(jax.tree.map(np.asarray, want))
    got = flatten(got)
    assert set(got) == set(want)
    for path, leaf in got.items():
        np.testing.assert_allclose(leaf.numpy(), want[path], atol=atol, rtol=0,
                                   err_msg=f"{what}: {path}")


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_train_logits_match_jax(name):
    """T = 70 crosses the flash threshold: the port's ``flash=True`` takes
    its flash wrapper (the plain version on the CPU), the JAX side its XLA
    oracle, as on a CPU backend."""
    jparams, host = _shared_params(name)
    jcfg, pcfg = get_model_config(name), pt_get_model_config(name)
    toks = _tokens(jcfg, 2, 70)
    want = np.asarray(jax_llama.forward_train(jparams, jcfg, jnp.asarray(toks), remat=True))
    pparams = params_from_jax(host)
    for flash in (None, True):
        with torch.no_grad():
            got = pt_llama.forward_train(pparams, pcfg, torch.from_numpy(toks), flash=flash)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["tiny", "tiny-phi", "tiny-swa"])
def test_remat_on_equals_off(name):
    """Recomputing the layers in the backward changes neither the loss nor
    a gradient (the same kernels on the same values: bitwise on the CPU)."""
    pcfg = pt_get_model_config(name)
    params = pt_llama.init_params(pcfg, seed=2, dtype=torch.float32)
    toks = torch.from_numpy(_tokens(pcfg, 2, 17))
    loss_a, grads_a = loss_and_grads(params, pcfg, toks, remat=True, device="cpu")
    loss_b, grads_b = loss_and_grads(params, pcfg, toks, remat=False, device="cpu")
    assert torch.equal(loss_a, loss_b)
    for (path, a), b in zip(flatten(grads_a).items(), flatten(grads_b).values()):
        assert torch.equal(a, b), path


def test_forward_train_matches_cached_forward():
    """The cache-free training forward and the KV-cache inference forward
    agree on the same tokens (the port's twin of
    tests/test_parallel.py::test_forward_train_matches_cached_forward)."""
    pcfg = pt_get_model_config("tiny")
    params = pt_llama.init_params(pcfg, seed=0, dtype=torch.float32)
    toks = torch.from_numpy(_tokens(pcfg, 2, 6))
    with torch.no_grad():
        train_logits = pt_llama.forward_train(params, pcfg, toks, remat=False)
    infer_logits, _ = pt_llama.forward(
        params, pcfg, toks, pt_llama.KVCache.create(pcfg, 2, 8, torch.float32))
    torch.testing.assert_close(train_logits, infer_logits, atol=1e-4, rtol=1e-4)


def test_grads_accumulate_into_the_stacked_buffer():
    """``loss_and_grads`` (per-layer autograd leaves whose ``.grad`` is a
    view of one stacked buffer) gives what autograd gives on the stacked
    parameters themselves."""
    pcfg = pt_get_model_config("tiny-bias")
    params = pt_llama.init_params(pcfg, seed=4, dtype=torch.float32)
    toks = torch.from_numpy(_tokens(pcfg, 2, 12)).long()
    loss, grads = loss_and_grads(params, pcfg, toks, remat=False, device="cpu")
    leaves = tree_map(lambda t: t.clone().requires_grad_(True), params)
    logits = pt_llama.forward_train(leaves, pcfg, toks[:, :-1], remat=False)
    want = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), toks[:, 1:].reshape(-1))
    want.backward()
    torch.testing.assert_close(loss, want.detach(), atol=0, rtol=0)
    for (path, g), leaf in zip(flatten(grads).items(), flatten(leaves).values()):
        torch.testing.assert_close(g, leaf.grad, atol=1e-6, rtol=0, msg=path)


@pytest.mark.parametrize("name,weight_decay", [("tiny", 0.0), ("tiny-swa", 0.01),
                                               ("tiny-phi", 0.01)])
def test_train_steps_match_jax(name, weight_decay):
    """Two steps of both packages on the same weights and batch: loss,
    raw and clipped gradients at step 0, then parameters and optimizer
    state after each step."""
    overrides = {"num_layers": 2}
    jparams, host = _shared_params(name, **overrides)
    jcfg, pcfg = get_model_config(name, **overrides), pt_get_model_config(name, **overrides)
    toks = _tokens(jcfg, 2, 16)
    kw = dict(learning_rate=1e-4, weight_decay=weight_decay, grad_clip=1.0, remat=True)

    def jax_loss(p):
        logits = jax_llama.forward_train(p, jcfg, jnp.asarray(toks)[:, :-1])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(toks)[:, 1:]).mean()

    jloss, jgrads = jax.value_and_grad(jax_loss)(jparams)
    jclipped, _ = optax.clip_by_global_norm(1.0).update(jgrads, optax.EmptyState())

    pparams = params_from_jax(host)
    opt, step = make_train_step(pcfg, TrainConfig(**kw), device="cpu")
    loss, grads = loss_and_grads(pparams, pcfg, torch.from_numpy(toks), device="cpu")
    np.testing.assert_allclose(float(loss), float(jloss), atol=ATOL, rtol=0)
    _assert_tree_close(grads, jgrads, ATOL, "gradients")
    gnorm = opt.global_norm(grads)
    np.testing.assert_allclose(float(gnorm), float(optax.global_norm(jgrads)), rtol=1e-5)
    assert float(gnorm) > 1.0  # the clip bites
    _assert_tree_close(tree_map(lambda g: g / gnorm * 1.0, grads), jclipped, ATOL,
                       "clipped gradients")

    jopt, jstep = jax_train.make_train_step(jcfg, jax_train.TrainConfig(**kw))
    jstate = jopt.init(jparams)
    pstate = opt.init(pparams)
    for i in range(2):
        jparams, jstate, jl = jstep(jparams, jstate, jnp.asarray(toks))
        pparams, pstate, pl = step(pparams, pstate, torch.from_numpy(toks))
        np.testing.assert_allclose(float(pl), float(jl), atol=ATOL, rtol=0)
        _assert_tree_close(pparams, jparams, ATOL, f"parameters after step {i}")
        want_params = flatten(jax.tree.map(np.asarray, jparams))
        off = sum(int((np.abs(leaf.numpy() - want_params[path]) > 1e-6).sum())
                  for path, leaf in flatten(pparams).items())
        assert off <= 1e-3 * sum(leaf.numel() for leaf in flatten(pparams).values())
        want_state = opt_state_from_jax(jax.tree.map(np.asarray, jstate))
        assert int(pstate["count"]) == int(want_state["count"]) == i + 1
        for moment, atol in (("mu", 1e-7), ("nu", 5e-9)):
            for (path, got), want in zip(flatten(pstate[moment]).items(),
                                         flatten(want_state[moment]).values()):
                torch.testing.assert_close(got, want, atol=atol, rtol=0,
                                           msg=f"{moment} {path} after step {i}")


def test_opt_state_from_jax_continues_the_run():
    """One step in the JAX package, weights and optimizer state carried
    across, the second step in the port: the JAX package's second step."""
    jparams, _ = _shared_params("tiny", num_layers=2)
    jcfg, pcfg = get_model_config("tiny", num_layers=2), pt_get_model_config("tiny", num_layers=2)
    toks = _tokens(jcfg, 2, 16)
    kw = dict(learning_rate=1e-4, weight_decay=0.01)
    jopt, jstep = jax_train.make_train_step(jcfg, jax_train.TrainConfig(**kw))
    jparams, jstate, _ = jstep(jparams, jopt.init(jparams), jnp.asarray(toks))
    pparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    pstate = opt_state_from_jax(jax.tree.map(np.asarray, jstate))
    assert int(pstate["count"]) == 1 and set(pstate) == {"count", "mu", "nu"}
    assert flatten(pstate["mu"]).keys() == flatten(pparams).keys()
    _, step = make_train_step(pcfg, TrainConfig(**kw), device="cpu")
    pparams, pstate, pl = step(pparams, pstate, torch.from_numpy(toks))
    jparams, jstate, jl = jstep(jparams, jstate, jnp.asarray(toks))
    np.testing.assert_allclose(float(pl), float(jl), atol=ATOL, rtol=0)
    _assert_tree_close(pparams, jparams, ATOL, "parameters after the carried step")
    assert int(pstate["count"]) == 2
    with pytest.raises(ValueError, match="no Adam state"):
        opt_state_from_jax((optax.EmptyState(),))


def test_loss_falls():
    """The port's twin of test_train_step_reduces_loss_sharded, unsharded."""
    pcfg = pt_get_model_config("tiny")
    params = pt_llama.init_params(pcfg, seed=0, dtype=torch.float32)
    opt, step = make_train_step(pcfg, TrainConfig(learning_rate=1e-2), device="cpu")
    state = opt.init(params)
    toks = torch.from_numpy(_tokens(pcfg, 4, 16, seed=3))
    losses = []
    for _ in range(5):
        params, state, loss = step(params, state, toks)
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], f"loss did not decrease: {losses}"


def test_bf16_moments_keep_the_params_dtype():
    pcfg = pt_get_model_config("tiny")
    params = pt_llama.init_params(pcfg, seed=0, dtype=torch.bfloat16)
    opt, step = make_train_step(pcfg, TrainConfig(learning_rate=1e-2), device="cpu")
    state = opt.init(params)
    before = params["layers"]["wq"].clone()
    params, state, loss = step(params, state, torch.from_numpy(_tokens(pcfg, 2, 16)))
    assert torch.isfinite(loss) and loss.dtype == torch.float32
    assert all(t.dtype == torch.bfloat16 for t in flatten(state["mu"]).values())
    assert all(t.dtype == torch.bfloat16 for t in flatten(params).values())
    assert not torch.equal(params["layers"]["wq"], before)


@pytest.mark.parametrize("bits,leaf", [(8, "QTensor"), (4, "QTensor4")])
def test_quantized_params_raise(bits, leaf):
    """Quantized leaves carry no gradient: a typed error names the leaf."""
    pcfg = pt_get_model_config("tiny", hidden_size=512, intermediate_size=1024,
                               num_heads=8, num_kv_heads=4)
    params = quantize_params(pt_llama.init_params(pcfg, seed=0, dtype=torch.float32), bits=bits)
    toks = torch.from_numpy(_tokens(pcfg, 1, 8))
    with pytest.raises(TrainingError, match=rf"params\['layers'\]\['wq'\] is a {leaf}\b"):
        pt_llama.forward_train(params, pcfg, toks)
    _, step = make_train_step(pcfg, device="cpu")
    with pytest.raises(TrainingError, match="quantized weights carry no gradient"):
        step(params, {}, toks)


needs_no_card = pytest.mark.skipif(torch.cuda.is_available(),
                                   reason="checks what happens without a card")


@needs_no_card
def test_training_defaults_to_the_card_and_raises_without_one(tmp_path):
    """The training entry points run on the card unless the caller asks
    for the CPU: without a card the defaults raise instead of training on
    the CPU through the plain attention."""
    pcfg = pt_get_model_config("tiny")
    params = pt_llama.init_params(pcfg, seed=0, dtype=torch.float32)
    toks = torch.from_numpy(_tokens(pcfg, 1, 8))
    with pytest.raises(EngineError, match="CUDA is not available"):
        make_train_step(pcfg)
    with pytest.raises(EngineError, match="CUDA is not available"):
        loss_and_grads(params, pcfg, toks)
    save_checkpoint(str(tmp_path), 0, params)
    with pytest.raises(EngineError, match="CUDA is not available"):
        restore_checkpoint(str(tmp_path))


def test_params_off_the_step_device_raise(tmp_path):
    """Parameters that lie on another device than the step's raise, naming
    the leaf; ``device="cpu"`` is how the CPU is asked for. The meta device
    stands for "elsewhere" here, where there is no card."""
    pcfg = pt_get_model_config("tiny")
    params = pt_llama.init_params(pcfg, seed=0, dtype=torch.float32)
    toks = torch.from_numpy(_tokens(pcfg, 1, 8))
    loss, _ = loss_and_grads(params, pcfg, toks, device="cpu")
    assert torch.isfinite(loss)
    with pytest.raises(TrainingError, match=r"params\[embed\] is on cpu.*runs on meta"):
        loss_and_grads(params, pcfg, toks, device="meta")
    elsewhere = tree_map(lambda t: t.to("meta"), params)
    _, step = make_train_step(pcfg, device="cpu")
    with pytest.raises(TrainingError, match="is on meta.*runs on cpu"):
        step(elsewhere, {}, toks)
    save_checkpoint(str(tmp_path), 0, params)
    with pytest.raises(CheckpointError, match="target is on meta"):
        restore_checkpoint(str(tmp_path), target={"params": elsewhere}, device="cpu")


def test_moe_raises_naming_its_roadmap_module(monkeypatch):
    """MoE training is ported (C2): ``forward_train`` on ``tiny-moe``
    matches the JAX package's logits. Expert parallelism is ported too
    (C4): ``_moe`` given an ep mesh takes the routed ep form; its training
    over a mesh is tests/test_torch_sharded_train.py's."""
    jparams, host = _shared_params("tiny-moe")
    jcfg, pcfg = get_model_config("tiny-moe"), pt_get_model_config("tiny-moe")
    toks = _tokens(jcfg, 2, 20)
    want = np.asarray(jax_llama.forward_train(jparams, jcfg, jnp.asarray(toks), remat=True))
    pparams = params_from_jax(host)
    with torch.no_grad():
        got = pt_llama.forward_train(pparams, pcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, atol=LOGITS_ATOL, rtol=0)
    from fei_tpu_torch.parallel import expert as pt_expert
    from fei_tpu_torch.parallel.mesh import Mesh

    seen = []
    monkeypatch.setattr(pt_expert, "moe_mlp_ep_routed",
                        lambda *a, **kw: seen.append(kw) or torch.zeros_like(a[0]))
    y = torch.zeros((1, 2, pcfg.hidden_size))
    out = pt_llama._moe(pcfg, y, pt_llama.layer_params(pparams, 0), False,
                        moe_mesh=Mesh({"ep": 2}))
    assert len(seen) == 1 and torch.equal(out, torch.zeros_like(y))


def test_optimizer_refuses_a_state_that_does_not_fit():
    pcfg = pt_get_model_config("tiny")
    params = pt_llama.init_params(pcfg, seed=0, dtype=torch.float32)
    opt = make_optimizer(TrainConfig())
    state = opt.init(params)
    del state["mu"]["layers"]["wq"]
    with pytest.raises(TrainingError, match="layers/wq"):
        opt.update(params, tree_map(torch.zeros_like, params), state)


# ---------------------------------------------------------------- checkpoints

@pytest.fixture()
def cfg_params():
    pcfg = pt_get_model_config("tiny", num_layers=2)
    return pcfg, pt_llama.init_params(pcfg, seed=0, dtype=torch.float32)


def _assert_trees_equal(a: dict, b: dict):
    fa, fb = flatten(a), flatten(b)
    assert fa.keys() == fb.keys()
    for path in fa:
        assert fa[path].dtype == fb[path].dtype and torch.equal(fa[path], fb[path]), path


class TestCheckpoint:
    def test_save_restore_params(self, tmp_path, cfg_params):
        _, params = cfg_params
        save_checkpoint(str(tmp_path / "ckpt"), 0, params)
        out = restore_checkpoint(str(tmp_path / "ckpt"), target={"params": params},
                                 device="cpu")
        assert set(out) == {"params"}
        _assert_trees_equal(out["params"], params)

    def test_save_restore_opt_state_and_bf16(self, tmp_path):
        pcfg = pt_get_model_config("tiny", num_layers=2)
        params = pt_llama.init_params(pcfg, seed=1, dtype=torch.bfloat16)
        opt, step = make_train_step(pcfg, TrainConfig(learning_rate=1e-2), device="cpu")
        state = opt.init(params)
        params, state, _ = step(params, state, torch.from_numpy(_tokens(pcfg, 2, 12)))
        save_checkpoint(str(tmp_path), 7, params, opt_state=state)
        out = restore_checkpoint(str(tmp_path), device="cpu")  # no target: dtypes as saved
        assert set(out) == {"params", "opt_state"}
        _assert_trees_equal(out["params"], params)
        _assert_trees_equal(out["opt_state"], state)
        assert out["opt_state"]["count"].dtype == torch.int32
        assert int(out["opt_state"]["count"]) == 1

    def test_latest_step_and_retention(self, tmp_path, cfg_params):
        _, params = cfg_params
        d = str(tmp_path / "ckpt")
        assert latest_step(d) is None
        for s in (1, 2, 3, 4, 5):
            save_checkpoint(d, s, params, max_to_keep=2)
        assert latest_step(d) == 5
        assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["4", "5"]
        assert restore_checkpoint(d, target={"params": params}, device="cpu") is not None
        with pytest.raises(CheckpointError, match="step 1"):
            restore_checkpoint(d, step=1, target={"params": params}, device="cpu")
        with pytest.raises(CheckpointError, match="already saved"):
            save_checkpoint(d, 5, params)

    def test_missing_dir_raises(self, tmp_path):
        with pytest.raises(CheckpointError, match="no checkpoints found"):
            restore_checkpoint(str(tmp_path / "nope"), device="cpu")

    def test_target_mismatch_raises(self, tmp_path, cfg_params):
        _, params = cfg_params
        save_checkpoint(str(tmp_path), 0, params)
        wider = pt_llama.init_params(pt_get_model_config("tiny", num_layers=3), seed=0,
                                     dtype=torch.float32)
        with pytest.raises(CheckpointError, match="saved .* target"):
            restore_checkpoint(str(tmp_path), target={"params": wider}, device="cpu")
        fewer = {k: v for k, v in params.items() if k != "final_norm"}
        with pytest.raises(CheckpointError, match="final_norm"):
            restore_checkpoint(str(tmp_path), target={"params": fewer}, device="cpu")

    def test_cache_shardings_and_quantized_leaves_wait(self, tmp_path, cfg_params):
        """Quantized leaves, a KV cache and sharded restore no longer wait:
        they round-trip bitwise, with and without a target; each tp2 rank's
        sharded restore (Megatron slices) put back together is the saved
        tree. A leaf of no known kind raises and leaves nothing behind."""
        _, params = cfg_params
        with pytest.raises(CheckpointError, match="not a tensor"):
            save_checkpoint(str(tmp_path), 0, params, cache=object())
        assert latest_step(str(tmp_path)) is None  # the failed save left nothing
        assert list(tmp_path.iterdir()) == []
        save_checkpoint(str(tmp_path), 0, params)
        from fei_tpu_torch.parallel.mesh import Mesh
        from fei_tpu_torch.parallel.sharding import param_shardings

        halves = []
        for rank in range(2):
            sh = param_shardings(params, Mesh({"tp": 2}, rank=rank), is_moe=False)
            halves.append(restore_checkpoint(str(tmp_path), shardings={"params": sh},
                                             device="cpu")["params"])
        specs = flatten(param_shardings(params, Mesh({"tp": 2}), is_moe=False))
        for path, leaf in flatten(params).items():
            dims = [i for i, e in enumerate(specs[path].spec) if e == "tp"]
            a, b = (flatten(h)[path] for h in halves)
            got = torch.cat([a, b], dim=dims[0]) if dims else a
            assert torch.equal(got, leaf), path
            assert bool(dims) == (a.shape != leaf.shape), path
        pcfg = pt_get_model_config("tiny", hidden_size=512, intermediate_size=1024,
                                   num_heads=8, num_kv_heads=4)
        q = quantize_params(pt_llama.init_params(pcfg, seed=0, dtype=torch.float32),
                            bits=4)
        cache = pt_llama.KVCache.create(pcfg, 1, 16, dtype=torch.float32)
        cache.k.normal_(generator=torch.Generator().manual_seed(0))
        cache = cache._replace(length=torch.tensor([5], dtype=torch.int32))
        save_checkpoint(str(tmp_path), 1, q, cache=cache)
        want = flatten(q)
        kinds = {type(leaf).__name__ for leaf in want.values()}
        assert {"QTensor", "QTensor4"} <= kinds
        for target in (None, {"params": q, "cache": cache}):
            out = restore_checkpoint(str(tmp_path), 1, target=target, device="cpu")
            got = flatten(out["params"])
            assert set(got) == set(want)
            for path, leaf in want.items():
                assert type(got[path]) is type(leaf), path
                for a, b in zip(got[path], leaf):
                    assert torch.equal(a, b), path
            assert type(out["cache"]) is pt_llama.KVCache
            for a, b in zip(out["cache"], cache):
                assert torch.equal(a, b)

    def test_resume_matches_uninterrupted(self, tmp_path, cfg_params):
        """Four steps against two steps, a checkpoint, a restore and two
        more: bitwise the same loss and parameters (the JAX twin allows
        1e-5; the port's step is deterministic)."""
        pcfg, params = cfg_params
        opt, step = make_train_step(pcfg, TrainConfig(remat=False), device="cpu")
        toks = torch.from_numpy(_tokens(pcfg, 2, 16, seed=7))
        dup = lambda t: tree_map(torch.clone, t)

        p, s = dup(params), opt.init(params)
        for _ in range(4):
            p, s, loss_a = step(p, s, toks)

        p2, s2 = dup(params), opt.init(params)
        for _ in range(2):
            p2, s2, _ = step(p2, s2, toks)
        d = str(tmp_path / "resume")
        save_checkpoint(d, 2, p2, opt_state=s2)
        out = restore_checkpoint(d, target={"params": p2, "opt_state": s2}, device="cpu")
        p3, s3 = out["params"], out["opt_state"]
        for _ in range(2):
            p3, s3, loss_b = step(p3, s3, toks)
        assert torch.equal(loss_a, loss_b)
        _assert_trees_equal(p, p3)
        _assert_trees_equal(s, s3)


def test_example_script_runs_on_the_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, str(REPO / "examples" / "train_finetune_torch.py"), "--device", "cpu",
         "--steps", "4", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"},
    )
    assert out.returncode == 0, out.stderr
    assert "checkpointed at step 2" in out.stdout and "restored step-2" in out.stdout
    assert latest_step(str(tmp_path)) == 2
