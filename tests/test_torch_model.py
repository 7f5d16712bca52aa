"""The port's dense forward against fei_tpu.models.llama.forward on the same
weights (JAX init -> numpy -> models.convert.params_from_jax), fp32, for
six tiny families. A T=70 prefill crosses _FLASH_MIN_T; the JAX side runs
it once through the Pallas flash kernel in interpret mode
(FEI_TPU_FLASH=1) and once through its XLA oracle (=0). Two decode steps
follow on the JAX oracle path. Norm and bias leaves are randomized (init
makes them 1 and 0, which would hide their math). Tolerance: atol 2e-4 on fp32 logits of magnitude
~1 — summation order through a few layers."""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fei_tpu.models import llama as jax_llama
from fei_tpu.models.configs import get_model_config
from fei_tpu_torch.models import llama as pt_llama
from fei_tpu_torch.models.configs import get_model_config as pt_get_model_config
from fei_tpu_torch.models.convert import params_from_jax

FAMILIES = ["tiny", "debug", "tiny-bias", "tiny-swa", "tiny-phi", "tiny-gemma"]
ATOL = 2e-4
S = 96  # cache length: the T=70 prefill and the decode steps fit


def _shared_params(name: str):
    """JAX fp32 params with randomized norm/bias leaves, as (jax tree,
    numpy tree)."""
    cfg = get_model_config(name)
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


def _jax_run(cfg, params, prompt, steps, monkeypatch):
    """Prefill logits under FEI_TPU_FLASH=1 (interpret kernel) and =0, then
    the decode steps (T=1: the XLA oracle, as on the accelerator)."""
    outs = {}
    for flash in ("1", "0"):
        monkeypatch.setenv("FEI_TPU_FLASH", flash)
        cache = jax_llama.KVCache.create(cfg, 1, S, jnp.float32)
        logits, cache = jax_llama.forward(params, cfg, jnp.asarray(prompt), cache)
        outs[f"prefill FEI_TPU_FLASH={flash}"] = np.asarray(logits)[0]
    for i, tok in enumerate(steps):
        logits, cache = jax_llama.forward(
            params, cfg, jnp.asarray([[tok]], dtype=jnp.int32), cache)
        outs[f"decode step {i}"] = np.asarray(logits)[0]
    return outs


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_logits_match_jax(name, monkeypatch):
    jparams, host = _shared_params(name)
    jcfg = get_model_config(name)
    pcfg = pt_get_model_config(name)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, jcfg.vocab_size, size=(1, 70)).astype(np.int32)
    steps = rng.integers(0, jcfg.vocab_size, size=2).tolist()

    pparams = params_from_jax(host)
    cache = pt_llama.KVCache.create(pcfg, 1, S, torch.float32)
    logits, cache = pt_llama.forward(pparams, pcfg, torch.from_numpy(prompt), cache)
    got = [logits[0].numpy()]
    for tok in steps:
        logits, cache = pt_llama.forward(pparams, pcfg, torch.tensor([[tok]]), cache)
        got.append(logits[0].numpy())
    assert int(cache.length[0]) == 72

    want = _jax_run(jcfg, jparams, prompt, steps, monkeypatch)
    expect = [want["prefill FEI_TPU_FLASH=0"]] + [
        want[f"decode step {i}"] for i in range(len(steps))
    ]
    np.testing.assert_allclose(
        got[0], want["prefill FEI_TPU_FLASH=1"], atol=ATOL, rtol=0,
        err_msg="prefill vs the interpret flash kernel",
    )
    for i, (g, w) in enumerate(zip(got, expect)):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=f"call {i}")


def test_forward_flash_wrapper_path_matches_plain():
    """flash=True routes the port's prefill through the flash wrapper (its
    plain version on the CPU, no launches): same logits as the default."""
    from fei_tpu_torch.ops.kernels.flash_attention import flash_attention

    pcfg = pt_get_model_config("tiny-swa")
    params = pt_llama.init_params(pcfg, seed=3, dtype=torch.float32)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 512, (1, 70)))
    runs = []
    for flash in (True, None):
        cache = pt_llama.KVCache.create(pcfg, 1, S, torch.float32)
        before = flash_attention.launches
        runs.append(pt_llama.forward(params, pcfg, toks, cache, flash=flash)[0])
        assert flash_attention.launches == before
    torch.testing.assert_close(runs[0], runs[1], atol=1e-5, rtol=0)


def test_forward_live_mask_freezes_rows():
    """A row marked not-live keeps its KV slots and length."""
    pcfg = pt_get_model_config("tiny")
    params = pt_llama.init_params(pcfg, seed=0, dtype=torch.float32)
    cache = pt_llama.KVCache.create(pcfg, 2, 16, torch.float32)
    _, cache = pt_llama.forward(params, pcfg, torch.tensor([[5, 6], [7, 8]]), cache)
    k0, v0 = cache.k.clone(), cache.v.clone()
    live = torch.tensor([True, False])
    _, cache = pt_llama.forward(params, pcfg, torch.tensor([[9], [10]]), cache, live=live)
    assert cache.length.tolist() == [3, 2]
    assert torch.equal(cache.k[:, 1], k0[:, 1]) and torch.equal(cache.v[:, 1], v0[:, 1])
    assert not torch.equal(cache.k[:, 0, 2], k0[:, 0, 2])


def test_convert_rejects_quantized_leaves():
    """Quantized leaves the port knows (QTensor, QTensor4) convert with
    their int8 values and fp32 scales untouched by ``dtype``; any other
    NamedTuple leaf is refused."""
    from typing import NamedTuple

    from fei_tpu.ops.quant import quantize, quantize4
    from fei_tpu_torch.ops.quant import QTensor, QTensor4

    w = jnp.linspace(-1.0, 1.0, 512 * 8, dtype=jnp.float32).reshape(512, 8)
    tree = jax.tree.map(np.asarray, {"layers": {"wq": quantize(w), "wo": quantize4(w)},
                                     "norm": jnp.ones((4,), jnp.float32)})
    out = params_from_jax(tree, dtype=torch.bfloat16)
    wq, wo = out["layers"]["wq"], out["layers"]["wo"]
    assert isinstance(wq, QTensor) and isinstance(wo, QTensor4)
    assert (wq.q.dtype, wq.s.dtype, wo.p.dtype, wo.s.dtype) == (
        torch.int8, torch.float32, torch.int8, torch.float32)
    assert out["norm"].dtype == torch.bfloat16
    np.testing.assert_array_equal(wo.p.numpy(), tree["layers"]["wo"].p)
    np.testing.assert_array_equal(wq.s.numpy(), tree["layers"]["wq"].s)

    class Other(NamedTuple):
        a: np.ndarray
        b: np.ndarray

    with pytest.raises(NotImplementedError, match="no counterpart"):
        params_from_jax({"layers": {"wq": Other(np.ones(2), np.ones(2))}})


def test_convert_keeps_bf16():
    host = {"embed": np.asarray(jnp.arange(6, dtype=jnp.bfloat16).reshape(2, 3))}
    out = params_from_jax(host)
    assert out["embed"].dtype == torch.bfloat16
    assert out["embed"].float().tolist() == [[0, 1, 2], [3, 4, 5]]
