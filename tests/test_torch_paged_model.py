"""The port's paged forwards (models/llama.py ``forward_paged``,
``forward_paged_block``, ``forward_paged_merged``) against fei_tpu's, with
the same fp32 weights (``params_from_jax``) and the same block tables:
logits and pools after a prefill-sized block, decode steps and a merged
chunk + decode step. The JAX side runs the Pallas kernels in interpret
mode, the port their plain versions on the CPU.

Tolerances, fp32: logits and hidden states atol/rtol 1e-4 (two layers of
matmuls and softmaxes summed in different orders: ~1e-6 observed); bf16-
layout pools (fp32 here) atol 1e-5 (the written K/V are one projection
and a rope away from the embeddings); int8 pools may differ by one
quantization step where a value sits on a rounding boundary after those
fp32 differences, and their scales by 1e-5 relative."""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fei_tpu.engine.paged_cache import PagedKVCache as JaxPool
from fei_tpu.models import llama as jl
from fei_tpu.models.configs import get_model_config as jax_cfg
from fei_tpu_torch.engine.paged_cache import PagedKVCache
from fei_tpu_torch.models import llama as tl
from fei_tpu_torch.models.configs import get_model_config
from fei_tpu_torch.models.convert import params_from_jax

PS, WIDTH, NUM_PAGES, B = 16, 6, 20, 2
TABLE = np.array([[4, 9, 2, 11, 0, 0], [7, 1, 13, 5, 16, 0]], np.int32)


def _setup(name, kv_quant):
    jcfg = jax_cfg(name)
    jparams = jl.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    jpool = JaxPool.create(jcfg, NUM_PAGES, B, WIDTH, page_size=PS, dtype=jnp.float32,
                           kv_quant=kv_quant)
    jpool = jpool._replace(block_table=jnp.asarray(TABLE))
    tpool = PagedKVCache.create(get_model_config(name), NUM_PAGES, B, WIDTH, page_size=PS,
                                dtype=torch.float32, kv_quant=kv_quant)
    tpool = tpool._replace(block_table=torch.from_numpy(TABLE))
    return jcfg, jparams, get_model_config(name), tparams, jpool, tpool


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=1e-4)


def _pools_close(tpool, jpool):
    if tpool.k_scales is None:
        _close(tpool.k_pages, jpool.k_pages, 1e-5)
        _close(tpool.v_pages, jpool.v_pages, 1e-5)
        return
    for got, want in ((tpool.k_pages, jpool.k_pages), (tpool.v_pages, jpool.v_pages)):
        step = got.numpy().astype(np.int32) - np.asarray(want).astype(np.int32)
        assert np.abs(step).max() <= 1
    for got, want in ((tpool.k_scales, jpool.k_scales), (tpool.v_scales, jpool.v_scales)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=0)


@pytest.mark.parametrize("name,kv_quant", [("tiny", None), ("tiny-swa", None),
                                           ("tiny", "int8")])
def test_block_then_decode_match_jax(name, kv_quant):
    """A 20-token block per row (the chunk body of paged prefill), then
    three single-token decode steps: logits, lengths and pools agree."""
    jcfg, jparams, cfg, tparams, jpool, tpool = _setup(name, kv_quant)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, (B, 20)).astype(np.int32)
    jlog, jpool = jl.forward_paged_block(jparams, jcfg, jnp.asarray(toks), jpool)
    tlog, tpool = tl.forward_paged_block(tparams, cfg, torch.from_numpy(toks), tpool)
    _close(tlog, jlog)
    _pools_close(tpool, jpool)
    for _ in range(3):
        step = np.array(jnp.argmax(jlog[:, -1], axis=-1), np.int32)[:, None]
        jlog, jpool = jl.forward_paged(jparams, jcfg, jnp.asarray(step), jpool)
        tlog, tpool = tl.forward_paged(tparams, cfg, torch.from_numpy(step), tpool)
        _close(tlog, jlog)
    assert tpool.lengths.tolist() == np.asarray(jpool.lengths).tolist() == [23, 23]
    _pools_close(tpool, jpool)


@pytest.mark.parametrize("name,kv_quant", [("tiny", None), ("tiny-swa", None),
                                           ("tiny", "int8")])
def test_merged_chunk_and_decode_match_jax(name, kv_quant):
    """Row 0 decodes (17 tokens already in) while a 13-token chunk of row
    1's prompt, starting at position 16, rides the same dispatch in groups
    of 4: the chunk's hidden states, the decode logits and the pools
    agree with the JAX merged program."""
    jcfg, jparams, cfg, tparams, jpool, tpool = _setup(name, kv_quant)
    rng = np.random.default_rng(1)
    pre = rng.integers(1, cfg.vocab_size, (B, 17)).astype(np.int32)
    _, jpool = jl.forward_paged_block(jparams, jcfg, jnp.asarray(pre), jpool)
    _, tpool = tl.forward_paged_block(tparams, cfg, torch.from_numpy(pre), tpool)
    # row 1 is the admitting slot: its live row is zero, its chunk goes
    # through its own table row
    live = TABLE.copy()
    live[1] = 0
    lengths = np.array([17, 0], np.int32)
    jpool = jpool._replace(block_table=jnp.asarray(live), lengths=jnp.asarray(lengths))
    tpool = tpool._replace(block_table=torch.from_numpy(live),
                           lengths=torch.from_numpy(lengths))
    chunk = rng.integers(1, cfg.vocab_size, (1, 13)).astype(np.int32)
    dec = np.array([[5], [0]], np.int32)
    jh, jlog, jpool = jl.forward_paged_merged(
        jparams, jcfg, jnp.asarray(chunk), jnp.asarray(TABLE[1:2]),
        jnp.asarray([16], jnp.int32), jnp.asarray(dec), jpool, rows=4)
    th, tlog, tpool = tl.forward_paged_merged(
        tparams, cfg, torch.from_numpy(chunk), torch.from_numpy(TABLE[1:2]), 16,
        torch.from_numpy(dec), tpool, rows=4)
    _close(th, jh)
    _close(tlog[:1], jlog[:1])  # row 1 of the decode batch is idle
    _pools_close(tpool, jpool)
