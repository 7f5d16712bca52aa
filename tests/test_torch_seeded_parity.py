"""Seeded sampling, port against fei_tpu: with the reference's threefry
chain in the port (engine/prng.py), a seeded request gives the JAX
package's tokens. At the ``tiny`` config (two layers, fp32) with the same
weights in both packages (``params_from_jax``; logits agree to 1e-4 on
the CPU, tests/test_torch_model.py), the streams must be token-identical:

- the dense engine (temperature 0.8, top-p 0.9) at chunk 1 and chunk 16;
- the paged scheduler, four concurrent seeded requests, one of them
  admitted in chunks, against fei_tpu's scheduler;
- inside the port, the dense stream equals the paged one;
- a sampled tool-call turn whose trigger lands mid-chunk (the rollback
  restores the key) equals the JAX package's per-token turn.

Each JAX stream is computed once per module.
"""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fei_tpu.engine.engine import GenerationConfig as JaxGen
from fei_tpu.engine.engine import InferenceEngine as JaxEngine
from fei_tpu.engine.grammar import compile_agent_tool_grammar as jax_compile
from fei_tpu.tools.definitions import TOOL_DEFINITIONS as JAX_TOOLS
from fei_tpu_torch.engine.engine import GenerationConfig, InferenceEngine
from fei_tpu_torch.engine.grammar import TriggerScanner, compile_agent_tool_grammar
from fei_tpu_torch.models.convert import params_from_jax
from fei_tpu_torch.tools.definitions import TOOL_DEFINITIONS
from fei_tpu_torch.utils.metrics import METRICS

MAX_SEQ = 256
N_NEW = 24
SAMPLED = dict(temperature=0.8, top_p=0.9)
PROMPTS = [
    [105, 47, 220, 31, 99, 180, 12, 200, 64, 150, 77, 9],
    list(range(30, 71)),  # 41 tokens: admitted in chunks of 32
    [7, 300, 12, 401, 22],
    [260, 3, 90, 18, 111, 57, 8, 499],
]
SEEDS = [3, 11, 29, 101]


def _jgen(seed, **kw):
    return JaxGen(max_new_tokens=N_NEW, ignore_eos=True, seed=seed, **SAMPLED, **kw)


def _gen(seed, **kw):
    return GenerationConfig(max_new_tokens=N_NEW, ignore_eos=True, seed=seed, **SAMPLED, **kw)


@pytest.fixture(scope="module")
def ref():
    eng = JaxEngine.from_config("tiny", dtype=jnp.float32, max_seq_len=MAX_SEQ, num_layers=2)
    # the LM head zeroed past the byte tokenizer's 264 ids: the random
    # model's picks are then ids the tokenizer decodes, so the tool-call
    # case can find a trigger in its text
    V = eng.tokenizer.vocab_size
    eng.params["lm_head"] = eng.params["lm_head"].at[:, V:].set(0.0)
    return eng


@pytest.fixture(scope="module")
def dense(ref):
    params = params_from_jax(jax.tree.map(np.asarray, ref.params))
    return InferenceEngine.from_config("tiny", params=params, device="cpu",
                                       dtype=torch.float32, max_seq_len=MAX_SEQ, num_layers=2)


@pytest.fixture(scope="module")
def jax_dense_streams(ref):
    return [list(ref.generate_stream(p, _jgen(s, chunk=1))) for p, s in zip(PROMPTS, SEEDS)]


@pytest.fixture(scope="module")
def jax_paged_streams(ref):
    """fei_tpu's scheduler: four seeded requests in flight together."""
    jeng = JaxEngine(ref.cfg, ref.params, ref.tokenizer, max_seq_len=MAX_SEQ,
                     dtype=jnp.float32, paged=True, page_size=16, batch_size=4)
    jeng.scheduler.prefill_chunk = 32
    try:
        seqs = [jeng.scheduler.submit(p, _jgen(s)) for p, s in zip(PROMPTS, SEEDS)]
        return [list(jeng.scheduler.drain(q)) for q in seqs]
    finally:
        jeng.close()


def _paged(dense):
    eng = InferenceEngine.from_config(
        "tiny", params=dense.params, paged=True, page_size=16, batch_size=4,
        device="cpu", dtype=torch.float32, max_seq_len=MAX_SEQ, num_layers=2)
    eng.scheduler.prefill_chunk = 32
    return eng


@pytest.mark.parametrize("chunk", [1, 16])
def test_dense_seeded_streams_equal_reference(dense, jax_dense_streams, chunk):
    for prompt, seed, want in zip(PROMPTS, SEEDS, jax_dense_streams):
        assert len(set(want)) > 3  # sampled, not a degenerate repeat
        got = list(dense.generate_stream(prompt, _gen(seed, chunk=chunk)))
        assert got == want, (seed, chunk)


def test_paged_seeded_streams_equal_reference_scheduler(dense, jax_paged_streams,
                                                        jax_dense_streams):
    """Four requests in flight at once, one admitted in chunks: each
    stream equals fei_tpu's scheduler's, and the port's own dense one."""
    eng = _paged(dense)
    try:
        seqs = [eng.scheduler.submit(p, _gen(s)) for p, s in zip(PROMPTS, SEEDS)]
        got = [list(eng.scheduler.drain(q)) for q in seqs]
        assert METRICS.snapshot()["counters"].get("scheduler.multi_steps", 0) > 0
    finally:
        eng.close()
    assert got == jax_paged_streams
    assert got == jax_dense_streams


def _trigger_at(engine, prompt, gen, lo=4, hi=7):
    """A trigger string the free stream first completes at token j, with
    lo <= j <= hi: inside the first decode chunk of 16."""
    toks = list(engine.generate_stream(prompt, dataclasses.replace(gen, max_new_tokens=hi + 1,
                                                                    chunk=1)))
    for j in range(lo, hi + 1):
        text = engine.tokenizer.decode(toks[:j + 1])
        for width in (1, 2, 3, 4):
            trig = text[-width:]
            if len(trig) < width:
                continue
            sc = TriggerScanner(engine.tokenizer, trig)
            hits = [i for i, t in enumerate(toks) if sc.feed(t) is not None]
            if hits and hits[0] == j:
                return trig
    raise AssertionError(f"no mid-chunk trigger in {toks}")


def test_sampled_mid_chunk_trigger_equals_reference(ref, dense):
    """A sampled tool-call turn: the fused chunk finds the trigger
    mid-chunk and rolls the cache and the key back to it; the turn equals
    the JAX package's per-token turn."""
    prompt, seed = PROMPTS[0], 3
    gen1 = GenerationConfig(max_new_tokens=96, ignore_eos=True, temperature=0.9,
                            top_k=50, seed=seed, chunk=1)
    trig = _trigger_at(dense, prompt, gen1)
    jgr = jax_compile(JAX_TOOLS, ref.tokenizer)
    want = list(ref.generate_stream_toolcalls(
        prompt, JaxGen(max_new_tokens=96, ignore_eos=True, temperature=0.9, top_k=50,
                       seed=seed, chunk=1), grammar=jgr, trigger=trig))
    gr = compile_agent_tool_grammar(TOOL_DEFINITIONS, dense.tokenizer)
    got = list(dense.generate_stream_toolcalls(
        prompt, dataclasses.replace(gen1, chunk=16), grammar=gr, trigger=trig))
    assert got == want
    assert dense.tokenizer.decode(got).endswith("</tool_call>")
