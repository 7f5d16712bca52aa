"""Grammar-constrained decoding in the port against fei_tpu, on the
``tiny`` config (two layers) with the same fp32 weights in both packages
(``params_from_jax``) and the 14-tool union grammar on the byte tokenizer:

- dense ``generate_constrained`` and ``generate_stream_toolcalls`` (free
  phase per token and fused-chunked, the trigger found mid-chunk so the
  rollback runs) give the reference's greedy tokens; the fused decode
  equals the host-masked per-token reference; a budget too small for a
  call truncates as the reference does;
- inside the port: a paged constrained request equals the dense one, alone
  and beside unconstrained neighbours (whose streams it leaves alone),
  with the multi-step scan (a mid-scan trigger rolls the slot back) and
  without, and through a preemption in its constrained phase; a sampled
  stream whose trigger lands mid-chunk equals the per-token stream, dense
  and paged."""

import concurrent.futures as cf
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
from fei_tpu_torch.engine.grammar import (
    TriggerScanner,
    char_walk,
    compile_agent_tool_grammar,
)
from fei_tpu_torch.models.convert import params_from_jax
from fei_tpu_torch.tools.definitions import TOOL_DEFINITIONS
from fei_tpu_torch.utils.metrics import METRICS

MAX_SEQ = 256
CLOSE = "</tool_call>"
PROMPT = [105, 47, 220, 31, 99, 180, 12, 200, 64, 150, 77, 9]


def _counter(name):
    return METRICS.snapshot()["counters"].get(name, 0.0)


@pytest.fixture(scope="module")
def ref():
    eng = JaxEngine.from_config("tiny", dtype=jnp.float32, max_seq_len=MAX_SEQ, num_layers=2)
    # the LM head zeroed past the byte tokenizer's 264 ids (as the card's
    # agent phase does at llama3-8b): the random model's picks are then
    # ids the tokenizer decodes, so its text can carry a trigger
    V = eng.tokenizer.vocab_size
    eng.params["lm_head"] = eng.params["lm_head"].at[:, V:].set(0.0)
    return eng


@pytest.fixture(scope="module")
def dense(ref):
    params = params_from_jax(jax.tree.map(np.asarray, ref.params))
    return InferenceEngine.from_config("tiny", params=params, device="cpu",
                                       dtype=torch.float32, max_seq_len=MAX_SEQ, num_layers=2)


@pytest.fixture(scope="module")
def grammars(ref, dense):
    return (jax_compile(JAX_TOOLS, ref.tokenizer),
            compile_agent_tool_grammar(TOOL_DEFINITIONS, dense.tokenizer))


def _paged(dense, **kw):
    eng = InferenceEngine.from_config(
        "tiny", params=dense.params, paged=True, page_size=16,
        batch_size=kw.pop("batch_size", 4), device="cpu", dtype=torch.float32,
        max_seq_len=MAX_SEQ, num_layers=2, **kw)
    eng.scheduler.prefill_chunk = 32
    return eng


def _gen(n, **kw):
    return GenerationConfig(max_new_tokens=n, ignore_eos=True, **kw)


def _mid_trigger(engine, gen, lo=4, hi=7):
    """(trigger, j): a trigger string that the free stream of ``gen`` first
    completes at token j, lo <= j <= hi — inside the first decode chunk
    (chunk 16) and the first multi-step scan (8 steps)."""
    toks = list(engine.generate_stream(
        PROMPT, dataclasses.replace(gen, max_new_tokens=hi + 1, chunk=1)))
    for j in range(lo, hi + 1):
        text = engine.tokenizer.decode(toks[:j + 1])
        for width in (1, 2, 3, 4):
            trig = text[-width:]
            if len(trig) < width:
                continue
            sc = TriggerScanner(engine.tokenizer, trig)
            hits = [i for i, t in enumerate(toks) if sc.feed(t) is not None]
            if hits and hits[0] == j:
                return trig, j
    raise AssertionError(f"no mid-chunk trigger in {toks}")


def _call_of(engine, toks, trigger, grammar):
    text = engine.tokenizer.decode(toks)
    assert text.endswith(CLOSE), text
    payload = text.split(trigger, 1)[1][:-len(CLOSE)]
    assert char_walk(grammar, payload) == grammar.accept
    return payload


def test_generate_constrained_matches_reference(ref, dense, grammars):
    jgr, gr = grammars
    for n, chunk in ((48, 16), (40, 5)):
        want = ref.generate_constrained(PROMPT, jgr, JaxGen(max_new_tokens=n, ignore_eos=True),
                                        chunk=chunk).token_ids
        before = _counter("engine.grammar_fused_steps")
        got = dense.generate_constrained(PROMPT, gr, _gen(n), chunk=chunk).token_ids
        assert got == want
        assert _counter("engine.grammar_fused_steps") > before
        text = dense.tokenizer.decode(got)
        assert char_walk(gr, text) == gr.accept  # a whole call in the budget


@pytest.mark.parametrize("chunk", [1, 16])
def test_toolcall_stream_matches_reference(ref, dense, grammars, chunk):
    jgr, gr = grammars
    trig, j = _mid_trigger(dense, _gen(1))
    want = list(ref.generate_stream_toolcalls(
        PROMPT, JaxGen(max_new_tokens=96, ignore_eos=True, chunk=chunk),
        grammar=jgr, trigger=trig))
    fused0, dispatches0 = _counter("engine.grammar_fused_steps"), _counter(
        "engine.decode_dispatches")
    got = list(dense.generate_stream_toolcalls(PROMPT, _gen(96, chunk=chunk),
                                               grammar=gr, trigger=trig))
    assert got == want
    _call_of(dense, got, trig, gr)
    constrained = len(got) - (j + 1) - len(dense.tokenizer.encode(CLOSE))
    steps = _counter("engine.grammar_fused_steps") - fused0
    assert steps >= constrained > 0
    if chunk == 16:
        # one host sync per chunk: the free chunks up to the trigger, then
        # ceil(steps / 16) constrained ones
        assert _counter("engine.decode_dispatches") - dispatches0 <= 2 + -(-steps // 16)


def test_fused_equals_host_mask(dense, grammars):
    _, gr = grammars
    trig, j = _mid_trigger(dense, _gen(1))
    toks = list(dense.generate_stream_toolcalls(PROMPT, _gen(96), grammar=gr, trigger=trig))
    payload = _call_of(dense, toks, trig, gr)
    free = toks[:j + 1]
    left = 96 - (j + 1)
    host = dense.generate(PROMPT + free, GenerationConfig(max_new_tokens=left),
                          logit_mask_fn=gr.logit_mask_fn(max_tokens=left))
    assert host.text == payload


def test_budget_too_small_truncates_like_reference(ref, dense, grammars):
    jgr, gr = grammars
    trig, j = _mid_trigger(dense, _gen(1))
    for chunk in (1, 16):
        want = list(ref.generate_stream_toolcalls(
            PROMPT, JaxGen(max_new_tokens=j + 12, ignore_eos=True, chunk=chunk),
            grammar=jgr, trigger=trig))
        before = _counter("engine.grammar_budget_too_small")
        got = list(dense.generate_stream_toolcalls(PROMPT, _gen(j + 12, chunk=chunk),
                                                   grammar=gr, trigger=trig))
        assert got == want and len(got) == j + 1  # the free tokens, no partial call
        assert _counter("engine.grammar_budget_too_small") == before + 1


def test_paged_constrained_equals_dense(dense, grammars):
    _, gr = grammars
    trig, j = _mid_trigger(dense, _gen(1))
    want_c = dense.generate_constrained(PROMPT, gr, _gen(48)).token_ids
    want_t = list(dense.generate_stream_toolcalls(PROMPT, _gen(96), grammar=gr, trigger=trig))
    rng = np.random.default_rng(1)
    others = [rng.integers(1, 264, n).tolist() for n in (9, 40, 21)]
    alone = [list(dense.generate_stream(p, _gen(24))) for p in others]
    eng = _paged(dense)
    try:
        for multistep in (8, 1):
            eng.scheduler.multistep = multistep
            rb0 = _counter("scheduler.turbo_rollbacks")
            assert eng.generate_constrained(PROMPT, gr, _gen(48)).token_ids == want_c
            assert list(eng.generate_stream_toolcalls(
                PROMPT, _gen(96), grammar=gr, trigger=trig)) == want_t
            if multistep == 8:
                assert _counter("scheduler.turbo_rollbacks") > rb0
            # beside unconstrained neighbours: every stream as if alone
            with cf.ThreadPoolExecutor(4) as ex:
                futs = [ex.submit(lambda: list(eng.generate_stream_toolcalls(
                    PROMPT, _gen(96), grammar=gr, trigger=trig)))]
                futs += [ex.submit(lambda p=p: list(eng.generate_stream(p, _gen(24))))
                         for p in others]
                got = [f.result(timeout=120) for f in futs]
            assert got[0] == want_t
            assert got[1:] == alone
        assert eng._allocator.free_pages == eng._allocator.num_pages - 1
    finally:
        eng.close()


def test_paged_constrained_resumes_after_preemption(dense, grammars):
    """A tool-call request preempted in its constrained phase resumes with
    its DFA state and scanner and finishes with the dense engine's call."""
    @dataclasses.dataclass(frozen=True)
    class PriorityGen(GenerationConfig):
        priority: int = 0

    _, gr = grammars
    trig, j = _mid_trigger(dense, _gen(1))
    want = list(dense.generate_stream_toolcalls(PROMPT, _gen(96), grammar=gr, trigger=trig))
    eng = _paged(dense, batch_size=1)
    sched = eng.scheduler
    urgent = []
    deliver = sched._deliver

    def deliver_then_preempt(seq, t):
        deliver(seq, t)
        # once the call is a few tokens in, a priority request arrives and
        # takes the only slot (submitted on the loop thread: deterministic)
        if seq.grammar is not None and seq.gstate >= 0 and len(seq.generated) == j + 4 \
                and not urgent:
            urgent.append(sched.submit([5, 6, 7], PriorityGen(
                max_new_tokens=6, ignore_eos=True, priority=1)))

    sched._deliver = deliver_then_preempt
    try:
        before = _counter("scheduler.priority_preemptions")
        got = list(eng.generate_stream_toolcalls(PROMPT, _gen(96), grammar=gr, trigger=trig))
        assert urgent and len(list(sched.drain(urgent[0]))) == 6
        assert _counter("scheduler.priority_preemptions") > before
        assert got == want
    finally:
        eng.close()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_sampled_mid_chunk_trigger_equals_per_token(dense, grammars, paged):
    """Under sampling a rollback that is off by one draw changes the
    stream: the fused chunk (and the paged multi-step scan) with the
    trigger mid-chunk must equal the per-token free phase."""
    _, gr = grammars
    gen1 = _gen(96, temperature=0.9, top_k=50, seed=3, chunk=1)
    trig, j = _mid_trigger(dense, gen1)
    want = list(dense.generate_stream_toolcalls(PROMPT, gen1, grammar=gr, trigger=trig))
    _call_of(dense, want, trig, gr)
    gen16 = _gen(96, temperature=0.9, top_k=50, seed=3, chunk=16)
    if not paged:
        got = list(dense.generate_stream_toolcalls(PROMPT, gen16, grammar=gr, trigger=trig))
        assert got == want
        return
    eng = _paged(dense)
    try:
        rb0 = _counter("scheduler.turbo_rollbacks")
        got = list(eng.generate_stream_toolcalls(PROMPT, gen16, grammar=gr, trigger=trig))
        assert _counter("scheduler.turbo_rollbacks") > rb0
        assert got == want
    finally:
        eng.close()
