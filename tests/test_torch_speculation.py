"""Prompt-lookup speculation in the port (roadmap C3), on the CPU in fp32.

Dense (``InferenceEngine.generate_lookahead``, the counterparts of
tests/test_engine.py's ``TestPromptLookupSpeculation``) and paged (the
scheduler's ``_maybe_spec_step``, the counterparts of all eight cases of
tests/test_paged_speculation.py, which the JAX package marks slow and
which run here at tiny size): a speculated stream is the plain greedy
stream, token for token, on ``tiny`` and on ``tiny-moe``; the port's dense
lookahead stream equals the JAX package's. Where the JAX package turns
speculation off after a failed verify dispatch, the port fails the
streams through ``_fail_all`` (ROADMAP F3). Also: a fully rejected draft
in the dense cache followed by a plain step, the rolling-window release
margin with ``FEI_TPU_SPEC_DRAFT`` > ``FEI_TPU_SCHED_MULTISTEP``, the
scheduler's speculation variables, and the provider's route under
``FEI_TPU_SPECULATE=1``.
"""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import json
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fei_tpu.engine.engine import GenerationConfig as JaxGen
from fei_tpu.engine.engine import InferenceEngine as JaxEngine
from fei_tpu_torch.engine.engine import GenerationConfig, InferenceEngine
from fei_tpu_torch.engine.grammar import char_walk, compile_agent_tool_grammar
from fei_tpu_torch.models.convert import params_from_jax
from fei_tpu_torch.utils.metrics import METRICS

TEXT = "def foo(a, b): return a + b\ndef foo(a, b): return a + b\n"
TOOLS = [{
    "name": "LS", "description": "d",
    "input_schema": {"type": "object", "properties": {"p": {"type": "string"}},
                     "required": ["p"]},
}]


def _counter(name: str) -> float:
    return METRICS.snapshot()["counters"].get(name, 0)


def _span_count(name: str) -> int:
    return METRICS.snapshot()["spans"].get(name, {}).get("count", 0)


def _gen(n, **kw):
    return GenerationConfig(max_new_tokens=n, temperature=kw.pop("temperature", 0.0),
                            ignore_eos=kw.pop("ignore_eos", True), **kw)


# ---------------------------------------------------------------- dense


@pytest.fixture(scope="module", params=["tiny", "tiny-moe"])
def dense(request):
    return InferenceEngine.from_config(request.param, device="cpu", dtype=torch.float32,
                                       max_seq_len=256, num_layers=2)


def test_dense_matches_greedy_on_a_repetitive_prompt(dense):
    prompt = dense.tokenizer.encode(TEXT, add_bos=True)
    want = dense.generate(prompt, _gen(24)).token_ids
    assert dense.generate_lookahead(prompt, _gen(24)).token_ids == want


def test_dense_spec_path_exercised_and_exact(dense, monkeypatch):
    """Bogus drafts of every length: wrong tokens are rejected by the
    model's own argmax and the stream is greedy's."""
    prompt = dense.tokenizer.encode("spec test", add_bos=True)
    want = dense.generate(prompt, _gen(20)).token_ids
    drafts = iter(range(1000))

    def fake_draft(ids, ngram, draft_len):
        k = (next(drafts) % draft_len) + 1
        return [(ids[-1] + i) % 256 for i in range(k)]

    monkeypatch.setattr(type(dense), "_find_draft", staticmethod(fake_draft))
    s0 = _span_count("spec_step")
    assert dense.generate_lookahead(prompt, _gen(20)).token_ids == want
    assert _span_count("spec_step") - s0 >= 1


def test_find_draft():
    find = InferenceEngine._find_draft
    assert find([1, 2, 3, 9, 9, 1, 2, 3], 3, 4) == [9, 9, 1, 2]  # follows the earlier match
    assert find([1, 2, 3, 7, 1, 2, 3, 8, 1, 2, 3], 3, 2) == [8, 1]  # the newest repeat
    assert find([5, 6, 7], 3, 4) is None  # the tail is the whole sequence
    assert find([1, 2], 3, 4) is None  # too short


def test_dense_matches_greedy_on_a_nonrepetitive_prompt(dense):
    prompt = dense.tokenizer.encode("zq9!k", add_bos=True)
    want = dense.generate(prompt, _gen(16)).token_ids
    assert dense.generate_lookahead(prompt, _gen(16)).token_ids == want


def test_dense_sampled_falls_back(dense):
    prompt = dense.tokenizer.encode("hello", add_bos=True)
    gen = _gen(8, temperature=0.8, seed=3)
    s0 = _span_count("spec_step")
    assert dense.generate_lookahead(prompt, gen).token_ids == dense.generate(prompt, gen).token_ids
    assert _span_count("spec_step") == s0


def test_dense_respects_stops(dense):
    prompt = dense.tokenizer.encode("ab " * 20, add_bos=True)
    gen = GenerationConfig(max_new_tokens=32, temperature=0.0,
                           stop_token_ids=(dense.generate(prompt, _gen(6)).token_ids[3],))
    want = dense.generate(prompt, gen).token_ids
    assert dense.generate_lookahead(prompt, gen).token_ids == want


def test_dense_fully_rejected_draft_then_a_plain_step(dense, monkeypatch):
    """Every draft wrong (accept 0): the verify wrote 1 + draft_len rows,
    the length keeps one; the next step (no draft) is a plain step whose
    write overwrites the rows the length masks. The stream is greedy's,
    and the cache's length after each verify counts only real tokens."""
    prompt = dense.tokenizer.encode("rejected drafts", add_bos=True)
    want = dense.generate(prompt, _gen(12)).token_ids
    calls = iter(range(1000))
    lengths, expect = [], []

    def wrong_every_other(ids, ngram, draft_len):
        if next(calls) % 2:
            return None  # a plain step
        nxt = want[len(ids) - len(prompt)] if len(ids) - len(prompt) < len(want) else 0
        expect.append(len(ids) - 1)  # K/V held: every id but the pending last
        return [(nxt + 1) % 256] * draft_len  # rejected at its first token

    real_forward = __import__("fei_tpu_torch.engine.engine", fromlist=["forward"]).forward

    def spy(params, cfg, toks, cache, **kw):
        logits, out = real_forward(params, cfg, toks, cache, **kw)
        if toks.shape[1] > 1 and cache.length.numel() == 1 and int(cache.length) > 0:
            lengths.append((int(cache.length), toks.shape[1]))
        return logits, out

    monkeypatch.setattr(type(dense), "_find_draft", staticmethod(wrong_every_other))
    monkeypatch.setattr("fei_tpu_torch.engine.engine.forward", spy)
    assert dense.generate_lookahead(prompt, _gen(12)).token_ids == want
    assert lengths, "no verify block ran"
    # each verify starts where the real tokens end, the rejected rows of
    # the one before it masked by the cut length
    assert [T for _, T in lengths] == [9] * len(lengths)
    assert [before for before, _ in lengths] == expect[:len(lengths)]


def test_dense_lookahead_equals_the_jax_package():
    jeng = JaxEngine.from_config("tiny-moe", dtype=jnp.float32, max_seq_len=256)
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params))
    eng = InferenceEngine.from_config("tiny-moe", params=params, device="cpu",
                                      dtype=torch.float32, max_seq_len=256)
    prompt = eng.tokenizer.encode(TEXT, add_bos=True)
    want = jeng.generate_lookahead(prompt, JaxGen(max_new_tokens=16, ignore_eos=True)).token_ids
    assert eng.generate_lookahead(prompt, _gen(16)).token_ids == want


def test_chat_speculates_on_greedy_dense_turns(dense):
    msgs = [{"role": "user", "content": TEXT}]
    ids = dense.tokenizer.apply_chat_template(msgs, add_generation_prompt=True)
    want = dense.generate(ids, _gen(12)).token_ids
    s0 = _span_count("spec_step") + _span_count("decode_step")
    assert dense.chat(msgs, _gen(12)).token_ids == want
    assert _span_count("spec_step") + _span_count("decode_step") > s0


# ---------------------------------------------------------------- paged


def _paged(monkeypatch, speculate: str, name="tiny", **kw):
    monkeypatch.setenv("FEI_TPU_SPECULATE", speculate)
    return InferenceEngine.from_config(name, device="cpu", dtype=torch.float32, paged=True,
                                       batch_size=2, max_seq_len=512, num_layers=2, **kw)


def _prompt(eng):
    return eng.tokenizer.encode(TEXT, add_bos=True)


def _plain_stream(monkeypatch, gen, name="tiny", **kw):
    ref = _paged(monkeypatch, "0", name, **kw)
    try:
        return list(ref.scheduler.stream(_prompt(ref), gen))
    finally:
        ref.close()


@pytest.mark.parametrize("name", ["tiny", "tiny-moe"])
def test_paged_single_stream_matches_unspeculated(monkeypatch, name):
    gen = _gen(24)
    want = _plain_stream(monkeypatch, gen, name)
    eng = _paged(monkeypatch, "1", name)
    try:
        assert list(eng.scheduler.stream(_prompt(eng), gen)) == want
    finally:
        eng.close()


def test_paged_spec_step_runs_and_takes_multi_token_steps(monkeypatch):
    gen = _gen(20)
    want = _plain_stream(monkeypatch, gen)
    eng = _paged(monkeypatch, "1")
    drafts = iter(range(1000))

    def fake_draft(ids, ngram, draft_len):
        k = (next(drafts) % draft_len) + 1
        return [(ids[-1] + i) % 256 for i in range(k)]

    monkeypatch.setattr(type(eng), "_find_draft", staticmethod(fake_draft))
    try:
        before = _counter("scheduler.spec_steps")
        assert list(eng.scheduler.stream(_prompt(eng), gen)) == want
        assert _counter("scheduler.spec_steps") > before
    finally:
        eng.close()


@pytest.mark.parametrize("name", ["tiny", "tiny-moe"])
def test_paged_multi_token_acceptance_on_echoing_output(monkeypatch, name):
    """The model's own continuation as the draft: tokens per dispatch > 2."""
    gen = _gen(24)
    want = _plain_stream(monkeypatch, gen, name)
    eng = _paged(monkeypatch, "1", name)
    n_prompt = len(_prompt(eng))

    def oracle_draft(ids, ngram, draft_len):
        done = len(ids) - n_prompt
        return list(want[done:done + draft_len]) or None

    monkeypatch.setattr(type(eng), "_find_draft", staticmethod(oracle_draft))
    try:
        s0, a0 = _counter("scheduler.spec_steps"), _counter("scheduler.spec_accepted")
        assert list(eng.scheduler.stream(_prompt(eng), gen)) == want
        steps = _counter("scheduler.spec_steps") - s0
        accepted = _counter("scheduler.spec_accepted") - a0
        assert steps > 0 and accepted > 0
        assert (accepted + steps) / steps > 2.0, (accepted, steps)
    finally:
        eng.close()


def test_paged_two_streams_do_not_speculate_but_stay_exact(monkeypatch):
    gen = _gen(16)
    want = _plain_stream(monkeypatch, gen)
    eng = _paged(monkeypatch, "1")
    results: dict = {}

    def run(tag):
        results[tag] = list(eng.scheduler.stream(_prompt(eng), gen))

    try:
        ts = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        [t.start() for t in ts]
        [t.join() for t in ts]
        assert results[0] == want and results[1] == want
    finally:
        eng.close()


def test_paged_sampled_stream_never_speculates(monkeypatch):
    eng = _paged(monkeypatch, "1")
    try:
        before = _counter("scheduler.spec_steps")
        toks = list(eng.scheduler.stream(_prompt(eng), _gen(8, temperature=0.9, seed=7)))
        assert len(toks) == 8
        assert _counter("scheduler.spec_steps") == before
    finally:
        eng.close()


def test_paged_spec_kernel_failure_fails_the_streams(monkeypatch):
    """A failed verify dispatch fails the stream through ``_fail_all``
    like every other kernel failure; speculation stays on and
    ``scheduler.spec_disabled`` does not move (the JAX package turns it
    off and continues: ROADMAP F3)."""
    eng = _paged(monkeypatch, "1")
    monkeypatch.setattr(type(eng), "_find_draft", staticmethod(lambda ids, n, d: [1, 2, 3]))

    def boom(T):
        def fn(*a, **k):
            raise RuntimeError("the verify kernel failed to launch")
        return fn

    monkeypatch.setattr(eng.scheduler, "_spec_fn", boom)
    d0 = _counter("scheduler.spec_disabled")
    try:
        with pytest.raises(RuntimeError, match="verify kernel"):
            list(eng.scheduler.stream(_prompt(eng), _gen(16)))
        assert eng.scheduler.speculate is True
        assert _counter("scheduler.spec_disabled") == d0
    finally:
        eng.close()


def test_paged_grammar_free_phase_speculates(monkeypatch):
    gen = _gen(24)
    never = "\x07NEVER\x07"  # a trigger that cannot occur: the whole turn is free
    ref = _paged(monkeypatch, "0")
    try:
        want = list(ref.generate_stream_toolcalls(
            _prompt(ref), gen, grammar=compile_agent_tool_grammar(TOOLS, ref.tokenizer),
            trigger=never))
    finally:
        ref.close()
    eng = _paged(monkeypatch, "1")
    n_prompt = len(_prompt(eng))

    def oracle_draft(ids, ngram, draft_len):
        done = len(ids) - n_prompt
        return list(want[done:done + draft_len]) or None

    monkeypatch.setattr(type(eng), "_find_draft", staticmethod(oracle_draft))
    try:
        s0 = _counter("scheduler.spec_steps")
        got = list(eng.generate_stream_toolcalls(
            _prompt(eng), gen, grammar=compile_agent_tool_grammar(TOOLS, eng.tokenizer),
            trigger=never))
        assert got == want
        assert _counter("scheduler.spec_steps") > s0, "the free phase never speculated"
    finally:
        eng.close()


def test_paged_trigger_mid_spec_block_engages_the_grammar(monkeypatch):
    """The trigger completes inside a verified block: the rest of the
    block is dropped and the DFA takes over; the call is valid."""
    eng = _paged(monkeypatch, "1")
    g = compile_agent_tool_grammar(TOOLS, eng.tokenizer)
    try:
        free = list(eng.scheduler.stream(_prompt(eng), _gen(24)))
        trigger = ""
        for k in range(2, len(free) + 1):
            trigger = eng.tokenizer.decode(free[:k])
            if trigger:
                break
        assert trigger, "the model's output decodes entirely empty"

        def eager_draft(ids, ngram, draft_len):
            done = len(ids) - len(_prompt(eng))
            return list(free[done:done + draft_len]) or [free[0]]

        monkeypatch.setattr(type(eng), "_find_draft", staticmethod(eager_draft))
        s0 = _counter("scheduler.spec_steps")
        toks = list(eng.generate_stream_toolcalls(_prompt(eng), _gen(96), grammar=g,
                                                  trigger=trigger))
        assert _counter("scheduler.spec_steps") > s0
        text = eng.tokenizer.decode(toks)
        if trigger in text and text.endswith("</tool_call>"):
            payload = text.split(trigger, 1)[1][: -len("</tool_call>")]
            assert json.loads(payload)["name"] == "LS"
            assert char_walk(g, payload) == g.accept
        else:
            assert "</tool_call>" not in text
    finally:
        eng.close()


# ---------------------------------------------------------------- knobs


def test_scheduler_reads_the_speculation_variables(monkeypatch):
    for var in ("FEI_TPU_SPECULATE", "FEI_TPU_SPEC_NGRAM", "FEI_TPU_SPEC_DRAFT"):
        monkeypatch.delenv(var, raising=False)
    eng = InferenceEngine.from_config("tiny", device="cpu", dtype=torch.float32, paged=True,
                                      batch_size=1, max_seq_len=64, num_layers=1)
    s = eng.scheduler
    assert (s.speculate, s.spec_ngram, s.spec_draft_len) == (False, 3, 8)
    eng.close()
    monkeypatch.setenv("FEI_TPU_SPECULATE", "1")
    monkeypatch.setenv("FEI_TPU_SPEC_NGRAM", "2")
    monkeypatch.setenv("FEI_TPU_SPEC_DRAFT", "5")
    eng = InferenceEngine.from_config("tiny", device="cpu", dtype=torch.float32, paged=True,
                                      batch_size=1, max_seq_len=64, num_layers=1)
    s = eng.scheduler
    assert (s.speculate, s.spec_ngram, s.spec_draft_len) == (True, 2, 5)
    eng.close()


def test_swa_release_margin_covers_a_rejected_draft(monkeypatch):
    """The rolling-window margin is max(spec_draft_len, multistep) + page
    size (the JAX package's): with a 12-token draft over a 2-step scan a
    page is released only once it stays below the window after the
    deepest cut. A speculated tiny-swa stream with pages released equals
    the plain one."""
    monkeypatch.setenv("FEI_TPU_SPEC_DRAFT", "12")
    monkeypatch.setenv("FEI_TPU_SCHED_MULTISTEP", "2")
    eng = _paged(monkeypatch, "1", "tiny-swa", page_size=4)
    sched = eng.scheduler
    released = []
    eng._ensure_pool()
    eng._allocator.release_prefix = lambda slot, n: released.append(n)
    W, ps = eng.cfg.sliding_window, eng.page_size
    seq = types.SimpleNamespace(prompt_ids=[0] * 20, generated=[], released_pages=0, slot=0)
    margin = max(12, 2) + ps
    seq.generated = [0] * (W + margin + ps - 1 - 20)  # one token short of a page
    sched._release_window_pages(seq)
    assert released == []
    seq.generated.append(0)
    sched._release_window_pages(seq)
    assert released == [1] and seq.released_pages == 1
    eng.close()

    gen = _gen(40)
    want = _plain_stream(monkeypatch, gen, "tiny-swa", page_size=4)
    eng = _paged(monkeypatch, "1", "tiny-swa", page_size=4)
    n_prompt = len(_prompt(eng))
    monkeypatch.setattr(type(eng), "_find_draft", staticmethod(
        lambda ids, n, d: list(want[len(ids) - n_prompt:len(ids) - n_prompt + d]) or None))
    try:
        r0, s0 = _counter("scheduler.swa_pages_released"), _counter("scheduler.spec_steps")
        assert list(eng.scheduler.stream(_prompt(eng), gen)) == want
        assert _counter("scheduler.swa_pages_released") > r0
        assert _counter("scheduler.spec_steps") > s0
    finally:
        eng.close()


def test_provider_routes_greedy_dense_turns_to_the_lookahead(monkeypatch):
    from fei_tpu_torch.agent.providers import TorchLocalProvider

    eng = InferenceEngine.from_config("tiny", device="cpu", dtype=torch.float32,
                                      max_seq_len=512, num_layers=2)
    provider = TorchLocalProvider(engine=eng)
    msgs = [{"role": "user", "content": TEXT}]
    greedy = {"temperature": 0.0}
    calls = []
    real = eng.generate_stream_lookahead

    def spy(ids, gen):
        calls.append(len(ids))
        return real(ids, gen)

    monkeypatch.setattr(eng, "generate_stream_lookahead", spy)
    monkeypatch.setenv("FEI_TPU_SPECULATE", "0")
    want = provider.complete(msgs, max_tokens=12, gen_overrides=greedy)
    assert calls == []
    monkeypatch.setenv("FEI_TPU_SPECULATE", "1")
    got = provider.complete(msgs, max_tokens=12, gen_overrides=greedy)
    assert len(calls) == 1 and got.content == want.content
    provider.complete(msgs, max_tokens=4, gen_overrides={"temperature": 0.7, "seed": 1})
    assert len(calls) == 1  # a sampled turn keeps the normal stream
