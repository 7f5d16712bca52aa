"""The port's grammar (``fei_tpu_torch.engine.grammar``) against fei_tpu's:
for the JAX package's test schemas and the 14-tool union on the byte
tokenizer, the lifted tables (``table``, ``min_dist``, ``accepting_states``,
``entry``, ``accept``) are bitwise the same; ``walk``, ``logit_mask_fn``,
``feasible_mask`` (numpy and torch), ``char_walk``, ``TriggerScanner`` and
``toolcall_stream_mask_fn`` agree on the same streams; the device tables
pad with -1, keep int16 and are memoized per (vocab, device)."""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import numpy as np
import pytest
import torch

from fei_tpu.engine import grammar as jg
from fei_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from fei_tpu.tools.definitions import TOOL_DEFINITIONS as JAX_TOOLS
from fei_tpu_torch.engine import grammar as tg
from fei_tpu_torch.engine.tokenizer import ByteTokenizer
from fei_tpu_torch.tools.definitions import TOOL_DEFINITIONS

SCHEMAS = [
    {"type": "object", "properties": {"pattern": {"type": "string"},
                                      "limit": {"type": "integer"}}},
    {"type": "object", "properties": {"score": {"type": "number"},
                                      "flag": {"type": "boolean"}}},
    {"type": "object", "properties": {"mode": {"enum": ["fast", "full", "files"]}}},
    {"type": "object", "properties": {
        "tags": {"type": "array", "items": {"type": "string"}},
        "opts": {"type": "object", "properties": {"n": {"type": "integer"},
                                                  "x": {"type": ["string", "null"]}}}}},
    {"type": "object", "properties": {"v": {"enum": [1, 12, 123]}}},
    {"type": "number"},
    {"type": "object", "properties": {"a": {"type": "string"}, "b": {"type": "integer"},
                                      "c": {"type": "boolean"}}, "required": ["b"]},
    {"type": "object", "properties": {"path": {"type": "string"},
                                      "pattern": {"type": "string"}}, "required": []},
]


@pytest.fixture(scope="module")
def union():
    return (jg.compile_agent_tool_grammar(JAX_TOOLS, JaxByteTokenizer()),
            tg.compile_agent_tool_grammar(TOOL_DEFINITIONS, ByteTokenizer()))


def _same_tables(a, b):
    assert a.table.dtype == b.table.dtype
    assert a.table.shape == b.table.shape
    assert np.array_equal(a.table, b.table)
    assert np.array_equal(a.mask_table, b.mask_table)
    assert a.min_dist.dtype == b.min_dist.dtype
    assert np.array_equal(a.min_dist, b.min_dist)
    assert a.accepting_states == b.accepting_states
    assert (a.entry, a.accept) == (b.entry, b.accept)
    assert np.array_equal(a.grammar.char_table, b.grammar.char_table)


@pytest.mark.parametrize("i", range(len(SCHEMAS)))
def test_schema_tables_bitwise(i):
    _same_tables(jg.compile_tool_call_grammar(SCHEMAS[i], JaxByteTokenizer()),
                 tg.compile_tool_call_grammar(SCHEMAS[i], ByteTokenizer()))


def test_union_tables_bitwise(union):
    a, b = union
    _same_tables(a, b)
    # the 14-tool union on the byte tokenizer: what the card's agent phase lifts
    assert b.table.shape == (1007, 264) and b.table.dtype == np.int16
    assert int(b.min_dist[b.entry]) == 37


def _streams(g, n=6, length=40, seed=0):
    """Random token streams that stay legal for a while, then wander off."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        s, ids = g.entry, []
        for step in range(length):
            legal = np.flatnonzero(g.table[s] >= 0) if s >= 0 else np.array([], int)
            if legal.size and not (k == n - 1 and step == length // 2):
                t = int(rng.choice(legal))
            else:
                t = int(rng.integers(0, g.table.shape[1]))
            ids.append(t)
            s = int(g.table[s, t]) if s >= 0 else -1
        out.append(ids)
    return out


def test_walk_and_logit_mask_fn_agree(union):
    a, b = union
    for ids in _streams(b):
        fa, fb = a.logit_mask_fn(max_tokens=48), b.logit_mask_fn(max_tokens=48)
        for j in range(len(ids) + 1):
            assert a.walk(ids[:j]) == b.walk(ids[:j])
            ma, mb = fa(ids[:j]), fb(ids[:j])
            assert (ma is None) == (mb is None)
            if ma is not None:
                assert np.array_equal(ma, mb)


@pytest.mark.parametrize("remaining", [1, 2, 5, 37, 38, 200])
def test_feasible_mask_numpy_and_torch(union, remaining):
    a, b = union
    rows = np.arange(0, b.table.shape[0], 7)
    ref = np.stack([jg.feasible_mask(a.table[s], a.min_dist, remaining) for s in rows])
    mine = np.stack([tg.feasible_mask(b.table[s], b.min_dist, remaining) for s in rows])
    assert np.array_equal(ref, mine)
    table, min_dist = b.device_tables(300, "cpu")
    rem = torch.full((len(rows),), remaining, dtype=torch.int32)
    dev = tg.feasible_mask(table[torch.as_tensor(rows)], min_dist, rem)
    assert dev.dtype == torch.bool and tuple(dev.shape) == (len(rows), 300)
    assert np.array_equal(dev[:, :264].numpy(), ref)
    assert not dev[:, 264:].any()  # padded columns are never legal
    # a budget-feasible row keeps a legal token: the masked sample is finite
    feasible = b.min_dist[rows] <= remaining
    assert dev[torch.as_tensor(feasible)].any(dim=-1).all()


def test_device_tables_padded_int16_memoized(union):
    _, b = union
    table, min_dist = b.device_tables(512, "cpu")
    assert table.dtype == torch.int16 and min_dist.dtype == torch.int32
    assert tuple(table.shape) == (1007, 512)
    assert np.array_equal(table[:, :264].numpy(), b.table)
    assert (table[:, 264:] == -1).all()
    assert b.device_tables(512, "cpu")[0] is table
    assert b.device_tables(264, "cpu")[0] is not table


@pytest.mark.parametrize("vocab", [None, 264, 300, 1024])
def test_device_tables_bitwise_the_reference(union, vocab):
    a, b = union
    ref_table, ref_min = (np.asarray(x) for x in a.device_tables(vocab))
    table, min_dist = b.device_tables(vocab, "cpu")
    assert table.numpy().dtype == ref_table.dtype and min_dist.numpy().dtype == ref_min.dtype
    assert np.array_equal(table.numpy(), ref_table)
    assert np.array_equal(min_dist.numpy(), ref_min)


@pytest.mark.parametrize("use_rows", [False, True])
def test_grammar_step_masks_and_advances(union, use_rows):
    """grammar_step is the DFA step of the dense chunk (every row masked,
    a scalar budget) and of the scheduler's sampler (rows with ``use``
    False pass unmasked and keep state and budget)."""
    _, b = union
    table, min_dist = b.device_tables(300, "cpu")
    rng = np.random.default_rng(3)
    B = 6
    gstate = torch.as_tensor(rng.integers(0, table.shape[0], B), dtype=torch.int32)
    logits = torch.as_tensor(rng.standard_normal((B, 300)), dtype=torch.float32)
    if use_rows:
        use = torch.tensor([True, False, True, True, False, True])
        gstate = torch.where(use, gstate, -1)
        remaining = torch.as_tensor(rng.integers(1, 60, B), dtype=torch.int32)
    else:
        use = None
        remaining = torch.tensor(40, dtype=torch.int32)
    masked, advance = tg.grammar_step(logits, table, min_dist, gstate, remaining, use=use)
    nxt = masked.argmax(-1)
    nstate, nrem = advance(nxt)
    assert nstate.dtype == torch.int32 and nrem.shape == remaining.shape
    for r in range(B):
        if use is not None and not use[r]:
            assert torch.equal(masked[r], logits[r])
            assert nstate[r] == -1 and nrem[r] == remaining[r]
            continue
        budget = int(remaining if remaining.ndim == 0 else remaining[r])
        legal = torch.as_tensor(tg.feasible_mask(table[int(gstate[r])].numpy(),
                                                 min_dist.numpy(), budget))
        assert torch.equal(torch.isfinite(masked[r]), legal)
        assert legal[nxt[r]]
        assert nstate[r] == int(table[int(gstate[r]), int(nxt[r])])
    if use is None:
        assert int(nrem) == 39
    else:
        assert torch.equal(nrem[use], remaining[use] - 1)


def test_char_walk_agrees(union):
    a, b = union
    for text in ('{"name":"LS","arguments":{"path":"src"}}',
                 '\n {"name":"Shell","arguments":{"command":"ls","timeout":5}}',
                 '{"name":"GlobTool","arguments":{"pattern":"*.py","path":"a"}}',
                 '{"name":"Nope"', '{"name":"View","arguments":{}}', ''):
        assert jg.char_walk(a, text) == tg.char_walk(b, text)
        for start in (None, a.entry, 5):
            assert jg.char_walk(a, text[:9], start) == tg.char_walk(b, text[:9], start)


def test_trigger_scanner_agrees():
    jt, t = JaxByteTokenizer(), ByteTokenizer()
    text = 'ab<tool_call>{"x"} more <tool_<tool_call>\n{"name"'
    ja, tb = jg.TriggerScanner(jt, "<tool_call>"), tg.TriggerScanner(t, "<tool_call>")
    hits = []
    for i in t.encode(text):
        ha, hb = ja.feed(i), tb.feed(i)
        assert ha == hb
        if hb is not None:
            hits.append(hb)
    assert hits == ["", ""]


def test_toolcall_stream_mask_fn_agrees(union):
    a, b = union
    tok = ByteTokenizer()
    call = '{"name":"LS","arguments":{"path":"x"}}'
    for prefix in ("hello <tool_call>", "<tool_call>\n", "no trigger here"):
        ids = tok.encode(prefix + call) + tok.stop_token_ids[:1]
        fa, sa = jg.toolcall_stream_mask_fn(a, JaxByteTokenizer(), max_tokens=96)
        fb, sb = tg.toolcall_stream_mask_fn(b, tok, max_tokens=96)
        for j in range(len(ids) + 1):
            ma, mb = fa(ids[:j]), fb(ids[:j])
            assert (ma is None) == (mb is None)
            if ma is not None:
                assert np.array_equal(ma, mb)
            assert (sa["mode"], sa["s"], sa["accepted"]) == (sb["mode"], sb["s"], sb["accepted"])
        assert sb["accepted"] == ("<tool_call>" in prefix)
