"""Survival in the port: graceful drain, warm restart from drain snapshots,
and crash recovery from the session journal, on the ``tiny`` config (two
layers, fp32) with the JAX package's weights (``params_from_jax``).

The drain cases of tests/test_preemption.py and the single-chip crash
cases of tests/test_crash_recovery.py, on the port:
- a draining engine sheds new submits with Retry-After; the drain is
  idempotent and sticky; a constrained request fails typed;
- queued requests snapshot and replay at a warm restart, and a drain in
  mid-decode loses nothing: the restored stream is the uninterrupted one;
- a journal directory copied in mid-stream (the process "dies" with it)
  recovers byte-identically, greedy and seeded; an expired deadline and
  another page size are skipped (counted), another mesh is accepted;
- the route is carried: a densely admitted prompt restores densely, a
  record without a route (the JAX package's) restores through chunks;
- ``/drain`` flips ``/health`` and validates its deadline; the provider's
  ``stream(resume=...)`` and the ``"resume"`` body equal the
  uninterrupted turn; the ``crash`` fault's fuse and the snapshot
  writer's fsyncs.

Across packages: the port's streams are held against the JAX package's
UNINTERRUPTED paged streams (computed once per module); a JAX-package
journal copied in mid-stream recovers in the port to those streams; the
JAX package reads a port-written snapshot file and journal unchanged, and
the port reads the JAX package's snapshot file. The JAX package's own
replay (tests/test_crash_recovery.py::TestJournalReplay::
test_byte_identity_after_crash) is never the reference here: it fails on
its own (ROADMAP.md §3).
"""

from __future__ import annotations

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fei_tpu.engine import checkpoint as jax_ckpt
from fei_tpu.engine import journal as jax_journal
from fei_tpu.engine.engine import GenerationConfig as JaxGen
from fei_tpu.engine.engine import InferenceEngine as JaxEngine
from fei_tpu_torch.engine import checkpoint as pt_ckpt
from fei_tpu_torch.engine import faults as faults_mod
from fei_tpu_torch.engine.engine import GenerationConfig, InferenceEngine
from fei_tpu_torch.engine.faults import FAULTS
from fei_tpu_torch.engine.journal import SessionJournal
from fei_tpu_torch.engine.journal import recover as pt_recover
from fei_tpu_torch.models.convert import params_from_jax
from fei_tpu_torch.utils.errors import (
    CheckpointError,
    EngineDrainingError,
    PageSizeMismatchError,
)
from fei_tpu_torch.utils.metrics import METRICS

MAX_SEQ = 256
PROMPT = list(range(1, 19))
LONG = list(range(40, 100))  # 60 tokens: admitted in chunks of 32
GREEDY = dict(max_new_tokens=24, ignore_eos=True)
SEEDED = dict(max_new_tokens=24, ignore_eos=True, temperature=0.9, top_k=40, seed=7)


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.disarm()
    yield
    FAULTS.disarm()


def _counter(name: str) -> float:
    return METRICS.snapshot()["counters"].get(name, 0)


def _gauge(name: str) -> float:
    return METRICS.snapshot()["gauges"].get(name, 0)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's tiny fp32 weights and its uninterrupted paged
    streams: greedy and seeded for PROMPT, greedy for the chunked LONG."""
    dense = JaxEngine.from_config("tiny", dtype=jnp.float32, max_seq_len=MAX_SEQ, num_layers=2)
    eng = JaxEngine(dense.cfg, dense.params, dense.tokenizer, max_seq_len=MAX_SEQ,
                    dtype=jnp.float32, paged=True, page_size=16, batch_size=2)
    eng.scheduler.prefill_chunk = 32
    try:
        streams = {
            "greedy": list(eng.scheduler.stream(PROMPT, JaxGen(**GREEDY))),
            "seeded": list(eng.scheduler.stream(PROMPT, JaxGen(**SEEDED))),
            "long": list(eng.scheduler.stream(LONG, JaxGen(**GREEDY))),
        }
    finally:
        eng.close()
    return dense, streams


@pytest.fixture(scope="module")
def params(jax_ref):
    return params_from_jax(jax.tree.map(np.asarray, jax_ref[0].params))


def _make(params, **kw) -> InferenceEngine:
    eng = InferenceEngine.from_config(
        "tiny", params=params, paged=True, page_size=kw.pop("page_size", 16),
        batch_size=kw.pop("batch_size", 2), device="cpu", dtype=torch.float32,
        max_seq_len=MAX_SEQ, num_layers=2, **kw)
    eng.scheduler.prefill_chunk = 32
    return eng


def _journal_engine(params, monkeypatch, jdir: str, sync: str = "batch") -> InferenceEngine:
    """A port engine with the journal on: the scheduler reads the
    FEI_TPU_JOURNAL_* variables once, when it is built."""
    with monkeypatch.context() as m:
        m.setenv("FEI_TPU_JOURNAL_DIR", jdir)
        m.setenv("FEI_TPU_JOURNAL_SYNC", sync)
        return _make(params)


def _shutdown(eng) -> None:
    eng.close()
    eng.scheduler.close_journal()


# -- graceful drain ---------------------------------------------------------


def test_drain_sheds_new_submits_with_retry_after(params):
    eng = _make(params)
    eng.begin_drain(deadline_s=5)
    assert eng.wait_drained(timeout=10)
    assert _gauge("engine.draining") == 1
    with pytest.raises(EngineDrainingError) as e:
        eng.scheduler.submit(PROMPT, GenerationConfig(**GREEDY))
    assert e.value.retry_after_s > 0


def test_drain_is_idempotent_and_sticky(params):
    eng = _make(params)
    eng.begin_drain(deadline_s=1)
    eng.begin_drain(deadline_s=99)  # a no-op: the first drain wins
    assert eng.wait_drained(timeout=10)
    assert eng.scheduler.draining()


def test_constrained_request_fails_typed_at_drain(params, monkeypatch):
    """A constraint (grammar automaton, mask closure) cannot be snapshotted
    across processes: drain fails the request with the typed error."""
    eng = _make(params)
    sched = eng.scheduler
    monkeypatch.setattr(sched, "_start_thread", lambda: None)  # parked loop
    seq = sched.submit(PROMPT, GenerationConfig(**GREEDY))
    seq.mask_fn = lambda toks: None  # host-masked == constrained
    eng.begin_drain(deadline_s=0)
    assert sched.wait_drained(timeout=10)
    with pytest.raises(EngineDrainingError):
        list(sched.drain(seq))
    assert seq.status == "failed"


def test_queued_requests_snapshot_and_warm_restart_replays(params, jax_ref, monkeypatch,
                                                          tmp_path):
    """Requests parked in the queue drain to disk, a fresh engine
    re-admits them, and each stream equals the uninterrupted one — the
    port's and the JAX package's. The JAX package reads the file too."""
    gens = [GenerationConfig(**GREEDY), GenerationConfig(**SEEDED)]
    eng = _make(params)
    sched = eng.scheduler
    monkeypatch.setattr(sched, "_start_thread", lambda: None)
    seqs = [sched.submit(PROMPT, g) for g in gens]
    s0 = _counter("scheduler.requests_snapshotted")
    eng.begin_drain(deadline_s=0, snapshot_dir=str(tmp_path))
    assert sched.wait_drained(timeout=10)
    assert _counter("scheduler.requests_snapshotted") == s0 + 2
    for s in seqs:
        assert s.status == "snapshotted"
        with pytest.raises(EngineDrainingError):
            list(sched.drain(s))
    theirs = jax_ckpt.load_request_snapshots(str(tmp_path), expect_page_size=16)
    assert theirs == pt_ckpt.load_request_snapshots(str(tmp_path))
    assert [s["gen"]["seed"] for s in theirs] == [0, 7]

    eng2 = _make(params)
    try:
        restored = eng2.warm_restart(str(tmp_path))
        assert len(restored) == 2
        assert pt_ckpt.load_request_snapshots(str(tmp_path)) == []  # at-most-once
        assert eng2.warm_restart(str(tmp_path)) == []
        outs = [list(eng2.scheduler.drain(s)) for s in restored]
    finally:
        eng2.close()
    _, ref = jax_ref
    assert outs == [ref["greedy"], ref["seeded"]]


def _drain_mid_decode(eng, snap_dir: str, gen, prompt, after: int = 4):
    """Start ``gen`` on ``prompt`` and begin a drain from the loop thread
    once ``after`` tokens were delivered (deterministic: the rest of that
    scan is delivered, then the drain finalizes). Returns the tokens the
    old consumer saw and its sequence."""
    sched = eng.scheduler
    deliver = sched._deliver

    def deliver_then_drain(seq, t, key=None):
        deliver(seq, t, key)
        if len(seq.generated) == after and not sched.draining():
            sched.begin_drain(deadline_s=0, snapshot_dir=snap_dir)

    sched._deliver = deliver_then_drain
    seq = sched.submit(prompt, gen)
    before = []
    with pytest.raises(EngineDrainingError):
        for t in sched.drain(seq):
            before.append(t)
    assert sched.wait_drained(timeout=30)
    return before, seq


@pytest.mark.parametrize("kind", ["greedy", "seeded", "long"])
def test_mid_decode_drain_loses_nothing(params, jax_ref, tmp_path, kind):
    """A drain in mid-decode snapshots the running request (its delivered
    tokens, its key, its route); the restored stream replays the
    delivered prefix and continues as the uninterrupted run, densely and
    chunk-admitted prompts alike."""
    prompt = LONG if kind == "long" else PROMPT
    gen = GenerationConfig(**(SEEDED if kind == "seeded" else GREEDY))
    eng = _make(params)
    before, seq = _drain_mid_decode(eng, str(tmp_path), gen, prompt)
    assert seq.status == "snapshotted" and 4 <= len(before) < 24
    snaps = pt_ckpt.load_request_snapshots(str(tmp_path))
    assert [s["route"] for s in snaps] == ["chunked" if kind == "long" else "dense"]
    assert snaps[0]["generated"] == before
    r0 = _counter("scheduler.requests_restored")
    eng2 = _make(params)
    try:
        restored = eng2.warm_restart(str(tmp_path))
        after = list(eng2.scheduler.drain(restored[0]))
    finally:
        eng2.close()
    assert after[: len(before)] == before
    assert after == jax_ref[1][kind]
    assert _counter("scheduler.requests_restored") == r0 + 1


@pytest.mark.parametrize("route", ["dense", None], ids=["dense", "no_route"])
def test_route_is_carried(params, tmp_path, monkeypatch, route):
    """A densely admitted prompt restores through one dense prefill; a
    snapshot without a route (as the JAX package writes them) restores
    through the chunks, the reference's route."""
    eng = _make(params)
    before, _ = _drain_mid_decode(eng, str(tmp_path), GenerationConfig(**SEEDED), PROMPT)
    snaps = pt_ckpt.load_request_snapshots(str(tmp_path))
    if route is None:
        del snaps[0]["route"]
    pt_ckpt.save_request_snapshots(str(tmp_path), snaps, page_size=16)
    eng2 = _make(params)
    calls = []
    dense_prefill = eng2.scheduler._dense_prefill
    monkeypatch.setattr(eng2.scheduler, "_dense_prefill",
                        lambda ids: calls.append(len(ids)) or dense_prefill(ids))
    try:
        after = list(eng2.scheduler.drain(eng2.warm_restart(str(tmp_path))[0]))
    finally:
        eng2.close()
    assert calls == ([len(PROMPT)] if route == "dense" else [])
    assert after[: len(before)] == before and len(after) == 24


# -- crash recovery from the journal -----------------------------------------


def _crash_and_copy(eng, jdir: str, crash_dir: str, n_pull: int = 5):
    """kill -9 without the kill: pull a few delivered tokens, then freeze
    the journal directory as the dead process left it (no end records,
    no drain)."""
    s1 = eng.scheduler.submit(PROMPT, GenerationConfig(**GREEDY))
    s2 = eng.scheduler.submit(PROMPT, GenerationConfig(**SEEDED))
    got1 = [s1.out.get() for _ in range(n_pull)]
    got2 = [s2.out.get() for _ in range(n_pull)]
    assert eng.scheduler._journal.flush()
    shutil.copytree(jdir, crash_dir)
    return got1, got2


@pytest.mark.parametrize("sync", ["batch", "always"])
def test_byte_identity_after_crash(params, jax_ref, monkeypatch, tmp_path, sync):
    """Sessions mid-decode when the process died resume from the journal
    alone, greedy and seeded at once, their delivered prefixes replayed
    exactly once; the streams equal the uninterrupted run."""
    jdir, crash_dir = str(tmp_path / "wal"), str(tmp_path / "dead")
    eng = _journal_engine(params, monkeypatch, jdir, sync)
    try:
        got1, got2 = _crash_and_copy(eng, jdir, crash_dir)
    finally:
        _shutdown(eng)
    ref = jax_ref[1]
    assert got1 == ref["greedy"][:5] and got2 == ref["seeded"][:5]
    # the JAX package reads the port's journal to the same sessions (less
    # the route, which its reader ignores)
    ours, _ = pt_recover(crash_dir)
    theirs, _ = jax_journal.recover(crash_dir)
    assert theirs == [{k: v for k, v in x.items() if k != "route"} for x in ours]
    assert {x["route"] for x in ours} == {"dense"}

    c0 = _counter("journal.recovered_sessions")
    eng2 = _journal_engine(params, monkeypatch, crash_dir)
    try:
        restored = eng2.warm_restart()
        assert len(restored) == 2
        outs = [list(eng2.scheduler.drain(s)) for s in restored]
        assert ref["greedy"] in outs and ref["seeded"] in outs
        assert _counter("journal.recovered_sessions") - c0 == 2
        assert eng2.warm_restart() == []  # the segments were consumed
    finally:
        _shutdown(eng2)


def test_jax_journal_recovers_in_the_port(params, jax_ref, monkeypatch, tmp_path):
    """A journal the JAX package's scheduler wrote, copied in mid-stream,
    recovers in the port (no route recorded: the chunked route); the
    completed streams equal the JAX package's uninterrupted ones."""
    dense, ref = jax_ref
    jdir, crash_dir = str(tmp_path / "wal"), str(tmp_path / "dead")
    with monkeypatch.context() as m:
        m.setenv("FEI_TPU_JOURNAL_DIR", jdir)
        jeng = JaxEngine(dense.cfg, dense.params, dense.tokenizer, max_seq_len=MAX_SEQ,
                         dtype=jnp.float32, paged=True, page_size=16, batch_size=2)
    try:
        s1 = jeng.scheduler.submit(PROMPT, JaxGen(**GREEDY))
        s2 = jeng.scheduler.submit(PROMPT, JaxGen(**SEEDED))
        got1 = [s1.out.get() for _ in range(5)]
        got2 = [s2.out.get() for _ in range(5)]
        assert jeng.scheduler._journal.flush()
        shutil.copytree(jdir, crash_dir)
    finally:
        jeng.close()
        jeng.scheduler._journal.close()
    assert got1 == ref["greedy"][:5] and got2 == ref["seeded"][:5]
    eng = _journal_engine(params, monkeypatch, crash_dir)
    try:
        restored = eng.warm_restart()
        assert len(restored) == 2
        outs = [list(eng.scheduler.drain(s)) for s in restored]
    finally:
        _shutdown(eng)
    assert ref["greedy"] in outs and ref["seeded"] in outs


def _one_session(jdir: str, **fields) -> None:
    j = SessionJournal(jdir)
    j.admit({"rid": "r", "prompt_ids": PROMPT,
             "gen": {"max_new_tokens": 4, "ignore_eos": True}, **fields})
    assert j.flush()
    j.close()


@pytest.mark.parametrize("fields, counter, n_restored", [
    ({"deadline_epoch": 1.0}, "engine.recovery_skipped.deadline_expired", 0),
    ({"page_size": 999}, "engine.recovery_skipped.page_size", 0),
    ({"mesh": {"tp": 8}}, "engine.cross_mesh_recoveries", 1),
], ids=["expired_deadline", "page_size", "other_mesh"])
def test_recovery_gates(params, monkeypatch, tmp_path, fields, counter, n_restored):
    """An expired deadline and another page size drop the session, visibly
    (a counter); another mesh is provenance and replays."""
    jdir = str(tmp_path / "wal")
    _one_session(jdir, **fields)
    c0 = _counter(counter)
    eng = _journal_engine(params, monkeypatch, jdir)
    try:
        restored = eng.warm_restart()
        assert len(restored) == n_restored
        assert _counter(counter) - c0 == 1
        for s in restored:
            assert len(list(eng.scheduler.drain(s))) == 4
    finally:
        _shutdown(eng)


# -- snapshot files -----------------------------------------------------------


def test_snapshot_file_roundtrip_and_gates(tmp_path):
    snaps = [{"rid": "req-1", "prompt_ids": [1, 2], "generated": [3]}]
    pt_ckpt.save_request_snapshots(str(tmp_path), snaps, page_size=16)
    assert pt_ckpt.load_request_snapshots(str(tmp_path)) == snaps
    with pytest.raises(PageSizeMismatchError):
        pt_ckpt.load_request_snapshots(str(tmp_path), expect_page_size=64)
    pt_ckpt.clear_request_snapshots(str(tmp_path))
    assert pt_ckpt.load_request_snapshots(str(tmp_path)) == []
    pt_ckpt.clear_request_snapshots(str(tmp_path))  # idempotent
    # the JAX package's file loads in the port
    jax_ckpt.save_request_snapshots(str(tmp_path), snaps, page_size=16)
    assert pt_ckpt.load_request_snapshots(str(tmp_path), expect_page_size=16) == snaps
    (tmp_path / "requests.json").write_text("not json{")
    with pytest.raises(CheckpointError):
        pt_ckpt.load_request_snapshots(str(tmp_path))
    (tmp_path / "requests.json").write_text('{"version": 999, "requests": []}')
    with pytest.raises(CheckpointError):
        pt_ckpt.load_request_snapshots(str(tmp_path))


def test_snapshot_writer_fsyncs_file_and_dir(tmp_path, monkeypatch):
    synced = []
    real_fsync = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: (synced.append(fd), real_fsync(fd))[1])
    pt_ckpt.save_request_snapshots(
        str(tmp_path), [{"rid": "r", "prompt_ids": [1], "gen": {}}], mesh={"tp": 1})
    assert len(synced) >= 2  # the tmp file before the rename, then the directory


def test_crash_fault_is_a_delay_fuse(monkeypatch):
    kills = []
    monkeypatch.setattr(faults_mod, "_hard_kill", lambda point: kills.append(point))
    FAULTS.arm("replica.crash", "crash", count=3)
    for _ in range(2):
        FAULTS.check("replica.crash")
    assert kills == []  # the fuse is burning
    FAULTS.check("replica.crash")
    assert kills == ["replica.crash"]
    FAULTS.check("replica.crash")  # disarmed after firing
    assert kills == ["replica.crash"] and FAULTS.fired("replica.crash") == 1


# -- the server and the provider ----------------------------------------------


def test_drain_endpoint_and_health_flip(params):
    from fei_tpu_torch.agent.providers import TorchLocalProvider
    from fei_tpu_torch.ui.server import ServeAPI

    eng = _make(params)
    api = ServeAPI(TorchLocalProvider(engine=eng), model_name="tiny")
    assert api.handle("GET", "/health", {}, {})[0] == 200
    assert api.handle("POST", "/drain", {"deadline_s": "soon"}, {})[0] == 400
    res = api.handle("POST", "/drain", {"deadline_s": 2}, {})
    assert res[0] == 202 and res[1]["status"] == "draining"
    assert eng.wait_drained(timeout=10)
    code, body, hdrs = api.handle("GET", "/health", {}, {})
    assert code == 503 and body["status"] == "draining"
    assert int(hdrs["Retry-After"]) >= 1
    chat = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4}
    res = api.handle("POST", "/v1/chat/completions", chat, {})
    assert res[0] == 503 and int(res[2]["Retry-After"]) >= 1


def test_provider_and_server_resume_equal_the_uninterrupted_turn(params):
    """A seeded plain turn resumed from its first five tokens (no key: the
    chain is rebuilt by five splits) replays them and continues as the
    uninterrupted turn, through the provider and through the ``"resume"``
    body; a dense engine refuses a resume."""
    from fei_tpu_torch.agent.providers import TorchLocalProvider
    from fei_tpu_torch.ui.server import ServeAPI

    eng = _make(params)
    try:
        prov = TorchLocalProvider(engine=eng, gen_overrides={"ignore_eos": True})
        msgs = [{"role": "user", "content": "resume me"}]
        over = {"temperature": 0.9, "top_k": 40, "seed": 7}
        full = prov.complete(msgs, max_tokens=16, gen_overrides=over)
        ids = eng.tokenizer.apply_chat_template(
            prov._messages_with_system(msgs, None, None), add_generation_prompt=True)
        toks = list(eng.generate_stream(ids, GenerationConfig(max_new_tokens=16,
                                                              ignore_eos=True, **over)))
        resumed = prov.complete(msgs, max_tokens=16, gen_overrides=over,
                                resume={"generated": toks[:5]})
        assert resumed.content == full.content
        api = ServeAPI(prov, model_name="tiny")
        body = {"messages": msgs, "max_tokens": 16, **over, "ignore_eos": True,
                "resume": {"generated": toks[:5]}}
        code, payload = api.handle("POST", "/v1/chat/completions", body, {})[:2]
        assert code == 200 and payload["choices"][0]["message"]["content"] == full.content
        bad = dict(body, resume={"generated": "x"})
        assert api.handle("POST", "/v1/chat/completions", bad, {})[0] == 400
    finally:
        eng.close()
    dense = InferenceEngine.from_config("tiny", params=params, device="cpu",
                                        dtype=torch.float32, max_seq_len=MAX_SEQ, num_layers=2)
    with pytest.raises(Exception, match="paged engine"):
        list(dense.generate_stream(PROMPT, GenerationConfig(**GREEDY),
                                   resume={"generated": [1]}))
