"""The port's flight recorder, compile observer and cost model against
fei_tpu's.

- The ring, its spill file, the Chrome-trace export and ``for_rid`` give
  the reference's records for the same events.
- The compile observer counts and times first builds as the reference's
  does; in the port it watches the kernel libraries' loads
  (ops/kernels/build.py) and each engine's grammar-table uploads: warm
  traffic reads zero new builds, and a forced reload reads one recompile
  (the counterpart of the reference's dropped jit cache).
- Dispatch accounting: one ``dispatch.decode`` record per
  ``engine.decode_dispatches`` on the dense paths, one ``dispatch.step``
  per batched dispatch on the paged scheduler; a preempt → resume round
  trip leaves rid-tagged instants and trace phases; the roofline gauges
  are live; ``/debug/timeline`` and ``/v1/traces/<id>`` serve them.
- The cost model's bytes and FLOPs equal the reference's on the same tiny
  config; only the bandwidth default differs (the H100's 3350 GB/s).
"""

from __future__ import annotations

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fei_tpu.obs as jax_obs
import fei_tpu.obs.costmodel as jax_cost
import fei_tpu_torch.obs as torch_obs
from fei_tpu.engine.engine import InferenceEngine as JaxEngine
from fei_tpu_torch.engine.engine import GenerationConfig, InferenceEngine
from fei_tpu_torch.models.convert import params_from_jax
from fei_tpu_torch.obs import FLIGHT, CompileObserver
from fei_tpu_torch.obs import costmodel
from fei_tpu_torch.ops.kernels import build
from fei_tpu_torch.utils.metrics import METRICS

PROMPT = list(range(11, 29))
PROMPTS = [list(range(11 + i, 29 + i)) for i in range(4)]
PKGS = {"fei_tpu": jax_obs, "fei_tpu_torch": torch_obs}


def _counter(name: str) -> float:
    return METRICS.snapshot()["counters"].get(name, 0)


def _gauge(name: str) -> float:
    return METRICS.snapshot()["gauges"].get(name, 0)


def _gen(**kw) -> GenerationConfig:
    kw.setdefault("max_new_tokens", 24)
    kw.setdefault("temperature", 0.0)
    kw.setdefault("ignore_eos", True)
    return GenerationConfig(**kw)


def _both(fn):
    got = {label: fn(obs) for label, obs in PKGS.items()}
    assert got["fei_tpu_torch"] == got["fei_tpu"]
    return got["fei_tpu_torch"]


def _script(r) -> None:
    r.event("preempt", rid="req-1", slot=0, generated=7)
    r.dispatch("dispatch.decode", 1.0, 1.5, 2.25, rid="req-1", mesh="ms1", slot=0, n_steps=1)
    r.dispatch("dispatch.step", 3.0, 3.1, 3.6, rids=["req-1", "req-2"], mesh="tp2", n_steps=4)
    r.dispatch("dispatch.decode", 2.0, 1.0, 0.5)  # the clock went backwards


def _no_ts(records: list[dict]) -> list[dict]:
    return [{k: v for k, v in r.items() if not (k == "ts" and r["kind"] == "instant")}
            for r in records]


# -- the ring, its spill, the export -----------------------------------------


def test_ring_bounds_and_env_equal_the_reference(monkeypatch):
    def run(obs):
        r = obs.FlightRecorder(maxlen=16)
        for i in range(100):
            r.event("turbo_arm", depth=i)
        kept = [rec["tags"]["depth"] for rec in r.records()]
        floor = obs.FlightRecorder(maxlen=1)._ring.maxlen
        monkeypatch.setenv("FEI_TPU_FLIGHT_RING", "32")
        env = obs.FlightRecorder()._ring.maxlen
        monkeypatch.setenv("FEI_TPU_FLIGHT_RING", "bogus")
        bogus = obs.FlightRecorder()._ring.maxlen
        r.reset()
        return [len(r), kept, floor, env, bogus]

    out = _both(run)
    assert out[1] == list(range(84, 100)) and out[2:] == [16, 32, 4096]


def test_spill_file_equals_the_reference(tmp_path, monkeypatch):
    def run(obs):
        path = tmp_path / f"{obs.__name__}.jsonl"
        monkeypatch.setenv("FEI_TPU_FLIGHT_FILE", str(path))
        r = obs.FlightRecorder(maxlen=64)
        _script(r)
        rows = [json.loads(x) for x in path.read_text().splitlines()]
        monkeypatch.setenv("FEI_TPU_FLIGHT_FILE", str(tmp_path / "missing" / "x.jsonl"))
        r.event("fault", point="kv.fetch")  # an unwritable spill is swallowed
        return _no_ts(rows)

    assert len(_both(run)) == 4


def test_chrome_trace_and_for_rid_equal_the_reference():
    def run(obs):
        r = obs.FlightRecorder(maxlen=64)
        _script(r)
        trace = json.loads(json.dumps(r.chrome_trace()))
        events = [{k: v for k, v in e.items() if not (k == "ts" and e["ph"] == "i")}
                  for e in trace["traceEvents"]]
        return [trace["displayTimeUnit"], events, _no_ts(r.for_rid("req-1")),
                _no_ts(r.for_rid("req-2")), r.for_rid("req-nope"), dict(r.counts())]

    unit, events, one, two, none, counts = _both(run)
    assert unit == "ms" and len(events) == 7 and none == []
    assert all(e["dur"] >= 0 for e in events if e["ph"] == "X")
    iss = next(e for e in events if e["name"] == "dispatch.decode.issue")
    assert iss["ts"] == pytest.approx(1.0e6) and iss["dur"] == pytest.approx(0.5e6)
    assert len(one) == 3 and [r["name"] for r in two] == ["dispatch.step"]


# -- the compile observer ----------------------------------------------------


def test_compile_observer_equals_the_reference():
    def run(obs):
        m = obs.METRICS
        obs.FLIGHT.reset()
        c0 = m.snapshot()["counters"]
        before = (c0.get("engine.compiles", 0), c0.get("engine.recompiles", 0))
        co = obs.CompileObserver()
        f = co.wrap("test.family", (1, 128), lambda x: x + 1)
        g = co.wrap("test.family", (1, 256), lambda x: x + 2)
        h = co.wrap("test.family", (1, 128), lambda x: x * 2)  # the cache was dropped
        vals = [f(1), f(2), g(1), h(3)]
        c1 = m.snapshot()["counters"]
        builds = [r for r in obs.FLIGHT.records() if r["name"] == "compile"]
        return [c1["engine.compiles"] - before[0], c1["engine.recompiles"] - before[1],
                vals, dict(obs.FLIGHT.counts()),
                [(r["tags"]["family"], r["tags"]["key"]) for r in builds]]

    out = _both(run)
    assert out[:3] == [2, 1, [2, 3, 3, 6]]


def test_kernel_loads_go_through_the_observer(monkeypatch):
    """A kernel library's first load counts as a build, a second load in
    the process does not load again, and a load after the handle was
    dropped reads one recompile (the counterpart of the reference's dropped
    jit cache; on the CPU the build itself is stubbed: there is no nvcc)."""
    loads = []
    monkeypatch.setattr(build, "_build_and_open", lambda name: loads.append(name) or name)
    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "COMPILES", CompileObserver())
    c0, r0 = _counter("engine.compiles"), _counter("engine.recompiles")
    assert build.load("paged_attention") == build.load("paged_attention") == "paged_attention"
    build.load("int4_matmul")
    assert (_counter("engine.compiles") - c0, _counter("engine.recompiles") - r0) == (2, 0)
    build._LOADED.pop("paged_attention")
    build.load("paged_attention")
    assert (_counter("engine.compiles") - c0, _counter("engine.recompiles") - r0) == (2, 1)
    assert loads == ["paged_attention", "int4_matmul", "paged_attention"]


@pytest.fixture(scope="module")
def engine():
    jeng = JaxEngine.from_config("tiny", dtype=jnp.float32, max_seq_len=128)
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params))
    return jeng, InferenceEngine.from_config("tiny", params=params, device="cpu",
                                             dtype=torch.float32, max_seq_len=128)


def test_grammar_uploads_build_once_and_a_forced_reload_is_a_recompile(engine):
    """The engine's observer sees each grammar table's first upload; warm
    constrained turns build nothing, and dropping the memo re-uploads the
    same tables: one recompile and a flight event."""
    from fei_tpu_torch.engine.grammar import compile_tool_call_grammar

    eng = engine[1]
    schema = {"name": "t", "input_schema": {"type": "object", "properties": {
        "x": {"type": "integer"}}, "required": ["x"]}}
    gr = compile_tool_call_grammar(schema, eng.tokenizer)
    c0, r0 = _counter("engine.compiles"), _counter("engine.recompiles")
    eng.generate_constrained(PROMPT, gr, _gen(max_new_tokens=12))
    assert (_counter("engine.compiles") - c0, _counter("engine.recompiles") - r0) == (1, 0)
    for _ in range(2):
        eng.generate_constrained(PROMPT, gr, _gen(max_new_tokens=12))
    assert (_counter("engine.compiles") - c0, _counter("engine.recompiles") - r0) == (1, 0)
    FLIGHT.reset()
    gr._dev_tables.clear()
    eng.generate_constrained(PROMPT, gr, _gen(max_new_tokens=12))
    assert _counter("engine.recompiles") - r0 == 1 and FLIGHT.counts()["recompile"] == 1


# -- dense dispatch attribution ----------------------------------------------


@pytest.mark.parametrize("chunk", [1, 0], ids=["per_token", "fused"])
def test_dense_dispatch_records_match_the_counter(engine, chunk):
    eng = engine[1]
    FLIGHT.reset()
    d0 = _counter("engine.decode_dispatches")
    toks = list(eng.generate_stream(PROMPT, _gen(max_new_tokens=12, chunk=chunk)))
    assert len(toks) == 12
    counts = FLIGHT.counts()
    assert counts["dispatch.decode"] == _counter("engine.decode_dispatches") - d0 > 0
    assert counts["dispatch.prefill"] == 1
    prefill = next(r for r in FLIGHT.records() if r["name"] == "dispatch.prefill")
    assert prefill["tags"] == {"mesh": "ms1", "tokens": len(PROMPT)}
    assert prefill["issue_s"] >= 0 and prefill["sync_s"] >= 0
    if chunk == 0:  # the fused chunks' sync is pipelined into the next read
        recs = [r for r in FLIGHT.records() if r["name"] == "dispatch.decode"]
        assert all(r["tags"]["pipelined"] and r["sync_s"] == 0 for r in recs)
        assert _gauge("roofline.frac") > 0


def test_dense_decode_is_unchanged_by_the_recorder(engine):
    """The records add no sync and change no token: the port's dense
    stream still equals the reference's (greedy, per token and fused)."""
    jeng, eng = engine
    from fei_tpu.engine.engine import GenerationConfig as JaxGen

    want = list(jeng.generate_stream(PROMPT, JaxGen(max_new_tokens=16, ignore_eos=True)))
    for chunk in (1, 0):
        assert list(eng.generate_stream(PROMPT, _gen(max_new_tokens=16, chunk=chunk))) == want


# -- the paged scheduler -----------------------------------------------------


@pytest.fixture(scope="module")
def flown():
    """One tight-pool concurrent run (two worst-case reservations cannot
    share 13 pages, so it preempts by itself), with counter deltas."""
    engine = InferenceEngine.from_config(
        "tiny", paged=True, batch_size=2, page_size=4, num_pages=14,
        prefix_cache=True, device="cpu", dtype=torch.float32, max_seq_len=128)
    sched = engine.scheduler
    FLIGHT.reset()
    names = ("decode_steps", "multi_steps", "multi_tokens", "preemptions")
    before = {n: _counter(f"scheduler.{n}") for n in names}
    seqs = [sched.submit(p, _gen()) for p in PROMPTS]
    results: list = [None] * len(seqs)

    def go(i):
        results[i] = list(sched.drain(seqs[i]))

    ts = [threading.Thread(target=go, args=(i,)) for i in range(len(seqs))]
    [t.start() for t in ts]
    [t.join(timeout=300) for t in ts]
    assert all(r for r in results), "a stream never finished"
    deltas = {n: _counter(f"scheduler.{n}") - before[n] for n in names}
    records = FLIGHT.records()
    timeline = FLIGHT.chrome_trace()
    yield engine, seqs, deltas, records, timeline
    engine.close()


def test_dispatch_step_records_match_the_counters(flown):
    _, _, d, records, _ = flown
    # a multi-step dispatch adds N to decode_steps but is ONE dispatch
    expected = (d["decode_steps"] - d["multi_tokens"]) + d["multi_steps"]
    steps = [r for r in records if r["name"] == "dispatch.step"]
    assert expected > 0 and len(steps) == expected
    assert all(r["tags"]["mesh"] == "ms1" and r["tags"]["rids"] for r in steps)


def test_preempt_resume_round_trip_is_on_the_timeline(flown):
    _, seqs, d, records, _ = flown
    names = [r["name"] for r in records]
    assert d["preemptions"] >= 1 and names.count("preempt") == d["preemptions"]
    assert names.count("resume") >= 1 and names.count("admit") >= len(PROMPTS)
    rid = next(r for r in records if r["name"] == "preempt")["tags"]["rid"]
    mine = [r["name"] for r in records
            if r["tags"].get("rid") == rid or rid in (r["tags"].get("rids") or ())]
    assert {"preempt", "resume", "admit", "dispatch.step"} <= set(mine)
    victim = next(s for s in seqs if s.rid == rid)
    phases = [p for p, _ in victim.trace.events]
    assert phases[0] == "queued" and phases[-1] == "completed"
    assert "preempted" in phases and "resumed" in phases
    assert phases.index("first_token") < phases.index("preempted")
    ts = [t for _, t in victim.trace.events]
    assert ts == sorted(ts)


def test_roofline_gauges_are_live(flown):
    assert 0 < _gauge("roofline.frac") < 1.05 and _gauge("roofline.tok_s_per_chip") > 0


def test_timeline_and_traces_endpoints(flown):
    from fei_tpu_torch.ui.server import ServeAPI

    _, seqs, _, _, timeline = flown
    events = json.loads(json.dumps(timeline))["traceEvents"]
    issues = [e for e in events if e["ph"] == "X" and e["name"].endswith(".issue")]
    syncs = [e for e in events if e["ph"] == "X" and e["name"].endswith(".sync")]
    assert issues and len(issues) == len(syncs)
    assert {"dispatch.step.issue", "dispatch.prefill_chunk.issue"} & {e["name"] for e in issues}
    api = ServeAPI(provider=None)
    status, payload = api.handle("GET", f"/v1/traces/{seqs[0].rid}", {}, {})[:2]
    assert status == 200 and payload["id"] == seqs[0].rid and payload["status"] == "completed"
    assert api.handle("GET", "/v1/traces/req-nope", {}, {})[0] == 404
    status, listing = api.handle("GET", "/v1/traces?limit=0", {}, {})[:2]
    assert status == 200 and len(listing["data"]) == 1  # clamped to 1..1000
    assert api.handle("GET", "/v1/traces?limit=x", {}, {})[0] == 400
    status, served = api.handle("GET", "/debug/timeline", {}, {})[:2]
    assert status == 200
    # one clock: the timeline is on the wall clock of the request traces,
    # so each dispatch that served a request lies inside its trace
    stamps = dict(seqs[0].trace.events)
    mine = [e for e in json.loads(json.dumps(served))["traceEvents"]
            if e["ph"] == "X" and seqs[0].rid in (e["args"].get("rids") or ())]
    assert mine and all(stamps["queued"] * 1e6 <= e["ts"] <= stamps["completed"] * 1e6
                        for e in mine)


def test_profile_route_validates_and_captures(tmp_path):
    from fei_tpu_torch.ui.server import ServeAPI

    api = ServeAPI(provider=None)
    assert api.handle("POST", "/debug/profile", {"seconds": 0}, {})[0] == 400
    assert api.handle("POST", "/debug/profile", {"seconds": 61}, {})[0] == 400
    assert api.handle("POST", "/debug/profile", {"seconds": "x"}, {})[0] == 400
    api._profile_lock.acquire()
    try:
        assert api.handle("POST", "/debug/profile", {"seconds": 1}, {})[0] == 409
    finally:
        api._profile_lock.release()
    status, out = api.handle("POST", "/debug/profile",
                             {"seconds": 0.05, "trace_dir": str(tmp_path)}, {})[:2]
    assert status == 200 and out == {"object": "profile", "trace_dir": str(tmp_path),
                                     "seconds": 0.05}
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert "traceEvents" in trace
    # the flight recorder's ranges of the capture, on the trace's timeline
    ranges = json.loads((tmp_path / "ranges.json").read_text())
    assert ranges["baseTimeNanoseconds"] == trace["baseTimeNanoseconds"]
    assert isinstance(ranges["traceEvents"], list) and ranges["rangesDropped"] == 0



def test_profile_gate_waits_for_and_holds_back_scheduler_work():
    """The profiler starts and stops under ``DEVICE_GATE.quiesce()``: it
    waits for a scheduler iteration in flight, and one that comes while it
    waits or runs starts only after it."""
    import time

    from fei_tpu_torch.engine.scheduler import DeviceGate

    gate, order = DeviceGate(), []
    inside, release = threading.Event(), threading.Event()

    def step(name, hold=None):
        with gate.shared():
            order.append(name)
            if hold is not None:
                inside.set()
                assert hold.wait(5)

    def stop_profiler():
        with gate.quiesce():
            order.append("quiesce")

    first = threading.Thread(target=step, args=("a", release))
    first.start()
    assert inside.wait(5)
    q = threading.Thread(target=stop_profiler)
    q.start()
    deadline = time.time() + 5
    while not gate._closed and time.time() < deadline:
        time.sleep(0.001)
    later = threading.Thread(target=step, args=("b",))
    later.start()
    time.sleep(0.05)
    assert order == ["a"]  # the quiesce waits for a; b waits for the quiesce
    release.set()
    for t in (first, q, later):
        t.join(5)
    assert order == ["a", "quiesce", "b"]

# -- the cost model against the reference's ----------------------------------


def test_costmodel_bytes_and_flops_equal_the_reference(engine):
    """The same tiny fp32 config in both packages: per-token bytes, K/V row
    bytes, dispatch and merged-dispatch bytes, FLOPs per token."""
    jeng, eng = engine

    def run(cm, e):
        return [cm.kv_row_bytes(e), cm.decode_stream_bytes(e, 32),
                cm.dispatch_bytes(e, 4, 100, 2), cm.dispatch_bytes(e, 0, 0, 1),
                cm.ragged_dispatch_bytes(e, 8, 300, 3, 64, 128),
                cm.decode_flops_per_token(e)]

    ours, theirs = run(costmodel, eng), run(jax_cost, jeng)
    assert ours == theirs
    assert ours[0] == 512 and ours[1]["kv_read"] == 512 * 32
    assert ours[1]["weights"] == pytest.approx(
        (eng.cfg.num_params() - eng.cfg.vocab_size * eng.cfg.hidden_size) * 4, rel=0.05)


def test_roofline_fraction_and_chips_equal_the_reference(monkeypatch):
    def run(cm):
        out = [cm.roofline_fraction(int(50e9), 1.0), cm.roofline_fraction(int(50e9), 1.0, 2),
               cm.roofline_fraction(int(50e9), 0.0)]
        return out + [cm.chips_for_tag(t) for t in
                      (None, "ms1", "off", "tp2", "tp2dp2", "dp=2,tp=4", "??junk??")]

    monkeypatch.setenv("FEI_TPU_HBM_GBPS", "100")
    assert run(costmodel) == run(jax_cost) == [0.5, 0.25, 0.0, 1, 1, 1, 2, 4, 8, 1]
    # only the default ceiling differs: the H100's, not the v5e's
    monkeypatch.setenv("FEI_TPU_HBM_GBPS", "bogus")
    assert costmodel.hbm_gbps() == costmodel.H100_HBM_GBPS == 3350.0
    assert jax_cost.hbm_gbps() == jax_cost.V5E_HBM_GBPS
    monkeypatch.delenv("FEI_TPU_HBM_GBPS")
    assert costmodel.roofline_fraction(int(3350e9), 1.0) == pytest.approx(1.0)


def test_kv_transfer_accounting_equals_the_reference():
    def run(obs):
        from importlib import import_module

        cm = import_module(obs.__name__ + ".costmodel")
        m = obs.METRICS
        b0 = m.snapshot()["counters"].get("kv.bytes_spilled", 0)
        cm.account_kv_transfer("spilled", 2_000_000, 0.001)
        cm.account_kv_transfer("sideways", 1, 1.0)  # not a direction: ignored
        cm.account_kv_transfer("fetched", 5, 0.0)  # no time: counted, no gauge
        snap = m.snapshot()
        return [snap["counters"]["kv.bytes_spilled"] - b0, snap["gauges"]["kv.spilled_gbps"]]

    assert _both(run) == [2_000_000, 2.0]
