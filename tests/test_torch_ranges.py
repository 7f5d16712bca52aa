"""The flight recorder's ranges (fei_tpu_torch/obs/flight.py): captured
only while a torch profiler runs, nested under the right parents, free
when no profiler runs; ``quant.cast`` at both int8 sites; the scheduler's
two always-on counters (``scheduler.dispatch_issue_seconds``,
``scheduler.admit_seconds``); and one clock with the profiler's timeline
as ``portbench/trace.py`` places it (``trace_start_ns()`` + an event's
``time_range``). Tiny paged engines on the CPU."""

from __future__ import annotations

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import json
import time
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fei_tpu_torch.engine.engine import GenerationConfig, InferenceEngine
from fei_tpu_torch.obs import FLIGHT
from fei_tpu_torch.ops.quant import mm, quantize, wcast
from fei_tpu_torch.utils.metrics import METRICS

SHORT = list(range(5, 15))  # a dense admission
LONG = list(range(20, 60))  # over the 16-token chunk: a chunked admission


def _counter(name: str) -> float:
    return METRICS.snapshot()["counters"].get(name, 0.0)


def _gen(n: int = 12) -> GenerationConfig:
    return GenerationConfig(max_new_tokens=n, temperature=0.0, ignore_eos=True)


def _serve(engine, prompts) -> list[list[int]]:
    sched = engine.scheduler
    seqs = [sched.submit(p, _gen()) for p in prompts]
    return [list(sched.drain(s)) for s in seqs]


def _parents(ranges) -> Counter:
    by_id = {r["id"]: r for r in ranges}
    return Counter((r["name"], by_id[r["parent"]]["name"] if r["parent"] else None)
                   for r in ranges)


@pytest.fixture(scope="module")
def moe_int8():
    engine = InferenceEngine.from_config(
        "tiny-moe", paged=True, batch_size=2, page_size=4, num_pages=64,
        device="cpu", dtype=torch.float32, max_seq_len=128, quantize="int8")
    engine.scheduler.prefill_chunk = 16
    yield engine
    engine.close()


@pytest.fixture(scope="module")
def captured(moe_int8):
    """One profiled run (a dense and a chunked admission beside decode),
    its ranges, and the counters and flight records it moved. The
    profiler starts and stops on the loop thread between two iterations
    (``run_ctl``), as the benchmark's traced slice does, and the snapshot
    is taken there."""
    FLIGHT.reset()
    names = ("scheduler.dispatch_issue_seconds", "scheduler.admit_seconds")
    before = {n: _counter(n) for n in names}
    admit_calls: list[float] = []
    sched = moe_int8.scheduler
    inner = sched._admit_ready

    def timed_admit():  # the wall time around each call, from outside
        t0 = time.perf_counter()
        inner()
        admit_calls.append(time.perf_counter() - t0)

    prof = profile(activities=[ProfilerActivity.CPU])

    def stop():
        snap = (FLIGHT.ranges(), list(admit_calls),
                {n: _counter(n) - before[n] for n in names}, FLIGHT.records())
        prof.stop()
        return snap

    sched._admit_ready = timed_admit
    try:
        sched.run_ctl(prof.start)
        streams = _serve(moe_int8, [SHORT, LONG])
        ranges, calls, deltas, records = sched.run_ctl(stop)
    finally:
        del sched._admit_ready
    return streams, ranges, deltas, calls, records


def test_ranges_nest_at_the_layer_boundaries(captured, moe_int8):
    streams, ranges, _, _, _ = captured
    assert all(len(s) == 12 for s in streams)
    got = _parents(ranges)
    for top in ("sched.admit", "sched.decode", "sched.deliver"):
        assert got[(top, None)] >= 1, top
    assert got[("admit.dense", "sched.admit")] == 1
    assert got[("engine.prefill", "admit.dense")] == 1
    assert got[("model.forward", "engine.prefill")] == 1
    assert got[("admit.chunk", "sched.admit")] >= 1
    for child in ("decode.prepare", "decode.sync"):
        assert got[(child, "sched.decode")] == got[("sched.decode", None)]
    steps = got[("decode.sample", "sched.decode")]
    assert steps >= 12 and got[("model.forward", "sched.decode")] == steps
    # every forward: one model.attn and one head; MoE blocks (two in a
    # merged dispatch's layer, the chunk's and the decode rows')
    forwards = sum(v for (n, _), v in got.items() if n == "model.forward")
    layers = moe_int8.cfg.num_layers
    assert got[("model.attn", "model.forward")] == forwards * layers
    assert got[("model.head", "model.forward")] == forwards
    assert got[("model.moe", "model.forward")] >= forwards * layers
    assert not [k for k in got if k[0] == "model.mlp"]  # an MoE model
    assert {p for (n, p) in got if n in ("model.attn", "model.moe", "model.head")} \
        == {"model.forward"}
    for r in ranges:
        assert r["start_ns"] <= r["end_ns"] and r["device_ms"] is None  # no CUDA here


def test_quant_cast_is_recorded_at_both_int8_sites(captured):
    got = _parents(captured[1])
    # quant.mm's int8 branch: the attention linears and the head
    assert got[("quant.cast", "model.attn")] > 0 and got[("quant.cast", "model.head")] > 0
    # ops.quant.wcast: the expert weights of the MoE block
    assert got[("quant.cast", "model.moe")] > 0
    x = torch.randn(3, 8)
    q = quantize(torch.randn(8, 4))
    FLIGHT.follow_profiler(True)
    try:
        mm(x, q)
        wcast(q, torch.float32)
        mm(x, torch.randn(8, 4))  # a plain weight is no cast
        casts = [r for r in FLIGHT.ranges() if r["name"] == "quant.cast"]
    finally:
        FLIGHT.follow_profiler(False)
    assert len(casts) == 2 and all(r["parent"] == 0 for r in casts)


def test_counters_advance_by_issue_and_admission_time(captured):
    _, ranges, deltas, admit_calls, records = captured
    steps = [r for r in records if r["name"] == "dispatch.step"]
    assert steps and deltas["scheduler.dispatch_issue_seconds"] > 0
    assert deltas["scheduler.dispatch_issue_seconds"] == pytest.approx(
        sum(r["issue_s"] for r in steps), abs=1e-6 * len(steps))
    # the counter's interval lies inside the caller's and holds the range
    admits = [r for r in ranges if r["name"] == "sched.admit"]
    assert len(admits) == len(admit_calls)
    inner = sum(r["end_ns"] - r["start_ns"] for r in admits) * 1e-9
    slack = 1e-6 * len(admit_calls)
    # (another test module's engine parked in this process adds a few µs)
    assert inner - slack <= deltas["scheduler.admit_seconds"] <= sum(admit_calls) + slack + 1e-3


def test_admission_time_is_counted_up_to_each_first_token(moe_int8, monkeypatch):
    """A first token leaves with its admission's time so far already in
    ``scheduler.admit_seconds``: a window that opens or closes on that
    token splits the call there."""
    sched = moe_int8.scheduler
    at_first: list[float] = []
    calls: list[float] = []
    deliver, admit = sched._deliver, sched._admit_ready

    def watch_deliver(seq, t, key=None):
        if not seq.generated:
            at_first.append(_counter("scheduler.admit_seconds") - calls[-1])
        return deliver(seq, t, key)

    def watch_admit():
        calls.append(_counter("scheduler.admit_seconds"))
        admit()

    monkeypatch.setattr(sched, "_deliver", watch_deliver)
    monkeypatch.setattr(sched, "_admit_ready", watch_admit)
    _serve(moe_int8, [SHORT])
    assert len(at_first) == 1 and at_first[0] > 0


def test_no_range_without_a_profiler(moe_int8, monkeypatch):
    """With no profiler running nothing opens a range (a call would raise
    here), the capture stays empty, and the counters still move."""
    FLIGHT.reset()
    FLIGHT.follow_profiler(False)

    def refuse(*a, **kw):
        raise AssertionError("a range opened with no profiler running")

    monkeypatch.setattr(FLIGHT, "open", refuse)
    i0, a0 = _counter("scheduler.dispatch_issue_seconds"), _counter("scheduler.admit_seconds")
    assert all(len(s) == 12 for s in _serve(moe_int8, [SHORT, LONG]))
    assert not FLIGHT.capturing and FLIGHT.ranges() == []
    assert _counter("scheduler.dispatch_issue_seconds") > i0
    assert _counter("scheduler.admit_seconds") > a0


def test_capture_starts_and_stops_with_the_profiler(moe_int8):
    FLIGHT.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _serve(moe_int8, [SHORT])
    _serve(moe_int8, [SHORT])  # the loop sees the profiler gone
    first = FLIGHT.ranges()
    assert first and not FLIGHT.capturing
    _serve(moe_int8, [SHORT])
    assert FLIGHT.ranges() == first
    with profile(activities=[ProfilerActivity.CPU]):
        _serve(moe_int8, [SHORT])
        again = FLIGHT.ranges()
    # a new capture starts from an empty list
    assert again and min(r["id"] for r in again) > max(r["id"] for r in first)


def test_device_times_are_read_without_a_sync(monkeypatch):
    """A device-timed range takes an event at each end; ``resolve`` reads
    the pairs the device has passed, oldest first, stops at the first it
    has not (no sync), and reuses the events it read."""
    from types import SimpleNamespace

    from fei_tpu_torch.obs.flight import FlightRecorder

    clock = {"t": 0.0, "done": 0.0}

    class Event:  # a CUDA event on a device whose progress the test sets
        def __init__(self, enable_timing=False):
            self.t = None

        def record(self, stream=None):
            clock["t"] += 1.0
            self.t = clock["t"]

        def elapsed_time(self, end):
            if end.t > clock["done"]:
                raise RuntimeError("Both events must be completed")
            return end.t - self.t

    rec = FlightRecorder()
    rec.follow_profiler(True)
    monkeypatch.setattr(rec, "_cuda", SimpleNamespace(Event=Event))
    moe = rec.open("model.moe", device=True)  # events at 1 and 4
    cast = rec.open("quant.cast", device=True)  # 2 and 3
    rec.close(cast)
    rec.close(moe)
    later = rec.open("quant.cast", device=True)  # 5 and 6
    rec.close(later)
    host = rec.open("model.attn")
    rec.close(host)
    clock["done"] = 4.0  # the device has passed the first dispatch only
    rec.resolve()
    got = {r["id"]: r["device_ms"] for r in rec.ranges()}
    assert got == {moe[0]: 3.0, cast[0]: 1.0, later[0]: None, host[0]: None}
    assert len(rec._events) == 4 and len(rec._pending) == 1
    clock["done"] = 6.0
    assert {r["id"]: r["device_ms"] for r in rec.ranges()}[later[0]] == 1.0


def test_the_capture_is_bounded_and_counts_what_it_drops(monkeypatch):
    FLIGHT.reset()
    FLIGHT.follow_profiler(True)
    monkeypatch.setattr(FLIGHT, "_capture_max", 3)
    try:
        for _ in range(5):
            FLIGHT.close(FLIGHT.open("test.range"))
        assert len(FLIGHT.ranges()) == 3 and FLIGHT.ranges_dropped == 2
        assert FLIGHT.chrome_trace()["rangesDropped"] == 2
    finally:
        FLIGHT.follow_profiler(False)
        FLIGHT.reset()


def test_one_clock_with_the_profilers_timeline():
    """A torch op run inside a range lies inside the range's [start, end]
    when the profiler's event is placed as portbench/trace.py places
    kernels; instants, dispatches and the timeline export are on the same
    wall clock."""
    import torch.autograd.profiler as torch_profiler

    FLIGHT.reset()
    a = torch.randn(192, 192)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        FLIGHT.follow_profiler(torch_profiler._is_profiler_enabled)  # as the loop does
        t0 = time.time()
        r = FLIGHT.open("test.range")
        torch.mm(a, a)
        FLIGHT.close(r)
        FLIGHT.event("test.instant")
        t1 = time.time()
        FLIGHT.dispatch("test.dispatch", t0, t1, t1)
    FLIGHT.follow_profiler(torch_profiler._is_profiler_enabled)
    assert not FLIGHT.capturing
    (rng,) = [x for x in FLIGHT.ranges() if x["name"] == "test.range"]
    origin = prof.profiler.kineto_results.trace_start_ns()
    mms = [(origin + int(e.time_range.start * 1000), origin + int(e.time_range.end * 1000))
           for e in prof.events() if e.name == "aten::mm"]
    assert len(mms) == 1
    assert rng["start_ns"] <= mms[0][0] <= mms[0][1] <= rng["end_ns"]
    inst = next(x for x in FLIGHT.records() if x["name"] == "test.instant")
    assert t0 <= inst["ts"] <= t1
    events = json.loads(json.dumps(FLIGHT.chrome_trace()))["traceEvents"]
    exported = next(e for e in events if e["name"] == "test.range")
    assert exported["ts"] == pytest.approx(rng["start_ns"] / 1e3)
    assert exported["dur"] == pytest.approx((rng["end_ns"] - rng["start_ns"]) / 1e3)
    issue = next(e for e in events if e["name"] == "test.dispatch.issue")
    assert issue["ts"] <= exported["ts"] and exported["ts"] + exported["dur"] <= issue["ts"] + issue["dur"]
    FLIGHT.reset()


def test_profile_route_writes_the_ranges_on_the_traces_timeline(tmp_path, monkeypatch):
    """``POST /debug/profile`` captures ranges for its seconds and writes
    them beside trace.json, after the same ``baseTimeNanoseconds``: an op
    run inside a range during the capture lies inside it in both files.
    (The op runs in the capture's own wait, on the thread that started the
    profiler, which records that thread's CPU ops.)"""
    from fei_tpu_torch.ui import server

    seen = {}

    class Clock:  # the server's time module; the capture's wait does the work
        def __getattr__(self, name):
            return getattr(time, name)

        def sleep(self, seconds):
            seen["capturing"] = FLIGHT.capturing
            a = torch.randn(160, 160)
            r = FLIGHT.open("test.range")
            torch.mm(a, a)
            FLIGHT.close(r)

    FLIGHT.reset()
    monkeypatch.setattr(server, "time", Clock())
    status, out = server.ServeAPI(provider=None).handle(
        "POST", "/debug/profile", {"seconds": 0.5, "trace_dir": str(tmp_path)}, {})[:2]
    assert status == 200 and seen == {"capturing": True} and not FLIGHT.capturing
    trace = json.loads((tmp_path / "trace.json").read_text())
    ranges = json.loads((tmp_path / "ranges.json").read_text())
    assert ranges["baseTimeNanoseconds"] == trace["baseTimeNanoseconds"]
    assert ranges["rangesDropped"] == 0
    (rng,) = [e for e in ranges["traceEvents"] if e["name"] == "test.range"]
    (op,) = [e for e in trace["traceEvents"] if e.get("name") == "aten::mm"]
    assert rng["ts"] <= op["ts"] and op["ts"] + op["dur"] <= rng["ts"] + rng["dur"]
    FLIGHT.reset()
