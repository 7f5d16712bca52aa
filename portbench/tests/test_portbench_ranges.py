"""The readers of the program's ranges and counters on a made-up run: the
decode step's issue and admission time from the window's counters, the
MoE block's and the int8 casts' device time inside the decode dispatches
of the traced slice, and the share of the slice's idle time inside the
model's forward. A program without them reads None."""

from __future__ import annotations

import pytest

from portbench import ranges, run, spec
from portbench.trace import Slice

MS = 1_000_000  # ns


def rng(i, name, start, end, parent=0, device_ms=None):
    return {"id": i, "name": name, "start_ns": start * MS, "end_ns": end * MS,
            "parent": parent, "tid": 1, "tags": {}, "device_ms": device_ms}


def made_up_ranges() -> list[dict]:
    return [
        rng(1, "sched.admit", 0, 4),
        rng(2, "admit.dense", 0, 4, 1),
        rng(3, "engine.prefill", 0, 4, 2),
        rng(4, "model.forward", 0, 4, 3),
        rng(5, "model.moe", 1, 3, 4, device_ms=3.0),  # a prefill's: not the decode step's
        rng(6, "sched.decode", 5, 20),
        rng(7, "decode.prepare", 5, 6, 6),
        rng(8, "model.forward", 6, 13, 6),
        rng(9, "model.attn", 6, 9, 8),
        rng(10, "quant.cast", 7, 8, 9, device_ms=0.5),
        rng(11, "model.moe", 9, 12, 8, device_ms=2.0),
        rng(12, "quant.cast", 10, 11, 11, device_ms=1.5),
        rng(13, "decode.sample", 13, 14, 6),
        rng(14, "decode.sync", 14, 20, 6),
    ]


def made_up_view(counters=True) -> run.View:
    cell = spec.load_cell("mixtral-8x7b-int8.chat")
    sl = Slice(wall_s=0.020)
    # busy [0, 2), [3, 7), [10, 11), [17, 20): gaps [2, 3) in a prefill's
    # forward, [7, 10) in the decode step's, [11, 17) past it (midpoint 14)
    sl.kernels = [("gemm", 0, 2 * MS), ("copy", 3 * MS, 7 * MS),
                  ("gemm", 10 * MS, 11 * MS), ("paged_attn_seg", 17 * MS, 20 * MS)]
    sl.counters0 = {"scheduler.decode_steps": 10.0}
    sl.counters1 = {"scheduler.decode_steps": 12.0}
    before = {"scheduler.decode_steps": 100.0}
    after = {"scheduler.decode_steps": 120.0}
    if counters:
        before.update({"scheduler.dispatch_issue_seconds": 1.0, "scheduler.admit_seconds": 2.0})
        after.update({"scheduler.dispatch_issue_seconds": 2.0, "scheduler.admit_seconds": 2.5})
    return run.View(cell.model, cell, 64, 0.0, 10.0, before, after, [], 1.0, sl)


def read(name, view):
    return run.load_reader(name)(view)


def test_the_readers_over_made_up_ranges(monkeypatch):
    monkeypatch.setattr(ranges, "captured", made_up_ranges)
    view = made_up_view()
    assert read("sched.decode_issue_ms", view) == pytest.approx(50.0)  # 1 s over 20 steps
    assert read("sched.admit_ms", view) == pytest.approx(25.0)
    # the decode dispatch's MoE block and casts, over the slice's 2 steps
    assert read("model.moe_ms", view) == pytest.approx(1.0)
    assert read("quant.cast_ms", view) == pytest.approx(1.0)
    # 4 of the 10 idle ms have their midpoint in a forward ([2, 3), [7, 10))
    assert read("device_idle.in_forward", view) == pytest.approx(0.4)


def test_ranges_under_an_ancestor():
    rs = made_up_ranges()
    assert [r["id"] for r in ranges.under(rs, "model.moe", "sched.decode")] == [11]
    assert [r["id"] for r in ranges.under(rs, "quant.cast", "model.moe")] == [12]
    assert ranges.under(rs, "model.moe", "sched.deliver") == []


def test_a_missing_device_time_reads_none(monkeypatch):
    rs = made_up_ranges()
    rs[11]["device_ms"] = None
    monkeypatch.setattr(ranges, "captured", lambda: rs)
    view = made_up_view()
    assert read("quant.cast_ms", view) is None
    assert read("model.moe_ms", view) == pytest.approx(1.0)


def test_a_program_without_ranges_or_counters_reads_none(monkeypatch):
    """The parent of the program that added them: no ``FLIGHT.ranges``, no
    counters. Every reader gives None and none raises."""
    monkeypatch.setattr(ranges, "captured", lambda: None)
    view = made_up_view(counters=False)
    for name in ("sched.decode_issue_ms", "sched.admit_ms", "model.moe_ms",
                 "quant.cast_ms", "device_idle.in_forward"):
        assert read(name, view) is None, name
    view.slice = None
    monkeypatch.setattr(ranges, "captured", made_up_ranges)
    for name in ("model.moe_ms", "quant.cast_ms", "device_idle.in_forward"):
        assert read(name, view) is None, name


def test_captured_reads_the_programs_recorder(monkeypatch):
    from fei_tpu_torch.obs import flight

    class Old:  # a recorder without ranges
        pass

    monkeypatch.setattr(flight, "FLIGHT", Old())
    assert ranges.captured() is None
    rec = flight.FlightRecorder()
    rec.follow_profiler(True)
    rec.close(rec.open("model.forward"))
    rec.follow_profiler(False)
    monkeypatch.setattr(flight, "FLIGHT", rec)
    assert [r["name"] for r in ranges.captured()] == ["model.forward"]
