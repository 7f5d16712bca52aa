"""The traced slice's arithmetic on a made-up timeline: busy time as the
union of the device's operations, idle gaps named by the host spans open
then, and the metric readers over it."""

from __future__ import annotations

import pytest

from portbench.trace import Slice, host_activity

MS = 1_000_000  # ns


def made_up() -> Slice:
    sl = Slice(wall_s=0.010)
    sl.kernels = [("paged_attn_seg<128>", 0, 2 * MS), ("gemm", 1 * MS, 3 * MS),
                  ("flash_fwd_wgmma", 5 * MS, 6 * MS), ("gemm", 9 * MS, 10 * MS)]
    sl.host = [("sched.decode_dispatch", 0, 3 * MS), ("sched.admit", 3 * MS + MS // 2, 8 * MS),
               ("engine.prefill", 3 * MS + MS * 3 // 4, 6 * MS)]
    return sl


def test_busy_is_the_union_of_device_operations():
    sl = made_up()
    assert sl.busy() == [(0, 3 * MS), (5 * MS, 6 * MS), (9 * MS, 10 * MS)]
    assert sl.busy_s() == pytest.approx(0.005)
    assert sl.kernel_seconds(["paged_attn_seg", "flash_fwd_"]) == pytest.approx(0.003)


def test_idle_gaps_are_named_by_the_open_spans():
    b = made_up().breakdown()
    assert b["device_ops"][0] == ["gemm", pytest.approx(0.003)]
    gaps = dict((n, v) for n, v in b["idle_gaps"])
    assert gaps == {"sched.admit > engine.prefill": pytest.approx(0.002),
                    "sched.admit": pytest.approx(0.003)}
    assert host_activity([], [5]) == ["host"]


def test_readers_over_a_made_up_run():
    from types import SimpleNamespace

    from portbench import roofline, run, spec

    cell = spec.load_cell("mistral-7b.chat")
    m = cell.model
    req = SimpleNamespace(prompt=[5] * 100, stamps=[1.0, 1.5, 2.0], tokens=[1, 2, 3],
                          due=0.5, error=None, ttft=0.5, seq=SimpleNamespace(prefix_match=[]))
    sl = made_up()
    sl.progress0, sl.progress1 = {id(req): 0}, {id(req): 3}
    view = run.View(m, cell, 64, 0.0, 10.0, {"scheduler.decode_steps": 0.0},
                    {"scheduler.decode_steps": 20.0, "scheduler.decode_slot_steps": 640.0,
                     "scheduler.prefill_tokens": 100.0}, [req], 1.0, sl)
    assert run.load_reader("model.step_ms")(view) == pytest.approx(500.0)
    assert run.load_reader("sched.batch_occupancy")(view) == pytest.approx(0.5)
    assert run.load_reader("cache.prefix_hit_frac")(view) == pytest.approx(0.0)
    assert run.load_reader("output_tok_s")(view) == pytest.approx(0.3)
    flops = roofline.model_flops(m, 102, 3, roofline.span_attn_flops(m, 0, 102))
    assert run.load_reader("mfu.serve")(view) == pytest.approx(100 * flops / (0.010 * 989e12))
    share = run.load_reader("attn_roofline.serve")(view)
    assert 0 < share < 100  # 3 ms of attention kernels for one prefill and two decode tokens
    assert run.load_reader("device_idle.serve")(view) == pytest.approx(0.5)
