"""The traced slice: a torch.profiler trace of the device over a few
seconds of steady load, read into the device's busy time, kernel time by
name and the idle gaps, each gap named by what the host was doing then.

Only device activity is traced: recording every host operator of this
eager, launch-bound program slowed its loop several times over on the
H100 and made the slice unlike the window. What the host was doing comes
from spans of the benchmark's own instead: during a traced run the
scheduler's admission and decode dispatch and the engine's prefill
(``HOST_SPANS``) stamp their start and end on the wall clock, the clock
the profiler's timeline is kept on.

The profiler starts and stops on the scheduler's loop thread between two
dispatches (``run_ctl``; a profiler torn down while another thread
launches kernels has crashed the process on the H100), so the slice holds
whole loop iterations, and the requests' progress read at its two ends is
exact.
"""

from __future__ import annotations

import bisect
import importlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

TOP = 10
# (module, class, method) -> span name; a method a later program drops is skipped
HOST_SPANS = {
    ("fei_tpu_torch.engine.scheduler", "PagedScheduler", "_admit_ready"): "sched.admit",
    ("fei_tpu_torch.engine.scheduler", "PagedScheduler", "_dispatch_steps"): "sched.decode_dispatch",
    ("fei_tpu_torch.engine.engine", "InferenceEngine", "prefill"): "engine.prefill",
}


class HostSpans:
    """Wraps the methods in ``HOST_SPANS``; while ``on``, each call's
    (name, start ns, end ns) on the wall clock is kept."""

    def __init__(self):
        self.on = False
        self.spans: list[tuple[str, int, int]] = []
        for (mod, cls, meth), name in HOST_SPANS.items():
            owner = getattr(importlib.import_module(mod), cls, None)
            fn = getattr(owner, meth, None)
            if fn is not None:
                setattr(owner, meth, self._wrap(fn, name))

    def _wrap(self, fn, name):
        def wrapped(*a, **kw):
            if not self.on:
                return fn(*a, **kw)
            t0 = time.time_ns()
            try:
                return fn(*a, **kw)
            finally:
                self.spans.append((name, t0, time.time_ns()))
        return wrapped


@dataclass
class Slice:
    t0: float = 0.0
    t1: float = 0.0
    counters0: dict = field(default_factory=dict)
    counters1: dict = field(default_factory=dict)
    progress0: dict = field(default_factory=dict)  # id(record) -> tokens generated
    progress1: dict = field(default_factory=dict)
    kernels: list = field(default_factory=list)  # (name, start ns, end ns), wall clock
    host: list = field(default_factory=list)  # (name, start ns, end ns), wall clock
    wall_s: float = 0.0

    def kernel_seconds(self, patterns) -> float:
        return sum(e - s for n, s, e in self.kernels if any(p in n for p in patterns)) * 1e-9

    def busy(self) -> list[tuple[int, int]]:
        """The union of the device's operation intervals."""
        out: list[list[int]] = []
        for s, e in sorted((s, e) for _, s, e in self.kernels):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-9

    def breakdown(self) -> dict:
        by_name: dict[str, float] = defaultdict(float)
        for n, s, e in self.kernels:
            by_name[n] += (e - s) * 1e-9
        busy = self.busy()
        gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
        idle: dict[str, float] = defaultdict(float)
        for (s, e), name in zip(gaps, host_activity(self.host, [(s + e) // 2 for s, e in gaps])):
            idle[name] += (e - s) * 1e-9
        top = lambda d: [[n, v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_name), "idle_gaps": top(idle)}


def host_activity(host: list, times: list[int]) -> list[str]:
    """For each time, the spans open then, outermost first ("host" where
    none is: the loop between spans, the sampler, token delivery)."""
    spans = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in spans]
    out = []
    for t in times:
        i = bisect.bisect_right(starts, t)
        # spans nest: the open ones are among the last few that started
        chain = [h[0] for h in spans[max(0, i - 64):i] if h[2] >= t]
        out.append(" > ".join(chain) if chain else "host")
    return out


def profile_slice(seconds: float, sched, spans: HostSpans, read_counters, read_progress) -> Slice:
    """Trace ``seconds`` of the running load, starting and stopping on the
    scheduler's loop thread (``run_ctl``)."""
    sl = Slice()
    prof = profile(activities=[ProfilerActivity.CUDA])

    def start():
        torch.cuda.synchronize()
        prof.start()  # the profiler's own start-up (seconds) falls before the slice
        sl.counters0, sl.progress0 = read_counters(), read_progress()
        spans.on = True
        sl.t0 = time.perf_counter()

    def stop():
        torch.cuda.synchronize()
        sl.t1 = time.perf_counter()
        spans.on = False
        sl.counters1, sl.progress1 = read_counters(), read_progress()
        prof.stop()

    sched.run_ctl(start)
    time.sleep(seconds)
    sched.run_ctl(stop, timeout_s=600)
    sl.wall_s = sl.t1 - sl.t0
    origin = prof.profiler.kineto_results.trace_start_ns()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            sl.kernels.append((e.name, origin + int(e.time_range.start * 1000),
                               origin + int(e.time_range.end * 1000)))
    sl.host = list(spans.spans)
    return sl
