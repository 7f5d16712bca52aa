"""Structured metrics: counters, gauges, span timers, and histograms
(counterpart of fei_tpu/obs/metrics.py).

Cheap counters and gauges, wall-clock span timing with per-phase
aggregation, and fixed-bucket log-spaced latency histograms with
p50/p95/p99 summaries. Every span also feeds a ``<name>_seconds``
histogram, so TTFT, per-decode-step latency, prefill time and tool-call
duration get percentile summaries for free.

Exposition lives in fei_tpu_torch/obs/prom.py (Prometheus text format,
served by ``GET /metrics`` on ui/server.py); every name a call site uses
must be declared in fei_tpu_torch/obs/registry.py (a tier-1 test scans
the package). fei_tpu_torch/utils/metrics.py re-exports this module.

The reference's ``span(..., jax_trace=True)`` emits a
``jax.profiler.TraceAnnotation``; here ``span(..., nvtx=True)`` pushes an
NVTX range instead (``torch.cuda.nvtx.range_push``/``range_pop``), and only
once CUDA is initialised in the process, so a CPU run never touches the
CUDA runtime. Nsight and ``torch.profiler`` show the range on the host
timeline beside the kernels it launched.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import threading
import time
from collections import defaultdict
from dataclasses import dataclass


@contextlib.contextmanager
def _nvtx_range(name: str):
    """An NVTX range around the block when CUDA is initialised, else
    nothing (torch is imported lazily: only a span that asks pays it)."""
    try:
        import torch

        live = torch.cuda.is_initialized()
    except Exception:  # noqa: BLE001 — a broken CUDA runtime: no range
        live = False
    if not live:
        yield
        return
    torch.cuda.nvtx.range_push(name)
    try:
        yield
    finally:
        torch.cuda.nvtx.range_pop()


@dataclass
class _Stat:
    count: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    def record(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)

    def as_dict(self) -> dict:
        mean = self.total_s / self.count if self.count else 0.0
        return {
            "count": self.count,
            "total_s": round(self.total_s, 6),
            "mean_s": round(mean, 6),
            "min_s": round(self.min_s, 6) if self.count else 0.0,
            "max_s": round(self.max_s, 6),
        }


# 24 log-spaced (factor-2) upper bounds from 100 µs to ~839 s: one fixed
# ladder for every latency histogram, so bucket layouts never vary per
# metric and Prometheus can aggregate across restarts.
DEFAULT_BUCKETS: tuple[float, ...] = tuple(1e-4 * 2.0**i for i in range(24))


class Histogram:
    """Fixed-bucket histogram with Prometheus-style quantile estimation.

    ``bounds`` are inclusive upper edges (``le``); observations above the
    last bound land in the implicit +Inf bucket. Quantiles interpolate
    linearly inside the owning bucket (the histogram_quantile rule), which
    makes the math exact and testable on synthetic data.
    """

    __slots__ = ("bounds", "counts", "inf_count", "count", "sum", "min", "max")

    def __init__(self, buckets: tuple[float, ...] | list[float] | None = None):
        bounds = tuple(
            float(b)
            for b in (DEFAULT_BUCKETS if buckets is None else buckets)
        )
        if not bounds or any(
            b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])
        ):
            raise ValueError("histogram buckets must be strictly increasing")
        self.bounds = bounds
        self.counts = [0] * len(bounds)
        self.inf_count = 0
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = 0.0

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        idx = bisect.bisect_left(self.bounds, v)  # first bound >= v (le)
        if idx < len(self.bounds):
            self.counts[idx] += 1
        else:
            self.inf_count += 1

    def quantile(self, q: float) -> float:
        """The q-quantile (q in [0, 1]) under the uniform-within-bucket
        assumption; observations in the +Inf bucket report the last finite
        bound (Prometheus convention)."""
        if self.count == 0:
            return 0.0
        rank = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            prev = cum
            cum += c
            if c and cum >= rank:
                lo = self.bounds[i - 1] if i else 0.0
                hi = self.bounds[i]
                return lo + (hi - lo) * max(0.0, rank - prev) / c
        return self.bounds[-1]

    def summary(self) -> dict:
        mean = self.sum / self.count if self.count else 0.0
        return {
            "count": self.count,
            "sum": round(self.sum, 6),
            "mean": round(mean, 6),
            "p50": round(self.quantile(0.50), 6),
            "p95": round(self.quantile(0.95), 6),
            "p99": round(self.quantile(0.99), 6),
            "min": round(self.min, 6) if self.count else 0.0,
            "max": round(self.max, 6),
        }

    def state(self) -> tuple:
        """(bounds, per-bucket counts, +Inf count, sum, count) — the raw
        series the Prometheus renderer needs (cumulative le buckets)."""
        return (self.bounds, list(self.counts), self.inf_count,
                self.sum, self.count)


class Metrics:
    """Thread-safe counters, gauges, span timers, and histograms."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, float] = defaultdict(float)
        self._gauges: dict[str, float] = {}
        self._spans: dict[str, _Stat] = defaultdict(_Stat)
        self._hists: dict[str, Histogram] = {}

    def incr(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] += value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        """Record one observation into the named histogram."""
        with self._lock:
            self._hist_locked(name).observe(value)

    def _hist_locked(self, name: str) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram()
        return h

    @contextlib.contextmanager
    def span(self, name: str, nvtx: bool = False):
        """Time a block; optionally also push an NVTX range around it (when
        CUDA is initialised). The duration feeds both the span aggregate
        and a ``<name>_seconds`` histogram."""
        ctx = _nvtx_range(name) if nvtx else contextlib.nullcontext()
        start = time.perf_counter()
        try:
            with ctx:
                yield
        finally:
            dt = time.perf_counter() - start
            with self._lock:
                self._spans[name].record(dt)
                self._hist_locked(name + "_seconds").observe(dt)

    def timing(self, name: str, dt: float) -> None:
        with self._lock:
            self._spans[name].record(dt)
            self._hist_locked(name + "_seconds").observe(dt)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "spans": {k: v.as_dict() for k, v in self._spans.items()},
                "histograms": {
                    k: v.summary() for k, v in self._hists.items()
                },
            }

    def prometheus_text(self) -> str:
        """The full exposition in Prometheus text format (0.0.4)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: v.state() for k, v in self._hists.items()}
        from fei_tpu_torch.obs.prom import render_prometheus

        return render_prometheus(counters, gauges, hists)

    def dumps(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._spans.clear()
            self._hists.clear()


METRICS = Metrics()
