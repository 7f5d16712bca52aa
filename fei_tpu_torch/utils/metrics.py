"""Structured metrics: counters, gauges, span timers and histograms.

A copy of fei_tpu.obs.metrics (with its Prometheus renderer,
fei_tpu.obs.prom) minus the jax.profiler span annotation. Spans are
wall-clock host timings; a span that must cover device work ends in a
host sync inside it (the engine syncs on the sampled token).

The KV tier (fei_tpu_torch/kv, the scheduler's spill, streamed resume,
content-addressed prefixes and migration) sets the JAX package's ``kv.*``
names (fei_tpu/obs/registry.py): counters ``kv.spills``,
``kv.spill_failures``, ``kv.pages_spilled``, ``kv.bytes_spilled``,
``kv.fetches``, ``kv.pages_restored``, ``kv.bytes_fetched``,
``kv.fetch_misses``, ``kv.fetch_corrupt``, ``kv.fetch_fallbacks``,
``kv.spill_skipped_length`` (the port's own: a victim whose device
length is not its host token count, so it replays),
``kv.demotions``, ``kv.evictions``, ``kv.migrations_out``/``_in``,
``kv.pages_migrated``, ``kv.bytes_migrated``, ``kv.cas_stores``,
``kv.cas_dedup_hits``, ``kv.prefix_hits_tier``, ``kv.prefix_tokens_saved``,
``kv.resharded_imports``; gauges ``kv.tier_bytes_ram``/``_disk``,
``kv.tier_entries``, ``kv.dedup_ratio``, ``kv.spilled_gbps``,
``kv.fetched_gbps``; spans ``kv_spill`` (a gather to the host) and
``kv_fetch`` (a scatter into the pool).
"""

from __future__ import annotations

import bisect
import contextlib
import re
import threading
import time
from collections import defaultdict
from dataclasses import dataclass


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
# ladder for every latency histogram
DEFAULT_BUCKETS: tuple[float, ...] = tuple(1e-4 * 2.0**i for i in range(24))


class Histogram:
    """Fixed-bucket histogram with Prometheus-style quantile estimation
    (``bounds`` are inclusive upper edges; linear interpolation inside the
    owning bucket)."""

    __slots__ = ("bounds", "counts", "inf_count", "count", "sum", "min", "max")

    def __init__(self, buckets: tuple[float, ...] | list[float] | None = None):
        bounds = tuple(
            float(b) for b in (DEFAULT_BUCKETS if buckets is None else buckets)
        )
        if not bounds or any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
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
        idx = bisect.bisect_left(self.bounds, v)
        if idx < len(self.bounds):
            self.counts[idx] += 1
        else:
            self.inf_count += 1

    def quantile(self, q: float) -> float:
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
        with self._lock:
            self._hist_locked(name).observe(value)

    def _hist_locked(self, name: str) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram()
        return h

    @contextlib.contextmanager
    def span(self, name: str):
        """Time a block; the duration feeds the span aggregate and a
        ``<name>_seconds`` histogram."""
        start = time.perf_counter()
        try:
            yield
        finally:
            self.timing(name, time.perf_counter() - start)

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
                "histograms": {k: v.summary() for k, v in self._hists.items()},
            }

    def prometheus_text(self) -> str:
        """The full exposition in Prometheus text format (0.0.4): names
        prefixed ``fei_``, counters suffixed ``_total``, histograms as
        cumulative ``le`` buckets plus ``_sum``/``_count``."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {
                k: (v.bounds, list(v.counts), v.inf_count, v.sum, v.count)
                for k, v in self._hists.items()
            }
        lines: list[str] = []
        for name in sorted(counters):
            prom = _sanitize(name) + "_total"
            lines += [f"# TYPE {prom} counter", f"{prom} {_fmt(counters[name])}"]
        for name in sorted(gauges):
            prom = _sanitize(name)
            lines += [f"# TYPE {prom} gauge", f"{prom} {_fmt(gauges[name])}"]
        for name in sorted(hists):
            bounds, counts, inf_count, total, count = hists[name]
            prom = _sanitize(name)
            lines.append(f"# TYPE {prom} histogram")
            cum = 0
            for b, c in zip(bounds, counts):
                cum += c
                lines.append(f'{prom}_bucket{{le="{b:.10g}"}} {cum}')
            lines.append(f'{prom}_bucket{{le="+Inf"}} {cum + inf_count}')
            lines.append(f"{prom}_sum {total:.9g}")
            lines.append(f"{prom}_count {count}")
        return "\n".join(lines) + "\n"


_INVALID = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize(name: str) -> str:
    n = _INVALID.sub("_", name)
    if not re.match(r"[a-zA-Z_:]", n):
        n = "_" + n
    return "fei_" + n


def _fmt(v: float) -> str:
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    if float(v) == int(v) and abs(v) < 1e15:
        return str(int(v))
    return f"{v:.10g}"


METRICS = Metrics()


def account_kv_transfer(direction: str, nbytes: int, dt_s: float) -> None:
    """Bytes moved by the KV tier: the cumulative ``kv.bytes_<direction>``
    counter and the achieved ``kv.<direction>_gbps`` gauge (host clock).
    ``direction`` is ``spilled`` (device → host on preemption) or
    ``fetched`` (host → device on streamed resume). The JAX package keeps
    this in its cost model (obs/costmodel.py), which the port does not
    have yet."""
    if direction not in ("spilled", "fetched"):
        return
    METRICS.incr(f"kv.bytes_{direction}", int(nbytes))
    if dt_s > 0:
        METRICS.gauge(f"kv.{direction}_gbps", round(nbytes / dt_s / 1e9, 6))
