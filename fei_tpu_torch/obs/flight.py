"""Engine flight recorder (counterpart of fei_tpu/obs/flight.py): a
bounded, lock-cheap ring of timestamped engine events, exportable as
Chrome-trace/Perfetto JSON.

Two record shapes share the ring:

- **instant** events — scheduler decisions and lifecycle edges (admission,
  turbo arm, rollback, preempt/snapshot/resume, drain, fault injections,
  router ejections and migrations, observed builds) at one timestamp;
- **dispatch** events — one per device dispatch, carrying THREE
  timestamps: call begin, issue return (the launches were queued; the
  device is still running), and host sync complete (the dispatch's one
  host copy returned: the tokens of a scan, the first token of an
  admission). The recorder adds no sync of its own: a dispatch whose
  result is read later (a pipelined fused chunk, a prefill chunk) records
  its issue time as its sync time. The Chrome-trace export splits each
  into an ``<name>.issue`` and ``<name>.sync`` complete ("X") event, so a
  Perfetto timeline shows host-issue vs device+transport time per
  dispatch.

Every record is tagged with the request trace id(s) it served, the
serving-mesh tag, and (where meaningful) the batch slot. The hot path is
one ``deque.append`` of a plain tuple — CPython's deque append is atomic
under the GIL, so recording takes no lock; only snapshot/export does.

Knobs: ``FEI_TPU_FLIGHT_RING`` bounds the ring (default 4096 records,
oldest evicted first); ``FEI_TPU_FLIGHT_FILE`` additionally appends every
record as one JSONL line. ``GET /debug/timeline`` on ui/server.py serves
``chrome_trace()``; load the JSON in https://ui.perfetto.dev or
chrome://tracing.

The compile observer lives here too. The eager port has no jit cache, so
it watches what the port does cache: each kernel library's first load
(``ops/kernels/build.py::load``: an nvcc build or a cache hit) and each
tool grammar's first table upload to an engine (``engine/grammar.py``,
memoized per tool set). The first miss of a signature counts as a
compile (``engine.compiles``) and its first invocation is timed into the
``compile_seconds`` histogram; a later miss of the same signature (a
forced reload, a dropped memo) counts as a recompile (``engine.recompiles``),
which must read zero after warm-up.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import Counter, deque

from fei_tpu_torch.obs.metrics import METRICS

# record tuples: ("i", name, ts, tags) | ("X", name, t0, t_issue, t1, tags)
_INSTANT = "i"
_DISPATCH = "X"


def _ring_size() -> int:
    try:
        return max(16, int(os.environ.get("FEI_TPU_FLIGHT_RING", "4096")))
    except ValueError:
        return 4096


class FlightRecorder:
    """Bounded ring of engine events with Chrome-trace export."""

    def __init__(self, maxlen: int | None = None):
        self._ring: deque[tuple] = deque(
            maxlen=_ring_size() if maxlen is None else max(16, int(maxlen))
        )
        self._lock = threading.Lock()  # guards export/reset, not recording

    # -- recording (lock-free: one atomic deque.append) ------------------

    def event(self, name: str, *, rid: str | None = None,
              mesh: str | None = None, slot: int | None = None,
              **args) -> None:
        """Record one instant event (a scheduler decision / lifecycle
        edge) at the current timestamp."""
        tags = self._tags(rid, None, mesh, slot, args)
        rec = (_INSTANT, name, time.perf_counter(), tags)
        self._ring.append(rec)
        self._spill(rec)

    def dispatch(self, name: str, t0: float, t_issue: float, t1: float, *,
                 rid: str | None = None, rids=None,
                 mesh: str | None = None, slot: int | None = None,
                 **args) -> None:
        """Record one device dispatch: ``t0`` call begin, ``t_issue`` the
        launches were queued (the device is running), ``t1``
        host sync complete. All three are time.perf_counter() values."""
        tags = self._tags(rid, rids, mesh, slot, args)
        rec = (_DISPATCH, name, t0, t_issue, t1, tags)
        self._ring.append(rec)
        self._spill(rec)

    @staticmethod
    def _tags(rid, rids, mesh, slot, args) -> dict:
        tags = dict(args)
        if rid is not None:
            tags["rid"] = rid
        if rids is not None:
            tags["rids"] = list(rids)
        if mesh is not None:
            tags["mesh"] = mesh
        if slot is not None:
            tags["slot"] = slot
        return tags

    def _spill(self, rec: tuple) -> None:
        path = os.environ.get("FEI_TPU_FLIGHT_FILE")
        if not path:
            return
        try:
            with open(path, "a", encoding="utf-8") as f:
                f.write(json.dumps(self._as_dict(rec)) + "\n")
        except OSError:
            pass  # flight recording must never take down the serving loop

    # -- export -----------------------------------------------------------

    @staticmethod
    def _as_dict(rec: tuple) -> dict:
        if rec[0] == _INSTANT:
            _, name, ts, tags = rec
            return {"kind": "instant", "name": name,
                    "ts": round(ts, 6), "tags": tags}
        _, name, t0, t_issue, t1, tags = rec
        return {"kind": "dispatch", "name": name, "ts": round(t0, 6),
                "issue_s": round(t_issue - t0, 6),
                "sync_s": round(t1 - t_issue, 6), "tags": tags}

    def records(self) -> list[dict]:
        """Snapshot of the ring as plain dicts, oldest first."""
        with self._lock:
            ring = list(self._ring)
        return [self._as_dict(r) for r in ring]

    def counts(self) -> Counter:
        """Record count per event name — the recorder side of the
        dispatch-accounting cross-check against METRICS counters."""
        with self._lock:
            ring = list(self._ring)
        return Counter(r[1] for r in ring)

    def for_rid(self, rid: str) -> list[dict]:
        """The ring slice mentioning one request id (instants tagged with
        it, dispatches that served it)."""
        out = []
        for rec in self.records():
            tags = rec["tags"]
            if tags.get("rid") == rid or rid in (tags.get("rids") or ()):
                out.append(rec)
        return out

    def chrome_trace(self) -> dict:
        """The ring as Chrome-trace JSON (``{"traceEvents": [...]}``,
        timestamps in µs). Each dispatch expands into two complete ("X")
        events — ``<name>.issue`` and ``<name>.sync`` — so the issue/sync
        split is visible as adjacent slices on the timeline; instants
        export as ph="i". Args carry the rid/mesh/slot tags verbatim."""
        with self._lock:
            ring = list(self._ring)
        events = []
        for rec in ring:
            if rec[0] == _INSTANT:
                _, name, ts, tags = rec
                events.append({
                    "name": name, "ph": "i", "s": "g",
                    "ts": round(ts * 1e6, 3), "pid": 1, "tid": 1,
                    "args": tags,
                })
            else:
                _, name, t0, t_issue, t1, tags = rec
                events.append({
                    "name": f"{name}.issue", "ph": "X",
                    "ts": round(t0 * 1e6, 3),
                    "dur": round(max(0.0, t_issue - t0) * 1e6, 3),
                    "pid": 1, "tid": 1, "args": tags,
                })
                events.append({
                    "name": f"{name}.sync", "ph": "X",
                    "ts": round(t_issue * 1e6, 3),
                    "dur": round(max(0.0, t1 - t_issue) * 1e6, 3),
                    "pid": 1, "tid": 1, "args": tags,
                })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()

    def __len__(self) -> int:
        return len(self._ring)


class CompileObserver:
    """Counts and times first builds per signature.

    Every cache in the port routes its miss through ``wrap``: the first
    miss of a ``(family, key)`` signature counts as a compile
    (``engine.compiles``) and its first invocation is timed into the
    ``compile_seconds`` histogram; a LATER miss of the same signature (the
    cache was dropped or reloaded) counts as a recompile
    (``engine.recompiles``) and records a flight event. Each engine keeps
    one for its grammar uploads; the kernel libraries, which are
    process-wide, share one in ops/kernels/build.py.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._seen: set = set()

    def wrap(self, family: str, key, fn):
        """Register a cache miss for ``(family, key)`` and return ``fn``
        wrapped so its first invocation is timed as the build."""
        sig = (family, key)
        with self._lock:
            if sig in self._seen:
                METRICS.incr("engine.recompiles")
                FLIGHT.event("recompile", family=family, key=str(key))
            else:
                self._seen.add(sig)
                METRICS.incr("engine.compiles")
        state = {"first": True}

        def timed(*a, **kw):
            if state["first"]:
                state["first"] = False
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                dt = time.perf_counter() - t0
                METRICS.timing("compile", dt)
                FLIGHT.event("compile", family=family, key=str(key),
                             seconds=round(dt, 6))
                return out
            return fn(*a, **kw)

        return timed


FLIGHT = FlightRecorder()
