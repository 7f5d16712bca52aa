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
  admission), each a ``time.time()`` value. The recorder adds no sync of
  its own: a dispatch whose result is read later (a pipelined fused
  chunk, a prefill chunk) records its issue time as its sync time. The Chrome-trace export splits each
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

Ranges: while a torch profiler runs in the process, the recorder also
captures **ranges** — a name, a start and end on the host, the range open
around it on the same thread (its parent) and tags; a device-timed range
also carries the device time between two ``torch.cuda.Event``s recorded at
its ends, read once the device has passed the second (before the next
decode dispatch's host copy, at the end of an admission call, or on
export: the recorder adds no sync).
Capture is on exactly while a profiler runs: the paged scheduler's loop
reads the profiler's state once an iteration (``follow_profiler``), and
``POST /debug/profile`` sets it around its own capture. No switch or
environment variable turns it on. With capture off a call site pays one
test of ``capturing`` and nothing else (no object, no clock read). Ranges
go to a capture list of their own, never into the ring: it is cleared
when a capture starts and holds at most ``CAPTURE_MAX`` ranges, counting
the ones it drops (``ranges_dropped``). The ranges, at layer boundaries
(parents by indentation; "device": device-timed):

- ``sched.admit``: one ``PagedScheduler._admit_ready`` call
  - ``admit.dense``: one dense admission
    - ``engine.prefill``: ``InferenceEngine.prefill``
  - ``admit.chunk``: one chunk of a chunked admission (also a deferred
    chunk flushed after a decode dispatch, outside ``sched.admit``)
- ``sched.decode``: one ``_dispatch_steps`` call
  - ``decode.prepare``: page growth, the host token and live tensors, the
    grammar vectors, the sampler's build
  - ``model.forward``: one step's ``forward_paged`` /
    ``forward_paged_merged`` (every prefill forward has one too)
    - ``model.attn``: the qkv projection, the KV write and the attention
    - ``model.mlp``, or ``model.moe`` on MoE configurations (device)
      - ``quant.cast``: an int8 weight's bf16 copy, in ``ops.quant.wcast``
        and ``ops.quant.mm`` (device)
    - ``model.head``: the final norm and the logits
  - ``decode.sample``: one step's sampler
  - ``decode.sync``: the dispatch's one host copy
- ``sched.deliver``: the delivery loop after a dispatch

One clock: instants, dispatches and ranges are all on the wall clock
(``time.time``; ranges in ``time.time_ns``), the clock ``torch.profiler``'s
timeline is placed on (``trace_start_ns()`` + an event's ``time_range``),
so ``GET /debug/timeline``, the ranges and ``/debug/profile``'s
``trace.json`` line up.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import Counter, deque

from fei_tpu_torch.obs.metrics import METRICS

# record tuples: ("i", name, ts, tags) | ("X", name, t0, t_issue, t1, tags)
_INSTANT = "i"
_DISPATCH = "X"
# range lists: [id, name, start ns, end ns, parent id (0: none), thread id,
# tags, device (None; [event, event] until read; ms), capture generation]
CAPTURE_MAX = 1 << 17


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
        self.capturing = False  # ranges are recorded (a profiler runs)
        self.ranges_dropped = 0  # ranges past CAPTURE_MAX in this capture
        self._capture_max = CAPTURE_MAX
        self._captured: list[list] = []
        self._pending: list[list] = []  # device-timed ranges not yet read
        self._stacks: dict[int, list] = {}  # thread id -> its open ranges
        self._ids = itertools.count(1)
        self._gen = 0
        self._events: list = []  # spare CUDA events
        self._cuda = None  # the torch.cuda module while device timing works
        self._stream = None  # the stream device times are taken on

    # -- recording (lock-free: one atomic deque.append) ------------------

    def event(self, name: str, *, rid: str | None = None,
              mesh: str | None = None, slot: int | None = None,
              **args) -> None:
        """Record one instant event (a scheduler decision / lifecycle
        edge) at the current timestamp."""
        tags = self._tags(rid, None, mesh, slot, args)
        rec = (_INSTANT, name, time.time(), tags)
        self._ring.append(rec)
        self._spill(rec)

    def dispatch(self, name: str, t0: float, t_issue: float, t1: float, *,
                 rid: str | None = None, rids=None,
                 mesh: str | None = None, slot: int | None = None,
                 **args) -> None:
        """Record one device dispatch: ``t0`` call begin, ``t_issue`` the
        launches were queued (the device is running), ``t1``
        host sync complete. All three are time.time() values."""
        tags = self._tags(rid, rids, mesh, slot, args)
        rec = (_DISPATCH, name, t0, t_issue, t1, tags)
        self._ring.append(rec)
        self._spill(rec)

    # -- ranges (only while a profiler runs) ------------------------------

    def follow_profiler(self, on: bool) -> None:
        """Set capture to the profiler's state ``on``: a capture starts
        (the list cleared) when it turns on and ends when it turns off.
        Called between loop iterations, where the calling thread has no
        range open: while capturing it also drops what an exception left
        open on this thread. Device times are taken on the stream current
        when the capture starts (the port launches on one stream)."""
        if on and not self.capturing:
            import torch

            with self._lock:
                self._gen += 1
                self._captured, self._pending, self._stacks = [], [], {}
                self.ranges_dropped = 0
                cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
                self._cuda = torch.cuda if cuda else None
                self._stream = torch.cuda.current_stream() if cuda else None
                self.capturing = True
        elif not on and self.capturing:
            self.capturing = False
        elif on:
            self._stacks.pop(threading.get_ident(), None)

    def open(self, name: str, device: bool = False, **tags) -> list:
        """Open a range on this thread; call only while ``capturing`` and
        hand the result to ``close``. ``device``: also time it on the
        device (CUDA events at its ends), where CUDA runs."""
        tid = threading.get_ident()
        stack = self._stacks.setdefault(tid, [])
        rec = [next(self._ids), name, time.time_ns(), 0, stack[-1][0] if stack else 0,
               tid, tags, None, self._gen]
        if device and self._cuda is not None:
            ev = self._event()
            ev.record(self._stream)
            rec[7] = [ev, None]
        stack.append(rec)
        return rec

    def close(self, rec: list) -> None:
        """Close a range ``open`` returned and keep it in the capture."""
        rec[3] = time.time_ns()
        if rec[8] != self._gen:
            return  # its capture ended
        if rec[7] is not None:
            ev = self._event()
            ev.record(self._stream)
            rec[7][1] = ev
        stack = self._stacks.get(rec[5])
        while stack:  # ranges an exception left open above it end here
            if stack.pop() is rec:
                break
        if len(self._captured) >= self._capture_max:
            self.ranges_dropped += 1
            return
        self._captured.append(rec)
        if rec[7] is not None:
            with self._lock:
                self._pending.append(rec)

    def _event(self):
        try:
            return self._events.pop()
        except IndexError:
            return self._cuda.Event(enable_timing=True)

    def resolve(self) -> None:
        """Read the device times of the device-timed ranges, oldest first,
        up to the first one the device has not passed; the rest wait (no
        sync). The decode dispatch calls it before its host copy, while the
        device runs (the ranges of earlier dispatches are done by then), and
        an admission call at its end (its first tokens' copies synced)."""
        with self._lock:
            done = 0
            for rec in self._pending:
                ev0, ev1 = rec[7]
                try:
                    rec[7] = ev0.elapsed_time(ev1)
                except RuntimeError:  # not reached yet: it and the later ones wait
                    break
                self._events += (ev0, ev1)
                done += 1
            del self._pending[:done]

    def ranges(self) -> list[dict]:
        """The captured ranges as plain dicts, by start: ``start_ns`` and
        ``end_ns`` on ``time.time_ns``, ``parent`` the id of the range
        open around it on its thread (0: none), ``device_ms`` None where
        the range is not device-timed or the device has not passed it."""
        self.resolve()
        with self._lock:
            recs = sorted(self._captured, key=lambda r: r[2])
        return [{"id": r[0], "name": r[1], "start_ns": r[2], "end_ns": r[3],
                 "parent": r[4], "tid": r[5], "tags": r[6],
                 "device_ms": r[7] if isinstance(r[7], float) else None} for r in recs]

    def chrome_ranges(self, base_ns: int = 0, since_ns: int = 0) -> list[dict]:
        """The ranges that started at or after ``since_ns`` as Chrome-trace
        complete events, in µs after ``base_ns``; one track per thread
        (tid 2, 3, ...; the ring is tid 1)."""
        tids: dict[int, int] = {}
        events = []
        for r in self.ranges():
            if r["start_ns"] < since_ns:
                continue
            args = dict(r["tags"])
            if r["device_ms"] is not None:
                args["device_ms"] = r["device_ms"]
            events.append({
                "name": r["name"], "ph": "X", "ts": (r["start_ns"] - base_ns) / 1e3,
                "dur": (r["end_ns"] - r["start_ns"]) / 1e3, "pid": 1,
                "tid": tids.setdefault(r["tid"], len(tids) + 2), "args": args,
            })
        return events

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
        """The ring and the captured ranges as Chrome-trace JSON
        (``{"traceEvents": [...]}``, timestamps in µs on the wall clock).
        Each dispatch expands into two complete ("X") events —
        ``<name>.issue`` and ``<name>.sync`` — so the issue/sync split is
        visible as adjacent slices on the timeline; instants export as
        ph="i". Args carry the rid/mesh/slot tags verbatim. A capture that
        dropped ranges says how many (``rangesDropped``)."""
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
        out = {"traceEvents": events + self.chrome_ranges(), "displayTimeUnit": "ms"}
        if self.ranges_dropped:
            out["rangesDropped"] = self.ranges_dropped
        return out

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._captured, self._pending = [], []
            self.ranges_dropped = 0

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
