"""Per-request lifecycle traces for the paged scheduler (counterpart of
fei_tpu/obs/trace.py).

Every submitted sequence gets a request id and an ordered list of phase
events — queued → admitted → prefill → first_token → completed/cancelled/
failed/deadline_exceeded/snapshotted — kept in a bounded ring buffer
(``FEI_TPU_TRACE_RING``, default 256) and served by ``GET /v1/traces`` on
ui/server.py. Preempt-and-resume scheduling adds non-terminal
``preempted`` / ``resumed`` events mid-trace: a sequence evicted under
KV-pool pressure re-admits and continues byte-identically; ``snapshotted``
is the terminal state of a request persisted to disk by a graceful drain
for warm restart. Setting
``FEI_TPU_TRACE_FILE`` additionally appends each finished trace as one
JSONL line, the flight-recorder shape production schedulers use to debug
tail latency after the fact.

Timestamps are time.time() clamped to be non-decreasing within a trace,
so consumers can rely on monotonically ordered phases even across clock
adjustments.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field

TERMINAL_PHASES = (
    "completed", "cancelled", "failed", "deadline_exceeded", "snapshotted",
    # queued request displaced by a higher-priority arrival when the
    # bounded queue was full (scheduler._check_queue_caps) — counts into
    # scheduler.requests_shed like every other backpressure rejection
    "shed",
)


@dataclass
class RequestTrace:
    rid: str
    prompt_tokens: int = 0
    completion_tokens: int = 0
    status: str = "active"
    # serving-mesh tag ("ms1", "tp2", "tp2dp2", …) — post-hoc tail-latency
    # debugging needs to know which mesh mode served the request
    mesh: str = "ms1"
    events: list = field(default_factory=list)  # [(phase, ts), ...]

    def event(self, phase: str) -> None:
        now = time.time()
        if self.events and now < self.events[-1][1]:
            now = self.events[-1][1]
        self.events.append((phase, now))

    def as_dict(self) -> dict:
        spans = [{"phase": p, "ts": round(ts, 6)} for p, ts in self.events]
        dur = 0.0
        if len(self.events) >= 2:
            dur = self.events[-1][1] - self.events[0][1]
        return {
            "id": self.rid,
            "status": self.status,
            "prompt_tokens": self.prompt_tokens,
            "completion_tokens": self.completion_tokens,
            "mesh": self.mesh,
            "duration_s": round(dur, 6),
            "spans": spans,
        }


class TraceBuffer:
    """Bounded ring of recent request traces (oldest evicted first)."""

    def __init__(self, maxlen: int | None = None):
        if maxlen is None:
            try:
                maxlen = int(os.environ.get("FEI_TPU_TRACE_RING", "256"))
            except ValueError:
                maxlen = 256
        self._lock = threading.Lock()
        self._ring: deque[RequestTrace] = deque(maxlen=max(1, maxlen))

    def start(self, prompt_tokens: int = 0, mesh: str = "ms1") -> RequestTrace:
        tr = RequestTrace(
            rid=f"req-{uuid.uuid4().hex[:12]}", prompt_tokens=prompt_tokens,
            mesh=mesh,
        )
        tr.event("queued")
        with self._lock:
            self._ring.append(tr)
        return tr

    def finish(self, trace: RequestTrace, status: str,
               completion_tokens: int | None = None) -> None:
        """Mark a trace terminal. Idempotent: the first terminal status
        wins, so racing cancel/finish paths can't double-record."""
        if status not in TERMINAL_PHASES:
            raise ValueError(f"not a terminal status: {status!r}")
        with self._lock:
            if trace.status != "active":
                return
            trace.status = status
            if completion_tokens is not None:
                trace.completion_tokens = completion_tokens
            trace.event(status)
        path = os.environ.get("FEI_TPU_TRACE_FILE")
        if path:
            try:
                with open(path, "a", encoding="utf-8") as f:
                    f.write(json.dumps(trace.as_dict()) + "\n")
            except OSError:
                pass  # tracing must never take down the serving loop

    def get(self, rid: str) -> RequestTrace | None:
        """The trace with request id ``rid``, or None if it was never
        recorded or has been evicted from the ring."""
        with self._lock:
            for tr in reversed(self._ring):
                if tr.rid == rid:
                    return tr
        return None

    def recent(self, limit: int = 50) -> list[dict]:
        """Most recent traces first (active ones included)."""
        with self._lock:
            traces = list(self._ring)
        return [t.as_dict() for t in reversed(traces[-max(0, limit):])]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


TRACES = TraceBuffer()
