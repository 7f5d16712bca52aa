"""Deterministic fault injection for the paged scheduler (a copy of
fei_tpu/engine/faults.py, cut to the points the port's scheduler has).

Named injection points sit at the seams the failure-domain design cares
about, and an armed fault raises a typed exception (utils.errors taxonomy)
exactly ``count`` times, then disarms. Arm it from code:
``FAULTS.arm("delivery.detok", "request", count=1, match=lambda ctx: ...)``
— ``match`` filters on the call-site context (e.g. the victim sequence),
so a test can doom one request out of a concurrent batch with no race
against the scheduler thread. Or from the environment, as the JAX package
arms it: ``FEI_TPU_FAULT="point:kind:count"`` (comma-separated for
several), parsed at import; an entry naming a point or kind this copy
does not have (``grammar.compile``, ``provider.http``) is logged and
skipped. Every fault that fires is a ``fault`` event in the flight
recorder.

Points:
- ``admission.prefill``  — before a prefill/chunk dispatch
- ``decode.dispatch``    — before a batched decode dispatch
- ``delivery.detok``     — per-token delivery
- ``pool.alloc``         — inside the scheduler's page-allocation seam
- ``router.forward``     — fleet router, before forwarding to a replica
- ``replica.health``     — fleet router, before a replica health probe
- ``kv.spill``           — KV tier, before a page spill lands
- ``kv.fetch``           — KV tier, before a page fetch returns
- ``journal.append``     — session journal, before a record append
- ``journal.fsync``      — session journal, before an fsync
- ``replica.crash``      — the hard-kill seam (SIGKILL), per delivered
  token or frame

Kinds: ``request`` → RequestError, ``device`` → DeviceError, ``conn`` →
urllib URLError, ``http429``/``http503`` → urllib HTTPError (with
Retry-After: 0 so retry tests stay fast; the router diverts without
charging the breaker),
``exhausted``/``transient`` → PoolPressure (``pool.alloc``: the
scheduler's pressure handler swallows it like a real exhaustion, so a
test forces preemption on a roomy pool), ``io`` → OSError (a journal
write or a tier file that fails), ``corrupt`` → KVTierError (a tier entry
whose checksum fails), ``hang`` → TimeoutError (what a fetch that never
answers — a replica or a fetch — turns into after its timeout; raised
at once, never slept).

``crash`` is the one kind that does not raise: it kills the whole process
with SIGKILL — no handlers, no drain, no atexit — the kill -9 the session
journal exists to survive. Its ``count`` is a delay fuse rather than a
fire budget: the fault fires on the count-th matching check, since a kill
can only ever fire once.
"""

from __future__ import annotations

import os
import threading
from typing import Callable

from fei_tpu_torch.obs.flight import FLIGHT
from fei_tpu_torch.utils.errors import (
    DeviceError,
    EngineError,
    PoolPressure,
    RequestError,
)
from fei_tpu_torch.utils.logging import get_logger

log = get_logger("faults")

POINTS = ("admission.prefill", "decode.dispatch", "delivery.detok", "pool.alloc",
          "router.forward", "replica.health",
          "kv.spill", "kv.fetch", "journal.append", "journal.fsync", "replica.crash")
KINDS = ("request", "device", "conn", "http429", "http503",
         "exhausted", "transient", "hang", "io", "corrupt", "crash")


def _hard_kill(point: str) -> None:
    """SIGKILL this process. Module-level so a test can replace it."""
    import os
    import signal

    os.kill(os.getpid(), signal.SIGKILL)


def _make_exc(kind: str, point: str) -> BaseException:
    msg = f"injected {kind} fault at {point}"
    if kind == "crash":
        # never raised: check() routes a crash to _hard_kill; this arm
        # lets arm() validate the kind
        return SystemExit(msg)
    if kind == "io":
        return OSError(msg)
    if kind == "corrupt":
        from fei_tpu_torch.utils.errors import KVTierError

        return KVTierError(msg)
    if kind == "hang":
        return TimeoutError(msg)
    if kind == "request":
        return RequestError(msg)
    if kind == "device":
        return DeviceError(msg)
    if kind in ("exhausted", "transient"):
        return PoolPressure(msg)
    import io
    import urllib.error
    from email.message import Message

    if kind == "conn":
        return urllib.error.URLError(msg)
    if kind in ("http429", "http503"):
        hdrs = Message()
        hdrs["Retry-After"] = "0"
        return urllib.error.HTTPError("http://faults.invalid",
                                      429 if kind == "http429" else 503,
                                      msg, hdrs, io.BytesIO(b""))
    raise EngineError(f"unknown fault kind {kind!r} (one of {KINDS})")


class _Fault:
    __slots__ = ("kind", "count", "match")

    def __init__(self, kind: str, count: int, match: Callable[[dict], bool] | None):
        self.kind = kind
        self.count = count
        self.match = match


class FaultInjector:
    """Process-wide registry of armed faults; thread-safe (the scheduler
    loop and submitter threads both check points)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._armed: dict[str, _Fault] = {}
        self._fired: dict[str, int] = {}
        self.load_env()

    def arm(self, point: str, kind: str = "request", count: int = 1,
            match: Callable[[dict], bool] | None = None) -> None:
        if point not in POINTS:
            raise EngineError(f"unknown fault point {point!r} (one of {POINTS})")
        _make_exc(kind, point)  # validate the kind eagerly
        with self._lock:
            self._armed[point] = _Fault(kind, max(1, int(count)), match)

    def disarm(self, point: str | None = None) -> None:
        with self._lock:
            if point is None:
                self._armed.clear()
                self._fired.clear()
            else:
                self._armed.pop(point, None)

    def load_env(self) -> None:
        """(Re)parse FEI_TPU_FAULT — ``point:kind:count`` specs, comma-
        separated. Called at import; tests that monkeypatch the env call
        it explicitly."""
        spec = os.environ.get("FEI_TPU_FAULT", "").strip()
        if not spec:
            return
        for part in spec.split(","):
            fields = part.strip().split(":")
            if len(fields) < 2:
                log.warning("malformed FEI_TPU_FAULT entry %r", part)
                continue
            point, kind = fields[0], fields[1]
            count = int(fields[2]) if len(fields) > 2 else 1
            try:
                self.arm(point, kind, count)
                log.info("fault armed from env: %s:%s:%d", point, kind, count)
            except EngineError as exc:
                log.warning("FEI_TPU_FAULT entry %r rejected: %s", part, exc)

    def check(self, point: str, **ctx) -> None:
        """Raise the armed fault for ``point`` (if any). A non-matching
        context does not consume the count."""
        with self._lock:
            fault = self._armed.get(point)
            if fault is None:
                return
            if fault.match is not None and not fault.match(ctx):
                return
            fault.count -= 1
            if fault.kind == "crash" and fault.count > 0:
                return  # the count is a delay fuse: fire on the Nth check
            if fault.count <= 0:
                self._armed.pop(point, None)
            self._fired[point] = self._fired.get(point, 0) + 1
            kind = fault.kind
        log.warning("firing injected %s fault at %s", kind, point)
        FLIGHT.event("fault", point=point, kind=kind, rid=ctx.get("rid"))
        if kind == "crash":
            _hard_kill(point)
            return  # reached only when a test replaced _hard_kill
        raise _make_exc(kind, point)

    def fired(self, point: str) -> int:
        """How many times ``point`` has fired since the last full disarm()."""
        with self._lock:
            return self._fired.get(point, 0)


FAULTS = FaultInjector()
