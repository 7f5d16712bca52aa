"""Replica handles the fleet router forwards through (counterpart of
fei_tpu/fleet/replica.py).

Two shapes behind one duck-typed surface:

- ``InProcessReplica`` wraps a socket-free ``ServeAPI`` core directly —
  several engines in one process (tests on the CPU, ``chip_smoke.py``'s
  fleet phase on one card), so rolling restarts and breaker trips run
  with no ports and no subprocesses.
- ``HttpReplica`` speaks to a remote ``python -m fei_tpu_torch serve``
  process over urllib, streaming SSE frames as they arrive.
  Restarting a remote process is the supervisor's job (systemd / k8s),
  so its ``restart()`` raises and ``can_restart`` is False — the
  router's rolling restart refuses an HTTP fleet up-front (before
  draining anything); the HTTP twin is drain + supervisor restart.

The router-facing contract:

- ``request(method, path, body, headers) -> (status, payload, headers)``
  — never raises for HTTP-level errors (4xx/5xx come back as a status);
  raises ``OSError``/``TimeoutError``-class exceptions only for
  transport failures, which the router counts toward the breaker.
- ``stream(body, headers)`` — an iterator of SSE byte frames.
- ``wait_drained(timeout)`` / ``restart()`` — the rolling-restart hooks.
"""

from __future__ import annotations

import json
import threading

from fei_tpu_torch.utils.errors import EngineError
from fei_tpu_torch.utils.logging import get_logger

log = get_logger("fleet.replica")


class InProcessReplica:
    """A ServeAPI core addressed like a network replica.

    ``factory`` is a zero-arg callable returning a fresh ``ServeAPI``;
    it is required for ``restart()`` because a drained scheduler is
    sticky for its lifetime — restart means a new engine, exactly like a
    new process. ``drain_dir`` is where the old engine snapshots queued
    requests at drain and where the new one warm-restarts from.
    """

    def __init__(self, rid: str, api=None, factory=None,
                 drain_dir: str | None = None):
        if api is None and factory is None:
            raise EngineError(
                f"replica {rid!r} needs api= or factory= (got neither)"
            )
        self.rid = rid
        self._factory = factory
        self.api = api if api is not None else factory()
        self.drain_dir = drain_dir
        self._wire_drain_dir()

    @property
    def engine(self):
        return getattr(self.api.provider, "engine", None)

    @property
    def role(self) -> str:
        """The replica's fleet role (``mixed`` / ``prefill-heavy`` /
        ``decode-heavy``) — owned by the ServeAPI (ctor ``role=`` or
        FEI_TPU_REPLICA_ROLE) and reported on ``/health``; the router
        reads it off the health payload, this property is for tests and
        in-process tooling."""
        return getattr(self.api, "role", "mixed")

    @property
    def can_restart(self) -> bool:
        """True when ``restart()`` can rebuild this replica in-place —
        the router's rolling restart checks this BEFORE draining
        anything, so a fleet with an unrestartable member refuses the
        sweep instead of stranding a drained replica mid-loop."""
        return self._factory is not None

    def _wire_drain_dir(self) -> None:
        """Point the scheduler's drain snapshots at this replica's
        drain_dir, so a POST /drain persists queued requests where
        ``restart()`` will look for them."""
        sched = getattr(self.engine, "_scheduler", None)
        if self.drain_dir and sched is not None:
            sched.drain_dir = self.drain_dir

    def request(self, method: str, path: str, body: dict | None = None,
                headers: dict | None = None) -> tuple[int, dict, dict]:
        res = self.api.handle(method, path, dict(body or {}),
                              dict(headers or {}))
        extra = res[2] if len(res) > 2 else {}
        return res[0], res[1], dict(extra or {})

    def stream(self, body: dict, headers: dict | None = None):
        """SSE frames for a streaming chat completion. Raises ValueError
        on a malformed body (the router maps that to 400 pre-commit)."""
        kw = self.api._parse_request(dict(body), dict(headers or {}))
        return self.api.stream_chat(body, kw)

    def wait_drained(self, timeout: float | None = None) -> bool:
        eng = self.engine
        if eng is None:
            return True
        return eng.wait_drained(timeout)

    def restart(self) -> int:
        """Warm restart: rebuild the API (fresh engine + scheduler) and
        re-admit any requests the drained engine snapshotted. Returns
        how many snapshots were restored; their decodes finish on daemon
        threads exactly like ``fei serve``'s boot path."""
        if self._factory is None:
            raise EngineError(
                f"replica {self.rid!r} has no factory=; cannot restart"
            )
        self.api = self._factory()
        self._wire_drain_dir()
        eng = self.engine
        if not self.drain_dir or eng is None:
            return 0
        try:
            restored = eng.warm_restart(self.drain_dir)
        except Exception as exc:  # noqa: BLE001 — a corrupt snapshot
            # must not keep the replica out of rotation
            log.warning("replica %s warm restart failed: %r", self.rid, exc)
            return 0

        def _finish(s):
            try:
                for _ in eng.scheduler.drain(s):
                    pass
            except Exception as exc:  # noqa: BLE001
                log.warning("restored request %s failed: %r",
                            getattr(s, "rid", "?"), exc)

        for s in restored:
            threading.Thread(target=_finish, args=(s,), daemon=True).start()
        return len(restored)


class HttpReplica:
    """A remote ``fei serve`` endpoint behind the same contract."""

    def __init__(self, rid: str, base_url: str, timeout_s: float = 30.0,
                 role: str = "mixed"):
        self.rid = rid
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s
        # informational default; the router trusts the /health payload
        # (the remote process knows its own FEI_TPU_REPLICA_ROLE)
        self.role = role

    def request(self, method: str, path: str, body: dict | None = None,
                headers: dict | None = None) -> tuple[int, dict, dict]:
        import urllib.error
        import urllib.request

        data = None
        hdrs = dict(headers or {})
        if method == "POST":
            data = json.dumps(body or {}).encode("utf-8")
            hdrs.setdefault("Content-Type", "application/json")
        req = urllib.request.Request(
            self.base_url + path, data=data, headers=hdrs, method=method
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return r.status, _json_or_text(r.read()), dict(r.headers)
        except urllib.error.HTTPError as exc:
            # an HTTP status is an answer, not a transport failure — the
            # router's breaker must only count connection-class errors
            payload = _json_or_text(exc.read() if exc.fp else b"")
            return exc.code, payload, dict(exc.headers or {})
        # URLError / socket.timeout propagate: transport failure

    def stream(self, body: dict, headers: dict | None = None):
        import urllib.request

        hdrs = dict(headers or {})
        hdrs.setdefault("Content-Type", "application/json")
        req = urllib.request.Request(
            self.base_url + "/v1/chat/completions",
            data=json.dumps({**body, "stream": True}).encode("utf-8"),
            headers=hdrs, method="POST",
        )
        resp = urllib.request.urlopen(req, timeout=self.timeout_s)

        def frames():
            with resp:
                buf = b""
                for line in resp:
                    buf += line
                    if buf.endswith(b"\n\n") or line == b"\n":
                        if buf.strip():
                            yield buf
                        buf = b""
                if buf.strip():
                    yield buf

        return frames()

    def wait_drained(self, timeout: float | None = None) -> bool:
        del timeout  # a remote drain's completion isn't observable here
        return False

    # restarting a remote process is the supervisor's job; the router's
    # rolling restart refuses the whole sweep up-front when it sees this
    can_restart = False

    def restart(self) -> int:
        raise EngineError(
            f"replica {self.rid!r} is remote; restart it via its process "
            "supervisor (systemd/k8s), then the router's health probe "
            "readmits it"
        )


def _json_or_text(raw: bytes) -> dict:
    try:
        out = json.loads(raw or b"{}")
        return out if isinstance(out, dict) else {"data": out}
    except (ValueError, UnicodeDecodeError):
        return {"raw": raw.decode("utf-8", "replace")}
