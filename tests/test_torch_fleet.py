"""The port's fleet router against fei_tpu's.

- Every ``tests/test_fleet.py`` scenario over scripted replicas (routing,
  the breaker, deadlines, fault points, streaming, health, rolling
  restart) runs through BOTH packages' ``Router``: the chosen replica, the
  status, the frames and the counters must be the same.
- The role split, the prefill→decode handoff and the KV CDN's fetch on
  miss and pre-warm run over scripted replicas in both packages, and over
  the port's own ``InProcessReplica``s (tiny paged engines on the CPU).
- F6: ``/health`` of a parked paged scheduler (a finished slot not yet
  evicted, a queued request) equals the reference's, and so do the SSE
  ``fei`` frames (the token ids and the threefry keys) of a greedy and a
  seeded stream.
- Resurrection: a stream whose replica dies after tokens flowed continues
  on the survivor, bitwise the uninterrupted stream and the reference's,
  greedy and seeded; a dropped socket under an ``HttpReplica`` (the
  kill -9 case) resurrects the same way, and ``HttpReplica`` streams frames
  as they arrive.
"""

from __future__ import annotations

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import io
import json
import threading
import time
import types
import urllib.error
from email.message import Message

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fei_tpu.engine.faults as jax_faults
import fei_tpu.fleet as jax_fleet
import fei_tpu.fleet.replica as jax_replica
import fei_tpu.fleet.router as jax_router
import fei_tpu.utils.metrics as jax_metrics
import fei_tpu_torch.engine.faults as torch_faults
import fei_tpu_torch.fleet as torch_fleet
import fei_tpu_torch.fleet.replica as torch_replica
import fei_tpu_torch.fleet.router as torch_router
import fei_tpu_torch.utils.metrics as torch_metrics
from fei_tpu.agent.providers import JaxLocalProvider
from fei_tpu.engine.engine import InferenceEngine as JaxEngine
from fei_tpu.ui.server import ServeAPI as JaxServeAPI
from fei_tpu_torch.agent.providers import TorchLocalProvider
from fei_tpu_torch.engine.engine import InferenceEngine
from fei_tpu_torch.models.convert import params_from_jax
from fei_tpu_torch.ui.server import ServeAPI, ServingServer

PKGS = {
    "fei_tpu": types.SimpleNamespace(
        Router=jax_fleet.Router, HttpReplica=jax_fleet.HttpReplica,
        FAULTS=jax_faults.FAULTS, METRICS=jax_metrics.METRICS,
        parse_sse=jax_router._parse_sse, json_or_text=jax_replica._json_or_text),
    "fei_tpu_torch": types.SimpleNamespace(
        Router=torch_fleet.Router, HttpReplica=torch_fleet.HttpReplica,
        FAULTS=torch_faults.FAULTS, METRICS=torch_metrics.METRICS,
        parse_sse=torch_router._parse_sse, json_or_text=torch_replica._json_or_text),
}
COUNTERS = (
    "router.requests", "router.retries", "router.sheds", "router.ejections",
    "router.readmissions", "router.affinity_hits", "router.affinity_misses",
    "router.deadline_expired", "router.invalid_requests", "router.role_routed",
    "router.migrations", "router.migration_failures", "router.geometry_skips",
    "router.rolling_restarts", "router.prewarm_pushes", "router.prewarm_failures",
    "router.prefix_fetch_failures", "kv.prefix_hits_remote",
    "router.resurrections",
)


@pytest.fixture(autouse=True)
def _clean_faults():
    for pkg in PKGS.values():
        pkg.FAULTS.disarm()
    yield
    for pkg in PKGS.values():
        pkg.FAULTS.disarm()


def _counts(pkg) -> dict:
    c = pkg.METRICS.snapshot()["counters"]
    return {k: c.get(k, 0) for k in COUNTERS}


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in COUNTERS if after[k] != before[k]}


class FakeReplica:
    """Scripted replica (tests/test_fleet.py's): per-call answers,
    recorded forwards."""

    def __init__(self, rid, queue_depth=0, running=0, slots=4):
        self.rid = rid
        self.health = {"status": "ok", "queue_depth": queue_depth,
                       "running": running, "slots": slots}
        self.health_status = 200
        self.fail_with: Exception | None = None
        self.answer = (200, {"id": rid}, {})
        self.answers: list | None = None
        self.calls: list = []
        self.drained = 0
        self.restarted = 0
        self.stream_frames: list = []

    def request(self, method, path, body=None, headers=None):
        self.calls.append((method, path, dict(body or {}), dict(headers or {})))
        if path == "/health":
            return self.health_status, dict(self.health), {}
        if path == "/drain":
            self.health["status"] = "draining"
            return 202, {"status": "draining"}, {}
        if path.startswith("/kv/"):
            return 404, {"error": {"message": "no kv routes here"}}, {}
        if self.fail_with is not None:
            raise self.fail_with
        if self.answers:
            return self.answers.pop(0)
        return self.answer

    def stream(self, body, headers=None):
        self.calls.append(("STREAM", "/v1/chat/completions", dict(body),
                           dict(headers or {})))
        if self.fail_with is not None:
            raise self.fail_with
        return iter(self.stream_frames)

    def wait_drained(self, timeout=None):
        self.drained += 1
        return True

    def restart(self):
        self.restarted += 1
        self.health["status"] = "ok"
        return 2

    def forwards(self) -> list:
        """(method, path, deadline header present) of every non-probe call."""
        return [(m, p, "X-FEI-Deadline-S" in h) for m, p, _, h in self.calls
                if p != "/health"]


def _router(pkg, replicas, **kw):
    kw.setdefault("retries", 2)
    kw.setdefault("backoff_s", 0.0)
    kw.setdefault("breaker_fails", 2)
    kw.setdefault("breaker_cooldown_s", 0.05)
    kw.setdefault("health_ttl_s", 0.0)
    return pkg.Router(replicas, **kw)


def _chat(session=None, content="hi", **extra):
    body = {"messages": [{"role": "user", "content": content}], "max_tokens": 4, **extra}
    if session:
        body["session"] = session
    return body


def _frames(*payloads, done=True):
    out = [b"data: " + json.dumps(p).encode() + b"\n\n" for p in payloads]
    if done:
        out.append(b"data: [DONE]\n\n")
    return out


def _post(r, body, headers=None):
    res = r.handle("POST", "/v1/chat/completions", body, headers or {})
    return [res[0], res[1], sorted((res[2] if len(res) > 2 else {}) or {})]


# -- scenarios: each returns the observables both packages must share ------


def sc_least_loaded(pkg):
    busy = FakeReplica("busy", queue_depth=6, running=4)
    idle = FakeReplica("idle", queue_depth=0, running=1)
    return _post(_router(pkg, [busy, idle]), _chat())


def sc_affinity_sticks(pkg):
    a, b = FakeReplica("a"), FakeReplica("b", queue_depth=1)
    r = _router(pkg, [a, b])
    out = [_post(r, _chat(session="s1"))]
    a.health.update(queue_depth=9, running=4)
    out.append(_post(r, _chat(session="s1")))
    return out


def sc_affinity_falls_back_on_drain(pkg):
    a, b = FakeReplica("a"), FakeReplica("b")
    r = _router(pkg, [a, b])
    out = [_post(r, _chat(session="s1"))]
    a.health["status"] = "draining"
    out.append(_post(r, _chat(session="s1")))
    return out


def sc_affinity_keys(pkg):
    R = pkg.Router
    garbage = [{"messages": "not-a-list"}, {"messages": [42]},
               {"messages": [None, {"role": "user", "content": "x"}]},
               {"messages": {"role": "user"}}, {}]
    return [R._affinity_key(_chat(), {}), R._affinity_key(_chat(), {"X-FEI-Session": "s9"}),
            [R._affinity_key(b, {}) for b in garbage],
            R._affinity_key({"messages": [7, {"role": "user", "content": "hello"}]}, {})]


def sc_affinity_map_bounded(pkg):
    r = _router(pkg, [FakeReplica("a")], affinity_cap=4)
    for i in range(16):
        r._remember(f"session:{i}", "a")
    return list(r._affinity)


def sc_other_routes_proxy(pkg):
    a = FakeReplica("a")
    a.answer = (200, {"object": "list"}, {})
    r = _router(pkg, [a])
    return [r.handle("GET", "/v1/models", {}, {})[:2], a.forwards()]


def sc_breaker_ejects_then_readmits(pkg):
    good, bad = FakeReplica("good", queue_depth=9), FakeReplica("bad")
    bad.fail_with = ConnectionError("refused")
    r = _router(pkg, [bad, good])
    out = [_post(r, _chat(content=f"q{i}")) for i in range(3)]
    out.append(r._status_payload()["replicas"]["bad"]["ejected"])
    out.append(r._usable("bad"))
    bad.fail_with = None
    time.sleep(0.06)
    out += [r._usable("bad"), r._state["bad"].fails]
    return out


def sc_halfopen_failure_reejects(pkg):
    good, bad = FakeReplica("good"), FakeReplica("bad")
    bad.fail_with = ConnectionError("refused")
    r = _router(pkg, [bad, good])
    out = [_post(r, _chat(content=f"q{i}")) for i in range(2)]
    bad.health_status, bad.health = 503, {"status": "unhealthy"}
    time.sleep(0.06)
    out += [r._usable("bad"), r._state["bad"].ejected_until > time.monotonic()]
    return out


def sc_probe_success_keeps_fails(pkg):
    bad = FakeReplica("bad")
    bad.fail_with = ConnectionError("refused")
    r = _router(pkg, [bad, FakeReplica("good")])
    out = [_post(r, _chat()), r._state["bad"].fails]
    out += [r._probe("bad"), r._state["bad"].fails]
    return out


def sc_backpressure_never_trips(pkg):
    a, b = FakeReplica("a"), FakeReplica("b", queue_depth=1)
    a.answer = (429, {"error": {"message": "q full"}}, {"Retry-After": "1"})
    r = _router(pkg, [a, b])
    out = [_post(r, _chat()) for _ in range(4)]
    return out + [r._state["a"].fails]


def sc_all_shedding(pkg):
    a = FakeReplica("a")
    a.answer = (503, {"error": {"message": "draining", "type": "overloaded_error"}}, {})
    return _post(_router(pkg, [a]), _chat())


def sc_retry_untried(pkg):
    flaky, solid = FakeReplica("flaky"), FakeReplica("solid", queue_depth=5)
    flaky.answers = [(503, {"error": {"message": "busy"}}, {})]
    return _post(_router(pkg, [flaky, solid]), _chat())


def sc_deadline_rides_header(pkg):
    a = FakeReplica("a")
    _post(_router(pkg, [a]), _chat(deadline_s=5.0))
    hdr = float(a.calls[-1][3]["X-FEI-Deadline-S"])
    return [0 < hdr <= 5.0, a.forwards()]


def sc_retry_smaller_budget(pkg):
    a, b = FakeReplica("a"), FakeReplica("b", queue_depth=5)
    first = a.request

    def scripted(method, path, body=None, headers=None):
        if path == "/health":
            return first(method, path, body, headers)
        a.calls.append((method, path, dict(body or {}), dict(headers or {})))
        time.sleep(0.05)
        return 503, {"error": {"message": "busy"}}, {}

    a.request = scripted
    out = _post(_router(pkg, [a, b]), _chat(deadline_s=5.0))
    sent_a = float(a.calls[-1][3]["X-FEI-Deadline-S"])
    sent_b = float(b.calls[-1][3]["X-FEI-Deadline-S"])
    return [out, sent_b < sent_a <= 5.0]


def sc_exhausted_budget_504(pkg):
    a = FakeReplica("a")

    def slow(method, path, body=None, headers=None):
        if path != "/health":
            time.sleep(0.02)
            return 503, {"error": {"message": "busy"}}, {}
        return 200, dict(a.health), {}

    a.request = slow
    return _post(_router(pkg, [a], retries=5), _chat(), {"X-FEI-Deadline-S": "0.01"})


def sc_deadline_fold(pkg):
    R = pkg.Router
    return [R._deadline_budget({"deadline_s": 9}, {"X-FEI-Deadline-S": "2"}),
            R._deadline_budget({"deadline_s": 1}, {"x-fei-deadline-s": "30"}),
            R._deadline_budget({}, {}), R._deadline_budget({}, {"X-FEI-Deadline-S": "-1"})]


def sc_fault_conn_charges_breaker(pkg):
    a, b = FakeReplica("a"), FakeReplica("b", queue_depth=5)
    pkg.FAULTS.arm("router.forward", "conn", count=2,
                   match=lambda ctx: ctx.get("replica") == "a")
    out = _post(_router(pkg, [a, b]), _chat())
    return [out, pkg.FAULTS.fired("router.forward")]


def sc_fault_429_is_backpressure(pkg):
    a, b = FakeReplica("a"), FakeReplica("b", queue_depth=5)
    pkg.FAULTS.arm("router.forward", "http429", count=1,
                   match=lambda ctx: ctx.get("replica") == "a")
    r = _router(pkg, [a, b])
    return [_post(r, _chat()), r._state["a"].fails]


def sc_fault_503_then_hang(pkg):
    a, b = FakeReplica("a"), FakeReplica("b", queue_depth=5)
    pkg.FAULTS.arm("router.forward", "http503", count=1,
                   match=lambda ctx: ctx.get("replica") == "a")
    r = _router(pkg, [a, b])
    out = [_post(r, _chat(content="x")), r._state["a"].fails]
    pkg.FAULTS.arm("router.forward", "hang", count=1,
                   match=lambda ctx: ctx.get("replica") == "a")
    out += [_post(r, _chat(content="y")), r._state["a"].fails]
    return out


def sc_fault_health_fails_probe(pkg):
    a = FakeReplica("a")
    pkg.FAULTS.arm("replica.health", "conn", count=1)
    r = _router(pkg, [a])
    return [r._probe("a"), r._state["a"].fails]


def _stream_texts(pkg, chunks):
    infos = [pkg.parse_sse(c) for c in chunks]
    return [(i.get("choices") or [{}])[0].get("delta", {}).get("content")
            if i and not i.get("error") else (i or {}).get("error", {}).get("type")
            for i in infos]


def sc_stream_precommit_overload(pkg):
    a, b = FakeReplica("a"), FakeReplica("b", queue_depth=5)
    a.stream_frames = _frames({"choices": [{"delta": {"role": "assistant"}}]},
                              {"error": {"message": "shed", "type": "overloaded_error"}})
    b.stream_frames = _frames({"choices": [{"delta": {"role": "assistant"}}]},
                              {"choices": [{"delta": {"content": "hi"}}]},
                              {"choices": [{"delta": {}, "finish_reason": "stop"}]})
    return _stream_texts(pkg, list(_router(pkg, [a, b]).stream_chat(_chat(), {})))


def sc_stream_postcommit_error_final(pkg):
    a, b = FakeReplica("a"), FakeReplica("b", queue_depth=5)
    a.stream_frames = _frames({"choices": [{"delta": {"content": "tok"}}]},
                              {"error": {"message": "died", "type": "server_error"}})
    out = _stream_texts(pkg, list(_router(pkg, [a, b]).stream_chat(_chat(), {})))
    return [out, [c[0] for c in b.calls]]


def sc_stream_transport_failover(pkg):
    a, b = FakeReplica("a"), FakeReplica("b", queue_depth=5)
    a.fail_with = ConnectionError("refused")
    b.stream_frames = _frames({"choices": [{"delta": {"content": "ok"}}]})
    return _stream_texts(pkg, list(_router(pkg, [a, b]).stream_chat(_chat(), {})))


def sc_stream_no_replica(pkg):
    a = FakeReplica("a")
    a.health_status, a.health = 503, {"status": "unhealthy"}
    chunks = list(_router(pkg, [a], breaker_fails=99).stream_chat(_chat(), {}))
    return [chunks[-1], _stream_texts(pkg, chunks)]


def sc_stream_malformed_400(pkg):
    a, b = FakeReplica("a"), FakeReplica("b", queue_depth=5)
    a.fail_with = ValueError("messages must be a list")
    r = _router(pkg, [a, b])
    out = [_stream_texts(pkg, list(r.stream_chat(_chat(), {}))) for _ in range(4)]
    return out + [r._state["a"].fails, r._state["a"].healthy, [c[0] for c in b.calls]]


def sc_stream_remote_4xx(pkg):
    a = FakeReplica("a")
    a.fail_with = urllib.error.HTTPError("http://x.invalid", 400, "bad request",
                                         Message(), io.BytesIO(b""))
    r = _router(pkg, [a])
    return [_stream_texts(pkg, list(r.stream_chat(_chat(), {}))), r._state["a"].fails]


def sc_stream_resurrects_fake(pkg):
    """A replica whose stream ends after two content frames (no finish)
    resurrects on the survivor with the delivered ids teacher-forced; the
    replayed prefix is suppressed."""
    fei = {"toks": [5, 6], "key": [1, 2]}
    a, b = FakeReplica("a"), FakeReplica("b", queue_depth=5)
    a.stream_frames = _frames({"id": "x", "choices": [{"delta": {"role": "assistant"}}]},
                              {"id": "x", "choices": [{"delta": {"content": "ab"}}], "fei": fei},
                              {"id": "x", "choices": [{"delta": {"content": "c"}}],
                               "fei": {"toks": [7], "key": [3, 4]}}, done=False)
    b.stream_frames = _frames({"id": "y", "choices": [{"delta": {"role": "assistant"}}]},
                              {"id": "y", "choices": [{"delta": {"content": "abcd"}}]},
                              {"id": "y", "choices": [{"delta": {}, "finish_reason": "stop"}]})
    chunks = list(_router(pkg, [a, b]).stream_chat(_chat(), {}))
    resumed = [c[2].get("resume") for c in b.calls if c[0] == "STREAM"]
    return [[pkg.parse_sse(c) for c in chunks], resumed]


def sc_parse_sse(pkg):
    return [pkg.parse_sse(b"data: [DONE]\n\n"), pkg.parse_sse(b": comment\n\n"),
            pkg.parse_sse(b'data: {"a": 1}\n\n'), pkg.parse_sse(b"data: not json\n\n")]


def sc_health_and_status(pkg):
    a, b = FakeReplica("a"), FakeReplica("b")
    r = _router(pkg, [a, b])
    out = [r.handle("GET", "/health", {}, {}), r.handle("GET", "/fleet/status", {}, {})]
    a.health_status, a.health = 503, {"status": "unhealthy"}
    b.health_status, b.health = 503, {"status": "unhealthy"}
    out.append(r.handle("GET", "/health", {}, {}))
    return out


def sc_rolling_restart(pkg):
    a, b = FakeReplica("a"), FakeReplica("b")
    r = _router(pkg, [a, b])
    r._state["a"].fails = 99
    r._state["a"].ejected_until = time.monotonic() + 999
    report = r.rolling_restart(drain_deadline_s=3.0, wait_s=1.0)
    return [report, [(x.drained, x.restarted) for x in (a, b)],
            [c[2] for c in a.calls if c[1] == "/drain"],
            r._state["a"].fails, r._state["a"].ejected_until]


def sc_rolling_restart_unhealthy_comeback(pkg):
    a = FakeReplica("a")

    def never_back(method, path, body=None, headers=None):
        if path == "/health":
            return 503, {"status": "unhealthy"}, {}
        return 202, {"status": "draining"}, {}

    a.request = never_back
    return _router(pkg, [a]).rolling_restart(wait_s=0.1)


def sc_rolling_restart_refuses_http(pkg):
    a = FakeReplica("a")
    h = pkg.HttpReplica("h", "http://127.0.0.1:9")
    r = _router(pkg, [a, h])
    try:
        r.rolling_restart(wait_s=0.1)
        raised = None
    except Exception as exc:  # noqa: BLE001
        raised = ("nothing was drained" in str(exc), type(exc).__name__)
    return [raised, a.drained, r._state["a"].draining, r._state["h"].draining]


def sc_rolling_restart_failure_continues(pkg):
    a, b = FakeReplica("a"), FakeReplica("b")

    def boom():
        raise RuntimeError("factory died")

    a.restart = boom
    report = _router(pkg, [a, b]).rolling_restart(wait_s=0.2)
    return [report, b.restarted]


def sc_rolling_restart_boot_probes(pkg):
    a = FakeReplica("a")
    orig = a.request
    state = {"bad": 0}

    def scripted(method, path, body=None, headers=None):
        if path == "/health" and a.restarted and state["bad"] < 3:
            state["bad"] += 1
            return 503, {"status": "unhealthy"}, {}
        return orig(method, path, body, headers)

    a.request = scripted
    r = _router(pkg, [a], breaker_fails=2, breaker_cooldown_s=60.0)
    report = r.rolling_restart(wait_s=2.0)
    return [report, r._state["a"].fails, r._state["a"].ejected_until, r._usable("a")]


def sc_http_helpers(pkg):
    rep = pkg.HttpReplica("r9", "http://127.0.0.1:9")
    try:
        rep.restart()
        msg = None
    except Exception as exc:  # noqa: BLE001
        msg = "supervisor" in str(exc)
    return [pkg.json_or_text(b'{"a": 1}'), pkg.json_or_text(b""),
            pkg.json_or_text(b"[1, 2]"), pkg.json_or_text(b"\xff\xfenot json"),
            msg, rep.wait_drained(1.0), rep.can_restart]


# -- role split and the KV control plane over scripted replicas ------------


class _RoleStub:
    """Scripted replica with a role on /health and canned kv endpoints."""

    def __init__(self, rid, role="mixed", queue_depth=0,
                 export=(404, {"error": {"message": "no cached prefix"}}, {}),
                 kv_import=(200, {"pages": 3}, {}), fingerprint=None):
        self.rid, self.role, self.queue_depth = rid, role, queue_depth
        self.calls: list = []
        self._export, self._import, self.fingerprint = export, kv_import, fingerprint

    def request(self, method, path, body=None, headers=None):
        self.calls.append((method, path, dict(body or {})))
        if path == "/health":
            out = {"status": "ok", "queue_depth": self.queue_depth, "running": 0,
                   "slots": 4, "role": self.role}
            if self.fingerprint is not None:
                out["kv_fingerprint"] = self.fingerprint
            return 200, out, {}
        if path == "/kv/export":
            return self._export
        if path == "/kv/import":
            return self._import
        return 200, {"id": self.rid, "choices": []}, {}

    def paths(self) -> list:
        return [p for _, p, _ in self.calls if p != "/health"]


LONG = "x" * 4096  # 1024 estimated tokens: past the 512 threshold


def sc_role_long_prefers_prefill(pkg):
    pf = _RoleStub("pf", role="prefill-heavy", queue_depth=3)
    dec = _RoleStub("dec", role="decode-heavy", queue_depth=0)
    out = _post(_router(pkg, [pf, dec]), {"messages": [{"role": "user", "content": LONG}]})
    return [out, pf.paths(), dec.paths()]


def sc_role_short_avoids_prefill(pkg):
    pf = _RoleStub("pf", role="prefill-heavy", queue_depth=0)
    dec = _RoleStub("dec", role="decode-heavy", queue_depth=3)
    out = _post(_router(pkg, [pf, dec]), {"messages": [{"role": "user", "content": "hi"}]})
    return [out, pf.paths(), dec.paths()]


def sc_role_all_mixed(pkg):
    a, b = _RoleStub("a"), _RoleStub("b", queue_depth=3)
    return _post(_router(pkg, [a, b]), {"messages": [{"role": "user", "content": LONG}]})


def sc_role_handoff_repins(pkg):
    pf = _RoleStub("pf", role="prefill-heavy",
                   export=(200, {"blob": "b3BhcXVl", "bytes": 6}, {}))
    dec = _RoleStub("dec", role="decode-heavy")
    r = _router(pkg, [pf, dec])
    out = [_post(r, {"messages": [{"role": "user", "content": LONG}], "session": "s1"})]
    out.append(_post(r, {"messages": [{"role": "user", "content": "hi"}], "session": "s1"}))
    return out + [pf.paths(), dec.paths(), [b for _, p, b in dec.calls if p == "/kv/import"]]


def sc_role_handoff_best_effort(pkg):
    pf = _RoleStub("pf", role="prefill-heavy", export=(500, {"error": {"message": "boom"}}, {}))
    dec = _RoleStub("dec", role="decode-heavy")
    return _post(_router(pkg, [pf, dec]),
                 {"messages": [{"role": "user", "content": LONG}], "session": "s2"})


def sc_migration_geometry_skips(pkg):
    pf = _RoleStub("pf", role="prefill-heavy", fingerprint={"page_size": 16},
                   export=(200, {"blob": "b3BhcXVl"}, {}))
    dec = _RoleStub("dec", role="decode-heavy", fingerprint={"page_size": 64})
    out = _post(_router(pkg, [pf, dec]),
                {"messages": [{"role": "user", "content": LONG}], "session": "s3"})
    return [out, dec.paths()]


class _CdnStub:
    """Scripted replica: /health + canned /kv/prefix control plane."""

    def __init__(self, rid, hashes=(), want=(), queue_depth=0, blob="QkxPQg==",
                 get_status=200, push_status=200):
        self.rid, self.hashes, self.want = rid, list(hashes), list(want)
        self.queue_depth, self.blob = queue_depth, blob
        self.get_status, self.push_status = get_status, push_status
        self.calls: list = []

    def request(self, method, path, body=None, headers=None):
        self.calls.append((method, path, dict(body or {})))
        if path == "/health":
            return 200, {"status": "ok", "queue_depth": self.queue_depth,
                         "running": 0, "slots": 4, "role": "mixed"}, {}
        if path == "/kv/prefix" and method == "GET":
            return 200, {"hashes": list(self.hashes)}, {}
        if path == "/kv/prefix" and method == "POST":
            if self.push_status == 200:
                self.hashes.insert(0, (body or {}).get("hash"))
            return self.push_status, {"stored": True}, {}
        if path == "/kv/prefix/probe":
            return 200, {"hashes": list(self.want),
                         "have": [h for h in self.want if h in self.hashes]}, {}
        if path.startswith("/kv/prefix/"):
            return self.get_status, {"blob": self.blob}, {}
        if path == "/kv/export":
            return 404, {"error": {"message": "no cached prefix"}}, {}
        return 200, {"id": self.rid, "choices": []}, {}

    def pushes(self) -> list:
        return [b for m, p, b in self.calls if p == "/kv/prefix" and m == "POST"]


H1, H2, H3 = ("cas:" + c * 32 for c in ("11", "22", "33"))


def _session(s):
    return {"messages": [{"role": "user", "content": "hello"}], "session": s}


def sc_cdn_cold_session_pulls(pkg):
    dst = _CdnStub("dst", want=[H1], queue_depth=0)
    peer = _CdnStub("peer", hashes=[H1], queue_depth=3)
    out = _post(_router(pkg, [dst, peer]), _session("cold-1"))
    return [out, dst.pushes()]


def sc_cdn_warm_session_skips_probe(pkg):
    dst = _CdnStub("dst", want=[H1], queue_depth=0)
    peer = _CdnStub("peer", hashes=[H1], queue_depth=3)
    r = _router(pkg, [dst, peer])
    _post(r, _session("warm-1"))
    _post(r, _session("warm-1"))
    return [p for _, p, _ in dst.calls if p != "/health"]


def sc_cdn_local_and_failures(pkg):
    dst = _CdnStub("dst", want=[H1], hashes=[H1])
    peer = _CdnStub("peer", hashes=[H1], queue_depth=3)
    out = [_post(_router(pkg, [dst, peer]), _session("cold-2")), dst.pushes()]
    dst = _CdnStub("dst", want=[H1])
    peer = _CdnStub("peer", hashes=[H1], queue_depth=3, get_status=500)
    out += [_post(_router(pkg, [dst, peer]), _session("cold-3")), dst.pushes()]
    return out


def sc_cdn_prewarm(pkg):
    a, b = _CdnStub("a", hashes=[H1, H2]), _CdnStub("b", hashes=[H2, H3])
    target = _CdnStub("t", hashes=[H3])
    r = _router(pkg, [a, b, target])
    out = [r.prewarm("t"), sorted(p["hash"] for p in target.pushes())]
    failing = _CdnStub("f", push_status=500)
    out.append(_router(pkg, [a, failing]).prewarm("f"))
    return out


SCENARIOS = {name[3:]: fn for name, fn in sorted(globals().items()) if name.startswith("sc_")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_router_scenario_matches_reference(name):
    """The same scripted fleet through both routers: equal answers, frames,
    replica calls and counter deltas."""
    got = {}
    for label, pkg in PKGS.items():
        before = _counts(pkg)
        out = SCENARIOS[name](pkg)
        got[label] = {"out": out, "counters": _delta(before, _counts(pkg))}
    assert got["fei_tpu_torch"] == got["fei_tpu"]


def test_router_needs_unique_replicas():
    from fei_tpu_torch.utils.errors import EngineError

    with pytest.raises(EngineError):
        torch_fleet.Router([])
    with pytest.raises(EngineError):
        torch_fleet.Router([FakeReplica("a"), FakeReplica("a")])


def test_fault_points_arm_from_the_environment(monkeypatch):
    """The router's points and kinds arm from FEI_TPU_FAULT as the
    reference's do (they were logged and skipped before the fleet)."""
    monkeypatch.setenv("FEI_TPU_FAULT",
                       "router.forward:conn:3,replica.health:http503,router.forward:hang")
    ours, theirs = torch_faults.FaultInjector(), jax_faults.FaultInjector()
    assert ({p: (f.kind, f.count) for p, f in ours._armed.items()}
            == {p: (f.kind, f.count) for p, f in theirs._armed.items()}
            == {"router.forward": ("hang", 1), "replica.health": ("http503", 1)})
    with pytest.raises(urllib.error.HTTPError) as err:
        ours.check("replica.health")
    assert err.value.code == 503 and err.value.headers["Retry-After"] == "0"


# -- real port replicas (tiny paged engines on the CPU) ---------------------

MAX_SEQ = 256
GREEDY = {"messages": [{"role": "user", "content": "hello world"}], "max_tokens": 24,
          "temperature": 0}
SEEDED = {"messages": [{"role": "user", "content": "hello world"}], "max_tokens": 24,
          "temperature": 0.9, "seed": 7}


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's tiny fp32 weights and its paged server's SSE
    frames for the greedy and the seeded body."""
    dense = JaxEngine.from_config("tiny", dtype=jnp.float32, max_seq_len=MAX_SEQ, num_layers=2)
    eng = JaxEngine(dense.cfg, dense.params, dense.tokenizer, max_seq_len=MAX_SEQ,
                    dtype=jnp.float32, paged=True, page_size=16, batch_size=2)
    api = JaxServeAPI(JaxLocalProvider(engine=eng), model_name="tiny")
    try:
        frames = {name: list(api.stream_chat(dict(body), api._parse_request(dict(body), {})))
                  for name, body in (("greedy", GREEDY), ("seeded", SEEDED))}
    finally:
        eng.close()
    return dense, frames


@pytest.fixture(scope="module")
def params(jax_ref):
    return params_from_jax(jax.tree.map(np.asarray, jax_ref[0].params))


def _engine(params, **kw):
    return InferenceEngine.from_config(
        "tiny", params=params, paged=True, page_size=kw.pop("page_size", 16),
        batch_size=kw.pop("batch_size", 2), device="cpu", dtype=torch.float32,
        max_seq_len=MAX_SEQ, num_layers=2, **kw)


def _api(params, role=None, **kw) -> ServeAPI:
    return ServeAPI(TorchLocalProvider(engine=_engine(params, **kw)), model_name="tiny",
                    role=role)


def _infos(frames) -> list[dict]:
    return [i for f in frames if (i := torch_router._parse_sse(f))]


def _content(frames) -> str:
    return "".join((i.get("choices") or [{}])[0].get("delta", {}).get("content") or ""
                   for i in _infos(frames) if not i.get("error"))


def _fei(frames) -> list:
    return [i["fei"] for i in _infos(frames) if "fei" in i]


@pytest.mark.parametrize("name", ["greedy", "seeded"])
def test_sse_fei_frames_equal_the_reference(jax_ref, params, name):
    """Each content frame's ``fei`` extension — the ids delivered since the
    last frame and the threefry key after them — is the reference's."""
    body = GREEDY if name == "greedy" else SEEDED
    api = _api(params)
    try:
        frames = list(api.stream_chat(dict(body), api._parse_request(dict(body), {})))
    finally:
        api.provider.engine.close()
    ref = jax_ref[1][name]
    assert _content(frames) == _content(ref) and _content(frames)
    ours, theirs = _fei(frames), _fei(ref)
    assert [t for f in ours for t in f["toks"]]  # ids flowed
    if name == "seeded":
        assert ours == theirs
    else:
        # a greedy slot's key never advances in the port (ROADMAP F3: the
        # reference splits every slot's key every step); greedy output does
        # not read it, and a resurrection re-installs PRNGKey(seed)
        assert [f["toks"] for f in ours] == [f["toks"] for f in theirs]
        assert {tuple(f["key"]) for f in ours} == {(0, 0)}


def test_health_of_a_parked_scheduler_equals_the_reference(jax_ref, params, monkeypatch):
    """F6: the same parked state in both packages — one running slot, one
    finished slot not yet evicted, one queued request — gives the same
    /health: keys, ``running`` without the finished slot, ``role`` from
    FEI_TPU_REPLICA_ROLE, ``mesh``, and the draining and degraded answers
    (503 with and without Retry-After)."""
    dense = jax_ref[0]
    jeng = JaxEngine(dense.cfg, dense.params, dense.tokenizer, max_seq_len=MAX_SEQ,
                     dtype=jnp.float32, paged=True, page_size=16, batch_size=2)
    peng = _engine(params)
    monkeypatch.setenv("FEI_TPU_REPLICA_ROLE", "decode-heavy")
    apis = {"jax": JaxServeAPI(JaxLocalProvider(engine=jeng), model_name="tiny"),
            "torch": ServeAPI(TorchLocalProvider(engine=peng), model_name="tiny")}
    try:
        for eng in (jeng, peng):
            sched = eng.scheduler
            sched._start_thread = lambda: None  # parked: nothing admits
            running, done, queued = (types.SimpleNamespace(finished=f) for f in
                                     (False, True, False))
            sched._slots[0], sched._slots[1] = running, done
            sched._waiting.append(queued)
        got = {k: api.handle("GET", "/health", {}, {}) for k, api in apis.items()}
        assert got["torch"] == got["jax"]
        status, body = got["torch"][:2]
        assert status == 200 and body["running"] == 1 and body["queue_depth"] == 1
        assert body["slots"] == 2 and body["role"] == "decode-heavy" and body["mesh"] == "ms1"
        for eng in (jeng, peng):
            eng.scheduler._degraded_until = float("inf")
        got = {k: api.handle("GET", "/health", {}, {}) for k, api in apis.items()}
        assert got["torch"] == got["jax"] and got["torch"][0] == 503 and len(got["torch"]) == 2
        for eng in (jeng, peng):
            eng.scheduler._degraded_until = 0.0
            eng.scheduler._draining = True
        got = {k: api.handle("GET", "/health", {}, {}) for k, api in apis.items()}
        assert got["torch"] == got["jax"] and got["torch"][2] == {"Retry-After": "5"}
        with pytest.raises(ValueError):
            ServeAPI(TorchLocalProvider(engine=peng), role="gpu-rich")
    finally:
        for eng in (jeng, peng):
            sched = eng.scheduler
            sched._slots[0] = sched._slots[1] = None
            sched._waiting.clear()
            sched._draining = False
            eng.close()


def test_a_chunk_padded_past_the_table_matches_the_reference(jax_ref, params):
    """A chunked admission whose padded last chunk runs past the block
    table (a 40-id prompt, chunks of 32, a 48-position table: positions
    32..63) clamps its rope positions as the JAX gather does; the port used
    to raise IndexError there (hit by a prefix-hit route near
    max_seq_len)."""
    from fei_tpu.engine.engine import GenerationConfig as JaxGen
    from fei_tpu_torch.engine.engine import GenerationConfig

    dense = jax_ref[0]
    prompt = list(range(11, 51))
    jeng = JaxEngine(dense.cfg, dense.params, dense.tokenizer, max_seq_len=48,
                     dtype=jnp.float32, paged=True, page_size=16, batch_size=2)
    peng = InferenceEngine.from_config(
        "tiny", params=params, paged=True, page_size=16, batch_size=2, device="cpu",
        dtype=torch.float32, max_seq_len=48, num_layers=2)
    try:
        for eng in (jeng, peng):
            eng.scheduler.prefill_chunk = 32
        want = list(jeng.scheduler.stream(prompt, JaxGen(max_new_tokens=6, ignore_eos=True)))
        got = list(peng.scheduler.stream(prompt, GenerationConfig(max_new_tokens=6,
                                                                   ignore_eos=True)))
    finally:
        jeng.close()
        peng.close()
    assert got == want and len(got) == 6


class _KillerReplica:
    """While armed, the wrapped replica's next stream drops its transport
    after ``after`` content frames — a kill -9 seen from the router."""

    def __init__(self, inner, after: int = 2):
        self.inner, self.after, self.armed = inner, after, True

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def stream(self, body, headers=None):
        gen = self.inner.stream(body, headers)
        if not self.armed:
            return gen
        self.armed = False

        def killed():
            n = 0
            for f in gen:
                yield f
                d = ((torch_router._parse_sse(f) or {}).get("choices") or [{}])[0]
                if (d.get("delta") or {}).get("content"):
                    n += 1
                    if n >= self.after:
                        raise ConnectionError("replica died mid-stream")
        return killed()


def _close(*apis):
    for api in apis:
        api.provider.engine.close()


@pytest.mark.parametrize("name", ["greedy", "seeded"])
def test_resurrected_stream_equals_uninterrupted_and_reference(jax_ref, params, name):
    """A stream whose replica dies after tokens flowed continues on the
    survivor: the same bytes as the uninterrupted stream and as the
    reference's, one stream id, one resurrection."""
    body = GREEDY if name == "greedy" else SEEDED
    solo = _api(params)
    try:
        ref = _content(solo.stream_chat(dict(body), solo._parse_request(dict(body), {})))
    finally:
        _close(solo)
    assert ref and ref == _content(jax_ref[1][name])
    a_api, b_api = _api(params), _api(params)
    a = _KillerReplica(torch_fleet.InProcessReplica("a", a_api), after=2)
    b = torch_fleet.InProcessReplica("b", b_api)
    router = torch_fleet.Router([a, b], retries=2, backoff_s=0.0, health_ttl_s=0.0)
    before = _counts(PKGS["fei_tpu_torch"])
    try:
        frames = list(router.stream_chat(dict(body), {}))
    finally:
        _close(a_api, b_api)
    infos = _infos(frames)
    assert not [i for i in infos if i.get("error")]
    assert _content(frames) == ref
    assert len({i["id"] for i in infos if i.get("id")}) == 1
    counts = _delta(before, _counts(PKGS["fei_tpu_torch"]))
    assert counts.get("router.resurrections") == 1


def test_http_replica_streams_and_survives_a_dropped_socket(params, monkeypatch):
    """``HttpReplica`` over a real loopback socket: frames arrive one by one
    while the stream runs, and a replica process that dies mid-stream (the
    socket drops with no [DONE]: the ``replica.crash`` hard kill) is
    resurrected on the in-process survivor, bitwise the uninterrupted
    stream."""
    class _Killed(SystemExit):
        """Escapes the handler like a SIGKILL: no error frame, no [DONE]
        (a SystemExit ends the handler thread quietly)."""

    def kill(point):
        raise _Killed(point)

    monkeypatch.setattr(torch_faults, "_hard_kill", kill)
    hook = threading.excepthook
    monkeypatch.setattr(threading, "excepthook",
                        lambda a: None if a.exc_type is _Killed else hook(a))
    solo = _api(params)
    try:
        ref = _content(solo.stream_chat(dict(SEEDED), solo._parse_request(dict(SEEDED), {})))
    finally:
        _close(solo)
    a_api, b_api = _api(params), _api(params)
    server = ServingServer(a_api, host="127.0.0.1", port=0)
    server.start()
    try:
        a = torch_fleet.HttpReplica("a", f"http://127.0.0.1:{server.port}", timeout_s=60)
        # frames stream as they are written: the first arrives while the
        # request is still decoding
        gen = a.stream(dict(SEEDED), {})
        first = next(gen)
        assert b'"role": "assistant"' in first
        rest = list(gen)
        assert rest[-1] == b"data: [DONE]\n\n" and _content([first, *rest]) == ref
        b = torch_fleet.InProcessReplica("b", b_api)
        router = torch_fleet.Router([a, b], retries=2, backoff_s=0.0, health_ttl_s=0.0)
        torch_faults.FAULTS.arm("replica.crash", "crash", count=3)
        before = _counts(PKGS["fei_tpu_torch"])
        frames = list(router.stream_chat(dict(SEEDED), {}))
        assert torch_faults.FAULTS.fired("replica.crash") == 1
    finally:
        server.stop()
        _close(a_api, b_api)
    assert _content(frames) == ref
    assert not [i for i in _infos(frames) if i.get("error")]
    assert _delta(before, _counts(PKGS["fei_tpu_torch"])).get("router.resurrections") == 1


def _tier_api(params, tmp_path, tag, role=None, monkeypatch=None) -> ServeAPI:
    with monkeypatch.context() as m:
        m.setenv("FEI_TPU_KV_TIER", "disk")
        m.setenv("FEI_TPU_KV_DISK_DIR", str(tmp_path / tag))
        return _api(params, role=role, page_size=4, num_pages=64, prefix_cache=True)


_KV_CHAT = {"messages": [{"role": "user", "content": "kv migration round trip"}],
            "max_tokens": 4, "temperature": 0}


def test_router_hands_a_prefill_off_to_the_decode_replica(params, tmp_path, monkeypatch):
    """A prompt past the prefill threshold lands on the prefill-heavy port
    replica, its KV prefix migrates to the decode-heavy one over /kv, the
    session re-pins there, and the next turn admits as a prefix hit."""
    monkeypatch.setenv("FEI_TPU_ROUTER_PREFILL_TOKENS", "4")
    pf = torch_fleet.InProcessReplica(
        "pf", api=_tier_api(params, tmp_path, "pf", "prefill-heavy", monkeypatch))
    dec = torch_fleet.InProcessReplica(
        "dec", api=_tier_api(params, tmp_path, "dec", "decode-heavy", monkeypatch))
    router = torch_fleet.Router([pf, dec], retries=1, backoff_s=0.0, health_ttl_s=0.0)
    METRICS = torch_metrics.METRICS
    body = dict(_KV_CHAT, session="s1")
    try:
        before = _counts(PKGS["fei_tpu_torch"])
        status, first, _ = router.handle("POST", "/v1/chat/completions", dict(body), {})
        assert status == 200
        moved = _delta(before, _counts(PKGS["fei_tpu_torch"]))
        assert moved.get("router.migrations") == 1 and moved.get("router.role_routed") == 1
        hits = METRICS.snapshot()["counters"].get("prefix.hits", 0)
        status, second, _ = router.handle("POST", "/v1/chat/completions", dict(body), {})
        assert status == 200
        assert second["choices"][0]["message"] == first["choices"][0]["message"]
        assert METRICS.snapshot()["counters"].get("prefix.hits", 0) > hits
        assert _delta(before, _counts(PKGS["fei_tpu_torch"])).get("router.affinity_hits") == 1
    finally:
        pf.engine.close()
        dec.engine.close()


def test_router_fetches_a_cold_prefix_and_prewarms(params, tmp_path, monkeypatch):
    """A session no replica remembers lands on ``b`` while only ``a``
    holds its prefix: the router pulls the blob by content hash
    (``kv.prefix_hits_remote``) and ``b`` admits through it; ``prewarm``
    pushes ``a``'s hottest prefixes into a fresh replica."""
    a = torch_fleet.InProcessReplica("a", api=_tier_api(params, tmp_path, "a",
                                                        monkeypatch=monkeypatch))
    b = torch_fleet.InProcessReplica("b", api=_tier_api(params, tmp_path, "b",
                                                        monkeypatch=monkeypatch))
    c = torch_fleet.InProcessReplica("c", api=_tier_api(params, tmp_path, "c",
                                                        monkeypatch=monkeypatch))
    METRICS = torch_metrics.METRICS
    try:
        status, ref, _ = a.request("POST", "/v1/chat/completions", dict(_KV_CHAT), {})
        assert status == 200 and a.request("GET", "/kv/prefix", None, {})[1]["hashes"]
        router = torch_fleet.Router([b, a], retries=1, backoff_s=0.0, health_ttl_s=0.0)
        before = _counts(PKGS["fei_tpu_torch"])
        tier0 = METRICS.snapshot()["counters"].get("kv.prefix_hits_tier", 0)
        status, out, _ = router.handle("POST", "/v1/chat/completions",
                                       dict(_KV_CHAT, session="cold"), {})
        assert status == 200 and out["choices"][0]["message"] == ref["choices"][0]["message"]
        assert _delta(before, _counts(PKGS["fei_tpu_torch"])).get("kv.prefix_hits_remote") == 1
        assert METRICS.snapshot()["counters"].get("kv.prefix_hits_tier", 0) > tier0
        pushed = torch_fleet.Router([a, c], retries=1, backoff_s=0.0,
                                    health_ttl_s=0.0).prewarm("c")
        assert pushed >= 1
        assert set(c.request("GET", "/kv/prefix", None, {})[1]["hashes"]) <= set(
            a.request("GET", "/kv/prefix", None, {})[1]["hashes"])
    finally:
        for r in (a, b, c):
            r.engine.close()


def test_rolling_restart_of_port_replicas_loses_nothing(params, tmp_path):
    """Drain → warm restart of each in-process port replica in turn while a
    stream is in flight: the drained request snapshots, the restarted
    engine re-admits it, and the router keeps serving."""
    made: list = []

    def factory():
        api = _api(params)
        made.append(api)
        return api

    a = torch_fleet.InProcessReplica("a", factory=factory, drain_dir=str(tmp_path / "a"))
    b = torch_fleet.InProcessReplica("b", factory=factory, drain_dir=str(tmp_path / "b"))
    router = torch_fleet.Router([a, b], retries=2, backoff_s=0.0, health_ttl_s=0.0)
    try:
        report = router.rolling_restart(drain_deadline_s=0.2, wait_s=30.0)
        assert {k: v["healthy"] for k, v in report.items()} == {"a": True, "b": True}
        status, out, _ = router.handle("POST", "/v1/chat/completions", dict(GREEDY), {})
        assert status == 200 and out["choices"][0]["message"]["content"]
    finally:
        for api in made:
            api.provider.engine.close()
