"""OpenAI-compatible serving endpoint over the PyTorch engine (counterpart
of fei_tpu/ui/server.py, dense serving routes).

``python -m fei_tpu_torch serve`` exposes the torch_local provider behind
POST /v1/chat/completions (JSON, or SSE with ``"stream": true``), GET
/v1/models, /health and /metrics, and POST /drain. Survival is the JAX
package's: /drain and SIGTERM start a graceful drain (/health answers 503
``draining``, new completions 503 with Retry-After, in-flight requests
finish within the deadline, the rest snapshot to FEI_TPU_DRAIN_DIR), and
at boot ``warm_restart`` re-admits what a drain snapshotted or what the
session journal (FEI_TPU_JOURNAL_DIR) recorded as unfinished. A
completion body may carry ``"resume": {"generated": [...], "resume_key":
[hi, lo]}`` to teach-force a delivered suffix (paged engines).

The KV control plane (paged engines; the blobs are the JAX package's FKV1
bytes, base64 in JSON): POST /kv/export (a prompt's cached prefix as a
blob; 404 when nothing is cached), POST /kv/import (scatter one into the
pool), GET /kv/prefix (the content hashes the KV tier can serve), POST
/kv/prefix (push a content-addressed blob into the tier), POST
/kv/prefix/probe (the hashes a prompt would admit through) and GET
/kv/prefix/<hash>. A blob that is not base64 answers 400, one whose
invariant pool geometry can never match 409 with ``{ours, theirs}``, a
corrupt one 422. /health carries the reference's fields: ``mesh``
(the engine's tag: ``ms1`` for one device, ``tp2``, ``tp2dp2``), ``role`` (``FEI_TPU_REPLICA_ROLE``, one of
``REPLICA_ROLES``, read by the fleet router), ``queue_depth``/``running``
/``slots`` (paged engines), ``kv_fingerprint`` and ``kv_layout``.

Observability: GET /v1/traces?limit= (recent request traces, newest
first; limit clamped to 1–1000), GET /v1/traces/<id> (one trace with its
slice of the flight recorder), GET /debug/timeline (the flight recorder as
Chrome-trace JSON, for ui.perfetto.dev) and POST /debug/profile
(``seconds`` in (0, 60]: a torch.profiler capture of the card's kernels
under live traffic, written as Chrome-trace JSON into ``trace_dir``, and
the flight recorder's ranges of the same seconds beside it in
``ranges.json``, on the same timeline; 409 while another capture runs in
the process). A streamed completion's content frames carry
an ``fei`` extension (the token ids delivered since the last frame and
the threefry key after them) so the fleet router can resurrect the stream
on another replica.
Built on stdlib http.server. Auth is optional (``--api-key`` /
FEI_TPU_SERVER_API_KEY).
"""

from __future__ import annotations

import argparse
import base64
import binascii
import hmac
import json
import os
import tempfile
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from fei_tpu_torch.engine.faults import FAULTS
from fei_tpu_torch.obs.flight import FLIGHT
from fei_tpu_torch.obs.trace import TRACES
from fei_tpu_torch.utils.errors import (
    DeadlineExceededError,
    EngineDegradedError,
    EngineDrainingError,
    KVGeometryError,
    KVTierError,
    QueueFullError,
)
from fei_tpu_torch.utils.logging import get_logger
from fei_tpu_torch.utils.metrics import METRICS

log = get_logger("ui.server")

DEFAULT_PORT = 8188

# fleet role split: a prefill-heavy replica takes the long prompts, a
# decode-heavy one the token streams, mixed does both. The router reads the
# role off /health and hands the prefilled KV across (/kv/export ->
# /kv/import).
REPLICA_ROLES = ("mixed", "prefill-heavy", "decode-heavy")

# one torch.profiler capture per process at a time: a second POST gets 409
_PROFILE_LOCK = threading.Lock()


def _content_text(content) -> str:
    """OpenAI content is a string or a parts array; extract the text."""
    if isinstance(content, list):
        return "".join(
            p.get("text", "") for p in content
            if isinstance(p, dict) and p.get("type", "text") == "text"
        )
    return str(content or "")


def _from_openai_messages(raw: list[dict]) -> tuple[list[dict], str | None]:
    """OpenAI wire messages -> (internal messages, system prompt)."""
    if not isinstance(raw, list):
        raise ValueError("messages must be a list of message objects")
    msgs: list[dict] = []
    system_parts: list[str] = []
    for m in raw:
        if not isinstance(m, dict):
            raise ValueError(
                f"each message must be an object, got {type(m).__name__}"
            )
        role = m.get("role", "user")
        if role == "system":
            system_parts.append(_content_text(m.get("content")))
        elif role == "assistant" and m.get("tool_calls"):
            msgs.append({
                "role": "assistant",
                "content": m.get("content") or "",
                "tool_calls": [
                    {
                        "id": c.get("id", ""),
                        "name": c.get("function", {}).get("name", ""),
                        "arguments": json.loads(
                            c.get("function", {}).get("arguments") or "{}"
                        ),
                    }
                    for c in m["tool_calls"]
                ],
            })
        elif role == "tool":
            msgs.append({
                "role": "tool",
                "tool_call_id": m.get("tool_call_id", ""),
                "content": _content_text(m.get("content")),
            })
        else:
            msgs.append({"role": role, "content": _content_text(m.get("content"))})
    return msgs, ("\n\n".join(system_parts) or None)


def _from_openai_tools(raw: list[dict] | None) -> list[dict] | None:
    if not raw:
        return None
    out = []
    for t in raw:
        fn = t.get("function", t)
        out.append({
            "name": fn.get("name", ""),
            "description": fn.get("description", ""),
            "input_schema": fn.get("parameters", {}),
        })
    return out


def _gen_overrides(body: dict, headers: dict | None = None) -> dict:
    """Explicit JSON null means 'use the default' per the OpenAI spec
    (several SDKs serialize unset fields as null). ``headers`` carries
    the fleet extensions: ``X-FEI-Tenant`` / ``X-FEI-Priority`` (QoS
    labels, body fields win) and ``X-FEI-Deadline-S`` — the client's
    REMAINING deadline as propagated by the fleet router, folded in as a
    min() so a retry hop can only ever shrink the request's budget,
    never extend it."""
    over: dict = {}
    h = {str(k).lower(): v for k, v in (headers or {}).items()}
    if body.get("temperature") is not None:
        over["temperature"] = float(body["temperature"])
    if body.get("top_p") is not None:
        over["top_p"] = float(body["top_p"])
    if body.get("top_k") is not None:  # non-OpenAI extension
        over["top_k"] = int(body["top_k"])
    if body.get("min_p") is not None:  # non-OpenAI extension (vLLM-style)
        over["min_p"] = min(max(float(body["min_p"]), 0.0), 1.0)
    if body.get("seed") is not None:
        over["seed"] = int(body["seed"])
    if body.get("ignore_eos") is not None:
        # non-OpenAI extension (vLLM-style): decode the full max_tokens
        # budget — benches and the chaos crash smoke need streams long
        # enough to kill mid-flight regardless of what the model samples
        over["ignore_eos"] = bool(body["ignore_eos"])
    deadlines = []
    if body.get("deadline_s") is not None:  # non-OpenAI extension
        dl = max(0.0, float(body["deadline_s"]))
        if dl > 0:
            deadlines.append(dl)
    hd = h.get("x-fei-deadline-s")
    if hd is not None:
        try:
            # a propagated remaining budget of <= 0 means the client's
            # deadline already passed in flight; clamp to an epsilon so
            # the scheduler sheds it instead of treating 0 as "none"
            deadlines.append(max(1e-3, float(hd)))
        except (TypeError, ValueError):
            pass
    if deadlines:
        over["deadline_s"] = min(deadlines)
    tenant = body.get("tenant") or h.get("x-fei-tenant")
    if tenant:  # non-OpenAI extension (multi-tenant QoS)
        over["tenant"] = str(tenant)
    priority = body.get("priority")
    if priority is None:
        priority = h.get("x-fei-priority")
    if priority is not None:
        try:
            over["priority"] = int(priority)
        except (TypeError, ValueError):
            pass
    return over


def _to_openai_response(resp, model: str, rid: str) -> dict:
    msg: dict = {"role": "assistant", "content": resp.content}
    finish = "stop"
    if resp.tool_calls:
        msg["tool_calls"] = [
            {
                "id": c.id,
                "type": "function",
                "function": {"name": c.name, "arguments": json.dumps(c.arguments)},
            }
            for c in resp.tool_calls
        ]
        finish = "tool_calls"
    usage = resp.usage or {}
    pt = int(usage.get("prompt_tokens", 0))
    ct = int(usage.get("completion_tokens", 0))
    return {
        "id": rid,
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{"index": 0, "message": msg, "finish_reason": finish}],
        "usage": {
            "prompt_tokens": pt,
            "completion_tokens": ct,
            "total_tokens": pt + ct,
        },
    }


class ServeAPI:
    """Socket-free core so tests can drive it directly. ``provider`` is an
    agent-layer Provider (TorchLocalProvider; MockProvider in tests)."""

    def __init__(self, provider, model_name: str = "fei-tpu-torch",
                 api_key: str | None = None, role: str | None = None):
        self.provider = provider
        self.model_name = model_name
        self.api_key = api_key or ""
        role = role or os.environ.get("FEI_TPU_REPLICA_ROLE", "") or "mixed"
        if role not in REPLICA_ROLES:
            raise ValueError(
                f"replica role must be one of {REPLICA_ROLES}, got {role!r}")
        self.role = role
        self._profile_lock = _PROFILE_LOCK

    def authorized(self, headers: dict) -> bool:
        if not self.api_key:
            return True
        provided = ""
        for k, v in headers.items():
            if k.lower() == "authorization":
                provided = v.strip()
                if provided[:7].lower() == "bearer ":  # RFC 7235 §2.1
                    provided = provided[7:].strip()
                break
        # bytes comparison: compare_digest raises on non-ASCII str input
        return hmac.compare_digest(
            provided.encode("utf-8"), self.api_key.encode("utf-8")
        )

    def handle(self, method: str, path: str, body: dict, headers: dict) -> tuple:
        """Route a request. Returns ``(status, payload)`` or ``(status,
        payload, headers)``; a ``str`` payload is plain text (the Prometheus
        exposition), dicts are JSON."""
        parts = urlsplit(path)
        route, query = parts.path, parse_qs(parts.query)
        METRICS.incr("server.requests")
        if route == "/health":
            base = {"model": self.model_name, "mesh": self._mesh_tag(), "role": self.role,
                    **self._kv_geometry(), **self._load_fields()}
            sched = self._kv_scheduler()
            if sched is not None and sched.draining():
                # a draining replica leaves the load balancer's rotation
                # while its in-flight set finishes
                return 503, {"status": "draining", **base}, {"Retry-After": "5"}
            if sched is not None and sched.degraded():
                # the crash-loop breaker: balancers eject the replica
                return 503, {"status": "degraded", **base}
            return 200, {"status": "ok", **base}
        if route == "/metrics" and method == "GET":
            # pre-auth like /health: scrapers don't carry bearer tokens
            return 200, METRICS.prometheus_text()
        if not self.authorized(headers):
            return 401, {"error": {"message": "invalid or missing API key",
                                   "type": "authentication_error"}}
        if route == "/v1/models" and method == "GET":
            return 200, {
                "object": "list",
                "data": [{"id": self.model_name, "object": "model",
                          "owned_by": "fei-tpu-torch"}],
            }
        if route == "/v1/traces" and method == "GET":
            try:
                limit = int(query.get("limit", ["50"])[0])
            except ValueError:
                return _bad_request("limit must be an int")
            limit = min(max(limit, 1), 1000)
            return 200, {"object": "list", "data": TRACES.recent(limit)}
        if route.startswith("/v1/traces/") and method == "GET":
            rid = route.rsplit("/", 1)[1]
            tr = TRACES.get(rid)
            if tr is None:
                return 404, {"error": {"message": f"no trace {rid!r} (unknown or evicted)",
                                       "type": "invalid_request_error"}}
            payload = tr.as_dict()
            # the request's slice of the flight recorder: every dispatch and
            # scheduler event tagged with this rid
            payload["flight"] = FLIGHT.for_rid(rid)
            return 200, payload
        if route == "/debug/timeline" and method == "GET":
            return 200, FLIGHT.chrome_trace()
        if route == "/debug/profile" and method == "POST":
            return self._profile(body)
        if route == "/v1/chat/completions" and method == "POST":
            return self._chat(body, headers)
        if route == "/drain" and method == "POST":
            return self._drain(body)
        # the KV routes stay routable while draining: migration on drain is
        # exactly when a replica's warm KV must leave
        if route == "/kv/export" and method == "POST":
            return self._kv_export(body)
        if route == "/kv/import" and method == "POST":
            return self._kv_import(body)
        if route == "/kv/prefix" and method == "GET":
            return self._kv_prefix_list()
        if route == "/kv/prefix" and method == "POST":
            return self._kv_prefix_push(body)
        if route == "/kv/prefix/probe" and method == "POST":
            return self._kv_prefix_probe(body)
        if route.startswith("/kv/prefix/") and method == "GET":
            return self._kv_prefix_get(route.rsplit("/", 1)[1])
        return 404, {"error": {"message": f"no route {method} {route}",
                               "type": "invalid_request_error"}}

    def _load_fields(self) -> dict:
        """The /health load fields the fleet router's least-loaded scoring
        reads: waiting-queue depth, running count (finished slots not yet
        evicted excluded), slot count. Empty for non-paged providers (the
        router reads a missing field as 0)."""
        sched = self._kv_scheduler()
        if sched is None:
            return {}
        try:
            with sched._lock:
                slots = list(sched._slots)
                depth = len(sched._waiting)
            running = sum(1 for s in slots if s is not None and not s.finished)
            return {"queue_depth": depth, "running": running, "slots": len(slots)}
        except Exception:  # noqa: BLE001 — /health must never 500
            return {}

    def _profile(self, body: dict) -> tuple:
        """On-demand torch.profiler capture of the card's kernels for
        ``seconds`` while live traffic keeps flowing (the scheduler launches
        from its own thread; CUPTI records every kernel on the device). The
        trace is Chrome-trace JSON in ``trace_dir``. Only the CUDA activity
        is recorded where there is a card: with CPU ops recorded from this
        handler's thread while the scheduler's threads dispatched, two of
        three full smoke runs on an H100 died of SIGSEGV; a machine without
        a card records its CPU ops. The profiler starts and stops with the
        schedulers quiesced (``DEVICE_GATE``): a stop while a scheduler
        thread launched kernels also died of SIGSEGV, inside CUPTI's
        teardown. The flight recorder captures its ranges for the same
        seconds; they go beside the trace in ``ranges.json``."""
        try:
            seconds = float(body.get("seconds", 2.0))
        except (TypeError, ValueError):
            return _bad_request("seconds must be a number")
        if not 0 < seconds <= 60:
            return _bad_request(f"seconds must be in (0, 60], got {seconds}")
        if not self._profile_lock.acquire(blocking=False):
            return 409, {"error": {"message": "a profile capture is already running",
                                   "type": "conflict_error"}}
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            from fei_tpu_torch.engine.scheduler import DEVICE_GATE

            trace_dir = str(body.get("trace_dir") or tempfile.mkdtemp(prefix="fei-profile-"))
            os.makedirs(trace_dir, exist_ok=True)
            activities = [ProfilerActivity.CUDA if torch.cuda.is_available()
                          else ProfilerActivity.CPU]
            prof = profile(activities=activities)
            # no scheduler launches a kernel while CUPTI sets up or tears down
            with DEVICE_GATE.quiesce():
                prof.start()
                FLIGHT.follow_profiler(True)
                since = time.time_ns()
            try:
                time.sleep(seconds)
            finally:
                with DEVICE_GATE.quiesce():
                    FLIGHT.follow_profiler(False)
                    prof.stop()
            trace = os.path.join(trace_dir, "trace.json")
            prof.export_chrome_trace(trace)
            self._write_ranges(trace, trace_dir, since)
            METRICS.incr("server.profile_captures")
            return 200, {"object": "profile", "trace_dir": trace_dir, "seconds": seconds}
        except Exception as exc:  # noqa: BLE001 — profiler issues -> JSON
            log.warning("profile capture failed: %r", exc)
            return _server_error(exc)
        finally:
            self._profile_lock.release()

    @staticmethod
    def _write_ranges(trace: str, trace_dir: str, since_ns: int) -> None:
        """The flight recorder's ranges of the capture as Chrome-trace JSON
        in ``ranges.json``, on ``trace.json``'s timeline: the profiler
        writes its events in µs after ``baseTimeNanoseconds`` of the wall
        clock, and the ranges are placed after the same base."""
        with open(trace, encoding="utf-8") as f:
            base = int(json.load(f).get("baseTimeNanoseconds", 0))
        out = {"traceEvents": FLIGHT.chrome_ranges(base, since_ns),
               "displayTimeUnit": "ms", "baseTimeNanoseconds": base,
               "rangesDropped": FLIGHT.ranges_dropped}
        with open(os.path.join(trace_dir, "ranges.json"), "w", encoding="utf-8") as f:
            json.dump(out, f)

    # -- the KV control plane -------------------------------------------------

    def _kv_geometry(self) -> dict:
        """Both halves of the KV pool geometry for /health: the INVARIANT
        fingerprint (which replicas can exchange KV at all) and the shard
        layout (provenance). Empty for dense and non-engine providers."""
        eng = getattr(self.provider, "engine", None)
        try:
            fp = eng.kv_fingerprint() if eng is not None else None
        except Exception:  # noqa: BLE001 — /health must never 500
            return {}
        if fp is None:
            return {}
        return {"kv_fingerprint": fp, "kv_layout": eng.kv_layout()}

    def _mesh_tag(self) -> str:
        """The serving engine's mesh tag ('ms1' for one device or a
        provider without an engine)."""
        return getattr(getattr(self.provider, "engine", None), "mesh_tag", "ms1")

    def _kv_scheduler(self):
        return getattr(getattr(self.provider, "engine", None), "_scheduler", None)

    def _prompt_ids(self, body: dict) -> list[int]:
        """The request's prompt ids, rendered exactly like a completion
        (same chat template, same system folding), so the prefix named is
        the one a later /v1/chat/completions on this body would hit."""
        msgs, system = _from_openai_messages(body.get("messages") or [])
        full = self.provider._messages_with_system(
            msgs, system, _from_openai_tools(body.get("tools")))
        return list(self.provider.engine.tokenizer.apply_chat_template(
            full, add_generation_prompt=True))

    @staticmethod
    def _blob_of(body: dict) -> tuple[bytes | None, tuple | None]:
        """(the decoded ``blob`` field, None) or (None, the 400 answer)."""
        raw = body.get("blob")
        if not isinstance(raw, str) or not raw:
            return None, _bad_request("blob must be a base64 string")
        try:
            return base64.b64decode(raw, validate=True), None
        except (binascii.Error, ValueError):
            return None, _bad_request("blob is not valid base64")

    def _kv_export(self, body: dict) -> tuple:
        """The longest cached KV prefix of this prompt as a portable blob
        (kv/migrate.py). 404 when nothing is cached: the caller re-prefills."""
        sched = self._kv_scheduler()
        if sched is None or not hasattr(self.provider, "_messages_with_system"):
            return 501, {"error": {"message": "kv export needs a paged engine",
                                   "type": "invalid_request_error"}}
        try:
            ids = self._prompt_ids(body)
        except (ValueError, KeyError, TypeError) as exc:
            return _bad_request(str(exc))
        try:
            blob = sched.export_prefix(ids)
        except Exception as exc:  # noqa: BLE001 — answer JSON, never drop
            log.warning("kv export failed: %r", exc)
            return _server_error(exc)
        if blob is None:
            return 404, {"error": {"message": "no cached prefix for this prompt",
                                   "type": "invalid_request_error"}}
        return 200, {"object": "kv.blob", "bytes": len(blob),
                     "blob": base64.b64encode(blob).decode("ascii")}

    def _kv_import(self, body: dict) -> tuple:
        """Scatter a migration blob into this replica's pool: 409 with the
        ``{ours, theirs}`` geometry diff for an invariant-incompatible blob
        (never retryable), 422 for a corrupt one (another copy may be
        fine). ``pages: 0`` when the pool cannot spare room (best effort,
        never preempts)."""
        sched = self._kv_scheduler()
        if sched is None:
            return 501, {"error": {"message": "kv import needs a paged engine",
                                   "type": "invalid_request_error"}}
        blob, bad = self._blob_of(body)
        if bad is not None:
            return bad
        try:
            pages = sched.import_prefix(blob)
        except KVTierError as exc:
            return _kv_refusal(exc)
        except Exception as exc:  # noqa: BLE001
            log.warning("kv import failed: %r", exc)
            return _server_error(exc)
        return 200, {"object": "kv.import", "pages": int(pages)}

    def _kv_tier_store(self):
        return getattr(self._kv_scheduler(), "_kv_tier", None)

    def _kv_prefix_list(self) -> tuple:
        """Content hashes this replica's tier can serve, hottest first (an
        empty list is a healthy answer)."""
        tier = self._kv_tier_store()
        return 200, {"object": "kv.prefix.list",
                     "hashes": [] if tier is None else tier.advertised()}

    def _kv_prefix_get(self, key: str) -> tuple:
        """One content-addressed prefix blob by hash; 404 = not here. A
        tier-side fault (the ``kv.fetch`` point fires here too) answers
        500 JSON."""
        from fei_tpu_torch.kv.tier import pack_entry

        tier = self._kv_tier_store()
        if tier is None:
            return 404, {"error": {"message": "this replica runs without a KV tier",
                                   "type": "invalid_request_error"}}
        try:
            entry = tier.fetch(key)
        except Exception as exc:  # noqa: BLE001
            log.warning("kv prefix fetch %s failed: %r", key, exc)
            return _server_error(exc)
        if entry is None:
            return 404, {"error": {"message": f"no prefix {key!r} in the tier",
                                   "type": "invalid_request_error"}}
        blob = pack_entry(entry)
        return 200, {"object": "kv.blob", "hash": key, "bytes": len(blob),
                     "blob": base64.b64encode(blob).decode("ascii")}

    def _kv_prefix_push(self, body: dict) -> tuple:
        """Land a content-addressed blob in this replica's tier without
        touching the pool (the next admission over those tokens fetches
        it). 409 when its invariant fingerprint can never match this pool,
        422 for a corrupt blob or a key that is not content-addressed;
        ``stored: false`` means the tier already held it."""
        from fei_tpu_torch.kv.content import is_cas_key
        from fei_tpu_torch.kv.pagesio import check_fingerprint
        from fei_tpu_torch.kv.tier import unpack_entry

        tier = self._kv_tier_store()
        if tier is None:
            return 501, {"error": {"message": "kv prefix push needs a KV tier "
                                              "(FEI_TPU_KV_TIER)",
                                   "type": "invalid_request_error"}}
        blob, bad = self._blob_of(body)
        if bad is not None:
            return bad
        try:
            entry, _ = unpack_entry(blob)
            key = body.get("hash") or entry.key
            if not is_cas_key(key) or key != entry.key:
                raise KVTierError("hash does not name a content-addressed prefix blob")
            want = self._kv_geometry().get("kv_fingerprint")
            if want is not None:
                check_fingerprint(want, entry.fingerprint, what="pushed prefix blob")
        except KVTierError as exc:
            return _kv_refusal(exc)
        try:
            stored = tier.put_if_absent(key, entry)
        except Exception as exc:  # noqa: BLE001 — spill faults, disk errors
            log.warning("kv prefix push %s failed: %r", key, exc)
            return _server_error(exc)
        return 200, {"object": "kv.prefix.push", "hash": key,
                     "stored": bool(stored), "bytes": entry.nbytes}

    def _kv_prefix_probe(self, body: dict) -> tuple:
        """Which content hashes this prompt would admit through (longest
        first), and which of them the tier already holds."""
        sched = self._kv_scheduler()
        if sched is None or not hasattr(self.provider, "_messages_with_system"):
            return 501, {"error": {"message": "kv prefix probe needs a paged engine",
                                   "type": "invalid_request_error"}}
        if sched._kv_tier is None or not sched._cas_enabled:
            return 200, {"object": "kv.prefix.probe", "hashes": [], "have": []}
        try:
            ids = self._prompt_ids(body)
        except (ValueError, KeyError, TypeError) as exc:
            return _bad_request(str(exc))
        try:
            st = sched.content_prefix_status(ids)
        except Exception as exc:  # noqa: BLE001
            log.warning("kv prefix probe failed: %r", exc)
            return _server_error(exc)
        return 200, {"object": "kv.prefix.probe", **st}

    def _parse_request(self, body: dict,
                       headers: dict | None = None) -> dict:
        """Decode the request into provider kwargs; raises on bad input
        BEFORE any engine work (the streaming path validates here before
        committing SSE headers)."""
        msgs, system = _from_openai_messages(body.get("messages") or [])
        mt = body.get("max_tokens")
        if mt is None:
            mt = body.get("max_completion_tokens")
        mt = 1024 if mt is None else int(mt)  # 0 is a valid explicit budget
        if mt < 0:
            raise ValueError(f"max_tokens must be >= 0, got {mt}")
        kw = {
            "messages": msgs,
            "system": system,
            "tools": _from_openai_tools(body.get("tools")),
            "max_tokens": mt,
        }
        over = _gen_overrides(body, headers)
        if over and getattr(self.provider, "supports_gen_overrides", False):
            kw["gen_overrides"] = over
        kw.update(self._resume_kw(body))
        return kw

    def _resume_kw(self, body: dict) -> dict:
        """The ``"resume"`` body extension: ``{"generated": [ids...],
        "resume_key": [hi, lo] | null}`` teacher-forces a delivered suffix
        so this stream replays it byte-identically. A provider that cannot
        resume refuses it: restarting from token 0 would duplicate the
        user-visible stream."""
        raw = body.get("resume")
        if raw is None:
            return {}
        if not getattr(self.provider, "supports_resume", False):
            raise ValueError("resume is not supported by this provider")
        if not isinstance(raw, dict):
            raise ValueError("resume must be an object")
        gen = raw.get("generated") or []
        if not isinstance(gen, list):
            raise ValueError("resume.generated must be a list of token ids")
        resume: dict = {"generated": [int(t) for t in gen]}
        key = raw.get("resume_key")
        if key is not None:
            if not isinstance(key, list) or not key:
                raise ValueError("resume.resume_key must be a list of ints")
            resume["resume_key"] = [int(x) for x in key]
        return {"resume": resume}

    def _drain(self, body: dict) -> tuple:
        """Operator-initiated graceful drain, the HTTP twin of SIGTERM:
        stop admitting, finish in-flight requests within the deadline,
        snapshot the rest for a warm restart. Idempotent."""
        try:
            deadline = body.get("deadline_s")
            deadline = None if deadline is None else max(0.0, float(deadline))
        except (TypeError, ValueError):
            return 400, {"error": {"message": "deadline_s must be a number",
                                   "type": "invalid_request_error"}}
        eng = getattr(self.provider, "engine", None)
        sched = getattr(eng, "_scheduler", None)
        if sched is None:
            return 200, {"status": "drained"}  # nothing in flight to drain
        eng.begin_drain(deadline_s=deadline)
        METRICS.incr("server.drains")
        return 202, {"status": "draining",
                     "deadline_s": deadline if deadline is not None else sched.drain_deadline_s}

    def _chat(self, body: dict, headers: dict | None = None) -> tuple:
        try:
            kw = self._parse_request(body, headers)
        except (ValueError, KeyError, TypeError) as exc:
            return 400, {"error": {"message": str(exc),
                                   "type": "invalid_request_error"}}
        try:
            msgs = kw.pop("messages")
            resp = self.provider.complete(msgs, **kw)
        except QueueFullError as exc:
            # backpressure, not failure: tell the client when to come back
            return 429, {"error": {"message": str(exc),
                                   "type": "overloaded_error"}}, _retry_after(exc)
        except (EngineDegradedError, EngineDrainingError) as exc:
            return 503, {"error": {"message": str(exc),
                                   "type": "overloaded_error"}}, _retry_after(exc)
        except DeadlineExceededError as exc:
            return 504, {"error": {"message": str(exc), "type": "timeout_error"}}
        except Exception as exc:  # noqa: BLE001 — surface as JSON, not a
            # dropped socket (EngineError/ProviderError/anything)
            log.warning("completion failed: %r", exc)
            return 500, {"error": {"message": f"{type(exc).__name__}: {exc}",
                                   "type": "server_error"}}
        rid = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        return 200, _to_openai_response(resp, body.get("model") or self.model_name, rid)

    def stream_chat(self, body: dict, kw: dict):
        """Yield SSE frames (bytes). ``kw`` comes from _parse_request, so
        the 200 + SSE headers the caller committed were safe. Errors
        mid-stream become an error frame followed by [DONE]."""
        rid = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        model = body.get("model") or self.model_name
        created = int(time.time())

        def frame(delta: dict, finish=None, fei: dict | None = None) -> bytes:
            chunk = {
                "id": rid,
                "object": "chat.completion.chunk",
                "created": created,
                "model": model,
                "choices": [{"index": 0, "delta": delta, "finish_reason": finish}],
            }
            if fei is not None:
                chunk["fei"] = fei
            return b"data: " + json.dumps(chunk).encode() + b"\n\n"

        yield frame({"role": "assistant"})
        resp = None
        # the failover side channel: the engine fills ``export`` in place
        # with every delivered token id and its threefry key; each content
        # frame carries the ids delivered since the previous frame and the
        # key after the last of them, so the fleet router can resurrect this
        # stream on a survivor if this process dies. OpenAI clients ignore
        # the extra key.
        kw = dict(kw)
        export: dict | None = None
        if getattr(self.provider, "supports_resume", False):
            export = {}
            kw["export"] = export
        sent = 0
        try:
            msgs = kw.pop("messages")
            gen = self.provider.stream(msgs, **kw)
            while True:
                try:
                    delta = next(gen)
                except StopIteration as fin:
                    resp = fin.value
                    break
                if delta:
                    yield frame({"content": delta}, fei=_fei_delta(export, sent))
                    sent = len((export or {}).get("ids") or ())
                    # the hard-kill seam: a process that dies after a frame
                    # left, the worst case the journal must cover
                    FAULTS.check("replica.crash", rid=rid)
        except Exception as exc:  # noqa: BLE001 — headers are committed
            log.warning("stream failed: %r", exc)
            # the status line is sent, but the frame keeps the category so
            # a client can still back off
            etype = "server_error"
            if isinstance(exc, (QueueFullError, EngineDegradedError, EngineDrainingError)):
                etype = "overloaded_error"
            elif isinstance(exc, DeadlineExceededError):
                etype = "timeout_error"
            yield (b"data: " + json.dumps({"error": {
                "message": f"{type(exc).__name__}: {exc}",
                "type": etype,
            }}).encode() + b"\n\n")
            yield b"data: [DONE]\n\n"
            return
        finish = "stop"
        if resp is not None and resp.tool_calls:
            finish = "tool_calls"
            yield frame({
                "tool_calls": [
                    {
                        "index": i,
                        "id": c.id,
                        "type": "function",
                        "function": {"name": c.name,
                                     "arguments": json.dumps(c.arguments)},
                    }
                    for i, c in enumerate(resp.tool_calls)
                ]
            })
        yield frame({}, finish=finish)
        yield b"data: [DONE]\n\n"


def _fei_delta(export: dict | None, sent: int) -> dict | None:
    """The ``fei`` frame extension: the ids delivered past ``sent`` and
    the key after the last of them (None when nothing new was delivered)."""
    ids = (export or {}).get("ids")
    if not ids or len(ids) <= sent:
        return None
    n = len(ids)
    keys = export.get("keys") or []
    return {"toks": [int(t) for t in ids[sent:n]],
            "key": keys[n - 1] if n - 1 < len(keys) else None}


def _retry_after(exc) -> dict:
    return {"Retry-After": str(max(1, round(getattr(exc, "retry_after_s", 1.0))))}


def _bad_request(msg: str) -> tuple:
    return 400, {"error": {"message": msg, "type": "invalid_request_error"}}


def _server_error(exc: BaseException) -> tuple:
    return 500, {"error": {"message": f"{type(exc).__name__}: {exc}",
                           "type": "server_error"}}


def _kv_refusal(exc: KVTierError) -> tuple:
    """409 for a geometry that can never match (with the ``{ours,
    theirs}`` diff), 422 for bad bytes."""
    if isinstance(exc, KVGeometryError):
        return 409, {"error": {"message": str(exc), "type": "invalid_request_error",
                               "ours": exc.ours, "theirs": exc.theirs}}
    return 422, {"error": {"message": str(exc), "type": "invalid_request_error"}}


def make_handler(api: ServeAPI):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through our logger
            log.debug("http: " + fmt, *args)

        def _json(self, status: int, payload: dict | str,
                  headers: dict | None = None) -> None:
            if isinstance(payload, str):  # Prometheus text exposition
                data = payload.encode("utf-8")
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            else:
                data = json.dumps(payload).encode()
                ctype = "application/json"
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _body(self) -> dict | None:
            """None means malformed JSON or a non-object body (-> 400),
            {} means no body."""
            n = int(self.headers.get("Content-Length") or 0)
            if not n:
                return {}
            try:
                data = json.loads(self.rfile.read(n))
            except json.JSONDecodeError:
                return None
            return data if isinstance(data, dict) else None

        def do_GET(self):  # noqa: N802
            self._json(*api.handle("GET", self.path, {}, dict(self.headers)))

        def do_POST(self):  # noqa: N802
            body = self._body()
            if body is None:
                self._json(400, {"error": {
                    "message": "request body is not a JSON object",
                    "type": "invalid_request_error"}})
                return
            if (
                urlsplit(self.path).path == "/v1/chat/completions"
                and body.get("stream")
                and api.authorized(dict(self.headers))
            ):
                # validate BEFORE committing 200 + SSE headers
                try:
                    kw = api._parse_request(body, dict(self.headers))
                except (ValueError, KeyError, TypeError) as exc:
                    self._json(400, {"error": {"message": str(exc),
                                               "type": "invalid_request_error"}})
                    return
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                try:
                    for chunk in api.stream_chat(body, kw):
                        self.wfile.write(chunk)
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    log.info("client disconnected mid-stream")
                return
            self._json(*api.handle("POST", self.path, body, dict(self.headers)))

    return Handler


class ServingServer:
    """Owns the ThreadingHTTPServer; start()/stop() for tests and the CLI."""

    def __init__(self, api: ServeAPI, host: str = "127.0.0.1", port: int = 0):
        self.api = api
        self.httpd = ThreadingHTTPServer((host, port), make_handler(api))
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        log.info("serving OpenAI-compatible API on :%d", self.port)

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description="OpenAI-compatible serving endpoint over the PyTorch engine"
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=DEFAULT_PORT)
    p.add_argument("--model", default=None,
                   help="model config name (default: [torch_local] model)")
    p.add_argument("--api-key", default=os.environ.get("FEI_TPU_SERVER_API_KEY"))
    p.add_argument("--device", default="cuda",
                   help="where the engine runs: cuda (default) or cpu")
    args = p.parse_args(argv)

    from fei_tpu_torch.agent.providers import TorchLocalProvider

    # under FEI_TPU_MESH the engine starts its follower ranks here
    provider = TorchLocalProvider(model=args.model, device=args.device)
    api = ServeAPI(provider, model_name=provider.engine.cfg.name, api_key=args.api_key)
    server = ServingServer(api, host=args.host, port=args.port)
    server.start()
    log.info("model %s ready on http://%s:%d/v1 (ctrl-c to stop)",
             provider.engine.cfg.name, args.host, server.port)
    eng = provider.engine
    warm_restart_at_boot(eng, os.environ.get("FEI_TPU_DRAIN_DIR", ""))
    stopping = threading.Event()
    got_term = threading.Event()

    def _sigterm(signum, frame):  # noqa: ARG001
        got_term.set()
        stopping.set()

    import signal

    try:
        signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:
        pass  # not the main thread (embedded use): no SIGTERM hook
    try:
        while not stopping.wait(3600):
            pass
    except KeyboardInterrupt:
        pass
    sched = getattr(eng, "_scheduler", None)
    if got_term.is_set() and sched is not None:
        log.info("SIGTERM: draining before shutdown")
        eng.begin_drain()
        eng.wait_drained(sched.drain_deadline_s + 5.0)
    server.stop()
    if sched is not None:
        sched.close_journal()
    eng.close()  # on a mesh: stops the follower ranks
    return 0


def warm_restart_at_boot(eng, drain_dir: str) -> list:
    """Re-admit what a previous process left: the requests its drain
    snapshotted to ``drain_dir`` and the sessions its journal recorded as
    unfinished (it may have died with no cooperation at all). They decode
    to completion on threads of their own (their old connections are
    gone), which also warms the prefix cache for the clients' retries.
    Returns the restored sequences."""
    sched = getattr(eng, "_scheduler", None)
    if sched is None or not (drain_dir or sched._journal is not None):
        return []
    try:
        restored = eng.warm_restart(drain_dir or None)
    except Exception as exc:  # noqa: BLE001 — boot survives a corrupt snapshot
        log.warning("warm restart failed: %r", exc)
        return []
    if restored:
        log.info("warm restart: re-admitted %d request(s)", len(restored))

    def finish(seq):
        try:
            for _ in sched.drain(seq):
                pass
        except Exception as exc:  # noqa: BLE001
            log.warning("restored request failed: %r", exc)

    for seq in restored:
        threading.Thread(target=finish, args=(seq,), daemon=True).start()
    return restored


if __name__ == "__main__":
    raise SystemExit(main())
