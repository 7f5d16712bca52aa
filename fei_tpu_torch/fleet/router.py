"""Fleet router: one front door over N serving replicas (counterpart of
fei_tpu/fleet/router.py; the decisions, counters and flight events are the
reference's).

Routing policy, in priority order:

1. **Affinity** — a request carrying a session key (``X-FEI-Session``
   header or ``body["session"]``), or failing that a hash of its first
   message, prefers the replica that served that key last: multi-turn
   conversations keep hitting their warm prefix cache. Affinity degrades
   gracefully — a draining/ejected target falls back to least-loaded
   (``router.affinity_misses``) instead of queueing behind a drain.
2. **Role fit** — replicas advertise a role on ``/health`` (``mixed`` /
   ``prefill-heavy`` / ``decode-heavy``, FEI_TPU_REPLICA_ROLE). When the
   fleet is split, prompts estimated at ≥
   ``FEI_TPU_ROUTER_PREFILL_TOKENS`` prefer prefill-heavy replicas and
   short/decode work avoids them; an all-``mixed`` fleet skips the
   filter entirely. Preference, not a hard partition — an empty
   preferred set falls back to every usable replica.
3. **Least-loaded** — among the remaining replicas, the one with the
   lowest ``(queue_depth + running) / slots`` read off its ``/health``
   capacity fields (TTL-cached, ``FEI_TPU_FLEET_HEALTH_TTL_S``).

Warm-state mobility (kv/migrate.py via ``POST /kv/export`` →
``POST /kv/import``): when a session's remembered replica is out of
rotation (draining, ejected) and the request lands elsewhere, the router
best-effort moves the cached KV prefix to the new home before
forwarding (``router.migrations`` / ``router.migration_failures``);
after a prefill-heavy replica finishes a request it hands the prefix to
the least-loaded decode-heavy replica and re-pins the session's
affinity there, so follow-up turns decode where decode is cheap. Both
moves are strictly best-effort: any failure costs one re-prefill,
exactly the pre-migration world.

Content-addressed prefixes (KV CDN, kv/content.py) extend the same idea
to sessions NO replica remembers: a cold forward probes its destination
(``POST /kv/prefix/probe``) for the content hashes the prompt would
admit through and pulls the blob from any peer advertising it
(``GET /kv/prefix/<hash>`` → ``POST /kv/prefix``); ``prewarm()`` pushes
the fleet's hottest prefixes into a replica before sessions land there,
and ``rolling_restart`` calls it the moment a restarted replica probes
back — hot-prefix TTFT survives the restart. Both are best-effort
(``kv.prefix_hits_remote`` / ``router.prefix_fetch_failures`` /
``router.prewarm_pushes`` / ``router.prewarm_failures``).

Failure handling:

- **Circuit breaker** per replica: ``FEI_TPU_FLEET_BREAKER_FAILS``
  consecutive transport failures eject it for
  ``FEI_TPU_FLEET_BREAKER_COOLDOWN_S``; after the cooldown one
  half-open health probe decides readmission vs re-ejection. 429/503
  answers are backpressure, not failures — they divert the request but
  never trip the breaker. A malformed request body is the CLIENT's
  fault: it answers 400 (``router.invalid_requests``) without a retry
  and without charging any replica's breaker — bad input must never
  eject a healthy fleet.
- **Bounded retry** (``FEI_TPU_FLEET_RETRIES``) with jittered backoff
  (``FEI_TPU_FLEET_BACKOFF_S``), each attempt on a replica not yet
  tried. Every forward carries ``X-FEI-Deadline-S`` = the client's
  *remaining* deadline, so a retry can never grant a request more time
  than it arrived with; an expired budget 504s in the router
  (``router.deadline_expired``).
- When *no* replica looks usable, the router force-probes the whole set
  once before shedding 503 — a stale cache entry must not turn a
  transient blip into an outage.
- **Mid-stream resurrection** — each streamed content frame carries an
  ``fei`` extension (delivered token ids + the PRNG resume key) from
  the serving layer; the router keeps a per-stream ledger of them. When
  a replica dies AFTER tokens flowed (kill -9, dropped socket, stream
  closed without a finish), the ledger re-submits the request to a
  survivor with ``body["resume"]`` teacher-forcing the delivered
  suffix, suppresses the byte-identical replayed prefix, and splices
  the survivor's tail into the client's stream
  (``router.resurrections`` / ``router.resurrection_replayed_tokens``).
  Tool-grammar turns never resurrect (they are never journaled); with
  no survivor the failure degrades to the old error-frame contract.

``rolling_restart()`` sequences drain → warm-restart across the set one
replica at a time, keeping the rest in rotation: zero accepted requests
dropped (queued work snapshots and resumes; newly arriving work routes
to the survivors).

Fault points ``router.forward`` and ``replica.health`` make every path
above testable (``FAULTS.arm`` or ``FEI_TPU_FAULT``: kinds ``conn``,
``http429``, ``http503``, ``hang``).
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import threading
import time
from collections import OrderedDict
from urllib.parse import urlsplit

from fei_tpu_torch.engine.faults import FAULTS
from fei_tpu_torch.obs.flight import FLIGHT
from fei_tpu_torch.utils.errors import EngineError
from fei_tpu_torch.utils.logging import get_logger
from fei_tpu_torch.utils.metrics import METRICS

log = get_logger("fleet.router")

_RETRYABLE = (429, 503)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


class _ReplicaState:
    """Router-side view of one replica (health cache + breaker)."""

    __slots__ = ("fails", "ejected_until", "draining", "healthy",
                 "queue_depth", "running", "slots", "last_probe", "role",
                 "kv_fingerprint", "kv_layout")

    def __init__(self):
        self.fails = 0
        self.ejected_until = 0.0   # monotonic deadline; 0 = not ejected
        self.draining = False
        self.healthy = True        # optimistic until the first probe
        self.queue_depth = 0
        self.running = 0
        self.slots = 1
        self.last_probe = 0.0      # monotonic; 0 = never probed
        self.role = "mixed"        # /health "role"; mixed until probed
        # KV geometry halves off /health: the INVARIANT fingerprint
        # (model shape / dtype / page size — what blobs and sessions can
        # move between) and the tp shard layout (provenance; a layout
        # skew resheds on import, it never blocks placement). None until
        # probed, or for replicas that don't advertise geometry.
        self.kv_fingerprint = None
        self.kv_layout = None

    def load(self) -> float:
        return (self.queue_depth + self.running) / max(self.slots, 1)


class Router:
    """ServeAPI-shaped front door (``handle`` / ``stream_chat``), so
    ``ui.server.make_handler`` serves a router exactly like a single
    replica. Thread-safe for concurrent submitters: per-replica state
    updates are monotonic scalars; the affinity map takes the lock."""

    def __init__(self, replicas, retries: int | None = None,
                 backoff_s: float | None = None,
                 breaker_fails: int | None = None,
                 breaker_cooldown_s: float | None = None,
                 affinity_cap: int | None = None,
                 health_ttl_s: float | None = None):
        if not replicas:
            raise EngineError("Router needs at least one replica")
        self.replicas = {r.rid: r for r in replicas}
        if len(self.replicas) != len(replicas):
            raise EngineError("replica ids must be unique")
        self._order = [r.rid for r in replicas]
        self._state = {rid: _ReplicaState() for rid in self._order}
        self.retries = (
            _env_int("FEI_TPU_FLEET_RETRIES", 2)
            if retries is None else int(retries)
        )
        self.backoff_s = (
            _env_float("FEI_TPU_FLEET_BACKOFF_S", 0.05)
            if backoff_s is None else float(backoff_s)
        )
        self.breaker_fails = max(1, (
            _env_int("FEI_TPU_FLEET_BREAKER_FAILS", 3)
            if breaker_fails is None else int(breaker_fails)
        ))
        self.breaker_cooldown_s = (
            _env_float("FEI_TPU_FLEET_BREAKER_COOLDOWN_S", 5.0)
            if breaker_cooldown_s is None else float(breaker_cooldown_s)
        )
        self.affinity_cap = max(1, (
            _env_int("FEI_TPU_FLEET_AFFINITY", 1024)
            if affinity_cap is None else int(affinity_cap)
        ))
        self.health_ttl_s = (
            _env_float("FEI_TPU_FLEET_HEALTH_TTL_S", 1.0)
            if health_ttl_s is None else float(health_ttl_s)
        )
        # prompt size (estimated tokens) at which a request counts as
        # prefill-heavy for the role filter
        self.prefill_tokens = max(
            1, _env_int("FEI_TPU_ROUTER_PREFILL_TOKENS", 512)
        )
        # KV CDN (content-addressed prefixes): resolve a COLD session's
        # prefix from any peer advertising its content hash before the
        # forward lands, and pre-warm a restarted replica with the
        # fleet's hottest prefixes before sessions return to it
        self.prefix_fetch = os.environ.get(
            "FEI_TPU_FLEET_PREFIX_FETCH", "1"
        ).strip().lower() not in ("0", "off", "false")
        self.prewarm_enabled = os.environ.get(
            "FEI_TPU_FLEET_PREWARM", "1"
        ).strip().lower() not in ("0", "off", "false")
        self.prewarm_k = max(1, _env_int("FEI_TPU_FLEET_PREWARM_K", 8))
        self._affinity: OrderedDict[str, str] = OrderedDict()
        self._lock = threading.Lock()

    # -- health + breaker ---------------------------------------------------

    def _probe(self, rid: str) -> bool:
        """One health probe; updates the cached state. Transport failures
        and degraded answers count toward the breaker; a draining answer
        is orderly (out of rotation, no breaker pressure)."""
        st = self._state[rid]
        st.last_probe = time.monotonic()
        try:
            FAULTS.check("replica.health", replica=rid)
            status, payload, _ = self.replicas[rid].request("GET", "/health")
        except Exception as exc:  # noqa: BLE001 — any probe failure is
            # a health failure; the breaker decides how many to forgive
            log.debug("probe %s failed: %r", rid, exc)
            st.healthy = False
            # dead, not draining: an unreachable replica must charge the
            # breaker and surface as DOWN — a stale draining flag from a
            # graceful exit would dress a kill -9 up as orderly
            st.draining = False
            self._note_failure(rid)
            return False
        payload = payload if isinstance(payload, dict) else {}
        st.healthy = status == 200
        st.draining = payload.get("status") == "draining"
        st.queue_depth = int(payload.get("queue_depth") or 0)
        st.running = int(payload.get("running") or 0)
        st.slots = int(payload.get("slots") or 1)
        st.role = str(payload.get("role") or "mixed")
        fp = payload.get("kv_fingerprint")
        st.kv_fingerprint = dict(fp) if isinstance(fp, dict) else None
        lay = payload.get("kv_layout")
        st.kv_layout = dict(lay) if isinstance(lay, dict) else None
        if st.healthy:
            # deliberately does NOT reset st.fails: a replica can answer
            # /health while failing real forwards, and a passing probe
            # must not erase the breaker's consecutive-failure count.
            # Only a successful forward (or half-open readmission) does.
            return True
        if not st.draining:
            self._note_failure(rid)
        return False

    def _note_failure(self, rid: str) -> None:
        st = self._state[rid]
        st.fails += 1
        now = time.monotonic()
        if st.fails >= self.breaker_fails:
            if now >= st.ejected_until:
                METRICS.incr("router.ejections")
                FLIGHT.event("router_eject", replica=rid, fails=st.fails)
                log.warning("breaker OPEN for replica %s after %d fails",
                            rid, st.fails)
            st.ejected_until = now + self.breaker_cooldown_s

    def _usable(self, rid: str, force: bool = False) -> bool:
        """Routable right now? Refreshes the health cache when stale and
        runs the half-open probe when a breaker cooldown just expired."""
        st = self._state[rid]
        now = time.monotonic()
        if st.ejected_until > now:
            return False
        half_open = st.ejected_until > 0.0  # cooldown expired, not cleared
        if half_open or force or (now - st.last_probe) > self.health_ttl_s:
            ok = self._probe(rid)
            if half_open and ok:
                st.ejected_until = 0.0
                st.fails = 0
                METRICS.incr("router.readmissions")
                FLIGHT.event("router_readmit", replica=rid)
                log.info("breaker CLOSED: replica %s readmitted", rid)
            return ok and not st.draining
        return st.healthy and not st.draining

    def _candidates(self, force: bool = False,
                    exclude=()) -> list[str]:
        out = [rid for rid in self._order
               if rid not in exclude and self._usable(rid, force=force)]
        METRICS.gauge("router.replicas_usable", len(out))
        return out

    # -- routing ------------------------------------------------------------

    @staticmethod
    def _affinity_key(body: dict, headers: dict) -> str | None:
        h = {str(k).lower(): v for k, v in (headers or {}).items()}
        key = h.get("x-fei-session") or body.get("session")
        if key:
            return f"session:{key}"
        msgs = body.get("messages")
        for m in msgs if isinstance(msgs, list) else []:
            if not isinstance(m, dict):
                # malformed body: routing must never raise on client
                # input — the replica's parse answers the 400
                continue
            c = m.get("content")
            text = c if isinstance(c, str) else (
                json.dumps(c, sort_keys=True) if c else ""
            )
            if text:
                digest = hashlib.sha1(
                    text[:256].encode("utf-8", "replace")
                ).hexdigest()[:16]
                return f"prefix:{digest}"
        return None

    def _role_pref(self, body: dict) -> str | None:
        """Which side of the role split this request belongs on:
        ``"prefill"`` for prompts estimated at ≥ ``prefill_tokens``,
        ``"decode"`` otherwise, None when every replica is ``mixed``
        (no split to honor — skip the char-count walk entirely)."""
        for rid in self._order:
            # roles come from /health; a never-probed state would read as
            # "mixed" and silently disable the split for the first picks
            if self._state[rid].last_probe == 0.0:
                self._probe(rid)
        if all(self._state[r].role == "mixed" for r in self._order):
            return None
        chars = 0
        msgs = body.get("messages")
        for m in msgs if isinstance(msgs, list) else []:
            if not isinstance(m, dict):
                continue
            c = m.get("content")
            if isinstance(c, str):
                chars += len(c)
            elif c:
                chars += len(json.dumps(c))
        # ~4 chars/token: close enough to split long from short without
        # tokenizing in the router
        return "prefill" if chars // 4 >= self.prefill_tokens else "decode"

    def _pick(self, key: str | None, exclude=(),
              force: bool = False,
              role_pref: str | None = None) -> str | None:
        cands = self._candidates(force=force, exclude=exclude)
        if not cands:
            return None
        if key is not None:
            with self._lock:
                rid = self._affinity.get(key)
            if rid is not None:
                # affinity outranks role fit: a warm prefix cache beats
                # landing on the "right" role cold
                if rid in cands:
                    METRICS.incr("router.affinity_hits")
                    return rid
                METRICS.incr("router.affinity_misses")
        if role_pref is not None:
            if role_pref == "prefill":
                pref = [r for r in cands
                        if self._state[r].role == "prefill-heavy"]
            else:
                pref = [r for r in cands
                        if self._state[r].role != "prefill-heavy"]
            if pref and len(pref) < len(cands):
                METRICS.incr("router.role_routed")
            cands = pref or cands
        return min(cands, key=lambda r: self._state[r].load())

    def _remember(self, key: str | None, rid: str) -> None:
        if key is None:
            return
        with self._lock:
            self._affinity[key] = rid
            self._affinity.move_to_end(key)
            while len(self._affinity) > self.affinity_cap:
                self._affinity.popitem(last=False)

    # -- kv migration (warm-state mobility) ---------------------------------

    @staticmethod
    def _kv_compatible(a: dict | None, b: dict | None) -> bool:
        """Can KV state move between replicas with these INVARIANT
        fingerprints? Unknown (None — never probed, or a replica that
        doesn't advertise geometry) is optimistic: the /kv endpoints
        themselves are the authority and answer 409 on a real mismatch.
        Layout is deliberately NOT consulted — a tp skew resheds on
        import (kv/migrate.py)."""
        if a is None or b is None:
            return True
        return a == b

    def _migrate(self, src: str, dst: str, body: dict) -> bool:
        """Best-effort move of the cached KV prefix for ``body``'s prompt
        from ``src`` to ``dst`` over the /kv control plane. Never raises;
        any failure just costs the re-prefill that would have happened
        anyway. A 404 export (nothing cached) is a no-op, not a failure.
        Known-incompatible invariant geometry (mismatched fingerprints
        off /health, or a 409 import) skips without charging
        ``router.migration_failures`` — there is nothing to retry."""
        msgs = body.get("messages")
        if not isinstance(msgs, list) or not msgs:
            return False
        if not self._kv_compatible(self._state[src].kv_fingerprint,
                                   self._state[dst].kv_fingerprint):
            METRICS.incr("router.geometry_skips")
            log.debug("kv migration %s->%s skipped: invariant "
                      "fingerprints differ", src, dst)
            return False
        try:
            status, payload, _ = self.replicas[src].request(
                "POST", "/kv/export",
                {"messages": msgs, "tools": body.get("tools")},
            )
            if status == 404:
                return False  # cold source: nothing to move
            blob = payload.get("blob") if isinstance(payload, dict) else None
            if status != 200 or not blob:
                METRICS.incr("router.migration_failures")
                return False
            status, imp, _ = self.replicas[dst].request(
                "POST", "/kv/import", {"blob": blob}
            )
            if status == 409:
                # invariant geometry refusal: never retryable, distinct
                # from a transient no-room failure
                METRICS.incr("router.geometry_skips")
                log.warning("kv migration %s->%s refused (409): "
                            "invariant geometry mismatch", src, dst)
                return False
            pages = int(imp.get("pages") or 0) if isinstance(imp, dict) else 0
            if status != 200 or pages <= 0:
                # a refused import (no room) still means the session
                # re-prefills on dst; count it so operators see churn
                METRICS.incr("router.migration_failures")
                return False
        except Exception as exc:  # noqa: BLE001 — migration must never
            # take down the forward it rides along with
            log.debug("kv migration %s->%s failed: %r", src, dst, exc)
            METRICS.incr("router.migration_failures")
            return False
        METRICS.incr("router.migrations")
        FLIGHT.event("router_migrate", src=src, dst=dst, pages=pages)
        log.info("migrated %d kv pages %s -> %s", pages, src, dst)
        return True

    def _maybe_migrate(self, key: str | None, rid: str, body: dict) -> None:
        """Affinity-miss repair: the session remembers a different
        replica than the one this request is about to land on (its home
        is draining/ejected/busy) — try to bring the warm KV along so
        the new home serves it from cache instead of re-prefilling."""
        if key is None:
            return
        with self._lock:
            prev = self._affinity.get(key)
        if prev is None or prev == rid or prev not in self.replicas:
            return
        self._migrate(prev, rid, body)

    # -- content-addressed prefixes (KV CDN) --------------------------------

    def _push_prefix(self, src: str, dst: str, h: str) -> int:
        """GET one content-addressed blob off ``src`` and push it into
        ``dst``'s tier. Returns ``dst``'s HTTP status — 200 means landed
        (a dedup ``stored: false`` still counts: the bytes are there),
        409 means ``dst``'s invariant KV geometry can never accept
        blobs from ``src`` (the caller should stop trying this pair),
        0 means the source had nothing or transport failed. Never
        raises."""
        try:
            status, payload, _ = self.replicas[src].request(
                "GET", f"/kv/prefix/{h}"
            )
            blob = payload.get("blob") if isinstance(payload, dict) else None
            if status != 200 or not blob:
                return 0
            status, _out, _ = self.replicas[dst].request(
                "POST", "/kv/prefix", {"hash": h, "blob": blob}
            )
            return int(status)
        except Exception as exc:  # noqa: BLE001 — a prefix push must
            # never take down the forward or sweep it rides along with
            log.debug("prefix push %s %s->%s failed: %r", h, src, dst, exc)
            return 0

    def _peer_prefix_sets(self, exclude=()) -> dict[str, set]:
        """Content hashes each reachable replica advertises. Draining
        replicas stay included on purpose — /kv routes outlive the
        rotation exactly so their warm bytes can leave the ship."""
        out: dict[str, set] = {}
        for r in self._order:
            if r in exclude:
                continue
            try:
                status, payload, _ = self.replicas[r].request(
                    "GET", "/kv/prefix"
                )
            except Exception:  # noqa: BLE001 — unreachable peer: skip
                continue
            if status == 200 and isinstance(payload, dict):
                hs = payload.get("hashes") or []
                if hs:
                    out[r] = set(hs)
        return out

    def _maybe_prefix_fetch(self, key: str | None, rid: str,
                            body: dict) -> None:
        """Cold-session repair — the content-addressed complement of
        ``_maybe_migrate``: no replica remembers this session, but a
        peer may already hold the prompt's prefix bytes under their
        content hash. Probe the destination for the hashes it would
        admit through, find a peer advertising one, and push the blob
        ahead of the forward. Strictly best-effort and never raises;
        every failure costs exactly the re-prefill that would have
        happened anyway."""
        if not self.prefix_fetch or key is None or len(self.replicas) < 2:
            return
        with self._lock:
            prev = self._affinity.get(key)
        if prev is not None:
            return  # warm session: _maybe_migrate owns this case
        if not isinstance(body.get("messages"), list):
            return
        try:
            status, payload, _ = self.replicas[rid].request(
                "POST", "/kv/prefix/probe",
                {"messages": body.get("messages"),
                 "tools": body.get("tools")},
            )
            if status != 200 or not isinstance(payload, dict):
                return
            have = set(payload.get("have") or [])
            want = [h for h in payload.get("hashes") or [] if h not in have]
            if not want:
                return
            peers = self._peer_prefix_sets(exclude=(rid,))
            for h in want:  # longest prefix first (probe order)
                srcs = [r for r, s in peers.items() if h in s]
                for src in srcs:
                    status = self._push_prefix(src, rid, h)
                    if status == 200:
                        METRICS.incr("kv.prefix_hits_remote")
                        FLIGHT.event("router_prefix_fetch", src=src,
                                     dst=rid, hash=h)
                        return  # one prefix is all an admission can use
                    if status == 409:
                        # the destination's invariant KV geometry can
                        # never admit this prompt's blobs — every
                        # remaining hash shares the invariant, so the
                        # whole fetch is futile (422-corrupt still
                        # falls through to the next source)
                        METRICS.incr("router.geometry_skips")
                        return
                if srcs:
                    METRICS.incr("router.prefix_fetch_failures")
        except Exception as exc:  # noqa: BLE001
            METRICS.incr("router.prefix_fetch_failures")
            log.debug("prefix fetch ahead of %s failed: %r", rid, exc)

    def prewarm(self, rid: str) -> int:
        """Speculative pre-warm: push the fleet's hottest
        content-addressed prefixes (each peer's advertised list is MRU-
        ordered) into ``rid``'s tier BEFORE sessions land there —
        ``rolling_restart`` calls this the moment a restarted replica
        probes back healthy, so the first wave of returning sessions
        admits over fetched bytes instead of cold prefill. At most
        ``FEI_TPU_FLEET_PREWARM_K`` pushes; returns how many landed."""
        if not self.prewarm_enabled:
            return 0
        pushed = 0
        try:
            status, payload, _ = self.replicas[rid].request(
                "GET", "/kv/prefix"
            )
            have = set(
                (payload.get("hashes") or [])
                if status == 200 and isinstance(payload, dict) else []
            )
            for src in [r for r in self._order if r != rid]:
                if pushed >= self.prewarm_k:
                    break
                try:
                    status, payload, _ = self.replicas[src].request(
                        "GET", "/kv/prefix"
                    )
                except Exception:  # noqa: BLE001
                    continue
                if status != 200 or not isinstance(payload, dict):
                    continue
                for h in payload.get("hashes") or []:
                    if pushed >= self.prewarm_k:
                        break
                    if h in have:
                        continue
                    status = self._push_prefix(src, rid, h)
                    if status == 200:
                        pushed += 1
                        have.add(h)
                        METRICS.incr("router.prewarm_pushes")
                    elif status == 409:
                        # every blob this source serves shares its
                        # invariant geometry — move to the next source
                        METRICS.incr("router.geometry_skips")
                        break
                    else:
                        METRICS.incr("router.prewarm_failures")
        except Exception as exc:  # noqa: BLE001 — pre-warm is a bonus,
            # never a blocker: the replica serves cold without it
            METRICS.incr("router.prewarm_failures")
            log.debug("prewarm of %s failed: %r", rid, exc)
        if pushed:
            log.info("prewarmed %s with %d prefix blobs", rid, pushed)
            FLIGHT.event("router_prewarm", replica=rid, pushed=pushed)
        return pushed

    def _handoff(self, key: str | None, rid: str, body: dict) -> None:
        """Prefill→decode handoff (role split): after a prefill-heavy
        replica served a request, push the prompt's KV to the
        least-loaded decode-heavy replica and re-pin the session there —
        follow-up turns hit a warm cache where decode capacity lives."""
        if self._state[rid].role != "prefill-heavy":
            return
        cands = [r for r in self._candidates(exclude=(rid,))
                 if self._state[r].role == "decode-heavy"]
        if not cands:
            return
        dst = min(cands, key=lambda r: self._state[r].load())
        if self._migrate(rid, dst, body):
            self._remember(key, dst)

    @staticmethod
    def _deadline_budget(body: dict, headers: dict) -> float | None:
        """The client's total deadline for this request (seconds), or
        None. Folds body ``deadline_s`` with a propagated
        ``X-FEI-Deadline-S`` so a chained router can only shrink it."""
        h = {str(k).lower(): v for k, v in (headers or {}).items()}
        vals = []
        try:
            dl = float(body.get("deadline_s") or 0)
            if dl > 0:
                vals.append(dl)
        except (TypeError, ValueError):
            pass
        hd = h.get("x-fei-deadline-s")
        if hd is not None:
            try:
                vals.append(max(1e-3, float(hd)))
            except (TypeError, ValueError):
                pass
        return min(vals) if vals else None

    def _backoff(self, attempt: int, remaining: float | None) -> None:
        pause = random.uniform(0, self.backoff_s * (2 ** attempt))
        if remaining is not None:
            pause = min(pause, max(0.0, remaining))
        if pause > 0:
            time.sleep(pause)

    # -- the front door -----------------------------------------------------

    def handle(self, method: str, path: str, body: dict,
               headers: dict) -> tuple:
        """ServeAPI-shaped entry point: ``(status, payload[, headers])``."""
        route = urlsplit(path).path
        if route == "/health":
            return self._health()
        if route == "/fleet/status":
            return 200, self._status_payload()
        if route == "/v1/chat/completions" and method == "POST":
            return self._forward(method, route, body, headers)
        # any other route (models, metrics, traces, …) goes to one
        # usable replica — no retry semantics to honor
        rid = self._pick(None) or self._pick(None, force=True)
        if rid is None:
            METRICS.incr("router.sheds")
            return 503, {"error": {"message": "no usable replica",
                                   "type": "overloaded_error"}}, \
                {"Retry-After": "1"}
        try:
            return self.replicas[rid].request(method, route, body, headers)
        except Exception as exc:  # noqa: BLE001
            self._state[rid].healthy = False
            self._note_failure(rid)
            return 502, {"error": {
                "message": f"replica {rid}: {type(exc).__name__}: {exc}",
                "type": "server_error"}}

    def _health(self) -> tuple:
        cands = self._candidates()
        payload = {
            "status": "ok" if cands else "unhealthy",
            "replicas_usable": len(cands),
            "replicas": self._status_payload()["replicas"],
        }
        if cands:
            return 200, payload
        return 503, payload, {"Retry-After": "1"}

    def _status_payload(self) -> dict:
        now = time.monotonic()
        reps = {}
        for rid in self._order:
            st = self._state[rid]
            reps[rid] = {
                "healthy": st.healthy,
                "draining": st.draining,
                "ejected": st.ejected_until > now,
                "consecutive_fails": st.fails,
                "queue_depth": st.queue_depth,
                "running": st.running,
                "slots": st.slots,
                "role": st.role,
                "kv_fingerprint": st.kv_fingerprint,
                "kv_layout": st.kv_layout,
            }
        return {"replicas": reps, "affinity_entries": len(self._affinity)}

    def _forward(self, method: str, route: str, body: dict,
                 headers: dict) -> tuple:
        METRICS.incr("router.requests")
        t0 = time.monotonic()
        budget = self._deadline_budget(body, headers)
        key = self._affinity_key(body, headers)
        pref = self._role_pref(body)
        tried: set[str] = set()
        last: tuple = (
            503,
            {"error": {"message": "no usable replica",
                       "type": "overloaded_error"}},
            {"Retry-After": "1"},
        )
        for attempt in range(self.retries + 1):
            remaining = None
            if budget is not None:
                remaining = budget - (time.monotonic() - t0)
                if remaining <= 0:
                    METRICS.incr("router.deadline_expired")
                    return 504, {"error": {
                        "message": "deadline expired before a replica "
                                   "answered",
                        "type": "timeout_error"}}
            rid = self._pick(key, exclude=tried, role_pref=pref)
            if rid is None:
                # force-probe the whole set once before giving up: a
                # stale health cache must not shed a servable request
                rid = self._pick(key, exclude=tried, force=True,
                                 role_pref=pref)
            if rid is None:
                break
            if attempt == 0:
                # the session's home replica fell out of rotation: bring
                # its warm KV to wherever this request is about to land;
                # a session NO replica remembers may still find its
                # prefix bytes on a peer by content hash (KV CDN)
                self._maybe_migrate(key, rid, body)
                self._maybe_prefix_fetch(key, rid, body)
            fwd = dict(headers or {})
            if remaining is not None:
                fwd["X-FEI-Deadline-S"] = f"{remaining:.3f}"
            st = self._state[rid]
            try:
                FAULTS.check("router.forward", replica=rid)
                status, payload, extra = self.replicas[rid].request(
                    method, route, body, fwd
                )
            except Exception as exc:  # noqa: BLE001
                code = getattr(exc, "code", None)
                tried.add(rid)
                METRICS.incr("router.retries")
                if code in _RETRYABLE:
                    # injected/remote backpressure answer: divert, but
                    # never charge the breaker
                    last = (code, {"error": {
                        "message": str(exc),
                        "type": "overloaded_error"}}, {"Retry-After": "1"})
                else:
                    st.healthy = False
                    self._note_failure(rid)
                    last = (502, {"error": {
                        "message": (
                            f"replica {rid}: {type(exc).__name__}: {exc}"
                        ),
                        "type": "server_error"}}, {})
                self._backoff(attempt, remaining)
                continue
            if status in _RETRYABLE:
                tried.add(rid)
                METRICS.incr("router.retries")
                if (isinstance(payload, dict)
                        and "draining" in str(payload).lower()):
                    st.draining = True
                last = (status, payload, dict(extra or {}))
                self._backoff(attempt, remaining)
                continue
            st.fails = 0
            if status == 200:
                self._remember(key, rid)
                self._handoff(key, rid, body)
            return status, payload, dict(extra or {})
        METRICS.incr("router.sheds")
        status, payload, extra = last
        extra = dict(extra or {})
        extra.setdefault("Retry-After", "1")
        return status, payload, extra

    # -- streaming ----------------------------------------------------------

    def stream_chat(self, body: dict, headers: dict | None = None):
        """SSE frames with replica failover on BOTH sides of the first
        content frame. Before tokens flow, a failure retries on an
        untried replica (classic forward retry). After tokens flowed,
        the delivered-state ledger resurrects the session on a survivor
        (``_resurrect``) — the replayed prefix is suppressed so the
        client stream stays byte-identical; only when no survivor can
        take the session does the failure become an error frame (the
        old single-replica contract, now the floor rather than the
        ceiling). Yields frames."""
        METRICS.incr("router.requests")
        headers = dict(headers or {})
        t0 = time.monotonic()
        budget = self._deadline_budget(body, headers)
        key = self._affinity_key(body, headers)
        pref = self._role_pref(body)
        tried: set[str] = set()
        last_err = {"message": "no usable replica",
                    "type": "overloaded_error"}
        for attempt in range(self.retries + 1):
            remaining = None
            if budget is not None:
                remaining = budget - (time.monotonic() - t0)
                if remaining <= 0:
                    METRICS.incr("router.deadline_expired")
                    last_err = {"message": "deadline expired before a "
                                           "replica answered",
                                "type": "timeout_error"}
                    break
            rid = self._pick(key, exclude=tried, role_pref=pref)
            if rid is None:
                rid = self._pick(key, exclude=tried, force=True,
                                 role_pref=pref)
            if rid is None:
                break
            if attempt == 0:
                self._maybe_migrate(key, rid, body)
                self._maybe_prefix_fetch(key, rid, body)
            fwd = dict(headers)
            if remaining is not None:
                fwd["X-FEI-Deadline-S"] = f"{remaining:.3f}"
            try:
                FAULTS.check("router.forward", replica=rid)
                buffered, gen, err = self._try_stream(rid, body, fwd)
            except (ValueError, KeyError, TypeError) as exc:
                # malformed request body (ServeAPI._parse_request raises
                # before any engine work): the CLIENT's fault, not the
                # replica's — answer 400 without charging the breaker or
                # retrying (the same body would fail on every replica)
                METRICS.incr("router.invalid_requests")
                yield (b"data: " + json.dumps({"error": {
                    "message": str(exc),
                    "type": "invalid_request_error"}}).encode() + b"\n\n")
                yield b"data: [DONE]\n\n"
                return
            except Exception as exc:  # noqa: BLE001
                code = getattr(exc, "code", None)
                if code is not None and 400 <= code < 500 \
                        and code not in _RETRYABLE:
                    # a remote replica rejected the request itself
                    # (HttpReplica.stream surfaces 4xx as HTTPError):
                    # deterministic client error, same contract as above
                    METRICS.incr("router.invalid_requests")
                    yield (b"data: " + json.dumps({"error": {
                        "message": str(exc),
                        "type": "invalid_request_error"}}).encode()
                        + b"\n\n")
                    yield b"data: [DONE]\n\n"
                    return
                tried.add(rid)
                METRICS.incr("router.retries")
                if code in _RETRYABLE:
                    last_err = {"message": str(exc),
                                "type": "overloaded_error"}
                else:
                    self._state[rid].healthy = False
                    self._note_failure(rid)
                    last_err = {
                        "message": (
                            f"replica {rid}: {type(exc).__name__}: {exc}"
                        ),
                        "type": "server_error"}
                self._backoff(attempt, remaining)
                continue
            if err is not None and err.get("type") == "overloaded_error":
                # the replica shed before producing tokens: retryable
                tried.add(rid)
                METRICS.incr("router.retries")
                last_err = err
                self._backoff(attempt, remaining)
                continue
            self._state[rid].fails = 0
            self._remember(key, rid)
            # Post-commit streaming with mid-stream resurrection: every
            # emitted frame updates a delivered-state ledger (content
            # chars, absolute token ids + latest PRNG resume key off the
            # per-frame ``fei`` extension). If the serving replica dies
            # after tokens flowed — transport exception, stream closed
            # without a finish, or a mid-stream server_error frame — the
            # ledger teacher-forces the delivered suffix onto a survivor
            # and the replayed prefix is suppressed, so the client sees
            # one uninterrupted, byte-identical stream.
            st = {"id": None, "chars": 0, "toks": [], "key": None,
                  "resumable": False, "tools": False, "finished": False}
            cur = rid
            src = _chain_frames(buffered, gen)
            skip = 0
            dead: set[str] = set()
            while True:
                died: BaseException | None = None
                try:
                    yield from self._tracked(st, src, skip_chars=skip,
                                             resumed=skip > 0)
                    if st["finished"]:
                        break
                    died = EngineError(
                        f"replica {cur} closed the stream mid-generation"
                    )
                except Exception as exc:  # noqa: BLE001 — any mid-stream
                    # failure is a dead/unreachable replica; the ledger
                    # decides whether the session can move
                    died = exc
                self._state[cur].healthy = False
                self._note_failure(cur)
                dead.add(cur)
                remaining = None
                if budget is not None:
                    remaining = budget - (time.monotonic() - t0)
                nxt = self._resurrect(st, dead, body, headers, key,
                                      remaining)
                if nxt is None:
                    yield (b"data: " + json.dumps({"error": {
                        "message": (
                            f"replica {cur}: stream died mid-generation "
                            f"({type(died).__name__}: {died}) and the "
                            "session could not be resumed elsewhere"
                        ),
                        "type": "server_error"}}).encode() + b"\n\n")
                    yield b"data: [DONE]\n\n"
                    return
                cur, src = nxt
                skip = st["chars"]
            # stream finished: if a prefill-heavy replica served it,
            # push the warm prefix to decode capacity for the next turn
            self._handoff(key, cur, body)
            return
        METRICS.incr("router.sheds")
        yield (b"data: " + json.dumps({"error": last_err}).encode()
               + b"\n\n")
        yield b"data: [DONE]\n\n"

    def _tracked(self, st: dict, frames, skip_chars: int = 0,
                 resumed: bool = False):
        """Yield one replica's SSE frames to the client while keeping the
        delivered-state ledger ``st`` current: cumulative content chars,
        the absolute delivered token ids and latest PRNG resume key (off
        the serving layer's per-frame ``fei`` extension), tool-call and
        finish markers. For a resumed source the first ``skip_chars``
        content chars are the failover replay — they already reached the
        client from the dead replica, so whole-replay frames are
        swallowed, the straddling frame is rewritten, the duplicate
        role preamble drops, and every frame re-stamps the original
        stream id. Raises on a mid-stream server_error frame when the
        session is resumable (the caller's resurrection loop owns it)."""
        replayed = 0
        for chunk in frames:
            info = _parse_sse(chunk)
            if info is None:
                if b"[DONE]" in chunk:
                    st["finished"] = True
                yield chunk
                continue
            err = info.get("error")
            if err:
                if (st["resumable"] and not st["tools"]
                        and str(err.get("type")) == "server_error"):
                    raise EngineError(
                        f"mid-stream server error: {err.get('message')}"
                    )
                yield chunk
                continue
            if st["id"] is None and info.get("id"):
                st["id"] = info["id"]
            fei = info.get("fei")
            if isinstance(fei, dict):
                st["toks"].extend(int(t) for t in (fei.get("toks") or []))
                if fei.get("key") is not None:
                    st["key"] = fei["key"]
                st["resumable"] = True
            choice = (info.get("choices") or [{}])[0]
            delta = choice.get("delta") or {}
            if delta.get("tool_calls"):
                st["tools"] = True
            if choice.get("finish_reason"):
                st["finished"] = True
            content = delta.get("content")
            dirty = False
            if resumed:
                if "role" in delta and not content:
                    continue  # duplicate preamble: the client has one
                if st["id"] is not None and info.get("id") != st["id"]:
                    info["id"] = st["id"]
                    dirty = True
            if content and replayed < skip_chars:
                take = min(skip_chars - replayed, len(content))
                replayed += take
                content = content[take:]
                delta = {k: v for k, v in delta.items() if k != "content"}
                if content:
                    delta["content"] = content
                info["choices"][0]["delta"] = delta
                dirty = True
                if not content and not choice.get("finish_reason"):
                    continue  # wholly-replayed frame
            if content:
                st["chars"] += len(content)
            if dirty:
                chunk = b"data: " + json.dumps(info).encode() + b"\n\n"
            yield chunk

    def _resurrect(self, st: dict, dead: set, body: dict, headers: dict,
                   key: str | None, remaining: float | None):
        """Teacher-force a dead replica's delivered suffix onto a
        survivor. Returns ``(rid, frames)`` with the ledger reset for the
        resumed stream's absolute re-export, or None when the session
        cannot move: a tool-grammar turn (never journaled), no ``fei``
        extension observed (non-engine provider), an expired deadline,
        or no survivor that will take it.

        The survivor does NOT have to share the dead replica's mesh:
        teacher-forced replay moves the session as host-side token ids,
        and tp/dp serving is token-identical to single-chip, so any
        replica whose INVARIANT KV fingerprint matches can take it — a
        tp2 death resurrects on a single-chip survivor byte-for-byte.
        Known-incompatible invariants (a different model/page_size in a
        heterogeneous fleet) are skipped without burning a stream
        attempt."""
        if st["tools"] or not st["resumable"] or not st["toks"]:
            return None
        if remaining is not None and remaining <= 0:
            METRICS.incr("router.deadline_expired")
            return None
        dead_fp = next(
            (self._state[r].kv_fingerprint for r in dead
             if r in self._state
             and self._state[r].kv_fingerprint is not None),
            None,
        )
        body2 = {k: v for k, v in body.items() if k != "resume"}
        body2["resume"] = {"generated": [int(t) for t in st["toks"]],
                           "resume_key": st["key"]}
        fwd = dict(headers)
        if remaining is not None:
            fwd["X-FEI-Deadline-S"] = f"{remaining:.3f}"
        tried = set(dead)
        for _ in range(self.retries + 1):
            rid = self._pick(key, exclude=tried)
            if rid is None:
                rid = self._pick(key, exclude=tried, force=True)
            if rid is None:
                return None
            tried.add(rid)
            if not self._kv_compatible(dead_fp,
                                       self._state[rid].kv_fingerprint):
                METRICS.incr("router.geometry_skips")
                log.debug("resurrection skips %s: invariant kv "
                          "fingerprint differs from the dead replica",
                          rid)
                continue
            try:
                FAULTS.check("router.forward", replica=rid)
                buffered, gen, err = self._try_stream(rid, body2, fwd)
            except Exception as exc:  # noqa: BLE001 — a survivor that
                # cannot take the session is just another dead end
                log.warning("resurrection on %s failed: %r", rid, exc)
                self._state[rid].healthy = False
                self._note_failure(rid)
                continue
            if err is not None:
                log.warning("resurrection on %s declined: %s", rid, err)
                continue
            METRICS.incr("router.resurrections")
            METRICS.incr("router.resurrection_replayed_tokens",
                         len(st["toks"]))
            FLIGHT.event("router_resurrect", replica=rid,
                         replayed=len(st["toks"]))
            log.warning(
                "resurrecting session on %s (%d delivered tokens "
                "teacher-forced)", rid, len(st["toks"]),
            )
            self._remember(key, rid)
            # the resumed stream re-exports the session from token 0
            # (replay included), so the ledger rebuilds absolutely —
            # a second crash resumes from the rebuilt ledger
            st["toks"] = []
            st["key"] = None
            st["resumable"] = False
            return rid, _chain_frames(buffered, gen)
        return None

    def _try_stream(self, rid: str, body: dict, headers: dict):
        """Start a stream and pull frames until the replica committed
        (first content/tool/finish frame) or declined (error frame
        before any tokens). Returns (buffered_frames, generator,
        error_dict_or_None)."""
        gen = self.replicas[rid].stream(body, headers)
        buffered = []
        for chunk in gen:
            buffered.append(chunk)
            info = _parse_sse(chunk)
            if info is None:  # [DONE] / non-JSON — nothing more to learn
                return buffered, gen, None
            err = info.get("error")
            if err:
                return buffered, gen, dict(err)
            choice = (info.get("choices") or [{}])[0]
            delta = choice.get("delta") or {}
            if ("content" in delta or "tool_calls" in delta
                    or choice.get("finish_reason")):
                return buffered, gen, None
            # role-only preamble frame: keep looking
        return buffered, gen, None

    # -- zero-downtime rolling restart --------------------------------------

    def rolling_restart(self, drain_deadline_s: float | None = None,
                        wait_s: float = 60.0) -> dict:
        """Drain → warm-restart each replica in turn while the rest stay
        in rotation. Zero accepted requests dropped: in-flight work
        finishes or snapshots at drain and resumes after restart; new
        arrivals route to the survivors. Returns a per-replica report.
        Raises (before draining anything) if any replica cannot restart
        in-place — a remote fleet restarts via its supervisor instead."""
        # refuse BEFORE draining anything: a replica that cannot restart
        # in-place (HttpReplica — its supervisor owns restarts) would
        # otherwise be drained, stuck, and out of rotation forever while
        # the sweep aborted mid-loop
        stuck = [rid for rid in self._order
                 if not getattr(self.replicas[rid], "can_restart", True)]
        if stuck:
            raise EngineError(
                f"rolling restart refused: replica(s) {stuck} cannot "
                "restart in-place (remote replicas restart via their "
                "process supervisor); nothing was drained"
            )
        report = {}
        for rid in list(self._order):
            replica = self.replicas[rid]
            st = self._state[rid]
            st.draining = True  # out of rotation before the drain lands
            FLIGHT.event("router_restart_begin", replica=rid)
            drain_body = {}
            if drain_deadline_s is not None:
                drain_body["deadline_s"] = drain_deadline_s
            try:
                replica.request("POST", "/drain", drain_body)
            except Exception as exc:  # noqa: BLE001 — an unreachable
                # replica still gets restarted; that IS the remedy
                log.warning("drain of %s failed: %r", rid, exc)
            drained = replica.wait_drained(wait_s)
            restart_err = None
            try:
                restored = replica.restart()
            except Exception as exc:  # noqa: BLE001 — a failed restart
                # must not abort the sweep with this replica stuck in
                # draining=True: record it, let the probe loop rediscover
                # the replica's true state, and keep going
                log.warning("restart of %s failed: %r", rid, exc)
                restart_err, restored = f"{type(exc).__name__}: {exc}", 0
            # fresh process: clear breaker history, probe back in
            st.fails = 0
            st.ejected_until = 0.0
            st.draining = False
            deadline = time.monotonic() + wait_s
            back = False
            while time.monotonic() < deadline:
                if self._probe(rid) and not st.draining:
                    # boot probes that failed while the engine came up
                    # charged the breaker; a healthy comeback must not
                    # start its life ejected (mirror half-open readmit)
                    st.fails = 0
                    st.ejected_until = 0.0
                    back = True
                    break
                time.sleep(0.05)
            if back:
                # speculative pre-warm BEFORE sessions return: the fresh
                # engine's tier gets the fleet's hottest prefixes now,
                # so returning traffic admits over fetched bytes and the
                # restart stays TTFT-neutral for hot prefixes
                self.prewarm(rid)
            FLIGHT.event("router_restart_done", replica=rid,
                         restored=restored)
            report[rid] = {"drained": bool(drained),
                           "restored": restored, "healthy": back}
            if restart_err is not None:
                report[rid]["error"] = restart_err
            if not back:
                log.warning("replica %s did not come back healthy after "
                            "restart", rid)
        METRICS.incr("router.rolling_restarts")
        return report


def _chain_frames(buffered, gen):
    """Replay the commit-probe's buffered frames, then the live tail."""
    yield from buffered
    yield from gen


def _parse_sse(chunk: bytes) -> dict | None:
    """One SSE frame -> its JSON payload, or None for [DONE]/non-JSON."""
    raw = chunk.strip()
    if not raw.startswith(b"data:"):
        return None
    raw = raw[len(b"data:"):].strip()
    if raw == b"[DONE]":
        return None
    try:
        out = json.loads(raw)
        return out if isinstance(out, dict) else None
    except ValueError:
        return None
