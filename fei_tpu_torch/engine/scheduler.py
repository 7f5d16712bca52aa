"""Continuous-batching decode scheduler over the shared paged KV pool
(counterpart of fei_tpu/engine/scheduler.py).

- One daemon thread owns the device loop; ``submit()`` only enqueues. All
  pool mutation happens on that thread, so there are no cross-thread device
  races by construction. Where the JAX scheduler donates the pool through
  every dispatch, the port updates the pool tensors in place.
- Admission: a prompt of at most ``prefill_chunk`` tokens takes the dense
  bucketed prefill (the flash kernel for prompt-sized T on the card) and a
  scatter of its K/V into fresh pages; a longer prompt, a prefix-cache hit
  or a resumed sequence admits in chunks written straight into its pages
  (paged-native chunked prefill, the paged kernel's block form), one chunk
  per loop iteration so live streams stall at most one chunk.
- Decode: up to ``multistep`` batched steps per host sync; with
  ``ragged_attention`` a pending prefill chunk rides the first step as ONE
  merged dispatch (models/llama.py ``forward_paged_merged``, the ragged
  kernel). Token streams are identical with it on or off.
- Speculation (``FEI_TPU_SPECULATE=1``): while exactly one greedy stream
  decodes (or a tool-call request is in its free phase), a repeated
  n-gram's continuation is verified in ONE ``forward_paged_block`` of
  ``1 + spec_draft_len`` tokens (the paged kernel's block form), and the
  slot's length is cut back to the accepted tokens (sched_decode
  ``_maybe_spec_step``).
- Each slot carries the reference's threefry key chain in a [B, 2] device
  tensor (``PRNGKey(seed)`` split once at the first token and once per
  sampled step, engine/prng.py); the batched draw gives each row the
  reference's bits, so a seeded request samples the JAX package's tokens
  and the dense engine's. Greedy slots draw and split nothing.
- Page exhaustion is a scheduling event: prefix-cache eviction, then
  preemption of the least-progressed victim, which resumes token-
  identically (its prompt re-prefills through the chunked path, its
  generated suffix replays through the decode-shaped forward).
- KV tier (fei_tpu_torch/kv, ``FEI_TPU_KV_TIER``): a victim's settled
  pages spill to host RAM (and past the budget, disk) before its slot is
  evicted (``_spill_seq``), and its re-admission scatters them back and
  re-arms the slot with zero tokens recomputed (``_try_streamed_resume``);
  any miss or tier failure falls back to the replay above. With the tier
  on, each new prompt's full-page prefix is published under a content
  hash (``_cas_publish``), and a local prefix-cache miss tries the tier
  before prefilling (``_try_cas_admit``). ``export_prefix`` /
  ``import_prefix`` move a cached prefix between replicas; they and every
  other pool access from another thread run on the loop thread between
  dispatches (``run_ctl``).
- Constrained requests (``grammar=``): the grammar's DFA steps on the
  device inside the batched step from per-slot states (rows with no
  grammar, or still in their free phase, pass unmasked), so constrained
  and free requests share every dispatch. A tool-call request
  (``grammar_trigger=``) decodes freely until its trigger, inside the
  multi-step scan; a trigger found mid-scan rolls that slot's length and
  key back to the exact token (sched_decode ``_rollback_slots``).
- Survival: ``begin_drain`` sheds new submits (``EngineDrainingError``,
  HTTP 503 + Retry-After), lets the in-flight set finish within the
  deadline, then snapshots what is left (``_finalize_drain``; constrained
  requests fail typed instead). A session journal (engine/journal.py,
  ``FEI_TPU_JOURNAL_DIR``) records each admission, each delivered token
  with its key, and each end. ``submit(_restore=...)`` re-admits a
  snapshot or a journaled session: it re-prefills through the route the
  request was first admitted by (the ``route`` the snapshot and the
  journal carry; chunked when a record has none), re-installs the key,
  and replays the delivered tokens to the new consumer exactly once.
- Inactive slots still flow through the batched forward (static [B]
  shapes); their block-table rows are zero, so their KV writes land in the
  reserved null page 0.

The survival and KV-tier knobs read the JAX package's environment
variables, so one deployment's settings drive either package:
``FEI_TPU_DRAIN_DEADLINE_S`` (30), ``FEI_TPU_DRAIN_DIR``,
``FEI_TPU_JOURNAL_DIR`` (empty: no journal), ``FEI_TPU_JOURNAL_SYNC``
(batch), ``FEI_TPU_JOURNAL_SEGMENT_BYTES`` (4 MiB), ``FEI_TPU_KV_TIER``
(off | ram | disk; off), ``FEI_TPU_KV_RAM_BYTES`` (256 MiB),
``FEI_TPU_KV_DISK_BYTES`` (1 GiB), ``FEI_TPU_KV_DISK_DIR`` and
``FEI_TPU_KV_CDN`` (1: content-addressed prefixes while the tier is on).
So do the serving knobs, each read into an attribute when the scheduler
is built, with the JAX package's defaults and parsing:
``FEI_TPU_PREFILL_CHUNK`` (``prefill_chunk`` 256), ``FEI_TPU_ATTENTION``
(ragged | paged; ``ragged_attention`` True), ``FEI_TPU_RAGGED_ROWS``
(``ragged_rows`` 8), ``FEI_TPU_PAGED_PREFILL`` (1; the port has only the
paged-native admission, so 0 raises), ``FEI_TPU_SCHED_MULTISTEP``
(``multistep`` 8), ``FEI_TPU_MAX_QUEUE`` (``max_queue`` 0, unbounded),
``FEI_TPU_RETRY_AFTER_S`` (1), ``FEI_TPU_DEFAULT_DEADLINE_S`` (0: none),
the crash-loop breaker's ``FEI_TPU_BREAKER_FAILS`` (3) within
``FEI_TPU_BREAKER_WINDOW_S`` (60) for ``FEI_TPU_BREAKER_COOLDOWN_S`` (30),
``FEI_TPU_PREEMPT_POLICY`` (min-progress | off), and through
``TenantBook`` ``FEI_TPU_TENANT_BUDGETS`` and ``FEI_TPU_DEFAULT_TENANT``,
and speculation's ``FEI_TPU_SPECULATE`` (``speculate``, off),
``FEI_TPU_SPEC_NGRAM`` (``spec_ngram`` 3) and ``FEI_TPU_SPEC_DRAFT``
(``spec_draft_len`` 8). The sequence-parallel (``FEI_TPU_SP_*``) variables
name a feature the port does not have and stay unread.

A kernel that fails to launch fails every in-flight request through
``_fail_all`` (device scope); no path reroutes a failed kernel call to
another program, and a failed speculative dispatch does not turn
speculation off (the JAX package's ``scheduler.spec_disabled``) either.
"""

from __future__ import annotations

import math
import os
import queue
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Iterator, Sequence

import numpy as np
import torch
import torch.autograd.profiler as torch_profiler

from fei_tpu_torch.engine.faults import FAULTS
from fei_tpu_torch.engine.sched_admission import AdmissionMixin
from fei_tpu_torch.engine.sched_constrain import ConstraintMixin
from fei_tpu_torch.engine.sched_decode import DecodeMixin
from fei_tpu_torch.engine.tenancy import TenantBook, clamp_priority, sanitize_tenant
from fei_tpu_torch.obs.flight import FLIGHT
from fei_tpu_torch.obs.trace import TRACES
from fei_tpu_torch.parallel.mesh import AXES, axis_size, mesh_geometry
from fei_tpu_torch.utils.errors import (
    DeadlineExceededError,
    DeviceError,
    EngineDegradedError,
    EngineDrainingError,
    EngineError,
    QueueFullError,
)
from fei_tpu_torch.utils.logging import get_logger
from fei_tpu_torch.utils.metrics import METRICS

log = get_logger("scheduler")

_DONE = object()


class DeviceGate:
    """Process-wide gate between the schedulers' device work and a caller
    that must see no kernel launched from another thread while it runs:
    the profiler's start and stop (CUPTI's teardown while a scheduler
    thread launched kernels died of SIGSEGV on the H100). Each scheduler
    loop iteration holds it ``shared()``; ``quiesce()`` waits for the
    iterations in flight, holds new ones back until it exits, and goes
    first when both wait."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._active = 0
        self._closed = False

    @contextmanager
    def shared(self):
        with self._cond:
            while self._closed:
                self._cond.wait()
            self._active += 1
        try:
            yield
        finally:
            with self._cond:
                self._active -= 1
                self._cond.notify_all()

    @contextmanager
    def quiesce(self):
        with self._cond:
            while self._closed:
                self._cond.wait()
            self._closed = True
            while self._active:
                self._cond.wait()
        try:
            yield
        finally:
            with self._cond:
                self._closed = False
                self._cond.notify_all()


DEVICE_GATE = DeviceGate()


def gen_from_record(rec: dict | None):
    """A GenerationConfig from a snapshot's or a journal's ``gen`` dict."""
    from fei_tpu_torch.engine.engine import GenerationConfig

    gen_d = dict(rec or {})
    gen_d["stop_token_ids"] = tuple(gen_d.get("stop_token_ids") or ())
    return GenerationConfig(**gen_d)


def device_scoped(exc: BaseException) -> bool:
    """True for failures the device state cannot be trusted after: a typed
    DeviceError, or a RuntimeError (what PyTorch raises for CUDA errors and
    what the kernel wrappers raise for a failed launch)."""
    return isinstance(exc, DeviceError) or (
        isinstance(exc, RuntimeError) and not isinstance(exc, NotImplementedError)
    )


@dataclass
class _Seq:
    """One in-flight generation request."""

    prompt_ids: list[int]
    gen: object  # GenerationConfig
    mask_fn: Callable[[list[int]], object] | None
    stops: set[int]
    out: queue.Queue = field(default_factory=queue.Queue)
    generated: list[int] = field(default_factory=list)
    budget: int = 0
    slot: int = -1
    next_input: int = 0
    cancelled: bool = False
    finished: bool = False
    prefilling: bool = False  # chunked admission in progress (no decode yet)
    # prefix-cache match memo: None = not yet probed; [] = miss
    prefix_match: list[int] | None = None
    # the prompt was admitted through the dense route: a resume rebuilds
    # its K/V through that route, never through a prefix match and chunks
    dense_admitted: bool = False
    # rolling-buffer SWA: leading pages already released to the pool
    released_pages: int = 0
    # observability: request id + lifecycle trace (obs.trace.RequestTrace)
    rid: str = ""
    trace: object | None = None
    status: str | None = None  # terminal lifecycle status, once set
    # the caller's failover side channel (submit(_export=)): ``ids`` is the
    # live generated list, ``keys`` each delivered token's key as [hi, lo]
    export: dict | None = None
    t_queued: float = 0.0
    # absolute perf_counter deadline (0 = none)
    deadline: float = 0.0
    # preempt-and-resume state: the slot's threefry key at preemption (or
    # from a snapshot or a journal), re-installed at re-admission so the
    # resumed chain is the uninterrupted one; ``replay`` re-emits the
    # delivered tokens to a fresh consumer (warm restart)
    resume_key: torch.Tensor | None = None
    replay: bool = False
    # the admission landed in the session journal: every delivered token
    # and the end follow it there
    journaled: bool = False
    # host mirror of the slot's device block-table row, in ABSOLUTE page
    # positions (rolling-window releases drop leading pages from
    # pages_for() while the row keeps them)
    row: np.ndarray | None = None
    lazy: bool = False  # reservation covers prefill + one scan only
    shield: bool = False  # not a preemption victim until one dispatch lands
    tenant: str = "default"
    priority: int = 0
    # device-native grammar constraint (engine.grammar.TokenGrammar): the
    # DFA mask is computed inside the batched step from the slot's state;
    # ``gstate`` is the host mirror (-1 = free phase / unconstrained)
    grammar: object | None = None
    gtrigger: str | None = None
    gscanner: object | None = None
    gstate: int = -1
    gaccepted: bool = False
    # host-mask route (a second distinct grammar in flight): the tool-call
    # masker's state dict, whose "accepted" flag folds into gaccepted
    gfallback_state: dict | None = None
    # the content key this session published or shares (pinned in the
    # KV tier while it lives)
    cas_key: str | None = None


class PagedScheduler(AdmissionMixin, DecodeMixin, ConstraintMixin):
    """Multi-sequence decode over one paged pool (one per paged engine).

    ``engine.batch_size`` bounds concurrent sequences; further requests
    queue FIFO and admit as slots free up. A request whose page demand can
    never fit the pool fails immediately with EngineError."""

    _IDLE_PARKS = 600  # ~60 s of nothing to do -> park the thread

    def __init__(self, engine):
        self.engine = engine
        self.B = engine.batch_size
        self._slots: list[_Seq | None] = [None] * self.B
        self._waiting: deque[_Seq] = deque()
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._thread: threading.Thread | None = None
        self._pool = None  # PagedKVCache owned by the loop thread
        self._prefix = None  # PrefixCache when engine.prefix_cache
        self._admitting: dict | None = None  # in-flight chunked admission
        self._pending_chunk: dict | None = None  # deferred merge chunk
        self._admit_t: float | None = None  # admission time counted up to here
        self._ctl: deque = deque()  # closures for the loop thread (run_ctl)
        self._closed = False
        # the serving knobs, read as the JAX package reads them
        # (fei_tpu/engine/scheduler.py:195-301)
        self.prefill_chunk = int(os.environ.get("FEI_TPU_PREFILL_CHUNK", "256"))
        # the sp admission's cap: one sequence-sharded dispatch covers at
        # most this many prefill_chunks a rank before the chunked path,
        # with its bounded stall of live decode, takes over
        self.sp_admit_factor = int(os.environ.get("FEI_TPU_SP_ADMIT_FACTOR", "8"))
        # ragged merged dispatch: a pending prefill chunk rides the decode
        # step as one program; "paged" keeps the two-program shape
        attn = os.environ.get("FEI_TPU_ATTENTION", "ragged")
        if attn not in ("ragged", "paged"):
            raise EngineError(f"unknown FEI_TPU_ATTENTION {attn!r} (ragged | paged)")
        self.ragged_attention = attn == "ragged"
        self.ragged_rows = max(1, int(os.environ.get("FEI_TPU_RAGGED_ROWS", "8")))
        # admission chunks always write K/V straight into pool pages; the
        # JAX package's dense-staging admission (FEI_TPU_PAGED_PREFILL=0)
        # is not ported (ROADMAP F3)
        if os.environ.get("FEI_TPU_PAGED_PREFILL", "1") == "0":
            raise EngineError(
                "FEI_TPU_PAGED_PREFILL=0 selects the dense-staging admission, "
                "which fei_tpu_torch does not have (ROADMAP F3): unset it")
        self.multistep = max(1, int(os.environ.get("FEI_TPU_SCHED_MULTISTEP", "8")))
        # prompt-lookup speculation for the single-stream case (opt-in, as
        # in the JAX package)
        self.spec_ngram = int(os.environ.get("FEI_TPU_SPEC_NGRAM", "3"))
        self.spec_draft_len = int(os.environ.get("FEI_TPU_SPEC_DRAFT", "8"))
        self.speculate = os.environ.get("FEI_TPU_SPECULATE", "0") == "1"
        # backpressure: bound the waiting queue (0 = unbounded); the server
        # maps the QueueFullError to 429 + Retry-After
        self.max_queue = int(os.environ.get("FEI_TPU_MAX_QUEUE", "0"))
        self.retry_after_s = float(os.environ.get("FEI_TPU_RETRY_AFTER_S", "1"))
        # per-request wall-clock deadline default (0 = none)
        self.default_deadline_s = float(os.environ.get("FEI_TPU_DEFAULT_DEADLINE_S", "0"))
        # crash-loop breaker: breaker_fails device failures inside
        # breaker_window_s reject new submits for breaker_cooldown_s
        self.breaker_fails = int(os.environ.get("FEI_TPU_BREAKER_FAILS", "3"))
        self.breaker_window_s = float(os.environ.get("FEI_TPU_BREAKER_WINDOW_S", "60"))
        self.breaker_cooldown_s = float(os.environ.get("FEI_TPU_BREAKER_COOLDOWN_S", "30"))
        self._fail_times: deque[float] = deque()
        self._degraded_until = 0.0
        self.tenants = TenantBook()
        self.preempt_policy = os.environ.get("FEI_TPU_PREEMPT_POLICY", "min-progress")
        if self.preempt_policy not in ("min-progress", "off"):
            raise EngineError(
                f"unknown FEI_TPU_PREEMPT_POLICY {self.preempt_policy!r} (min-progress | off)")
        # the device-native grammar: ONE table pair serves every constrained
        # request (the provider memoizes one union grammar per tool set)
        self._ggrammar = None
        self._gtable = None
        self._gmind = None
        self._keys = None  # [B, 2] per-slot threefry keys, on the device
        self._step_keys = None  # [n, B, 2] keys after each step of the last dispatch
        # graceful drain (SIGTERM / POST /drain)
        self.drain_deadline_s = float(os.environ.get("FEI_TPU_DRAIN_DEADLINE_S", "30"))
        self.drain_dir = os.environ.get("FEI_TPU_DRAIN_DIR", "")
        self._draining = False
        self._drain_deadline = 0.0
        self._drain_dir: str | None = None
        self._drained = threading.Event()
        # the crash-consistent session journal; empty FEI_TPU_JOURNAL_DIR =
        # off (survival is then the drain snapshots alone)
        self._journal = None
        jdir = os.environ.get("FEI_TPU_JOURNAL_DIR", "").strip()
        if jdir:
            from fei_tpu_torch.engine.journal import SessionJournal

            self._journal = SessionJournal(
                jdir,
                sync=os.environ.get("FEI_TPU_JOURNAL_SYNC", "batch").strip().lower() or "batch",
                segment_bytes=int(os.environ.get("FEI_TPU_JOURNAL_SEGMENT_BYTES", str(4 << 20))),
            )
        # the KV tier: a preempted slot's pages spill to host RAM (and past
        # the budget, disk) so its resume streams bytes back instead of
        # replaying tokens. None = off (FEI_TPU_KV_TIER), exactly the
        # replay-only behaviour.
        from fei_tpu_torch.kv.tier import KVTierStore, TierConfig

        tier_cfg = TierConfig.from_env()
        self._kv_tier = KVTierStore(tier_cfg) if tier_cfg.enabled else None
        # content-addressed prefixes (kv/content.py): with the tier on,
        # finished admissions publish their full-page prefix under a
        # content hash and a local prefix-cache miss tries the tier before
        # prefilling. FEI_TPU_KV_CDN=0 keeps only the spill/resume half.
        self._cas_enabled = self._kv_tier is not None and os.environ.get(
            "FEI_TPU_KV_CDN", "1").strip().lower() not in ("0", "off", "false")
        self._cas_salt: bytes | None = None  # lazy: needs the live pool

    # -- public API ---------------------------------------------------------

    def stream(self, prompt_ids: Sequence[int], gen,
               logit_mask_fn: Callable | None = None, grammar=None,
               grammar_trigger: str | None = None,
               export: dict | None = None,
               resume: dict | None = None) -> Iterator[int]:
        """Submit a request and yield its tokens as they decode. Closing
        the iterator (or abandoning it to GC) cancels the request and
        returns its pages/slot to the pool. ``export`` (a caller-owned
        dict) receives the live resume state of every delivered token (see
        ``submit``); ``resume`` (``generated`` and an optional
        ``resume_key``) teacher-forces an already-delivered suffix, which
        the stream replays first — the fleet's resurrection path."""
        seq = self.submit(prompt_ids, gen, logit_mask_fn, grammar=grammar,
                          grammar_trigger=grammar_trigger, _restore=resume,
                          _export=export)
        yield from self.drain(seq)

    def drain(self, seq: _Seq) -> Iterator[int]:
        """Yield a submitted request's tokens; cancel on close/GC."""
        try:
            while True:
                item = seq.out.get()
                if item is _DONE:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            self.cancel(seq)

    def submit(self, prompt_ids, gen, logit_mask_fn=None, grammar=None,
               grammar_trigger: str | None = None,
               _restore: dict | None = None,
               _export: dict | None = None) -> _Seq:
        """``grammar`` (a TokenGrammar) runs device-native: the DFA mask is
        computed inside the batched step from the slot's state, with no
        per-step host mask and no [B, V] upload. With ``grammar_trigger``
        the request decodes freely until the trigger text appears, then
        constrains (the agent's tool-call protocol); without it the whole
        output is constrained.

        ``_restore`` (a drain snapshot or a journaled session: ``generated``,
        ``resume_key``, ``route``, ``deadline_remaining_s``) re-admits a
        request a previous process accepted: it resumes like a preempted
        sequence and replays its delivered tokens to the new consumer.

        ``_export`` (a caller-owned dict, the serving layer's failover side
        channel) is filled in place: ``ids`` is the request's LIVE generated
        list and ``keys`` stays index-aligned with it, each delivered
        token's threefry key as the reference's ``[hi, lo]`` words (replayed
        tokens carry None except the last, which carries the resume key).
        The keys reach the host with the tokens' one copy per dispatch, as
        for a journaled request."""
        eng = self.engine
        if self._draining:
            METRICS.incr("scheduler.requests_shed")
            raise EngineDrainingError(
                "engine is draining; retry against another replica",
                retry_after_s=max(self.retry_after_s,
                                  self._drain_deadline - time.monotonic()),
            )
        if self.degraded():
            METRICS.incr("scheduler.requests_shed")
            raise EngineDegradedError(
                f"engine degraded: {len(self._fail_times)} device failures "
                f"within {self.breaker_window_s:.0f}s tripped the crash-loop "
                "breaker; retry after the cooldown or call reset_degraded()",
                retry_after_s=max(self.retry_after_s,
                                  self._degraded_until - time.monotonic()),
            )
        tenant = sanitize_tenant(getattr(gen, "tenant", "") or self.tenants.default_tenant)
        priority = clamp_priority(getattr(gen, "priority", 0))
        self._check_queue_caps(tenant, priority)
        n = len(prompt_ids)
        if n > eng.max_seq_len:
            raise EngineError(f"prompt length {n} exceeds engine max_seq_len {eng.max_seq_len}")
        self._ensure_pool()
        alloc = eng._allocator
        budget = min(gen.max_new_tokens, eng.max_seq_len - n)
        need = alloc.pages_needed(min(n + budget, eng.max_seq_len))
        if need > alloc.num_pages - 1:
            raise EngineError(
                f"request needs {need} pages but the pool holds "
                f"{alloc.num_pages - 1}; raise num_pages or shrink max_new_tokens"
            )
        seq = _Seq(prompt_ids=list(prompt_ids), gen=gen, mask_fn=logit_mask_fn,
                   stops=eng._stops(gen), budget=budget, tenant=tenant,
                   priority=priority)
        seq.trace = TRACES.start(prompt_tokens=n, mesh=self.engine.mesh_tag)
        seq.rid = seq.trace.rid
        seq.t_queued = time.perf_counter()
        dl = getattr(gen, "deadline_s", 0.0) or self.default_deadline_s
        if dl > 0:
            seq.deadline = seq.t_queued + dl
        if _restore is not None:
            self._install_restore(seq, _restore)
        if _export is not None:
            seq.export = _export
            _export["ids"] = seq.generated
            keys = _export.setdefault("keys", [])
            if seq.generated:
                keys.extend([None] * (len(seq.generated) - 1))
                keys.append(self._key_list(seq.resume_key))
        if grammar is not None and logit_mask_fn is not None:
            raise EngineError("grammar and logit_mask_fn are mutually exclusive")
        prebuilt = None
        if grammar is not None and self._ggrammar is not grammar:
            # the [S, V] device tables are built OUTSIDE the lock: a union
            # grammar over a 128k vocab is a large upload and must not
            # stall the loop's token delivery
            prebuilt = grammar.device_tables(eng.cfg.vocab_size, eng.device,
                                             observer=eng._compiles)
        with self._lock:
            # a tenant going idle -> backlogged re-anchors its fair-share
            # clock at the busy tenants' floor (tenancy.TenantBook)
            busy = {s.tenant for s in list(self._waiting) + list(self._slots)
                    if s is not None and not s.finished}
            if tenant not in busy:
                self.tenants.activate(tenant, (self.tenants.vtime(t) for t in busy))
            # caps re-checked in the SAME critical section as the append:
            # concurrent submits passed the pre-check against the same
            # stale depth and would otherwise all append
            victims, shed = self._caps_victims_locked(tenant, priority)
            if shed is None and grammar is not None:
                # installed and queued in ONE critical section: a concurrent
                # submit of a different grammar must see this request in
                # flight, or it could swap the tables under our host mirror
                if self._set_grammar(grammar, prebuilt):
                    self._arm_grammar(seq, grammar, grammar_trigger)
                else:
                    self._host_grammar(seq, grammar, grammar_trigger, budget)
            if shed is None:
                self._closed = False  # a submit after close() reopens
                self._waiting.append(seq)
                self._start_thread()
            depth = len(self._waiting)
        self._settle_caps(victims, shed, tenant, priority, depth, arrival=seq)
        METRICS.incr("scheduler.requests_submitted")
        # the journal's admit record comes after every point that sheds, so
        # a journaled request is exactly an accepted one
        self._journal_admit(seq)
        self._update_sched_gauges()
        self._wake.set()
        return seq

    def _install_restore(self, seq: _Seq, restore: dict) -> None:
        """The preempt-resume state of a restored request, set before the
        loop thread can see it. A missing key is rebuilt: the chain is
        ``PRNGKey(seed)`` split once at the first token and once per
        sampled step, so after k delivered tokens it is k splits (a greedy
        request's key never advances)."""
        from fei_tpu_torch.engine import prng

        dev = self.engine.device
        seq.generated = [int(t) for t in restore.get("generated") or []]
        key = restore.get("resume_key")
        if key is not None:
            seq.resume_key = prng.key_from_words(key, dev)
        elif seq.generated:
            k = prng.PRNGKey(int(getattr(seq.gen, "seed", 0) or 0), dev)
            if seq.gen.temperature > 0.0:
                for _ in range(len(seq.generated)):
                    k = prng.split(k)[0]
            seq.resume_key = k
        seq.dense_admitted = restore.get("route") == "dense"
        seq.replay = bool(seq.generated)
        rem = restore.get("deadline_remaining_s")
        if rem is not None:
            seq.deadline = seq.t_queued + float(rem)

    def _arm_grammar(self, seq: _Seq, grammar, trigger: str | None) -> None:
        """A device-grammar request: constrained from its first token, or
        free until ``trigger`` (the scanner watches its text)."""
        from fei_tpu_torch.engine.grammar import TriggerScanner

        seq.grammar = grammar
        seq.gtrigger = trigger
        if trigger is None:
            seq.gstate = grammar.entry
        else:
            seq.gscanner = TriggerScanner(self.engine.tokenizer, trigger)

    def _host_grammar(self, seq: _Seq, grammar, trigger: str | None, budget: int) -> None:
        """A different grammar is in flight: serve this request through the
        equivalent host mask rather than reject it."""
        log.info("second distinct grammar in flight; request served through "
                 "host masks")
        if trigger is None:
            seq.mask_fn = grammar.logit_mask_fn(max_tokens=budget)
            return
        from fei_tpu_torch.engine.grammar import toolcall_stream_mask_fn

        seq.mask_fn, seq.gfallback_state = toolcall_stream_mask_fn(
            grammar, self.engine.tokenizer, trigger, max_tokens=budget)

    def _check_queue_caps(self, tenant: str, priority: int) -> None:
        """Backpressure pre-check: fail a doomed arrival before any work.
        submit() re-runs the check in the critical section that appends."""
        with self._lock:
            victims, shed = self._caps_victims_locked(tenant, priority)
            depth = len(self._waiting)
        self._settle_caps(victims, shed, tenant, priority, depth)

    def _caps_victims_locked(self, tenant: str, priority: int):
        """Queue-cap enforcement core (under self._lock): a strictly lower-
        priority queued request is displaced to make room; with none, the
        arrival sheds. Returns (victims, shed message or None)."""
        victims: list[_Seq] = []
        shed: str | None = None
        pol = self.tenants.policy(tenant)
        if not self.max_queue and not pol.queue_cap:
            return victims, shed
        if pol.queue_cap:
            mine = [s for s in self._waiting if s.tenant == tenant]
            if len(mine) >= pol.queue_cap:
                v = self._queue_victim_locked(priority, within=mine)
                if v is None:
                    shed = (f"tenant {tenant!r} queue is full ({len(mine)} "
                            f">= cap {pol.queue_cap})")
                else:
                    self._waiting.remove(v)
                    victims.append(v)
        if shed is None and self.max_queue and len(self._waiting) >= self.max_queue:
            v = self._queue_victim_locked(priority)
            if v is None:
                shed = (f"waiting queue is full ({len(self._waiting)} >= "
                        f"max_queue={self.max_queue})")
            else:
                self._waiting.remove(v)
                victims.append(v)
        return victims, shed

    def _settle_caps(self, victims, shed, tenant, priority, depth, arrival=None) -> None:
        """Deliver eviction errors to displaced victims and raise for a shed
        arrival — the out-of-lock half of _caps_victims_locked."""
        for v in victims:
            v.finished = True
            self._trace_finish(v, "shed")
            METRICS.incr(f"tenant.{v.tenant}.sheds")
            FLIGHT.event("queue_evict", rid=v.rid, priority=v.priority,
                         by_priority=priority)
            v.out.put(QueueFullError(
                f"request {v.rid} (priority {v.priority}) was evicted from "
                f"the full queue by a priority-{priority} arrival",
                retry_after_s=self.retry_after_s,
            ))
        if shed is not None:
            if arrival is not None:
                arrival.finished = True
                self._trace_finish(arrival, "shed")
            else:
                METRICS.incr("scheduler.requests_shed")
            METRICS.incr(f"tenant.{tenant}.sheds")
            METRICS.gauge("scheduler.queue_depth", depth)
            raise QueueFullError(shed, retry_after_s=self.retry_after_s)

    def _queue_victim_locked(self, priority: int, within: list | None = None):
        """The lowest-priority, most recently queued request from a class
        STRICTLY below ``priority`` (equals keep FIFO), or None."""
        best = None
        for s in (within if within is not None else self._waiting):
            if s.priority >= priority:
                continue
            if best is None or s.priority <= best.priority:
                best = s
        return best

    def degraded(self) -> bool:
        """True while the crash-loop breaker rejects submits."""
        if self._degraded_until and time.monotonic() >= self._degraded_until:
            self.reset_degraded()
        return bool(self._degraded_until)

    def reset_degraded(self) -> None:
        self._degraded_until = 0.0
        self._fail_times.clear()
        METRICS.gauge("engine.degraded", 0)

    def cancel(self, seq: _Seq) -> None:
        with self._lock:
            if seq in self._waiting:
                self._waiting.remove(seq)
                seq.finished = True
                self._release_tier(seq)  # a preempted waiter's spill dies here
                self._trace_finish(seq, "cancelled")
                self._journal_end(seq, "cancelled")
                return
            seq.cancelled = True
        self._wake.set()

    # -- scheduler thread ---------------------------------------------------

    def _start_thread(self) -> None:
        # callers hold self._lock, so the park-or-restart handoff with
        # _loop's locked exit check cannot lose a submission
        if self._thread is None or not self._thread.is_alive():
            self._closed = False
            self._thread = threading.Thread(
                target=self._loop, name="fei-torch-paged-scheduler", daemon=True
            )
            self._thread.start()

    def close(self) -> None:
        """Stop the loop thread (idempotent). In-flight requests fail with
        EngineError; the pool and prefix cache survive, and a later
        submit() reopens the scheduler."""
        with self._lock:
            self._closed = True
            thread = self._thread
            # release the installed grammar (its device tables stay memoized
            # on the TokenGrammar, so a reopen installs it without an upload)
            self._ggrammar = self._gtable = self._gmind = None
        self._wake.set()
        if thread is not None and thread.is_alive():
            thread.join(timeout=60)
        if self._journal is not None:
            # flush, don't close: a submit() after close() reopens the
            # scheduler and keeps journaling into the live segment
            self._journal.flush()

    def close_journal(self) -> None:
        """Flush and close the session journal and stop its writer thread
        (the process is done with this engine)."""
        if self._journal is not None:
            self._journal.close()

    def _loop(self) -> None:
        idle = 0
        while True:
            park = False
            try:
                # device work holds the gate; an idle wait does not
                with DEVICE_GATE.shared():
                    if self._closed:
                        self._drain(EngineError("scheduler closed"))
                        with self._lock:
                            if self._closed:
                                self._thread = None
                                return
                        continue
                    self._reap_cancelled()
                    self._run_ctl_pending()
                    # the flight recorder captures ranges while a profiler runs
                    on = torch_profiler._is_profiler_enabled
                    if on or FLIGHT.capturing:
                        FLIGHT.follow_profiler(on)
                    if self._draining:
                        if self._admitting is not None:
                            # an accepted chunked admission finishes its
                            # prefill; nothing new leaves the queue
                            self._admit_ready()
                        if self._drain_step():
                            with self._lock:
                                self._thread = None
                                return
                        continue
                    self._admit_ready()
                    if not any(self._slots):
                        if not self._waiting and self._admitting is None:
                            idle += 1
                            if idle > self._IDLE_PARKS:
                                with self._lock:
                                    if not self._waiting and not any(self._slots):
                                        self._thread = None
                                        return
                        park = True
                    else:
                        idle = 0
                        self._step_active()
                if park:
                    self._wake.wait(timeout=0.1)
                    self._wake.clear()
            except BaseException as exc:  # noqa: BLE001
                log.error("scheduler loop error: %r", exc)
                if device_scoped(exc):
                    self._fail_all(exc)
                else:
                    # host-side failure no per-request handler could
                    # attribute: fail the in-flight set, keep the pool
                    self._drain(exc)

    def _reap_cancelled(self) -> None:
        now = time.perf_counter()
        for s in self._slots:
            if s is None or s.finished:
                continue
            if s.cancelled:
                self._finish(s)
            elif s.deadline and now > s.deadline:
                s.out.put(DeadlineExceededError(
                    f"request {s.rid} exceeded its "
                    f"{s.deadline - s.t_queued:.1f}s deadline mid-decode"
                ))
                self._trace_finish(s, "deadline_exceeded")
                self._finish(s)

    def _slot_row(self, slot: int) -> np.ndarray:
        """The slot's padded block-table row (null-page padded), on the host."""
        width = self._pool.block_table.shape[1]
        pages = self.engine._allocator.pages_for(slot)
        row = np.zeros((width,), dtype=np.int32)
        row[: len(pages)] = pages
        return row

    def _deliver(self, seq: _Seq, t: int, key=None) -> None:
        """Handle one sampled token for an armed sequence: stop handling,
        emission, completion. ``key`` is the slot's key after the step
        (host words, or a device tensor at admission) when the request is
        journaled, else None. A host-side failure here fails ONLY this
        sequence; device-scoped ones re-raise to the loop."""
        try:
            FAULTS.check("delivery.detok", seq=seq, rid=seq.rid)
            self._deliver_inner(seq, t, key)
        except BaseException as exc:  # noqa: BLE001
            if device_scoped(exc):
                raise
            log.warning("request %s failed at delivery: %r", seq.rid, exc)
            self._fail_seq(seq, exc)

    def _fail_seq(self, seq: _Seq, exc: BaseException) -> None:
        """Fail ONE request through the healthy-pool eviction path."""
        seq.out.put(exc)
        self._trace_finish(seq, "failed")
        self._journal_end(seq, "failed")
        METRICS.incr("scheduler.requests_failed_isolated")
        self._finish(seq)

    def _deliver_inner(self, seq: _Seq, t: int, key=None) -> None:
        emit, done = self._grammar_advance(seq, t) if seq.grammar is not None else (True, False)
        if not done and t in seq.stops:
            self._finish(seq)
            return
        if emit:
            if not seq.generated:
                if seq.trace is not None:
                    seq.trace.event("first_token")
                METRICS.observe("ttft_seconds", time.perf_counter() - seq.t_queued)
            seq.generated.append(t)
            # export and journal BEFORE the token is published: a consumer
            # never sees a token whose resume state is still missing
            if seq.export is not None:
                seq.export["keys"].append(self._key_list(key))
            if seq.journaled:
                # the record is queued BEFORE the token is published: a
                # consumer never sees a token whose resume state is missing
                extra = None
                if len(seq.generated) == 1:
                    # the route the prompt was admitted by, known only now
                    extra = {"route": "dense" if seq.dense_admitted else "chunked"}
                self._journal.token(seq.rid, t, self._key_list(key), extra)
            seq.out.put(t)
            # weighted-fair service accounting
            self.tenants.charge(seq.tenant, 1)
            METRICS.incr(f"tenant.{seq.tenant}.tokens_served")
        if not done and seq.gfallback_state is not None:
            # host-mask tool-call route: advance the masker now (it is
            # idempotent per prefix length) so acceptance ends the turn at
            # the completing token, as on the device-native route
            seq.mask_fn(seq.generated)
            if seq.gfallback_state.get("accepted"):
                seq.gaccepted = True
                done = True
        if done:
            self._finish(seq)
            return
        seq.next_input = t
        if self.engine.cfg.sliding_window:
            self._release_window_pages(seq)
        if len(seq.generated) >= seq.budget:
            self._finish(seq)

    def _release_window_pages(self, seq: _Seq) -> None:
        """Rolling-buffer SWA: pages wholly below (pos - window - margin)
        return to the pool mid-stream; the kernel starts at the first
        in-window page, so they are never read again. The margin covers the
        deepest mid-stream length cut, a rejected speculative draft or a
        multi-step scan's rollback (a page released under the longer length
        must still be below the window after the cut), plus one page of
        slack."""
        W = self.engine.cfg.sliding_window
        ps = self.engine.page_size
        margin = max(self.spec_draft_len, self.multistep) + ps
        cur = len(seq.prompt_ids) + len(seq.generated)
        releasable = max(0, (cur - W - margin)) // ps
        if releasable > seq.released_pages:
            n = releasable - seq.released_pages
            self.engine._allocator.release_prefix(seq.slot, n)
            seq.released_pages = releasable
            METRICS.incr("scheduler.swa_pages_released", n)

    def _finish(self, seq: _Seq) -> None:
        seq.finished = True
        if seq.gfallback_state is not None:
            seq.gaccepted = bool(seq.gfallback_state.get("accepted"))
        self._release_tier(seq)
        slot = seq.slot
        if slot >= 0 and self._slots[slot] is seq:
            self._evict_slot(slot)
        self._trace_finish(seq, "cancelled" if seq.cancelled else "completed")
        self._journal_end(seq, "cancelled" if seq.cancelled else "completed")
        self._update_sched_gauges()
        seq.out.put(_DONE)

    def _release_tier(self, seq: _Seq) -> None:
        """A finished or cancelled request's tier state: its spilled pages
        are dropped and its content key unpinned."""
        if self._kv_tier is None:
            return
        self._kv_tier.drop(seq.rid)
        if seq.cas_key is not None:
            self._kv_tier.unpin(seq.cas_key)
            seq.cas_key = None

    def _evict_slot(self, slot: int) -> None:
        """Zero the slot's device block-table row + length (future KV writes
        for the slot land in the null page 0) and return its pages."""
        if self._pool is not None:
            self._pool.block_table[slot].zero_()
            self._pool.lengths[slot] = 0
        self.engine._allocator.free(slot)
        self._slots[slot] = None

    def _trace_finish(self, seq: _Seq, status: str) -> None:
        """Terminal trace event + lifecycle counter (the first status wins,
        matching TraceBuffer.finish)."""
        if seq.status is not None:
            return
        seq.status = status
        if seq.trace is not None:
            TRACES.finish(seq.trace, status, completion_tokens=len(seq.generated))
        METRICS.incr(f"scheduler.requests_{status}")

    def _update_sched_gauges(self) -> None:
        """Occupancy gauges: queue depth, running slots, the page pool, the
        mesh's shape and each dp replica group's occupancy (the reference's
        names and values), and the tenants' shares."""
        METRICS.gauge("scheduler.queue_depth", len(self._waiting))
        METRICS.gauge("scheduler.running_slots", sum(1 for s in self._slots if s is not None))
        mesh = self.engine.mesh
        sizes = {ax: axis_size(mesh, ax) for ax in AXES}
        METRICS.gauge("engine.mesh_shape", math.prod(sizes.values()))
        for ax, n in sizes.items():
            METRICS.gauge(f"engine.mesh.{ax}", n)
        dp = sizes["dp"]
        if dp > 1 and self.B % dp == 0:
            # the batch rows stripe over the dp groups in contiguous blocks
            # (the rows each rank's kernels take)
            per = self.B // dp
            waiting = len(self._waiting)
            for g in range(dp):
                METRICS.gauge(f"scheduler.replica.{g}.slots",
                              sum(1 for s in self._slots[g * per:(g + 1) * per] if s is not None))
                METRICS.gauge(f"scheduler.replica.{g}.queue_depth",
                              waiting // dp + (1 if g < waiting % dp else 0))
        alloc = getattr(self.engine, "_allocator", None)
        if alloc is not None:
            total = alloc.num_pages - 1
            METRICS.gauge("pool.pages_total", total)
            METRICS.gauge("pool.pages_free", alloc.free_pages)
            METRICS.gauge("pool.pages_in_use", total - alloc.free_pages)
        if self.tenants.configured:
            queued: dict[str, int] = {}
            running: dict[str, int] = {}
            for s in self._waiting:
                queued[s.tenant] = queued.get(s.tenant, 0) + 1
            for s in self._slots:
                if s is not None and not s.finished:
                    running[s.tenant] = running.get(s.tenant, 0) + 1
            for name in set(queued) | set(running) | {k for k in self.tenants.policies if k != "*"}:
                METRICS.gauge(f"tenant.{name}.queued", queued.get(name, 0))
                METRICS.gauge(f"tenant.{name}.running", running.get(name, 0))

    def _drain(self, exc: BaseException) -> None:
        """Fail every queued and in-flight request WITHOUT dropping device
        state (close, or an unattributable host failure)."""
        with self._lock:
            waiting = list(self._waiting)
            self._waiting.clear()
        for s in waiting:
            s.finished = True
            self._trace_finish(s, "failed")
            self._journal_end(s, "failed")
            s.out.put(exc)
        self._admitting = None
        self._pending_chunk = None
        for s in list(self._slots):
            if s is not None:
                s.out.put(exc)
                self._trace_finish(s, "failed")
                self._journal_end(s, "failed")
                self._finish(s)

    def _fail_all(self, exc: BaseException) -> None:
        """A device failure: every in-flight and queued request fails, the
        pool is dropped (rebuilt at the next admission) and the prefix cache
        emptied. Each call feeds the crash-loop breaker: ``breaker_fails``
        failures within ``breaker_window_s`` reject submits for
        ``breaker_cooldown_s``."""
        now = time.monotonic()
        self._fail_times.append(now)
        while self._fail_times and now - self._fail_times[0] > self.breaker_window_s:
            self._fail_times.popleft()
        if len(self._fail_times) >= self.breaker_fails:
            self._degraded_until = now + self.breaker_cooldown_s
            METRICS.gauge("engine.degraded", 1)
            FLIGHT.event("breaker_trip", fails=len(self._fail_times),
                         cooldown_s=self.breaker_cooldown_s)
            log.error("crash-loop breaker tripped: %d device failures within %.0fs",
                      len(self._fail_times), self.breaker_window_s)
        with self._lock:
            doomed = [s for s in self._slots if s is not None] + list(self._waiting)
            self._waiting.clear()
            for b in range(self.B):
                if self._slots[b] is not None:
                    self.engine._allocator.free(b)
                    self._slots[b] = None
        self._admitting = None
        self._pending_chunk = None
        self._pool = None
        self._keys = None
        self.engine._pool = None
        if self._prefix is not None:
            while self._prefix._evict_one():
                pass
            self._prefix = None
        for s in doomed:
            s.finished = True
            self._trace_finish(s, "failed")
            self._journal_end(s, "failed")
            s.out.put(exc)

    # -- memory pressure: preemption + pressure-aware allocation -------------

    def _prefill_ids(self, seq: _Seq) -> list[int]:
        """A fresh request prefills its prompt; a preempted one re-prefills
        prompt + generated[:-1] (its last token stays the next input)."""
        if seq.generated:
            return seq.prompt_ids + seq.generated[:-1]
        return seq.prompt_ids

    def _pick_victim(self, exclude: _Seq | None, max_priority: int | None = None):
        """The lowest-priority running sequence, least far toward its
        budget; never ``exclude`` or a shielded (just admitted) slot."""
        best = best_k = None
        for s in self._slots:
            if s is None or s is exclude or s.finished or s.shield:
                continue
            if max_priority is not None and s.priority > max_priority:
                continue
            k = (s.priority, len(s.generated) / max(s.budget, 1))
            if best_k is None or k < best_k:
                best, best_k = s, k
        return best

    def _preempt_seq(self, seq: _Seq, *, locked: bool, requeue: bool = True) -> None:
        """Release one running sequence's slot and pages and requeue it.
        Its state is its token lists and its slot's key (copied on the
        device, no sync); with the KV tier on, its settled pages spill to
        the host first. Re-admission streams the pages back, or else
        re-prefills by its admission route and replays its generated
        tokens."""
        slot = seq.slot
        if slot >= 0 and self._slots[slot] is seq:
            if not seq.prefilling:
                # a victim still (re-)prefilling keeps the key it carried
                seq.resume_key = self._keys[slot].clone()
                # spill-before-preempt: best effort, the preemption never
                # depends on the tier
                self._spill_seq(seq, slot)
            self._evict_slot(slot)
        st = self._admitting
        if st is not None and st.get("seq") is seq:
            self._admitting = None
        seq.slot = -1
        seq.prefilling = False
        seq.prefix_match = None
        seq.released_pages = 0
        seq.row = None
        if seq.trace is not None:
            seq.trace.event("preempted")
        METRICS.incr("scheduler.preemptions")
        METRICS.incr(f"tenant.{seq.tenant}.preemptions")
        FLIGHT.event("preempt", rid=seq.rid, slot=slot,
                     generated=len(seq.generated), requeue=requeue)
        log.info("preempted %s (%d/%d tokens) under pool pressure",
                 seq.rid, len(seq.generated), seq.budget)
        if requeue:
            if locked:
                self._waiting.append(seq)
            else:
                with self._lock:
                    self._waiting.append(seq)

    def _spill_seq(self, seq: _Seq, slot: int) -> None:
        """Copy a settled, about-to-be-preempted slot's pages into the host
        tier, keyed by request id. Loop thread only (reads the live pool,
        after the last dispatch's KV writes in stream order). Every skip or
        failure is silent toward the caller: replay remains the
        always-correct resume."""
        tier = self._kv_tier
        if tier is None or not seq.generated:
            return
        if self.engine.cfg.sliding_window:
            # rolling-window slots release leading pages mid-decode;
            # spilled pages would misalign at scatter — replay covers
            return
        from fei_tpu_torch.kv.pagesio import gather_pages, pool_fingerprint, shard_layout
        from fei_tpu_torch.kv.tier import PageEntry
        from fei_tpu_torch.obs.costmodel import account_kv_transfer

        try:
            alloc = self.engine._allocator
            n = len(self._prefill_ids(seq))
            need = alloc.pages_needed(n)
            pages = alloc.pages_for(slot)[:need]
            if len(pages) < need:
                return  # partial state: replay
            # the device length must match the host token count, or the
            # entry would arm a resumed slot at the wrong position
            if int(self._pool.lengths[slot]) != n:
                METRICS.incr("kv.spill_skipped_length")
                return
            t0 = time.time()
            with METRICS.span("kv_spill"):
                arrays = gather_pages(self._pool, pages)
            fp = pool_fingerprint(self._pool, self.engine.tp)
            entry = PageEntry(
                key=seq.rid, n_tokens=n, page_size=self.engine.page_size,
                fingerprint=fp, arrays=arrays, layout=shard_layout(fp["kv_heads"], self.engine.tp),
            )
            tier.put(seq.rid, entry)
            t1 = time.time()
            METRICS.incr("kv.spills")
            METRICS.incr("kv.pages_spilled", need)
            account_kv_transfer("spilled", entry.nbytes, t1 - t0)
            FLIGHT.dispatch("dispatch.kv_spill", t0, t1, t1, rid=seq.rid, slot=slot,
                            pages=need, bytes=entry.nbytes)
        except Exception as exc:  # noqa: BLE001 — a failed spill only costs
            # the fast resume; the preemption proceeds regardless
            METRICS.incr("kv.spill_failures")
            log.warning("kv spill of %s failed: %r", seq.rid, exc)

    def _ensure_free(self, seq: _Seq, n: int, *, preempt: bool, locked: bool = True) -> bool:
        """Make ``n`` pages free: first evict prefix-cache entries, then
        (when allowed) preempt victims one at a time. False when the demand
        cannot be met. The ``pool.alloc`` fault point is checked once per
        attempt."""
        from fei_tpu_torch.utils.errors import PoolPressure

        alloc = self.engine._allocator
        attempt = 0
        while True:
            pressure = False
            try:
                FAULTS.check("pool.alloc", seq=seq, rid=seq.rid, n=n)
            except PoolPressure:
                pressure = True
            if not pressure and alloc.free_pages >= n:
                return True
            attempt += 1
            if attempt == 1:
                if self._prefix is not None:
                    self._prefix.evict_for(n)
                continue
            if not preempt or self.preempt_policy == "off":
                return False
            victim = self._pick_victim(exclude=seq, max_priority=seq.priority)
            if victim is None:
                return False
            self._preempt_seq(victim, locked=locked)

    def _alloc_pages(self, seq: _Seq, slot: int, n: int, *, preempt: bool = True,
                     locked: bool = False) -> list[int] | None:
        """Pressure-aware page allocation; None when no victim could free
        enough pages."""
        if n <= 0:
            return []
        alloc = self.engine._allocator
        while True:
            if not self._ensure_free(seq, n, preempt=preempt, locked=locked):
                return None
            got = alloc.try_alloc(slot, n)
            if got is not None:
                return got

    # -- control-plane closures on the loop thread ---------------------------

    def run_ctl(self, fn, timeout_s: float = 60.0):
        """Run ``fn`` on the scheduler loop thread between dispatches and
        return its result (KV export/import: the pool is single-owner
        state). With the loop parked there is no dispatch to race, so
        ``fn`` runs inline, outside the lock (the closure may take it:
        ``_ensure_pool`` does); a live loop services the queue at the top
        of its next iteration."""
        box: dict = {}
        done = threading.Event()
        with self._lock:
            alive = self._thread is not None and self._thread.is_alive()
            if alive:
                self._ctl.append((fn, box, done))
        if not alive:
            return fn()
        self._wake.set()
        deadline = time.perf_counter() + timeout_s
        while not done.wait(timeout=0.05):
            if time.perf_counter() > deadline:
                raise EngineError(f"scheduler ctl call timed out after {timeout_s}s")
            reclaimed = False
            with self._lock:
                alive = self._thread is not None and self._thread.is_alive()
                if not alive:
                    # the loop parked or died between enqueue and service:
                    # reclaim the entry and run inline
                    try:
                        self._ctl.remove((fn, box, done))
                        reclaimed = True
                    except ValueError:
                        pass  # already picked up; keep waiting
            if reclaimed:
                return fn()
        if "exc" in box:
            raise box["exc"]
        return box.get("result")

    def _run_ctl_pending(self) -> None:
        """Service queued control closures (loop thread only), each outside
        the lock. A closure's exception fails its caller, never the loop."""
        while True:
            with self._lock:
                if not self._ctl:
                    return
                fn, box, done = self._ctl.popleft()
            try:
                box["result"] = fn()
            except BaseException as exc:  # noqa: BLE001 — re-raised by run_ctl
                box["exc"] = exc
            finally:
                done.set()

    def export_prefix(self, prompt_ids) -> bytes | None:
        """The longest page-aligned cached prefix of ``prompt_ids`` as a
        portable migration blob (kv/migrate.py), or None when nothing is
        cached. Safe from any thread."""
        from fei_tpu_torch.kv.migrate import export_blob

        ids = [int(t) for t in prompt_ids]
        return self.run_ctl(lambda: export_blob(self, ids))

    def import_prefix(self, blob: bytes) -> int:
        """Scatter a migration blob into this scheduler's pool and prefix
        cache; returns the pages landed (0 = refused for lack of room).
        Raises KVTierError on a corrupt or mismatched blob. Safe from any
        thread."""
        from fei_tpu_torch.kv.migrate import import_blob

        return self.run_ctl(lambda: import_blob(self, blob))

    def content_prefix_status(self, prompt_ids, cap: int = 8) -> dict:
        """Candidate content hashes for ``prompt_ids``' page boundaries
        (longest first, at most ``cap``) and which of them this replica's
        tier holds (``POST /kv/prefix/probe``). Safe from any thread."""
        ids = [int(t) for t in prompt_ids]

        def work() -> dict:
            if self._kv_tier is None or not self._cas_enabled:
                return {"hashes": [], "have": []}
            self._ensure_pool()
            max_m = max(0, (len(ids) - 1) // self.engine.page_size)
            keys = self._cas_keys(ids, max_m)
            hashes = list(reversed(keys))[: max(1, int(cap))]
            have = [k for k in hashes if self._kv_tier.contains(k)]
            return {"hashes": hashes, "have": have}

        return self.run_ctl(work)

    def _cas_keys(self, ids, n_pages: int) -> list[str]:
        """Content keys for the first 1..n_pages boundaries of ``ids``.
        Loop thread only (reads the live pool's fingerprint once). The
        salt hashes only the invariant fingerprint half, so the keys are
        the JAX package's for the same model and pool geometry."""
        from fei_tpu_torch.kv.content import content_keys, content_salt
        from fei_tpu_torch.kv.pagesio import pool_fingerprint

        if self._cas_salt is None:
            self._cas_salt = content_salt(getattr(self.engine.cfg, "name", ""),
                                          pool_fingerprint(self._pool, self.engine.tp))
        return content_keys(ids, n_pages, self.engine.page_size, self._cas_salt)

    # -- the session journal ------------------------------------------------

    @staticmethod
    def _key_list(key) -> list[int] | None:
        """A key as the journal's and the snapshot file's ``[hi, lo]`` int
        list (None passes through). A device tensor syncs: callers pass
        one only for journaled or snapshotted requests."""
        if key is None:
            return None
        if isinstance(key, torch.Tensor):
            key = key.tolist()
        return [int(x) for x in np.asarray(key).reshape(-1).tolist()]

    def _want_token_keys(self) -> bool:
        """True when an armed slot is journaled or exporting: only then does
        a dispatch copy its per-step keys to the host (once, with its
        tokens), so unjournaled, unexported serving pays nothing."""
        return any(s is not None and not s.finished
                   and (s.journaled or s.export is not None) for s in self._slots)

    @staticmethod
    def _portable(seq: _Seq) -> bool:
        """A constraint (grammar automaton, mask closure) is process-local
        state: such a request is neither journaled nor snapshotted."""
        return (seq.grammar is None and seq.mask_fn is None
                and seq.gscanner is None and seq.gfallback_state is None)

    def _gen_record(self, seq: _Seq) -> dict:
        from dataclasses import asdict

        gen = asdict(seq.gen)
        gen["stop_token_ids"] = list(gen.get("stop_token_ids") or ())
        return gen

    def _journal_admit(self, seq: _Seq) -> None:
        """The journal's admit record, written at the end of submit() after
        every point that sheds. The mesh is provenance (a session restores
        onto any mesh); page_size gates recovery."""
        j = self._journal
        if j is None or seq.finished or not self._portable(seq):
            return
        from fei_tpu_torch.engine.journal import deadline_epoch

        rec = {
            "t": "admit",
            "rid": seq.rid,
            "prompt_ids": [int(t) for t in seq.prompt_ids],
            "gen": self._gen_record(seq),
            "mesh": mesh_geometry(self.engine.mesh),
            "page_size": int(self.engine.page_size),
            "tenant": seq.tenant,
            "priority": seq.priority,
        }
        if seq.deadline:
            # wall clock: the deadline must mean something after a restart
            rec["deadline_epoch"] = deadline_epoch(seq.deadline - time.perf_counter())
        if seq.generated:
            # a resumed admission carries its delivered suffix, so recovery
            # composes across repeated crashes
            rec["generated"] = [int(t) for t in seq.generated]
            rec["resume_key"] = self._key_list(seq.resume_key)
            rec["route"] = "dense" if seq.dense_admitted else "chunked"
        j.admit(rec)
        seq.journaled = True

    def _journal_end(self, seq: _Seq, reason: str) -> None:
        """The journal's end record (once per request). A journaled request
        with no end record is exactly what recovery re-admits, so every
        exit path comes here."""
        if self._journal is None or not seq.journaled:
            return
        seq.journaled = False
        self._journal.finish(seq.rid, reason)

    # -- graceful drain and warm restart ------------------------------------

    def begin_drain(self, deadline_s: float | None = None,
                    snapshot_dir: str | None = None) -> None:
        """Start draining: new submits shed with EngineDrainingError (HTTP
        503 + Retry-After), in-flight requests finish within the deadline,
        then the still-queued set, and any running request the deadline
        strands, snapshots (to ``snapshot_dir``, else ``drain_dir``) for a
        warm restart. Idempotent; sticky for the process's lifetime."""
        with self._lock:
            if self._draining:
                return
            self._draining = True
            self._drain_deadline = time.monotonic() + (
                self.drain_deadline_s if deadline_s is None else deadline_s)
            self._drain_dir = snapshot_dir if snapshot_dir is not None else (
                self.drain_dir or None)
            busy = (any(s is not None for s in self._slots) or bool(self._waiting)
                    or self._admitting is not None)
            if busy:
                self._start_thread()
        METRICS.gauge("engine.draining", 1)
        FLIGHT.event("drain", deadline_s=round(self._drain_deadline - time.monotonic(), 3))
        log.info("drain started (deadline %.1fs, snapshot dir %s)",
                 self._drain_deadline - time.monotonic(), self._drain_dir or "-")
        thread = self._thread
        if thread is None or not thread.is_alive():
            # the loop cannot run (idle, or a harness stubbed
            # _start_thread): finalize here instead of hanging wait_drained
            self._finalize_drain()
        self._wake.set()

    def wait_drained(self, timeout: float | None = None) -> bool:
        """Block until the drain finalized; True when it did in time."""
        return self._drained.wait(timeout)

    def draining(self) -> bool:
        return self._draining

    def _drain_step(self) -> bool:
        """One loop iteration while draining: step the in-flight set until
        it quiesces or the deadline passes, then finalize. True once the
        drain has finalized (the loop parks)."""
        busy = any(s is not None for s in self._slots) or self._admitting is not None
        if busy and time.monotonic() < self._drain_deadline:
            if any(s is not None and not s.prefilling for s in self._slots):
                self._step_active()
            else:
                # only a chunked admission is in flight: the loop advances
                # it one chunk per iteration
                self._wake.wait(timeout=0.01)
                self._wake.clear()
            return False
        self._finalize_drain()
        return True

    def _finalize_drain(self) -> None:
        """Snapshot everything still alive and declare the drain done.
        Running requests the deadline stranded are preempted (not
        requeued): their delivered tokens and key ride in the snapshot.
        Constrained requests cannot be snapshotted across processes; they
        fail with a typed EngineDrainingError."""
        with self._lock:
            waiting = list(self._waiting)
            self._waiting.clear()
        st = self._admitting
        if st is not None and st.get("seq") is not None:
            s = st["seq"]
            if not s.finished and not any(s is w for w in waiting):
                waiting.insert(0, s)  # mid-admission: still queued work
        running = [s for s in self._slots
                   if s is not None and not s.finished
                   and not any(s is w for w in waiting)]
        for s in running + [w for w in waiting if w.slot >= 0]:
            self._preempt_seq(s, locked=False, requeue=False)
        self._admitting = None
        self._pending_chunk = None
        snaps: list[dict] = []
        for s in running + waiting:
            snap = self._snapshot_seq(s)
            s.finished = True
            if snap is None:
                s.out.put(EngineDrainingError(
                    "engine drained; this request's constraint (grammar / host "
                    "mask closure) cannot be snapshotted across processes — "
                    "resubmit it after restart", retry_after_s=self.retry_after_s))
                self._trace_finish(s, "failed")
                self._journal_end(s, "failed")
            else:
                snaps.append(snap)
                FLIGHT.event("snapshot", rid=s.rid, generated=len(s.generated))
                s.out.put(EngineDrainingError(
                    "engine drained before this request completed; it was "
                    "snapshotted for warm restart", retry_after_s=self.retry_after_s))
                self._trace_finish(s, "snapshotted")
                # the snapshot owns the session now: without an end record
                # a warm restart would re-admit it twice
                self._journal_end(s, "snapshotted")
            s.out.put(_DONE)
        if snaps and self._drain_dir:
            from fei_tpu_torch.engine import checkpoint

            try:
                checkpoint.save_request_snapshots(
                    self._drain_dir, snaps, mesh=mesh_geometry(self.engine.mesh),
                    page_size=self.engine.page_size)
            except Exception as exc:  # noqa: BLE001
                log.error("drain snapshot persistence failed: %r", exc)
        if self._journal is not None:
            # the end records must be durable before the process exits
            self._journal.flush()
        self._update_sched_gauges()
        log.info("drain finalized: %d request(s) snapshotted (%d preempted from slots)",
                 len(snaps), len(running))
        self._drained.set()

    def _snapshot_seq(self, seq: _Seq) -> dict | None:
        """The host-resumable snapshot of one request, in the JAX package's
        format plus ``route``; None for a constrained request."""
        if not self._portable(seq):
            return None
        snap = {
            "rid": seq.rid,
            "prompt_ids": [int(t) for t in seq.prompt_ids],
            "generated": [int(t) for t in seq.generated],
            "resume_key": self._key_list(seq.resume_key),
            "mesh": mesh_geometry(self.engine.mesh),
            "gen": self._gen_record(seq),
            "route": "dense" if seq.dense_admitted else "chunked",
        }
        if seq.deadline:
            snap["deadline_remaining_s"] = max(0.0, seq.deadline - time.perf_counter())
        return snap

    def restore_snapshots(self, snaps: list[dict]) -> list[_Seq]:
        """Warm restart: resubmit persisted drain snapshots. Each resumes
        like a preempted sequence (its route, its key) and replays its
        delivered tokens, so the new consumer sees the whole stream."""
        seqs = []
        for snap in snaps:
            seqs.append(self.submit(snap["prompt_ids"], gen_from_record(snap.get("gen")),
                                    _restore=snap))
            METRICS.incr("scheduler.requests_restored")
        return seqs

    # -- shared device state ------------------------------------------------

    def _ensure_pool(self) -> None:
        # under self._lock: two submitter threads must not double-create
        with self._lock:
            if self._pool is None:
                self._pool = self.engine._ensure_pool()
                self.engine._pool = None  # the scheduler owns the tensors now
                self._keys = torch.zeros((self.B, 2), dtype=torch.int64,
                                         device=self._pool.k_pages.device)
                if self.engine.prefix_cache and self._prefix is None:
                    from fei_tpu_torch.engine.paged_cache import PrefixCache

                    self._prefix = PrefixCache(self.engine._allocator)

    def _arm(self, slot: int, row: np.ndarray, length: int) -> None:
        """Install a slot's block-table row and length so decode reads it."""
        dev = self._pool.block_table.device
        self._pool.block_table[slot] = torch.as_tensor(row, dtype=torch.int32).to(dev)
        self._pool.lengths[slot] = int(length)
