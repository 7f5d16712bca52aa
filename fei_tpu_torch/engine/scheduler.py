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
- Each request samples from its own ``torch.Generator`` seeded with
  ``gen.seed``, drawing exactly what the dense engine draws at B=1, so a
  seeded request gives the same tokens through the scheduler as through
  the dense engine; greedy rows draw nothing.
- Page exhaustion is a scheduling event: prefix-cache eviction, then
  preemption of the least-progressed victim, which resumes token-
  identically (its prompt re-prefills through the chunked path, its
  generated suffix replays through the decode-shaped forward).
- Constrained requests (``grammar=``): the grammar's DFA steps on the
  device inside the batched step from per-slot states (rows with no
  grammar, or still in their free phase, pass unmasked), so constrained
  and free requests share every dispatch. A tool-call request
  (``grammar_trigger=``) decodes freely until its trigger, inside the
  multi-step scan; a trigger found mid-scan rolls that slot's length and
  generator back to the exact token (sched_decode ``_rollback_slots``).
- Inactive slots still flow through the batched forward (static [B]
  shapes); their block-table rows are zero, so their KV writes land in the
  reserved null page 0.

The knobs are attributes with the JAX package's defaults (the port reads
no environment variable): ``prefill_chunk`` 256, ``multistep`` 8,
``ragged_attention`` True, ``ragged_rows`` 8, ``preempt_policy``
"min-progress", ``max_queue`` 0 (unbounded), ``retry_after_s`` 1,
``default_deadline_s`` 0, and the crash-loop breaker's ``breaker_fails``
3 within ``breaker_window_s`` 60 for ``breaker_cooldown_s`` 30.

A kernel that fails to launch fails every in-flight request through
``_fail_all`` (device scope); no path reroutes a failed kernel call to
another program.
"""

from __future__ import annotations

import queue
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterator, Sequence

import numpy as np
import torch

from fei_tpu_torch.engine.faults import FAULTS
from fei_tpu_torch.engine.sched_admission import AdmissionMixin
from fei_tpu_torch.engine.sched_constrain import ConstraintMixin
from fei_tpu_torch.engine.sched_decode import DecodeMixin
from fei_tpu_torch.engine.tenancy import TenantBook, clamp_priority, sanitize_tenant
from fei_tpu_torch.utils.errors import (
    DeadlineExceededError,
    DeviceError,
    EngineDegradedError,
    EngineError,
    QueueFullError,
)
from fei_tpu_torch.utils.logging import get_logger
from fei_tpu_torch.utils.metrics import METRICS

log = get_logger("scheduler")

_DONE = object()


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
    rid: str = ""
    status: str | None = None  # terminal lifecycle status, once set
    t_queued: float = 0.0
    # absolute perf_counter deadline (0 = none)
    deadline: float = 0.0
    # the request's sampling stream, created at its first token; it stays
    # with the sequence through preemption, so a resumed stream continues
    # the same draws
    generator: torch.Generator | None = None
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
        self._closed = False
        self.prefill_chunk = 256
        self.multistep = 8
        self.ragged_attention = True
        self.ragged_rows = 8
        self.preempt_policy = "min-progress"
        self.max_queue = 0
        self.retry_after_s = 1.0
        self.default_deadline_s = 0.0
        self.breaker_fails = 3
        self.breaker_window_s = 60.0
        self.breaker_cooldown_s = 30.0
        self._fail_times: deque[float] = deque()
        self._degraded_until = 0.0
        self.tenants = TenantBook()
        # the device-native grammar: ONE table pair serves every constrained
        # request (the provider memoizes one union grammar per tool set)
        self._ggrammar = None
        self._gtable = None
        self._gmind = None
        # per free-phase sampled slot, its generator's state after each step
        # of the last dispatch (the rollback's restore points)
        self._step_gen_states: dict[int, list] = {}

    # -- public API ---------------------------------------------------------

    def stream(self, prompt_ids: Sequence[int], gen,
               logit_mask_fn: Callable | None = None, grammar=None,
               grammar_trigger: str | None = None) -> Iterator[int]:
        """Submit a request and yield its tokens as they decode. Closing
        the iterator (or abandoning it to GC) cancels the request and
        returns its pages/slot to the pool."""
        seq = self.submit(prompt_ids, gen, logit_mask_fn, grammar=grammar,
                          grammar_trigger=grammar_trigger)
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
               grammar_trigger: str | None = None) -> _Seq:
        """``grammar`` (a TokenGrammar) runs device-native: the DFA mask is
        computed inside the batched step from the slot's state, with no
        per-step host mask and no [B, V] upload. With ``grammar_trigger``
        the request decodes freely until the trigger text appears, then
        constrains (the agent's tool-call protocol); without it the whole
        output is constrained."""
        eng = self.engine
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
                   priority=priority, rid=f"req-{uuid.uuid4().hex[:12]}")
        seq.t_queued = time.perf_counter()
        dl = getattr(gen, "deadline_s", 0.0) or self.default_deadline_s
        if dl > 0:
            seq.deadline = seq.t_queued + dl
        if grammar is not None and logit_mask_fn is not None:
            raise EngineError("grammar and logit_mask_fn are mutually exclusive")
        prebuilt = None
        if grammar is not None and self._ggrammar is not grammar:
            # the [S, V] device tables are built OUTSIDE the lock: a union
            # grammar over a 128k vocab is a large upload and must not
            # stall the loop's token delivery
            prebuilt = grammar.device_tables(eng.cfg.vocab_size, eng.device)
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
        self._update_sched_gauges()
        self._wake.set()
        return seq

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
                self._trace_finish(seq, "cancelled")
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

    def _loop(self) -> None:
        idle = 0
        while True:
            try:
                if self._closed:
                    self._drain(EngineError("scheduler closed"))
                    with self._lock:
                        if self._closed:
                            self._thread = None
                            return
                    continue
                self._reap_cancelled()
                self._admit_ready()
                if not any(self._slots):
                    if not self._waiting and self._admitting is None:
                        idle += 1
                        if idle > self._IDLE_PARKS:
                            with self._lock:
                                if not self._waiting and not any(self._slots):
                                    self._thread = None
                                    return
                    self._wake.wait(timeout=0.1)
                    self._wake.clear()
                    continue
                idle = 0
                self._step_active()
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

    def _deliver(self, seq: _Seq, t: int) -> None:
        """Handle one sampled token for an armed sequence: stop handling,
        emission, completion. A host-side failure here fails ONLY this
        sequence; device-scoped ones re-raise to the loop."""
        try:
            FAULTS.check("delivery.detok", seq=seq, rid=seq.rid)
            self._deliver_inner(seq, t)
        except BaseException as exc:  # noqa: BLE001
            if device_scoped(exc):
                raise
            log.warning("request %s failed at delivery: %r", seq.rid, exc)
            self._fail_seq(seq, exc)

    def _fail_seq(self, seq: _Seq, exc: BaseException) -> None:
        """Fail ONE request through the healthy-pool eviction path."""
        seq.out.put(exc)
        self._trace_finish(seq, "failed")
        METRICS.incr("scheduler.requests_failed_isolated")
        self._finish(seq)

    def _deliver_inner(self, seq: _Seq, t: int) -> None:
        emit, done = self._grammar_advance(seq, t) if seq.grammar is not None else (True, False)
        if not done and t in seq.stops:
            self._finish(seq)
            return
        if emit:
            if not seq.generated:
                METRICS.observe("ttft_seconds", time.perf_counter() - seq.t_queued)
            seq.generated.append(t)
            seq.out.put(t)
            self.tenants.charge(seq.tenant, 1)
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
        in-window page, so they are never read again. The margin covers a
        multi-step scan plus one page of slack."""
        W = self.engine.cfg.sliding_window
        ps = self.engine.page_size
        margin = self.multistep + ps
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
        slot = seq.slot
        if slot >= 0 and self._slots[slot] is seq:
            self._evict_slot(slot)
        self._trace_finish(seq, "cancelled" if seq.cancelled else "completed")
        self._update_sched_gauges()
        seq.out.put(_DONE)

    def _evict_slot(self, slot: int) -> None:
        """Zero the slot's device block-table row + length (future KV writes
        for the slot land in the null page 0) and return its pages."""
        if self._pool is not None:
            self._pool.block_table[slot].zero_()
            self._pool.lengths[slot] = 0
        self.engine._allocator.free(slot)
        self._slots[slot] = None

    def _trace_finish(self, seq: _Seq, status: str) -> None:
        """Terminal status + lifecycle counter (the first status wins)."""
        if seq.status is not None:
            return
        seq.status = status
        METRICS.incr(f"scheduler.requests_{status}")

    def _update_sched_gauges(self) -> None:
        METRICS.gauge("scheduler.queue_depth", len(self._waiting))
        METRICS.gauge("scheduler.running_slots", sum(1 for s in self._slots if s is not None))
        alloc = getattr(self.engine, "_allocator", None)
        if alloc is not None:
            total = alloc.num_pages - 1
            METRICS.gauge("pool.pages_total", total)
            METRICS.gauge("pool.pages_free", alloc.free_pages)
            METRICS.gauge("pool.pages_in_use", total - alloc.free_pages)

    def _drain(self, exc: BaseException) -> None:
        """Fail every queued and in-flight request WITHOUT dropping device
        state (close, or an unattributable host failure)."""
        with self._lock:
            waiting = list(self._waiting)
            self._waiting.clear()
        for s in waiting:
            s.finished = True
            self._trace_finish(s, "failed")
            s.out.put(exc)
        self._admitting = None
        self._pending_chunk = None
        for s in list(self._slots):
            if s is not None:
                s.out.put(exc)
                self._trace_finish(s, "failed")
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
        self.engine._pool = None
        if self._prefix is not None:
            while self._prefix._evict_one():
                pass
            self._prefix = None
        for s in doomed:
            s.finished = True
            self._trace_finish(s, "failed")
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
        Its state is host-side (token lists, its generator); re-admission
        re-prefills through the prefix cache and the chunked path."""
        slot = seq.slot
        if slot >= 0 and self._slots[slot] is seq:
            self._evict_slot(slot)
        st = self._admitting
        if st is not None and st.get("seq") is seq:
            self._admitting = None
        seq.slot = -1
        seq.prefilling = False
        seq.prefix_match = None
        seq.released_pages = 0
        seq.row = None
        METRICS.incr("scheduler.preemptions")
        log.info("preempted %s (%d/%d tokens) under pool pressure",
                 seq.rid, len(seq.generated), seq.budget)
        if requeue:
            if locked:
                self._waiting.append(seq)
            else:
                with self._lock:
                    self._waiting.append(seq)

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

    # -- shared device state ------------------------------------------------

    def _ensure_pool(self) -> None:
        # under self._lock: two submitter threads must not double-create
        with self._lock:
            if self._pool is None:
                self._pool = self.engine._ensure_pool()
                self.engine._pool = None  # the scheduler owns the tensors now
                if self.engine.prefix_cache and self._prefix is None:
                    from fei_tpu_torch.engine.paged_cache import PrefixCache

                    self._prefix = PrefixCache(self.engine._allocator)

    def _arm(self, slot: int, row: np.ndarray, length: int) -> None:
        """Install a slot's block-table row and length so decode reads it."""
        dev = self._pool.block_table.device
        self._pool.block_table[slot] = torch.as_tensor(row, dtype=torch.int32).to(dev)
        self._pool.lengths[slot] = int(length)
