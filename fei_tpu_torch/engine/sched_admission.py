"""Admission half of the paged scheduler (counterpart of
fei_tpu/engine/sched_admission.py): a queued request becomes an armed
batch slot. A mixin over PagedScheduler state.

Two prefill routes:
- dense: a prompt of at most ``prefill_chunk`` tokens prefills as one
  bucketed dense forward (``engine.prefill``; the flash kernel for T >= 64
  on the card) and its K/V scatter into fresh pages;
- paged-native chunked: a longer prompt, a prefix-cache hit or a resumed
  sequence prefills ``prefill_chunk`` tokens per loop iteration, each chunk
  forwarding against a one-slot view of the pool (its table row, its
  running length) and writing K/V straight into its pages. With
  ``ragged_attention`` and live decode, a chunk is deferred to ride the
  next decode dispatch as one merged program.

A resumed (preempted) sequence prefills only its prompt positions, by the
route recorded when it was admitted (``_Seq.dense_admitted``: a densely
admitted prompt through one dense forward again, never through a prefix
match; any other through the chunks: the dense flash kernel and the paged
kernels round differently), and then replays its generated suffix through
the decode-shaped [B, 1] forward, so its rebuilt KV is bitwise what
admission and the decode steps wrote. A chunked prompt whose prefix-cache
pages were evicted before it resumes recomputes those positions through
the chunks, which may round apart from the pages it had shared.
With the KV tier on, two routes come first (kv/): a preempted sequence
whose pages were spilled scatters them back and re-arms at once
(``_try_streamed_resume``: zero tokens recomputed, bitwise the slot it
left), and a fresh request the local prefix cache cannot fully serve
fetches its longest published prefix by content hash
(``_try_cas_admit``), then takes the chunked prefix-hit route. Each new
prompt's full-page prefix is published (``_cas_publish``). Any tier miss or
failure falls through to the routes above.

On a mesh with an sp axis a fresh prompt of at least ``long_prefill_min``
tokens (and at most ``sp_admit_factor`` x ``prefill_chunk`` x sp) admits
through the dense route, whose ``engine.prefill`` runs it sequence-sharded
in one dispatch; a prefix hit and a resumed sequence keep the chunks.

The JAX package's dense-staging chunked route and its fallbacks for a
kernel Mosaic rejects have no counterpart here: a kernel failure fails the
requests, it is never rerouted.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from fei_tpu_torch.engine import prng
from fei_tpu_torch.engine.faults import FAULTS
from fei_tpu_torch.engine.paged_cache import scatter_dense
from fei_tpu_torch.engine.sampling import sample_logits
from fei_tpu_torch.utils.errors import DeadlineExceededError, EngineError, PoolPressure
from fei_tpu_torch.utils.logging import get_logger
from fei_tpu_torch.obs.costmodel import account_kv_transfer
from fei_tpu_torch.parallel.mesh import axis_size
from fei_tpu_torch.obs.flight import FLIGHT
from fei_tpu_torch.utils.metrics import METRICS

log = get_logger("scheduler")

# pseudo seq-id for a content-addressed fetch's pages in flight (slots are
# 0..B-1, kv/migrate.py's import is -7777)
_CAS_ID = -7778


class AdmissionMixin:
    """Request admission: queue -> slot -> prefilled pages -> first token."""

    def _admit_ready(self) -> None:
        """Fill free slots while the pool has pages. A chunked admission in
        flight gets exactly one chunk per call, so the loop interleaves it
        with decode. Head-of-line blocking on the chosen candidate is
        deliberate: a too-big-for-now request eventually runs. Each call's
        wall time adds to ``scheduler.admit_seconds``, in parts: before
        each first token it delivers (``_admit_split``) and at its end, so
        a window that opens or closes on such a token splits the call
        there. While the flight recorder captures, the call is a
        ``sched.admit`` range."""
        self._admit_t = time.perf_counter()
        cap = FLIGHT.capturing
        if cap:
            r = FLIGHT.open("sched.admit")
        try:
            self._admit_queued()
        finally:
            if cap:
                FLIGHT.close(r)
                FLIGHT.resolve()  # its prefills' device times: their first tokens synced
            METRICS.incr("scheduler.admit_seconds", time.perf_counter() - self._admit_t)
            self._admit_t = None

    def _admit_split(self) -> None:
        """Add the admission call's time so far to
        ``scheduler.admit_seconds`` (before a first token goes out)."""
        if self._admit_t is not None:
            now = time.perf_counter()
            METRICS.incr("scheduler.admit_seconds", now - self._admit_t)
            self._admit_t = now

    def _admit_queued(self) -> None:
        if self._admitting is not None:
            seq, slot = self._admitting["seq"], self._admitting["slot"]
            try:
                self._admit_chunk()
            except BaseException as exc:  # noqa: BLE001
                self._abort_admission(seq, slot, exc)
            return
        while True:
            with self._lock:
                self._shed_expired_locked()
                if not self._waiting:
                    return
                seq = self._next_admission_locked()
                if seq is None:
                    return
                free = [b for b, s in enumerate(self._slots) if s is None]
                if not free:
                    # a waiting request may preempt a STRICTLY lower-
                    # priority running one; equal classes wait for a slot
                    if self.preempt_policy == "off" or seq.priority <= 0:
                        return
                    victim = self._pick_victim(exclude=None, max_priority=seq.priority - 1)
                    if victim is None:
                        return
                    METRICS.incr("scheduler.priority_preemptions")
                    FLIGHT.event("priority_preempt", rid=victim.rid, by_rid=seq.rid,
                                 priority=victim.priority, by_priority=seq.priority)
                    self._preempt_seq(victim, locked=True)
                    free = [b for b, s in enumerate(self._slots) if s is None]
                    if not free:
                        return
                alloc = self.engine._allocator
                ids = self._prefill_ids(seq)
                if seq.prefix_match is None:
                    seq.prefix_match = (self._prefix.match(ids)
                                        if self._prefix and not seq.dense_admitted else [])
                prefix = seq.prefix_match
                if prefix:
                    # pin the matched pages so eviction below cannot free them
                    try:
                        alloc.take_ref(prefix)
                    except EngineError:
                        seq.prefix_match = prefix = self._prefix.match(ids)
                        if prefix:
                            alloc.take_ref(prefix)
                # hybrid reservation: the full worst case first; under
                # pressure a lazy one (prefill + one scan, grown on demand)
                # with preemption allowed; else block at the queue head
                seq.lazy = False
                full_tokens = min(len(seq.prompt_ids) + seq.budget, self.engine.max_seq_len)
                need = alloc.pages_needed(full_tokens) - len(prefix)
                if not self._ensure_free(seq, need, preempt=False):
                    lazy_need = max(0, alloc.pages_needed(
                        min(len(ids) + self.multistep + 1, full_tokens)) - len(prefix))
                    if self.preempt_policy != "off" and self._ensure_free(
                            seq, lazy_need, preempt=True):
                        seq.lazy = True
                    else:
                        METRICS.incr("scheduler.admission_blocked")
                        self._update_sched_gauges()
                        if prefix:
                            alloc.drop_ref(prefix)
                            seq.prefix_match = None  # re-probe after the pin drops
                        return
                self._waiting.remove(seq)
                slot = free[0]
                self._slots[slot] = seq
                seq.slot = slot
                seq.shield = True  # not a victim until one dispatch lands
                if prefix:
                    alloc.share(slot, prefix)
                    alloc.drop_ref(prefix)  # the pin became the slot's ref
            if seq.trace is not None:
                seq.trace.event("admitted")
            METRICS.observe("queue_wait_seconds", time.perf_counter() - seq.t_queued)
            FLIGHT.event("admit", rid=seq.rid, slot=slot, lazy=seq.lazy,
                         prefix_pages=len(prefix))
            self._update_sched_gauges()
            try:
                # streamed resume: a preempted sequence whose pages live in
                # the KV tier scatters them back and re-arms in one hop
                if seq.generated and self._try_streamed_resume(seq, slot, prefix):
                    continue
                # a fresh request's prefix may be in the tier under its
                # content hash; a hit takes the chunked prefix-hit route
                if not seq.generated:
                    cas = self._try_cas_admit(seq, slot, prefix)
                    if cas:
                        seq.prefix_match = prefix = cas
                # a long prompt on an sp mesh admits sequence-sharded in one
                # dispatch (engine.prefill's route). That dispatch stalls
                # live decode for its whole duration, so it is capped at
                # sp_admit_factor x prefill_chunk tokens a rank; a prefix
                # hit and a resumed sequence keep the chunked path
                n_tok = len(ids)
                sp_long = (
                    not prefix
                    and not seq.generated
                    and self.engine._sp_prefill_eligible(n_tok)
                    and n_tok <= self.sp_admit_factor * self.prefill_chunk
                    * axis_size(self.engine.mesh, "sp")
                )
                if (prefix or n_tok > self.prefill_chunk or seq.generated) and not sp_long:
                    self._start_chunked_paged(seq, slot, prefix)
                    return  # one chunked admission at a time
                self._admit(seq, slot)
            except PoolPressure:
                # no viable victim mid-admission: release the slot and put
                # the request back at the FRONT of the queue
                self._admitting = None
                self.engine._allocator.free(slot)
                self._slots[slot] = None
                seq.slot = -1
                seq.prefilling = False
                seq.prefix_match = None
                seq.lazy = False
                METRICS.incr("scheduler.admission_blocked")
                with self._lock:
                    self._waiting.appendleft(seq)
                return
            except BaseException as exc:  # noqa: BLE001
                self._abort_admission(seq, slot, exc)

    def _next_admission_locked(self):
        """The request the next admission takes (left in the queue). Uniform
        priorities and no tenant table: exactly the FIFO head. Otherwise
        the highest priority class first; within it the backlogged tenant
        with the least weighted-fair virtual time, skipping tenants over
        their token budget; a fully deferred class falls through."""
        if not self._waiting:
            return None
        book = self.tenants
        first = self._waiting[0]
        if all(s.priority == first.priority for s in self._waiting) and not book.configured:
            return first
        inflight: dict[str, int] = {}
        for s in self._slots:
            if s is not None and not s.finished:
                inflight[s.tenant] = inflight.get(s.tenant, 0) + min(
                    len(s.prompt_ids) + s.budget, self.engine.max_seq_len)
        for top in sorted({s.priority for s in self._waiting}, reverse=True):
            best = best_v = None
            seen: set[str] = set()
            for s in self._waiting:
                if s.priority != top or s.tenant in seen:
                    continue
                seen.add(s.tenant)
                pol = book.policy(s.tenant)
                if pol.token_budget and inflight.get(s.tenant, 0) > 0:
                    need = min(len(s.prompt_ids) + s.budget, self.engine.max_seq_len)
                    if inflight[s.tenant] + need > pol.token_budget:
                        METRICS.incr("scheduler.tenant_budget_deferred")
                        continue
                v = book.vtime(s.tenant)
                if best_v is None or v < best_v:
                    best, best_v = s, v
            if best is not None:
                return best
        return None

    def _shed_expired_locked(self) -> None:
        """Drop queued requests whose wait already blew their deadline."""
        if not any(s.deadline for s in self._waiting):
            return
        now = time.perf_counter()
        for s in [s for s in self._waiting if s.deadline and now > s.deadline]:
            self._waiting.remove(s)
            s.finished = True
            self._trace_finish(s, "deadline_exceeded")
            METRICS.incr("scheduler.requests_shed")
            s.out.put(DeadlineExceededError(
                f"request {s.rid} spent its whole "
                f"{s.deadline - s.t_queued:.1f}s deadline queued"))

    def _abort_admission(self, seq, slot: int, exc: BaseException) -> None:
        """Admission failed for ONE request: release the slot and fail only
        that sequence — unless the failure is device-scoped, which
        escalates to the loop's _fail_all."""
        from fei_tpu_torch.engine.scheduler import device_scoped

        if device_scoped(exc):
            raise exc
        self._admitting = None
        self.engine._allocator.free(slot)
        self._slots[slot] = None
        seq.finished = True
        self._trace_finish(seq, "failed")
        METRICS.incr("scheduler.requests_failed_isolated")
        seq.out.put(exc)

    def _admission_tokens(self, seq) -> int:
        """Token positions this admission reserves pages for: the full worst
        case, or (lazy) the prefill plus one multi-step scan."""
        full = min(len(seq.prompt_ids) + seq.budget, self.engine.max_seq_len)
        if not seq.lazy:
            return full
        return min(len(self._prefill_ids(seq)) + self.multistep + 1, full)

    # -- dense admission ----------------------------------------------------

    def _admit(self, seq, slot: int) -> None:
        """Dense bucketed prefill, then scatter its K/V into fresh pages."""
        FAULTS.check("admission.prefill", seq=seq, rid=seq.rid)
        eng = self.engine
        alloc = eng._allocator
        ids = self._prefill_ids(seq)
        need = alloc.pages_needed(self._admission_tokens(seq))
        if self._alloc_pages(seq, slot, need) is None:
            raise PoolPressure(f"no viable victim could free {need} pages for "
                               f"{seq.rid} at admission")
        cap = FLIGHT.capturing
        if cap:
            r = FLIGHT.open("admit.dense", tokens=len(ids))
        t0 = time.time()
        last_logits, dense = self._dense_prefill(ids)
        seq.dense_admitted = True
        self._complete_admission(seq, slot, dense, last_logits,
                                 flight=(t0, time.time()))
        if cap:
            FLIGHT.close(r)

    def _dense_prefill(self, ids: list[int]):
        """One bucketed dense forward of ``ids``: (last logits, the dense
        cache of the prompt's bucket, not of max_seq_len)."""
        from fei_tpu_torch.engine.engine import _next_bucket

        eng = self.engine
        bucket = min(_next_bucket(len(ids)), eng.max_seq_len)
        dense = eng.new_cache(1, bucket)
        with METRICS.span("prefill", nvtx=True):
            return eng.prefill([ids], dense)

    def _complete_admission(self, seq, slot: int, dense, last_logits,
                            flight: tuple | None = None) -> None:
        """Dense-path tail: sample the first token, scatter the prompt's
        K/V into its pages, arm the slot. ``flight`` is the prefill's
        (call, issue-return) times: its record closes at the first token's
        host copy, the admission's one sync."""
        eng = self.engine
        alloc = eng._allocator
        ids = self._prefill_ids(seq)
        n = len(ids)
        tok0, key = self._first_token(seq, last_logits)
        if flight is not None:
            FLIGHT.dispatch("dispatch.prefill", *flight, time.time(),
                            rid=seq.rid, mesh=self.engine.mesh_tag, slot=slot, tokens=n)
        pages = alloc.pages_for(slot)
        n_prompt_pages = alloc.pages_needed(n)
        scatter_dense(dense, self._pool, pages[:n_prompt_pages])
        row = self._slot_row(slot)
        self._arm(slot, row, n)
        self._keys[slot] = key
        seq.prefilling = False
        seq.row = row
        if seq.trace is not None:
            seq.trace.event("prefill")
        if self._prefix is not None:
            self._prefix.register(ids, pages[:n_prompt_pages])
        METRICS.incr("scheduler.prefill_tokens", n)
        self._cas_publish(seq, ids, pages)
        if seq.budget <= 0:
            self._finish(seq)
            return
        self._admit_split()
        self._deliver(seq, tok0, key=key if self._wants_key(seq) else None)

    @staticmethod
    def _wants_key(seq) -> bool:
        """The first token's key goes to the host only for a request that
        records it (journaled) or exports it (the SSE failover channel)."""
        return seq.journaled or seq.export is not None

    def _first_token(self, seq, last_logits) -> tuple[int, torch.Tensor]:
        """Sample the admission's first token on the request's own key
        chain (the dense engine's prologue, engine._prefill_sample:
        ``PRNGKey(seed)``, one split for a sampled request), with the
        first-step host mask or, for a request constrained from its first
        token, the grammar's entry mask. Returns (token, the slot's key)."""
        from fei_tpu_torch.engine.engine import _split_if_sampled

        mask = self._host_mask(seq, first=True)
        if mask is None and seq.grammar is not None and seq.gstate >= 0:
            mask = self._grammar_first_mask(seq)
        if mask is not None:
            last_logits = torch.where(mask[None, :], last_logits, float("-inf"))
        key, sub = _split_if_sampled(seq.gen, prng.PRNGKey(seq.gen.seed, self.engine.device))
        tok = int(sample_logits(
            last_logits, sub, temperature=seq.gen.temperature,
            top_k=seq.gen.top_k, top_p=seq.gen.top_p, min_p=seq.gen.min_p,
        )[0])
        return tok, key

    # -- paged-native chunked admission -------------------------------------

    def _reserve_admission(self, seq, slot: int, prefix: list[int]) -> int:
        """Reserve the slot's fresh pages (shared prefix pages were already
        handed over) and mark it prefilling. Returns the prefix page count."""
        alloc = self.engine._allocator
        m = len(prefix)
        need = alloc.pages_needed(self._admission_tokens(seq))
        if self._alloc_pages(seq, slot, need - m) is None:
            raise PoolPressure(f"no viable victim could free {need - m} pages for "
                               f"{seq.rid} at admission")
        seq.prefilling = True
        return m

    def _start_chunked_paged(self, seq, slot: int, prefix: list[int] | None = None) -> None:
        """Begin a paged-native chunked admission. The slot's row in the
        live table stays ZERO until completion, so interleaved decode
        steps write this slot's idle token to the null page."""
        prefix = prefix or []
        m = self._reserve_admission(seq, slot, prefix)
        self._admitting = {
            "seq": seq, "slot": slot, "row": self._slot_row(slot),
            "pos": m * self.engine.page_size, "prefix": m,
        }
        self._admit_chunk()

    def _admit_chunk(self) -> None:
        """Run (or defer for merging) ONE prefill chunk of the in-flight
        chunked admission (an ``admit.chunk`` range while the flight
        recorder captures)."""
        if not FLIGHT.capturing:
            self._admit_one_chunk()
            return
        r = FLIGHT.open("admit.chunk")
        try:
            self._admit_one_chunk()
        finally:
            FLIGHT.close(r)

    def _admit_one_chunk(self) -> None:
        if self._pending_chunk is not None:
            # a deferred chunk no decode dispatch consumed: its solo
            # dispatch is this call's one-chunk budget
            self._flush_pending_chunk()
            return
        st = self._admitting
        seq = st["seq"]
        if seq.finished:
            self._admitting = None
            return
        if seq.cancelled:
            self._admitting = None
            self._finish(seq)
            return
        FAULTS.check("admission.prefill", seq=seq, rid=seq.rid)
        eng = self.engine
        C = self.prefill_chunk
        prompt = self._prefill_ids(seq)
        n, lo = len(prompt), st["pos"]
        end = n
        if seq.generated:
            # preempt-resume: chunk-prefill only the prompt (and cached
            # prefix) positions, then replay the generated suffix through
            # the decode-shaped [B, 1] forward, so the rebuilt KV is
            # bitwise what the decode steps wrote
            end = min(n, max(len(seq.prompt_ids), st["prefix"] * eng.page_size))
            if seq.dense_admitted and lo == 0:
                # the prompt was admitted through the dense route (and so
                # matched no prefix here): rebuild its K/V the same way
                # (this call's one-chunk budget)
                _, dense = self._dense_prefill(seq.prompt_ids)
                pages = eng._allocator.pages_for(st["slot"])
                scatter_dense(dense, self._pool, pages[:eng._allocator.pages_needed(end)])
                st["pos"] = end
                return
            if lo >= end:
                if lo < n:
                    hi = min(lo + max(1, self.multistep), n)
                    t0 = time.time()
                    with METRICS.span("prefill_chunk", nvtx=True):
                        self._replay(prompt[lo:hi], st["row"], st["slot"], lo)
                    t1 = time.time()
                    FLIGHT.dispatch("dispatch.prefill_chunk", t0, t1, t1, rid=seq.rid,
                                    mesh=self.engine.mesh_tag, slot=st["slot"], tokens=hi - lo,
                                    replay=True)
                    METRICS.incr("scheduler.resume_replayed_tokens", hi - lo)
                    st["pos"] = hi
                    if hi < n:
                        return  # more replay; decode interleaves
                self._admitting = None
                self._complete_admission_paged(seq, st["slot"], None, st["row"],
                                               prefix_pages=st["prefix"])
                return
        hi = min(lo + C, end)
        toks = np.zeros((1, C), dtype=np.int64)
        toks[0, : hi - lo] = prompt[lo:hi]
        final = hi >= end
        if (self.ragged_attention and not seq.generated
                and any(s is not None and not s.prefilling for s in self._slots)):
            # DEFER: the next decode dispatch merges this chunk with its
            # first step; if no dispatch runs, _step_active's flush sends
            # it solo — the admission still advances one chunk per loop
            self._pending_chunk = {"st": st, "toks": toks, "lo": lo, "hi": hi,
                                   "final": final, "ntok": end}
            return
        self._dispatch_chunk_solo(st, seq, toks, lo, hi, final, end)

    def _dispatch_chunk_solo(self, st: dict, seq, toks: np.ndarray, lo: int, hi: int,
                             final: bool, end: int) -> None:
        """Run one paged-native prefill chunk as its own forward. Its result
        is read at the admission's first token, so its record carries no
        sync time (the dispatch itself adds no sync)."""
        t0 = time.time()
        with METRICS.span("prefill_chunk", nvtx=True):
            # a resume's prompt chunks need no logits: it samples nothing
            last_logits = self._paged_chunk(toks, st["row"], lo, end - 1 - lo,
                                            final and not seq.generated)
        t1 = time.time()
        FLIGHT.dispatch("dispatch.prefill_chunk", t0, t1, t1, rid=seq.rid,
                        mesh=self.engine.mesh_tag, slot=st["slot"], tokens=hi - lo,
                        paged=True)
        st["pos"] = hi
        if not final or seq.generated:
            return  # more prompt chunks, or a resume's replay still to run
        self._admitting = None
        self._complete_admission_paged(seq, st["slot"], last_logits, st["row"],
                                       prefix_pages=st["prefix"])

    def _flush_pending_chunk(self) -> None:
        """Solo-dispatch a deferred chunk that no decode dispatch consumed."""
        pc = self._pending_chunk
        if pc is None:
            return
        self._pending_chunk = None
        st = pc["st"]
        if st is not self._admitting:
            return  # admission aborted/completed elsewhere: drop it
        seq = st["seq"]
        if seq.finished or seq.cancelled:
            return  # the next _admit_chunk call reaps it
        try:
            self._dispatch_chunk_solo(st, seq, pc["toks"], pc["lo"], pc["hi"],
                                      pc["final"], pc["ntok"])
        except BaseException as exc:  # noqa: BLE001
            self._abort_admission(seq, st["slot"], exc)

    def _finish_merged_chunk(self, pc: dict, chunk_logits) -> None:
        """Host bookkeeping for a chunk that rode a merged dispatch."""
        st = pc["st"]
        st["pos"] = pc["hi"]
        if not pc["final"]:
            return
        self._admitting = None
        self._complete_admission_paged(st["seq"], st["slot"], chunk_logits, st["row"],
                                       prefix_pages=st["prefix"])

    def _paged_chunk(self, toks: np.ndarray, row: np.ndarray, pos: int, last_idx: int,
                     final: bool):
        """Forward [1, C] tokens against a one-slot view of the pool (the
        slot's table row, its absolute position as the length). Pad tokens
        of a final partial chunk write above the prompt into the slot's
        reserved pages (or the null page) and are never attended. Only the
        final chunk projects one position through the LM head; returns its
        logits [1, V] (None otherwise)."""
        from fei_tpu_torch.models.llama import _logits, forward_paged_block

        eng = self.engine
        dev = self._pool.k_pages.device
        view = self._pool._replace(
            block_table=torch.as_tensor(row[None], dtype=torch.int32).to(dev),
            lengths=torch.tensor([pos], dtype=torch.int32, device=dev),
        )
        hidden, _ = forward_paged_block(
            eng.params, eng.cfg, torch.as_tensor(toks).to(dev), view, lm_head=False,
            moe_mesh=eng._moe_mesh())
        if not final:
            return None
        return _logits(hidden[:, last_idx:last_idx + 1], eng.params, eng.cfg)[:, 0]

    def _replay(self, tokens: list[int], row: np.ndarray, slot: int, start: int) -> None:
        """Feed already-sampled tokens through the SAME [B, 1] forward the
        decode steps use, writing K/V into the resuming slot's pages. Other
        slots' rows are zero in the replay view (their writes land in the
        null page; each row's arithmetic is its own), and the live table is
        untouched, so interleaved decode never sees the half-built slot."""
        from fei_tpu_torch.models.llama import forward_paged

        eng = self.engine
        pool = self._pool
        dev = pool.k_pages.device
        bt = torch.zeros_like(pool.block_table)
        bt[slot] = torch.as_tensor(row, dtype=torch.int32).to(dev)
        lengths = torch.zeros_like(pool.lengths)
        lengths[slot] = start
        view = pool._replace(block_table=bt, lengths=lengths)
        for t in tokens:
            step = torch.zeros((self.B, 1), dtype=torch.long)
            step[slot, 0] = t
            _, view = forward_paged(eng.params, eng.cfg, step.to(dev), view)

    def _complete_admission_paged(self, seq, slot: int, last_logits, row: np.ndarray,
                                  prefix_pages: int = 0) -> None:
        """Paged-native tail: sample the first token (a resume re-installs
        its key and keeps its last token as the next input), arm the
        slot's row and length, register the prefix."""
        eng = self.engine
        alloc = eng._allocator
        ids = self._prefill_ids(seq)
        n = len(ids)
        resume = bool(seq.generated)
        if resume:
            key = seq.resume_key
        else:
            tok0, key = self._first_token(seq, last_logits)
        pages = alloc.pages_for(slot)
        self._arm(slot, row, n)
        self._keys[slot] = key
        seq.prefilling = False
        seq.row = np.array(row)
        if seq.trace is not None:
            seq.trace.event("prefill")
        if self._prefix is not None:
            self._prefix.register(ids, pages[: alloc.pages_needed(n)])
        if resume:
            self._resume_delivered(seq, n, prefix_pages)
            return
        METRICS.incr("scheduler.prefill_tokens", max(0, n - prefix_pages * alloc.page_size))
        self._cas_publish(seq, ids, pages)
        if seq.budget <= 0:
            self._finish(seq)
            return
        self._admit_split()
        self._deliver(seq, tok0, key=key if self._wants_key(seq) else None)

    def _resume_delivered(self, seq, n: int, prefix_pages: int,
                          recomputed: int | None = None) -> None:
        """Resume tail: the stream continues with no token delivered twice
        or dropped. A warm-restart replay first re-emits the recorded
        tokens to the fresh consumer (the old process's queue is gone).
        ``recomputed`` overrides the replay-cost accounting: a streamed
        resume passes 0 (it recomputes nothing)."""
        alloc = self.engine._allocator
        seq.next_input = seq.generated[-1]
        if seq.trace is not None:
            seq.trace.event("resumed")
        FLIGHT.event("resume", rid=seq.rid, slot=seq.slot,
                     generated=len(seq.generated), prefix_pages=prefix_pages)
        METRICS.incr("scheduler.preempted_tokens_recomputed",
                     max(0, n - prefix_pages * alloc.page_size)
                     if recomputed is None else recomputed)
        if seq.replay:
            for t in seq.generated:
                seq.out.put(t)
            seq.replay = False
            METRICS.incr("scheduler.replayed_tokens", len(seq.generated))
        if len(seq.generated) >= seq.budget:
            self._finish(seq)

    # -- the KV tier ----------------------------------------------------------

    def _try_streamed_resume(self, seq, slot: int, prefix: list[int]) -> bool:
        """Resume a preempted sequence by scattering its spilled pages back
        from the KV tier instead of replaying tokens. True = the slot is
        armed and the stream continues (zero tokens recomputed); False = no
        usable entry, and the caller takes the replay route. Only
        ``PoolPressure`` escapes (from the reservation, to the caller's
        requeue handler); every tier-side failure becomes a replay here.

        The entry's arrays are the exact pool bytes the slot held at
        preemption (``_spill_seq`` gathers after checking the device
        length). Prefix pages the registry shares into the slot are never
        overwritten (a live co-resident may be attending them), and the
        replay route reads those same pages; the rest is restored bitwise.
        The saved key re-installs exactly as on the replay route."""
        tier = self._kv_tier
        if tier is None or seq.resume_key is None:
            return False
        if self.engine.cfg.sliding_window:
            return False
        from fei_tpu_torch.kv.pagesio import canonicalize_arrays, pool_fingerprint, scatter_pages
        from fei_tpu_torch.utils.errors import KVGeometryError

        alloc = self.engine._allocator
        ids = self._prefill_ids(seq)
        n = len(ids)
        try:
            entry = tier.fetch(seq.rid)
        except Exception as exc:  # noqa: BLE001 — corrupt file, I/O error,
            # injected hang: all mean "replay instead"
            METRICS.incr("kv.fetch_fallbacks")
            log.warning("kv fetch for %s failed (%r); falling back to replay", seq.rid, exc)
            return False
        if entry is None:
            return False
        need = alloc.pages_needed(n)
        want = pool_fingerprint(self._pool, self.engine.tp)
        if (entry.n_tokens != n or entry.page_size != self.engine.page_size
                or entry.n_pages < need or entry.fingerprint != want):
            # stale (decoded past the spill) or invariant-incompatible:
            # useless now and forever
            tier.drop(seq.rid)
            METRICS.incr("kv.fetch_fallbacks")
            return False
        try:
            arrays = canonicalize_arrays(entry.arrays, entry.layout, want["kv_heads"])
        except KVGeometryError:
            tier.drop(seq.rid)  # partial head coverage: replay instead
            METRICS.incr("kv.fetch_fallbacks")
            return False
        # commits pages to the slot; PoolPressure propagates to the
        # caller's requeue handler exactly like the replay routes
        m = self._reserve_admission(seq, slot, prefix)
        t0 = time.time()
        pages = alloc.pages_for(slot)
        with METRICS.span("kv_fetch"):
            # blocking host -> device copies: the entry may go right after
            scatter_pages(self._pool, pages[m:need], {k: v[m:need] for k, v in arrays.items()})
        row = self._slot_row(slot)
        self._arm(slot, row, n)
        self._keys[slot] = seq.resume_key
        t1 = time.time()
        seq.prefilling = False
        seq.row = row
        if seq.trace is not None:
            seq.trace.event("prefill")
        if self._prefix is not None:
            self._prefix.register(ids, pages[:need])
        METRICS.incr("kv.fetches")
        METRICS.incr("kv.pages_restored", need - m)
        nbytes = sum(int(v[m:need].nbytes) for v in arrays.values())
        account_kv_transfer("fetched", nbytes, t1 - t0)
        FLIGHT.dispatch("dispatch.kv_fetch", t0, t1, t1, rid=seq.rid, mesh=self.engine.mesh_tag,
                        slot=slot, pages=need - m, bytes=nbytes)
        tier.drop(seq.rid)  # one-shot: a later preemption re-spills
        self._resume_delivered(seq, n, prefix_pages=m, recomputed=0)
        return True

    def _try_cas_admit(self, seq, slot: int, prefix: list[int]) -> list[int]:
        """Local prefix shortfall -> content-addressed tier fetch.
        ``prefix`` is the local prefix-cache match already shared into
        ``slot``. Probes the prompt's page-boundary content hashes
        longest-first for a boundary PAST the local match; on a hit,
        allocates only the missing pages under a pseudo-id, scatters the
        blob's tail, registers the full prefix and shares the new pages
        into ``slot`` (kv/migrate.py's import, keyed by content). Returns
        the full prefix page list now shared into the slot ([] = nothing
        gained: the caller keeps its local match). Never raises: a
        tier-side failure degrades to plain prefill."""
        tier = self._kv_tier
        if tier is None or not self._cas_enabled or self._prefix is None:
            return []
        from fei_tpu_torch.kv.pagesio import canonicalize_arrays, pool_fingerprint, scatter_pages
        from fei_tpu_torch.utils.errors import KVGeometryError

        alloc = self.engine._allocator
        ids = self._prefill_ids(seq)
        ps = self.engine.page_size
        have = len(prefix)
        # strictly shorter than the prompt, like PrefixCache.match: one
        # suffix token must remain to produce logits
        max_m = (len(ids) - 1) // ps
        if max_m <= have:
            return []
        try:
            keys = self._cas_keys(ids, max_m)
            for m in range(max_m, have, -1):
                key = keys[m - 1]
                if not tier.contains(key):
                    continue
                entry = tier.fetch(key)  # kv.fetch faults fire here
                if entry is None:
                    continue
                want = pool_fingerprint(self._pool, self.engine.tp)
                if (entry.n_tokens != m * ps or entry.page_size != ps
                        or entry.n_pages != m or entry.fingerprint != want):
                    tier.drop(key)  # stale or incompatible: try shorter
                    continue
                try:
                    cas_arrays = canonicalize_arrays(entry.arrays, entry.layout,
                                                     want["kv_heads"])
                except KVGeometryError:
                    tier.drop(key)
                    continue
                if entry.layout is not None and entry.layout.get("tp") != self.engine.tp:
                    METRICS.incr("kv.resharded_imports")
                # the blob carries all m pages from position 0; the first
                # ``have`` are in the slot already: fetch only the tail
                grow = m - have
                got = alloc.try_alloc(_CAS_ID, grow)
                if got is None:
                    self._prefix.evict_for(grow)
                    got = alloc.try_alloc(_CAS_ID, grow)
                if got is None:
                    return []  # no room even after eviction: prefill
                try:
                    t0 = time.time()
                    with METRICS.span("kv_fetch"):
                        scatter_pages(self._pool, got,
                                      {k: v[have:m] for k, v in cas_arrays.items()})
                    t1 = time.time()
                    full = list(prefix) + list(got)
                    self._prefix.register(ids[: m * ps], full)
                    alloc.share(slot, got)
                finally:
                    # the registry and slot refs keep the pages; the
                    # fetch's own claim dies even if the scatter raised
                    alloc.free(_CAS_ID)
                METRICS.incr("kv.prefix_hits_tier")
                METRICS.incr("kv.prefix_tokens_saved", grow * ps)
                nbytes = sum(int(v[have:m].nbytes) for v in entry.arrays.values())
                account_kv_transfer("fetched", nbytes, t1 - t0)
                FLIGHT.dispatch("dispatch.kv_cas_fetch", t0, t1, t1, rid=seq.rid,
                                mesh=self.engine.mesh_tag, slot=slot, pages=grow,
                                bytes=nbytes)
                return full
        except Exception as exc:  # noqa: BLE001 — corrupt entry, I/O error,
            # injected hang: all mean "prefill instead"
            METRICS.incr("kv.fetch_fallbacks")
            log.warning("cas prefix fetch for %s failed (%r); prefilling", seq.rid, exc)
        return []

    def _cas_publish(self, seq, ids, pages) -> None:
        """Publish a freshly admitted prompt's full-page prefix under its
        content hash, to every session here (the tier) and to other
        replicas (``GET /kv/prefix/<hash>``). ``put_if_absent`` stores at
        most one copy however many sessions admit the same prefix (the
        gather runs only on absence), and each live session pins the key.
        Best-effort: a failure only costs future fetch hits."""
        tier = self._kv_tier
        if tier is None or not self._cas_enabled:
            return
        ps = self.engine.page_size
        # the strictly-shorter boundary a consumer can ask for (an
        # admission keeps one token to prefill for logits)
        m = (len(ids) - 1) // ps
        if m <= 0:
            return
        from fei_tpu_torch.kv.pagesio import gather_pages, pool_fingerprint, shard_layout
        from fei_tpu_torch.kv.tier import PageEntry

        try:
            key = self._cas_keys(ids, m)[m - 1]
            if seq.cas_key is None:
                tier.pin(key)
                seq.cas_key = key

            def make_entry() -> PageEntry:
                with METRICS.span("kv_spill"):
                    arrays = gather_pages(self._pool, list(pages[:m]))
                fp = pool_fingerprint(self._pool, self.engine.tp)
                return PageEntry(key=key, n_tokens=m * ps, page_size=ps, fingerprint=fp,
                                 arrays=arrays, layout=shard_layout(fp["kv_heads"], self.engine.tp))

            tier.put_if_absent(key, make_entry)
        except Exception as exc:  # noqa: BLE001 — the admission stands
            METRICS.incr("kv.spill_failures")
            log.warning("cas publish for %s failed: %r", seq.rid, exc)
