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
The JAX package's dense-staging chunked route, its sp admission, the KV
tier and its fallbacks for a kernel Mosaic rejects have no counterpart
here: a kernel failure fails the requests, it is never rerouted.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from fei_tpu_torch.engine.faults import FAULTS
from fei_tpu_torch.engine.sampling import sample_logits
from fei_tpu_torch.utils.errors import DeadlineExceededError, EngineError, PoolPressure
from fei_tpu_torch.utils.metrics import METRICS


class AdmissionMixin:
    """Request admission: queue -> slot -> prefilled pages -> first token."""

    def _admit_ready(self) -> None:
        """Fill free slots while the pool has pages. A chunked admission in
        flight gets exactly one chunk per call, so the loop interleaves it
        with decode. Head-of-line blocking on the chosen candidate is
        deliberate: a too-big-for-now request eventually runs."""
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
            METRICS.observe("queue_wait_seconds", time.perf_counter() - seq.t_queued)
            self._update_sched_gauges()
            try:
                if prefix or len(ids) > self.prefill_chunk or seq.generated:
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
        last_logits, dense = self._dense_prefill(ids)
        seq.dense_admitted = True
        self._complete_admission(seq, slot, dense, last_logits)

    def _dense_prefill(self, ids: list[int]):
        """One bucketed dense forward of ``ids``: (last logits, the dense
        cache of the prompt's bucket, not of max_seq_len)."""
        from fei_tpu_torch.engine.engine import _next_bucket
        from fei_tpu_torch.models.llama import KVCache

        eng = self.engine
        bucket = min(_next_bucket(len(ids)), eng.max_seq_len)
        dense = KVCache.create(eng.cfg, 1, bucket, dtype=eng.dtype, device=eng.device)
        with METRICS.span("prefill"):
            return eng.prefill([ids], dense)

    def _complete_admission(self, seq, slot: int, dense, last_logits) -> None:
        """Dense-path tail: sample the first token, scatter the prompt's
        K/V into its pages, arm the slot."""
        eng = self.engine
        alloc = eng._allocator
        ids = self._prefill_ids(seq)
        n = len(ids)
        tok0 = self._first_token(seq, last_logits)
        pages = alloc.pages_for(slot)
        n_prompt_pages = alloc.pages_needed(n)
        self._scatter_dense(dense, pages[:n_prompt_pages])
        row = self._slot_row(slot)
        self._arm(slot, row, n)
        seq.prefilling = False
        seq.row = row
        if self._prefix is not None:
            self._prefix.register(ids, pages[:n_prompt_pages])
        METRICS.incr("scheduler.prefill_tokens", n)
        if seq.budget <= 0:
            self._finish(seq)
            return
        self._deliver(seq, tok0)

    def _scatter_dense(self, dense, page_ids: list[int]) -> None:
        """Copy the first len(page_ids)*ps positions of a [L, 1, S, K, D]
        dense cache into those pool pages (one indexed write per pool;
        int8 pools quantize per (position, head) row)."""
        from fei_tpu_torch.engine.paged_cache import quant_kv_rows

        pool = self._pool
        ps = pool.page_size
        n_pages = len(page_ids)
        need = n_pages * ps
        idx = torch.as_tensor(page_ids, dtype=torch.long, device=pool.k_pages.device)

        def pages_of(x):  # [L, 1, S, K, D] -> [L, n_pages, K, ps, D]
            x = x[:, 0, :need]
            if x.shape[1] < need:
                x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, need - x.shape[1]))
            L, _, K, D = x.shape
            return x.reshape(L, n_pages, ps, K, D).transpose(2, 3)

        for src, dst, scales in ((dense.k, pool.k_pages, pool.k_scales),
                                 (dense.v, pool.v_pages, pool.v_scales)):
            blocks = pages_of(src)
            if scales is not None:
                blocks, s = quant_kv_rows(blocks)  # s: [L, n, K, ps]
                scales[:, idx] = s[:, :, :, None, :]
            dst[:, idx] = blocks.to(dst.dtype)

    def _first_token(self, seq, last_logits) -> int:
        """Sample the admission's first token on the request's own
        generator, created here from its seed (the dense engine's
        prologue, engine._prefill_sample), with the first-step host mask
        or, for a request constrained from its first token, the grammar's
        entry mask."""
        mask = self._host_mask(seq, first=True)
        if mask is None and seq.grammar is not None and seq.gstate >= 0:
            mask = self._grammar_first_mask(seq)
        if mask is not None:
            last_logits = torch.where(mask[None, :], last_logits, float("-inf"))
        seq.generator = torch.Generator(device=self.engine.device).manual_seed(
            int(seq.gen.seed))
        return int(sample_logits(
            last_logits, seq.generator, temperature=seq.gen.temperature,
            top_k=seq.gen.top_k, top_p=seq.gen.top_p, min_p=seq.gen.min_p,
        )[0])

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
        chunked admission."""
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
                self._scatter_dense(dense, pages[:eng._allocator.pages_needed(end)])
                st["pos"] = end
                return
            if lo >= end:
                if lo < n:
                    hi = min(lo + max(1, self.multistep), n)
                    with METRICS.span("prefill_chunk"):
                        self._replay(prompt[lo:hi], st["row"], st["slot"], lo)
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
        """Run one paged-native prefill chunk as its own forward."""
        with METRICS.span("prefill_chunk"):
            # a resume's prompt chunks need no logits: it samples nothing
            last_logits = self._paged_chunk(toks, st["row"], lo, end - 1 - lo,
                                            final and not seq.generated)
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
            eng.params, eng.cfg, torch.as_tensor(toks).to(dev), view, lm_head=False)
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
        """Paged-native tail: sample the first token (a resume keeps its
        generator and its last token as the next input), arm the slot's
        row and length, register the prefix."""
        eng = self.engine
        alloc = eng._allocator
        ids = self._prefill_ids(seq)
        n = len(ids)
        resume = bool(seq.generated)
        if not resume:
            tok0 = self._first_token(seq, last_logits)
        pages = alloc.pages_for(slot)
        self._arm(slot, row, n)
        seq.prefilling = False
        seq.row = np.array(row)
        if self._prefix is not None:
            self._prefix.register(ids, pages[: alloc.pages_needed(n)])
        if resume:
            seq.next_input = seq.generated[-1]
            METRICS.incr("scheduler.preempted_tokens_recomputed",
                         max(0, n - prefix_pages * alloc.page_size))
            if len(seq.generated) >= seq.budget:
                self._finish(seq)
            return
        METRICS.incr("scheduler.prefill_tokens", max(0, n - prefix_pages * alloc.page_size))
        if seq.budget <= 0:
            self._finish(seq)
            return
        self._deliver(seq, tok0)
