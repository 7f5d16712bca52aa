"""Decode-step half of the paged scheduler (counterpart of
fei_tpu/engine/sched_decode.py): batched decode dispatches over the armed
slots — the host-masked single step and the multi-step scan that runs up
to ``multistep`` steps per host sync — and the merged dispatch in which a
pending prefill chunk rides the scan's first step (``forward_paged_merged``,
the ragged kernel). Every step runs one sampling tail (``_make_sampler``):
the grammar's per-slot DFA mask and state step on the device, an optional
host mask, the per-row draw. A tool-call slot whose trigger completes
mid-scan rolls back to that token (``_rollback_slots``). A mixin over
PagedScheduler state.

Prompt-lookup speculation (C3) is a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from fei_tpu_torch.engine.faults import FAULTS
from fei_tpu_torch.engine.sampling import sample_logits_dynamic
from fei_tpu_torch.utils.metrics import METRICS


def _make_sampler(active, B: int, table=None, mind=None):
    """The ONE sampling tail every decode step of a dispatch runs: the
    grammar's per-slot DFA mask (``table``/``mind`` given: rows with
    ``gstate < 0`` — free phase or no grammar — pass unmasked; budget
    feasibility and the state step are the dense fused decode's,
    grammar.grammar_step), an optional host mask, then per-row knobs and
    generators from the active slots (other rows are greedy and draw
    nothing), and the DFA state step. All on the device. Shared by the
    solo scan and the merged first step."""
    from fei_tpu_torch.engine.grammar import grammar_step

    gens = [None] * B
    temps, topks, topps, minps = [0.0] * B, [0] * B, [1.0] * B, [0.0] * B
    for b, s in active:
        gens[b] = s.generator
        temps[b] = float(s.gen.temperature)
        topks[b] = int(s.gen.top_k)
        topps[b] = float(s.gen.top_p)
        minps[b] = float(s.gen.min_p)

    def sample(logits, mask=None, gstates=None, gremain=None):
        if table is not None:
            logits, advance = grammar_step(
                logits, table, mind, gstates, gremain, use=gstates >= 0)
        if mask is not None:
            logits = torch.where(mask, logits, float("-inf"))
        nxt = sample_logits_dynamic(logits, gens, temps, topks, topps, minps)
        if table is not None:
            gstates, gremain = advance(nxt)
        return nxt, gstates, gremain

    return sample


class DecodeMixin:
    """Batched decode stepping: single and multi-step dispatches."""

    def _step_active(self) -> None:
        self._step_active_impl()
        # a deferred admission chunk this iteration's dispatch did not
        # consume still makes progress now: bounded-stall admission is a
        # guarantee, not a fast path
        self._flush_pending_chunk()

    def _step_active_impl(self) -> None:
        if self._try_multi_step():
            return
        # evaluate per-request masks FIRST: a mask_fn that raises must kill
        # only its own request
        masks: dict[int, torch.Tensor] = {}
        for b, s in list(enumerate(self._slots)):
            if s is None or s.prefilling or s.mask_fn is None:
                continue
            try:
                m = self._host_mask(s)
            except BaseException as exc:  # noqa: BLE001
                self._fail_seq(s, exc)
                continue
            if m is not None:
                masks[b] = m
        active = [(b, s) for b, s in enumerate(self._slots)
                  if s is not None and not s.prefilling]
        if not active:
            return
        mask = None
        if masks:
            mask = torch.ones((self.B, self.engine.cfg.vocab_size), dtype=torch.bool,
                              device=self.engine.device)
            for b, m in masks.items():
                mask[b] = m
            METRICS.incr("scheduler.host_mask_uploads", len(masks))
        toks, active = self._dispatch_steps(active, 1, mask=mask)
        for b, s in active:
            if self._slots[b] is s:
                self._deliver(s, int(toks[b, 0]))

    def _try_multi_step(self) -> bool:
        """Run up to ``multistep`` decode steps in ONE dispatch (one host
        sync): the scheduler's steady state, queued and chunked admissions
        included (one chunk interleaves with one scan per loop iteration).
        Only a host mask on an armed slot forces single steps. The depth
        is the power of two covering the DEEPEST remaining budget (capped):
        a slot that finishes mid-scan has its scanned tail discarded at
        delivery, so nearly-done streams never throttle the batch."""
        cap = self.multistep
        if cap <= 1:
            return False
        active = [(b, s) for b, s in enumerate(self._slots)
                  if s is not None and not s.prefilling]
        # only a host mask forces single steps: grammar slots scan, their
        # DFA stepping on the device (constrained) or their trigger watched
        # at delivery (free phase, rolled back on a mid-scan trigger)
        if not active or any(s.mask_fn is not None for _, s in active):
            return False
        headroom = max(s.budget - len(s.generated) for _, s in active)
        n = 1
        while n < headroom and n < cap:
            n *= 2
        if n <= 1:
            return False
        toks, active = self._dispatch_steps(active, n)
        METRICS.incr("scheduler.multi_steps")
        METRICS.incr("scheduler.multi_tokens", n)
        if self._waiting or self._admitting is not None:
            METRICS.incr("scheduler.turbo_under_admission")
        rollback: dict[int, int] = {}
        for b, s in active:
            for i in range(n):
                if self._slots[b] is not s:  # finished at an earlier step
                    break
                was_free = s.grammar is not None and s.gstate < 0
                self._deliver(s, int(toks[b, i]))
                if was_free and i < n - 1 and self._slots[b] is s and s.gstate >= 0:
                    # the tool-call trigger completed mid-scan: the steps
                    # past i were sampled unconstrained — discard them and
                    # re-enter constrained decode from the exact token
                    rollback[b] = i
                    break
        if rollback:
            self._rollback_slots(rollback, n)
        return True

    def _rollback_slots(self, rollback: dict[int, int], n: int) -> None:
        """Roll mid-scan-triggered slots back to their delivered frontier.

        ``rollback`` maps a slot to the last scan step it delivered, ``i``.
        Every slot's pool length is set from the host's own state (prompt
        plus generated, less the pending next input, whose K/V is written
        when it is fed): for a slot that delivered the whole scan this is
        the scan's own length; for a free or prefilling slot, 0, as
        eviction leaves it. Each rolled-back slot's generator returns to
        its state after step ``i`` (``i + 1`` draws of the scan), the
        per-token path's state after the same tokens. The K/V of the
        discarded steps stay above the new length, never attended, and are
        overwritten slot by slot."""
        from fei_tpu_torch.engine.paged_cache import replace_lengths

        lengths = np.zeros((self.B,), dtype=np.int32)
        for b, s in enumerate(self._slots):
            if s is not None and not s.prefilling:
                lengths[b] = len(s.prompt_ids) + len(s.generated) - 1
        self._pool = replace_lengths(self._pool, lengths)
        for b, i in rollback.items():
            states = self._step_gen_states.get(b)
            if states:
                self._slots[b].generator.set_state(states[i])
        METRICS.incr("scheduler.turbo_rollbacks", len(rollback))
        METRICS.incr("scheduler.turbo_rollback_tokens",
                     sum(n - 1 - i for i in rollback.values()))

    def _grow_for_steps(self, active, n: int) -> None:
        """Pre-dispatch growth for LAZY reservations: every active lazy slot
        gets pages for its next ``n`` positions, under the pressure API
        (prefix-cache evict, then preempt the least-progressed victim). A
        slot that cannot grow preempts ITSELF and re-admits later — the
        request is deferred, never failed."""
        eng = self.engine
        alloc = eng._allocator
        for b, s in active:
            if not s.lazy or self._slots[b] is not s or s.row is None:
                continue
            L = len(s.prompt_ids) + len(s.generated) - 1
            target = min(len(s.prompt_ids) + s.budget, eng.max_seq_len)
            want = min(L + n, target)
            # capacity is ABSOLUTE: window releases drop leading pages from
            # pages_for while the row keeps them
            have = s.released_pages + len(alloc.pages_for(b))
            grow = alloc.pages_needed(want) - have
            if grow <= 0:
                continue
            got = self._alloc_pages(s, b, grow, locked=False)
            if got is None:
                self._preempt_seq(s, locked=False)
                continue
            for i, p in enumerate(got):
                s.row[have + i] = p
            self._arm(b, s.row, L)
            METRICS.incr("scheduler.lazy_grown_pages", len(got))

    def _dispatch_steps(self, active, n: int, mask: torch.Tensor | None = None):
        """Run ``n`` batched decode steps (a pending chunk merged into the
        first one) with no host sync between them; returns (tokens [B, n]
        on the host, the active slots that took part). Slots preempted by
        the growth pass drop out before anything is sampled for them, so
        their generators draw nothing they would not deliver."""
        from fei_tpu_torch.models.llama import _logits, forward_paged, forward_paged_merged

        self._grow_for_steps(active, n)
        active = [(b, s) for b, s in active if self._slots[b] is s]
        if not active:
            return None, []
        FAULTS.check("decode.dispatch")
        eng = self.engine
        dev = self._pool.k_pages.device
        tokens = torch.zeros((self.B, 1), dtype=torch.long)
        live = torch.zeros((self.B,), dtype=torch.bool)
        for b, s in active:
            tokens[b, 0] = s.next_input
            live[b] = True
        pool = self._pool
        # idle rows restart at length 0 every dispatch: their writes go to
        # the null page and their attention reads its first slot only
        pool = pool._replace(lengths=torch.where(
            live.to(dev), pool.lengths, torch.zeros_like(pool.lengths)))
        pc = None
        if mask is None and self._pending_chunk is not None:
            pc, self._pending_chunk = self._pending_chunk, None
            if pc["st"] is not self._admitting:
                pc = None  # admission moved on (cancelled/aborted): drop
        gstates = gremain = table = mind = None
        grammar_rows = [(b, s) for b, s in active if s.grammar is not None and s.gstate >= 0]
        if grammar_rows:
            # the [B] state/budget vectors ride one upload with the token
            # ids; the [S, V] table never leaves the device
            gs = torch.full((self.B,), -1, dtype=torch.int32)
            gr = torch.zeros((self.B,), dtype=torch.int32)
            for b, s in grammar_rows:
                gs[b] = s.gstate
                gr[b] = s.budget - len(s.generated)
            gstates, gremain = gs.to(dev), gr.to(dev)
            table, mind = self._gtable, self._gmind
        # a free-phase tool-call row may roll back to any step of the scan:
        # its sampled draws keep the generator's state after each step
        # (get_state: host memory, no sync)
        roll_rows = [(b, s) for b, s in active
                     if s.grammar is not None and s.gstate < 0 and s.gen.temperature > 0]
        self._step_gen_states = {b: [] for b, _ in roll_rows}
        sample = _make_sampler(active, self.B, table, mind)
        METRICS.incr("scheduler.decode_steps", n)
        METRICS.incr("scheduler.decode_slot_steps", len(active) * n)
        METRICS.gauge("scheduler.batch_slots_active", len(active))
        chunk_logits = None
        tok = tokens.to(dev)
        outs = []
        with METRICS.span("decode_step"):
            for i in range(n):
                if i == 0 and pc is not None:
                    st = pc["st"]
                    chunk_hidden, logits, pool = forward_paged_merged(
                        eng.params, eng.cfg, torch.as_tensor(pc["toks"]).to(dev),
                        torch.as_tensor(st["row"][None], dtype=torch.int32).to(dev),
                        pc["lo"], tok, pool, rows=self.ragged_rows,
                    )
                    if pc["final"]:
                        last = pc["ntok"] - 1 - pc["lo"]
                        chunk_logits = _logits(chunk_hidden[:, last:last + 1],
                                               eng.params, eng.cfg)[:, 0]
                else:
                    logits, pool = forward_paged(eng.params, eng.cfg, tok, pool)
                nxt, gstates, gremain = sample(logits[:, -1, :], mask, gstates, gremain)
                for b, s in roll_rows:
                    self._step_gen_states[b].append(s.generator.get_state())
                outs.append(nxt)
                tok = nxt[:, None].long()
            self._pool = pool
            out = torch.stack(outs, dim=1).cpu().numpy()  # the one host sync
        for _, s in active:
            s.shield = False  # survived a dispatch: victimizable again
        if pc is not None:
            METRICS.incr("engine.ragged_dispatches")
            st = pc["st"]
            try:
                self._finish_merged_chunk(pc, chunk_logits)
            except BaseException as exc:  # noqa: BLE001
                self._abort_admission(st["seq"], st["slot"], exc)
        return out, active

