"""Decode-step half of the paged scheduler (counterpart of
fei_tpu/engine/sched_decode.py): batched decode dispatches over the armed
slots — the host-masked single step and the multi-step scan that runs up
to ``multistep`` steps per host sync — and the merged dispatch in which a
pending prefill chunk rides the scan's first step (``forward_paged_merged``,
the ragged kernel). Every step runs one sampling tail (``_make_sampler``):
the grammar's per-slot DFA mask and state step on the device, an optional
host mask, one split of the sampled slots' threefry keys and the batched
per-row draw. A tool-call slot whose trigger completes mid-scan rolls back
to that token, key included (``_rollback_slots``). Prompt-lookup
speculation (``_maybe_spec_step``) takes the step first when one greedy
stream decodes alone. A mixin over PagedScheduler state.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from fei_tpu_torch.engine import prng
from fei_tpu_torch.engine.faults import FAULTS
from fei_tpu_torch.engine.sampling import RowKnobs, sample_rows
from fei_tpu_torch.obs import costmodel
from fei_tpu_torch.obs.flight import FLIGHT
from fei_tpu_torch.utils.metrics import METRICS


def _make_sampler(active, B: int, vocab: int, device, table=None, mind=None):
    """The ONE sampling tail every decode step of a dispatch runs: the
    grammar's per-slot DFA mask (``table``/``mind`` given: rows with
    ``gstate < 0`` — free phase or no grammar — pass unmasked; budget
    feasibility and the state step are the dense fused decode's,
    grammar.grammar_step), an optional host mask, then the per-slot key
    split (``jax.vmap(jax.random.split)`` in the reference) and the
    batched per-row draw, and the DFA state step. All on the device.
    Only the sampled slots' keys advance: a greedy slot draws nothing, and
    a dispatch of greedy slots splits nothing. Rows outside ``active``
    are greedy. Shared by the solo scan and the merged first step."""
    from fei_tpu_torch.engine.grammar import grammar_step

    temps, topks, topps, minps = [0.0] * B, [0] * B, [1.0] * B, [0.0] * B
    for b, s in active:
        temps[b] = float(s.gen.temperature)
        topks[b] = int(s.gen.top_k)
        topps[b] = float(s.gen.top_p)
        minps[b] = float(s.gen.min_p)
    knobs = RowKnobs(temps, topks, topps, minps, vocab, device)
    drawn = knobs.temps[:, 0] > 0.0 if knobs.sampled else None

    def sample(logits, keys, mask=None, gstates=None, gremain=None):
        if table is not None:
            logits, advance = grammar_step(
                logits, table, mind, gstates, gremain, use=gstates >= 0)
        if mask is not None:
            logits = torch.where(mask, logits, float("-inf"))
        subs = None
        if drawn is not None:
            outs = prng.split(keys)  # [B, 2, 2]
            keys = torch.where(drawn[:, None], outs[:, 0], keys)
            subs = outs[:, 1]
        nxt = sample_rows(logits, subs, knobs)
        if table is not None:
            gstates, gremain = advance(nxt)
        return nxt, keys, gstates, gremain

    return sample


class DecodeMixin:
    """Batched decode stepping: speculative, single and multi-step
    dispatches."""

    def _maybe_spec_step(self) -> bool:
        """Prompt-lookup speculation inside the scheduler: when exactly one
        greedy, unconstrained stream is decoding (or a tool-call request is
        still in its free phase), a repeated n-gram proposes draft tokens
        and ONE multi-token paged dispatch (``_spec_fn``: the paged
        kernel's block form) verifies them, giving the per-step stream's
        tokens with up to ``1 + spec_draft_len`` of them per weight read.
        A failed dispatch goes to the loop's ``_fail_all`` like every other
        kernel failure; speculation is never turned off quietly. Returns
        True if a spec step ran."""
        from fei_tpu_torch.engine.paged_cache import replace_lengths

        if not self.speculate or self._admitting is not None:
            return False
        active = [(b, s) for b, s in enumerate(self._slots) if s is not None]
        if len(active) != 1:
            return False
        b, s = active[0]
        if (
            s.prefilling
            or s.gen.temperature != 0.0
            or s.mask_fn is not None
            # a tool-call request speculates in its FREE phase only: the
            # verify cannot apply the DFA mask
            or (s.grammar is not None and s.gstate >= 0)
        ):
            return False
        eng = self.engine
        draft = eng._find_draft(s.prompt_ids + s.generated, self.spec_ngram,
                                self.spec_draft_len)
        if draft is None:
            return False
        T = 1 + self.spec_draft_len
        # the slot's pool length: prompt + generated, less the pending next
        # input whose K/V is written when it is fed
        L0 = len(s.prompt_ids) + len(s.generated) - 1
        # room is ABSOLUTE capacity: rolling-window releases drop leading
        # pages from pages_for while the row keeps them
        room = (s.released_pages + len(eng._allocator.pages_for(b))) * eng.page_size
        if L0 + T > min(room, eng.max_seq_len):
            return False
        draft = draft + [0] * (self.spec_draft_len - len(draft))
        tokens = torch.zeros((self.B, T), dtype=torch.long)
        tokens[b] = torch.tensor([s.next_input] + draft)
        dev = self._pool.k_pages.device
        lengths = np.zeros((self.B,), dtype=np.int32)
        lengths[b] = L0
        # idle rows at length 0: their writes land in the null page
        pool = replace_lengths(self._pool, lengths)
        t0 = time.time()
        with METRICS.span("spec_step"):
            greedy_dev, pool = self._spec_fn(T)(eng.params, pool, tokens.to(dev))
            t_issue = time.time()
            greedy = greedy_dev[b].tolist()  # the host sync, inside the span
        self._pool = pool
        FLIGHT.dispatch("dispatch.spec", t0, t_issue, time.time(),
                        rid=s.rid, mesh=self.engine.mesh_tag, slot=b, draft=T - 1)
        accept = 0
        while accept < self.spec_draft_len and draft[accept] == greedy[accept]:
            accept += 1
        # greedy[:accept + 1] are all the model's own tokens (the verified
        # draft prefix and the bonus token)
        METRICS.incr("scheduler.spec_steps")
        METRICS.incr("scheduler.spec_accepted", accept)
        delivered = 0
        spec_key = None
        if s.journaled or s.export is not None:
            # greedy: the slot's key does not move, so every token of the
            # block shares its current key as its resume point
            spec_key = self._keys[b].cpu().numpy()
        for t in greedy[: accept + 1]:
            self._deliver(s, t, key=spec_key)
            if s.finished:
                break
            delivered += 1
            if s.grammar is not None and s.gstate >= 0:
                # the trigger completed inside the block: the rest was
                # decoded unconstrained; the constrained phase re-decodes
                # under the DFA mask from here
                break
        if not s.finished:
            # K/V is real through L0 + delivered - 1; the next fed token is
            # s.next_input at L0 + delivered. The block wrote T rows
            lengths[b] = L0 + delivered
            self._pool = replace_lengths(self._pool, lengths)
        return True

    def _spec_fn(self, T: int):
        """The verify program: ``forward_paged_block`` over [B, T] tokens
        (K2's block form), then the argmax of every position; returns
        (greedy [B, T], pool with lengths += T)."""
        from fei_tpu_torch.models.llama import forward_paged_block

        eng = self.engine

        def spec(params, pool, tokens):
            logits, pool = forward_paged_block(params, eng.cfg, tokens, pool)
            return torch.argmax(logits, dim=-1), pool

        return spec

    def _step_active(self) -> None:
        self._step_active_impl()
        # a deferred admission chunk this iteration's dispatch did not
        # consume still makes progress now: bounded-stall admission is a
        # guarantee, not a fast path
        cap = FLIGHT.capturing and self._pending_chunk is not None
        if cap:
            r = FLIGHT.open("admit.chunk", deferred=True)
        self._flush_pending_chunk()
        if cap:
            FLIGHT.close(r)

    def _step_active_impl(self) -> None:
        if self._maybe_spec_step():
            return
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
        toks, keys_h, active = self._dispatch_steps(active, 1, mask=mask)
        cap = FLIGHT.capturing
        if cap:
            r = FLIGHT.open("sched.deliver")
        for b, s in active:
            if self._slots[b] is s:
                self._deliver(s, int(toks[b, 0]), key=None if keys_h is None else keys_h[0, b])
        if cap:
            FLIGHT.close(r)

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
        under_admission = bool(self._waiting) or self._admitting is not None
        FLIGHT.event("turbo_arm", depth=n, slots=len(active),
                     under_admission=under_admission)
        toks, keys_h, active = self._dispatch_steps(active, n)
        METRICS.incr("scheduler.multi_steps")
        METRICS.incr("scheduler.multi_tokens", n)
        if under_admission:
            METRICS.incr("scheduler.turbo_under_admission")
        cap = FLIGHT.capturing
        if cap:
            r = FLIGHT.open("sched.deliver")
        rollback: dict[int, int] = {}
        for b, s in active:
            for i in range(n):
                if self._slots[b] is not s:  # finished at an earlier step
                    break
                was_free = s.grammar is not None and s.gstate < 0
                self._deliver(s, int(toks[b, i]),
                              key=None if keys_h is None else keys_h[i, b])
                if was_free and i < n - 1 and self._slots[b] is s and s.gstate >= 0:
                    # the tool-call trigger completed mid-scan: the steps
                    # past i were sampled unconstrained — discard them and
                    # re-enter constrained decode from the exact token
                    rollback[b] = i
                    break
        if cap:
            FLIGHT.close(r)
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
        eviction leaves it. Each rolled-back slot's key returns to its
        value after step ``i`` (``i + 1`` splits of the scan: a row of the
        dispatch's per-step keys, on the device), the per-token path's key
        after the same tokens. The K/V of the discarded steps stay above
        the new length, never attended, and are overwritten slot by
        slot."""
        from fei_tpu_torch.engine.paged_cache import replace_lengths

        lengths = np.zeros((self.B,), dtype=np.int32)
        for b, s in enumerate(self._slots):
            if s is not None and not s.prefilling:
                lengths[b] = len(s.prompt_ids) + len(s.generated) - 1
        self._pool = replace_lengths(self._pool, lengths)
        if self._step_keys is not None:  # a greedy dispatch moved no key
            for b, i in rollback.items():
                self._keys[b] = self._step_keys[i, b]
        discarded = sum(n - 1 - i for i in rollback.values())
        METRICS.incr("scheduler.turbo_rollbacks", len(rollback))
        METRICS.incr("scheduler.turbo_rollback_tokens", discarded)
        FLIGHT.event("rollback", slots=sorted(rollback), tokens=discarded,
                     rids=[self._slots[b].rid for b in rollback
                           if self._slots[b] is not None])

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
        on the host, the per-step keys [n, B, 2] on the host when a slot
        is journaled (else None), the active slots that took part). When a
        slot samples, the keys after each step stay on the device in
        ``self._step_keys`` (the rollback's restore points). Slots
        preempted by the growth pass drop out before anything is sampled
        for them. The issue time of each dispatch (the call until its
        launches are queued) adds to ``scheduler.dispatch_issue_seconds``;
        while the flight recorder captures, the call is a ``sched.decode``
        range holding ``decode.prepare``, each step's ``model.forward`` and
        ``decode.sample``, and ``decode.sync``."""
        if not FLIGHT.capturing:
            return self._run_steps(active, n, mask, False)
        r = FLIGHT.open("sched.decode", n_steps=n)
        try:
            return self._run_steps(active, n, mask, True)
        finally:
            FLIGHT.close(r)

    def _run_steps(self, active, n: int, mask, cap: bool):
        from fei_tpu_torch.models.llama import _logits, forward_paged, forward_paged_merged

        if cap:
            rp = FLIGHT.open("decode.prepare")
        self._grow_for_steps(active, n)
        active = [(b, s) for b, s in active if self._slots[b] is s]
        if not active:
            if cap:
                FLIGHT.close(rp)
            return None, None, []
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
        sample = _make_sampler(active, self.B, eng.cfg.vocab_size, dev, table, mind)
        if cap:
            FLIGHT.close(rp)
        METRICS.incr("scheduler.decode_steps", n)
        METRICS.incr("scheduler.decode_slot_steps", len(active) * n)
        METRICS.gauge("scheduler.batch_slots_active", len(active))
        chunk_logits = None
        tok = tokens.to(dev)
        keys = self._keys
        # only a sampled slot's key moves: a greedy dispatch keeps no
        # per-step keys
        sampled = any(s.gen.temperature > 0.0 for _, s in active)
        outs, step_keys = [], []
        t0 = time.time()
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
                if cap:
                    rs = FLIGHT.open("decode.sample")
                nxt, keys, gstates, gremain = sample(
                    logits[:, -1, :], keys, mask, gstates, gremain)
                if cap:
                    FLIGHT.close(rs)
                outs.append(nxt)
                if sampled:
                    step_keys.append(keys)
                tok = nxt[:, None].long()
            self._pool = pool
            self._keys = keys
            self._step_keys = torch.stack(step_keys) if sampled else None
            toks = torch.stack(outs, dim=1).long()
            t_issue = time.time()
            if cap:
                FLIGHT.resolve()  # earlier dispatches' device times, while this one runs
                rc = FLIGHT.open("decode.sync")
            keys_h = None
            if self._want_token_keys():
                # journaled slots record each delivered token's key: the
                # keys ride the tokens' one copy to the host
                steps = self._step_keys if sampled else keys.expand(n, *keys.shape)
                both = torch.cat((toks.reshape(-1), steps.reshape(-1))).cpu()
                out = both[: toks.numel()].reshape(toks.shape).numpy()
                keys_h = both[toks.numel():].reshape(steps.shape).numpy()
            else:
                out = toks.cpu().numpy()  # the one host sync
            if cap:
                FLIGHT.close(rc)
        t1 = time.time()
        self._record_collective_time(t1 - t0)
        METRICS.timing("dispatch_issue", t_issue - t0)
        METRICS.incr("scheduler.dispatch_issue_seconds", t_issue - t0)
        METRICS.timing("dispatch_sync", t1 - t_issue)
        extra = {}
        if pc is not None:
            # no separate "dispatch.prefill_chunk" record for a merged chunk:
            # that count dropping under overlap is the dispatch saving
            extra = {"ragged": True, "chunk_tokens": pc["hi"] - pc["lo"],
                     "chunk_rid": pc["st"]["seq"].rid}
        FLIGHT.dispatch("dispatch.step", t0, t_issue, t1,
                        rids=[s.rid for _, s in active], mesh=self.engine.mesh_tag,
                        n_steps=n, slots=len(active), **extra)
        ctx = sum(len(s.prompt_ids) + len(s.generated) for _, s in active)
        if pc is not None:
            METRICS.gauge("engine.kernel_loop_depth", n * eng.cfg.num_layers)
            costmodel.account_ragged_dispatch(eng, n, ctx, len(active),
                                              pc["hi"] - pc["lo"], pc["lo"], t1 - t0)
        else:
            costmodel.account_dispatch(eng, n, ctx, len(active), t1 - t0)
        for _, s in active:
            s.shield = False  # survived a dispatch: victimizable again
        if pc is not None:
            METRICS.incr("engine.ragged_dispatches")
            st = pc["st"]
            try:
                self._finish_merged_chunk(pc, chunk_logits)
            except BaseException as exc:  # noqa: BLE001
                self._abort_admission(st["seq"], st["slot"], exc)
        return out, keys_h, active

    def _record_collective_time(self, dt: float) -> None:
        """Attribute a sharded dispatch's wall time to each active mesh axis
        (``collective.<axis>`` timings). An upper bound: the step includes
        compute. The time spent inside the collectives themselves is the
        mesh's own count (``Mesh.stats``)."""
        from fei_tpu_torch.parallel.mesh import AXES, axis_size

        mesh = self.engine.mesh
        if mesh is None:
            return
        for ax in AXES:
            if axis_size(mesh, ax) > 1:
                METRICS.timing(f"collective.{ax}", dt)

