"""Constraint policy of the paged scheduler (counterpart of
fei_tpu/engine/sched_constrain.py): installing the one device-native
grammar (one [S, V] table pair on the device serves every constrained
request; while a different grammar has requests in flight, a new one is
served through its host mask function instead, the JAX package's own
route), the host DFA mirror that walks the sampled tokens, the first
token's entry mask, and the host masks of ``logit_mask_fn`` requests. A
mixin over PagedScheduler state."""

from __future__ import annotations

import numpy as np
import torch

from fei_tpu_torch.engine.fused_decode import trigger_walk
from fei_tpu_torch.utils.metrics import METRICS


class ConstraintMixin:
    """Grammar install, host DFA mirror, first-token and host masks."""

    def _set_grammar(self, grammar, prebuilt=None) -> bool:
        """Install ``grammar`` as the device-native one. False while a
        DIFFERENT grammar still has requests in flight (the caller serves
        the request through host masks). Called under self._lock;
        ``prebuilt`` device tables come from the caller, so the upload
        happens outside it."""
        if self._ggrammar is grammar:
            return True
        inflight = any(
            s is not None and s.grammar is not None for s in self._slots
        ) or any(s.grammar is not None for s in self._waiting)
        if self._ggrammar is not None and inflight:
            return False
        if prebuilt is None:
            prebuilt = grammar.device_tables(self.engine.cfg.vocab_size, self.engine.device,
                                              observer=self.engine._compiles)
        self._gtable, self._gmind = prebuilt
        self._ggrammar = grammar
        return True

    def _grammar_advance(self, seq, t: int) -> tuple[bool, bool]:
        """Advance the host DFA mirror with sampled token ``t``. Returns
        (emit_token, finish_now). The device step applied the same table,
        so the mirror can only land where the mask allowed."""
        g = seq.grammar
        if seq.gstate < 0:
            # free phase: the trigger watch the dense free phase shares, so
            # the multi-step scan's rollback decision cannot drift from it
            s = trigger_walk(g, seq.gscanner, t)
            if s is not None:
                if s == g.accept:  # the whole call inside the trigger token
                    seq.gaccepted = True
                    return True, True
                if s >= 0:
                    seq.gstate = s
                else:
                    METRICS.incr("scheduler.grammar_trigger_suffix_rejected")
            return True, False
        nxt = int(g.table[seq.gstate, t])
        if nxt < 0:
            METRICS.incr("scheduler.grammar_walked_off")
            return True, False  # unreachable under the device mask
        seq.gstate = nxt
        if nxt == g.accept and seq.gtrigger is not None:
            # tool-call protocol: the turn ends at acceptance; a stop
            # token's accept edge is not part of the call text
            seq.gaccepted = True
            return t not in seq.stops and t not in set(
                self.engine.tokenizer.stop_token_ids
            ), True
        return True, False

    def _grammar_first_mask(self, seq) -> torch.Tensor:
        """Entry-state mask (with the dense path's budget-feasibility rule)
        for a device-grammar request's first sampled token, on the device."""
        from fei_tpu_torch.engine.engine import pad_vocab_mask
        from fei_tpu_torch.engine.grammar import feasible_mask

        g = seq.grammar
        m = feasible_mask(g.table[seq.gstate], g.min_dist, seq.budget)
        return pad_vocab_mask(m, self.engine.cfg.vocab_size).to(self.engine.device)

    def _host_mask(self, seq, first: bool = False) -> torch.Tensor | None:
        """A logit_mask_fn request's bool [V] mask on the device, or None."""
        if seq.mask_fn is None:
            return None
        m = seq.mask_fn([] if first else seq.generated)
        if m is None:
            return None
        from fei_tpu_torch.engine.engine import pad_vocab_mask

        return pad_vocab_mask(np.asarray(m, dtype=bool),
                              self.engine.cfg.vocab_size).to(self.engine.device)
