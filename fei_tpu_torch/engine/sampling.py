"""Token sampling on the device (counterpart of fei_tpu/engine/sampling.py):
greedy / temperature / min-p / top-k / top-p.

The filters run in the JAX package's order (min-p, then top-k, then
top-p) and the draw is the reference's ``jax.random.categorical`` on a
threefry key (engine/prng.py): argmax of the filtered logits plus Gumbel
noise whose bits equal the JAX package's for the same key. So a seeded
request samples the reference's tokens on equal logits, except at a
near-tie within the last ulp of ``log`` (``torch.log`` and XLA's may
round one ulp apart). Greedy (temperature 0) draws nothing. Only the
sampled ids leave the device, and nothing here syncs with the host.
"""

from __future__ import annotations

from typing import Sequence

import torch

from fei_tpu_torch.engine import prng


def sample_logits(
    logits: torch.Tensor,  # [B, V] float32
    key: torch.Tensor | None = None,  # [2] threefry key (unused when greedy)
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    min_p: float = 0.0,
) -> torch.Tensor:
    """Return sampled token ids [B] (int32). ``min_p`` drops tokens whose
    prob is below min_p * max-prob. One key draws the noise of the whole
    [B, V] block, as the reference's ``categorical`` does."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = filter_logits(logits, temperature, top_k, top_p, min_p)
    return prng.categorical(key, logits).to(torch.int32)


def filter_logits(
    logits: torch.Tensor, temperature: float, top_k: int = 0,
    top_p: float = 1.0, min_p: float = 0.0,
) -> torch.Tensor:
    """Temperature-scaled logits with filtered-out tokens at -inf."""
    neg_inf = float("-inf")
    logits = logits / temperature
    if min_p > 0.0:
        probs = torch.softmax(logits, dim=-1)
        floor = min_p * probs.amax(dim=-1, keepdim=True)
        logits = torch.where(probs < floor, neg_inf, logits)
    if 0 < top_k < logits.shape[-1]:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, neg_inf, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep the smallest set whose cumulative prob >= top_p
        cutoff_idx = torch.sum(cum < top_p, dim=-1, keepdim=True)
        cutoff_idx = cutoff_idx.clamp(max=logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, neg_inf, logits)
    return logits


class RowKnobs:
    """One batch's per-row sampling knobs, uploaded once (a scheduler
    dispatch reuses them for every step). The host lists decide which
    filters any row uses; ``sampled`` says whether any row draws."""

    def __init__(self, temperatures: Sequence[float], top_ks: Sequence[int],
                 top_ps: Sequence[float], min_ps: Sequence[float] | None,
                 vocab: int, device):
        B = len(temperatures)
        min_ps = list(min_ps) if min_ps is not None else [0.0] * B
        self.sampled = any(t > 0.0 for t in temperatures)
        self.use_min_p = any(p > 0.0 for p in min_ps)
        self.use_k = any(0 < k < vocab for k in top_ks)
        self.use_p = any(p < 1.0 for p in top_ps)

        def col(values, dtype):
            return torch.tensor(list(values), dtype=dtype).to(device)[:, None]

        if self.sampled:
            self.temps = col(temperatures, torch.float32)
            self.min_ps = col(min_ps, torch.float32) if self.use_min_p else None
            self.top_ks = col(top_ks, torch.int64) if self.use_k else None
            self.top_ps = col(top_ps, torch.float32) if self.use_p else None


def sample_logits_dynamic(
    logits: torch.Tensor,  # [B, V] float32
    keys: torch.Tensor,  # [B, 2] threefry keys, one per row
    temperatures: Sequence[float],
    top_ks: Sequence[int],
    top_ps: Sequence[float],
    min_ps: Sequence[float] | None = None,
) -> torch.Tensor:
    """Per-row sampling for the continuous-batching scheduler, one batched
    pass: each row has its own key and knobs, and its token depends on its
    own key and logits alone. The arithmetic is the reference's
    ``_sample_row_dynamic`` under ``vmap``; a greedy row (temperature 0)
    takes the argmax. Returns token ids [B] (int32)."""
    knobs = RowKnobs(temperatures, top_ks, top_ps, min_ps, logits.shape[-1], logits.device)
    return sample_rows(logits, keys, knobs)


def sample_rows(logits: torch.Tensor, keys: torch.Tensor, knobs: RowKnobs) -> torch.Tensor:
    """``sample_logits_dynamic`` on prepared knobs. A filter no row uses
    is skipped (its ``where`` would keep every logit), and a batch of
    greedy rows draws nothing."""
    V = logits.shape[-1]
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not knobs.sampled:
        return greedy
    neg_inf = float("-inf")
    scaled = logits / knobs.temps.clamp_min(1e-8)
    if knobs.use_min_p:
        mp = knobs.min_ps
        mp_probs = torch.softmax(scaled, dim=-1)
        floor = mp * mp_probs.amax(dim=-1, keepdim=True)
        scaled = torch.where((mp > 0.0) & (mp_probs < floor), neg_inf, scaled)
    if knobs.use_k or knobs.use_p:
        sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
        if knobs.use_k:
            ks = knobs.top_ks
            apply_k = (ks > 0) & (ks < V)
            kth = torch.gather(sorted_desc, -1, (ks - 1).clamp(0, V - 1))
            scaled = torch.where(apply_k & (scaled < kth), neg_inf, scaled)
            sorted_desc = torch.where(apply_k & (sorted_desc < kth), neg_inf, sorted_desc)
        if knobs.use_p:
            ps = knobs.top_ps
            cum = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
            cutoff_idx = torch.sum(cum < ps, dim=-1, keepdim=True).clamp(0, V - 1)
            cutoff = torch.gather(sorted_desc, -1, cutoff_idx)
            scaled = torch.where((ps < 1.0) & (scaled < cutoff), neg_inf, scaled)
    sampled = prng.categorical(keys, scaled).to(torch.int32)
    return torch.where(knobs.temps[:, 0] > 0.0, sampled, greedy)


def stop_mask(tokens: torch.Tensor, stop_ids: torch.Tensor) -> torch.Tensor:
    """[B] bool: membership of each sampled token in ``stop_ids`` ([S]
    int32; S may be 0 → all False)."""
    if stop_ids.shape[0] == 0:
        return torch.zeros(tokens.shape, dtype=torch.bool, device=tokens.device)
    return torch.any(tokens[:, None] == stop_ids[None, :], dim=-1)
