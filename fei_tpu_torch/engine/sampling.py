"""Token sampling on the device (counterpart of fei_tpu/engine/sampling.py):
greedy / temperature / min-p / top-k / top-p.

The filters run in the JAX package's order (min-p, then top-k, then
top-p), so a given config keeps the same support. The draw is Gumbel-max
— argmax(logits + Gumbel noise) is a sample of softmax(logits) — with the
noise from the request's ``torch.Generator``. Only the sampled ids leave
the device, and nothing here syncs with the host. The port does not
reproduce the JAX package's threefry bits: a seed gives the same stream
within the port, not the same stream as the JAX package.
"""

from __future__ import annotations

import torch


def sample_logits(
    logits: torch.Tensor,  # [B, V] float32
    generator: torch.Generator | None = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    min_p: float = 0.0,
) -> torch.Tensor:
    """Return sampled token ids [B] (int32). ``min_p`` drops tokens whose
    prob is below min_p * max-prob. Greedy (temperature 0) draws no noise."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = filter_logits(logits, temperature, top_k, top_p, min_p)
    u = torch.rand(
        logits.shape, generator=generator, device=logits.device, dtype=torch.float32
    )
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


def filter_logits(
    logits: torch.Tensor, temperature: float, top_k: int = 0,
    top_p: float = 1.0, min_p: float = 0.0,
) -> torch.Tensor:
    """Temperature-scaled logits with filtered-out tokens at -inf."""
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
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


def sample_logits_dynamic(
    logits: torch.Tensor,  # [B, V] float32
    generators: list,  # [B] torch.Generator (None for greedy rows)
    temperatures: list[float],
    top_ks: list[int],
    top_ps: list[float],
    min_ps: list[float],
) -> torch.Tensor:
    """Per-row sampling for the continuous-batching scheduler: each row has
    its own knobs and its own generator. The knobs live on the host, so the
    rows split there: greedy rows (temperature 0) take the argmax and draw
    no noise; a sampled row runs ``sample_logits`` on its own [1, V] row —
    exactly the draw the dense engine makes for that request at B=1, so a
    seeded request gives the same tokens through the scheduler as through
    the dense engine. Returns token ids [B] (int32)."""
    out = torch.argmax(logits, dim=-1).to(torch.int32)
    for b, temp in enumerate(temperatures):
        if temp > 0.0:
            out[b] = sample_logits(
                logits[b:b + 1], generators[b], temperature=temp,
                top_k=top_ks[b], top_p=top_ps[b], min_p=min_ps[b],
            )[0]
    return out


def stop_mask(tokens: torch.Tensor, stop_ids: torch.Tensor) -> torch.Tensor:
    """[B] bool: membership of each sampled token in ``stop_ids`` ([S]
    int32; S may be 0 → all False)."""
    if stop_ids.shape[0] == 0:
        return torch.zeros(tokens.shape, dtype=torch.bool, device=tokens.device)
    return torch.any(tokens[:, None] == stop_ids[None, :], dim=-1)
