"""Sequence-parallel long-prompt prefill: the whole model with the prompt
sharded over the ``sp`` axis (counterpart of
fei_tpu/parallel/long_prefill.py).

- each rank embeds and projects only its T/n-token chunk;
- attention is ring attention or Ulysses (parallel/ring.py) over the
  chunks, with the config's sliding window;
- norms and the MLP (dense, MoE, or Phi's parallel block) are local to
  the chunk;
- the K/V chunks are gathered onto every rank at the end, so a dense
  KVCache of the whole prompt continues with ordinary decode.

Every rank calls these functions with the same whole token batch (rank 0
sends it with the dispatch) and its own mesh; under sp×tp a rank computes
its tp heads of its sequence chunk, as the forward does on a tp mesh.
"""

from __future__ import annotations

import torch

from fei_tpu_torch.models.configs import ModelConfig
from fei_tpu_torch.models.llama import (
    KVCache,
    _block_tail,
    _logits,
    _norm,
    _rope,
    _rope_tables,
    embed_tokens,
    layer_params,
    model_dtype,
    qkv_proj,
)
from fei_tpu_torch.parallel.ring import _ring_attention_shard, _ulysses_shard


def _prefill_shard(x, params, cos, sin, *, cfg: ModelConfig, mesh, axis_name: str,
                   attend: str = "ring"):
    """One rank's body: the whole model over its sequence chunk.

    x: [B, C, h] the chunk's embeddings. Returns (x_out, k_chunks,
    v_chunks), K/V stacked per layer [L, B, C, K_rank, D]. ``attend`` picks
    ring (K/V chunks rotate) or ulysses (head↔seq all_to_all)."""
    B, C, _ = x.shape
    K, d, Hq = cfg.num_kv_heads, cfg.head_dim_, cfg.num_heads
    my_idx = mesh.coords[axis_name]
    positions = (my_idx * C + torch.arange(C, device=x.device))[None, :].expand(B, C)
    window = cfg.sliding_window or 0
    shard = _ulysses_shard if attend == "ulysses" else _ring_attention_shard
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        y = _norm(x, lp["attn_norm"], cfg, b=lp.get("attn_norm_b"))
        q, k, v = qkv_proj(lp, y, Hq, K, d, mesh)
        q = _rope(q, cos, sin, positions, cfg.rope_dim_)
        k = _rope(k, cos, sin, positions, cfg.rope_dim_)
        attn = shard(q, k, v, mesh=mesh, axis_name=axis_name, scale=d ** -0.5,
                     window=window)
        attn = mesh.all_gather(attn, "tp", dim=2)  # every head (tp = 1: as is)
        x = _block_tail(cfg, lp, x, y, attn, False, mesh)
        ks.append(k)
        vs.append(v)
    return x, torch.stack(ks), torch.stack(vs)


def prefill_ring_kv(params: dict, cfg: ModelConfig, tokens: torch.Tensor, mesh,
                    axis_name: str = "sp", attend: str = "ring",
                    true_len: torch.Tensor | None = None):
    """Core sequence-parallel prefill: (last-valid logits [B, V] fp32,
    k_all, v_all [L, B, T, K_rank, D], gathered on every rank).
    ``tokens`` [B, T] is the whole (bucket-padded) batch; T must divide
    over the axis. ``true_len`` [B] picks the logits' position
    (``true_len - 1``); K/V beyond it is padding the caller masks by the
    cache length, as dense prefill padding is."""
    B, T = tokens.shape
    n = mesh.shape[axis_name]
    if attend not in ("ring", "ulysses"):
        raise ValueError(f"unknown attend mode {attend!r} (ring | ulysses)")
    if T % n:
        raise ValueError(f"prompt length {T} must divide sp axis {n}")
    if attend == "ulysses" and (cfg.num_heads % n or cfg.num_kv_heads % n):
        raise ValueError(
            f"ulysses prefill needs heads divisible by sp={n} "
            f"(H={cfg.num_heads}, K={cfg.num_kv_heads})")
    dtype = model_dtype(params)
    dev = params["final_norm"].device
    C = T // n
    my_idx = mesh.coords[axis_name]
    cos, sin = _rope_tables(cfg.rope_dim_, T, float(cfg.rope_theta), str(dev))
    mine = tokens.to(device=dev, dtype=torch.long)[:, my_idx * C:(my_idx + 1) * C]
    x = embed_tokens(params, cfg, mine, dtype, mesh)
    x, k_all, v_all = _prefill_shard(x, params, cos, sin, cfg=cfg, mesh=mesh,
                                     axis_name=axis_name, attend=attend)
    k_all = mesh.all_gather(k_all, axis_name, dim=2)
    v_all = mesh.all_gather(v_all, axis_name, dim=2)

    # the last valid position's hidden state lies on one rank: the others
    # add zeros (x + 0 is exact), so every rank gets it without a gather
    # of the whole sequence
    idx = (torch.full((B,), T, device=dev) if true_len is None
           else true_len.to(device=dev, dtype=torch.long)) - 1
    local = idx - my_idx * C
    own = (local >= 0) & (local < C)
    last = x[torch.arange(B, device=dev), local.clamp(0, C - 1)]
    last = torch.where(own[:, None], last, torch.zeros_like(last))
    last = mesh.all_reduce(last, axis_name)
    last = _norm(last, params["final_norm"], cfg, b=params.get("final_norm_b"))
    # kernel_mesh: on an sp×tp mesh a sharded or int4 LM head goes through
    # the tp path (a vocab-sharded head gathers, a whole int4 head runs
    # the column-sharded K4 wrapper)
    logits = _logits(last, params, cfg, kernel_mesh=mesh)
    return logits, k_all, v_all


def prefill_ring(params: dict, cfg: ModelConfig, tokens: torch.Tensor, mesh,
                 max_seq_len: int | None = None, axis_name: str = "sp",
                 attend: str = "ring"):
    """Sequence-parallel prefill: (last-token logits [B, V] fp32, a dense
    KVCache of length T sized ``max_seq_len`` or T, this rank's kv heads).
    ``attend="ulysses"`` swaps ring rotation for the head↔seq
    all_to_all; same contract."""
    B, T = tokens.shape
    logits, k_all, v_all = prefill_ring_kv(params, cfg, tokens, mesh,
                                           axis_name=axis_name, attend=attend)
    S = max_seq_len or T
    if S < T:
        raise ValueError(f"max_seq_len {S} < prompt length {T}")
    dtype = model_dtype(params)
    shape = (cfg.num_layers, B, S) + tuple(k_all.shape[3:])
    k_cache = torch.zeros(shape, dtype=dtype, device=k_all.device)
    v_cache = torch.zeros_like(k_cache)
    k_cache[:, :, :T] = k_all
    v_cache[:, :, :T] = v_all
    length = torch.full((B,), T, dtype=torch.int32, device=k_all.device)
    return logits, KVCache(k=k_cache, v=v_cache, length=length)
