"""Sequence parallelism: ring attention and Ulysses all_to_all (counterpart
of fei_tpu/parallel/ring.py).

Two strategies over the ``sp`` mesh axis, each a function of one rank's
chunk of the sequence (the reference lifts the same bodies with
``shard_map``; here every rank calls them on its own chunk and the
collectives pair up across the ranks):

- **Ring attention** (blockwise): Q stays put; K/V chunks rotate around
  the ring (``Mesh.ppermute``) while each rank folds the visiting chunk
  into an online softmax. Attention memory per rank is O(T/n · D).
- **Ulysses**: ``all_to_all`` reshards [B, T/n, H, D] → [B, T, H/n, D],
  each rank attends over the whole sequence for its head slice, and the
  inverse all_to_all restores sequence sharding.

Causal masking uses absolute positions from the rank's coordinate on the
axis. The block products are plain ``torch.einsum`` in fp32, as the
reference computes them outside any Pallas kernel.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _block_attend(q, k, v, q_pos, k_pos, scale, window: int = 0):
    """One (q-block × kv-block) online-softmax contribution.

    q: [B, Tq, H, D]; k/v: [B, Sk, K, D]; positions: [Tq] / [Sk] absolute.
    Returns (m, l, acc) partials: m/l [B, Tq, H, 1], acc [B, Tq, H, D].
    ``window`` adds the sliding-window mask (key visible iff additionally
    k_pos > q_pos - window). An entirely masked visiting block gives
    m = NEG_INF partials, which the caller's online-softmax correction
    zeroes once a live block has been folded; causally every query row's
    own chunk (fold step 0) is live. K/V keep their K heads: the grouped
    layout never repeats them to H heads.
    """
    B, Tq, H, D = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, Tq, K, G, D).float()
    s = torch.einsum("btkgd,bskd->btkgs", qg, k.float()) * scale
    mask = k_pos[None, None, None, None, :] <= q_pos[None, :, None, None, None]
    if window:
        mask &= k_pos[None, None, None, None, :] > q_pos[None, :, None, None, None] - window
    s = torch.where(mask, s, torch.tensor(NEG_INF, dtype=s.dtype, device=s.device))
    m = s.amax(dim=-1, keepdim=True)  # [B, Tq, K, G, 1]
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("btkgs,bskd->btkgd", p, v.float())
    return m.reshape(B, Tq, H, 1), l.reshape(B, Tq, H, 1), acc.reshape(B, Tq, H, D)


def ring_steps(n: int, C: int, window: int) -> int:
    """Rotations a rank folds: all n, or with a window only the chunks
    that any of its queries can see (k_last < q_first - window for hop h
    once h*C >= window + C - 1, so the rotation stops early; the count is
    static and the same on every rank)."""
    if window:
        return min(n, 1 + (window + C - 2) // C)
    return n


def _ring_attention_shard(q, k, v, *, mesh, axis_name: str, scale: float,
                          window: int = 0):
    """One rank's ring attention: q/k/v its sequence chunk [B, C, H|K, D]
    (chunk c holds absolute positions [c·C, (c+1)·C)). K/V chunks rotate
    ring-wise; each arrival folds into the running (m, l, acc)."""
    B, C, H, D = q.shape
    n = mesh.shape[axis_name]
    my_idx = mesh.coords[axis_name]
    dev = q.device
    q_pos = my_idx * C + torch.arange(C, device=dev)
    m = torch.full((B, C, H, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, C, H, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, C, H, D), dtype=torch.float32, device=dev)
    perm = [(i, (i + 1) % n) for i in range(n)]
    k_cur, v_cur = k, v
    steps = ring_steps(n, C, window)
    for step in range(steps):
        # after `step` rotations this rank holds the chunk of idx - step
        src = (my_idx - step) % n
        k_pos = src * C + torch.arange(C, device=dev)
        bm, bl, bacc = _block_attend(q, k_cur, v_cur, q_pos, k_pos, scale, window=window)
        m_new = torch.maximum(m, bm)
        c_old = torch.exp(m - m_new)
        c_blk = torch.exp(bm - m_new)
        l = c_old * l + c_blk * bl
        acc = c_old * acc + c_blk * bacc
        m = m_new
        if step + 1 < steps:  # the rotation after the last fold carries nothing
            k_cur = mesh.ppermute(k_cur, axis_name, perm)
            v_cur = mesh.ppermute(v_cur, axis_name, perm)
    # a fully masked row cannot happen causally (position p sees p): guard
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / safe_l).to(q.dtype)


def ring_attention(q, k, v, mesh, axis_name: str = "sp", scale: float | None = None,
                   window: int = 0) -> torch.Tensor:
    """Causal self-attention with the sequence sharded over ``axis_name``:
    ``q`` [B, C, H, D] and ``k``/``v`` [B, C, K, D] are this rank's chunk
    of T = n·C positions, and so is the output. ``window`` (> 0) applies
    sliding-window attention, the dense oracle's contract (key s visible
    iff s <= p and s > p - window)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _ring_attention_shard(q, k, v, mesh=mesh, axis_name=axis_name, scale=scale,
                                 window=window)


def _ulysses_shard(q, k, v, *, mesh, axis_name: str, scale: float, window: int = 0):
    """One rank's Ulysses attention: all_to_all seq→heads, full attention
    over the whole sequence for a head slice, heads→seq. Incoming q/k/v:
    [B, T/n, H|K, D]; H and K must divide the axis size."""
    def seq_to_heads(x):
        return mesh.all_to_all(x, axis_name, split_dim=2, concat_dim=1)

    qh, kh, vh = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    T = qh.shape[1]
    pos = torch.arange(T, device=q.device)
    _, l, acc = _block_attend(qh, kh, vh, pos, pos, scale, window=window)
    out = (acc / torch.where(l == 0.0, torch.ones_like(l), l)).to(q.dtype)
    return mesh.all_to_all(out, axis_name, split_dim=1, concat_dim=2)


def ulysses_attention(q, k, v, mesh, axis_name: str = "sp", scale: float | None = None,
                      window: int = 0) -> torch.Tensor:
    """Causal attention through the head↔sequence all_to_all
    (DeepSpeed-Ulysses): this rank's chunk in, its chunk out. Needs
    H % n == 0 and K % n == 0 for the head scatter. ``window`` (> 0)
    applies the sliding-window mask."""
    n = mesh.shape[axis_name]
    H, K = q.shape[2], k.shape[2]
    if H % n or K % n:
        raise ValueError(f"ulysses needs heads divisible by sp axis: H={H} K={K} n={n}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _ulysses_shard(q, k, v, mesh=mesh, axis_name=axis_name, scale=scale,
                          window=window)
