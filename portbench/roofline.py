"""The yardstick: the H100's peaks and the operations and bytes that a
piece of model work needs, counted from shapes.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity):
989 TFLOP/s in bf16 and 3.35 TB/s of HBM3 (the same numbers as the
program's ``chip_smoke.py`` bounds and cost model). Work is what the
tokens need, not what a kernel happens to do: padding, recomputation and
the dense MoE formulation's unpicked experts are not counted.
"""

from __future__ import annotations

from portbench.spec import Model

PEAK_FLOPS = 989e12  # bf16 dense
PEAK_BYTES = 3.35e12  # HBM3


def matmul_params(m: Model) -> int:
    """Weights one token multiplies by in one forward, the LM head
    excluded: attention projections and the MLP, only the k experts the
    router picks (plus the router) for an MoE layer."""
    h, d, H, K, I = m.hidden, m.head_dim, m.heads, m.kv_heads, m.inter
    attn = h * H * d + 2 * h * K * d + H * d * h
    mlp = 3 * h * I
    if m.is_moe:
        mlp = m.top_k * mlp + h * m.experts
    return m.layers * (attn + mlp)


def head_params(m: Model) -> int:
    return m.hidden * m.vocab


def span_keys(m: Model, start: int, end: int) -> int:
    """Sum of visible keys over the query positions [start, end)."""
    if end <= start:
        return 0
    tri = lambda n: n * (n + 1) // 2  # sum of p + 1 for p in [0, n)
    if not m.window:
        return tri(end) - tri(start)
    W = m.window
    full = max(start, min(end, W))  # positions below W see p + 1 keys
    return tri(full) - tri(start) + (end - full) * W


def span_attn_flops(m: Model, start: int, end: int) -> float:
    return float(4 * m.heads * m.head_dim * m.layers * span_keys(m, start, end))


def model_flops(m: Model, tokens: int, heads: int, attn: float) -> float:
    """Forward FLOPs: 2 per matmul weight for each token, 2 per LM-head
    weight for each position whose logits are computed, plus attention."""
    return 2.0 * matmul_params(m) * tokens + 2.0 * head_params(m) * heads + attn


def kv_bytes_per_token(m: Model) -> int:
    """bf16 K and V of one position over every layer."""
    return 2 * m.layers * m.kv_heads * m.head_dim * 2


def decode_attn_bytes(m: Model, contexts) -> float:
    """One decode step's attention inputs and outputs, each byte once: the
    K/V that each row's query sees, its query and its output (bf16)."""
    qo = 2 * m.layers * m.heads * m.head_dim * 2
    return float(sum(kv_bytes_per_token(m) * min(c, m.window or c) + qo for c in contexts))


def prefill_attn_bytes(m: Model, start: int, end: int) -> float:
    """A prefill of positions [start, end): its queries, outputs and new
    K/V once, plus the earlier K/V it reads (a prefix hit's cached pages,
    within the window)."""
    n = end - start
    qo = 2 * m.layers * m.heads * m.head_dim * 2
    earlier = min(start, m.window) if m.window else start
    return float(n * (qo + kv_bytes_per_token(m)) + earlier * kv_bytes_per_token(m))


def least_seconds(flops: float, nbytes: float) -> float:
    """The roofline: the larger of the compute and the memory time."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)
