"""Analytical roofline accountant (counterpart of fei_tpu/obs/costmodel.py):
per-dispatch HBM-byte and FLOP estimates from the model config and the
batch/page geometry.

Single-stream decode is weight-streaming-bound, so achieved tok/s times
the bytes streamed per token, against the card's memory rate, says whether
there is headroom. The scheduler and the dense ChunkDecoder feed each
dispatch into the ``roofline.frac`` / ``roofline.tok_s_per_chip`` gauges,
so ``/metrics`` carries the fraction of the roofline a run achieved.

The ceilings are the H100 SXM's (NVIDIA data sheet, dense, at the 700 W
power limit): 3350 GB/s of HBM3 and 989 TFLOP/s of bf16, the same bounds
``chip_smoke.py`` holds its kernels and paths to. ``FEI_TPU_HBM_GBPS``
overrides the bandwidth, as in the reference (e.g. a card capped below
its maximum, or a PCIe H100 at 2000 GB/s).

The roofline is per engine mesh: ``chips_for_tag`` reads the engine's
mesh tag (``ms1``, ``tp2``, ``tp2dp2``; parallel/mesh.py's parser), and
the aggregate ceiling is that many cards. Ranks that share one card
(gloo on a one-card host) still count one card each: the fraction then
reads against a ceiling the card cannot reach.
"""

from __future__ import annotations

import os

from fei_tpu_torch.obs.metrics import METRICS
from fei_tpu_torch.parallel.mesh import parse_mesh_shape

# H100 SXM HBM3 bandwidth (GB/s) — the default roofline ceiling
H100_HBM_GBPS = 3350.0
# H100 SXM dense bf16 tensor-core peak (FLOP/s)
H100_BF16_FLOPS = 989e12


def hbm_gbps() -> float:
    """The per-card HBM bandwidth ceiling (GB/s) the roofline fraction is
    computed against; ``FEI_TPU_HBM_GBPS`` overrides the H100 default."""
    try:
        return float(os.environ.get("FEI_TPU_HBM_GBPS", "") or H100_HBM_GBPS)
    except ValueError:
        return H100_HBM_GBPS


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif hasattr(tree, "shape"):
        yield tree


def _param_bytes(tree) -> int:
    return sum(int(t.numel()) * t.element_size() for t in _leaves(tree))


def _element_count(tree) -> int:
    return sum(int(t.numel()) for t in _leaves(tree))


def _active(engine, measure) -> float:
    """``measure`` of the weights one decoded token touches: every leaf but
    an untied embedding table (a gather reads one row; tied embeddings ARE
    the LM head and stream fully), MoE experts scaled to the routed
    top-k. Counted over the whole model, as the reference counts a
    sharded array's global size: a rank of the Megatron profile holds
    about 1/tp of it."""
    cfg = engine.cfg
    p = engine.params
    n = measure(p)
    if not cfg.tie_embeddings and "embed" in p:
        n -= measure(p["embed"])
    if cfg.is_moe:
        k, E = cfg.num_experts_per_tok, cfg.num_experts
        layers = p.get("layers", {})
        for name in ("w_gate", "w_up", "w_down"):
            if name in layers:
                n -= measure(layers[name]) * (1 - k / E)
    if getattr(engine, "mesh_weights", None) == "sharded":
        n *= engine.tp
    return n


def decode_stream_bytes(engine, mean_ctx: int) -> dict:
    """HBM bytes streamed to decode ONE token: the active weights (see
    ``_active``) plus the K/V read at the mean decode context and the new
    token's K/V write. Activation and norm traffic is O(hidden) per layer,
    noise beside the weight stream."""
    weights = _active(engine, _param_bytes)
    kv_row = kv_row_bytes(engine)
    kv_read = kv_row * mean_ctx
    kv_write = kv_row
    return {
        "weights": int(weights),
        "kv_read": int(kv_read),
        "kv_write": int(kv_write),
        "total": int(weights + kv_read + kv_write),
    }


def kv_row_bytes(engine) -> int:
    """Bytes of K+V cache per token position (all layers)."""
    import torch

    cfg = engine.cfg
    itemsize = torch.empty((), dtype=engine.dtype).element_size()
    return 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim_ * itemsize


def decode_flops_per_token(engine) -> int:
    """FLOPs to decode one token ≈ 2 × parameters touched (the 2·m·n·k
    identity at batch 1), over the same active weights as the bytes."""
    return 2 * int(_active(engine, _element_count))


def dispatch_bytes(engine, n_steps: int, total_ctx: int, slots: int) -> int:
    """HBM bytes one batched decode dispatch streams: per step the full
    weight stream plus a K/V read over every active slot's context and one
    K/V row write per slot. ``total_ctx`` is the summed context of the
    active slots at dispatch time."""
    sb = decode_stream_bytes(engine, 0)
    kv_row = kv_row_bytes(engine)
    per_step = sb["weights"] + kv_row * (total_ctx + slots)
    return int(max(1, n_steps) * per_step)


def ragged_dispatch_bytes(
    engine, n_steps: int, total_ctx: int, slots: int,
    chunk_tokens: int, chunk_ctx: int,
) -> int:
    """HBM bytes of one MERGED dispatch: a decode scan whose first step
    also carries a prefill chunk (``chunk_tokens`` positions from absolute
    context ``chunk_ctx``). The chunk adds no weight stream — the first
    step's read serves both — only its K/V: a row write per chunk token
    and the page reads of its causal attention."""
    kv_row = kv_row_bytes(engine)
    chunk = kv_row * (chunk_ctx + 2 * chunk_tokens)
    return dispatch_bytes(engine, n_steps, total_ctx, slots) + int(chunk)


def roofline_fraction(bytes_streamed: int, dt_s: float,
                      n_chips: int = 1) -> float:
    """Fraction of the aggregate HBM roofline achieved: estimated bytes
    over wall time vs ``n_chips`` × the per-card ceiling."""
    if dt_s <= 0:
        return 0.0
    gbps = bytes_streamed / dt_s / 1e9
    return gbps / (hbm_gbps() * max(1, n_chips))


def chips_for_tag(tag: str | None) -> int:
    """Device count implied by a serving-mesh tag (``ms1`` → 1,
    ``tp2dp2`` → 4). Unparseable tags count as one chip — a wrong
    denominator must never sink a record."""
    if not tag or tag in ("ms1", "off"):
        return 1
    try:
        n = 1
        for s in parse_mesh_shape(tag).values():
            n *= int(s)
        return max(1, n)
    except Exception:  # noqa: BLE001
        return 1


def account_kv_transfer(direction: str, nbytes: int, dt_s: float) -> None:
    """Bytes moved by the KV tier (kv/tier.py entries gathered and
    scattered through kv/pagesio.py) and by migration: the cumulative
    ``kv.bytes_<direction>`` counter and the achieved ``kv.<direction>_gbps``
    gauge (host clock). ``direction`` is ``spilled`` (device → host on
    preemption or publish) or ``fetched`` (host → device on a streamed
    resume or a content-addressed admission)."""
    if direction not in ("spilled", "fetched"):
        return
    METRICS.incr(f"kv.bytes_{direction}", int(nbytes))
    if dt_s > 0:
        METRICS.gauge(f"kv.{direction}_gbps", round(nbytes / dt_s / 1e9, 6))


def account_dispatch(engine, n_steps: int, total_ctx: int, slots: int,
                     dt_s: float) -> None:
    """Live roofline accounting for one decode dispatch: the
    ``roofline.frac`` and ``roofline.tok_s_per_chip`` gauges from the
    analytical byte estimate and the measured wall time."""
    if dt_s <= 0:
        return
    est = dispatch_bytes(engine, n_steps, total_ctx, slots)
    _roofline_gauges(est, n_steps * slots, dt_s, chips_for_tag(engine.mesh_tag))


def account_ragged_dispatch(
    engine, n_steps: int, total_ctx: int, slots: int,
    chunk_tokens: int, chunk_ctx: int, dt_s: float,
) -> None:
    """Roofline accounting for one MERGED dispatch (decode scan + prefill
    chunk): the chunk's K/V traffic is credited, not a second weight
    stream, and tok_s_per_chip counts decode tokens only, so the gauge
    stays comparable across the merged and solo paths."""
    if dt_s <= 0:
        return
    est = ragged_dispatch_bytes(
        engine, n_steps, total_ctx, slots, chunk_tokens, chunk_ctx
    )
    _roofline_gauges(est, n_steps * slots, dt_s, chips_for_tag(engine.mesh_tag))


def _roofline_gauges(est_bytes: int, tokens: int, dt_s: float,
                     n_chips: int) -> None:
    # 9 decimals: a tiny CPU model's frac is O(1e-7) and must not round
    # to a flat zero; a card's fractions are O(0.1) and unaffected
    METRICS.gauge(
        "roofline.frac",
        round(roofline_fraction(est_bytes, dt_s, n_chips), 9),
    )
    METRICS.gauge(
        "roofline.tok_s_per_chip",
        round(tokens / dt_s / max(1, n_chips), 3),
    )
