"""Arithmetic the metric readers share: tails, and the work of the traced
slice counted from the requests' progress at its two ends."""

from __future__ import annotations

import math

from portbench import roofline
from portbench.spec import PAGE_SIZE


def nearest_rank(values: list[float], q: float) -> float | None:
    """The q-th percentile by nearest rank; None when there is none, or
    when it falls on a request that never got its token (+inf)."""
    if not values:
        return None
    v = sorted(values)[max(0, math.ceil(q / 100 * len(values)) - 1)]
    return None if math.isinf(v) else v


def window_ttfts(view) -> list[float]:
    """TTFT of every request due in the window, from when it was due; a
    request that failed or never got a token counts as +inf."""
    return [r.ttft if r.ttft is not None and r.error is None else math.inf
            for r in view.due_in_window()]


def prefix_hit(r) -> int:
    """Prompt tokens the prefix cache served at this request's admission."""
    match = getattr(r.seq, "prefix_match", None) or []
    return min(len(match) * PAGE_SIZE, len(r.prompt) - 1)


def slice_work(view) -> dict | None:
    """The model work of the traced slice, from each request's tokens
    generated at its two ends: prefills (of the prompt past its prefix
    hit) of the requests whose first token came in it, and one decode
    position for every later token."""
    sl = view.slice
    if sl is None:
        return None
    m = view.model
    work = {"prefill_tokens": 0, "decode_tokens": 0, "heads": 0,
            "attn_flops": 0.0, "attn_least_s": 0.0}
    for r in view.records:
        g0, g1 = sl.progress0.get(id(r), 0), sl.progress1.get(id(r), 0)
        if g1 <= g0:
            continue
        P = len(r.prompt)
        if g0 == 0:
            hit = prefix_hit(r)
            work["prefill_tokens"] += P - hit
            work["heads"] += 1
            f = roofline.span_attn_flops(m, hit, P)
            work["attn_flops"] += f
            work["attn_least_s"] += roofline.least_seconds(f, roofline.prefill_attn_bytes(m, hit, P))
        contexts = [P + j for j in range(max(g0, 1), g1)]  # token j reads P + j keys
        work["decode_tokens"] += len(contexts)
        work["heads"] += len(contexts)
        f = sum(roofline.span_attn_flops(m, c - 1, c) for c in contexts)
        work["attn_flops"] += f
        work["attn_least_s"] += roofline.least_seconds(f, roofline.decode_attn_bytes(m, contexts))
    return work
