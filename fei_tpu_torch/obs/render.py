"""Human-readable rendering of METRICS.snapshot() — shared by the CLI's
/stats output and the Textual TUI's /metrics command so both UIs show the
same table.

A copy of ``fei_tpu/obs/render.py`` that imports only the port.
"""

from __future__ import annotations


def snapshot_lines(snap: dict) -> list[str]:
    lines: list[str] = []
    spans = snap.get("spans", {})
    if spans:
        lines.append("timings:")
        for name in sorted(spans):
            s = spans[name]
            lines.append(
                f"  {name:<24} n={s['count']:<5} mean={s['mean_s']:.3f}s "
                f"min={s['min_s']:.3f}s max={s['max_s']:.3f}s "
                f"total={s['total_s']:.2f}s"
            )
    hists = snap.get("histograms", {})
    if hists:
        lines.append("latency percentiles:")
        for name in sorted(hists):
            h = hists[name]
            if not h["count"]:
                continue
            lines.append(
                f"  {name:<24} n={h['count']:<5} p50={h['p50']:.4f}s "
                f"p95={h['p95']:.4f}s p99={h['p99']:.4f}s "
                f"max={h['max']:.4f}s"
            )
    counters = snap.get("counters", {})
    if counters:
        lines.append("counters:")
        for name in sorted(counters):
            v = counters[name]
            v = int(v) if float(v) == int(v) else v
            lines.append(f"  {name:<32} {v}")
    gauges = snap.get("gauges", {})
    if gauges:
        lines.append("gauges:")
        for name in sorted(gauges):
            v = gauges[name]
            if isinstance(v, float) and v != int(v):
                lines.append(f"  {name:<32} {v:.4f}")
            else:
                lines.append(f"  {name:<32} {int(v)}")
    if not lines:
        lines.append("(no metrics recorded yet)")
    return lines
