"""Prometheus text exposition (format 0.0.4) for the METRICS snapshot
(counterpart of fei_tpu/obs/prom.py).

Pure rendering — no state, no locks; Metrics.prometheus_text() collects a
consistent snapshot under its lock and hands the plain dicts here. Names
are sanitized to the Prometheus charset and prefixed ``fei_``; counters
get the conventional ``_total`` suffix; histograms emit cumulative
``le``-labelled buckets plus ``_sum``/``_count``.
"""

from __future__ import annotations

import re

from fei_tpu_torch.obs.registry import help_for

_INVALID = re.compile(r"[^a-zA-Z0-9_:]")


def _sanitize(name: str) -> str:
    n = _INVALID.sub("_", name)
    if not re.match(r"[a-zA-Z_:]", n):
        n = "_" + n
    return "fei_" + n


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(value: str) -> str:
    return (value.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if float(v) == int(v) and abs(v) < 1e15:
        return str(int(v))
    return f"{v:.10g}"


def _header(lines: list[str], prom_name: str, raw_name: str,
            kind: str) -> None:
    info = help_for(raw_name)
    help_text = info[1] if info else raw_name
    lines.append(f"# HELP {prom_name} {_escape_help(help_text)}")
    lines.append(f"# TYPE {prom_name} {kind}")


def render_prometheus(counters: dict, gauges: dict, hists: dict) -> str:
    """hists maps name -> (bounds, counts, inf_count, sum, count), the
    Histogram.state() tuple."""
    lines: list[str] = []
    for name in sorted(counters):
        prom = _sanitize(name) + "_total"
        _header(lines, prom, name, "counter")
        lines.append(f"{prom} {_fmt(counters[name])}")
    for name in sorted(gauges):
        prom = _sanitize(name)
        _header(lines, prom, name, "gauge")
        lines.append(f"{prom} {_fmt(gauges[name])}")
    for name in sorted(hists):
        bounds, counts, inf_count, total_sum, count = hists[name]
        prom = _sanitize(name)
        _header(lines, prom, name, "histogram")
        cum = 0
        for b, c in zip(bounds, counts):
            cum += c
            le = _escape_label(f"{b:.10g}")
            lines.append(f'{prom}_bucket{{le="{le}"}} {cum}')
        lines.append(f'{prom}_bucket{{le="+Inf"}} {cum + inf_count}')
        lines.append(f"{prom}_sum {total_sum:.9g}")
        lines.append(f"{prom}_count {count}")
    return "\n".join(lines) + "\n"
