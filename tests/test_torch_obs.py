"""The port's observability core against fei_tpu's: the same observations
through both packages' histograms, Prometheus exposition, request traces
and metric registry give the same numbers and the same text; and every
``METRICS.*`` name the port sets is declared in its registry (the port's
counterpart of scripts/metrics_lint.py, with a negative case)."""

from __future__ import annotations

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import json
import re
import types
from pathlib import Path

import numpy as np
import pytest

import fei_tpu.obs as jax_obs
import fei_tpu.obs.prom as jax_prom
import fei_tpu_torch.obs as torch_obs
import fei_tpu_torch.obs.prom as torch_prom

PKGS = {
    "fei_tpu": types.SimpleNamespace(obs=jax_obs, prom=jax_prom),
    "fei_tpu_torch": types.SimpleNamespace(obs=torch_obs, prom=torch_prom),
}
REPO = Path(__file__).resolve().parents[1]


def _both(fn):
    """``fn(pkg)`` for both packages; the port's result must be the
    reference's."""
    got = {label: fn(pkg) for label, pkg in PKGS.items()}
    assert got["fei_tpu_torch"] == got["fei_tpu"]
    return got["fei_tpu_torch"]


def _samples(seed: int, n: int) -> list[float]:
    rng = np.random.default_rng(seed)
    return [float(x) for x in rng.lognormal(mean=-4.0, sigma=2.0, size=n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_summaries_equal_the_reference(seed):
    """Log-normal latencies over the whole bucket ladder (+Inf included):
    bucket counts, quantiles and summaries equal."""
    data = _samples(seed, 500) + [1e4]

    def run(pkg):
        h = pkg.obs.Histogram()
        for v in data:
            h.observe(v)
        return (h.counts, h.inf_count, h.summary(),
                [h.quantile(q) for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0)])

    counts, inf_count, summary, _ = _both(run)
    assert sum(counts) + inf_count == len(data) and inf_count == 1
    assert summary["count"] == len(data)


def test_histogram_exact_math_and_bad_buckets():
    def run(pkg):
        h = pkg.obs.Histogram(buckets=[1.0, 2.0, 4.0])
        for v in (1.0, 1.5, 2.0, 3.0, 9.0):
            h.observe(v)
        empty = pkg.obs.Histogram().summary()
        errors = []
        for bad in ([], [2.0, 1.0], [1.0, 1.0]):
            try:
                pkg.obs.Histogram(buckets=bad)
            except ValueError:
                errors.append("ValueError")
        return h.counts, h.inf_count, h.quantile(0.5), h.quantile(1.0), empty, errors

    counts, inf_count, median, top, empty, errors = _both(run)
    assert counts == [1, 2, 1] and inf_count == 1  # le-inclusive edges
    assert median == pytest.approx(1.75) and top == 4.0  # 1 + (2.5 - 1) / 2
    assert empty["count"] == 0 and errors == ["ValueError"] * 3


def test_metrics_spans_observe_reset_and_the_shim():
    def run(pkg):
        m = pkg.obs.Metrics()
        with m.span("decode_step"):
            pass
        m.timing("prefill", 0.25)
        m.observe("ttft_seconds", 0.2)
        m.observe("ttft_seconds", 0.4)
        m.incr("tool.calls", 3)
        m.gauge("scheduler.queue_depth", 2)
        snap = m.snapshot()
        shape = (snap["spans"]["decode_step"]["count"],
                 snap["histograms"]["decode_step_seconds"]["count"],
                 snap["spans"]["prefill"], snap["histograms"]["ttft_seconds"],
                 snap["counters"], snap["gauges"])
        m.reset()
        return shape, m.snapshot()

    _both(run)
    from fei_tpu_torch.obs import METRICS
    from fei_tpu_torch.utils.metrics import METRICS as SHIM
    from fei_tpu_torch.utils.metrics import Metrics

    assert SHIM is METRICS and Metrics is torch_obs.Metrics


def test_nvtx_span_is_inert_without_cuda():
    """``span(nvtx=True)`` pushes no range on a CPU-only process (CUDA is
    not initialised) and still times the block."""
    m = torch_obs.Metrics()
    with m.span("prefill", nvtx=True):
        pass
    assert m.snapshot()["spans"]["prefill"]["count"] == 1


def test_prometheus_text_equals_the_reference():
    """The same series render to the same exposition: names, HELP from the
    registry, cumulative buckets, sums, counts, escaping."""
    data = _samples(7, 50)

    def run(pkg):
        m = pkg.obs.Metrics()
        m.incr("engine.decode_dispatches", 5)
        m.incr("tool.Grep-Tool", 2)
        m.incr("scheduler.requests_completed")
        m.gauge("scheduler.queue_depth", 3)
        m.gauge("roofline.frac", 0.123456789)
        for v in data:
            m.observe("ttft_seconds", v)
        with m.span("decode_step"):
            pass
        text = m.prometheus_text()
        # the span's own timing differs run to run: drop its series
        return "\n".join(ln for ln in text.splitlines() if "decode_step" not in ln)

    text = _both(run)
    assert "fei_engine_decode_dispatches_total 5" in text
    assert "# HELP fei_scheduler_queue_depth Sequences waiting" in text
    assert 'fei_ttft_seconds_bucket{le="+Inf"} 50' in text
    buckets = [int(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
               if ln.startswith("fei_ttft_seconds_bucket")]
    assert buckets == sorted(buckets)


def test_prometheus_helpers_equal_the_reference():
    _both(lambda pkg: [pkg.prom._sanitize("scheduler.queue_depth"),
                       pkg.prom._sanitize("tool.Grep-Tool"), pkg.prom._sanitize("9lives"),
                       pkg.prom._escape_help("a\\b\nc"), pkg.prom._escape_label('say "hi"\n'),
                       [pkg.prom._fmt(v) for v in (3.0, 0.1, float("inf"), -float("inf"))]])


def _trace_shape(d: dict) -> dict:
    return {k: v for k, v in d.items() if k not in ("id", "duration_s", "spans")} | {
        "phases": [s["phase"] for s in d["spans"]]}


def test_trace_buffer_lifecycle_equals_the_reference():
    def run(pkg):
        buf = pkg.obs.TraceBuffer(maxlen=3)
        traces = [buf.start(prompt_tokens=i) for i in range(5)]
        recent = buf.recent(10)
        order = [t["id"] for t in recent] == [traces[4].rid, traces[3].rid, traces[2].rid]
        tr = traces[4]
        for phase in ("admitted", "prefill", "preempted", "resumed", "first_token"):
            tr.event(phase)
        buf.finish(tr, "completed", completion_tokens=7)
        buf.finish(tr, "cancelled")  # racing path: the first status wins
        d = buf.recent(1)[0]
        ts = [s["ts"] for s in d["spans"]]
        try:
            buf.finish(buf.start(), "exploded")
            bad = None
        except ValueError:
            bad = "ValueError"
        got = buf.get(tr.rid) is tr and buf.get("req-nope") is None
        return [len(recent), order, len(buf), _trace_shape(d), ts == sorted(ts), bad, got]

    out = _both(run)
    assert out[3]["phases"] == ["queued", "admitted", "prefill", "preempted",
                                "resumed", "first_token", "completed"]


def test_trace_file_and_ring_env_equal_the_reference(tmp_path, monkeypatch):
    def run(pkg):
        path = tmp_path / f"{pkg.obs.__name__}.jsonl"
        monkeypatch.setenv("FEI_TPU_TRACE_FILE", str(path))
        monkeypatch.setenv("FEI_TPU_TRACE_RING", "2")
        buf = pkg.obs.TraceBuffer()
        for status in ("completed", "failed", "shed", "snapshotted"):
            buf.finish(buf.start(mesh="ms1"), status)
        rows = [json.loads(x) for x in path.read_text().splitlines()]
        return [len(buf), [_trace_shape(r) for r in rows],
                all(r["id"].startswith("req-") for r in rows)]

    assert _both(run)[0] == 2


def test_registry_is_the_reference_plus_the_ports_own_names():
    ref, port = jax_obs.METRIC_REGISTRY, torch_obs.METRIC_REGISTRY
    own = set(port) - set(ref)
    assert own == {"kv.spill_skipped_length", "scheduler.replayed_tokens",
                   "provider.torch_local", "scheduler.dispatch_issue_seconds",
                   "scheduler.admit_seconds"}
    assert set(ref) <= set(port)
    differ = {k for k in ref if port[k] != ref[k]}
    # the one help text that names the port's profiler
    assert differ == {"server.profile_captures"}
    assert port["server.profile_captures"][0] == ref["server.profile_captures"][0]
    for name, (kind, help_text) in port.items():
        assert kind in ("counter", "gauge", "span", "histogram"), name
        assert help_text


def test_declared_and_help_for_equal_the_reference():
    names = ["scheduler.queue_depth", "tool.GrepTool", "tool.*", "scheduler.requests_*",
             "made.up.metric", "decode_step", "decode_step_seconds", "nope_seconds",
             "router.resurrections", "kv.prefix_hits_remote", "roofline.frac"]
    got = _both(lambda pkg: [(pkg.obs.declared(n), pkg.obs.help_for(n)) for n in names])
    assert got[4] == (False, None) and got[6][1][0] == "histogram"


# -- the lint: every METRICS call site in fei_tpu_torch/ is declared ---------

_CALL = re.compile(r"METRICS\s*\.\s*(incr|gauge|observe|span|timing)\s*\(\s*(f?)\"([^\"]+)\"")
_ANY_CALL = re.compile(r"METRICS\s*\.\s*(incr|gauge|observe|span|timing)\s*\(")
_FSTRING_FIELD = re.compile(r"\{[^{}]*\}")


def _call_sites(text: str) -> tuple[list[str], int]:
    """(normalized names of literal call sites, count of all call sites)."""
    names = []
    for m in _CALL.finditer(text):
        name = m.group(3)
        if m.group(2):
            name = _FSTRING_FIELD.sub("*", name)
        names.append(name)
    return names, len(_ANY_CALL.findall(text))


def test_every_port_metric_name_is_declared():
    undeclared, sites = [], 0
    for path in sorted((REPO / "fei_tpu_torch").rglob("*.py")):
        text = path.read_text(encoding="utf-8")
        names, n_calls = _call_sites(text)
        # every call site names its metric with a (possibly f-) string
        # literal: a computed name is invisible to dashboards
        assert len(names) == n_calls, f"{path}: a METRICS call with a computed name"
        sites += len(names)
        undeclared += [f"{path.name}: {n}" for n in names if not torch_obs.declared(n)]
    assert sites > 100 and undeclared == []


def test_lint_catches_an_undeclared_name():
    names, n = _call_sites('METRICS.incr(f"bogus.{kind}", 2)\nMETRICS.gauge("kv.spilled_gbps", 1)')
    assert names == ["bogus.*", "kv.spilled_gbps"] and n == 2
    assert [torch_obs.declared(x) for x in names] == [False, True]
    names, n = _call_sites("METRICS.incr(name)")
    assert names == [] and n == 1  # a computed name is caught too


def test_metrics_exposition_lists_only_declared_names():
    """Every series a port engine's dispatches put into METRICS has a
    registry entry (the check chip_smoke.py makes on /metrics)."""
    import torch

    from fei_tpu_torch.engine.engine import GenerationConfig, InferenceEngine

    eng = InferenceEngine.from_config("tiny", device="cpu", dtype=torch.float32,
                                      paged=True, batch_size=2, max_seq_len=128)
    try:
        list(eng.scheduler.stream(list(range(11, 40)),
                                  GenerationConfig(max_new_tokens=12, ignore_eos=True)))
    finally:
        eng.close()
    snap = torch_obs.METRICS.snapshot()
    names = [n for section in ("counters", "gauges", "spans", "histograms")
             for n in snap[section]]
    assert "roofline.frac" in names and "scheduler.decode_steps" in names
    assert [n for n in names if torch_obs.help_for(n) is None] == []
