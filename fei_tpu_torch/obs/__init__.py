"""Observability of the port (counterpart of fei_tpu/obs): metrics,
histograms, request traces, the engine flight recorder, the roofline cost
model and Prometheus exposition. fei_tpu_torch/utils/metrics.py re-exports
the METRICS singleton from here."""

from fei_tpu_torch.obs.flight import FLIGHT, CompileObserver, FlightRecorder
from fei_tpu_torch.obs.metrics import (
    DEFAULT_BUCKETS,
    METRICS,
    Histogram,
    Metrics,
)
from fei_tpu_torch.obs.registry import METRIC_REGISTRY, declared, help_for
from fei_tpu_torch.obs.render import snapshot_lines
from fei_tpu_torch.obs.trace import TRACES, RequestTrace, TraceBuffer

__all__ = [
    "DEFAULT_BUCKETS",
    "FLIGHT",
    "METRICS",
    "METRIC_REGISTRY",
    "CompileObserver",
    "FlightRecorder",
    "Histogram",
    "Metrics",
    "RequestTrace",
    "TRACES",
    "TraceBuffer",
    "declared",
    "help_for",
    "snapshot_lines",
]
