"""Back-compat shim: the metrics implementation lives in fei_tpu_torch/obs/
(counterpart of fei_tpu/utils/metrics.py).

Every ``from fei_tpu_torch.utils.metrics import METRICS`` call site keeps
working; the names they set are declared in fei_tpu_torch/obs/registry.py,
and the KV tier's byte accounting is fei_tpu_torch/obs/costmodel.py's
``account_kv_transfer``.
"""

from fei_tpu_torch.obs.metrics import (  # noqa: F401
    DEFAULT_BUCKETS,
    METRICS,
    Histogram,
    Metrics,
    _Stat,
)

__all__ = ["DEFAULT_BUCKETS", "METRICS", "Histogram", "Metrics"]
