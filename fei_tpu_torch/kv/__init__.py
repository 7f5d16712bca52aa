"""Tiered, mobile KV page store (counterpart of fei_tpu/kv/).

- ``tier``    — host-RAM → disk page store with LRU demotion under byte
  budgets (``FEI_TPU_KV_TIER`` et al.), versioned + checksummed FKV1
  entries, async disk writes; the blobs are the JAX package's byte for
  byte, bf16 included (carried as 2-byte words, no ``ml_dtypes``).
- ``pagesio`` — gather/scatter between the paged pool
  (``engine/paged_cache.PagedKVCache``) and host numpy arrays, with the
  pool fingerprint and the canonical (full kv-head extent) layout.
- ``migrate`` — a prefix's KV pages as one portable blob
  (``/kv/export`` → ``/kv/import``).
- ``content`` — content-addressed (``cas:``) keys for prefix blobs.

Every tier/migration path is an optimization with token replay as the
always-correct fallback: a missing, corrupt or mismatched entry never
wedges a slot, and a resume through streamed pages is byte-identical to
one through replay.
"""

from fei_tpu_torch.kv.pagesio import gather_pages, pool_fingerprint, scatter_pages
from fei_tpu_torch.kv.tier import KVTierStore, PageEntry, TierConfig

__all__ = [
    "KVTierStore",
    "PageEntry",
    "TierConfig",
    "gather_pages",
    "scatter_pages",
    "pool_fingerprint",
]
