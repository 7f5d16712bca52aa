"""Cross-replica session migration: a prefix's KV pages as one blob
(a copy of fei_tpu/kv/migrate.py).

The source replica serializes the longest page-aligned cached prefix for a
prompt (``export_blob``), the blob travels over the control plane
(``POST /kv/export`` → ``POST /kv/import``, ui/server.py), and the target
scatters the pages into its own pool and registers them in its prefix
cache (``import_blob``): the next admission of that prefix hits the cache
instead of re-prefilling. Blobs cross between the two packages unchanged.

Contract:

- The blob is the ``tier.pack_entry`` wire format with the prompt ids in
  the header's ``extra``: self-describing, versioned, checksummed.
- Import refuses only an INVARIANT geometry mismatch (``pool_fingerprint``:
  model shape, dtype, page size) with ``KVGeometryError`` (HTTP 409). A tp
  *layout* skew reshards on scatter (``canonicalize_arrays``).
- Import is best-effort and never preempts: it takes only pages the pool
  can spare now (after a prefix-cache eviction pass); a refused import
  costs one re-prefill.

Both entry points run on the scheduler loop thread (``run_ctl``): the pool
is single-owner state and migration must not race a dispatch. The scatter
is in place (the JAX package donates the pool instead).
"""

from __future__ import annotations

from fei_tpu_torch.kv.pagesio import (
    canonicalize_arrays,
    check_fingerprint,
    gather_pages,
    pool_fingerprint,
    scatter_pages,
    shard_layout,
)
from fei_tpu_torch.kv.tier import PageEntry, pack_entry, unpack_entry
from fei_tpu_torch.utils.errors import KVTierError
from fei_tpu_torch.utils.logging import get_logger
from fei_tpu_torch.utils.metrics import METRICS

log = get_logger("kv.migrate")

# pseudo seq-id for in-flight imports: real slots are 0..B-1, spill keys
# are request ids — this never collides with either
_IMPORT_ID = -7777


def export_blob(scheduler, prompt_ids: list[int]) -> bytes | None:
    """The longest page-aligned cached prefix of ``prompt_ids`` as a
    portable blob, or None when nothing is cached. Loop-thread only."""
    pool = scheduler._pool
    prefix = scheduler._prefix
    if pool is None or prefix is None:
        return None
    pages = prefix.match(prompt_ids)
    if not pages:
        return None
    alloc = scheduler.engine._allocator
    alloc.take_ref(pages)  # pin against eviction while we gather
    try:
        arrays = gather_pages(pool, pages)
    finally:
        alloc.drop_ref(pages)
    ps = pool.page_size
    covered = len(pages) * ps
    entry = PageEntry(
        key="migrate",
        n_tokens=covered,
        page_size=ps,
        fingerprint=pool_fingerprint(pool, scheduler.engine.tp),
        arrays=arrays,
        layout=shard_layout(scheduler.engine.cfg.num_kv_heads, scheduler.engine.tp),
    )
    blob = pack_entry(entry, extra={"prompt_ids": list(prompt_ids[:covered])})
    METRICS.incr("kv.migrations_out")
    METRICS.incr("kv.bytes_migrated", entry.nbytes)
    return blob


def import_blob(scheduler, blob: bytes) -> int:
    """Scatter a migration blob into this replica's pool and register the
    prefix. Returns how many pages landed (0 = refused: no room even after
    prefix eviction; never preempts live work). Raises ``KVTierError`` on
    a corrupt blob or a geometry mismatch. Loop-thread only."""
    entry, extra = unpack_entry(blob)
    prompt_ids = [int(t) for t in extra.get("prompt_ids") or []]
    if not prompt_ids or entry.n_pages == 0:
        raise KVTierError("migration blob carries no prefix")
    scheduler._ensure_pool()
    pool = scheduler._pool
    prefix = scheduler._prefix
    if prefix is None:
        raise KVTierError("target replica runs without a prefix cache")
    want = pool_fingerprint(pool, scheduler.engine.tp)
    check_fingerprint(want, entry.fingerprint, what="migration blob")
    arrays = canonicalize_arrays(entry.arrays, entry.layout, want["kv_heads"])
    if entry.layout is not None and entry.layout.get("tp") != scheduler.engine.tp:
        METRICS.incr("kv.resharded_imports")
    alloc = scheduler.engine._allocator
    n = entry.n_pages
    got = alloc.try_alloc(_IMPORT_ID, n)
    if got is None:
        prefix.evict_for(n)
        got = alloc.try_alloc(_IMPORT_ID, n)
    if got is None:
        log.info("migration import refused: %d pages don't fit", n)
        return 0
    try:
        scatter_pages(pool, got, arrays)
        prefix.register(prompt_ids, got)
    finally:
        # the registry's refs keep the pages; drop the import's own claim
        alloc.free(_IMPORT_ID)
    METRICS.incr("kv.migrations_in")
    METRICS.incr("kv.pages_migrated", n)
    return n
