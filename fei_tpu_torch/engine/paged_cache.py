"""Paged KV cache: page pool + block tables + host-side allocator
(counterpart of fei_tpu/engine/paged_cache.py).

Layouts (L=layers, P=pool pages, K=kv heads, ps=page size, D=head dim) are
the JAX package's:
  k_pages/v_pages: [L, P, K, ps, D]   head-major pages (the kernels' layout)
  k_scales/v_scales: [L, P, K, 1, ps] fp32 per-slot scales (int8 pools)
  block_table:     [B, max_pages]     int32 page ids, row-ragged
  lengths:         [B]                int32 valid token count

Where JAX returns updated pools (donated, so updated in place in HBM),
``write_token_kv`` writes into the pool tensors in place. The allocator and
the prefix registry are host-side Python, copied from the JAX package.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np
import torch

from fei_tpu_torch.models.configs import ModelConfig
from fei_tpu_torch.parallel.serving import spmd_op
from fei_tpu_torch.utils.errors import EngineError
from fei_tpu_torch.utils.metrics import METRICS


class PagedKVCache(NamedTuple):
    """Page pool + block tables. With ``kv_quant="int8"`` the pools store
    int8 with per-slot (per-token, per-head) fp32 scales — KV bytes halve,
    so a pool holds ~2x the conversation tokens."""

    k_pages: torch.Tensor  # [L, P, K, ps, D] (bf16, or int8 when quantized)
    v_pages: torch.Tensor
    block_table: torch.Tensor  # [B, max_pages] int32
    lengths: torch.Tensor  # [B] int32
    k_scales: torch.Tensor | None = None  # [L, P, K, 1, ps] fp32 (int8 mode)
    v_scales: torch.Tensor | None = None

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]

    @property
    def quantized(self) -> bool:
        return self.k_scales is not None

    @classmethod
    def create(
        cls,
        cfg: ModelConfig,
        num_pages: int,
        batch: int,
        max_pages_per_seq: int,
        page_size: int = 64,
        dtype=torch.bfloat16,
        kv_quant: str | None = None,
        device: torch.device | str = "cpu",
        num_kv_heads: int | None = None,
    ) -> "PagedKVCache":
        """A zeroed pool; ``num_kv_heads`` overrides the config's (a tp
        rank's shard holds its kv heads)."""
        if kv_quant not in (None, "int8"):
            raise EngineError(f"unsupported kv_quant mode: {kv_quant!r}")
        L, K, D = cfg.num_layers, num_kv_heads or cfg.num_kv_heads, cfg.head_dim_
        shape = (L, num_pages, K, page_size, D)
        pool_dtype = torch.int8 if kv_quant == "int8" else dtype

        def scales():
            if kv_quant != "int8":
                return None
            return torch.ones((L, num_pages, K, 1, page_size), dtype=torch.float32,
                              device=device)

        return cls(
            k_pages=torch.zeros(shape, dtype=pool_dtype, device=device),
            v_pages=torch.zeros(shape, dtype=pool_dtype, device=device),
            block_table=torch.zeros((batch, max_pages_per_seq), dtype=torch.int32,
                                    device=device),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
            k_scales=scales(),
            v_scales=scales(),
        )


@spmd_op
def scatter_dense(dense, pool: PagedKVCache, page_ids: list[int], kernel_mesh=None) -> None:
    """Copy the first len(page_ids)*ps positions of a [L, 1, S, K, D] dense
    cache into those pool pages (one indexed write per pool; int8 pools
    quantize per (position, head) row). Under a mesh each rank copies its
    own kv heads."""
    ps = pool.page_size
    n_pages = len(page_ids)
    need = n_pages * ps
    idx = torch.as_tensor(page_ids, dtype=torch.long, device=pool.k_pages.device)

    def pages_of(x):  # [L, 1, S, K, D] -> [L, n_pages, K, ps, D]
        x = x[:, 0, :need]
        if x.shape[1] < need:
            x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, need - x.shape[1]))
        L, _, K, D = x.shape
        return x.reshape(L, n_pages, ps, K, D).transpose(2, 3)

    for src, dst, scales in ((dense.k, pool.k_pages, pool.k_scales),
                             (dense.v, pool.v_pages, pool.v_scales)):
        blocks = pages_of(src)
        if scales is not None:
            blocks, s = quant_kv_rows(blocks)  # s: [L, n, K, ps]
            scales[:, idx] = s[:, :, :, None, :]
        dst[:, idx] = blocks.to(dst.dtype)


def replace_lengths(pool: PagedKVCache, lengths) -> PagedKVCache:
    """Host-authoritative per-slot length override: swap ONLY the ``[B]``
    lengths leaf. Positions at or above a slot's new length are
    unreachable (decode attends strictly below ``lengths``) and later
    writes land at the running length, overwriting them in place."""
    return pool._replace(lengths=torch.as_tensor(
        lengths, dtype=torch.int32).to(pool.lengths.device))


def quant_kv_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the last (head_dim) axis: per-token, per-head
    scales. Returns (int8 values, fp32 scales with the D axis dropped).
    The rule is the JAX package's ``ops.quant.quantize``: scale amax/127
    (1 where amax is 0), round half to even, clip to ±127."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    s = torch.where(amax == 0.0, torch.ones_like(amax), amax / 127.0)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s[..., 0]


class PageAllocator:
    """Refcounting free-list page allocator over a pool of ``num_pages``.

    Page 0 is reserved as the null page (block-table padding points there).
    Pages are refcounted so prefix caching can SHARE full prompt-prefix
    pages across sequences (and with the PrefixCache registry): a page
    returns to the free list only when its last reference drops."""

    def __init__(self, num_pages: int, page_size: int):
        self.num_pages = num_pages
        self.page_size = page_size
        self._free = list(range(num_pages - 1, 0, -1))  # pop() yields 1, 2, …
        self._owned: dict[int, list[int]] = {}
        self._refs: dict[int, int] = {}
        self._refresh_gauges()

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def _refresh_gauges(self) -> None:
        total = self.num_pages - 1  # page 0 is the reserved null page
        free = len(self._free)
        METRICS.gauge("pool.pages_total", total)
        METRICS.gauge("pool.pages_free", free)
        METRICS.gauge("pool.pages_in_use", total - free)

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def pages_for(self, seq_id: int) -> list[int]:
        return list(self._owned.get(seq_id, []))

    def alloc(self, seq_id: int, n: int, contiguous: bool = False) -> list[int]:
        """Allocate n fresh pages for a sequence (``contiguous``: an
        ascending run)."""
        if n > len(self._free):
            raise EngineError(
                f"paged KV pool exhausted: need {n} pages, {len(self._free)} free"
            )
        if contiguous:
            run = self._find_run(n)
            if run is None:
                raise EngineError(
                    f"paged KV pool fragmented: no contiguous run of {n} pages"
                )
            for p in run:
                self._free.remove(p)
            got = run
        else:
            got = [self._free.pop() for _ in range(n)]
        for p in got:
            self._refs[p] = 1
        self._owned.setdefault(seq_id, []).extend(got)
        self._refresh_gauges()
        return got

    def try_alloc(self, seq_id: int, n: int, contiguous: bool = False) -> list[int] | None:
        """:meth:`alloc` that returns None on exhaustion (or fragmentation
        in contiguous mode) with no partial effects."""
        if n > len(self._free):
            return None
        if contiguous and self._find_run(n) is None:
            return None
        return self.alloc(seq_id, n, contiguous=contiguous)

    def share(self, seq_id: int, pages: list[int]) -> None:
        """Add existing (cached-prefix) pages to a sequence; all-or-nothing."""
        for p in pages:
            if self._refs.get(p, 0) <= 0:
                raise EngineError(f"cannot share unreferenced page {p}")
        for p in pages:
            self._refs[p] += 1
        self._owned.setdefault(seq_id, []).extend(pages)

    def take_ref(self, pages: list[int]) -> None:
        """Registry-held references; all-or-nothing."""
        for p in pages:
            if self._refs.get(p, 0) <= 0:
                raise EngineError(f"cannot reference dead page {p}")
        for p in pages:
            self._refs[p] += 1

    def drop_ref(self, pages: list[int]) -> None:
        for p in pages:
            self._refs[p] -= 1
            if self._refs[p] <= 0:
                del self._refs[p]
                self._free.append(p)
        if pages:
            self._refresh_gauges()

    def _find_run(self, n: int) -> list[int] | None:
        run: list[int] = []
        for p in sorted(self._free):
            if run and p == run[-1] + 1:
                run.append(p)
            else:
                run = [p]
            if len(run) == n:
                return run
        return None

    def release_prefix(self, seq_id: int, n: int) -> list[int]:
        """Drop the sequence's first ``n`` owned pages (rolling-buffer
        sliding-window serving: positions below every future query's window
        are never attended again). Returns the released page ids."""
        owned = self._owned.get(seq_id, [])
        drop, self._owned[seq_id] = owned[:n], owned[n:]
        self.drop_ref(drop)
        return drop

    def free(self, seq_id: int) -> None:
        self.drop_ref(list(reversed(self._owned.pop(seq_id, []))))

    def pages_needed(self, tokens: int) -> int:
        return -(-tokens // self.page_size)


class PrefixCache:
    """Page-aligned prompt-prefix registry for KV reuse across requests.

    Full pages of a finished admission register here keyed by the chained
    token-prefix hash at each page boundary; a later request reuses its
    longest cached prefix and prefills only the suffix. Entries hold
    allocator references so shared pages outlive their first sequence; LRU
    eviction under pool pressure returns them."""

    def __init__(self, alloc: PageAllocator, max_entries: int = 512):
        self.alloc = alloc
        self.max_entries = max_entries
        self._entries: dict[bytes, tuple[tuple[int, ...], int]] = {}
        self._clock = 0

    @staticmethod
    def _boundary_keys(prompt_ids, n_pages: int, page_size: int) -> list[bytes]:
        """Chained per-page digests: key_i = sha256(key_{i-1} || page_i)."""
        ids = np.asarray(prompt_ids, dtype=np.int32)
        keys: list[bytes] = []
        prev = b""
        for i in range(n_pages):
            h = hashlib.sha256()
            h.update(prev)
            h.update(ids[i * page_size : (i + 1) * page_size].tobytes())
            prev = h.digest()
            keys.append(prev)
        return keys

    def match(self, prompt_ids) -> list[int]:
        """Longest cached page-aligned prefix STRICTLY shorter than the
        prompt (one suffix token must remain to produce logits)."""
        ps = self.alloc.page_size
        max_m = (len(prompt_ids) - 1) // ps
        keys = self._boundary_keys(prompt_ids, max_m, ps)
        for m in range(max_m, 0, -1):
            hit = self._entries.get(keys[m - 1])
            if hit is not None:
                self._clock += 1
                self._entries[keys[m - 1]] = (hit[0], self._clock)
                METRICS.incr("prefix.hits")
                return list(hit[0])
        METRICS.incr("prefix.misses")
        return []

    def register(self, prompt_ids, pages: list[int]) -> None:
        """Register every full-page boundary of a freshly admitted prompt."""
        ps = self.alloc.page_size
        full = len(prompt_ids) // ps
        for m, key in enumerate(self._boundary_keys(prompt_ids, full, ps), 1):
            if key in self._entries:
                continue
            entry_pages = tuple(pages[:m])
            self.alloc.take_ref(list(entry_pages))
            self._clock += 1
            self._entries[key] = (entry_pages, self._clock)
        while len(self._entries) > self.max_entries:
            self._evict_one()
        METRICS.gauge("prefix.entries", len(self._entries))

    def _evict_one(self) -> bool:
        if not self._entries:
            return False
        key = min(self._entries, key=lambda k: self._entries[k][1])
        pages, _ = self._entries.pop(key)
        self.alloc.drop_ref(list(pages))
        METRICS.incr("prefix.evictions")
        METRICS.gauge("prefix.entries", len(self._entries))
        return True

    def evict_for(self, pages_wanted: int) -> None:
        """Free registry references until ``pages_wanted`` are available."""
        while self.alloc.free_pages < pages_wanted and self._evict_one():
            pass


def build_block_table(page_lists: list[list[int]], max_pages: int,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    """Host page lists → padded [B, max_pages] int32 table (null page 0)."""
    rows = []
    for pages in page_lists:
        if len(pages) > max_pages:
            raise EngineError(
                f"sequence owns {len(pages)} pages > table width {max_pages}"
            )
        rows.append(list(pages) + [0] * (max_pages - len(pages)))
    return torch.tensor(rows, dtype=torch.int32, device=device)


def write_token_kv(
    k_pages: torch.Tensor,  # [P, K, ps, D] one layer's pool
    v_pages: torch.Tensor,
    k_new: torch.Tensor,  # [B, T, K, D] keys of T consecutive positions
    v_new: torch.Tensor,
    block_table: torch.Tensor,  # [B, max_pages]
    lengths: torch.Tensor,  # [B] position of each row's first new token
    k_scales: torch.Tensor | None = None,  # [P, K, 1, ps] (int8 pools)
    v_scales: torch.Tensor | None = None,
) -> None:
    """Scatter T positions' K/V of every row into its pages, in place, with
    one indexed write per pool (the JAX version unrolls one
    ``dynamic_update_slice`` per row and position). int8 pools quantize
    each (position, head) row over D, with its own scale. A position past
    the table's width lands in the reserved null page 0, as in the JAX
    package: a clamped column would be a live page."""
    ps = k_pages.shape[2]
    B, T = k_new.shape[:2]
    width = block_table.shape[1]
    pos = lengths.long()[:, None] + torch.arange(T, device=k_pages.device)[None, :]
    slot = pos // ps
    offset = pos % ps
    col = torch.gather(block_table.long(), 1, slot.clamp(max=width - 1))
    page = torch.where(slot < width, col, torch.zeros_like(col))  # [B, T]
    if k_scales is not None:
        k_new, ks = quant_kv_rows(k_new)  # int8 [B, T, K, D], [B, T, K]
        v_new, vs = quant_kv_rows(v_new)
        k_scales[page, :, 0, offset] = ks
        v_scales[page, :, 0, offset] = vs
    k_pages[page, :, offset] = k_new.to(k_pages.dtype)
    v_pages[page, :, offset] = v_new.to(v_pages.dtype)


def paged_attention_reference(
    q: torch.Tensor,  # [B, H, D]
    k_pages: torch.Tensor,  # [P, K, ps, D]
    v_pages: torch.Tensor,
    block_table: torch.Tensor,  # [B, max_pages]
    lengths: torch.Tensor,  # [B]
    k_scales: torch.Tensor | None = None,  # [P, K, 1, ps]
    v_scales: torch.Tensor | None = None,
    window: int = 0,
) -> torch.Tensor:
    """Gather-based oracle for single-token paged attention (the JAX
    package's ``paged_attention_reference``): the paged kernels' plain
    version at one query position per row."""
    from fei_tpu_torch.ops.kernels.paged_attention import paged_rows_plain

    return paged_rows_plain(q[:, None], k_pages, v_pages, block_table, lengths,
                            k_scales=k_scales, v_scales=v_scales, window=window)[:, 0]
