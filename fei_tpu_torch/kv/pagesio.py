"""Byte-exact page movement between the paged pool and host memory
(counterpart of fei_tpu/kv/pagesio.py).

``gather_pages`` pulls a set of pool pages to host numpy arrays
(page-axis-first, so entries concatenate and slice per page);
``scatter_pages`` writes them back into (possibly different) page ids of a
(possibly different) pool, in place. Together they are the transport the
RAM/disk tier and migration ride on, so two invariants matter more than
speed:

- **Bitwise round-trip**: gather → scatter restores exactly the bytes that
  were resident, for bf16 and int8(+scales) pools alike. Resume
  correctness (greedy AND seeded byte-identity) reduces to this. bf16
  pages travel as their 2-byte words (``tier.BF16_WORDS``): no cast ever
  touches them.
- **Stream order**: both run on the scheduler loop thread, on the device's
  current stream, so a gather sees every KV write of the dispatches before
  it and a scatter lands before the next dispatch reads the pages. Both
  copies are blocking: a gather's host arrays are complete when it
  returns, and a scatter's host arrays may be freed as soon as it returns.

The pool geometry splits in two, as in the JAX package:

- ``pool_fingerprint`` — the INVARIANT half (layers, total kv heads,
  page_size, head_dim, dtype, quantized), with the JAX package's dtype
  names (``"bfloat16"``, ``"float32"``, ``"int8"``): two pools exchange KV
  iff this matches, across packages too, and content-addressed keys salt
  with only this half.
- ``shard_layout`` — the LAYOUT half (tp degree + per-shard head slices).
  Blobs travel in the canonical full-extent head order whatever the
  writer's layout: on a tp mesh ``gather_pages`` gathers every rank's
  heads, and ``scatter_pages`` hands each rank its own; a blob with a
  permuted layout is resharded by ``canonicalize_arrays`` before it
  scatters.

Both are ``parallel.serving`` ops: on rank 0 of a mesh engine they run on
every rank. A rank's pool holds its kv heads, so the per-page geometry is
the rank's shapes with the head extent times tp.

The JAX package pads page-id lists to bound its jit cache; eager torch
needs no padding.
"""

from __future__ import annotations

import numpy as np
import torch

from fei_tpu_torch.kv.tier import BF16_WORDS
from fei_tpu_torch.parallel.serving import spmd_op

_ARRAY_FIELDS = ("k_pages", "v_pages", "k_scales", "v_scales")


def dtype_name(dtype) -> str:
    """A torch dtype under the JAX package's (numpy's) name."""
    return str(dtype).removeprefix("torch.")


def pool_fingerprint(pool, tp: int = 1) -> dict:
    """The INVARIANT per-page geometry a spilled entry must match to
    scatter back: everything except the pool's total page count (two
    replicas with different memory budgets still exchange sessions) and
    its shard layout. ``tp``: the pool is one of tp head shards, so the
    total kv-head extent is its own times tp."""
    L, _, K, ps, D = pool.k_pages.shape
    return {
        "layers": int(L),
        "kv_heads": int(K) * int(tp),
        "page_size": int(ps),
        "head_dim": int(D),
        "dtype": dtype_name(pool.k_pages.dtype),
        "quantized": bool(pool.quantized),
    }


def config_fingerprint(cfg, page_size: int, dtype, kv_quant: str | None = None) -> dict:
    """``pool_fingerprint`` derived from the model config alone: what a
    replica advertises on ``/health`` before its pool exists. Equal to
    ``pool_fingerprint`` of the pool ``PagedKVCache.create`` builds from
    the same knobs."""
    quantized = kv_quant == "int8"
    return {
        "layers": int(cfg.num_layers),
        "kv_heads": int(cfg.num_kv_heads),
        "page_size": int(page_size),
        "head_dim": int(cfg.head_dim_),
        "dtype": dtype_name(torch.int8 if quantized else dtype),
        "quantized": quantized,
    }


def shard_layout(kv_heads: int, tp: int = 1) -> dict:
    """The LAYOUT half of the pool geometry: how the kv-head extent is
    sliced over ``tp`` shards. Provenance, not a compatibility gate."""
    hps = int(kv_heads) // max(tp, 1)
    return {
        "tp": int(tp),
        "head_slices": [[i * hps, (i + 1) * hps] for i in range(tp)],
    }


def check_fingerprint(ours: dict, theirs: dict, what: str = "blob") -> None:
    """Refuse an INVARIANT geometry mismatch with the structured
    ``{ours, theirs}`` diff (``KVGeometryError`` -> HTTP 409: never
    retryable, unlike a corrupt blob's 422)."""
    from fei_tpu_torch.utils.errors import KVGeometryError

    if dict(theirs) == dict(ours):
        return
    diff = sorted(k for k in set(ours) | set(theirs) if ours.get(k) != theirs.get(k))
    raise KVGeometryError(
        f"{what} geometry is invariant-incompatible with this pool "
        f"(differs on {', '.join(diff) or 'unknown keys'}): "
        f"theirs={theirs} ours={ours}",
        ours=ours, theirs=theirs,
    )


def canonicalize_arrays(arrays: dict[str, np.ndarray], layout: dict | None,
                        kv_heads: int) -> dict[str, np.ndarray]:
    """Reshard host page arrays into the canonical layout (full kv-head
    extent, natural head order). A blob with no recorded layout, or whose
    slices already concatenate in natural order, is canonical as-is; a
    permuted slice order re-orders the head axis (axis 2 of both
    ``[n, L, K, ps, D]`` pages and ``[n, L, K, 1, ps]`` scales); partial
    or overlapping head coverage raises ``KVGeometryError``."""
    from fei_tpu_torch.utils.errors import KVGeometryError

    if not layout:
        return arrays
    slices = [(int(lo), int(hi)) for lo, hi in (layout.get("head_slices") or [])]
    if not slices:
        return arrays  # the contiguous equal split: natural order
    heads = [h for lo, hi in slices for h in range(lo, hi)]
    if sorted(heads) != list(range(int(kv_heads))):
        raise KVGeometryError(
            f"blob layout {layout} does not cover kv heads "
            f"[0, {kv_heads}) exactly once; these pages cannot serve "
            "the full head extent on any mesh",
            theirs={"layout": layout}, ours={"kv_heads": int(kv_heads)},
        )
    if heads == sorted(heads):
        return arrays
    idx = np.argsort(np.asarray(heads, dtype=np.int64), kind="stable")
    return {name: np.ascontiguousarray(np.take(a, idx, axis=2))
            for name, a in arrays.items() if a is not None}


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A device tensor as a host array (blocking; bf16 as its words). On
    the card the copy lands in pinned memory, whose numpy view keeps the
    tensor alive."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
    host.copy_(t)
    a = host.numpy()
    return a.view(BF16_WORDS) if a.dtype == np.int16 else a


def _from_host(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A host array as a CPU tensor of the pool's dtype. A bf16 pool takes
    2-byte words (``BF16_WORDS``, or the JAX package's bfloat16 arrays)
    bit for bit; any other pool casts, as the JAX package's scatter does.
    A read-only array (a view of a blob) is copied: torch wants writable
    memory."""
    a = np.require(a, requirements=("C", "W"))
    if dtype == torch.bfloat16:
        if a.dtype.itemsize != 2:
            raise ValueError(f"a bf16 pool takes 2-byte words, not {a.dtype}")
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a).to(dtype)


@spmd_op
def gather_pages(pool, pages: list[int], kernel_mesh=None) -> dict[str, np.ndarray] | None:
    """Pool pages -> host numpy, page-axis-first ([n, L, K, ps, D] /
    scales [n, L, K, 1, ps]). The pool is read, never changed. Under a
    mesh each rank gathers its kv heads and they are all-gathered over tp
    into the full extent; rank 0 returns the host arrays (the others
    None)."""
    idx = torch.as_tensor(list(pages), dtype=torch.long, device=pool.k_pages.device)
    out = {}
    for name in _ARRAY_FIELDS:
        src = getattr(pool, name)
        if src is None:
            continue
        # [L, P, ...] -index_select-> [L, n, ...] -> page-axis-first
        got = src.index_select(1, idx).movedim(1, 0).contiguous()
        if kernel_mesh is not None:
            got = kernel_mesh.all_gather(got, "tp", dim=2)
        out[name] = got
    if kernel_mesh is not None and kernel_mesh.rank != 0:
        return None
    return {name: _to_host(t) for name, t in out.items()}


@spmd_op
def scatter_pages(pool, pages: list[int], arrays: dict[str, np.ndarray],
                  kernel_mesh=None) -> None:
    """Host page arrays -> pool pages, in place (the JAX package donates
    the pool and returns it). ``arrays`` may hold MORE pages than
    ``pages`` asks for: the leading ``len(pages)`` are written. The arrays
    hold the full kv-head extent; under a mesh each rank writes its own
    heads."""
    n = len(pages)
    dev = pool.k_pages.device
    idx = torch.as_tensor(list(pages), dtype=torch.long, device=dev)
    for name in _ARRAY_FIELDS:
        dst = getattr(pool, name)
        if dst is None or arrays.get(name) is None:
            continue
        a = np.asarray(arrays[name])[:n]
        if kernel_mesh is not None and a.shape[2] != dst.shape[2]:
            k = dst.shape[2]
            c = kernel_mesh.coords["tp"]
            a = a[:, :, c * k:(c + 1) * k]
        src = _from_host(a, dst.dtype).to(dev)
        dst.index_copy_(1, idx, src.movedim(0, 1))
