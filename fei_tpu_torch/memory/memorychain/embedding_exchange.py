"""Embedding exchange between federation nodes (the port of
fei_tpu/memory/memorychain/embedding_exchange.py).

The reference's Memorychain broadcasts memories peer-to-peer as HTTP JSON
(reference memorychain.py:1003-1035). The bandwidth-heavy part of sharing
memory, the embedding vectors used for similarity recall, moves onto the
device instead: each node contributes its local embedding bank and one
all-gather over the nodes gives every node the federation-wide bank. The
chain (small JSON blocks, consensus votes) stays on the HTTP control plane.

The JAX package gathers over a mesh axis with ``shard_map``; here the
gather is ``torch.distributed.all_gather`` over a process group (NCCL
between cards, gloo on the CPU or between ranks sharing a card), and with
no group one process holds every node and the stacked bank simply lands on
the device.

Embeddings come from a deterministic hashed-feature embedder by default —
dependency-free, identical across nodes without coordination, and bitwise
the JAX package's — or any callable mapping text → [D] vector.
"""

from __future__ import annotations

import functools
import hashlib
import re

import numpy as np
import torch

_TOKEN_RX = re.compile(r"[a-z0-9]+")


def hash_embed(text: str, dim: int = 256) -> np.ndarray:
    """Deterministic hashed bag-of-words embedding, L2-normalized.

    Each token hashes to a (bucket, sign) pair — the classic feature-hashing
    trick — so any two nodes embed the same text identically with no shared
    vocabulary or model weights.
    """
    vec = np.zeros(dim, dtype=np.float32)
    for tok in _TOKEN_RX.findall(text.lower()):
        h = hashlib.blake2b(tok.encode(), digest_size=8).digest()
        bucket = int.from_bytes(h[:4], "little") % dim
        sign = 1.0 if h[4] & 1 else -1.0
        vec[bucket] += sign
    norm = float(np.linalg.norm(vec))
    return vec / norm if norm > 0 else vec


def exchange_banks(all_banks, group=None, device="cuda") -> torch.Tensor:
    """All-gather every node's bank onto ``device``.

    ``all_banks`` stacks the per-node banks, ``[n_nodes, N, D]``. With no
    ``group`` one process holds every node: the stacked bank moves to the
    device as it is. With a ``torch.distributed`` process group, rank r
    contributes its contiguous share of the nodes (n_nodes must be a
    multiple of the group size; each rank may host several nodes) and one
    ``all_gather`` assembles the whole bank on every rank, in rank order.
    Returns ``[1, n_nodes, N, D]`` on ``device``, the reference's leading
    axis; read row 0.
    """
    banks = torch.as_tensor(np.asarray(all_banks), device=device)
    if group is None:
        return banks[None]
    import torch.distributed as dist

    n = dist.get_world_size(group)
    if banks.shape[0] % n:
        raise ValueError(
            f"num_nodes {banks.shape[0]} must be a multiple of "
            f"the group size {n}"
        )
    share = banks.shape[0] // n
    rank = dist.get_rank(group)
    local = banks[rank * share:(rank + 1) * share].contiguous()
    # one part per rank, in rank order (gloo gathers device tensors this
    # way; its all_gather_into_tensor may refuse them)
    parts = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts)[None]


class EmbeddingFederation:
    """Per-node embedding bank + pod-wide exchange + similarity recall.

    One instance per federation node. ``sync`` performs the all-gather
    across all nodes' banks; ``search`` runs cosine top-k over the latest
    federation-wide view.
    """

    def __init__(
        self,
        node_index: int,
        num_nodes: int,
        bank_size: int = 1024,
        dim: int = 256,
        embed_fn=None,
    ):
        if not 0 <= node_index < num_nodes:
            raise ValueError(f"node_index {node_index} not in [0, {num_nodes})")
        self.node_index = node_index
        self.num_nodes = num_nodes
        self.bank_size = bank_size
        self.dim = dim
        self.embed_fn = embed_fn or functools.partial(hash_embed, dim=dim)
        self._bank = np.zeros((bank_size, dim), dtype=np.float32)
        self._ids: list[str | None] = [None] * bank_size
        self._next = 0
        self._global: np.ndarray | None = None  # [n_nodes, bank, D]
        self._global_ids: list[list[str | None]] | None = None

    # ------------------------------------------------------------ local ops

    def add(self, memory_id: str, text: str) -> int:
        """Embed + store a memory locally (ring buffer). Returns the slot."""
        slot = self._next % self.bank_size
        self._bank[slot] = self.embed_fn(text)
        self._ids[slot] = memory_id
        self._next += 1
        return slot

    @property
    def local_bank(self) -> np.ndarray:
        return self._bank

    # ------------------------------------------------------------- exchange

    def sync(self, all_banks: np.ndarray, group=None, device="cuda"):
        """Exchange banks through ``device`` (``exchange_banks``).
        ``all_banks`` is the stacked [n_nodes, bank, D] array (each node
        slot filled by its owner; with a group each rank's share is read
        from it). Stores the gathered federation-wide bank on the host."""
        out = exchange_banks(all_banks, group=group, device=device)
        self._global = out[0].cpu().numpy()
        return self._global

    def install_global(self, banks: np.ndarray, ids: list[list[str | None]]):
        """Adopt a gathered view (banks [n_nodes, bank, D]) + id tables."""
        self._global = np.asarray(banks)
        self._global_ids = ids

    # --------------------------------------------------------------- search

    def search(self, text: str, top_k: int = 5) -> list[dict]:
        """Cosine top-k over the federation-wide bank (falls back to the
        local bank if no sync has happened yet)."""
        query = self.embed_fn(text)
        if self._global is not None:
            banks = self._global.reshape(-1, self.dim)
            n_nodes = self._global.shape[0]
        else:
            banks = self._bank
            n_nodes = 1
        scores = banks @ query
        order = np.argsort(-scores)[: top_k * 4]
        out = []
        for flat_idx in order:
            node, slot = divmod(int(flat_idx), self.bank_size)
            if n_nodes == 1:
                node, slot = self.node_index, int(flat_idx)
            mem_id = None
            if self._global_ids is not None and node < len(self._global_ids):
                mem_id = self._global_ids[node][slot]
            elif node == self.node_index:
                mem_id = self._ids[slot]
            score = float(scores[flat_idx])
            if score <= 0 and not mem_id:
                continue
            out.append(
                {"node": node, "slot": slot, "id": mem_id, "score": score}
            )
            if len(out) >= top_k:
                break
        return out
