"""Content-addressed keys for the KV CDN (a copy of fei_tpu/kv/content.py).

Spill and migration blobs are keyed by *session* (spill: request id,
migrate: the literal ``"migrate"``), so N sessions over the same prefix
would pin N copies. Prefix blobs are keyed by *content* instead: a chained
digest over (model id, ``pool_fingerprint`` geometry, token ids). Any
session, on any replica serving the same model and geometry, computes the
same key for the same tokens and so rendezvouses on the same bytes
(``KVTierStore.put_if_absent``).

The chain mirrors ``PrefixCache._boundary_keys``: key_i = sha256(key_{i-1}
|| page_i token bytes), SEEDED with a salt over the model id and the
pool's INVARIANT fingerprint (two models with a shared tokenizer never
exchange KV bytes). The page count and the tp shard layout are excluded,
so the port computes the JAX package's keys for the same model and pool.

Keys are strings with a ``cas:`` prefix so they coexist with request-id
spill keys in one ``KVTierStore`` and are recognizable in ``advertised()``
listings and ``/kv/prefix`` payloads.
"""

from __future__ import annotations

import hashlib
import json

import numpy as np

CAS_PREFIX = "cas:"


def content_salt(model_id: str, fingerprint: dict) -> bytes:
    """Chain seed binding content keys to (model, pool geometry)."""
    raw = json.dumps(
        {"model": str(model_id), "fingerprint": fingerprint}, sort_keys=True
    )
    return hashlib.sha256(raw.encode("utf-8")).digest()


def content_keys(
    prompt_ids, n_pages: int, page_size: int, salt: bytes
) -> list[str]:
    """Content key at every page boundary 1..n_pages, one O(n) pass.
    ``keys[m-1]`` names the first ``m`` pages of ``prompt_ids``."""
    ids = np.asarray(prompt_ids, dtype=np.int32)
    keys: list[str] = []
    prev = salt
    for i in range(n_pages):
        h = hashlib.sha256()
        h.update(prev)
        h.update(ids[i * page_size : (i + 1) * page_size].tobytes())
        prev = h.digest()
        keys.append(CAS_PREFIX + prev.hex())
    return keys


def is_cas_key(key) -> bool:
    return isinstance(key, str) and key.startswith(CAS_PREFIX)
