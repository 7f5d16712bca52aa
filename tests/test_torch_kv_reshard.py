"""The KV pool geometry in the port: the invariant fingerprint against the
shard layout, canonical host arrays, gather/scatter and the 409-vs-422
ladder, against the JAX package.

The single-chip cases of tests/test_reshard.py, on the port:
- ``shard_layout`` of one device is ``tp: 1`` over the whole head extent;
- ``canonicalize_arrays`` is the identity for every natural layout and
  for a blob with no layout, reorders a permuted slice order bitwise
  (bf16 pages and int8 pages with scales) and refuses partial or
  overlapping head coverage with ``KVGeometryError``;
- ``check_fingerprint`` raises the structured ``{ours, theirs}`` diff; the
  FKV1 header round-trips the layout and reads a blob without one as
  None; ``config_fingerprint`` equals the built pool's;
- over ``/kv/import``: another page size is 409 with the diff, a corrupt
  blob 422, and ``/health`` shows both geometry halves.

Across packages: ``gather_pages`` of the port equals the JAX package's on
the same pool contents (fp32, bf16, int8 with scales), ``scatter_pages``
restores them bitwise, ``canonicalize_arrays`` agrees, and a blob written
with a tp2 layout (its head slices out of order) imports into the port's
single pool as the canonical pages and serves a prefix hit.
"""

from __future__ import annotations

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import base64
import json
import struct

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fei_tpu.engine.engine import GenerationConfig as JaxGen
from fei_tpu.engine.engine import InferenceEngine as JaxEngine
from fei_tpu.engine.paged_cache import PagedKVCache as JaxPagedKVCache
from fei_tpu.kv import pagesio as jax_pagesio
from fei_tpu.kv import tier as jax_tier
from fei_tpu.models.configs import get_model_config as jax_model_config
from fei_tpu_torch.engine.engine import GenerationConfig, InferenceEngine
from fei_tpu_torch.engine.paged_cache import PagedKVCache
from fei_tpu_torch.kv.pagesio import (
    canonicalize_arrays,
    check_fingerprint,
    config_fingerprint,
    gather_pages,
    pool_fingerprint,
    scatter_pages,
    shard_layout,
)
from fei_tpu_torch.kv.tier import BF16_WORDS, PageEntry, pack_entry, unpack_entry
from fei_tpu_torch.models.configs import get_model_config
from fei_tpu_torch.models.convert import params_from_jax
from fei_tpu_torch.utils.errors import KVGeometryError, KVTierError
from fei_tpu_torch.utils.metrics import METRICS

KV_HEADS = 4
MAX_SEQ = 256
GREEDY = dict(max_new_tokens=8, ignore_eos=True)


def _counter(name: str) -> float:
    return METRICS.snapshot()["counters"].get(name, 0)


def _arrays(n: int = 3, L: int = 2, K: int = KV_HEADS, ps: int = 4, D: int = 8,
            quantized: bool = False, seed: int = 0) -> dict:
    """Canonical host arrays in the gather shapes: pages [n, L, K, ps, D]
    (bf16 words, or int8 with fp32 scales [n, L, K, 1, ps])."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, L, K, ps, D)).astype(np.float32)
    if not quantized:
        w = x.astype(ml_dtypes.bfloat16).view(BF16_WORDS)
        return {"k_pages": w, "v_pages": w[::-1].copy()}
    q = np.clip(np.round(x * 40), -127, 127).astype(np.int8)
    s = rng.uniform(0.01, 1.0, (n, L, K, 1, ps)).astype(np.float32)
    return {"k_pages": q, "v_pages": -q, "k_scales": s, "v_scales": s + 1}


def _permute_heads(arrays: dict, order: list[int]) -> dict:
    return {k: np.ascontiguousarray(np.take(v, order, axis=2)) for k, v in arrays.items()}


def _bitwise_equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


def test_single_chip_layout():
    assert shard_layout(KV_HEADS) == {"tp": 1, "head_slices": [[0, KV_HEADS]]}
    assert shard_layout(KV_HEADS) == jax_pagesio.shard_layout(KV_HEADS, None)


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("quantized", [False, True])
def test_natural_layouts_are_identity(tp, quantized):
    arrays = _arrays(quantized=quantized, seed=tp)
    got = canonicalize_arrays(arrays, shard_layout(KV_HEADS, tp), KV_HEADS)
    assert _bitwise_equal(got, arrays)


@pytest.mark.parametrize("quantized", [False, True])
def test_missing_layout_is_canonical(quantized):
    arrays = _arrays(quantized=quantized)
    assert canonicalize_arrays(arrays, None, KV_HEADS) is arrays
    assert canonicalize_arrays(arrays, {}, KV_HEADS) is arrays


@pytest.mark.parametrize("quantized", [False, True])
def test_permuted_slice_order_reorders_bitwise(quantized):
    canon = _arrays(quantized=quantized, seed=7)
    permuted = _permute_heads(canon, [2, 3, 0, 1])
    layout = {"tp": 2, "head_slices": [[2, 4], [0, 2]]}
    got = canonicalize_arrays(permuted, layout, KV_HEADS)
    assert _bitwise_equal(got, canon)
    jgot = jax_pagesio.canonicalize_arrays(permuted, layout, KV_HEADS)
    assert _bitwise_equal(got, jgot)


@pytest.mark.parametrize("slices", [[[0, 2]], [[0, 3], [1, 4]]], ids=["partial", "overlap"])
def test_bad_coverage_refuses(slices):
    with pytest.raises(KVGeometryError):
        canonicalize_arrays(_arrays(), {"tp": 2, "head_slices": slices}, KV_HEADS)


_FP = {"layers": 2, "kv_heads": 4, "page_size": 4, "head_dim": 8,
       "dtype": "bfloat16", "quantized": False}


def test_mismatch_raises_structured_diff():
    check_fingerprint(dict(_FP), dict(_FP))
    theirs = dict(_FP, page_size=64, dtype="float32")
    with pytest.raises(KVGeometryError) as exc:
        check_fingerprint(dict(_FP), theirs, what="test blob")
    assert exc.value.ours == _FP and exc.value.theirs == theirs
    assert "page_size" in str(exc.value) and "dtype" in str(exc.value)
    assert isinstance(exc.value, KVTierError)


def test_fkv1_round_trips_layout_and_reads_none_without_it():
    lay = {"tp": 2, "head_slices": [[0, 2], [2, 4]]}
    e = PageEntry(key="sess-1", n_tokens=12, page_size=4, fingerprint=dict(_FP),
                  arrays=_arrays(), layout=lay)
    got, _ = unpack_entry(pack_entry(e))
    assert got.layout == lay and got.fingerprint == _FP
    blob = pack_entry(PageEntry(key="sess-2", n_tokens=12, page_size=4,
                                fingerprint=dict(_FP), arrays=_arrays()))
    (hlen,) = struct.unpack("<I", blob[4:8])
    assert "layout" not in json.loads(blob[8:8 + hlen])
    assert unpack_entry(blob)[0].layout is None


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_config_fingerprint_matches_built_pool(kv_quant):
    cfg = get_model_config("tiny")
    pool = PagedKVCache.create(cfg, 8, 2, 4, page_size=4, dtype=torch.bfloat16,
                               kv_quant=kv_quant)
    assert config_fingerprint(cfg, 4, torch.bfloat16, kv_quant) == pool_fingerprint(pool)


# -- gather and scatter against the JAX package -------------------------------------


def _pools(kind: str, seed: int = 0):
    """(port pool, JAX pool) of the tiny config with the same random
    contents: 9 pages of 4 slots."""
    cfg, jcfg = get_model_config("tiny"), jax_model_config("tiny")
    dtype = {"fp32": "float32", "bf16": "bfloat16", "int8": "bfloat16"}[kind]
    kv_quant = "int8" if kind == "int8" else None
    pool = PagedKVCache.create(cfg, 9, 2, 4, page_size=4, dtype=getattr(torch, dtype),
                               kv_quant=kv_quant)
    jpool = JaxPagedKVCache.create(jcfg, num_pages=9, batch=2, max_pages_per_seq=4,
                                   page_size=4, dtype=getattr(jnp, dtype), kv_quant=kv_quant)
    rng = np.random.default_rng(seed)
    fill = {}
    for name in ("k_pages", "v_pages", "k_scales", "v_scales"):
        t = getattr(pool, name)
        if t is None:
            continue
        x = rng.standard_normal(tuple(t.shape)).astype(np.float32)
        if t.dtype == torch.int8:
            x = np.clip(np.round(x * 40), -127, 127).astype(np.int8)
        elif t.dtype == torch.bfloat16:
            x = x.astype(ml_dtypes.bfloat16)
        fill[name] = x
        src = torch.from_numpy(x.view(np.int16)).view(torch.bfloat16) \
            if x.dtype == ml_dtypes.bfloat16 else torch.from_numpy(x)
        t.copy_(src)
    jpool = jpool._replace(**{k: jnp.asarray(v) for k, v in fill.items()})
    return pool, jpool


@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
def test_gather_equals_the_jax_gather_and_scatter_restores(kind):
    pool, jpool = _pools(kind)
    pages = [5, 2, 7]
    got = gather_pages(pool, pages)
    want = jax_pagesio.gather_pages(jpool, pages)
    assert set(got) == set(want)
    for name, a in want.items():
        assert got[name].shape == a.shape and got[name].tobytes() == a.tobytes()
    if kind == "bf16":
        assert got["k_pages"].dtype == BF16_WORDS
    # scatter into other page ids of a second pool restores the bytes
    other, _ = _pools(kind, seed=1)
    scatter_pages(other, [1, 8, 3], got)
    again = gather_pages(other, [1, 8, 3])
    assert all(again[k].tobytes() == got[k].tobytes() for k in got)
    # the JAX package's arrays (ml_dtypes bf16) scatter bitwise too
    scatter_pages(other, [4, 6, 2], want)
    assert all(gather_pages(other, [4, 6, 2])[k].tobytes() == want[k].tobytes() for k in want)


# -- the /kv/import ladder and a tp2 blob ---------------------------------------------


@pytest.fixture(scope="module")
def jax_ref():
    dense = JaxEngine.from_config("tiny", dtype=jnp.float32, max_seq_len=MAX_SEQ, num_layers=2)
    return dense, params_from_jax(jax.tree.map(np.asarray, dense.params))


def _api(params, page_size: int = 4):
    from fei_tpu_torch.agent.providers import TorchLocalProvider
    from fei_tpu_torch.ui.server import ServeAPI

    eng = InferenceEngine.from_config(
        "tiny", params=params, paged=True, page_size=page_size, num_pages=64, batch_size=2,
        prefix_cache=True, device="cpu", dtype=torch.float32, max_seq_len=MAX_SEQ, num_layers=2)
    eng.scheduler.prefill_chunk = 8
    return ServeAPI(TorchLocalProvider(engine=eng), model_name="reshard")


_CHAT = {"messages": [{"role": "user", "content": "reshard error ladder"}],
         "max_tokens": 4, "temperature": 0}


def _req(api, method: str, path: str, body: dict | None = None):
    return api.handle(method, path, dict(body or {}), {})[:2]


def test_invariant_mismatch_is_409_with_diff(jax_ref):
    a, b = _api(jax_ref[1], 4), _api(jax_ref[1], 8)
    try:
        status, health = _req(a, "GET", "/health")
        assert status == 200 and health["kv_fingerprint"]["page_size"] == 4
        assert health["kv_fingerprint"]["dtype"] == "float32"
        K = health["kv_fingerprint"]["kv_heads"]
        assert health["kv_layout"] == {"tp": 1, "head_slices": [[0, K]]}
        assert _req(a, "POST", "/v1/chat/completions", _CHAT)[0] == 200
        # the pool exists now: /health reads it, and it is unchanged
        assert _req(a, "GET", "/health")[1]["kv_fingerprint"] == health["kv_fingerprint"]
        status, exported = _req(a, "POST", "/kv/export", {"messages": _CHAT["messages"]})
        assert status == 200
        status, payload = _req(b, "POST", "/kv/import", {"blob": exported["blob"]})
        assert status == 409, payload
        assert payload["error"]["ours"]["page_size"] == 8
        assert payload["error"]["theirs"]["page_size"] == 4
        raw = bytearray(base64.b64decode(exported["blob"]))
        raw[-5] ^= 0xFF
        status, _ = _req(a, "POST", "/kv/import", {"blob": base64.b64encode(bytes(raw)).decode()})
        assert status == 422
    finally:
        a.provider.engine.close()
        b.provider.engine.close()


def test_health_has_no_geometry_for_a_dense_engine(jax_ref):
    from fei_tpu_torch.agent.providers import TorchLocalProvider
    from fei_tpu_torch.ui.server import ServeAPI

    eng = InferenceEngine.from_config("tiny", params=jax_ref[1], device="cpu",
                                      dtype=torch.float32, max_seq_len=MAX_SEQ, num_layers=2)
    status, health = _req(ServeAPI(TorchLocalProvider(engine=eng)), "GET", "/health")
    assert status == 200 and "kv_fingerprint" not in health
    assert eng.kv_fingerprint() is None and eng.kv_layout() is None


def test_tp2_layout_blob_lands_in_the_single_pool(jax_ref):
    """A blob written under a tp2 layout whose head slices come out of
    order (as a shard-major writer may emit them) imports into the port's
    single pool as the canonical pages: ``kv.resharded_imports`` counts it,
    the pages gathered back are the canonical arrays, and the next
    admission is a prefix hit with the JAX package's stream."""
    dense, params = jax_ref
    prompt = list(range(40, 58))
    jeng = JaxEngine(dense.cfg, dense.params, dense.tokenizer, max_seq_len=MAX_SEQ,
                     dtype=jnp.float32, paged=True, page_size=4, num_pages=64, batch_size=2,
                     prefix_cache=True)
    jeng.scheduler.prefill_chunk = 8
    try:
        want = list(jeng.scheduler.stream(prompt, JaxGen(**GREEDY)))
        entry, extra = jax_tier.unpack_entry(jeng.scheduler.export_prefix(prompt))
    finally:
        jeng.close()
    K = entry.fingerprint["kv_heads"]
    half = K // 2
    order = list(range(half, K)) + list(range(half))
    tp2 = jax_tier.PageEntry(
        key="migrate", n_tokens=entry.n_tokens, page_size=entry.page_size,
        fingerprint=entry.fingerprint, arrays=_permute_heads(entry.arrays, order),
        layout={"tp": 2, "head_slices": [[half, K], [0, half]]})
    blob = jax_tier.pack_entry(tp2, extra=extra)
    eng = InferenceEngine.from_config(
        "tiny", params=params, paged=True, page_size=4, num_pages=64, batch_size=2,
        prefix_cache=True, device="cpu", dtype=torch.float32, max_seq_len=MAX_SEQ, num_layers=2)
    eng.scheduler.prefill_chunk = 8
    try:
        r0 = _counter("kv.resharded_imports")
        assert eng.scheduler.import_prefix(blob) == entry.n_pages
        assert _counter("kv.resharded_imports") - r0 == 1
        sched = eng.scheduler
        got = sched.run_ctl(lambda: gather_pages(sched._pool, sched._prefix.match(prompt)))
        assert all(got[k].tobytes() == np.asarray(v).tobytes() for k, v in entry.arrays.items())
        h0 = _counter("prefix.hits")
        assert list(sched.stream(prompt, GenerationConfig(**GREEDY))) == want
        assert _counter("prefix.hits") > h0
    finally:
        eng.close()


def test_import_without_room_refuses_without_preempting(jax_ref):
    """Import is best effort: with no page to spare it lands nothing."""
    from fei_tpu_torch.kv.tier import PageEntry as Entry

    params = jax_ref[1]
    eng = InferenceEngine.from_config(
        "tiny", params=params, paged=True, page_size=4, num_pages=3, batch_size=1,
        prefix_cache=True, device="cpu", dtype=torch.float32, max_seq_len=MAX_SEQ, num_layers=2)
    try:
        eng.scheduler._ensure_pool()
        fp = pool_fingerprint(eng.scheduler._pool)
        shape = tuple(eng.scheduler._pool.k_pages.shape)
        arr = np.zeros((4, shape[0]) + shape[2:], dtype=np.float32)
        blob = pack_entry(Entry(key="migrate", n_tokens=16, page_size=4, fingerprint=fp,
                                arrays={"k_pages": arr, "v_pages": arr}),
                          extra={"prompt_ids": list(range(16))})
        assert eng.scheduler.import_prefix(blob) == 0
        empty = pack_entry(Entry(key="migrate", n_tokens=0, page_size=4, fingerprint=fp,
                                 arrays={}), extra={})
        with pytest.raises(KVTierError):
            eng.scheduler.import_prefix(empty)
    finally:
        eng.close()
