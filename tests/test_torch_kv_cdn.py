"""Content-addressed prefixes (the KV CDN's scheduler side) in the port, on
the ``tiny`` config (two layers, fp32) with the JAX package's weights.

The single-replica cases of tests/test_kv_cdn.py, on the port:
- ``parse_size`` and ``TierConfig.from_env`` read the JAX package's
  variables and sizes;
- content keys: equal content gives equal keys, the model and the pool
  geometry salt the chain, a changed page splits it there;
- the store: ``put_if_absent`` builds once, a pin rides out RAM pressure
  and ``unpin`` releases it, ``drop`` ignores pins, ``advertised`` lists
  ``cas:`` keys hottest first; an FKV1 header with unknown fields reads;
- eight sessions over one prompt store one copy, and a live session pins
  it;
- a prefix fetched from the tier by content hash admits with only the
  suffix prefilled and gives the local prefill's stream (greedy and
  seeded); a fetch fault degrades to prefill with the same stream;
- the ``/kv/prefix`` routes: list, probe, get by hash, push to a peer
  (dedup is success) that then admits through it; garbage 400/422, an
  unknown hash 404, a fault 500 JSON.

Across packages: ``pool_fingerprint``, ``config_fingerprint`` and the
``cas:`` keys are equal for one model name at fp32, bf16 and int8, and the
prefix hit's stream equals the JAX package's paged stream.
"""

from __future__ import annotations

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import base64
import json
import os
import struct
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fei_tpu.engine.engine import GenerationConfig as JaxGen
from fei_tpu.engine.engine import InferenceEngine as JaxEngine
from fei_tpu.engine.paged_cache import PagedKVCache as JaxPagedKVCache
from fei_tpu.kv import content as jax_content
from fei_tpu.kv import pagesio as jax_pagesio
from fei_tpu.models.configs import get_model_config as jax_model_config
from fei_tpu_torch.engine.engine import GenerationConfig, InferenceEngine
from fei_tpu_torch.engine.faults import FAULTS
from fei_tpu_torch.engine.paged_cache import PagedKVCache
from fei_tpu_torch.kv import pagesio
from fei_tpu_torch.kv.content import CAS_PREFIX, content_keys, content_salt, is_cas_key
from fei_tpu_torch.kv.tier import (
    KVTierStore,
    PageEntry,
    TierConfig,
    pack_entry,
    parse_size,
    unpack_entry,
)
from fei_tpu_torch.models.configs import get_model_config
from fei_tpu_torch.models.convert import params_from_jax
from fei_tpu_torch.utils.metrics import METRICS

MAX_SEQ = 256
PROMPT = list(range(11, 29))  # 18 tokens: publish boundary 4 pages of 4
GREEDY = dict(max_new_tokens=24, ignore_eos=True)
SEEDED = dict(GREEDY, temperature=1.0, top_k=40, seed=123)


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.disarm()
    yield
    FAULTS.disarm()


def _counter(name: str) -> float:
    return METRICS.snapshot()["counters"].get(name, 0)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's tiny fp32 weights and its paged streams of PROMPT
    (local prefill, roomy pool), greedy and seeded."""
    dense = JaxEngine.from_config("tiny", dtype=jnp.float32, max_seq_len=MAX_SEQ, num_layers=2)
    eng = JaxEngine(dense.cfg, dense.params, dense.tokenizer, max_seq_len=MAX_SEQ,
                    dtype=jnp.float32, paged=True, page_size=4, num_pages=64,
                    batch_size=2, prefix_cache=True)
    eng.scheduler.prefill_chunk = 8
    try:
        greedy = list(eng.scheduler.stream(PROMPT, JaxGen(**GREEDY)))
        seeded = list(eng.scheduler.stream(PROMPT, JaxGen(**SEEDED)))
    finally:
        eng.close()
    return dense, greedy, seeded


@pytest.fixture(scope="module")
def params(jax_ref):
    return params_from_jax(jax.tree.map(np.asarray, jax_ref[0].params))


def _cdn_engine(params, mode: str = "ram", **kw) -> InferenceEngine:
    """A roomy port paged engine with the tier (and so the content-
    addressed prefixes, on by default) set by the environment."""
    old = os.environ.get("FEI_TPU_KV_TIER")
    os.environ["FEI_TPU_KV_TIER"] = mode
    try:
        eng = InferenceEngine.from_config(
            "tiny", params=params, paged=True, page_size=4, num_pages=64,
            batch_size=kw.pop("batch_size", 2), prefix_cache=True, device="cpu",
            dtype=torch.float32, max_seq_len=MAX_SEQ, num_layers=2, **kw)
    finally:
        if old is None:
            os.environ.pop("FEI_TPU_KV_TIER", None)
        else:
            os.environ["FEI_TPU_KV_TIER"] = old
    eng.scheduler.prefill_chunk = 8
    return eng


def _publish_key(eng) -> str:
    """The content hash a served PROMPT published under: the longest probe
    candidate (the strictly-shorter page boundary)."""
    return eng.scheduler.content_prefix_status(PROMPT)["hashes"][0]


# -- sizes and content keys --------------------------------------------------------


@pytest.mark.parametrize("text,want", [
    ("268435456", 268435456), ("256MiB", 256 << 20), ("256mb", 256 << 20),
    ("4g", 4 << 30), ("1.5 G", int(1.5 * (1 << 30))), ("512kb", 512 << 10),
    ("  2m  ", 2 << 20), ("1t", 1 << 40),
])
def test_parse_size_accepts_human_sizes(text, want):
    assert parse_size(text, 0) == want


@pytest.mark.parametrize("text", ["banana", "12qb", "g4", "-1m", "", None])
def test_parse_size_garbage_falls_back_to_default(text):
    assert parse_size(text, 777) == 777


def test_from_env_parses_budgets(monkeypatch):
    monkeypatch.setenv("FEI_TPU_KV_TIER", "ram")
    monkeypatch.setenv("FEI_TPU_KV_RAM_BYTES", "4g")
    monkeypatch.setenv("FEI_TPU_KV_DISK_BYTES", "not a size")
    monkeypatch.setenv("FEI_TPU_KV_DISK_DIR", "/tier")
    cfg = TierConfig.from_env()
    assert (cfg.mode, cfg.ram_bytes, cfg.disk_bytes, cfg.disk_dir) == (
        "ram", 4 << 30, 1 << 30, "/tier")
    monkeypatch.setenv("FEI_TPU_KV_TIER", "sideways")
    assert not TierConfig.from_env().enabled


IDS = list(range(100, 116))  # 4 pages of 4


def _keys(ids=None, model="tiny", fp=None):
    return content_keys(ids or IDS, 4, 4, content_salt(model, fp or {"page_size": 4}))


def test_same_content_same_key():
    assert _keys() == _keys() and all(is_cas_key(k) for k in _keys())


def test_model_and_geometry_change_the_salt():
    base = _keys()
    assert not set(_keys(model="other")) & set(base)
    assert not set(_keys(fp={"page_size": 4, "kv_heads": 4})) & set(base)


def test_chain_splits_at_the_divergent_page():
    ids = list(IDS)
    ids[6] += 1  # a token inside page 2
    base, got = _keys(), _keys(ids=ids)
    assert got[0] == base[0] and all(a != b for a, b in zip(got[1:], base[1:]))


def test_is_cas_key():
    assert is_cas_key(CAS_PREFIX + "ab" * 32)
    assert not is_cas_key("session-rid-7") and not is_cas_key(None)


@pytest.mark.parametrize("dtype,kv_quant", [
    ("float32", None), ("bfloat16", None), ("bfloat16", "int8")])
def test_fingerprints_and_keys_equal_across_packages(dtype, kv_quant):
    """One model name, one pool geometry: the port's pool and config
    fingerprints are the JAX package's, so are the content keys."""
    cfg, jcfg = get_model_config("tiny"), jax_model_config("tiny")
    pool = PagedKVCache.create(cfg, 8, 2, 4, page_size=4, dtype=getattr(torch, dtype),
                               kv_quant=kv_quant)
    jpool = JaxPagedKVCache.create(jcfg, num_pages=8, batch=2, max_pages_per_seq=4,
                                   page_size=4, dtype=getattr(jnp, dtype), kv_quant=kv_quant)
    fp = pagesio.pool_fingerprint(pool)
    assert fp == jax_pagesio.pool_fingerprint(jpool)
    assert pagesio.config_fingerprint(cfg, 4, getattr(torch, dtype), kv_quant) == fp
    assert fp == jax_pagesio.config_fingerprint(jcfg, 4, getattr(jnp, dtype), kv_quant)
    ids = list(range(3, 40))
    assert content_keys(ids, 9, 4, content_salt("tiny", fp)) == jax_content.content_keys(
        ids, 9, 4, jax_content.content_salt("tiny", jax_pagesio.pool_fingerprint(jpool)))


# -- the store: dedup, pins, advertising -----------------------------------------------


def _entry(key: str, n_pages: int = 3, seed: int = 0) -> PageEntry:
    rng = np.random.default_rng(seed)
    arrays = {
        "k_pages": rng.standard_normal((n_pages, 2, 4, 8)).astype(np.float32),
        "v_pages": rng.standard_normal((n_pages, 2, 4, 8)).astype(np.float32),
    }
    return PageEntry(key=key, n_tokens=n_pages * 4, page_size=4,
                     fingerprint={"page_size": 4}, arrays=arrays)


def _same_arrays(a: PageEntry, b: PageEntry) -> bool:
    return set(a.arrays) == set(b.arrays) and all(
        np.array_equal(a.arrays[k], b.arrays[k]) for k in a.arrays)


def test_unknown_header_fields_are_ignored():
    e = _entry("cas:" + "ab" * 32)
    blob = pack_entry(e)
    (hlen,) = struct.unpack("<I", blob[4:8])
    header = json.loads(blob[8:8 + hlen])
    header["compression"] = "none"
    header["replica_hints"] = {"hot": True}
    raw = json.dumps(header, sort_keys=True).encode("utf-8")
    got, _ = unpack_entry(blob[:4] + struct.pack("<I", len(raw)) + raw + blob[8 + hlen:])
    assert got.key == e.key and _same_arrays(e, got)


def test_put_if_absent_builds_once():
    store = KVTierStore(TierConfig(mode="ram", ram_bytes=1 << 30))
    built = []

    def make():
        built.append(1)
        return _entry("cas:" + "01" * 32)

    assert store.put_if_absent("cas:" + "01" * 32, make) is True
    assert store.put_if_absent("cas:" + "01" * 32, make) is False
    assert len(built) == 1
    assert (store.stats()["cas_stores"], store.stats()["cas_dedup_hits"]) == (1, 1)


def test_pin_survives_ram_pressure_unpin_releases():
    small = _entry("cas:" + "aa" * 32, n_pages=1, seed=1)
    store = KVTierStore(TierConfig(mode="ram", ram_bytes=small.nbytes + 16))
    store.put_if_absent(small.key, small)
    store.pin(small.key)
    for i in range(3):
        store.put(f"sess-{i}", _entry(f"sess-{i}", n_pages=1, seed=2 + i))
    assert store.contains(small.key) and _same_arrays(small, store.fetch(small.key))
    store.unpin(small.key)
    assert store.pin_count(small.key) == 0
    store.fetch("sess-2")
    store.put("sess-9", _entry("sess-9", n_pages=1, seed=9))
    assert not store.contains(small.key)


def test_drop_ignores_pins():
    e = _entry("cas:" + "bb" * 32)
    store = KVTierStore(TierConfig(mode="ram", ram_bytes=1 << 30))
    store.put_if_absent(e.key, e)
    store.pin(e.key)
    store.drop(e.key)
    assert not store.contains(e.key)


def test_advertised_lists_cas_keys_hottest_first():
    store = KVTierStore(TierConfig(mode="ram", ram_bytes=1 << 30))
    k1, k2 = "cas:" + "0a" * 32, "cas:" + "0b" * 32
    store.put(k1, _entry(k1, seed=1))
    store.put("sess-x", _entry("sess-x", seed=2))  # never advertised
    store.put(k2, _entry(k2, seed=3))
    assert store.advertised() == [k2, k1]
    store.fetch(k1)
    assert store.advertised() == [k1, k2] and store.advertised(limit=1) == [k1]


def _wait_unpinned(tier, key) -> int:
    deadline = time.monotonic() + 5.0
    while tier.pin_count(key) and time.monotonic() < deadline:
        time.sleep(0.01)
    return tier.pin_count(key)


def test_eight_sessions_pin_one_tier_copy(params):
    eng = _cdn_engine(params, batch_size=4)
    try:
        c0 = METRICS.snapshot()["counters"]
        out: list = [None] * 8

        def worker(i: int) -> None:
            out[i] = list(eng.scheduler.stream(PROMPT, GenerationConfig(**GREEDY)))

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert all(o is not None and len(o) == 24 for o in out)
        c1 = METRICS.snapshot()["counters"]
        assert c1.get("kv.cas_stores", 0) - c0.get("kv.cas_stores", 0) == 1
        assert c1.get("kv.cas_dedup_hits", 0) - c0.get("kv.cas_dedup_hits", 0) == 7
        key = _publish_key(eng)
        assert eng.scheduler._kv_tier.contains(key)
        assert _wait_unpinned(eng.scheduler._kv_tier, key) == 0
    finally:
        eng.close()


def test_live_session_holds_a_pin(params):
    eng = _cdn_engine(params)
    try:
        g = eng.scheduler.stream(PROMPT, GenerationConfig(**GREEDY))
        next(g)  # admitted: published and pinned
        key = _publish_key(eng)
        tier = eng.scheduler._kv_tier
        assert tier.contains(key) and tier.pin_count(key) == 1
        list(g)
        assert _wait_unpinned(tier, key) == 0
    finally:
        eng.close()


# -- a fetched prefix ---------------------------------------------------------------


@pytest.fixture(scope="module")
def published_blob(params):
    """(key, wire blob) of PROMPT's prefix as a serving replica publishes it."""
    eng = _cdn_engine(params)
    try:
        assert list(eng.scheduler.stream(PROMPT, GenerationConfig(**GREEDY)))
        key = _publish_key(eng)
        entry = eng.scheduler._kv_tier.fetch(key)
        assert entry is not None and entry.n_pages == 4
        return key, pack_entry(entry)
    finally:
        eng.close()


@pytest.mark.parametrize("seeded", [False, True], ids=["greedy", "seeded"])
def test_fetched_prefix_matches_local_prefill(params, jax_ref, published_blob, seeded):
    key, blob = published_blob
    eng = _cdn_engine(params)  # a fresh replica: cold prefix cache
    try:
        entry, _ = unpack_entry(blob)
        assert eng.scheduler._kv_tier.put_if_absent(key, entry)
        c0 = METRICS.snapshot()["counters"]
        got = list(eng.scheduler.stream(PROMPT, GenerationConfig(**(SEEDED if seeded else GREEDY))))
        assert got == jax_ref[2 if seeded else 1]
        c1 = METRICS.snapshot()["counters"]

        def delta(k: str) -> float:
            return c1.get(k, 0) - c0.get(k, 0)

        assert delta("kv.prefix_hits_tier") == 1
        assert delta("kv.prefix_tokens_saved") == 16  # 4 pages of 4
        assert delta("scheduler.prefill_tokens") == len(PROMPT) - 16  # the suffix only
        assert delta("kv.fetch_fallbacks") == 0
    finally:
        eng.close()


def test_fetch_fault_degrades_to_prefill(params, jax_ref, published_blob):
    key, blob = published_blob
    eng = _cdn_engine(params)
    try:
        eng.scheduler._kv_tier.put_if_absent(key, unpack_entry(blob)[0])
        FAULTS.arm("kv.fetch", "io", count=99)
        c0, f0 = _counter("scheduler.prefill_tokens"), _counter("kv.fetch_fallbacks")
        assert list(eng.scheduler.stream(PROMPT, GenerationConfig(**GREEDY))) == jax_ref[1]
        assert FAULTS.fired("kv.fetch") > 0
        assert _counter("kv.fetch_fallbacks") - f0 > 0
        assert _counter("scheduler.prefill_tokens") - c0 == len(PROMPT)
    finally:
        eng.close()


def test_cdn_off_keeps_only_spill(params, monkeypatch):
    monkeypatch.setenv("FEI_TPU_KV_CDN", "0")
    eng = _cdn_engine(params)
    try:
        c0 = _counter("kv.cas_stores")
        assert list(eng.scheduler.stream(PROMPT, GenerationConfig(**GREEDY)))
        assert _counter("kv.cas_stores") == c0
        assert eng.scheduler.content_prefix_status(PROMPT) == {"hashes": [], "have": []}
    finally:
        eng.close()


# -- the /kv/prefix routes ------------------------------------------------------------

_CHAT = {"messages": [{"role": "user", "content": "kv cdn prefix round trip"}],
         "max_tokens": 4, "temperature": 0}


def _req(api, method: str, path: str, body: dict | None = None):
    return api.handle(method, path, dict(body or {}), {})[:2]


@pytest.fixture(scope="module")
def replicas(params):
    from fei_tpu_torch.agent.providers import TorchLocalProvider
    from fei_tpu_torch.ui.server import ServeAPI

    apis = [ServeAPI(TorchLocalProvider(engine=_cdn_engine(params)), model_name=f"cdn-{t}")
            for t in "ab"]
    yield apis
    for api in apis:
        api.provider.engine.close()


def test_prefix_routes_publish_probe_get_and_push(params, replicas):
    from fei_tpu_torch.agent.providers import TorchLocalProvider
    from fei_tpu_torch.ui.server import ServeAPI

    a, b = replicas
    for api in (a, b):
        assert _req(api, "GET", "/kv/prefix") == (200, {"object": "kv.prefix.list",
                                                        "hashes": []})
    status, probe = _req(a, "POST", "/kv/prefix/probe", {"messages": _CHAT["messages"]})
    assert status == 200 and probe["hashes"] and probe["have"] == []
    assert _req(a, "POST", "/v1/chat/completions", _CHAT)[0] == 200
    status, listed = _req(a, "GET", "/kv/prefix")
    assert status == 200 and listed["hashes"] and all(is_cas_key(h) for h in listed["hashes"])
    status, probe = _req(a, "POST", "/kv/prefix/probe", {"messages": _CHAT["messages"]})
    assert status == 200 and probe["have"] and probe["have"][0] == listed["hashes"][0]
    h = probe["have"][0]
    status, got = _req(a, "GET", f"/kv/prefix/{h}")
    assert status == 200 and got["hash"] == h and got["blob"]
    status, pushed = _req(b, "POST", "/kv/prefix", {"hash": h, "blob": got["blob"]})
    assert status == 200 and pushed["stored"] is True
    status, pushed = _req(b, "POST", "/kv/prefix", {"hash": h, "blob": got["blob"]})
    assert status == 200 and pushed["stored"] is False  # dedup is success
    t0, s0 = _counter("kv.prefix_hits_tier"), _counter("kv.prefix_tokens_saved")
    status, payload = _req(b, "POST", "/v1/chat/completions", _CHAT)
    assert status == 200 and payload["choices"]
    assert _counter("kv.prefix_hits_tier") - t0 == 1
    assert _counter("kv.prefix_tokens_saved") - s0 > 0
    # a replica without the tier advertises nothing and refuses a push
    plain = ServeAPI(TorchLocalProvider(engine=_cdn_engine(params, "off")))
    try:
        assert _req(plain, "GET", "/kv/prefix")[1]["hashes"] == []
        assert _req(plain, "POST", "/kv/prefix", {"blob": got["blob"]})[0] == 501
        assert _req(plain, "GET", f"/kv/prefix/{h}")[0] == 404
    finally:
        plain.provider.engine.close()


def test_push_rejects_garbage(replicas):
    _, b = replicas
    assert _req(b, "POST", "/kv/prefix", {"blob": "not base64!!"})[0] == 400
    junk = base64.b64encode(b"FKV1 but not really").decode()
    assert _req(b, "POST", "/kv/prefix", {"blob": junk})[0] == 422
    blob = pack_entry(_entry("cas:" + "cd" * 32))
    for cut in (6, len(blob) // 2, len(blob) - 3):
        status, _ = _req(b, "POST", "/kv/prefix",
                         {"blob": base64.b64encode(blob[:cut]).decode()})
        assert status == 422, f"truncation at {cut} was served"
    flipped = bytearray(blob)
    flipped[-5] ^= 0xFF
    assert _req(b, "POST", "/kv/prefix",
                {"blob": base64.b64encode(bytes(flipped)).decode()})[0] == 422
    assert _req(b, "POST", "/kv/prefix", {"hash": "cas:" + "00" * 32,
                                          "blob": base64.b64encode(blob).decode()})[0] == 422
    sess = base64.b64encode(pack_entry(_entry("sess-42"))).decode()
    assert _req(b, "POST", "/kv/prefix", {"blob": sess})[0] == 422
    # well formed, content-addressed, but another page size: 409 with the diff
    status, payload = _req(b, "POST", "/kv/prefix", {"blob": base64.b64encode(blob).decode()})
    assert status == 409 and payload["error"]["theirs"] == {"page_size": 4}


def test_get_unknown_hash_404s_and_fault_answers_json(replicas):
    a, _ = replicas
    assert _req(a, "GET", "/kv/prefix/cas:" + "ee" * 32)[0] == 404
    assert _req(a, "POST", "/v1/chat/completions", _CHAT)[0] == 200  # publishes
    h = _req(a, "GET", "/kv/prefix")[1]["hashes"][0]
    FAULTS.arm("kv.fetch", "io", count=1)
    status, payload = _req(a, "GET", f"/kv/prefix/{h}")
    assert status == 500 and "error" in payload
