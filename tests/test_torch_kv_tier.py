"""The KV tier in the port: spill before preemption, streamed resume, the
RAM → disk store, the FKV1 wire format and migration, on the ``tiny``
config (two layers, fp32) with the JAX package's weights
(``params_from_jax``).

The B5 cases of tests/test_kv_tier.py, on the port:
- a preempted slot's pages spill to the host and its resume scatters them
  back: the tight pool's greedy and seeded streams (tier ``ram`` and
  ``disk``) equal the JAX package's UNINTERRUPTED paged streams (computed
  once per module) with ``scheduler.preempted_tokens_recomputed`` flat
  while ``kv.pages_restored`` climbs;
- past the RAM budget entries demote to checksummed files and come back
  bitwise; past the disk budget the coldest go; a corrupt file is typed;
- a fetch fault (io, corrupt, hang) or a spill fault falls back to replay
  and the streams stay equal; 5x oversubscription loses nothing;
- a prefix exports as a blob that a second engine imports (``/kv/export``
  → ``/kv/import``), with 404/400/422 for nothing cached, bad base64 and
  bad bytes.

Across packages: FKV1 blobs packed by either package unpack in the other
with equal bytes and manifests (bf16, int8 with scales, fp32), and the two
packers emit the same bytes; a JAX-exported migration blob imports into
the port with identical page bytes and serves a prefix hit, and the
reverse; a disk-tier file the JAX package wrote is fetched by the port;
and ``fei_tpu_torch.kv.tier`` round-trips a bf16 entry in a process where
``ml_dtypes`` cannot be imported.
"""

from __future__ import annotations

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import base64
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fei_tpu.engine.engine import GenerationConfig as JaxGen
from fei_tpu.engine.engine import InferenceEngine as JaxEngine
from fei_tpu.kv import pagesio as jax_pagesio
from fei_tpu.kv import tier as jax_tier
from fei_tpu_torch.engine.engine import GenerationConfig, InferenceEngine
from fei_tpu_torch.engine.faults import FAULTS
from fei_tpu_torch.kv import pagesio
from fei_tpu_torch.kv.tier import (
    BF16_WORDS,
    KVTierStore,
    PageEntry,
    TierConfig,
    pack_entry,
    unpack_entry,
)
from fei_tpu_torch.models.convert import params_from_jax
from fei_tpu_torch.utils.errors import KVTierError
from fei_tpu_torch.utils.metrics import METRICS

REPO = Path(__file__).resolve().parents[1]
MAX_SEQ = 256
PROMPTS = [list(range(11 + i, 29 + i)) for i in range(4)]
GREEDY = dict(max_new_tokens=24, ignore_eos=True)


def _seeded(i: int) -> dict:
    return dict(GREEDY, temperature=1.0, top_k=40, seed=100 + i)


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.disarm()
    yield
    FAULTS.disarm()


def _counter(name: str) -> float:
    return METRICS.snapshot()["counters"].get(name, 0)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's tiny fp32 weights and its UNINTERRUPTED paged
    streams (a roomy pool), greedy and seeded, for PROMPTS."""
    dense = JaxEngine.from_config("tiny", dtype=jnp.float32, max_seq_len=MAX_SEQ, num_layers=2)
    eng = JaxEngine(dense.cfg, dense.params, dense.tokenizer, max_seq_len=MAX_SEQ,
                    dtype=jnp.float32, paged=True, page_size=4, num_pages=64,
                    batch_size=2, prefix_cache=True)
    eng.scheduler.prefill_chunk = 8
    try:
        greedy = [list(eng.scheduler.stream(p, JaxGen(**GREEDY))) for p in PROMPTS]
        seeded = [list(eng.scheduler.stream(p, JaxGen(**_seeded(i))))
                  for i, p in enumerate(PROMPTS)]
    finally:
        eng.close()
    return dense, greedy, seeded


@pytest.fixture(scope="module")
def params(jax_ref):
    return params_from_jax(jax.tree.map(np.asarray, jax_ref[0].params))


def _make(params, mode: str = "ram", env: dict | None = None, **kw) -> InferenceEngine:
    """A port paged engine over the JAX weights with the KV tier set by
    the environment (the scheduler reads FEI_TPU_KV_* once, when it is
    built). The default pool (page_size 4, 13 allocatable pages) cannot
    hold two worst-case reservations, so preemption happens by itself."""
    over = {"FEI_TPU_KV_TIER": mode, **(env or {})}
    old = {k: os.environ.get(k) for k in over}
    os.environ.update(over)
    try:
        eng = InferenceEngine.from_config(
            "tiny", params=params, paged=True, page_size=kw.pop("page_size", 4),
            num_pages=kw.pop("num_pages", 14), batch_size=kw.pop("batch_size", 2),
            prefix_cache=kw.pop("prefix_cache", True), device="cpu", dtype=torch.float32,
            max_seq_len=MAX_SEQ, num_layers=2, **kw)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    eng.scheduler.prefill_chunk = 8
    return eng


def _run_concurrent(eng, prompts, gens):
    """Stream all prompts at once so co-residency forces preemption."""
    out: list = [None] * len(prompts)

    def worker(i: int) -> None:
        out[i] = list(eng.scheduler.stream(prompts[i], gens[i]))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert all(o is not None for o in out), "a stream never finished"
    return out


def _gens(seeded: bool, n: int = len(PROMPTS)):
    return [GenerationConfig(**(_seeded(i) if seeded else GREEDY)) for i in range(n)]


# -- the wire format and the store ---------------------------------------------


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
        a.arrays[k].dtype == b.arrays[k].dtype and np.array_equal(a.arrays[k], b.arrays[k])
        for k in a.arrays)


def test_pack_unpack_round_trip():
    e = _entry("rt")
    got, extra = unpack_entry(pack_entry(e, {"hop": 1}))
    assert got.key == "rt" and got.n_tokens == 12 and extra == {"hop": 1}
    assert _same_arrays(e, got)


def test_payload_corruption_is_typed():
    blob = bytearray(pack_entry(_entry("c")))
    blob[-5] ^= 0xFF
    with pytest.raises(KVTierError, match="checksum"):
        unpack_entry(bytes(blob))


@pytest.mark.parametrize("cut", [3, 10, -7])
def test_truncated_blob_is_typed(cut):
    blob = pack_entry(_entry("t"))
    with pytest.raises(KVTierError):
        unpack_entry(blob[:cut])


def test_ram_to_disk_demotion_round_trips(tmp_path):
    one = _entry("a").nbytes
    store = KVTierStore(TierConfig(mode="disk", ram_bytes=one + 1,
                                   disk_bytes=1 << 30, disk_dir=str(tmp_path)))
    entries = {k: _entry(k, seed=i) for i, k in enumerate("abc")}
    for k, e in entries.items():
        store.put(k, e)
    store.flush()
    assert store.stats()["disk_entries"] == 2 and store.stats()["ram_entries"] == 1
    for k, e in entries.items():
        got = store.fetch(k)
        assert got is not None and _same_arrays(e, got)
    store.clear()


def test_disk_budget_evicts_coldest(tmp_path):
    one = len(pack_entry(_entry("a")))
    store = KVTierStore(TierConfig(mode="disk", ram_bytes=1, disk_bytes=2 * one,
                                   disk_dir=str(tmp_path)))
    c0 = _counter("kv.evictions")
    for i, k in enumerate("abcd"):
        store.put(k, _entry(k, seed=i))
        store.flush()
    assert _counter("kv.evictions") - c0 >= 1
    assert store.fetch("a") is None  # the coldest file went first
    assert store.fetch("c") is not None
    store.clear()


def test_corrupt_disk_file_is_typed(tmp_path):
    store = KVTierStore(TierConfig(mode="disk", ram_bytes=1, disk_dir=str(tmp_path)))
    store.put("x", _entry("x"))
    store.put("y", _entry("y", seed=1))
    store.flush()
    path = store._path("x")
    raw = bytearray(Path(path).read_bytes())
    raw[-3] ^= 0xFF
    Path(path).write_bytes(bytes(raw))
    c0 = _counter("kv.fetch_corrupt")
    with pytest.raises(KVTierError):
        store.fetch("x")
    assert _counter("kv.fetch_corrupt") - c0 == 1
    assert store.fetch("x") is None  # never served twice
    store.clear()


def test_ram_mode_drops_past_budget():
    one = _entry("a").nbytes
    store = KVTierStore(TierConfig(mode="ram", ram_bytes=one + 1))
    store.put("a", _entry("a"))
    store.put("b", _entry("b", seed=1))
    assert store.fetch("a") is None and store.fetch("b") is not None
    assert store.stats()["disk_entries"] == 0
    store.clear()


# -- FKV1 across packages --------------------------------------------------------


def _cross_arrays(kind: str, seed: int = 0):
    """(port arrays, JAX arrays) of one gather-shaped entry: the same bits,
    bf16 as 2-byte words in the port and as ml_dtypes.bfloat16 in JAX."""
    rng = np.random.default_rng(seed)
    shape = (3, 2, 2, 4, 8)
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "bf16":
        words = x.astype(ml_dtypes.bfloat16).view(np.uint16)
        port = {"k_pages": words, "v_pages": words[::-1].copy()}
        return port, {k: v.view(ml_dtypes.bfloat16) for k, v in port.items()}
    if kind == "int8":
        q = np.clip(np.round(x * 40), -127, 127).astype(np.int8)
        s = rng.uniform(0.01, 1.0, (3, 2, 2, 1, 4)).astype(np.float32)
        port = {"k_pages": q, "v_pages": q[::-1].copy(), "k_scales": s, "v_scales": s * 2}
        return port, {k: v.copy() for k, v in port.items()}
    port = {"k_pages": x, "v_pages": -x}
    return port, {k: v.copy() for k, v in port.items()}


_FP = {"bf16": "bfloat16", "int8": "int8", "fp32": "float32"}


@pytest.mark.parametrize("kind", ["bf16", "int8", "fp32"])
def test_fkv1_blobs_are_equal_across_packages(kind):
    port, ref = _cross_arrays(kind)
    meta = dict(key="cas:" + "ab" * 32, n_tokens=12, page_size=4,
                fingerprint={"layers": 2, "kv_heads": 2, "page_size": 4, "head_dim": 8,
                             "dtype": _FP[kind], "quantized": kind == "int8"},
                layout={"tp": 1, "head_slices": [[0, 2]]})
    blob = pack_entry(PageEntry(arrays=port, **meta), {"prompt_ids": [1, 2, 3]})
    jblob = jax_tier.pack_entry(jax_tier.PageEntry(arrays=ref, **meta), {"prompt_ids": [1, 2, 3]})
    assert blob == jblob  # the same bytes, header and payload
    got, extra = unpack_entry(jblob)  # the JAX package's blob in the port
    jgot, jextra = jax_tier.unpack_entry(blob)  # and the reverse
    assert extra == jextra == {"prompt_ids": [1, 2, 3]}
    for name in port:
        assert got.arrays[name].dtype == port[name].dtype
        assert got.arrays[name].tobytes() == ref[name].tobytes()
        assert jgot.arrays[name].dtype == ref[name].dtype
        assert jgot.arrays[name].tobytes() == port[name].tobytes()
    if kind == "bf16":
        assert got.arrays["k_pages"].dtype == BF16_WORDS


_NO_ML_DTYPES = r"""
import builtins, json, sys
real = builtins.__import__
def guarded(name, *a, **k):
    if name == "ml_dtypes" or name.startswith("ml_dtypes."):
        raise ImportError("ml_dtypes is blocked")
    return real(name, *a, **k)
builtins.__import__ = guarded
import numpy as np
import torch
from fei_tpu_torch.kv import pagesio
from fei_tpu_torch.kv.tier import PageEntry, pack_entry, unpack_entry
pool = torch.randn(2, 5, 2, 4, 8).to(torch.bfloat16)
Pool = type("Pool", (), {})
p = Pool(); p.k_pages = pool; p.v_pages = -pool; p.k_scales = p.v_scales = None
p.quantized = False
arrays = pagesio.gather_pages(p, [3, 1])
e = PageEntry(key="k", n_tokens=8, page_size=4, fingerprint=pagesio.pool_fingerprint(p),
              arrays=arrays)
got, _ = unpack_entry(pack_entry(e))
q = Pool(); q.k_pages = torch.zeros_like(pool); q.v_pages = torch.zeros_like(pool)
q.k_scales = q.v_scales = None
pagesio.scatter_pages(q, [3, 1], got.arrays)
print(json.dumps({
    "ml_dtypes": "ml_dtypes" in sys.modules,
    "dtype": e.fingerprint["dtype"],
    "manifest_bf16": b'"bfloat16"' in pack_entry(e),
    "bitwise": bool(torch.equal(q.k_pages[:, [3, 1]].view(torch.int16),
                                pool[:, [3, 1]].view(torch.int16))
                    and torch.equal(q.v_pages[:, [3, 1]].view(torch.int16),
                                    (-pool)[:, [3, 1]].view(torch.int16))),
}))
"""


def test_bf16_entry_round_trips_without_ml_dtypes():
    import json

    out = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES], capture_output=True,
                         text=True, timeout=120, check=True, cwd=REPO)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"ml_dtypes": False, "dtype": "bfloat16", "manifest_bf16": True,
                   "bitwise": True}


def test_jax_written_disk_file_is_fetched_by_the_port(tmp_path):
    """A disk-tier file the JAX package wrote reads back in the port: the
    file name is the same function of the key, and the bytes are equal.
    (Each store's index of its files lives in its process.)"""
    _, ref = _cross_arrays("bf16", seed=3)
    jstore = jax_tier.KVTierStore(jax_tier.TierConfig(mode="disk", ram_bytes=1,
                                                      disk_dir=str(tmp_path)))
    fp = {"layers": 2, "kv_heads": 2, "page_size": 4, "head_dim": 8,
          "dtype": "bfloat16", "quantized": False}
    jstore.put("req-a", jax_tier.PageEntry("req-a", 12, 4, fp, ref))
    jstore.put("req-b", jax_tier.PageEntry("req-b", 12, 4, fp, ref))  # demotes req-a
    jstore.flush()
    store = KVTierStore(TierConfig(mode="disk", ram_bytes=1, disk_dir=str(tmp_path)))
    path = store._path("req-a")
    assert path == jstore._path("req-a") and os.path.exists(path)
    store._disk["req-a"] = os.path.getsize(path)
    got = store.fetch("req-a")
    assert got is not None and got.fingerprint == fp
    for name, a in ref.items():
        assert got.arrays[name].tobytes() == a.tobytes()


# -- spill and streamed resume ---------------------------------------------------


def _assert_streamed(c0: dict) -> None:
    c1 = METRICS.snapshot()["counters"]

    def delta(k: str) -> float:
        return c1.get(k, 0) - c0.get(k, 0)

    assert delta("scheduler.preemptions") > 0, "the tight pool never preempted"
    assert delta("kv.spills") > 0
    assert delta("kv.fetches") > 0 and delta("kv.pages_restored") > 0
    assert delta("kv.fetch_fallbacks") == 0
    assert delta("scheduler.preempted_tokens_recomputed") == 0, \
        "a resume re-prefilled instead of streaming pages back"


@pytest.mark.parametrize("seeded", [False, True], ids=["greedy", "seeded"])
def test_streamed_resume_equals_the_jax_streams(params, jax_ref, seeded):
    eng = _make(params, "ram")
    try:
        c0 = METRICS.snapshot()["counters"]
        got = _run_concurrent(eng, PROMPTS, _gens(seeded))
        assert got == jax_ref[2 if seeded else 1]
        _assert_streamed(c0)
    finally:
        eng.close()


@pytest.mark.parametrize("seeded", [False, True], ids=["greedy", "seeded"])
def test_disk_tier_streams_equal_the_jax_streams(params, jax_ref, tmp_path, seeded):
    """A one-byte RAM budget sends every spill but the newest through the
    disk rung before its resume fetches it back."""
    eng = _make(params, "disk", env={"FEI_TPU_KV_RAM_BYTES": "1",
                                     "FEI_TPU_KV_DISK_DIR": str(tmp_path)})
    try:
        c0 = METRICS.snapshot()["counters"]
        got = _run_concurrent(eng, PROMPTS, _gens(seeded))
        assert got == jax_ref[2 if seeded else 1]
        _assert_streamed(c0)
        assert _counter("kv.demotions") - c0.get("kv.demotions", 0) > 0
    finally:
        eng.close()


@pytest.mark.parametrize("kind", ["io", "corrupt", "hang"])
def test_fetch_fault_falls_back_to_replay(params, jax_ref, kind):
    eng = _make(params, "ram")
    try:
        FAULTS.arm("kv.fetch", kind, count=99)
        c0 = _counter("kv.fetch_fallbacks")
        got = _run_concurrent(eng, PROMPTS, _gens(False))
        assert got == jax_ref[1]
        assert FAULTS.fired("kv.fetch") > 0
        assert _counter("kv.fetch_fallbacks") - c0 == FAULTS.fired("kv.fetch")
    finally:
        eng.close()


def test_spill_fault_replays_silently(params, jax_ref):
    eng = _make(params, "ram")
    try:
        FAULTS.arm("kv.spill", "io", count=99)
        c0, r0 = _counter("kv.spill_failures"), _counter("scheduler.preempted_tokens_recomputed")
        got = _run_concurrent(eng, PROMPTS, _gens(False))
        assert got == jax_ref[1]
        assert _counter("kv.spill_failures") - c0 > 0
        assert _counter("scheduler.preempted_tokens_recomputed") - r0 > 0  # replayed
    finally:
        eng.close()


def test_oversubscription_soak_loses_nothing(params):
    """5x slot oversubscription: every stream delivers its whole budget,
    resumes stream pages (none replays), nothing wedges."""
    eng = _make(params, "ram")
    try:
        # distinct first tokens: a shared prefix would relieve the pressure
        prompts = [[40 + i] + PROMPTS[0][1:] for i in range(10)]
        c0 = METRICS.snapshot()["counters"]
        got = _run_concurrent(eng, prompts, _gens(False, len(prompts)))
        assert [len(g) for g in got] == [24] * len(prompts)
        c1 = METRICS.snapshot()["counters"]
        assert c1.get("scheduler.preemptions", 0) - c0.get("scheduler.preemptions", 0) > 0
        assert (c1.get("scheduler.preempted_tokens_recomputed", 0)
                - c0.get("scheduler.preempted_tokens_recomputed", 0)) == 0
    finally:
        eng.close()


def test_finished_requests_leave_nothing_in_the_tier(params):
    eng = _make(params, "ram")
    try:
        _run_concurrent(eng, PROMPTS, _gens(False))
        st = eng.scheduler._kv_tier.stats()
        assert st["ram_entries"] == st["cas_stores"]  # only published prefixes
        assert st["pinned_keys"] == 0
    finally:
        eng.close()


# -- migration --------------------------------------------------------------------

_CHAT = {"messages": [{"role": "user", "content": "kv migration round trip"}],
         "max_tokens": 4, "temperature": 0}


def _api(params, **kw):
    from fei_tpu_torch.agent.providers import TorchLocalProvider
    from fei_tpu_torch.ui.server import ServeAPI

    eng = _make(params, "off", num_pages=kw.pop("num_pages", 64), **kw)
    return ServeAPI(TorchLocalProvider(engine=eng), model_name="kvtier")


def _req(api, method: str, path: str, body: dict | None = None):
    return api.handle(method, path, dict(body or {}), {})[:2]


def test_migration_routes_and_ladder(params):
    a, b = _api(params), _api(params)
    try:
        status, _ = _req(a, "POST", "/kv/export",
                         {"messages": [{"role": "user", "content": "never served"}]})
        assert status == 404
        assert _req(a, "POST", "/v1/chat/completions", _CHAT)[0] == 200
        status, exported = _req(a, "POST", "/kv/export", {"messages": _CHAT["messages"]})
        assert status == 200 and exported["bytes"] > 0
        status, imported = _req(b, "POST", "/kv/import", {"blob": exported["blob"]})
        assert status == 200 and imported["pages"] > 0
        h0, m0 = _counter("prefix.hits"), _counter("prefix.misses")
        status, payload = _req(b, "POST", "/v1/chat/completions", _CHAT)
        assert status == 200 and payload["choices"]
        assert _counter("prefix.hits") > h0 and _counter("prefix.misses") == m0
        assert _req(b, "POST", "/kv/import", {"blob": "not base64!!"})[0] == 400
        assert _req(b, "POST", "/kv/import", {})[0] == 400
        junk = base64.b64encode(b"FKV1 but not really").decode()
        assert _req(b, "POST", "/kv/import", {"blob": junk})[0] == 422
        raw = bytearray(base64.b64decode(exported["blob"]))
        raw[-5] ^= 0xFF
        status, payload = _req(b, "POST", "/kv/import",
                               {"blob": base64.b64encode(bytes(raw)).decode()})
        assert status == 422, payload
    finally:
        a.provider.engine.close()
        b.provider.engine.close()


def _jax_paged(jax_ref, **kw):
    dense = jax_ref[0]
    eng = JaxEngine(dense.cfg, dense.params, dense.tokenizer, max_seq_len=MAX_SEQ,
                    dtype=jnp.float32, paged=True, page_size=4, num_pages=64,
                    batch_size=2, prefix_cache=True, **kw)
    eng.scheduler.prefill_chunk = 8
    return eng


def _port_pages(eng, prompt) -> dict:
    sched = eng.scheduler
    return sched.run_ctl(lambda: pagesio.gather_pages(sched._pool, sched._prefix.match(prompt)))


def _jax_pages(eng, prompt) -> dict:
    sched = eng.scheduler
    return sched.run_ctl(lambda: jax_pagesio.gather_pages(sched._pool,
                                                          sched._prefix.match(prompt)))


def test_jax_blob_imports_into_the_port_and_back(params, jax_ref):
    """ROADMAP B5's named test: a migration blob exported by the JAX
    package imports into the port with identical page bytes and serves a
    prefix hit equal to the JAX stream; a port blob lands in the JAX
    package the same way."""
    prompt = PROMPTS[1]
    jsrc = _jax_paged(jax_ref)
    port = _make(params, "off", num_pages=64)
    jdst = _jax_paged(jax_ref)
    try:
        assert list(jsrc.scheduler.stream(prompt, JaxGen(**GREEDY))) == jax_ref[1][1]
        jblob = jsrc.scheduler.export_prefix(prompt)
        want, extra = jax_tier.unpack_entry(jblob)
        assert port.scheduler.import_prefix(jblob) == want.n_pages == 4
        got = _port_pages(port, prompt)
        assert set(got) == set(want.arrays)
        for name, a in want.arrays.items():
            assert got[name].tobytes() == np.asarray(a).tobytes()
        h0 = _counter("prefix.hits")
        assert list(port.scheduler.stream(prompt, GenerationConfig(**GREEDY))) == jax_ref[1][1]
        assert _counter("prefix.hits") > h0
        # the reverse: the port's export is the same blob, and it imports
        blob = port.scheduler.export_prefix(prompt)
        assert blob == jblob
        assert jdst.scheduler.import_prefix(blob) == 4
        jgot = _jax_pages(jdst, prompt)
        for name, a in got.items():
            assert np.asarray(jgot[name]).tobytes() == a.tobytes()
    finally:
        for e in (jsrc, port, jdst):
            e.close()
