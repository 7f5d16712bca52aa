"""Rank-side cases of the port's sharded-serving tests (no jax here: the
rank processes import the port alone).

``run_ranks(world, case, args)`` spawns ``world`` processes that join one
gloo group over a local TCP port, run ``CASES[case](rank, world, args)``
on the CPU and return each rank's result (``RankRun`` starts them and
waits later, so two groups and the caller's own work can overlap). A case builds its mesh engines
with ``InferenceEngine.from_config(mesh=...)``, which binds to the group:
rank 0 leads, the others follow inside ``from_config`` until rank 0
closes the engine. One-rank reference engines are built on rank 0 alone.
"""

from __future__ import annotations

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import os
import pickle
import socket
import threading
import traceback
from pathlib import Path

N_NEW = 12
MAX_SEQ = 128
PROMPTS = [
    [105, 47, 220, 31, 99, 180, 12, 200, 64, 150, 77, 9],
    list(range(30, 71)),  # 41 tokens: admitted in chunks
    [7, 300, 12, 401, 22],
]
SEED = 29


def _gen(seeded: bool = False, n: int = N_NEW):
    from fei_tpu_torch.engine.engine import GenerationConfig

    if seeded:
        return GenerationConfig(max_new_tokens=n, ignore_eos=True, seed=SEED,
                                temperature=0.8, top_p=0.9)
    return GenerationConfig(max_new_tokens=n, ignore_eos=True)


def _engine(params, mesh, **kw):
    import torch

    from fei_tpu_torch.engine.engine import InferenceEngine

    kw.setdefault("max_seq_len", MAX_SEQ)
    return InferenceEngine.from_config("tiny", params=params, device="cpu",
                                       dtype=torch.float32, num_layers=2, mesh=mesh, **kw)


def _streams(eng) -> dict:
    """Three greedy streams in flight together, then one seeded stream."""
    out: dict = {}

    def go(i, p):
        out[i] = list(eng.scheduler.stream(p, _gen()))

    ts = [threading.Thread(target=go, args=(i, p)) for i, p in enumerate(PROMPTS)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    out["seeded"] = list(eng.scheduler.stream(PROMPTS[0], _gen(seeded=True)))
    return out


# a parked scheduler's occupancy, placed by hand for the gauge checks: the
# slots (tiled over the scheduler's rows) and the queued requests
GAUGE_SLOTS = (True, False, True, True)
GAUGE_WAITING = 3


def sched_gauges(sched, metrics) -> dict:
    """The gauges one ``_update_sched_gauges`` call sets on a parked
    scheduler (either package's; ``metrics`` is its registry) holding
    GAUGE_SLOTS and GAUGE_WAITING placeholder requests; the scheduler is
    emptied again after. Only what the call itself sets is returned, so
    gauges other tests left in the process do not count."""
    from types import SimpleNamespace

    def placeholder():
        return SimpleNamespace(tenant="default", finished=False)

    set_now: dict = {}
    real = metrics.gauge

    def gauge(name, value, *a, **kw):
        set_now[name] = value
        return real(name, value, *a, **kw)

    for i in range(sched.B):
        sched._slots[i] = placeholder() if GAUGE_SLOTS[i % len(GAUGE_SLOTS)] else None
    sched._waiting.extend(placeholder() for _ in range(GAUGE_WAITING))
    metrics.gauge = gauge
    try:
        sched._update_sched_gauges()
    finally:
        del metrics.gauge
        sched._slots[:] = [None] * sched.B
        sched._waiting.clear()
    return set_now


def _param_bytes(params) -> int:
    from fei_tpu_torch.obs.costmodel import _param_bytes

    return _param_bytes(params)


def wrapper_parity(mesh, device="cpu") -> dict:
    """Each sharded kernel wrapper on this rank's heads (or columns) against
    the unsharded kernel on every head, on the same seeded inputs: a dict of
    ``name: bitwise equal`` as rank 0 sees it, plus ``mutant``: the paged
    wrapper with its head gather in the wrong order, which must differ."""
    import torch

    from fei_tpu_torch.ops.kernels.int4_matmul import int4_mm, int4_mm_sharded
    from fei_tpu_torch.ops.kernels.paged_attention import (
        paged_attention,
        paged_attention_block,
        paged_attention_block_sharded,
        paged_attention_sharded,
    )
    from fei_tpu_torch.ops.kernels.ragged_paged_attention import (
        ragged_paged_attention,
        ragged_paged_attention_sharded,
    )
    from fei_tpu_torch.ops.quant import quantize4

    g = torch.Generator().manual_seed(7)
    tp, c = mesh.shape["tp"], mesh.coords["tp"]
    B, H, K, D, ps, P, W = 4, 8, 4, 64, 64, 12, 3

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(device)

    kp, vp = rnd(P, K, ps, D), rnd(P, K, ps, D)
    bt = torch.randint(1, P, (B, W), generator=g).to(torch.int32).to(device)
    lengths = torch.tensor([5, 130, 64, 190], dtype=torch.int32, device=device)
    kl, hl = slice(c * K // tp, (c + 1) * K // tp), slice(c * H // tp, (c + 1) * H // tp)
    mine = (kp[:, kl].contiguous(), vp[:, kl].contiguous())
    out = {}
    q = rnd(B, H, D)
    want = paged_attention(q, kp, vp, bt, lengths)
    got = paged_attention_sharded(q[:, hl].contiguous(), *mine, bt, lengths, mesh)
    out["paged_attention"] = torch.equal(got, want)
    qb = rnd(B, 5, H, D)
    want = paged_attention_block(qb, kp, vp, bt, lengths)
    got = paged_attention_block_sharded(qb[:, :, hl].contiguous(), *mine, bt, lengths, mesh)
    out["paged_attention_block"] = torch.equal(got, want)
    qr = rnd(B, 8, H, D)
    q_lens = torch.tensor([1, 8, 3, 1], dtype=torch.int32, device=device)
    modes = torch.tensor([1, 0, 0, 1], dtype=torch.int32, device=device)
    limits = (lengths + 1).to(torch.int32)
    want = ragged_paged_attention(qr, kp, vp, bt, limits, q_lens, modes)
    got = ragged_paged_attention_sharded(qr[:, :, hl].contiguous(), *mine, bt, limits,
                                         q_lens, modes, mesh)
    out["ragged_paged_attention"] = torch.equal(got, want)
    w = quantize4(rnd(512, 512).to(torch.bfloat16 if device != "cpu" else torch.float32))
    for m in (1, 8, 256):
        x = rnd(m, 512).to(torch.bfloat16 if device != "cpu" else torch.float32)
        out[f"int4_mm_m{m}"] = torch.equal(int4_mm_sharded(x, w, mesh), int4_mm(x, w))
    # the head-order mutant: the gather's chunks in reverse rank order
    gather = mesh.all_gather

    def reversed_gather(t, axis, dim):
        got = gather(t, axis, dim)
        return torch.cat(list(reversed(got.chunk(mesh.shape[axis], dim))), dim)

    mesh.all_gather = reversed_gather
    try:
        got = paged_attention_sharded(q[:, hl].contiguous(), *mine, bt, lengths, mesh)
    finally:
        mesh.all_gather = gather
    out["mutant"] = torch.equal(got, paged_attention(q, kp, vp, bt, lengths))
    return out


def case_serving(rank: int, world: int, args: dict) -> dict:
    """Every two-rank case of tests/test_torch_sharded_serving.py, in one
    group: the paged streams of both weight profiles, the dense logits of
    both, int4, the sharded checkpoint load, a drain onto one rank and an
    exported prefix landing on one rank."""
    import torch

    from fei_tpu_torch.engine.engine import InferenceEngine
    from fei_tpu_torch.parallel.mesh import mesh_geometry

    from fei_tpu_torch.parallel.mesh import make_mesh

    params = torch.load(args["params"], weights_only=False)
    res: dict = {"wrappers": wrapper_parity(make_mesh({"tp": world}))}
    prompt = torch.tensor([PROMPTS[1]])

    # -- paged streams, the FEI_TPU_MESH default (replicated weights)
    if rank == 0:
        one = _engine(params, "ms1", paged=True, batch_size=2)
        res["ms1_streams"] = _streams(one)
        one.close()
    os.environ["FEI_TPU_MESH"] = "tp2"
    try:
        eng = _engine(params, None, paged=True, batch_size=2)
    finally:
        del os.environ["FEI_TPU_MESH"]
    res["replicated_bytes"] = _param_bytes(eng.params)
    res["replicated_weights"] = eng.mesh_weights
    if rank == 0:
        from fei_tpu_torch.ops.kernels.paged_attention import paged_attention
        from fei_tpu_torch.ops.kernels.ragged_paged_attention import ragged_paged_attention

        res["tp2_streams"] = _streams(eng)
        res["tag"] = eng.mesh_tag
        res["geometry"] = mesh_geometry(eng.mesh)
        res["kv_fingerprint"] = eng.kv_fingerprint()
        res["kv_layout"] = eng.kv_layout()
        res["pool_heads"] = eng.scheduler._pool.k_pages.shape[2]
        res["backend"] = eng.mesh.backend
        res["dispatches"] = eng._spmd_leader.dispatches
        res["plain_launches"] = paged_attention.launches + ragged_paged_attention.launches
        eng.close()

    # -- paged streams and dense logits, Megatron profile
    eng = _engine(params, "tp2", mesh_weights="sharded", paged=True, batch_size=2)
    res["sharded_bytes"] = _param_bytes(eng.params)
    res["sharded_wq"] = tuple(eng.params["layers"]["wq"].shape)
    if rank == 0:
        res["sharded_streams"] = _streams(eng)
        eng.close()
    for weights in ("replicated", "sharded"):
        eng = _engine(params, "tp2", mesh_weights=weights)
        if rank == 0:
            logits, _ = eng.prefill([PROMPTS[1]], eng.new_cache(1))
            res[f"logits_{weights}"] = logits.numpy()
            from fei_tpu_torch.models.llama import forward

            full, _ = forward(eng.params, eng.cfg, prompt, eng.new_cache(1, 64))
            res[f"forward_{weights}"] = full.numpy()
            res[f"dense_{weights}"] = eng.generate(PROMPTS[0], _gen()).token_ids
            eng.close()

    # -- int4: K4 column-sharded, wo/w_down int8. The port's own int4 tp2
    # build shows which leaves stay int8; the logits run on fei_tpu's int4
    # tp2 engine's weights, one rank and tp2 under both profiles
    q4 = dict(hidden_size=512, intermediate_size=1024, num_heads=8, num_kv_heads=4,
              max_seq_len=MAX_SEQ)
    eng = InferenceEngine.from_config("tiny", device="cpu", dtype=torch.float32,
                                      num_layers=2, mesh="tp2", mesh_weights="replicated",
                                      quantize="int4", seed=0, **q4)
    kinds = {k: type(v).__name__ for k, v in eng.params["layers"].items()}
    if rank == 0:
        res["int4_kinds"] = kinds
        eng.close()
    q4p = torch.load(args["int4_params"], weights_only=False)
    if rank == 0:
        one = InferenceEngine.from_config("tiny", device="cpu", dtype=torch.float32,
                                          num_layers=2, mesh="ms1", params=dict(q4p), **q4)
        res["int4_ms1"] = one.prefill([PROMPTS[0]], one.new_cache(1))[0].numpy()
        one.close()
    for weights in ("replicated", "sharded"):
        eng = InferenceEngine.from_config("tiny", device="cpu", dtype=torch.float32,
                                          num_layers=2, mesh="tp2", mesh_weights=weights,
                                          params=dict(q4p), **q4)
        if rank == 0:
            res[f"int4_tp2_{weights}"] = eng.prefill([PROMPTS[0]], eng.new_cache(1))[0].numpy()
            eng.close()

    # -- a sharded streaming load of an HF checkpoint
    ckpt = args["ckpt"]
    if rank == 0:
        one = InferenceEngine.from_config("tiny", checkpoint_dir=ckpt, device="cpu",
                                          dtype=torch.float32, mesh="ms1", quantize="int8",
                                          max_seq_len=MAX_SEQ)
        res["load_ms1"] = one.prefill([PROMPTS[0]], one.new_cache(1))[0].numpy()
        res["load_ms1_bytes"] = _param_bytes(one.params)
    eng = InferenceEngine.from_config("tiny", checkpoint_dir=ckpt, device="cpu",
                                      dtype=torch.float32, mesh="tp2", mesh_weights="sharded",
                                      quantize="int8", max_seq_len=MAX_SEQ)
    res["load_bytes"] = _param_bytes(eng.params)
    res["load_wo"] = tuple(eng.params["layers"]["wo"].q.shape)
    if rank == 0:
        res["load_tp2"] = eng.prefill([PROMPTS[0]], eng.new_cache(1))[0].numpy()
        eng.close()

    # -- drain a tp2 engine, restart on one rank
    drain_dir = args["drain_dir"]
    eng = _engine(params, "tp2", mesh_weights="replicated", paged=True, batch_size=2)
    if rank == 0:
        sched = eng.scheduler
        sched._start_thread = lambda: None  # park: the requests stay queued
        for p in PROMPTS[:2]:
            sched.submit(p, _gen())
        eng.begin_drain(deadline_s=0, snapshot_dir=drain_dir)
        assert sched.wait_drained(timeout=30)
        eng.close()
        one = _engine(params, "ms1", paged=True, batch_size=2)
        restored = one.warm_restart(drain_dir)
        res["restored"] = [list(one.scheduler.drain(s)) for s in restored]
        one.close()

    # -- a tp2 engine's exported prefix lands on one rank
    eng = _engine(params, "tp2", mesh_weights="replicated", paged=True, batch_size=2,
                  page_size=4, prefix_cache=True)
    if rank == 0:
        from fei_tpu_torch.kv.tier import unpack_entry

        first = list(eng.scheduler.stream(PROMPTS[1], _gen(n=4)))
        blob = eng.scheduler.export_prefix(PROMPTS[1])
        entry, _ = unpack_entry(blob)
        res["blob_layout"] = entry.layout
        res["tp2_next"] = first
        eng.close()
        one = _engine(params, "ms1", paged=True, batch_size=2, page_size=4,
                      prefix_cache=True)
        res["landed_pages"] = one.scheduler.import_prefix(blob)
        res["ms1_next"] = list(one.scheduler.stream(PROMPTS[1], _gen(n=4)))
        blob = one.scheduler.export_prefix(PROMPTS[1])
        one.close()

    # -- and one rank's prefix lands on a tp2 engine (each rank its heads)
    eng = _engine(params, "tp2", mesh_weights="replicated", paged=True, batch_size=2,
                  page_size=4, prefix_cache=True)
    if rank == 0:
        res["tp2_landed_pages"] = eng.scheduler.import_prefix(blob)
        res["tp2_landed_next"] = list(eng.scheduler.stream(PROMPTS[1], _gen(n=4)))
        eng.close()
    return res


def case_tp2dp2(rank: int, world: int, args: dict) -> dict:
    """The four-rank case: tp2dp2 (replicated) paged streams and slots."""
    import torch

    params = torch.load(args["params"], weights_only=False)
    res: dict = {}
    if rank == 0:
        one = _engine(params, "ms1", paged=True, batch_size=2)
        res["ms1_streams"] = _streams(one)
        one.close()
    eng = _engine(params, "tp2dp2", mesh_weights="replicated", paged=True, batch_size=2)
    res["coords"] = dict(eng.mesh.coords)
    if rank == 0:
        res["tag"] = eng.mesh_tag
        res["slots"] = eng.batch_size
        res["streams"] = _streams(eng)
        eng.close()
    return res


def case_initialize(rank: int, world: int, args: dict) -> dict:
    """Two ranks that joined through ``parallel.distributed.initialize``
    (the FEI_TPU_* variables): their process info and a gather."""
    import torch

    from fei_tpu_torch.parallel.distributed import initialize, is_initialized, process_info
    from fei_tpu_torch.parallel.mesh import make_mesh

    info = process_info()
    mesh = make_mesh({"dp": world})
    # every rank's bytes arrive in rank order, bit for bit (bf16 words)
    x = torch.full((3,), rank + 0.5, dtype=torch.bfloat16)
    got = mesh.all_gather(x, "dp", dim=0)
    total = mesh.all_reduce(torch.tensor([rank + 1.0]), "dp")
    return {"info": info, "initialized": is_initialized(), "again": initialize(),
            "gather": got.float().tolist(),
            "sum": float(total[0])}


# -- sequence, expert and pipeline parallelism, sharded training, the bank
# exchange (tests/test_torch_{ring,expert_parallel,pipeline,sharded_train,
# parallel,embedding_exchange}.py read these results)

LONG_MIN = 64  # long_prefill_min of the sp engines
SP_PROMPT = [(17 * i + 3) % 200 + 10 for i in range(96)]  # bucket 128: sp-eligible
LIVE_PROMPT = list(range(40, 72))  # decoding while SP_PROMPT admits
SP_CHUNK = 32  # the paged engines' prefill_chunk: SP_PROMPT would chunk without sp
ATT_CASES = [(4, 2, 0), (4, 1, 0), (4, 2, 5)]  # (H, K, window): GQA, MQA, a window
ATT_SHAPE = (2, 16, 8)  # B, T, D
PREFILL_T = 32
PREFILL_LENS = [32, 27]
MOE_X = (2, 9)  # tokens [B, T] of the expert-parallel layer checks
DROP_CF = 0.5  # a capacity factor that drops assignments
PP_SHAPE = (4, 12)
TRAIN_SHAPE = (4, 17)
TRAIN_STEPS = 2
FALL_STEPS = 5
BANKS = (4, 8, 16)
EP_PROMPT = [109, 105, 120, 116, 114, 97, 108, 32, 101, 120, 112, 101, 114, 116]


def att_inputs(H: int, K: int, seed: int = 5):
    """Global q [B, T, H, D], k/v [B, T, K, D] (fp32 numpy) of a ring case."""
    import numpy as np

    B, T, D = ATT_SHAPE
    rng = np.random.default_rng(seed + 10 * H + K)
    return (rng.standard_normal((B, T, H, D)).astype(np.float32),
            rng.standard_normal((B, T, K, D)).astype(np.float32),
            rng.standard_normal((B, T, K, D)).astype(np.float32))


def tokens(shape, seed: int, vocab: int = 512):
    import numpy as np

    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int64)


def moe_x(seed: int = 6):
    import numpy as np

    return np.random.default_rng(seed).standard_normal(MOE_X + (64,)).astype(np.float32)


def _err(fn) -> str:
    """The ValueError message ``fn`` raises ("" when it does not)."""
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return ""


def _flat_np(params) -> dict:
    from fei_tpu_torch.utils.tree import flatten

    return {k: v.detach().numpy().copy() for k, v in flatten(params).items()}


def _train(params, cfg, mesh, steps: int, lr: float, toks):
    """``steps`` of the port's train step on ``mesh`` from the rank's
    Megatron shards of ``params``: (losses, the rank's params and
    optimizer state after)."""
    import torch

    from fei_tpu_torch.engine.train import TrainConfig, make_train_step
    from fei_tpu_torch.parallel.sharding import shard_params

    mine = shard_params({k: v for k, v in params.items()}, mesh, cfg.is_moe)
    mine = {k: ({a: b.clone() for a, b in v.items()} if isinstance(v, dict) else v.clone())
            for k, v in mine.items()}
    opt, step = make_train_step(cfg, TrainConfig(learning_rate=lr), device="cpu", mesh=mesh)
    state = opt.init(mine)
    losses = []
    for _ in range(steps):
        mine, state, loss = step(mine, state, torch.from_numpy(toks))
        losses.append(float(loss))
    return losses, mine, state


def _sp_paged(eng) -> dict:
    """LIVE_PROMPT decoding, SP_PROMPT admitted once it has five tokens."""
    import threading

    from fei_tpu_torch.engine.engine import GenerationConfig

    out: dict = {}
    started = threading.Event()

    def live():
        got = []
        for i, tok in enumerate(eng.scheduler.stream(
                LIVE_PROMPT, GenerationConfig(max_new_tokens=48, ignore_eos=True))):
            got.append(tok)
            if i == 4:
                started.set()
        out["live"] = got

    def long():
        started.wait(timeout=60)
        out["long"] = list(eng.scheduler.stream(
            SP_PROMPT, GenerationConfig(max_new_tokens=12, ignore_eos=True)))

    ts = [threading.Thread(target=live), threading.Thread(target=long)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    return out


def _counter(name: str) -> float:
    from fei_tpu_torch.utils.metrics import METRICS

    return METRICS.snapshot()["counters"].get(name, 0.0)


def _load_params(paths: dict, timeout: float = 120.0) -> dict:
    """The weights the parent writes while the ranks start (each file
    appears whole: written aside, then renamed)."""
    import time

    import torch

    out = {}
    for name, path in paths.items():
        t0 = time.monotonic()
        while not os.path.exists(path):
            if time.monotonic() - t0 > timeout:
                raise TimeoutError(f"{path} did not appear in {timeout} s")
            time.sleep(0.05)
        out[name] = torch.load(path, weights_only=False)
    return out


def case_parallel2(rank: int, world: int, args: dict) -> dict:
    """Every two-rank case of the sp, ep, pp, training and bank-exchange
    tests, in one group."""
    import numpy as np
    import torch

    from fei_tpu_torch.engine.engine import InferenceEngine
    from fei_tpu_torch.memory.memorychain.embedding_exchange import exchange_banks
    from fei_tpu_torch.models.configs import get_model_config
    from fei_tpu_torch.parallel.expert import moe_mlp_ep, moe_mlp_ep_routed
    from fei_tpu_torch.parallel.long_prefill import prefill_ring, prefill_ring_kv
    from fei_tpu_torch.parallel.mesh import make_mesh
    from fei_tpu_torch.parallel.pipeline import pipeline_forward_train
    from fei_tpu_torch.parallel.ring import ring_attention, ulysses_attention

    res: dict = {}
    P = _load_params(args["params"])
    t = torch.from_numpy
    kw = dict(device="cpu", dtype=torch.float32, num_layers=2, max_seq_len=MAX_SEQ)

    # -- sp: ring and Ulysses on this rank's chunk
    sp = make_mesh({"sp": world})
    B, T, D = ATT_SHAPE
    C = T // world
    mine = slice(rank * C, (rank + 1) * C)
    for H, K, w in ATT_CASES:
        q, k, v = (t(a[:, mine].copy()) for a in att_inputs(H, K))
        res[f"ring {H} {K} {w}"] = ring_attention(q, k, v, sp, window=w).numpy()
        try:
            res[f"ulysses {H} {K} {w}"] = ulysses_attention(q, k, v, sp, window=w).numpy()
        except ValueError as exc:
            res[f"ulysses {H} {K} {w}"] = f"ValueError: {exc}"
    for name in ("tiny", "tiny-swa"):
        cfg = get_model_config(name, num_layers=2)
        toks = t(tokens((2, PREFILL_T), 7))
        for attend in ("ring", "ulysses"):
            lg, ka, va = prefill_ring_kv(P[name], cfg, toks, sp, attend=attend,
                                         true_len=torch.tensor(PREFILL_LENS))
            res[f"prefill {name} {attend}"] = (lg.numpy(), ka.numpy(), va.numpy())
        lg, cache = prefill_ring(P[name], cfg, toks[:1], sp, max_seq_len=48)
        res[f"prefill_ring {name}"] = (lg.numpy(), cache.k.numpy(), cache.length.numpy())
    cfg = get_model_config("tiny", num_layers=2)
    res["err T % n"] = _err(lambda: prefill_ring_kv(P["tiny"], cfg, t(tokens((1, 31), 1)), sp))
    res["err attend"] = _err(lambda: prefill_ring_kv(P["tiny"], cfg, t(tokens((1, 32), 1)), sp,
                                                     attend="spiral"))
    mqa = get_model_config("tiny", num_layers=2, num_kv_heads=1)
    res["err ulysses heads"] = _err(lambda: prefill_ring_kv(
        P["tiny"], mqa, t(tokens((1, 32), 1)), sp, attend="ulysses"))

    # -- the sp engines: dense prefill and the scheduler's admission
    if rank == 0:
        res["sp_prefills_before"] = _counter("engine.sp_prefills")
    eng = InferenceEngine.from_config("tiny", params=P["tiny"], mesh="sp2",
                                      long_prefill_min=LONG_MIN, **kw)
    if rank == 0:
        from fei_tpu_torch.engine.engine import GenerationConfig

        gen = GenerationConfig(max_new_tokens=8, ignore_eos=True)
        res["sp_dense"] = eng.generate(SP_PROMPT, gen).token_ids
        res["sp_dense_prefills"] = _counter("engine.sp_prefills") - res["sp_prefills_before"]
        res["sp_short"] = eng.generate(LIVE_PROMPT, gen).token_ids
        res["sp_short_prefills"] = (_counter("engine.sp_prefills")
                                    - res["sp_prefills_before"] - res["sp_dense_prefills"])
        res["sp_tag"] = eng.mesh_tag
        eng.close()
    eng = InferenceEngine.from_config("tiny", params=P["tiny"], mesh="sp2", paged=True,
                                      batch_size=2, long_prefill_min=LONG_MIN, **kw)
    if rank == 0:
        eng.scheduler.prefill_chunk = SP_CHUNK
        before = _counter("engine.sp_prefills")
        res["sp_paged"] = _sp_paged(eng)
        res["sp_paged_prefills"] = _counter("engine.sp_prefills") - before
        eng.close()

    # -- ep: the layer functions and the engine (dropless)
    ep = make_mesh({"ep": world})
    moe = get_model_config("tiny-moe", num_layers=2)
    lay = {k: v[0] for k, v in P["tiny-moe"]["layers"].items()}
    x = t(moe_x())
    wts = (lay["router"], lay["w_gate"], lay["w_up"], lay["w_down"])
    k_ = moe.num_experts_per_tok
    res["ep"] = moe_mlp_ep(x, *wts, k_, ep).numpy()
    res["ep dropless"] = moe_mlp_ep_routed(x, *wts, k_, ep, dropless=True).numpy()
    res["ep capacity"] = moe_mlp_ep_routed(x, *wts, k_, ep, capacity_factor=DROP_CF).numpy()
    res["err E % n"] = _err(lambda: moe_mlp_ep(x, lay["router"][:, :3], *wts[1:], k_, ep))
    res["err E % n routed"] = _err(lambda: moe_mlp_ep_routed(
        x, lay["router"][:, :3], *wts[1:], k_, ep))
    os.environ["FEI_TPU_EP_CAPACITY"] = "dropless"
    try:
        eng = InferenceEngine.from_config("tiny-moe", params=P["tiny-moe"], mesh="ep2", **kw)
        res["ep_experts"] = eng.params["layers"]["w_up"].shape[1]
        if rank == 0:
            res["ep_stream"] = eng.generate(EP_PROMPT, _gen()).token_ids
            eng.close()
        eng = InferenceEngine.from_config("tiny-moe", params=P["tiny-moe"], mesh="ep2",
                                          paged=True, batch_size=2, **kw)
        if rank == 0:
            res["ep_paged"] = _streams(eng)
            eng.close()
    finally:
        del os.environ["FEI_TPU_EP_CAPACITY"]

    # -- the routing rule on a tp mesh: a tiny-moe tp2 engine's prefill of
    # 20 tokens (past the routed form's threshold) takes the dense oracle
    # (whole experts: the replicated profile's)
    from fei_tpu_torch.models import llama as pt_llama

    calls = {"routed": 0, "oracle": 0}
    real = (pt_llama.moe_mlp_routed, pt_llama.moe_mlp)

    def spy(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped

    pt_llama.moe_mlp_routed, pt_llama.moe_mlp = spy("routed", real[0]), spy("oracle", real[1])
    try:
        eng = InferenceEngine.from_config("tiny-moe", params=P["tiny-moe"], mesh="tp2",
                                          mesh_weights="replicated", **kw)
        if rank == 0:
            eng.prefill([list(range(20, 40))], eng.new_cache(1))
            eng.close()
    finally:
        pt_llama.moe_mlp_routed, pt_llama.moe_mlp = real
    res["tp2_moe_calls"] = calls

    # -- pp: the pipelined forward and a pp2 engine
    pp = make_mesh({"pp": world})
    for name in ("tiny", "tiny-phi"):
        cfg = get_model_config(name, num_layers=2)
        toks = t(tokens(PP_SHAPE, 8))
        for m in (2, 4):
            res[f"pp {name} {m}"] = pipeline_forward_train(P[name], cfg, toks, pp, m).detach().numpy()
    cfg3 = get_model_config("tiny", num_layers=3)
    res["err L % n"] = _err(lambda: pipeline_forward_train(P["tiny"], cfg3, t(tokens(PP_SHAPE, 8)),
                                                           pp, 2))
    res["err B % micro"] = _err(lambda: pipeline_forward_train(
        P["tiny"], get_model_config("tiny", num_layers=2), t(tokens(PP_SHAPE, 8)), pp, 3))
    eng = InferenceEngine.from_config("tiny", params=P["tiny"], mesh="pp2", **kw)
    if rank == 0:
        res["pp_stream"] = eng.generate(PROMPTS[0], _gen()).token_ids
        res["pp_tag"] = eng.mesh_tag
        eng.close()

    # -- training on dp2 and tp2 (the Megatron shards), two steps
    cfg = get_model_config("tiny", num_layers=2)
    toks = tokens(TRAIN_SHAPE, 9)
    for spec in ("dp2", "tp2"):
        losses, mine, _ = _train(P["tiny"], cfg, make_mesh(spec), TRAIN_STEPS, 1e-4, toks)
        res[f"train {spec}"] = (losses, _flat_np(mine))

    # -- the mesh and replica gauges of a parked dp2 paged scheduler
    eng = InferenceEngine.from_config("tiny", params=P["tiny"], mesh="dp2", paged=True,
                                      batch_size=2, **kw)
    if rank == 0:
        from fei_tpu_torch.utils.metrics import METRICS

        res["dp2_gauges"] = sched_gauges(eng.scheduler, METRICS)
        res["dp2_slots"] = eng.scheduler.B
        eng.close()

    # -- the bank exchange over both ranks
    import torch.distributed as dist

    banks = np.random.default_rng(12).standard_normal(BANKS).astype(np.float32)
    res["banks"] = exchange_banks(banks, group=dist.group.WORLD, device="cpu")[0].numpy()
    return res


def case_parallel4(rank: int, world: int, args: dict) -> dict:
    """The four-rank cases: tp2ep2 (the routed layer with tp-split experts,
    the engine's dense and paged streams) and dp2tp2 training."""
    import numpy as np
    import torch

    from fei_tpu_torch.engine.engine import InferenceEngine
    from fei_tpu_torch.models.configs import get_model_config
    from fei_tpu_torch.parallel.expert import moe_mlp_ep_routed
    from fei_tpu_torch.parallel.mesh import make_mesh
    from fei_tpu_torch.parallel.sharding import shard_params
    from fei_tpu_torch.utils.tree import flatten

    res: dict = {}
    P = _load_params(args["params"])
    kw = dict(device="cpu", dtype=torch.float32, num_layers=2, max_seq_len=MAX_SEQ)
    mesh = make_mesh("tp2ep2")
    moe = get_model_config("tiny-moe", num_layers=2)
    lay = shard_params(P["tiny-moe"], mesh, True)["layers"]
    lay = {k: v[0] for k, v in lay.items()}
    x = torch.from_numpy(moe_x())
    res["tp2ep2 dropless"] = moe_mlp_ep_routed(
        x, lay["router"], lay["w_gate"], lay["w_up"], lay["w_down"], moe.num_experts_per_tok,
        mesh, dropless=True, tp_axis="tp", intermediate_size=moe.intermediate_size).numpy()
    os.environ["FEI_TPU_EP_CAPACITY"] = "dropless"
    try:
        eng = InferenceEngine.from_config("tiny-moe", params=P["tiny-moe"], mesh="tp2ep2", **kw)
        res["w_up"] = tuple(eng.params["layers"]["w_up"].shape)
        if rank == 0:
            res["stream"] = eng.generate(EP_PROMPT, _gen()).token_ids
            res["tag"] = eng.mesh_tag
            eng.close()
        eng = InferenceEngine.from_config("tiny-moe", params=P["tiny-moe"], mesh="tp2ep2",
                                          paged=True, batch_size=2, **kw)
        if rank == 0:
            res["paged"] = _streams(eng)
            eng.close()
    finally:
        del os.environ["FEI_TPU_EP_CAPACITY"]
    cfg = get_model_config("tiny", num_layers=2)
    dp2tp2 = make_mesh("dp2tp2")
    losses, mine, state = _train(P["tiny"], cfg, dp2tp2, TRAIN_STEPS, 1e-4,
                                 tokens(TRAIN_SHAPE, 9))
    res["train"] = (losses, _flat_np(mine))
    res["coords"] = dict(dp2tp2.coords)
    # saved whole from the shards; each rank restores its own slices
    from fei_tpu_torch.engine.checkpoint import restore_checkpoint, save_checkpoint
    from fei_tpu_torch.engine.train import train_shardings

    ckpt = args["ckpt"]
    save_checkpoint(ckpt, TRAIN_STEPS, mine, state,
                    shardings=train_shardings(mine, cfg, dp2tp2))
    back = restore_checkpoint(ckpt, shardings=train_shardings(mine, cfg, dp2tp2),
                              device="cpu")
    res["restored_bitwise"] = _flat_np(back["params"]).keys() == _flat_np(mine).keys() and all(
        np.array_equal(a, b) for a, b in zip(_flat_np(back["params"]).values(),
                                             _flat_np(mine).values())) and all(
        torch.equal(a, b) for a, b in zip(flatten(back["opt_state"]["mu"]).values(),
                                          flatten(state["mu"]).values()))
    if rank == 0:
        res["saved_whole"] = _flat_np(restore_checkpoint(ckpt, device="cpu")["params"])
    res["fall"] = _train(P["tiny"], get_model_config("tiny"), dp2tp2, FALL_STEPS, 1e-2,
                         tokens((4, 16), 3))[0]
    return res


CASES = {
    "serving": case_serving,
    "tp2dp2": case_tp2dp2,
    "initialize": case_initialize,
    "parallel2": case_parallel2,
    "parallel4": case_parallel4,
}


def _rank_main(rank: int, world: int, port: int, case: str, args: dict, out: str,
               env_init: bool) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        if env_init:
            os.environ.update(FEI_TPU_COORDINATOR=f"127.0.0.1:{port}",
                              FEI_TPU_NUM_PROCESSES=str(world),
                              FEI_TPU_PROCESS_ID=str(rank))
            from fei_tpu_torch.parallel.distributed import initialize

            assert initialize(device_type="cpu")
        else:
            dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                    world_size=world, rank=rank)
        result = {"ok": CASES[case](rank, world, args)}
    except BaseException:  # noqa: BLE001 — the parent reports it
        result = {"error": traceback.format_exc()}
    with open(out, "wb") as f:
        pickle.dump(result, f)
    if dist.is_initialized():
        dist.destroy_process_group()


class RankRun:
    """``world`` spawned ranks of one case, running; ``result()`` waits for
    them and returns each rank's result, or raises with a failing rank's
    traceback."""

    def __init__(self, world: int, case: str, args: dict, tmpdir: str,
                 env_init: bool = False):
        import torch.multiprocessing as mp

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        self.case = case
        self.outs = [os.path.join(tmpdir, f"{case}-rank{r}.pkl") for r in range(world)]
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(r, world, port, case, args, self.outs[r], env_init))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def result(self, timeout: float = 240) -> list:
        for p in self.procs:
            p.join(timeout)
        hung = [p.pid for p in self.procs if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
        if hung:
            raise RuntimeError(f"ranks {hung} of {self.case} did not finish in {timeout} s")
        results = []
        for r, path in enumerate(self.outs):
            if not os.path.exists(path):
                raise RuntimeError(f"rank {r} of {self.case} left no result (exit code "
                                   f"{self.procs[r].exitcode})")
            with open(path, "rb") as f:
                got = pickle.load(f)
            if "error" in got:
                raise RuntimeError(f"rank {r} of {self.case} failed:\n{got['error']}")
            results.append(got["ok"])
        return results


def run_ranks(world: int, case: str, args: dict, tmpdir: str, timeout: float = 240,
              env_init: bool = False) -> list:
    """Spawn ``world`` ranks of ``case`` and return each rank's result."""
    return RankRun(world, case, args, tmpdir, env_init).result(timeout)


def parallel_results(tmp_path_factory) -> dict:
    """The two- and four-rank parallel groups' results, run once per test
    session and shared by the test files (and xdist workers) that read
    them: the first caller makes the inputs (fei_tpu's tiny weights through
    ``params_from_jax``) and runs both groups, under a file lock; the
    others read its results, or its error."""
    import fcntl

    base = Path(tmp_path_factory.getbasetemp())
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    root = base.parent / f"parallel-{uid}" if uid else base / "parallel"
    root.mkdir(parents=True, exist_ok=True)
    out = root / "results.pkl"
    with open(root / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            try:
                got = {"ok": _run_parallel(root)}
            except BaseException:  # noqa: BLE001 — every reader reports it
                got = {"error": traceback.format_exc()}
            out.write_bytes(pickle.dumps(got))
    got = pickle.loads(out.read_bytes())
    if "error" in got:
        raise RuntimeError(f"the parallel rank groups failed:\n{got['error']}")
    return got["ok"]


def _run_parallel(root: Path) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from fei_tpu.models.configs import get_model_config as jax_config
    from fei_tpu.models.llama import init_params
    from fei_tpu_torch.models.convert import params_from_jax

    names = ("tiny", "tiny-swa", "tiny-moe", "tiny-phi")
    paths = {name: str(root / f"{name}.pt") for name in names}
    # the ranks start first and wait for the weights (_load_params)
    two = RankRun(2, "parallel2", {"params": paths}, str(root))
    four = RankRun(4, "parallel4", {"params": paths, "ckpt": str(root / "ckpt")}, str(root))
    for name in names:
        params = init_params(jax_config(name, num_layers=2), jax.random.PRNGKey(0),
                             dtype=jnp.float32)
        torch.save(params_from_jax(jax.tree.map(np.asarray, params)), paths[name] + ".tmp")
        os.replace(paths[name] + ".tmp", paths[name])
    return {"two": two.result(), "four": four.result()}
