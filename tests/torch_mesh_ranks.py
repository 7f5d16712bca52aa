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

import os
import pickle
import socket
import threading
import traceback

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


CASES = {
    "serving": case_serving,
    "tp2dp2": case_tp2dp2,
    "initialize": case_initialize,
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
