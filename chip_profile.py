#!/usr/bin/env python3
"""Where the port's serving time goes on one NVIDIA GPU.

    python3 chip_profile.py [--train]

Builds the kernels, makes the same llama3-8b engine as chip_smoke.py
(full width and depth, bf16, random weights from seed 0) and traces four
windows with torch.profiler: one ~1500-token prefill (bucket 2048), 32
dense decode steps (fused chunks of 16), and on the paged path (a
1025-page pool, eight rows at chip_smoke's contexts of 96 to 5000
tokens) 8 batched decode steps and one merged dispatch (a 256-token
prefill chunk riding a decode step), with the paged kernels' (K2's in
decode, K3's in the merged dispatch) shares of kernel time. Then, with int4
weights (the same seed), it traces the prefill, the paged decode steps and
the merged dispatch again and reports the int4 kernel's (K4's) share of
kernel time beside K2's and K3's. Last, with those engines
released, it traces one training step of llama3-8b at full depth (bf16,
one sequence of 2049 ids, remat) and reports the flash kernels' shares (K1,
K5a, K5b). For each window it prints
the wall time, the device's busy share (the union of kernel intervals
over the wall time) and the kernels that took the most device time,
grouped by name; the paged windows also print their unprofiled time per
step. ``--train`` traces only the training step; a copy of this file run
from an older tree's root profiles that tree's kernels. Measurement only:
nothing here is checked beyond the card being there.
"""

from __future__ import annotations

import gc
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

TOP = 12
# K4's kernels: the decode split of K and its ordered reduction, the prefill pipeline
K4_NAMES = ("int4_mm_split", "int4_mm_reduce", "int4_mm_pipe")
# K2's and K3's kernels (one body in two libraries): the segments of a row's
# keys and their ordered combine. A paged decode window launches only K2, a
# merged dispatch only K3.
PAGED_NAMES = ("paged_attn_seg", "paged_attn_combine")


def kernel_summary(prof, wall_s: float, label: str,
                   share: str | tuple[str, ...] | None = None) -> None:
    """Print the window's kernel time, launches, busy share and top
    kernels; ``share`` names kernels (substrings of their symbols) whose
    shares of the kernel time are printed too."""
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"{label}: wall {wall_s * 1e3:.2f} ms; device time not traced")
        return
    by_name: dict[str, list[float]] = defaultdict(lambda: [0.0, 0])
    spans = []
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name][0] += us
        by_name[e.name][1] += 1
        spans.append((e.time_range.start, e.time_range.end))
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    total = sum(v[0] for v in by_name.values())
    print(f"{label}: wall {wall_s * 1e3:.2f} ms, kernel time {total / 1e3:.2f} ms "
          f"in {len(kernels)} launches, device busy {busy / 1e3:.2f} ms "
          f"({100 * busy / 1e6 / wall_s:.1f}% of wall)")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / total:5.1f}% x{n:<5d} {name[:110]}")
    for part in (share,) if isinstance(share, str) else share or ():
        us = sum(v[0] for k, v in by_name.items() if part in k)
        n = sum(v[1] for k, v in by_name.items() if part in k)
        print(f"  {part}: {us / 1e3:.3f} ms over {n} launches, {100 * us / total:.1f}% of "
              "kernel time")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}")

    from fei_tpu_torch.engine import GenerationConfig, InferenceEngine
    from fei_tpu_torch.engine.fused_decode import ChunkDecoder
    from fei_tpu_torch.ops.kernels import build

    for name in ("flash_attention_fwd", "flash_attention_bwd", "paged_attention",
                 "ragged_paged_attention", "int4_matmul"):
        build.build(name)
    if sys.argv[1:] == ["--train"]:
        train_window(card)
        return 0
    engine = InferenceEngine.from_config(
        "llama3-8b", dtype=torch.bfloat16, seed=0, max_seq_len=8192, device="cuda")
    prompt = np.random.default_rng(0).integers(8, engine.cfg.vocab_size, 1500).tolist()
    gen = GenerationConfig(max_new_tokens=33, ignore_eos=True, chunk=16)
    engine.generate(prompt, gen)  # warm-up: allocator, cuBLAS heuristics

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, _ = engine.prefill([prompt], engine.new_cache(1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernel_summary(prof, wall, f"prefill {len(prompt)} tokens (bucket 2048) on {card}",
                   share="flash_fwd")

    tok, cache, generator = engine._prefill_sample(prompt, gen)
    torch.cuda.synchronize()
    dec = ChunkDecoder(engine, gen, cache, tok, generator,
                       fed=len(prompt), chunk=16, want=32)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = sum(len(ch.tokens) for ch in dec.chunks())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernel_summary(prof, wall, f"decode {n} steps (chunk 16) on {card}")
    paged_windows(engine, card)

    # int4 weights: the prefill and one paged decode step, K4's share
    del engine, dec, cache, tok, generator, logits
    gc.collect()
    torch.cuda.empty_cache()
    engine = InferenceEngine.from_config(
        "llama3-8b", dtype=torch.bfloat16, seed=0, max_seq_len=8192, device="cuda",
        quantize="int4")
    engine.prefill([prompt], engine.new_cache(1))  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.prefill([prompt], engine.new_cache(1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernel_summary(prof, wall, f"int4 prefill {len(prompt)} tokens (bucket 2048) on {card}",
                   share=K4_NAMES + ("flash_fwd",))
    paged_windows(engine, card, "int4 ")  # K4 at the decode batch's 8 rows

    del engine
    gc.collect()
    torch.cuda.empty_cache()
    train_window(card)
    return 0


def train_window(card: str) -> None:
    """One training step of llama3-8b (full depth, bf16, T = 2048, remat),
    traced after a warm-up step: the flash kernels' shares of kernel time."""
    from fei_tpu_torch.engine.train import TrainConfig, loss_and_grads, make_train_step
    from fei_tpu_torch.models.configs import get_model_config
    from fei_tpu_torch.models.llama import init_params

    cfg = get_model_config("llama3-8b")
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    opt, step = make_train_step(cfg, TrainConfig(remat=True))
    state = opt.init(params)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(8, cfg.vocab_size, (1, 2049)))
    params, state, _ = step(params, state, tokens)  # warm-up: allocator, cuBLAS heuristics
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, _ = step(params, state, tokens)
    torch.cuda.synchronize()
    print(f"train step: {(time.perf_counter() - t0) * 1e3:.2f} ms unprofiled on {card}, "
          f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    # the step's two halves on the host clock: forward + backward, then the update
    t0 = time.perf_counter()
    _, grads = loss_and_grads(params, cfg, tokens, remat=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    opt.update(params, grads, state)
    torch.cuda.synchronize()
    print(f"train step halves: forward + backward {(t1 - t0) * 1e3:.2f} ms, optimizer update "
          f"{(time.perf_counter() - t1) * 1e3:.2f} ms on {card}")
    del grads
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, _ = step(params, state, tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernel_summary(prof, wall, f"train step, {cfg.num_layers} layers, T=2048 on {card}",
                   share=("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                          "nvjet", "elementwise_kernel", "reduce_kernel"))


def paged_windows(engine, card: str, tag: str = "") -> None:
    """8 batched paged decode steps and one merged dispatch, at the
    contexts of chip_smoke's paged traffic (pages assigned in order; the
    K/V values do not change the work)."""
    from fei_tpu_torch.engine import InferenceEngine
    from fei_tpu_torch.models.llama import forward_paged, forward_paged_merged

    paged = InferenceEngine.from_config(
        "llama3-8b", dtype=torch.bfloat16, params=engine.params, max_seq_len=8192,
        device="cuda", paged=True, batch_size=8)
    pool = paged._ensure_pool()
    lengths = [96, 160, 200, 250, 700, 1500, 3000, 5000]
    ps, nxt = paged.page_size, 1
    for b, n in enumerate(lengths):
        need = -(-(n + 64) // ps)
        pool.block_table[b, :need] = torch.arange(nxt, nxt + need, dtype=torch.int32)
        nxt += need
    chunk_row = torch.zeros_like(pool.block_table[:1])
    chunk_row[0, :20] = torch.arange(nxt, nxt + 20, dtype=torch.int32)
    base = pool._replace(lengths=torch.tensor(lengths, dtype=torch.int32, device="cuda"))
    tok = torch.zeros((8, 1), dtype=torch.long, device="cuda")
    chunk = torch.randint(8, paged.cfg.vocab_size, (1, 256), device="cuda")

    def steps(n):
        p = base
        for _ in range(n):
            logits, p = forward_paged(paged.params, paged.cfg, tok, p)
            logits.argmax(-1)

    def merged_step():
        forward_paged_merged(paged.params, paged.cfg, chunk, chunk_row, 1024, tok, base)

    windows = [(f"{tag}paged decode, 8 rows", lambda: steps(8), 8),
               (f"{tag}merged dispatch, 256-token chunk + 8 decode rows", merged_step, 1)]
    for label, fn, n in windows:
        fn()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        per = (time.perf_counter() - t0) / n
        print(f"{label}: {per * 1e3:.2f} ms per step unprofiled on {card}")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernel_summary(prof, wall, f"{label} ({n} step{'s' * (n > 1)}) on {card}",
                       share=PAGED_NAMES + (K4_NAMES if tag else ()))
    paged.close()


if __name__ == "__main__":
    sys.exit(main())
