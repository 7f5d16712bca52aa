#!/usr/bin/env python3
"""Where the port's serving time goes on one NVIDIA GPU.

    python3 chip_profile.py

Builds the kernels, makes the same llama3-8b engine as chip_smoke.py
(full width and depth, bf16, random weights from seed 0) and traces two
windows with torch.profiler: one ~1500-token prefill (bucket 2048) and
32 decode steps (fused chunks of 16). For each window it prints the wall
time, the device's busy share (the union of kernel intervals over the
wall time) and the kernels that took the most device time, grouped by
name. Measurement only: nothing here is checked beyond the card being
there.
"""

from __future__ import annotations

import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

TOP = 12


def kernel_summary(prof, wall_s: float, label: str) -> None:
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

    build.build("flash_attention_fwd")
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
    kernel_summary(prof, wall, f"prefill {len(prompt)} tokens (bucket 2048) on {card}")

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
    return 0


if __name__ == "__main__":
    sys.exit(main())
