#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (fei_tpu_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

1. Card: ``torch.cuda.is_available()`` must be true; prints the card's name
   and power limit as ``nvidia-smi`` reports them.
2. Build: compiles every kernel of the serving and training paths from the sources in
   this checkout (``fei_tpu_torch/csrc/*.cu`` -> ``build/fei_tpu_torch/``),
   one nvcc per source, all started together.
3. Kernels: holds each kernel against its plain PyTorch version on the card
   at the serving paths' shapes, element by element within its stated
   tolerance, and times kernel, plain version, one PyTorch library call
   computing the same function (a yardstick) and the bound. The paged
   kernels are also held to their bitwise identities: a ragged decode row
   equals the paged kernel at one query position, a ragged chunk group the
   paged kernel's block form, every position of a block the paged kernel
   at one query position there (what a resumed sequence relies on); their
   split of each row's keys into segments is shown to matter (a combine
   that drops a row's last segment breaks the tolerance), held at lengths
   on either side of a segment boundary and timed at several segment
   lengths. K1 is also held to row invariance (rows
   [0, 1024) of the main prefill equal a T = 1024 prefill; each row of a
   ragged batch equals itself run alone) and timed at D = 128 and D = 64,
   naming the design each head dim dispatches to; its difference from
   K2's block form on the same keys is measured and held to its tolerance.
4. Engine (dense path): llama3-8b at full width and depth (32 layers,
   h=4096, 32/8 heads, vocab 128256), bf16, random weights from a seed,
   max_seq_len 8192. A ~1500-token prefill must launch the flash kernel
   once per layer; its last-position logits are held against the same
   engine on the plain attention; 128 greedy tokens decode chunked.
5. Serve (dense path): the OpenAI-compatible server over the same engine
   answers /health and three /v1/chat/completions (one streamed).
6. Paged engine (the paged path): the same weights behind
   ``InferenceEngine(paged=True, batch_size=8)``; eight requests from eight
   threads (short prompts through dense admission, long ones chunked and
   merged with live decode), 128 greedy tokens each. The streams must not
   change with the merged dispatch off or with single-step decode; a tight
   pool must preempt and still finish every stream; chunked paged prefill
   logits are held against the dense engine's; an int8 pool must run the
   kernels' int8 branch.
7. Paged serve: the server over the paged engine answers eight concurrent
   completions (four streamed), each equal to the scheduler's own stream,
   and answers 429 with Retry-After once the waiting queue is full.
8. Agent turn (the agent path), on the same engines: ``TorchLocalProvider``
   over the 14-tool union grammar (1007 states; its int16 table padded to
   llama3-8b's vocab on the card), at the trigger the random model emits
   for its own tool prompt (a fixed point): one constrained call with
   every required argument, K1 in the turn's prefill, one host sync per
   decode chunk; ``generate_constrained`` equals the host-masked
   per-token decode. The same turn on the paged engine equals the dense
   one (or first leaves it at a tie of at most 2 bf16 ulps, as F1 allows),
   rolls the multi-step scan back at its trigger and equals its
   ``multistep = 1`` run; beside seven free requests (its chunks merged
   with their decode, K3) every stream equals its run alone. Then one
   round of the ``--message`` loop (``ui.cli.process_single_message``)
   whose registry holds the real tool schemas with recording handlers: the
   handler receives the decoded arguments, and no real tool runs.

Phase 3 also holds the int4 matmul kernel (K4) against its plain version
at llama3-8b's four linear shapes and M = 1/8/256/2048, shows that two
mutants (lo and hi planes swapped; each group read with the next group's
scale) break that bound, that two runs are bitwise equal and that row 0 is
bitwise the same at every M (the decode split of K and the prefill
pipeline sum in one order).
After the bf16 engines are released:

9. Quantized dense path: llama3-8b with int4 weights (random, the same
   seed): ``param_bytes``; a ~1500-token prefill launches K4 exactly 7
   times per layer and its logits are held against the same weights
   dequantized to bf16 and multiplied plainly; 128 greedy tokens. Then
   int8 weights: ``param_bytes``, 32 greedy tokens, no K4 launch.
10. Quantized paged path: the int4 weights behind the paged engine, four
   requests from threads; each stream must equal the dense int4 engine's,
   and must not change with the merged dispatch off or in a tight pool
   that preempts.
11. Provider: ``TorchLocalProvider`` built from the configuration with
    quantize = int4 answers one completion through the server.

Phase 3 also holds the flash backward: K1 with its logsumexp output
(``out`` bitwise the primal's, lse against the plain version, +inf for rows
with no live key), K5a (dq) and K5b (dk/dv) against the plain backward in
fp32 within ``flash_attention_bwd_tolerance`` at the training shape, a
ragged batch, unaligned lengths, a window, MHA and the other head dims, two
mutants shown to break the bound, two runs bitwise equal, each row of the
ragged batch bitwise equal to itself run alone. It names the design each
head dim dispatches to (wgmma at D 64/128, mma.sync at 80/256), times K5a,
K5b and the pair eager and as device time (CUDA graph) at the training
shape and at D = 64 beside the SDPA backward, and prints K5b's q-tile steps
per block (largest and mean). After the quantized engines are released:

12. Training (the training path): llama3-8b at full width and depth, bf16,
    random weights from the seed, ``TrainConfig(remat=True)``, one sequence
    of 2049 ids: three steps on the same batch (finite loss near ln V,
    lower at the third step; K1 twice per layer and step, K5a and K5b once).
    Then at two layers and full width: one step's gradients through the
    kernels against ``flash=False`` (autograd through the plain attention),
    and ``save_checkpoint`` -> ``restore_checkpoint`` -> one more step
    bitwise equal to the uninterrupted run's.

``python3 chip_smoke.py --paged-times`` only builds K2/K3 and times them at
every shape of phase 3 through their public wrappers; ``--bwd-times`` does
the same for K5a, K5b and the pair at the training shape and at D = 64. A
copy of this file run from an older tree's root times that tree's kernels.

Every kernel count is set to 0 just before a path is driven and read just
after. The line before the last two is the kernels' JSON record (launches
from the paged paths: K1-K3 from the bf16 run, K4 from the int4 run, K5a and
K5b from the three training steps; K1-K3 also carry ``launches_agent``, the
sum over the agent path's own runs, each counted from 0: the provider turn,
the paged turns, the paged turn beside its free neighbours and the
``--message`` round), the line before the last is the card, and the last
line is the JSON verdict.
"""

from __future__ import annotations

import gc
import itertools
import json
import math
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

SEED = 0
KERNELS = ["flash_attention_fwd", "flash_attention_bwd", "paged_attention",
           "ragged_paged_attention", "int4_matmul"]


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, from
    CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(calls, reps: int = 5) -> float:
    """Mean device time of one of ``calls`` (closures, each one launch of
    the timed function), from replays of a CUDA graph that holds them all:
    the host's Python and launch overhead, which ``cuda_ms`` includes and
    which dominates calls of a few microseconds, is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture
        for call in calls:
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for call in calls:
            call()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * len(calls))
    del graph
    return ms


# ---------------------------------------------------------------- kernels

def flash_cases():
    """(label, B, T, H, K, D, S, q_start, kv_length, window) at the shapes
    the serving path gives the kernel: the llama3-8b prefill (the main
    shape), a continuation chunk, a sliding window, the other head dims the
    presets use (qwen2-0.5b 64, phi-2 80, gemma 256) and a ragged batch."""
    return [
        ("main llama3-8b prefill", 1, 2048, 32, 8, 128, 8192, [0], [2048], 0),
        ("continuation", 1, 64, 32, 8, 128, 8192, [1000], [1064], 0),
        ("window 512", 1, 2048, 32, 8, 128, 8192, [0], [2048], 512),
        ("D=64 qwen2-0.5b", 1, 512, 14, 2, 64, 2048, [0], [512], 0),
        ("D=80 phi-2", 1, 512, 32, 32, 80, 2048, [0], [512], 0),
        ("D=256 gemma-7b", 1, 512, 16, 16, 256, 2048, [0], [512], 0),
        ("ragged B=2", 2, 512, 32, 8, 128, 2048, [0, 256], [512, 700], 0),
    ]


def flash_inputs(B, T, H, K, D, S, q_start, kv_length, gen):
    dev = "cuda"
    q = torch.randn(B, T, H, D, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(B, S, K, D, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(B, S, K, D, generator=gen, device=dev).to(torch.bfloat16)
    qs = torch.tensor(q_start, dtype=torch.int32, device=dev)
    kl = torch.tensor(kv_length, dtype=torch.int32, device=dev)
    return q, k, v, qs, kl


def flash_bound_ms(q, k, q_start, kv_length, window, products=2, q_like=2, kv_like=2,
                   kv_out=0, stats=0):
    """Least time for this call's work: live (query, key) pairs times
    2*D FLOP per head and product at the bf16 peak, against the bytes moved
    once at the memory rate; the larger of the two, and which it is. The
    forward (the defaults) does two products and moves q, o and the live
    k/v rows; the backward kernels do three (dq) or four (dk/dv) and move
    ``q_like`` tensors shaped like q, ``kv_like`` live k/v inputs,
    ``kv_out`` whole k/v-shaped outputs and ``stats`` fp32 [B,H,T] rows."""
    from fei_tpu_torch.ops.attention import visible_mask

    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    pos = q_start.long()[:, None] + torch.arange(T, device=q.device)[None, :]
    vis = visible_mask(pos, kv_length, S, window)  # [B, T, S]
    pairs = int(vis.sum())
    live_keys = int(vis.any(dim=1).sum())
    flops = 2.0 * products * D * H * pairs
    nbytes = (2.0 * (q_like * q.numel() + kv_like * live_keys * K * D + kv_out * k.numel())
              + 4.0 * stats * B * H * T)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def kernel_phase(card: str) -> dict:
    import torch.nn.functional as F

    from fei_tpu_torch.ops.kernels.flash_attention import (
        flash_attention,
        flash_attention_reference,
        flash_attention_tolerance,
        kernel_design,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    record = None
    ms_by_d = {}
    for label, B, T, H, K, D, S, qs_l, kl_l, window in flash_cases():
        q, k, v, qs, kl = flash_inputs(B, T, H, K, D, S, qs_l, kl_l, gen)
        out = flash_attention(q, k, v, qs, kl, window=window)
        torch.cuda.synchronize()
        # the plain version in fp32 on the same bf16 inputs
        ref = flash_attention_reference(q.float(), k.float(), v.float(), qs, kl,
                                        window=window)
        # tolerance, element by element: the kernel rounds each softmax
        # weight to bf16 before the P.V product (as the Pallas kernel does)
        # and rounds the output to bf16; flash_attention_tolerance bounds
        # both by each element's own size (its docstring gives the reason).
        # A bound from the largest output alone would exceed most outputs
        # of a long causal row and let a wrong kernel pass.
        tol = flash_attention_tolerance(q, k, v, qs, kl, window=window)
        diff = (out.float() - ref).abs()
        err = diff.max().item()
        worst = (diff / tol).max().item()
        log(f"kernel flash_attention_fwd [{label}] B={B} T={T} H={H} K={K} "
            f"D={D} S={S} q_start={qs_l} kv_length={kl_l} window={window}: "
            f"max_abs_err={err:.6g}, worst err/tol {worst:.4g} "
            f"(median tol {tol.median().item():.4g}, |out|max {ref.abs().max().item():.4g})")
        check(torch.isfinite(out).all().item(), f"{label}: non-finite output")
        check(worst <= 1.0, f"{label}: error exceeds its tolerance by {worst:.4g}x")
        # the same bound would catch attention that sees one key more per
        # row: a causal (and, with a window, a window) check off by one
        one_more = flash_attention_reference(q.float(), k.float(), v.float(), qs + 1, kl,
                                             window=window + (window > 0))
        caught = ((one_more - ref).abs() > tol).float().mean().item()
        check(caught > 0, f"{label}: the tolerance cannot see one key more per row")
        log(f"kernel flash_attention_fwd [{label}]: one key more per row "
            f"breaks the tolerance at {caught:.2%} of the elements")
        del one_more, tol, diff
        row_invariance(label, out, q, k, v, qs, kl, window)
        if label.startswith("D=64"):  # the other head dim of the wgmma design
            ms_by_d[64] = (cuda_ms(lambda: flash_attention(q, k, v, qs, kl, window=window)),
                           graph_ms([lambda: flash_attention(q, k, v, qs, kl, window=window)] * 20))
            log(f"kernel flash_attention_fwd [{label}] on {card}: {ms_by_d[64][0]:.4f} ms "
                f"({ms_by_d[64][1]:.4f} ms device time, CUDA graph), design {kernel_design(D)}")
        if record is None:  # the main shape: time it
            ms = cuda_ms(lambda: flash_attention(q, k, v, qs, kl, window=window))
            device_ms = graph_ms([lambda: flash_attention(q, k, v, qs, kl, window=window)] * 20)
            plain_ms = cuda_ms(
                lambda: flash_attention_reference(q, k, v, qs, kl, window=window),
                iters=5, warmup=1,
            )
            # yardstick only (never called by the port): SDPA on the live
            # k/v prefix, which for a causal prefill from 0 is the same
            # function; its inputs are head-major copies made outside the
            # timed region
            L = kl_l[0]
            qt = q.transpose(1, 2).contiguous()
            kt = k[:, :L].transpose(1, 2).contiguous()
            vt = v[:, :L].transpose(1, 2).contiguous()
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
            lib_device_ms = graph_ms([lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)] * 20)
            bound_ms, bound_by = flash_bound_ms(q, k, qs, kl, window)
            ms_by_d[128] = (ms, device_ms)
            log(f"kernel flash_attention_fwd [{label}] on {card}: design {kernel_design(D)}, "
                f"{ms:.4f} ms ({device_ms:.4f} ms device time, CUDA graph), "
                f"plain {plain_ms:.4f} ms, "
                f"scaled_dot_product_attention {lib_ms:.4f} ms ({lib_device_ms:.4f} ms "
                f"device time), bound {bound_ms:.4f} ms ({bound_by})")
            record = {
                "name": "flash_attention_fwd",
                "route": "cuda",
                "source": "fei_tpu_torch/csrc/flash_attention_fwd.cu",
                "replaces": "fei_tpu/ops/pallas/flash_attention.py:52",
                "launches": 0,
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": lib_ms,
                # "ms" and "library_ms" are eager, as for every kernel; these
                # two are device time from CUDA-graph replays
                "device_ms": device_ms,
                "library_device_ms": lib_device_ms,
                "design": kernel_design(D),
            }
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    record["designs"] = {str(d): kernel_design(d) for d in (64, 80, 128, 256)}
    record["ms_d64"], record["device_ms_d64"] = ms_by_d[64]
    log(f"kernel flash_attention_fwd: D=128 {ms_by_d[128][0]:.4f} ms ({kernel_design(128)}), "
        f"D=64 {ms_by_d[64][0]:.4f} ms ({kernel_design(64)}); D=80 and D=256 run "
        f"{kernel_design(80)}")
    return record


def row_invariance(label, out, q, k, v, qs, kl, window):
    """K1's rows must not depend on T or on the other rows of the batch:
    rows [0, 1024) of the main prefill equal a 1024-token prefill on the
    same cache, and each row of a ragged batch equals that row run alone."""
    from fei_tpu_torch.ops.kernels.flash_attention import flash_attention

    if label.startswith("main"):
        half = flash_attention(q[:, :1024].contiguous(), k, v, qs,
                               torch.full_like(kl, 1024), window=window)
        check(torch.equal(half, out[:, :1024]),
              f"{label}: rows [0, 1024) differ from a T = 1024 call on the same cache")
        log(f"kernel flash_attention_fwd [{label}]: rows [0, 1024) bitwise equal to a "
            f"T = 1024 prefill on the same cache")
    elif label.startswith("ragged"):
        for b in range(q.shape[0]):
            alone = flash_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1], qs[b:b + 1],
                                    kl[b:b + 1], window=window)
            check(torch.equal(alone, out[b:b + 1]),
                  f"{label}: batch row {b} differs from the same row run alone")
        log(f"kernel flash_attention_fwd [{label}]: every batch row bitwise equal to "
            f"itself run alone with B = 1")


# ---------------------------------------------------------- flash backward

MUTANT_FLOOR = 0.05  # least share of a leaf's elements at which a mutant must break the bound


def flash_bwd_cases():
    """(label, B, T, H, K, D, S, q_start, kv_length, window): the training
    shape (llama3-8b, one sequence of 2048), a ragged batch offset into a
    longer buffer, unaligned lengths, a window that bites at mistral-7b's
    widths, MHA at D=64, the other head dims, and a batch row with no live
    key at all."""
    return [
        ("train llama3-8b", 1, 2048, 32, 8, 128, 2048, [0], [2048], 0),
        ("ragged B=2", 2, 512, 32, 8, 128, 1024, [0, 256], [512, 700], 0),
        ("unaligned", 1, 333, 8, 2, 128, 555, [100], [433], 0),
        ("window 1024 mistral-7b widths", 1, 4096, 32, 8, 128, 4096, [0], [4096], 1024),
        ("MHA D=64", 1, 512, 16, 16, 64, 512, [0], [512], 0),
        ("D=80 phi-2", 1, 512, 32, 32, 80, 512, [0], [512], 0),
        ("D=256 gemma-7b", 1, 512, 16, 16, 256, 512, [0], [512], 0),
        ("dead row", 2, 256, 8, 2, 128, 512, [0, 0], [256, 0], 0),
    ]


def flash_bwd_times(q, k, v, qs, kl, out, lse, dout, window=0) -> dict:
    """Eager ``ms`` (CUDA events around back-to-back calls) and
    ``device_ms`` (CUDA-graph replays) of K5a, K5b and the pair (both
    kernels and the row sums: ``flash_attention_bwd``) through the public
    wrappers, which an older tree has too."""
    from fei_tpu_torch.ops.kernels.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
    )

    dsum = (dout.float() * out).sum(-1).permute(0, 2, 1).contiguous()
    kargs = (q, k, v, qs, kl, lse, dsum, dout)
    calls = {"dq": lambda: flash_attention_bwd_dq(*kargs, window=window),
             "dkv": lambda: flash_attention_bwd_dkv(*kargs, window=window),
             "pair": lambda: flash_attention_bwd(q, k, v, qs, kl, out, lse, dout,
                                                 window=window)}
    times = {}
    for name, call in calls.items():
        times[f"{name}_ms"] = cuda_ms(call)
        times[f"{name}_device_ms"] = graph_ms([call] * 10)
    return times


def sdpa_bwd_times(q, k, v, dout) -> tuple[float, float]:
    """The yardstick (never called by the port): the backward of causal
    SDPA on head-major copies made outside the timed region; one call gives
    dq, dk and dv. Eager: ``autograd.grad`` on a retained forward. Device
    time: CUDA-graph replays of forward + backward less those of the
    forward alone (a graph cannot hold a backward without its forward)."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    dot = dout.transpose(1, 2).contiguous()

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    o = fwd()
    eager = cuda_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True))
    del o
    both = graph_ms([lambda: torch.autograd.grad(fwd(), (qt, kt, vt), dot)] * 10)
    with torch.no_grad():
        alone = graph_ms([fwd] * 10)
    return eager, both - alone


def flash_bwd_kernel_phase(card: str) -> list[dict]:
    """K1 with its logsumexp output, K5a and K5b at ``flash_bwd_cases``;
    returns K5a's and K5b's records, timed at the training shape (and at
    D = 64, the other head dim of the wgmma design)."""
    from fei_tpu_torch.ops.kernels.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_dkv_block_steps,
        flash_attention_bwd_dkv_steps,
        flash_attention_bwd_reference,
        flash_attention_bwd_tolerance,
        flash_attention_fwd,
        flash_attention_reference,
        kernel_design,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    records = []
    d64 = None
    for label, B, T, H, K, D, S, qs_l, kl_l, window in flash_bwd_cases():
        q, k, v, qs, kl = flash_inputs(B, T, H, K, D, S, qs_l, kl_l, gen)
        dout = torch.randn(B, T, H, D, generator=gen, device="cuda").to(torch.bfloat16)
        # K1 with the logsumexp: the primal's output bitwise; lse within 1e-4
        # of the plain version's (values near 10 in fp32: sums in another
        # order, exp2 and log against exp and logsumexp) and +inf exactly
        # where no key is live
        out, lse = flash_attention_fwd(q, k, v, qs, kl, window=window)
        torch.cuda.synchronize()
        check(torch.equal(out, flash_attention(q, k, v, qs, kl, window=window)),
              f"{label}: K1 with lse does not give the primal's output bitwise")
        _, lse_ref = flash_attention_reference(q.float(), k.float(), v.float(), qs, kl,
                                               window=window, return_lse=True)
        check(torch.equal(torch.isposinf(lse), torch.isposinf(lse_ref)),
              f"{label}: lse is +inf at other rows than the plain version's")
        finite = torch.isfinite(lse_ref)
        lse_err = (lse[finite] - lse_ref[finite]).abs().max().item()
        check(lse_err <= 1e-4, f"{label}: lse differs by {lse_err:.3g} > 1e-4")
        n_inf = int(torch.isposinf(lse).sum())
        if label == "dead row":
            check(n_inf == H * T, f"dead row: {n_inf} +inf rows, expected {H * T}")

        grads = flash_attention_bwd(q, k, v, qs, kl, out, lse, dout, window=window)
        torch.cuda.synchronize()
        # the plain backward in fp32 on the same bf16 values and the same
        # residuals. Tolerance, element by element: the kernels round ds
        # (dq, dk) and p (dv) to bf16 before the products, as the Pallas
        # kernels do, and the results to bf16; flash_attention_bwd_tolerance
        # bounds both by each element's own size (its docstring gives the
        # reason)
        f32 = (q.float(), k.float(), v.float(), qs, kl, out.float(), lse, dout.float())
        refs = flash_attention_bwd_reference(*f32, window=window)
        tols, cancels = flash_attention_bwd_tolerance(q, k, v, qs, kl, out, lse, dout,
                                                      window=window, return_cancel=True)
        # the share of each bound that the term for cancelling row sums
        # supplies (dv has none): printed so that a later widening shows
        cancel_share = [(c / t.clamp_min(1e-30)).mean().item()
                        for c, t in zip(cancels[:2], tols[:2])]
        del cancels
        errs, worsts = {}, {}
        for name, g, r, tol in zip(("dq", "dk", "dv"), grads, refs, tols):
            check(torch.isfinite(g).all().item(), f"{label}: non-finite {name}")
            diff = (g.float() - r).abs()
            errs[name], worsts[name] = diff.max().item(), (diff / tol).max().item()
            check(worsts[name] <= 1.0,
                  f"{label}: {name} exceeds its tolerance by {worsts[name]:.4g}x, at "
                  f"{(diff > tol).float().mean().item():.3%} of the elements")
        if label == "dead row":
            check(not (grads[0][1].any() or grads[1][1].any() or grads[2][1].any()),
                  "dead row: a row with no live key has non-zero gradients")
        if kl_l[0] < S:  # keys past kv_length get zero dk and dv
            check(not (grads[1][0, kl_l[0]:].any() or grads[2][0, kl_l[0]:].any()),
                  f"{label}: keys past kv_length have non-zero dk or dv")
        # the bound must see a wrong backward: ds without the row-sum term
        # (dq and dk; dv does not read it), and one key more per row. Seen
        # means at MUTANT_FLOOR of the elements of every leaf it touches,
        # at every shape: a bound loose enough to pass a wrong kernel
        # almost everywhere fails here, not only one that passes it
        # everywhere
        caught = {}
        for mutant, leaves in (("no_dsum", (0, 1)), ("one_more", (0, 1, 2))):
            wrong = flash_attention_bwd_reference(*f32, window=window, mutant=mutant)
            caught[mutant] = min(((wrong[i] - refs[i]).abs() > tols[i]).float().mean().item()
                                 for i in leaves)
            del wrong
            check(caught[mutant] >= MUTANT_FLOOR,
                  f"{label}: the tolerance sees {mutant} at {caught[mutant]:.2%} of a leaf's "
                  f"elements only, under the floor of {MUTANT_FLOOR:.0%}")
        again = flash_attention_bwd(q, k, v, qs, kl, out, lse, dout, window=window)
        check(all(torch.equal(a, b) for a, b in zip(grads, again)),
              f"{label}: two runs of the backward differ")
        rows_alone = ""
        if label.startswith("ragged"):
            # a batch row's sums must not depend on the schedule of the
            # others: each row bitwise equal to itself run with B = 1
            for b in range(B):
                one = slice(b, b + 1)
                alone = flash_attention_bwd(q[one], k[one], v[one], qs[one], kl[one], out[one],
                                            lse[one].contiguous(), dout[one], window=window)
                check(all(torch.equal(a, g[one]) for a, g in zip(alone, grads)),
                      f"{label}: batch row {b}'s gradients differ from the row run alone")
            rows_alone = "; every batch row's dq, dk, dv bitwise equal to the row run alone"
        walked = ""
        if kernel_design(D) == "wgmma":
            # the steps K5b's blocks walked, as the kernel counts them: the
            # schedule's, for the cluster size the launch picked
            dsum = (dout.float() * out).sum(-1).permute(0, 2, 1).contiguous()
            steps = flash_attention_bwd_dkv_block_steps(q, k, v, qs, kl, lse, dsum, dout,
                                                        window=window)
            units = -(-S // 256) * K * B
            cluster = len(steps) // units
            check(len(steps) == cluster * units and cluster in (2, 4, 8)
                  and steps == flash_attention_bwd_dkv_steps(T, S, H, K, D, qs_l, kl_l, window,
                                                             cluster),
                  f"{label}: the dk/dv kernel's blocks walked other steps than its schedule's")
            walked = (f"; dk/dv clusters of {cluster}, q-tile steps per block as the kernel "
                      f"counts them: largest {max(steps)}, mean {sum(steps) / len(steps):.2f} "
                      f"over {len(steps)} blocks (the schedule's)")
            del dsum
        log(f"kernel flash_attention_bwd [{label}] B={B} T={T} H={H} K={K} D={D} S={S} "
            f"q_start={qs_l} kv_length={kl_l} window={window}: lse max_abs_err={lse_err:.3g} "
            f"({n_inf} +inf rows); max_abs_err dq/dk/dv "
            f"{errs['dq']:.4g}/{errs['dk']:.4g}/{errs['dv']:.4g}, worst err/tol "
            f"{worsts['dq']:.4g}/{worsts['dk']:.4g}/{worsts['dv']:.4g}; mutants break the "
            f"tolerance at {caught['no_dsum']:.2%} (no row-sum term) and "
            f"{caught['one_more']:.2%} (one key more) of the elements at least (floor "
            f"{MUTANT_FLOOR:.0%}); the cancelling-sums term is {cancel_share[0]:.2%} of dq's "
            f"bound and {cancel_share[1]:.2%} of dk's on average; two runs bitwise equal"
            f"{rows_alone}; design {kernel_design(D)}{walked}")
        del refs, tols, again, f32, lse_ref
        if label.startswith("MHA D=64"):  # the other head dim of the wgmma design
            d64 = flash_bwd_times(q, k, v, qs, kl, out, lse, dout, window)
            log(f"kernel flash_attention_bwd [{label}] on {card}: design "
                f"{kernel_design(D)}, dq {d64['dq_ms']:.4f} ms ({d64['dq_device_ms']:.4f} "
                f"device), dk/dv {d64['dkv_ms']:.4f} ms ({d64['dkv_device_ms']:.4f} device)")
        if not records:  # the training shape: time it
            t = flash_bwd_times(q, k, v, qs, kl, out, lse, dout, window)
            lse_ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, qs, kl, window=window))
            fwd_ms = cuda_ms(lambda: flash_attention(q, k, v, qs, kl, window=window))
            # the plain version computes dq, dk and dv in one pass
            plain_ms = cuda_ms(lambda: flash_attention_bwd_reference(
                q, k, v, qs, kl, out, lse, dout, window=window), iters=3, warmup=1)
            lib_ms, lib_device_ms = sdpa_bwd_times(q, k, v, dout)
            dq_bound = flash_bound_ms(q, k, qs, kl, window, products=3, q_like=3,
                                      kv_like=2, stats=2)
            dkv_bound = flash_bound_ms(q, k, qs, kl, window, products=4, q_like=2,
                                       kv_like=2, kv_out=2, stats=2)
            log(f"kernel flash_attention_bwd [{label}] on {card}: design "
                f"{kernel_design(D)}; dq {t['dq_ms']:.4f} ms ({t['dq_device_ms']:.4f} "
                f"device; bound {dq_bound[0]:.4f} ms, {dq_bound[1]}), dk/dv {t['dkv_ms']:.4f} "
                f"ms ({t['dkv_device_ms']:.4f} device; bound {dkv_bound[0]:.4f} ms, "
                f"{dkv_bound[1]}), the whole backward with its row sums {t['pair_ms']:.4f} ms "
                f"({t['pair_device_ms']:.4f} device); plain backward {plain_ms:.4f} ms; "
                f"backward of scaled_dot_product_attention {lib_ms:.4f} ms ({lib_device_ms:.4f} "
                f"device); K1 with lse {lse_ms:.4f} ms against {fwd_ms:.4f} ms without")
            for name, line, which, bound, err in (
                    ("flash_attention_bwd_dq", 275, "dq", dq_bound, errs["dq"]),
                    ("flash_attention_bwd_dkv", 345, "dkv", dkv_bound,
                     max(errs["dk"], errs["dv"]))):
                records.append({
                    "name": name, "route": "cuda",
                    "source": "fei_tpu_torch/csrc/flash_attention_bwd.cu",
                    "replaces": f"fei_tpu/ops/pallas/flash_attention.py:{line}",
                    "launches": 0, "max_abs_err": err, "ms": t[f"{which}_ms"],
                    "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
                    "library_ms": lib_ms,
                    # plain_ms and library_ms are of one pass that gives all
                    # three gradients: hold them against pair_ms (both
                    # kernels and the row sums), not against one kernel's ms.
                    # "ms", "pair_ms" and "library_ms" are eager; the
                    # *device_ms keys are device time from CUDA-graph replays
                    "plain_covers": "dq+dk+dv", "library_covers": "dq+dk+dv",
                    "pair_ms": t["pair_ms"], "device_ms": t[f"{which}_device_ms"],
                    "pair_device_ms": t["pair_device_ms"], "library_device_ms": lib_device_ms,
                    "design": kernel_design(D),
                })
        del q, k, v, dout, out, lse, grads
        torch.cuda.empty_cache()
    for rec, which in zip(records, ("dq", "dkv")):
        rec["designs"] = {str(d): kernel_design(d) for d in (64, 80, 128, 256)}
        rec["ms_d64"], rec["device_ms_d64"] = d64[f"{which}_ms"], d64[f"{which}_device_ms"]
    return records


def bwd_time_cases():
    """The shapes ``--bwd-times`` takes: the training shape, the training
    shapes of the D = 64 models (one sequence of 2048 at their head
    counts) and the MHA D = 64 case of ``flash_bwd_cases``."""
    cases = flash_bwd_cases()
    return [cases[0],
            ("train qwen2-0.5b", 1, 2048, 14, 2, 64, 2048, [0], [2048], 0),
            ("train llama3-1b", 1, 2048, 32, 8, 64, 2048, [0], [2048], 0),
            cases[4]]


def bwd_times(card: str) -> None:
    """``--bwd-times``: K5a, K5b and the pair at ``bwd_time_cases`` through
    the public wrappers, eager and device time. Run from an older tree's
    root it times that tree's kernels."""
    from fei_tpu_torch.ops.kernels.flash_attention import flash_attention_fwd

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    for label, B, T, H, K, D, S, qs_l, kl_l, window in bwd_time_cases():
        q, k, v, qs, kl = flash_inputs(B, T, H, K, D, S, qs_l, kl_l, gen)
        dout = torch.randn(B, T, H, D, generator=gen, device="cuda").to(torch.bfloat16)
        out, lse = flash_attention_fwd(q, k, v, qs, kl, window=window)
        t = flash_bwd_times(q, k, v, qs, kl, out, lse, dout, window)
        log(f"bwd times [{label}] on {card}: dq {t['dq_ms']:.4f} ms ({t['dq_device_ms']:.4f} "
            f"device), dk/dv {t['dkv_ms']:.4f} ({t['dkv_device_ms']:.4f} device), pair "
            f"{t['pair_ms']:.4f} ({t['pair_device_ms']:.4f} device)")
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()


# ---------------------------------------------------------- paged kernels

PAGE = 64


def paged_pool(n_pages, K, D, int8, gen):
    """A random pool [P, K, 64, D]: bf16 values, or int8 values with
    per-slot scales as the engine's quantizer makes them."""
    from fei_tpu_torch.engine.paged_cache import quant_kv_rows

    k = torch.randn(n_pages, K, PAGE, D, generator=gen, device="cuda")
    v = torch.randn(n_pages, K, PAGE, D, generator=gen, device="cuda")
    if not int8:
        return k.bfloat16(), v.bfloat16(), None, None
    kq, ks = quant_kv_rows(k)
    vq, vs = quant_kv_rows(v)
    return kq, vq, ks[:, :, None, :].contiguous(), vs[:, :, None, :].contiguous()


def paged_table(lengths, width, n_pages, seed):
    """Block table of rows owning ceil(len/64) pages each, drawn from a
    random permutation of the pool (non-contiguous pages; page 0 is the
    null page)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((len(lengths), width), dtype=np.int32)
    used = 0
    for b, n in enumerate(lengths):
        need = -(-n // PAGE)
        bt[b, :need] = perm[used:used + need]
        used += need
    return torch.from_numpy(bt).cuda()


def paged_bound_ms(q, block_table, limits, q_lens, K, int8, window):
    """Least time for one paged-attention call: the distinct live pages'
    K/V (and int8 scales) read once plus q and o, at the memory rate,
    against 4*D FLOP per visible (query head, key) pair at the bf16 peak;
    the larger of the two, and which it is."""
    Bv, R, H, D = q.shape
    bt = block_table.cpu().numpy()
    lim = limits.cpu().numpy().astype(np.int64)
    ql = q_lens.cpu().numpy().astype(np.int64)
    pages, pairs, live_rows = set(), 0, 0
    for b in range(Bv):
        if ql[b] <= 0:
            continue
        live_rows += ql[b]
        for t in range(ql[b]):
            hi = lim[b] + t
            lo = max(0, hi - window) if window else 0
            pairs += hi - lo
        hi = lim[b] + ql[b] - 1
        lo = max(0, lim[b] - window) if window else 0
        for pi in range(lo // PAGE, (hi - 1) // PAGE + 1):
            pages.add(int(bt[b, pi]))
    per_page = 2 * K * PAGE * D * (1 if int8 else 2) + (2 * K * PAGE * 4 if int8 else 0)
    nbytes = len(pages) * per_page + 2 * 2 * live_rows * H * D
    flops = 4.0 * D * H * pairs
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def sdpa_yardstick(q, k_pages, v_pages, block_table, limits, q_lens, window,
                   k_scales=None, v_scales=None):
    """One ``scaled_dot_product_attention`` call computing the same rows on
    a contiguous bf16 copy of each row's live K/V (dequantized, for an int8
    pool), made outside the timed region (the port never calls it).
    Returns the timing closure."""
    import torch.nn.functional as F

    from fei_tpu_torch.ops.attention import visible_mask
    from fei_tpu_torch.ops.kernels.paged_attention import gather_pages

    Bv, R, H, D = q.shape
    n = int(((limits + q_lens.clamp(min=1) - 1).max().item() + PAGE - 1) // PAGE)
    kc, vc = gather_pages(k_pages, v_pages, block_table, n, k_scales, v_scales)
    kt, vt = (c.to(q.dtype).transpose(1, 2).contiguous() for c in (kc, vc))
    qt = q.transpose(1, 2).contiguous()
    pos = (limits.long() - 1)[:, None] + torch.arange(R, device=q.device)[None, :]
    mask = visible_mask(pos, limits.long() + R - 1, kt.shape[2], window)[:, None]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)


def paged_case_check(label, out, q, kp, vp, bt, limits, q_lens, ks, vs, window):
    """Element-by-element check against the plain version in fp32 within
    ``paged_rows_tolerance``, and proof that the bound would catch
    attention that sees one key more per row and a split whose combine
    drops each row's last segment. Returns max_abs_err."""
    from fei_tpu_torch.ops.kernels.paged_attention import (
        paged_rows_plain,
        paged_rows_split,
        paged_rows_tolerance,
    )

    kf = kp if ks is not None else kp.float()
    vf = vp if ks is not None else vp.float()
    ref = paged_rows_plain(q.float(), kf, vf, bt, limits, q_lens,
                           k_scales=ks, v_scales=vs, window=window)
    # tolerance, element by element: the kernel rounds each softmax weight
    # (times its v scale, for int8 pools) to bf16 before the P.V product
    # and rounds the output to bf16 — paged_rows_tolerance bounds both by
    # each element's own size on the gathered contiguous view
    tol = paged_rows_tolerance(q, kp, vp, bt, limits, q_lens, k_scales=ks,
                               v_scales=vs, window=window)
    diff = (out.float() - ref).abs()
    err = diff.max().item()
    worst = (diff / tol).max().item()
    check(torch.isfinite(out).all().item(), f"{label}: non-finite output")
    check(worst <= 1.0, f"{label}: error exceeds its tolerance by {worst:.4g}x")
    one_more = paged_rows_plain(q.float(), kf, vf, bt, limits + 1, q_lens,
                                k_scales=ks, v_scales=vs,
                                window=window + (window > 0))
    caught = ((one_more - ref).abs() > tol).float().mean().item()
    check(caught > 0, f"{label}: the tolerance cannot see one key more per row")
    # the split's mutant: each row's last segment left out of the combine,
    # judged on the rows whose keys span several segments (where there are any)
    dropped = paged_rows_split(q.float(), kf, vf, bt, limits, q_lens, k_scales=ks,
                               v_scales=vs, window=window, mutant="drop_last")
    multi = multi_segment_rows(limits, q_lens, q.shape[1], bt.shape[1], window)
    broken = ((dropped - ref).abs() > tol)[multi if multi.any() else slice(None)]
    dropped_caught = broken.float().mean().item()
    check(dropped_caught > 0, f"{label}: the tolerance cannot see a dropped segment")
    log(f"kernel [{label}]: max_abs_err={err:.6g}, worst err/tol {worst:.4g}; "
        f"one key more per row breaks the tolerance at {caught:.2%} of the elements; "
        f"a dropped last segment at {dropped_caught:.2%} of the elements of the "
        f"{int(multi.sum())} rows that span several segments")
    return err


def multi_segment_rows(limits, q_lens, R: int, width: int, window: int):
    """[B, R] bool: live query rows whose visible keys span more than one
    segment of the kernels' split."""
    from fei_tpu_torch.ops.kernels.paged_attention import SEGMENT_PAGES

    t = torch.arange(R, device=limits.device)[None, :]
    hi = (limits.long()[:, None] + t).clamp(max=width * PAGE)
    lo = (hi - window).clamp(min=0) if window else torch.zeros_like(hi)
    span = PAGE * SEGMENT_PAGES
    live = (t < q_lens.long()[:, None]) & (hi > lo)
    return live & ((hi - 1) // span > lo // span)


def decode_equals_block_rows(label, blk, qb, kp, vp, bt_row, before, ks, vs, window=0):
    """R invariance: every position p of a block (K2's block form) is
    bitwise the decode kernel (K2 at qt = 1) run for one query at p, as a
    preempted sequence rebuilt through chunks relies on. One decode call
    takes the block's T positions as T rows of the same table row."""
    from fei_tpu_torch.ops.kernels.paged_attention import paged_attention

    T = qb.shape[1]
    lengths = (before + 1 + torch.arange(T, device="cuda")).int()
    one = paged_attention(qb[0], kp, vp, bt_row.expand(T, -1).contiguous(), lengths,
                          k_scales=ks, v_scales=vs, window=window)
    same = (one == blk[0]).flatten(1).all(dim=1)
    check(bool(same.all()), f"{label}: positions {(~same).nonzero().flatten()[:8].tolist()} "
          "of the block differ from the decode kernel at the same position")
    segs = multi_segment_rows(lengths, torch.ones_like(lengths), 1, bt_row.shape[1], window)
    log(f"kernel [{label}]: each of the {T} positions bitwise the decode kernel at that "
        f"position ({int(segs.sum())} of them span several segments)")


def k1_against_k2(q, blk, k_pages, v_pages, table, before: int) -> None:
    """K1 against K2's block form on the same keys: the T queries of a
    chunk at positions [before, before + T) over a contiguous copy of the
    row's pages. The wgmma K1 and the mma.sync K2 may round apart, so this
    measures their difference (the scheduler never mixes the two routes in
    one sequence's K/V) and holds it to K1's tolerance."""
    from fei_tpu_torch.ops.kernels.flash_attention import (
        flash_attention,
        flash_attention_tolerance,
    )
    from fei_tpu_torch.ops.kernels.paged_attention import gather_pages

    T = q.shape[1]
    kc, vc = gather_pages(k_pages, v_pages, table, -(-(before + T) // PAGE))
    kc, vc = kc.contiguous(), vc.contiguous()
    qs = torch.tensor([before], dtype=torch.int32, device="cuda")
    k1 = flash_attention(q, kc, vc, qs, qs + T)
    diff = (k1.float() - blk.float()).abs()
    _, exp = torch.frexp(torch.maximum(k1.float().abs(), blk.float().abs()).clamp_min(2.0 ** -126))
    ulps = diff / torch.ldexp(torch.ones_like(diff), exp - 8)
    tol = flash_attention_tolerance(q, kc, vc, qs, qs + T)
    check(bool((diff <= tol).all()), f"K1 against K2's block form (T={T}): "
          f"a difference beyond K1's tolerance (max {diff.max().item():.6g})")
    rows = int((diff.amax(dim=(2, 3)) > 0).sum())
    n_diff = int((diff > 0).sum())
    one_ulp = int(((diff > 0) & (ulps <= 1)).sum())
    log(f"kernel K1 against paged_attention_block (T={T}, the same keys): "
        f"{'bitwise equal' if rows == 0 else 'differ'}; {n_diff} of {diff.numel()} "
        f"elements in {rows} of {T} rows differ, {one_ulp} of them by one bf16 ulp of "
        f"the element; max |diff| {diff.max().item():.6g}, at most "
        f"{ulps.max().item():.3g} ulps of an element, {(diff / tol).max().item():.4g} "
        f"of K1's tolerance")
    del kc, vc, k1, diff, ulps, tol


# the paged kernels' shapes: llama3-8b decode, B=8, H=32, K=8, D=128, a
# table-width-128 pool, mixed lengths over non-contiguous pages; the other
# head dims the presets use; decode rows one below, at and one above the
# kernels' segment boundaries (SEGMENT_PAGES pages of 64 keys)
PAGED_SHAPE = dict(B=8, H=32, K=8, D=128, width=128)
PAGED_LENGTHS = [100, 700, 1500, 2500, 3500, 5000, 6500, 8000]
PAGED_HEAD_DIMS = (("D=64 qwen2-0.5b", 14, 2, 64), ("D=80 phi-2", 32, 32, 80),
                   ("D=256 gemma-7b", 16, 16, 256))
PAGED_OTHER_LENGTHS = [100, 900, 2000, 3000]
SEG_SWEEP = (4, 8, 16, 32, 128)  # segment lengths timed beside the one in use


def boundary_lengths() -> list[int]:
    from fei_tpu_torch.ops.kernels.paged_attention import SEGMENT_PAGES

    edge = SEGMENT_PAGES * PAGE
    return [edge - 1, edge, edge + 1, 2 * edge - 1, 2 * edge, 2 * edge + 1, PAGE, 1]


def merged_inputs(q, chunk_q, bt, ln, row: int, chunk_start: int, R: int = 8):
    """K3's merged-dispatch shape: the decode rows plus a chunk of row
    ``row`` starting at ``chunk_start``, in groups of R (the scheduler's)."""
    B, H, D = q.shape
    nG = chunk_q.shape[1] // R
    i32 = dict(dtype=torch.int32, device="cuda")
    qv = torch.cat([torch.nn.functional.pad(q[:, None], (0, 0, 0, 0, 0, R - 1)),
                    chunk_q.reshape(nG, R, H, D)]).contiguous()
    btv = torch.cat([bt, bt[row:row + 1].expand(nG, -1)]).contiguous()
    limits = torch.cat([ln, chunk_start + 1 + R * torch.arange(nG, **i32)]).int()
    q_lens = torch.tensor([1] * B + [R] * nG, **i32)
    modes = torch.tensor([1] * B + [0] * nG, **i32)
    return qv, btv, limits, q_lens, modes


def paged_kernel_phase(card: str) -> list[dict]:
    """K2 and K3 at the paged path's shapes; returns their records."""
    from fei_tpu_torch.ops.kernels.paged_attention import (
        SEGMENT_PAGES,
        launch,
        paged_attention,
        paged_attention_block,
        paged_rows_plain,
    )
    from fei_tpu_torch.ops.kernels.ragged_paged_attention import (
        ragged_paged_attention,
        ragged_paged_attention_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    i32 = dict(dtype=torch.int32, device="cuda")
    B, H, K, D, width = (PAGED_SHAPE[k] for k in ("B", "H", "K", "D", "width"))
    lengths = PAGED_LENGTHS
    n_pages = sum(-(-n // PAGE) for n in lengths) + 40
    bt = paged_table(lengths, width, n_pages, SEED)
    ln = torch.tensor(lengths, **i32)
    ones = torch.ones(B, **i32)
    q = torch.randn(B, H, D, generator=gen, device="cuda").bfloat16()
    records = {}
    for int8 in (False, True):
        tag = "int8" if int8 else "bf16"
        kp, vp, ks, vs = paged_pool(n_pages, K, D, int8, gen)
        dec = paged_attention(q, kp, vp, bt, ln, k_scales=ks, v_scales=vs)
        torch.cuda.synchronize()
        err = paged_case_check(f"paged_attention main decode {tag}", dec[:, None],
                               q[:, None], kp, vp, bt, ln, ones, ks, vs, 0)
        check(torch.equal(paged_attention(q, kp, vp, bt, ln, k_scales=ks, v_scales=vs), dec),
              f"paged_attention main decode {tag}: two runs differ")
        call = lambda: paged_attention(q, kp, vp, bt, ln, k_scales=ks, v_scales=vs)
        ms = cuda_ms(call)
        device_ms = graph_ms([call] * 20)
        plain_ms = cuda_ms(lambda: paged_rows_plain(
            q[:, None], kp, vp, bt, ln, None, k_scales=ks, v_scales=vs),
            iters=5, warmup=1)
        # for an int8 pool the yardstick reads a dequantized bf16 copy: no
        # single library call attends over int8 K/V with per-slot scales
        lib = sdpa_yardstick(q[:, None], kp, vp, bt, ln, ones, 0, ks, vs)
        lib_ms, lib_device_ms = cuda_ms(lib), graph_ms([lib] * 20)
        bound_ms, bound_by = paged_bound_ms(q[:, None], bt, ln, ones, K, int8, 0)
        log(f"kernel paged_attention [main decode {tag}] B={B} H={H} K={K} D={D} "
            f"lengths={lengths} on {card}: two runs bitwise equal; {ms:.4f} ms "
            f"({device_ms:.4f} ms device time, CUDA graph), plain {plain_ms:.4f} ms, "
            f"scaled_dot_product_attention {lib_ms:.4f} ms ({lib_device_ms:.4f} ms device "
            f"time), bound {bound_ms:.4f} ms ({bound_by})")
        records[f"paged_attention {tag}"] = {
            "name": "paged_attention", "route": "cuda",
            "source": "fei_tpu_torch/csrc/paged_attention.cu",
            "replaces": "fei_tpu/ops/pallas/paged_attention.py:44",
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "device_ms": device_ms, "library_device_ms": lib_device_ms,
            "seg_pages": SEGMENT_PAGES,
        }
        # the block form: a 256-token chunk (T=256) of the 5000-token row,
        # and a 16-token block of the 1500-token row; each position bitwise
        # the decode kernel at that position
        for T, row in ((256, 5), (16, 2)):
            qb = torch.randn(1, T, H, D, generator=gen, device="cuda").bfloat16()
            before = torch.tensor([lengths[row] - T], **i32)
            blk = paged_attention_block(qb, kp, vp, bt[row:row + 1], before,
                                        k_scales=ks, v_scales=vs)
            paged_case_check(f"paged_attention block T={T} {tag}", blk, qb, kp, vp,
                             bt[row:row + 1], before + 1, torch.full((1,), T, **i32),
                             ks, vs, 0)
            decode_equals_block_rows(f"paged_attention block T={T} {tag}", blk, qb, kp, vp,
                                     bt[row:row + 1], before, ks, vs)
            bcall = lambda qb=qb, row=row, before=before: paged_attention_block(
                qb, kp, vp, bt[row:row + 1], before, k_scales=ks, v_scales=vs)
            log(f"kernel paged_attention [block T={T} {tag}] on {card}: "
                f"{cuda_ms(bcall):.4f} ms ({graph_ms([bcall] * 10):.4f} ms device time)")
            if T == 256:
                chunk_q, chunk_out = qb, blk
        if not int8:
            k1_against_k2(chunk_q, chunk_out, kp, vp, bt[5:6], lengths[5] - 256)
        # K3: the eight decode rows plus the 256-token chunk as 32 groups of
        # R=8 (the merged dispatch's shape)
        qv, btv, limits, q_lens, modes = merged_inputs(q, chunk_q, bt, ln, 5, lengths[5] - 256)
        rag = ragged_paged_attention(qv, kp, vp, btv, limits, q_lens, modes,
                                     k_scales=ks, v_scales=vs)
        torch.cuda.synchronize()
        eff = torch.where(modes == 1, 1, q_lens).int()
        rerr = paged_case_check(f"ragged_paged_attention 8 decode + 32x8 {tag}", rag,
                                qv, kp, vp, btv, limits, eff, ks, vs, 0)
        check(torch.equal(rag[:B, 0], dec), f"{tag}: ragged decode rows != paged qt=1")
        check(torch.equal(rag[B:].reshape(1, 256, H, D), chunk_out),
              f"{tag}: ragged chunk groups != paged block")
        check(torch.equal(ragged_paged_attention(qv, kp, vp, btv, limits, q_lens, modes,
                                                 k_scales=ks, v_scales=vs), rag),
              f"ragged {tag}: two runs differ")
        log(f"kernel [{tag}]: ragged decode rows == paged_attention (qt=1) bitwise; "
            f"ragged chunk groups == paged_attention_block (T=256) bitwise; two runs "
            "bitwise equal")
        rcall = lambda: ragged_paged_attention(qv, kp, vp, btv, limits, q_lens, modes,
                                               k_scales=ks, v_scales=vs)
        rms, rdevice_ms = cuda_ms(rcall), graph_ms([rcall] * 10)
        rplain = cuda_ms(lambda: ragged_paged_attention_plain(
            qv, kp, vp, btv, limits, q_lens, modes, k_scales=ks, v_scales=vs),
            iters=5, warmup=1)
        rlib = sdpa_yardstick(qv, kp, vp, btv, limits, eff, 0, ks, vs)
        rlib_ms, rlib_device_ms = cuda_ms(rlib), graph_ms([rlib] * 10)
        rbound, rby = paged_bound_ms(qv, btv, limits, eff, K, int8, 0)
        log(f"kernel ragged_paged_attention [8 decode + 32 groups of 8, {tag}] on {card}: "
            f"{rms:.4f} ms ({rdevice_ms:.4f} ms device time), plain {rplain:.4f} ms, "
            f"scaled_dot_product_attention {rlib_ms:.4f} ms ({rlib_device_ms:.4f} ms "
            f"device time), bound {rbound:.4f} ms ({rby})")
        records[f"ragged_paged_attention {tag}"] = {
            "name": "ragged_paged_attention", "route": "cuda",
            "source": "fei_tpu_torch/csrc/ragged_paged_attention.cu",
            "replaces": "fei_tpu/ops/pallas/ragged_paged_attention.py:55",
            "launches": 0, "max_abs_err": rerr, "ms": rms, "plain_ms": rplain,
            "bound_ms": rbound, "bound_by": rby, "library_ms": rlib_ms,
            "device_ms": rdevice_ms, "library_device_ms": rlib_device_ms,
            "seg_pages": SEGMENT_PAGES,
        }
        # what the segment length costs: device time at each of SEG_SWEEP
        # (the decode, the T=256 block, the merged shape), through the
        # launch path that takes it as an argument
        sweep = []
        for seg in SEG_SWEEP:
            calls = (
                lambda: launch("paged_attention", "fei_paged_attention", q[:, None], kp, vp,
                               bt, [("lengths", ln)], None, ks, vs, 0, seg_pages=seg),
                lambda: launch("paged_attention", "fei_paged_attention", chunk_q, kp, vp,
                               bt[5:6], [("limits", limits[B:B + 1])], None, ks, vs, 0,
                               seg_pages=seg),
                lambda: launch("ragged_paged_attention", "fei_ragged_paged_attention", qv, kp,
                               vp, btv, [("limits", limits), ("q_lens", q_lens),
                                         ("modes", modes)], None, ks, vs, 0, seg_pages=seg),
            )
            sweep.append(f"{seg}: " + " / ".join(f"{graph_ms([c] * 10):.4f}" for c in calls))
        log(f"kernel paged [{tag}] device ms by segment pages (decode / block T=256 / "
            f"merged) on {card}: " + "; ".join(sweep) + f" (in use: {SEGMENT_PAGES})")
        # a sliding window of 512 on the decode shape
        wdec = paged_attention(q, kp, vp, bt, ln, k_scales=ks, v_scales=vs, window=512)
        paged_case_check(f"paged_attention window 512 {tag}", wdec[:, None], q[:, None],
                         kp, vp, bt, ln, ones, ks, vs, 512)
        wcall = lambda: paged_attention(q, kp, vp, bt, ln, k_scales=ks, v_scales=vs,
                                        window=512)
        log(f"kernel paged_attention [window 512 {tag}] on {card}: {cuda_ms(wcall):.4f} ms "
            f"({graph_ms([wcall] * 20):.4f} ms device time)")
        # decode rows one below, at and one above segment boundaries, a
        # 16-position block across the first boundary, and the merged form
        blens = boundary_lengths()
        bbt = paged_table(blens, width, n_pages, SEED + 1)
        bln = torch.tensor(blens, **i32)
        qd = torch.randn(len(blens), H, D, generator=gen, device="cuda").bfloat16()
        bdec = paged_attention(qd, kp, vp, bbt, bln, k_scales=ks, v_scales=vs)
        torch.cuda.synchronize()
        paged_case_check(f"paged_attention segment boundaries {blens} {tag}", bdec[:, None],
                         qd[:, None], kp, vp, bbt, bln, torch.ones_like(bln), ks, vs, 0)
        qb = torch.randn(1, 16, H, D, generator=gen, device="cuda").bfloat16()
        before = torch.tensor([blens[1] - 8], **i32)
        bblk = paged_attention_block(qb, kp, vp, bbt[4:5], before, k_scales=ks, v_scales=vs)
        paged_case_check(f"paged_attention block T=16 across a boundary {tag}", bblk, qb,
                         kp, vp, bbt[4:5], before + 1, torch.full((1,), 16, **i32), ks, vs, 0)
        decode_equals_block_rows(f"paged_attention block T=16 across a boundary {tag}", bblk,
                                 qb, kp, vp, bbt[4:5], before, ks, vs)
        bv = merged_inputs(qd, qb, bbt, bln, 4, blens[1] - 8)
        brag = ragged_paged_attention(*bv[:1], kp, vp, *bv[1:], k_scales=ks, v_scales=vs)
        check(torch.equal(brag[:len(blens), 0], bdec) and
              torch.equal(brag[len(blens):].reshape(1, 16, H, D), bblk),
              f"{tag}: ragged rows at the segment boundaries != paged")
        bcall = lambda: paged_attention(qd, kp, vp, bbt, bln, k_scales=ks, v_scales=vs)
        log(f"kernel [{tag}] at the segment boundaries: ragged decode rows and chunk groups "
            f"bitwise paged; decode {cuda_ms(bcall):.4f} ms ({graph_ms([bcall] * 20):.4f} ms "
            "device time)")
        del kp, vp, ks, vs
    # the other head dims the presets use
    for label, Hd, Kd, Dd in PAGED_HEAD_DIMS:
        lens = PAGED_OTHER_LENGTHS
        npg = sum(-(-n // PAGE) for n in lens) + 8
        btd = paged_table(lens, 64, npg, SEED + Dd)
        lnd = torch.tensor(lens, **i32)
        qd = torch.randn(4, Hd, Dd, generator=gen, device="cuda").bfloat16()
        kp, vp, _, _ = paged_pool(npg, Kd, Dd, False, gen)
        out = paged_attention(qd, kp, vp, btd, lnd)
        torch.cuda.synchronize()
        paged_case_check(f"paged_attention {label}", out[:, None], qd[:, None], kp, vp,
                         btd, lnd, torch.ones(4, **i32), None, None, 0)
        dcall = lambda: paged_attention(qd, kp, vp, btd, lnd)
        log(f"kernel paged_attention [{label}] on {card}: {cuda_ms(dcall):.4f} ms "
            f"({graph_ms([dcall] * 20):.4f} ms device time)")
        del kp, vp
    scratch_refused(q, bt, ln)
    torch.cuda.empty_cache()
    # the int8 pools' records (the kernels line holds the bf16 ones)
    log("kernel records [int8]: " + json.dumps(
        [{k: v for k, v in records[f"{n} int8"].items() if k != "launches"}
         for n in ("paged_attention", "ragged_paged_attention")]))
    return [records["paged_attention bf16"], records["ragged_paged_attention bf16"]]


def paged_times(card: str) -> None:
    """``--paged-times``: K2's and K3's time at every shape of the paged
    kernel phase (eager and CUDA-graph device time), through the public
    wrappers alone and with nothing checked, so that the same function
    times an older tree's kernels: run a copy of this file from that tree's
    root."""
    from fei_tpu_torch.ops.kernels.paged_attention import (
        paged_attention,
        paged_attention_block,
    )
    from fei_tpu_torch.ops.kernels.ragged_paged_attention import ragged_paged_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    i32 = dict(dtype=torch.int32, device="cuda")
    B, H, K, D, width = (PAGED_SHAPE[k] for k in ("B", "H", "K", "D", "width"))
    lengths = PAGED_LENGTHS
    n_pages = sum(-(-n // PAGE) for n in lengths) + 40
    bt = paged_table(lengths, width, n_pages, SEED)
    ln = torch.tensor(lengths, **i32)
    q = torch.randn(B, H, D, generator=gen, device="cuda").bfloat16()
    blens = [1023, 1024, 1025, 2047, 2048, 2049, PAGE, 1]  # SEGMENT_PAGES = 16's
    bbt = paged_table(blens, width, n_pages, SEED + 1)
    bln = torch.tensor(blens, **i32)
    qd = torch.randn(len(blens), H, D, generator=gen, device="cuda").bfloat16()
    qb = {T: torch.randn(1, T, H, D, generator=gen, device="cuda").bfloat16()
          for T in (256, 16)}

    def timed(label, call, reps):
        log(f"paged times [{label}] on {card}: {cuda_ms(call):.4f} ms "
            f"({graph_ms([call] * reps):.4f} ms device time)")

    for int8 in (False, True):
        tag = "int8" if int8 else "bf16"
        kp, vp, ks, vs = paged_pool(n_pages, K, D, int8, gen)
        kw = dict(k_scales=ks, v_scales=vs)
        timed(f"paged_attention main decode {tag}",
              lambda: paged_attention(q, kp, vp, bt, ln, **kw), 20)
        for T, row in ((256, 5), (16, 2)):
            before = torch.tensor([lengths[row] - T], **i32)
            timed(f"paged_attention block T={T} {tag}",
                  lambda: paged_attention_block(qb[T], kp, vp, bt[row:row + 1], before, **kw),
                  10)
        qv, btv, limits, q_lens, modes = merged_inputs(q, qb[256], bt, ln, 5,
                                                       lengths[5] - 256)
        timed(f"ragged_paged_attention 8 decode + 32x8 {tag}",
              lambda: ragged_paged_attention(qv, kp, vp, btv, limits, q_lens, modes, **kw), 10)
        timed(f"paged_attention window 512 {tag}",
              lambda: paged_attention(q, kp, vp, bt, ln, window=512, **kw), 20)
        timed(f"paged_attention segment boundaries {tag}",
              lambda: paged_attention(qd, kp, vp, bbt, bln, **kw), 20)
        del kp, vp, ks, vs
    for label, Hd, Kd, Dd in PAGED_HEAD_DIMS:
        lens = PAGED_OTHER_LENGTHS
        npg = sum(-(-n // PAGE) for n in lens) + 8
        btd = paged_table(lens, 64, npg, SEED + Dd)
        lnd = torch.tensor(lens, **i32)
        qh = torch.randn(4, Hd, Dd, generator=gen, device="cuda").bfloat16()
        kp, vp, _, _ = paged_pool(npg, Kd, Dd, False, gen)
        timed(f"paged_attention {label}", lambda: paged_attention(qh, kp, vp, btd, lnd), 20)
        del kp, vp


def scratch_refused(q, bt, ln) -> None:
    """K2's entry point refuses partials' scratch of another size than its
    plan's (the wrapper sizes it from ``scratch_elems``): one segment
    short, it returns an error and launches nothing."""
    from fei_tpu_torch.ops.kernels.paged_attention import (
        SEGMENT_PAGES,
        kernel_fn,
        scratch_elems,
    )

    B, H, D = q.shape
    K = PAGED_SHAPE["K"]
    kp = torch.zeros(2, K, PAGE, D, dtype=torch.bfloat16, device="cuda")
    out = torch.empty_like(q)
    n = scratch_elems(B, 1, H, D, bt.shape[1]) - B * H * (D + 2)
    short = torch.empty(n, dtype=torch.float32, device="cuda")
    fn, _ = kernel_fn("paged_attention", "fei_paged_attention", 1)
    err = fn(q.data_ptr(), kp.data_ptr(), kp.data_ptr(), None, None, out.data_ptr(),
             short.data_ptr(), n, bt.data_ptr(), bt.stride(0), ln.data_ptr(),
             B, 1, H, K, D, bt.shape[1], H * D, H * D, D, H * D, H * D, D,
             0, D ** -0.5, 0, SEGMENT_PAGES, torch.cuda.current_stream().cuda_stream)
    check(err != 0, "paged_attention took scratch one segment short of its plan")
    log(f"kernel paged_attention: scratch one segment short of the plan refused (error {err})")


# ------------------------------------------------------------- int4 kernel

# llama3-8b's linears (label, K, N) and the row counts the serving paths
# give them: dense decode, the paged decode batch, a chunk, the prefill
INT4_LINEARS = (("wq/wo", 4096, 4096), ("wk/wv", 4096, 1024),
                ("w_gate/w_up", 4096, 14336), ("w_down", 14336, 4096))
INT4_MS = (1, 8, 256, 2048)
INT4_MAIN = ("w_gate/w_up", 8)  # the record's shape: the paged decode batch
L2_BYTES = 128 * 2 ** 20  # more than the card's 50 MB L2: timed weights arrive cold


def int4_bound_ms(M: int, K: int, N: int) -> tuple[float, str]:
    """Least time for one int4 product: packed bytes, scales, x and the
    output moved once at the memory rate, against 2*M*K*N operations at
    the bf16 peak; the larger of the two, and which it is."""
    nbytes = (K // 2) * N + (K // 128) * N * 4 + 2 * M * K + 2 * M * N
    t_ops, t_bytes = 2.0 * M * K * N / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def copies(make, nbytes: int) -> list:
    """Enough copies of an input (``make()`` each) to exceed the L2 cache,
    so a timing loop that cycles through them reads each from device
    memory, as a decode step reads each layer's weights."""
    return [make() for _ in range(max(1, -(-L2_BYTES // nbytes)))]


def split_scratch_refused(x, w) -> None:
    """K4's entry point refuses split-K scratch of another size than its
    own plan's (the wrapper sizes it from ``split_plan``): one segment
    short, it returns an error and launches nothing."""
    from fei_tpu_torch.ops.kernels.int4_matmul import _kernel, split_plan

    fn, _ = _kernel()
    M, K = x.shape
    N = w.p.shape[1]
    out = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
    short = torch.empty(((len(split_plan(K)) - 1) * M * N,), dtype=torch.float32, device="cuda")
    err = fn(x.data_ptr(), x.stride(0), w.p.data_ptr(), w.s.data_ptr(), out.data_ptr(),
             short.data_ptr(), short.numel(), M, N, K, w.group_size,
             torch.cuda.current_stream().cuda_stream)
    check(err != 0, "int4_matmul took split scratch one segment short of its plan")
    log(f"kernel int4_matmul: scratch one segment short of the plan refused (error {err})")


def int4_kernel_phase(card: str) -> dict:
    """K4 at llama3-8b's four linear shapes x M in {1, 8, 256, 2048}: held
    element by element against its plain version within
    ``int4_mm_tolerance``, two mutants shown to break that bound, row 0
    bitwise the same at every M, and timed beside the plain version, one
    ``torch.matmul`` on the dequantized weight (a yardstick the port never
    calls) and the bound. Returns the main shape's record."""
    from fei_tpu_torch.ops.kernels.int4_matmul import (
        int4_mm,
        int4_mm_reference,
        int4_mm_tolerance,
    )
    from fei_tpu_torch.ops.quant import QTensor4, dequantize, quantize4

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    record = None
    for label, K, N in INT4_LINEARS:
        w = quantize4((torch.randn(K, N, generator=gen, device="cuda") * K ** -0.5).bfloat16())
        x_all = torch.randn(max(INT4_MS), K, generator=gen, device="cuda").bfloat16()
        # the mutants: lo and hi planes swapped; each group read with the
        # next group's scale
        mutants = {
            "planes swapped": QTensor4(((w.p & 0xF) << 4) | ((w.p >> 4) & 0xF), w.s),
            "next group's scale": QTensor4(w.p, torch.roll(w.s, -1, dims=0)),
        }
        w_copies = copies(lambda: QTensor4(w.p.clone(), w.s.clone()),
                          w.p.numel() + 4 * w.s.numel())
        deq = dequantize(w, torch.bfloat16)
        deq_copies = copies(deq.clone, 2 * deq.numel())
        outs = {}
        for M in INT4_MS:
            x = x_all[:M]
            out = int4_mm(x, w)
            torch.cuda.synchronize()
            ref = int4_mm_reference(x.float(), w)  # the plain version, fp32 sum
            # tolerance, element by element: one bf16 ulp of each output
            # (the kernel rounds its fp32 sum to bf16) plus K*2^-24*sum|x w|
            # for the two fp32 summation orders; the weights are the same
            # bf16 values on both sides (int4_mm_tolerance's docstring)
            tol = int4_mm_tolerance(x, w)
            diff = (out.float() - ref).abs()
            err = diff.max().item()
            worst = (diff / tol).max().item()
            check(torch.isfinite(out).all().item(), f"int4 {label} M={M}: non-finite output")
            check(worst <= 1.0, f"int4 {label} M={M}: error exceeds its tolerance by {worst:.4g}x")
            caught = {name: ((int4_mm_reference(x.float(), m) - ref).abs() > tol)
                      .float().mean().item() for name, m in mutants.items()}
            for name, share in caught.items():
                check(share > 0, f"int4 {label} M={M}: the tolerance cannot see {name}")
            check(torch.equal(int4_mm(x, w), out), f"int4 {label} M={M}: two runs differ")
            outs[M] = out
            ws = itertools.cycle(w_copies)
            ms = cuda_ms(lambda: int4_mm(x, next(ws)))
            # device time: one graph of a call per weight copy (each copy
            # arrives cold, as a layer's weights do in a decode step)
            device_ms = graph_ms([lambda wc=wc: int4_mm(x, wc) for wc in w_copies])
            plain_ms = cuda_ms(lambda: int4_mm_reference(x, w), iters=3, warmup=1)
            ds = itertools.cycle(deq_copies)
            lib_ms = cuda_ms(lambda: torch.matmul(x, next(ds)))
            lib_device_ms = graph_ms([lambda dc=dc: torch.matmul(x, dc) for dc in deq_copies])
            bound_ms, bound_by = int4_bound_ms(M, K, N)
            log(f"kernel int4_matmul [{label} M={M}] K={K} N={N} on {card}: "
                f"max_abs_err={err:.6g}, worst err/tol {worst:.4g}; "
                + ", ".join(f"{k} breaks the tolerance at {v:.2%}" for k, v in caught.items())
                + f"; two runs bitwise equal; {ms:.4f} ms ({device_ms:.4f} ms device time, "
                f"CUDA graph), plain {plain_ms:.4f} ms, matmul on the dequantized weight "
                f"{lib_ms:.4f} ms ({lib_device_ms:.4f} ms device time), "
                f"bound {bound_ms:.4f} ms ({bound_by})")
            if (label, M) == INT4_MAIN:
                record = {
                    "name": "int4_matmul", "route": "cuda",
                    "source": "fei_tpu_torch/csrc/int4_matmul.cu",
                    "replaces": "fei_tpu/ops/pallas/int4_matmul.py:75",
                    "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                    "device_ms": device_ms, "library_device_ms": lib_device_ms,
                    # M <= 16 takes the split of K, larger M the pipeline:
                    # wgmma in both
                    "design": "wgmma",
                }
            del out, ref, tol, diff
        # row invariance: a row's k-order does not follow M or the kernel
        # (M <= 16 splits K; larger M runs the pipeline): every row of each
        # call equals the same row of every larger call
        for a, b in itertools.combinations(INT4_MS, 2):
            same = (outs[b][:a] == outs[a]).all(dim=1)
            check(bool(same.all()), f"int4 {label}: rows {(~same).nonzero().flatten()[:8].tolist()} "
                  f"of the M={a} call differ from the M={b} call's")
        log(f"kernel int4_matmul [{label}]: every row bitwise equal across M = {INT4_MS}")
        if label == INT4_MAIN[0]:
            split_scratch_refused(x_all[:1], w)
        del w, x_all, mutants, w_copies, deq, deq_copies, outs
        torch.cuda.empty_cache()
    return record


# ----------------------------------------------------------------- engine

def weight_stream_bytes(params) -> int:
    """Bytes of the weights one decode step reads: every leaf but the
    embedding table, which is gathered a row at a time."""
    from fei_tpu_torch.ops.quant import param_bytes

    return param_bytes(params) - param_bytes(params["embed"])


def serving_bounds(cfg, prompt_len: int, new_tokens: int,
                   weight_bytes: int | None = None) -> tuple[float, float]:
    """The card's limits for this run's work, at the bf16 and memory peaks:
    the least TTFT (ms) — the larger of the prefill's operations (linear
    layers over the prompt's tokens, causal attention, the LM head for one
    position) and one read of the weights — and the most decode tok/s — one
    read of the weights (not the embedding table, which is gathered) and of
    the live KV per token, at the run's mean context. ``weight_bytes``
    gives a quantized tree's bytes (``weight_stream_bytes``); None counts
    bf16 linears."""
    h, d, L = cfg.hidden_size, cfg.head_dim_, cfg.num_layers
    H, K, I, V = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size, cfg.vocab_size
    per_layer = h * H * d + 2 * h * K * d + H * d * h + 3 * h * I
    head = h * V
    if weight_bytes is None:
        weight_bytes = 2 * (L * per_layer + head)
    flops = (2 * L * per_layer * prompt_len
             + 4 * d * H * L * prompt_len * (prompt_len + 1) / 2 + 2 * head)
    ttft_s = max(flops / PEAK_BF16_FLOPS, weight_bytes / PEAK_BYTES_PER_S)
    ctx = prompt_len + new_tokens / 2
    kv_bytes = 2 * 2 * L * ctx * K * d
    step_s = (weight_bytes + kv_bytes) / PEAK_BYTES_PER_S
    return ttft_s * 1e3, 1.0 / step_s


def engine_phase(card: str):
    from fei_tpu_torch.engine import GenerationConfig, InferenceEngine
    from fei_tpu_torch.ops.kernels.flash_attention import flash_attention

    t0 = time.perf_counter()
    engine = InferenceEngine.from_config(
        "llama3-8b", dtype=torch.bfloat16, seed=SEED, max_seq_len=8192,
        device="cuda",
    )
    torch.cuda.synchronize()
    cfg = engine.cfg
    n_params = sum(t.numel() for t in engine.params["layers"].values()) + sum(
        t.numel() for k, t in engine.params.items() if k != "layers")
    log(f"engine: {cfg.name} L={cfg.num_layers} h={cfg.hidden_size} "
        f"H={cfg.num_heads} K={cfg.num_kv_heads} V={cfg.vocab_size}, "
        f"{n_params / 1e9:.3f} B params bf16, random init in "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(SEED)
    prompt = rng.integers(8, cfg.vocab_size, size=1500).tolist()

    # the main path starts here: every kernel count from 0
    flash_attention.launches = 0
    logits, _ = engine.prefill([prompt], engine.new_cache(1))
    torch.cuda.synchronize()
    check(flash_attention.launches == cfg.num_layers,
          f"prefill launched flash {flash_attention.launches} times, "
          f"expected {cfg.num_layers} (one per layer)")
    log(f"engine: prefill of {len(prompt)} tokens (bucket 2048) launched "
        f"flash_attention_fwd {flash_attention.launches} times")
    check(torch.isfinite(logits).all().item(), "prefill logits not finite")
    check(tuple(logits.shape) == (1, cfg.vocab_size),
          f"prefill logits shape {tuple(logits.shape)}")

    plain, _ = engine.prefill([prompt], engine.new_cache(1), flash=False)
    diff = (logits - plain).abs().max().item()
    rel = ((logits - plain).norm() / plain.norm()).item()
    # tolerance: the two runs differ only in the attention outputs, each a
    # bf16 rounding (2^-8 relative) apart per layer; 32 such perturbations
    # of the residual stream stay within a few percent of the logits' norm
    log(f"engine: last-position prefill logits, flash vs plain attention: "
        f"max_abs_diff={diff:.6g}, rel_l2={rel:.6g} (tol 3e-2), "
        f"argmax {int(logits.argmax())} vs {int(plain.argmax())}")
    check(rel <= 3e-2, f"flash vs plain prefill logits rel_l2 {rel} > 3e-2")

    gen = GenerationConfig(max_new_tokens=128, ignore_eos=True, chunk=16)
    res = engine.generate(prompt, gen)
    check(len(res.token_ids) == 128, f"decoded {len(res.token_ids)} tokens, expected 128")
    check(all(0 <= t < cfg.vocab_size for t in res.token_ids), "token id out of range")
    ttft_bound, tok_s_bound = serving_bounds(cfg, len(prompt), 128)
    log(f"engine: {len(prompt)}-token prompt, 128 greedy tokens (chunk 16) "
        f"on {card}: TTFT {res.ttft_s * 1e3:.1f} ms (bound {ttft_bound:.1f} ms), "
        f"decode {res.decode_tokens_per_s:.2f} tok/s (bound {tok_s_bound:.1f} tok/s)")

    # the port's own parity: the per-token loop gives the same tokens
    ref = list(engine.generate_stream(prompt, GenerationConfig(
        max_new_tokens=32, ignore_eos=True, chunk=1)))
    check(ref == res.token_ids[:32],
          "per-token decode diverged from chunked decode")
    log("engine: per-token (chunk 1) == chunked (chunk 16) for 32 tokens")
    return engine


# ------------------------------------------------------------------ serve

def serve_phase(engine, card: str) -> None:
    from fei_tpu_torch.agent.providers import TorchLocalProvider
    from fei_tpu_torch.engine import GenerationConfig
    from fei_tpu_torch.ops.kernels.flash_attention import flash_attention
    from fei_tpu_torch.ui.server import ServeAPI, ServingServer

    # The repo ships no llama3 tokenizer, so the server decodes with the
    # byte tokenizer, which reads 264 of llama3-8b's 128256 ids: a random
    # model's greedy picks would almost all decode to nothing. Zeroing the
    # LM head's columns past the tokenizer's ids leaves those logits at 0
    # while the tokenizer's own are random, so every greedy pick is an id
    # the tokenizer decodes and the completions carry text. The served
    # path itself is unchanged.
    tok = engine.tokenizer
    check("lm_head" in engine.params, "the serve phase expects an untied LM head")
    engine.params["lm_head"][:, tok.vocab_size:] = 0

    api = ServeAPI(TorchLocalProvider(engine=engine), model_name=engine.cfg.name)
    server = ServingServer(api, host="127.0.0.1", port=0)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.loads(r.read())
            check(r.status == 200 and health.get("status") == "ok", f"/health {health}")
        log(f"serve: /health {health}")

        text = ("Summarize the design of a flash attention kernel for a GPU: "
                "tiles of queries, an online softmax, and a loop over live key tiles.")
        bodies = [
            {"messages": [{"role": "user", "content": text}]},
            {"messages": [{"role": "system", "content": "You are terse."},
                          {"role": "user", "content": text[::-1]}]},
            {"messages": [{"role": "user", "content": text}], "stream": True},
        ]
        contents = []
        for i, body in enumerate(bodies):
            body = dict(body, max_tokens=16, ignore_eos=True, model=engine.cfg.name)
            before = flash_attention.launches
            req = urllib.request.Request(
                base + "/v1/chat/completions", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"}, method="POST",
            )
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as r:
                status, raw = r.status, r.read()
            dt = time.perf_counter() - t0
            check(status == 200, f"request {i}: HTTP {status}")
            launched = flash_attention.launches - before
            if body.get("stream"):
                frames = [ln[6:] for ln in raw.decode().split("\n") if ln.startswith("data: ")]
                check(frames and frames[-1] == "[DONE]", f"request {i}: no [DONE]")
                chunks = [json.loads(f) for f in frames[:-1]]
                check(all("error" not in c for c in chunks), f"request {i}: {chunks}")
                content = "".join(
                    c["choices"][0]["delta"].get("content", "") for c in chunks)
                check(chunks[-1]["choices"][0]["finish_reason"] == "stop",
                      f"request {i}: no finish frame")
                ntok = None
            else:
                out = json.loads(raw)
                content = out["choices"][0]["message"]["content"]
                ntok = out["usage"]["completion_tokens"]
                check(ntok == 16, f"request {i}: {ntok} completion tokens, expected 16")
                check(out["usage"]["prompt_tokens"] >= 64,
                      f"request {i}: prompt of {out['usage']['prompt_tokens']} tokens")
            check(launched == engine.cfg.num_layers,
                  f"request {i}: prefill launched flash {launched} times")
            # the same greedy completion straight from the engine, on the
            # chat-templated prompt the provider builds
            ids = tok.apply_chat_template(body["messages"], add_generation_prompt=True)
            want = engine.generate(ids, GenerationConfig(max_new_tokens=16, ignore_eos=True))
            want_text = tok.decode(want.token_ids).strip()
            # the JSON message is stripped of surrounding blanks; the SSE
            # deltas carry the text as decoded
            content = content.strip()
            check(len(content) > 0, f"request {i}: empty completion")
            check(content == want_text,
                  f"request {i}: served {content!r}, engine.generate says {want_text!r}")
            contents.append(content)
            log(f"serve: request {i} ({'SSE' if body.get('stream') else 'JSON'}) "
                f"200 in {dt * 1e3:.1f} ms on {card}: completion_tokens={ntok}, "
                f"{len(content)} chars {content!r}, flash launches {launched}")
        # greedy is deterministic: the streamed twin of request 0 says the same
        check(contents[2] == contents[0], "SSE content differs from the JSON content")
    finally:
        server.stop()


# ------------------------------------------------------------ paged engine

SHORT_LENS = (96, 160, 200, 250)  # dense admission (<= prefill_chunk 256)
LONG_LENS = (700, 1500, 3000, 5000)  # chunked, merged with live decode
NEW_TOKENS = 128


def reset_counts():
    from fei_tpu_torch.ops.kernels.flash_attention import flash_attention, flash_attention_bwd
    from fei_tpu_torch.ops.kernels.int4_matmul import int4_mm
    from fei_tpu_torch.ops.kernels.paged_attention import paged_attention
    from fei_tpu_torch.ops.kernels.ragged_paged_attention import ragged_paged_attention

    for fn in (flash_attention, paged_attention, ragged_paged_attention, int4_mm):
        fn.launches = 0
        if hasattr(fn, "int8_launches"):
            fn.int8_launches = 0
    flash_attention_bwd.launches_dq = flash_attention_bwd.launches_dkv = 0


def read_counts() -> dict:
    from fei_tpu_torch.ops.kernels.flash_attention import flash_attention, flash_attention_bwd
    from fei_tpu_torch.ops.kernels.int4_matmul import int4_mm
    from fei_tpu_torch.ops.kernels.paged_attention import paged_attention
    from fei_tpu_torch.ops.kernels.ragged_paged_attention import ragged_paged_attention

    return {"flash_attention_fwd": flash_attention.launches,
            "paged_attention": paged_attention.launches,
            "ragged_paged_attention": ragged_paged_attention.launches,
            "int4_matmul": int4_mm.launches,
            "flash_attention_bwd_dq": flash_attention_bwd.launches_dq,
            "flash_attention_bwd_dkv": flash_attention_bwd.launches_dkv,
            "paged_attention_int8": paged_attention.int8_launches,
            "ragged_paged_attention_int8": ragged_paged_attention.int8_launches}


def counter(name: str) -> float:
    from fei_tpu_torch.utils.metrics import METRICS

    return METRICS.snapshot()["counters"].get(name, 0.0)


def traffic(engine, prompts, new_tokens: int) -> dict:
    """Eight requests from eight threads through the scheduler: the short
    prompts start at once, the long ones once every short stream has its
    first token (so their chunks overlap live decode). Returns the token
    streams, each request's TTFT and the run's wall time."""
    from fei_tpu_torch.engine import GenerationConfig

    gen = GenerationConfig(max_new_tokens=new_tokens, ignore_eos=True)
    n = len(prompts)
    n_short = sum(1 for p in prompts if len(p) <= engine.scheduler.prefill_chunk)
    streams, ttft, errors = [None] * n, [None] * n, []
    firsts = threading.Semaphore(0)

    def worker(i):
        try:
            if len(prompts[i]) > engine.scheduler.prefill_chunk:
                for _ in range(n_short):
                    firsts.acquire(timeout=600)
            t0 = time.perf_counter()
            out = []
            for tok in engine.scheduler.stream(prompts[i], gen):
                if not out:
                    ttft[i] = time.perf_counter() - t0
                    if len(prompts[i]) <= engine.scheduler.prefill_chunk:
                        for _ in range(n - n_short):
                            firsts.release()
                out.append(tok)
            streams[i] = out
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            errors.append(exc)
            for _ in range(n):
                firsts.release()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return {"streams": streams, "ttft": ttft, "wall": wall}


def paged_decode_bound(cfg, prompts, new_tokens: int) -> float:
    """Most aggregate decode tok/s for this traffic: each step reads the
    weights once plus every row's live KV at its mean context, and yields
    one token per row."""
    h, d, L = cfg.hidden_size, cfg.head_dim_, cfg.num_layers
    H, K, I, V = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size, cfg.vocab_size
    weight_bytes = 2 * (L * (h * H * d + 2 * h * K * d + H * d * h + 3 * h * I) + h * V)
    kv_bytes = sum(2 * 2 * L * K * d * (len(p) + new_tokens / 2) for p in prompts)
    return len(prompts) * PEAK_BYTES_PER_S / (weight_bytes + kv_bytes)


def chunked_paged_logits(engine, prompt):
    """Last-position logits of a chunked paged prefill (256-token chunks
    through forward_paged_block on a one-row pool)."""
    from fei_tpu_torch.engine.paged_cache import PagedKVCache
    from fei_tpu_torch.models.llama import _logits, forward_paged_block

    n, C = len(prompt), 256
    width = -(-engine.max_seq_len // PAGE)
    need = -(-(n + C) // PAGE)
    pool = PagedKVCache.create(engine.cfg, need + 1, 1, width, page_size=PAGE,
                               dtype=torch.bfloat16, device="cuda")
    row = torch.zeros((1, width), dtype=torch.int32, device="cuda")
    row[0, :need] = torch.arange(1, need + 1, dtype=torch.int32)
    pool = pool._replace(block_table=row)
    last = None
    for lo in range(0, n, C):
        toks = torch.zeros((1, C), dtype=torch.long)
        toks[0, : min(C, n - lo)] = torch.tensor(prompt[lo:lo + C])
        pool = pool._replace(lengths=torch.tensor([lo], dtype=torch.int32, device="cuda"))
        hidden, _ = forward_paged_block(engine.params, engine.cfg, toks.cuda(), pool,
                                        lm_head=False)
        if lo + C >= n:
            i = n - 1 - lo
            last = _logits(hidden[:, i:i + 1], engine.params, engine.cfg)[:, 0]
    return last


def first_divergence(dense, prompt, want, got):
    """(position, logit gap, bf16 ulp) where two streams first differ: the
    gap is logit(want's token) - logit(got's token) at that position, from
    the dense engine's prefill of the common prefix, and the ulp is a bf16
    step at the larger of the two logits (the LM head's product is bf16,
    so its logits sit on that grid)."""
    j = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    logits, _ = dense.prefill([list(prompt) + list(want[:j])], dense.new_cache(1))
    pair = logits[0, [want[j], got[j]]]
    _, exp = torch.frexp(pair.abs().max())
    return j, (pair[0] - pair[1]).item(), 2.0 ** (exp.item() - 8)


def paged_engine_phase(dense, card: str) -> tuple:
    """The paged path on the card. Returns (the roomy paged engine, the
    kernel launches of the main run)."""
    from fei_tpu_torch.engine import GenerationConfig, InferenceEngine

    cfg = dense.cfg
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(8, cfg.vocab_size, size=n).tolist()
               for n in SHORT_LENS + LONG_LENS]

    def paged(**kw):
        return InferenceEngine.from_config(
            "llama3-8b", dtype=torch.bfloat16, params=dense.params, max_seq_len=8192,
            device="cuda", paged=True, batch_size=8, page_size=PAGE, **kw)

    eng = paged()
    # the main path starts here: every kernel count from 0
    reset_counts()
    merged0, pre0 = counter("engine.ragged_dispatches"), counter("scheduler.preemptions")
    main = traffic(eng, prompts, NEW_TOKENS)
    launches = read_counts()
    merged = counter("engine.ragged_dispatches") - merged0
    preempted = counter("scheduler.preemptions") - pre0
    streams = main["streams"]
    check(all(len(s) == NEW_TOKENS for s in streams), "a paged stream came up short")
    check(all(0 <= t < cfg.vocab_size for s in streams for t in s), "token id out of range")
    total = sum(len(s) for s in streams)
    bound = paged_decode_bound(cfg, prompts, NEW_TOKENS)
    log(f"paged engine: {cfg.name} batch_size=8 page_size=64 pool 1025 pages on {card}")
    for p, t in zip(prompts, main["ttft"]):
        log(f"paged engine: prompt {len(p)} tokens: TTFT {t * 1e3:.1f} ms")
    log(f"paged engine: 8 x {NEW_TOKENS} greedy tokens in {main['wall']:.3f} s: aggregate "
        f"{total / main['wall']:.2f} tok/s (decode bound {bound:.1f} tok/s), "
        f"merged dispatches {merged:.0f}, preemptions {preempted:.0f}, launches {launches}")
    check(launches["paged_attention"] > 0, "the paged path never launched paged_attention")
    check(launches["ragged_paged_attention"] > 0,
          "the paged path never launched ragged_paged_attention")
    check(launches["flash_attention_fwd"] > 0,
          "the paged path's dense admission never launched flash_attention_fwd")
    check(merged > 0, "no chunk merged with live decode")

    # (a) the merged dispatch off, (b) single-step decode: same streams
    eng.scheduler.ragged_attention = False
    check(traffic(eng, prompts, NEW_TOKENS)["streams"] == streams,
          "streams changed with ragged_attention=False")
    eng.scheduler.ragged_attention = True
    log("paged engine: ragged_attention=False gives the same eight streams")
    eng.scheduler.multistep = 1
    check(traffic(eng, prompts, NEW_TOKENS)["streams"] == streams,
          "streams changed with multistep=1")
    eng.scheduler.multistep = 8
    log("paged engine: multistep=1 gives the same eight streams")

    # (d) a tight pool: the 5128-token request fits alone, all eight do not
    tight = paged(num_pages=129)
    pre0 = counter("scheduler.preemptions")
    t_run = traffic(tight, prompts, NEW_TOKENS)
    pre = counter("scheduler.preemptions") - pre0
    check(pre >= 1, "the tight pool never preempted")
    check(all(len(s) == NEW_TOKENS for s in t_run["streams"]),
          "the tight pool did not finish every stream")
    same = [a == b for a, b in zip(t_run["streams"], streams)]
    log(f"paged engine: tight pool (129 pages): {pre:.0f} preemptions, all eight "
        f"streams finished in {t_run['wall']:.3f} s; equal to the roomy run: {same}")
    for i, ok in enumerate(same):
        if not ok:
            j, gap, ulp = first_divergence(dense, prompts[i], streams[i], t_run["streams"][i])
            log(f"paged engine: tight stream {i} (prompt {len(prompts[i])}) first "
                f"differs at token {j}; logit gap there {gap:.6g} ({gap / ulp:.3g} bf16 ulps)")
    tight.close()
    del tight

    # (e) chunked paged prefill logits against the dense engine's
    p1500 = prompts[SHORT_LENS.__len__() + 1]
    pl = chunked_paged_logits(eng, p1500)
    dl, _ = dense.prefill([p1500], dense.new_cache(1))
    rel = ((pl - dl).norm() / dl.norm()).item()
    log(f"paged engine: 1500-token chunked paged prefill vs dense prefill logits: "
        f"rel_l2={rel:.6g} (tol 3e-2), argmax {int(pl.argmax())} vs {int(dl.argmax())}")
    check(rel <= 3e-2, f"paged vs dense prefill logits rel_l2 {rel} > 3e-2")

    # (f) an int8 pool: four streams x 32 tokens through the int8 branch
    q8 = paged(kv_quant="int8")
    before = read_counts()
    four = [prompts[0], prompts[1], prompts[4], prompts[5]]
    r8 = traffic(q8, four, 32)
    after = read_counts()
    d8 = {k: after[k] - before[k] for k in after}
    check(all(len(s) == 32 and all(0 <= t < cfg.vocab_size for t in s)
              for s in r8["streams"]), "int8 pool streams malformed")
    check(d8["paged_attention_int8"] > 0 and d8["ragged_paged_attention_int8"] > 0,
          f"the int8 pool did not run the kernels' int8 branch: {d8}")
    agree = sum(a == b for s8, s in zip(r8["streams"], [streams[0], streams[1],
                                                         streams[4], streams[5]])
                for a, b in zip(s8, s))
    log(f"paged engine: int8 pool, 4 x 32 tokens in {r8['wall']:.3f} s, int8 launches "
        f"{d8['paged_attention_int8']} (K2) / {d8['ragged_paged_attention_int8']} (K3); "
        f"{agree}/128 tokens equal to the bf16 pool's")
    q8.close()
    del q8
    torch.cuda.empty_cache()
    return eng, launches


def paged_serve_phase(eng, card: str) -> None:
    """Eight concurrent completions (four SSE) over the paged engine, each
    equal to the scheduler's own greedy stream; then 429 on a full queue."""
    from fei_tpu_torch.agent.providers import TorchLocalProvider
    from fei_tpu_torch.engine import GenerationConfig
    from fei_tpu_torch.ui.server import ServeAPI, ServingServer

    tok = eng.tokenizer
    # byte tokenizer over llama3-8b's vocab: the serve phase of the dense
    # path already zeroed the LM head past the tokenizer's ids (shared params)
    check(bool((eng.params["lm_head"][:, tok.vocab_size:] == 0).all()),
          "expected the LM head zeroed past the byte tokenizer's ids")
    api = ServeAPI(TorchLocalProvider(engine=eng), model_name=eng.cfg.name)
    server = ServingServer(api, host="127.0.0.1", port=0)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    words = "pages tables kernels streams batches tokens heads warps".split()
    bodies = []
    for i in range(8):
        text = " ".join(words[(i + j) % len(words)] for j in range(12 + 90 * (i % 4)))
        bodies.append({"messages": [{"role": "user", "content": text}],
                       "max_tokens": 24, "ignore_eos": True, "stream": i % 2 == 1,
                       "model": eng.cfg.name})

    def post(body):
        req = urllib.request.Request(base + "/v1/chat/completions",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"},
                                     method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.read()

    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as ex:
            results = list(ex.map(post, bodies))
        dt = time.perf_counter() - t0
        for i, (body, (status, raw)) in enumerate(zip(bodies, results)):
            check(status == 200, f"request {i}: HTTP {status}")
            if body["stream"]:
                frames = [ln[6:] for ln in raw.decode().split("\n") if ln.startswith("data: ")]
                check(frames and frames[-1] == "[DONE]", f"request {i}: no [DONE]")
                chunks = [json.loads(f) for f in frames[:-1]]
                check(all("error" not in c for c in chunks), f"request {i}: {chunks}")
                content = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
            else:
                content = json.loads(raw)["choices"][0]["message"]["content"]
            ids = tok.apply_chat_template(body["messages"], add_generation_prompt=True)
            want = list(eng.scheduler.stream(
                ids, GenerationConfig(max_new_tokens=24, ignore_eos=True)))
            want_text = tok.decode(want).strip()
            check(len(content.strip()) > 0, f"request {i}: empty completion")
            check(content.strip() == want_text,
                  f"request {i}: served {content.strip()!r}, scheduler says {want_text!r}")
        log(f"paged serve: 8 concurrent completions (4 SSE, prompts "
            f"{[len(tok.apply_chat_template(b['messages'], add_generation_prompt=True)) for b in bodies]}"
            f" tokens) in {dt * 1e3:.1f} ms on {card}, each equal to the scheduler's stream")

        # backpressure: 8 running + 1 queued fill a queue capped at 1
        sched = eng.scheduler
        hold = [sched.submit([5] * 64, GenerationConfig(max_new_tokens=512, ignore_eos=True))
                for _ in range(9)]
        deadline = time.perf_counter() + 120
        while time.perf_counter() < deadline and not (
                len(sched._waiting) >= 1 and all(s is not None for s in sched._slots)):
            time.sleep(0.01)
        sched.max_queue = 1
        try:
            post(dict(bodies[0], stream=False))
            status, headers = 200, {}
        except urllib.error.HTTPError as exc:
            status, headers = exc.code, dict(exc.headers)
        for s in hold:
            sched.cancel(s)
        sched.max_queue = 0
        check(status == 429, f"a request over the queue cap got HTTP {status}, not 429")
        check("Retry-After" in headers, "429 without Retry-After")
        log(f"paged serve: queue capped at 1 with 8 running + 1 queued: HTTP 429, "
            f"Retry-After {headers['Retry-After']}")
    finally:
        server.stop()


# ------------------------------------------------------------------ agent

AGENT_MESSAGES = ("list the python files", "grep for TODO", "run ls", "open README",
                  "find the tests", "look around", "scan for bugs", "check the docs")
AGENT_MAX_TOKENS = 160
NEIGHBOUR_LENS = (40, 90, 120, 160, 200, 230, 250)  # dense admission, no chunks
NEIGHBOUR_NEW = 48


def fixed_point_trigger(provider, messages, system, tools, widths=(4, 8, 2), rounds=6):
    """The trigger the random model emits for the provider's EXACT prompt.
    The trigger appears in the rendered tool prompt, so iterate until the
    greedy prefix of ``width`` tokens (at least 2, so that it completes
    inside the scheduler's first multi-step scan) of the prompt that
    contains it is the trigger itself. Returns (trigger, its width)."""
    for width in widths:
        for _ in range(rounds):
            full = provider._messages_with_system(messages, system, tools)
            ids = provider.engine.tokenizer.apply_chat_template(full, add_generation_prompt=True)
            toks = list(provider.engine.generate_stream(ids, provider._GenerationConfig(
                max_new_tokens=width, ignore_eos=True, chunk=1)))
            text = provider.engine.tokenizer.decode(toks)
            if not text:
                break
            if text == provider.tool_trigger:
                return text, width
            provider.tool_trigger = text
    return None, 0


def find_trigger(provider, system, tools):
    for content in AGENT_MESSAGES:
        messages = [{"role": "user", "content": content}]
        trig, width = fixed_point_trigger(provider, messages, system, tools)
        if trig:
            return messages, trig, width
    raise RuntimeError("no agent message converges to a fixed-point trigger")


def check_call(resp, tools):
    check(resp.stop_reason == "tool_use", f"stop_reason {resp.stop_reason!r}, not tool_use")
    check(len(resp.tool_calls) == 1, f"{len(resp.tool_calls)} tool calls, expected 1")
    call = resp.tool_calls[0]
    schemas = {t["name"]: t["input_schema"] for t in tools}
    check(call.name in schemas, f"tool {call.name!r} is not in the registry")
    check(isinstance(call.arguments, dict), f"arguments {call.arguments!r} are not a dict")
    missing = [r for r in schemas[call.name].get("required", []) if r not in call.arguments]
    check(not missing, f"{call.name} call lacks required arguments {missing}")
    return call


def same_or_tie(dense, prompt, want, got, label):
    """Streams equal, or first apart at a gap of at most 2 bf16 ulps (F1)."""
    if got == want:
        return "equal"
    j, gap, ulp = first_divergence(dense, prompt, want, got)
    log(f"agent: {label} first differs at token {j}; logit gap there {gap:.6g} "
        f"({gap / ulp:.3g} bf16 ulps)")
    check(abs(gap) <= 2 * ulp, f"{label} differs at token {j} by {gap / ulp:.3g} bf16 "
          f"ulps (> 2)")
    return f"tie at token {j} ({gap / ulp:.3g} ulps)"


def chunk_ms(engine, ids, gen, grammar, reps: int = 3) -> tuple[float, float]:
    """Host-clock time of one 16-token decode chunk on the turn's prompt,
    from dispatch to the chunk's tokens on the host: the free chunk
    (build_fused_decode) and the constrained one (_grammar_fused_fn, the
    DFA's table row, mask and state step in each step), each from the same
    cache length, median of ``reps``."""
    logits, cache = engine.prefill([ids], engine.new_cache(1))
    n = len(ids)
    tok = logits.argmax(-1).to(torch.int32).reshape(1, 1)
    table, min_dist = grammar.device_tables(engine.cfg.vocab_size, engine.device)
    free = engine._free_fused_fn(gen, 16)
    cons = engine._grammar_fused_fn(gen, 16)
    dev = engine.device
    done = torch.zeros((1,), dtype=torch.bool, device=dev)
    stops = torch.zeros((0,), dtype=torch.int32, device=dev)
    times = {"free": [], "constrained": []}
    for _ in range(reps + 1):
        for kind in times:
            cache = cache._replace(length=torch.full_like(cache.length, n))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "free":
                toks, cache, _, _ = free(engine.params, cache, tok, None, done, stops)
            else:
                toks, cache, _, _, _ = cons(
                    engine.params, cache, tok, None,
                    torch.tensor([grammar.entry], dtype=torch.int32, device=dev),
                    torch.tensor(AGENT_MAX_TOKENS, dtype=torch.int32, device=dev),
                    table, min_dist)
            toks.tolist()
            times[kind].append(time.perf_counter() - t0)
    return (float(np.median(times["free"][1:])) * 1e3,
            float(np.median(times["constrained"][1:])) * 1e3)


def agent_phase(dense, paged, card: str) -> dict:
    """The agent turn on the card (bf16 llama3-8b, the LM head zeroed past
    the byte tokenizer's ids by the serve phase): the grammar-enforced tool
    call on the dense engine through ``TorchLocalProvider``, the same turn
    on the paged engine beside seven free requests, and one round of the
    ``--message`` loop with recording tool handlers. Returns the kernel
    launches of the agent path's own runs: the provider turn, the paged
    turn alone and at multistep=1, the paged turn beside seven free
    requests, and the ``--message`` round. Each is counted from 0 just
    before it and read just after; the trigger probes, the chunk timings,
    the references and the free requests' baseline run outside."""
    import contextlib
    import io

    from fei_tpu_torch.agent import Assistant
    from fei_tpu_torch.agent.providers import TorchLocalProvider
    from fei_tpu_torch.engine import GenerationConfig
    from fei_tpu_torch.engine.grammar import char_walk
    from fei_tpu_torch.ops.kernels.flash_attention import flash_attention
    from fei_tpu_torch.tools import TOOL_DEFINITIONS, ToolRegistry
    from fei_tpu_torch.ui.cli import History, process_single_message

    tools = TOOL_DEFINITIONS
    check(bool((dense.params["lm_head"][:, dense.tokenizer.vocab_size:] == 0).all()),
          "expected the LM head zeroed past the byte tokenizer's ids")
    provider = TorchLocalProvider(engine=dense, gen_overrides={"ignore_eos": True})
    check(provider.constrain_tools, "constrain_tools is off by default")
    launched = dict.fromkeys(read_counts(), 0)

    @contextlib.contextmanager
    def agent_path():
        """One run of the agent path: the counts from 0 just before it,
        added to ``launched`` just after."""
        reset_counts()
        yield
        for k, v in read_counts().items():
            launched[k] += v

    grammar = provider._tool_grammar(tools)
    check(grammar is not None, "the tool grammar did not compile")
    t0 = time.perf_counter()
    table, _ = grammar.device_tables(dense.cfg.vocab_size, dense.device)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    table_bytes = table.numel() * table.element_size()
    log(f"agent: union grammar of {len(tools)} tools on the byte tokenizer: "
        f"{grammar.table.shape[0]} states, min_dist[entry] "
        f"{int(grammar.min_dist[grammar.entry])}, lift {grammar.lift_seconds:.3f} s (host), "
        f"device table {tuple(table.shape)} {table.dtype} = {table_bytes / 1e6:.1f} MB, "
        f"upload {upload_s * 1e3:.1f} ms on {card}")
    check(tuple(table.shape) == (grammar.table.shape[0], dense.cfg.vocab_size)
          and table.dtype == torch.int16, "device table shape/dtype")
    check(provider._tool_grammar(list(tools)) is grammar
          and grammar.device_tables(dense.cfg.vocab_size, dense.device)[0] is table,
          "the tool set's grammar or its device table is not memoized")

    # (a) the dense turn through the provider, at the fixed-point trigger
    t0 = time.perf_counter()
    messages, trig, width = find_trigger(provider, None, tools)
    log(f"agent: fixed-point trigger {ascii(trig)} ({width} tokens) for {messages[0]['content']!r} "
        f"found in {time.perf_counter() - t0:.1f} s")
    full = provider._messages_with_system(messages, None, tools)
    ids = dense.tokenizer.apply_chat_template(full, add_generation_prompt=True)
    fused0, disp0 = counter("engine.grammar_fused_steps"), counter("engine.decode_dispatches")
    provider.last_ttft_s = None
    with agent_path():
        t0 = time.perf_counter()
        resp = provider.complete(messages, tools=tools, max_tokens=AGENT_MAX_TOKENS)
        torch.cuda.synchronize()
        turn_s = time.perf_counter() - t0
        k1_turn = flash_attention.launches
    fused = counter("engine.grammar_fused_steps") - fused0
    dispatches = counter("engine.decode_dispatches") - disp0
    call = check_call(resp, tools)
    ntok = resp.usage["completion_tokens"]
    check(fused > 0, "the turn never ran the fused grammar decode")
    check(k1_turn >= dense.cfg.num_layers, f"the turn's prefill launched K1 {k1_turn} times")
    # one host sync per chunk, not per token: the free chunks up to the
    # trigger (the one in flight included) and the constrained chunks
    most = 2 + math.ceil(width / 16) + math.ceil(fused / 16)
    check(dispatches <= most, f"{dispatches} dispatches for {ntok} tokens (> {most})")
    log(f"agent: dense turn on {card}: prompt {len(ids)} tokens, {ntok} tokens "
        f"({fused:.0f} constrained) in {dispatches:.0f} dispatches (one host sync each), "
        f"TTFT {provider.last_ttft_s * 1e3:.1f} ms, turn {turn_s:.3f} s, K1 launches "
        f"{k1_turn}; call {call.name}({json.dumps(call.arguments)[:160]})")

    gen = GenerationConfig(max_new_tokens=AGENT_MAX_TOKENS, ignore_eos=True)
    free_ms, cons_ms = chunk_ms(dense, ids, gen, grammar)
    log(f"agent: one 16-token chunk on the {len(ids)}-token prompt on {card}: free "
        f"{free_ms:.2f} ms, constrained {cons_ms:.2f} ms ({cons_ms / free_ms:.3f}x)")

    # (b) generate_constrained equals the host-masked per-token reference
    gc_gen = GenerationConfig(max_new_tokens=48, ignore_eos=True)
    got = dense.generate_constrained(ids, grammar, gc_gen).token_ids
    want = dense.generate(ids, gc_gen, logit_mask_fn=grammar.logit_mask_fn(max_tokens=48)).token_ids
    check(got == want, "generate_constrained differs from the host-masked reference")
    check(char_walk(grammar, dense.tokenizer.decode(got)) == grammar.accept,
          "generate_constrained did not complete a call within its budget")
    log(f"agent: generate_constrained == generate(logit_mask_fn) for {len(got)} greedy tokens")

    # where the turn's time goes (host clock, each token stamped as the
    # engine's stream yields it): the prefill and first sample (TTFT), the
    # free phase up to the trigger token (its chunk and the one in flight
    # rolled back), the constrained phase (its chunks, one host sync each)
    stamps, want_toks = [], []
    t0 = time.perf_counter()
    for tok in dense.generate_stream_toolcalls(ids, gen, grammar=grammar, trigger=trig):
        stamps.append(time.perf_counter() - t0)
        want_toks.append(tok)
    check(dense.tokenizer.decode(want_toks[:width]) == trig, "the turn does not open with its trigger")
    n_cons = len(want_toks) - width - len(dense.tokenizer.encode("</tool_call>"))
    chunks = math.ceil(n_cons / 16)
    free_s, cons_s = stamps[width - 1] - stamps[0], stamps[-1] - stamps[width - 1]
    log(f"agent: the dense turn's engine stream on {card}: TTFT {stamps[0] * 1e3:.1f} ms, "
        f"free phase ({width - 1} tokens after the first) {free_s * 1e3:.1f} ms, "
        f"constrained phase ({n_cons} tokens, {chunks} chunks) {cons_s * 1e3:.1f} ms "
        f"({cons_s * 1e3 / chunks:.1f} ms a chunk), in all {stamps[-1] * 1e3:.1f} ms (the "
        f"provider's turn above: {turn_s * 1e3:.1f} ms)")

    # (c) the paged turn: alone (multistep 8, then 1), then beside seven
    # free requests; the dense turn's tokens, within F1's rule
    sched = paged.scheduler
    rb0, rbt0 = counter("scheduler.turbo_rollbacks"), counter("scheduler.turbo_rollback_tokens")
    with agent_path():
        alone = list(paged.generate_stream_toolcalls(ids, gen, grammar=grammar, trigger=trig))
        check(read_counts()["paged_attention"] > 0, "the paged turn never launched K2")
    rollbacks = counter("scheduler.turbo_rollbacks") - rb0
    check(rollbacks > 0, "the paged turn's trigger never rolled the scan back")
    verdict = same_or_tie(dense, ids, want_toks, alone, "paged turn vs dense turn")
    sched.multistep = 1
    with agent_path():
        single = list(paged.generate_stream_toolcalls(ids, gen, grammar=grammar, trigger=trig))
    sched.multistep = 8
    check(single == alone, "the paged turn changed with multistep=1")
    log(f"agent: paged turn ({len(alone)} tokens) vs dense: {verdict}; rollbacks "
        f"{rollbacks:.0f} ({counter('scheduler.turbo_rollback_tokens') - rbt0:.0f} "
        f"tokens discarded); multistep=1 gives the same tokens")

    rng = np.random.default_rng(SEED + 7)
    others = [rng.integers(8, dense.tokenizer.vocab_size, n).tolist() for n in NEIGHBOUR_LENS]
    free_gen = GenerationConfig(max_new_tokens=NEIGHBOUR_NEW, ignore_eos=True)

    def neighbours(with_turn: bool):
        seqs = [sched.submit(p, free_gen) for p in others]
        turn = None
        if with_turn:
            # once every neighbour decodes, the turn's prompt admits in
            # chunks merged with their decode (K3)
            deadline = time.perf_counter() + 300
            while not all(s.generated for s in seqs) and time.perf_counter() < deadline:
                time.sleep(0.005)
            turn = sched.submit(ids, gen, grammar=grammar, grammar_trigger=trig)
        streams = [list(sched.drain(s)) for s in seqs]
        return streams, (list(sched.drain(turn)) if turn is not None else None), turn

    base, _, _ = neighbours(False)  # the baseline: not the agent path
    merged0 = counter("engine.ragged_dispatches")
    with agent_path():
        t0 = time.perf_counter()
        streams, turn_toks, seq = neighbours(True)
        wall = time.perf_counter() - t0
        check(read_counts()["ragged_paged_attention"] > 0,
              "the merged dispatches never launched K3")
    merged = counter("engine.ragged_dispatches") - merged0
    check(merged > 0, "the turn's chunks never merged with live decode")
    check(streams == base, "a free request's stream changed beside the constrained turn")
    check(seq.gaccepted, "the constrained turn beside the free requests was not accepted")
    check(turn_toks + dense.tokenizer.encode("</tool_call>") == alone,
          "the constrained turn changed beside the free requests")
    log(f"agent: the paged turn beside {len(others)} free requests ({NEIGHBOUR_NEW} tokens "
        f"each) in {wall:.3f} s, {merged:.0f} of its chunks merged with their decode: every "
        f"free stream equal to its run without the turn, the turn equal to its run alone")

    # (d) one round of the --message loop; recording handlers only: a random
    # model's tool call never runs a real shell, file or network tool
    seen: list[dict] = []
    registry = ToolRegistry()
    for t in tools:
        registry.register_tool(t["name"], t["description"], t["input_schema"],
                               lambda _t=t["name"], **kw: seen.append({_t: kw}) or {"ok": True})
    assistant = Assistant(provider=provider, tool_registry=registry,
                          max_tokens=AGENT_MAX_TOKENS, max_tool_rounds=1)
    assistant.on_text = None
    messages2, trig2, _ = find_trigger(provider, assistant.system_prompt,
                                       assistant.tool_manager.get_tools())
    with (tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(io.StringIO()),
          agent_path()):
        rc = process_single_message(assistant, messages2[0]["content"],
                                    History(path=f"{d}/history.json"))
    check(rc == 0, f"process_single_message returned {rc}")
    calls = [c for m in assistant.conversation.messages for c in (m.get("tool_calls") or [])]
    check(bool(calls and seen), "the loop executed no tool call")
    name, args = calls[0]["name"], calls[0]["arguments"]
    check(seen[0] == {name: args}, f"the handler got {seen[0]}, the call was {name}({args})")
    log(f"agent: --message loop (trigger {ascii(trig2)}): one round, {name} executed through "
        f"a recording handler with the decoded arguments {json.dumps(args)[:160]}")
    return launched


# ------------------------------------------------------ quantized weights

QUANT_LENS = (96, 250, 700, 1500)  # two dense admissions, two chunked
QUANT_NEW = 64


def quant_dense_phase(card: str, bf16_bytes: int):
    """llama3-8b at full width and depth with int4 weights (K4 in every big
    linear), then with int8 weights. Returns the int4 engine."""
    from fei_tpu_torch.engine import GenerationConfig, InferenceEngine
    from fei_tpu_torch.ops.quant import QTensor4, dequantize_params, param_bytes

    t0 = time.perf_counter()
    eng = InferenceEngine.from_config(
        "llama3-8b", dtype=torch.bfloat16, seed=SEED, max_seq_len=8192, device="cuda",
        quantize="int4")
    torch.cuda.synchronize()
    cfg, L = eng.cfg, eng.cfg.num_layers
    nbytes = param_bytes(eng.params)
    log(f"int4 engine: {cfg.name}, param_bytes {nbytes / 1e9:.3f} GB (bf16 "
        f"{bf16_bytes / 1e9:.3f} GB), weights a decode step reads "
        f"{weight_stream_bytes(eng.params) / 1e9:.3f} GB; random init in "
        f"{time.perf_counter() - t0:.1f} s")
    check(nbytes < 0.4 * bf16_bytes, "int4 params are not smaller than 40% of bf16's")
    prompt = np.random.default_rng(SEED).integers(8, cfg.vocab_size, size=1500).tolist()

    # the int4 dense path starts here: every kernel count from 0
    reset_counts()
    logits, _ = eng.prefill([prompt], eng.new_cache(1))
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts["int4_matmul"] == 7 * L,
          f"int4 prefill launched int4_matmul {counts['int4_matmul']} times, expected {7 * L}")
    check(counts["flash_attention_fwd"] == L, f"int4 prefill: flash launches {counts}")
    check(torch.isfinite(logits).all().item(), "int4 prefill logits not finite")
    log(f"int4 engine: prefill of {len(prompt)} tokens launched int4_matmul "
        f"{counts['int4_matmul']} times (7 linears x {L} layers), flash {counts['flash_attention_fwd']}")

    # the same weights with every QTensor4 dequantized to bf16 and
    # multiplied plainly (cuBLAS); the int8 LM head stays as it is
    deq = InferenceEngine.from_config(
        "llama3-8b", dtype=torch.bfloat16, max_seq_len=8192, device="cuda",
        params=dequantize_params(eng.params, torch.bfloat16, only=(QTensor4,)))
    reset_counts()
    plain, _ = deq.prefill([prompt], deq.new_cache(1))
    torch.cuda.synchronize()
    check(read_counts()["int4_matmul"] == 0, "the dequantized engine launched int4_matmul")
    del deq
    torch.cuda.empty_cache()
    rel = ((logits - plain).norm() / plain.norm()).item()
    # tolerance: the two runs multiply the same bf16 weight values and
    # round each product to bf16; only the fp32 summation order differs,
    # and 32 layers of such perturbations stay within a few percent of the
    # logits' norm, as the bf16 engine's flash-vs-plain gap above does
    log(f"int4 engine: last-position prefill logits vs the dequantized weights: "
        f"max_abs_diff={(logits - plain).abs().max().item():.6g}, rel_l2={rel:.6g} "
        f"(tol 3e-2), argmax {int(logits.argmax())} vs {int(plain.argmax())}")
    check(rel <= 3e-2, f"int4 vs dequantized prefill logits rel_l2 {rel} > 3e-2")
    del plain

    res = eng.generate(prompt, GenerationConfig(max_new_tokens=128, ignore_eos=True, chunk=16))
    check(len(res.token_ids) == 128, f"int4 decoded {len(res.token_ids)} tokens, expected 128")
    check(all(0 <= t < cfg.vocab_size for t in res.token_ids), "int4 token id out of range")
    ttft_bound, tok_s_bound = serving_bounds(cfg, len(prompt), 128, weight_stream_bytes(eng.params))
    log(f"int4 engine: {len(prompt)}-token prompt, 128 greedy tokens (chunk 16) on {card}: "
        f"TTFT {res.ttft_s * 1e3:.1f} ms (bound {ttft_bound:.1f} ms), decode "
        f"{res.decode_tokens_per_s:.2f} tok/s (bound {tok_s_bound:.1f} tok/s at int4 bytes)")

    t0 = time.perf_counter()
    eng8 = InferenceEngine.from_config(
        "llama3-8b", dtype=torch.bfloat16, seed=SEED, max_seq_len=8192, device="cuda",
        quantize="int8")
    torch.cuda.synchronize()
    init8 = time.perf_counter() - t0
    reset_counts()
    res8 = eng8.generate(prompt, GenerationConfig(max_new_tokens=32, ignore_eos=True, chunk=16))
    check(read_counts()["int4_matmul"] == 0, "the int8 engine launched int4_matmul")
    check(len(res8.token_ids) == 32, f"int8 decoded {len(res8.token_ids)} tokens, expected 32")
    ttft8, tok8 = serving_bounds(cfg, len(prompt), 32, weight_stream_bytes(eng8.params))
    log(f"int8 engine: param_bytes {param_bytes(eng8.params) / 1e9:.3f} GB (init {init8:.1f} s); "
        f"{len(prompt)}-token prompt, 32 greedy tokens on {card}: TTFT {res8.ttft_s * 1e3:.1f} ms "
        f"(bound {ttft8:.1f} ms), decode {res8.decode_tokens_per_s:.2f} tok/s (bound "
        f"{tok8:.1f} tok/s at int8 bytes; each int8 product casts its weight to a bf16 copy "
        f"first), int4_matmul launches 0")
    del eng8
    torch.cuda.empty_cache()
    return eng


def quant_paged_phase(dense4, card: str) -> dict:
    """The int4 weights behind the paged engine: four requests from
    threads, each stream held against the dense int4 engine's greedy
    stream, then ragged off and a tight pool. Returns the main run's
    kernel launches."""
    from fei_tpu_torch.engine import GenerationConfig, InferenceEngine

    cfg = dense4.cfg
    rng = np.random.default_rng(SEED + 2)
    prompts = [rng.integers(8, cfg.vocab_size, size=n).tolist() for n in QUANT_LENS]
    gen = GenerationConfig(max_new_tokens=QUANT_NEW, ignore_eos=True)
    want = [dense4.generate(p, gen).token_ids for p in prompts]

    def paged(**kw):
        return InferenceEngine.from_config(
            "llama3-8b", dtype=torch.bfloat16, params=dense4.params, max_seq_len=8192,
            device="cuda", paged=True, batch_size=8, page_size=PAGE, **kw)

    eng = paged()
    # the int4 paged path starts here: every kernel count from 0
    reset_counts()
    main = traffic(eng, prompts, QUANT_NEW)
    launches = read_counts()
    streams = main["streams"]
    log(f"int4 paged engine: prompts {QUANT_LENS} x {QUANT_NEW} greedy tokens in "
        f"{main['wall']:.3f} s on {card}, TTFT "
        f"{[round(t * 1e3, 1) for t in main['ttft']]} ms, launches {launches}")
    for name in ("int4_matmul", "paged_attention", "ragged_paged_attention"):
        check(launches[name] > 0, f"the int4 paged path never launched {name}")
    # against the dense int4 engine: the two decode through different
    # attention arithmetic (dense: the plain fp32 path; paged: K2/K3, which
    # round the softmax weights to bf16), and their logits are bf16 values
    # (the LM head's product), so two candidates can tie exactly. A stream
    # must equal the dense one, or first leave it where the two tokens'
    # dense logits are within 2 bf16 ulps — a tie broken the other way.
    # A wrong product would leave it at a clear gap, within a few tokens.
    same = [a == b for a, b in zip(streams, want)]
    log(f"int4 paged engine: streams equal to the dense int4 engine's: {same}")
    for i, ok in enumerate(same):
        if not ok:
            j, gap, ulp = first_divergence(dense4, prompts[i], want[i], streams[i])
            log(f"int4 paged engine: stream {i} (prompt {len(prompts[i])}) first differs "
                f"from the dense stream at token {j}; dense logit gap there {gap:.6g} "
                f"({gap / ulp:.3g} bf16 ulps)")
            check(abs(gap) <= 2 * ulp, f"int4 paged stream {i} leaves the dense stream at "
                  f"token {j} with a logit gap of {gap / ulp:.3g} bf16 ulps, not a tie")

    eng.scheduler.ragged_attention = False
    check(traffic(eng, prompts, QUANT_NEW)["streams"] == streams,
          "int4 paged streams changed with ragged_attention=False")
    eng.close()
    # the 1564-token request fits alone (25 pages), all four do not (45)
    tight = paged(num_pages=30)
    pre0 = counter("scheduler.preemptions")
    t_run = traffic(tight, prompts, QUANT_NEW)
    pre = counter("scheduler.preemptions") - pre0
    tight.close()
    check(pre >= 1, "the int4 tight pool never preempted")
    check(t_run["streams"] == streams, "int4 tight-pool streams differ from the roomy run's")
    log(f"int4 paged engine: ragged_attention=False gives the same streams; tight pool "
        f"(30 pages): {pre:.0f} preemptions in {t_run['wall']:.3f} s, the same streams")
    torch.cuda.empty_cache()
    return launches


def quant_provider_phase(dense4, card: str) -> None:
    """``TorchLocalProvider`` built from the configuration ([torch_local]
    quantize = int4, here through its FEI_TPU_TORCH_LOCAL_* variables)
    answers one completion through the server, equal to its engine's own
    greedy stream."""
    import os
    from unittest import mock

    from fei_tpu_torch.agent.providers import TorchLocalProvider
    from fei_tpu_torch.engine import GenerationConfig
    from fei_tpu_torch.ops.quant import QTensor4
    from fei_tpu_torch.ui.server import ServeAPI, ServingServer

    env = {"FEI_TPU_TORCH_LOCAL_MODEL": "llama3-8b", "FEI_TPU_TORCH_LOCAL_QUANTIZE": "int4",
           "FEI_TPU_TORCH_LOCAL_MAX_SEQ_LEN": "2048", "FEI_TPU_TORCH_LOCAL_TOKENIZER": "byte"}
    with mock.patch.dict(os.environ, env):
        provider = TorchLocalProvider()
    engine = provider.engine
    check(isinstance(engine.params["layers"]["wq"], QTensor4), "the provider's engine is not int4")
    check(torch.equal(engine.params["layers"]["wq"].p, dense4.params["layers"]["wq"].p),
          "the provider's int4 weights differ from the same seed's")
    # as in the serve phase: an LM head zeroed past the byte tokenizer's
    # ids (the int8 head's values) makes the random model's picks text
    tok = engine.tokenizer
    engine.params["lm_head"].q[:, tok.vocab_size:] = 0
    api = ServeAPI(provider, model_name=engine.cfg.name)
    server = ServingServer(api, host="127.0.0.1", port=0)
    server.start()
    try:
        body = {"messages": [{"role": "user", "content": "Pack two int4 weights per byte."}],
                "max_tokens": 16, "ignore_eos": True, "model": engine.cfg.name}
        reset_counts()
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/v1/chat/completions",
            data=json.dumps(body).encode(), headers={"Content-Type": "application/json"},
            method="POST")
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            status, raw = r.status, r.read()
        dt = time.perf_counter() - t0
        launched = read_counts()["int4_matmul"]
        check(status == 200, f"int4 provider: HTTP {status}")
        content = json.loads(raw)["choices"][0]["message"]["content"].strip()
        ids = tok.apply_chat_template(body["messages"], add_generation_prompt=True)
        want = tok.decode(engine.generate(ids, GenerationConfig(
            max_new_tokens=16, ignore_eos=True)).token_ids).strip()
        check(len(content) > 0, "int4 provider: empty completion")
        check(content == want, f"int4 provider: served {content!r}, engine says {want!r}")
        check(launched > 0, "the int4 provider's request never launched int4_matmul")
        log(f"int4 provider: [torch_local] quantize=int4 -> 200 in {dt * 1e3:.1f} ms on {card}, "
            f"{len(content)} chars {content!r}, int4_matmul launches {launched}")
    finally:
        server.stop()


# ---------------------------------------------------------------- training

TRAIN_LAYERS = 32  # llama3-8b's full depth
TRAIN_TOKENS = 2049  # one sequence: T = 2048 positions to predict from
TRAIN_STEPS = 3


def train_step_bound_ms(cfg, T: int, param_bytes: int) -> float:
    """The card's least time for one remat'd step on T positions: four
    times the forward's operations (forward, recompute, and a backward of
    twice the forward: every linear layer, the LM head and the causal
    attention) at the bf16 peak, plus the optimizer's seven passes over the
    parameters' bytes (read p, g, mu, nu; write p, mu, nu) at the memory
    rate."""
    h, d, L = cfg.hidden_size, cfg.head_dim_, cfg.num_layers
    H, K, I, V = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size, cfg.vocab_size
    per_layer = h * H * d + 2 * h * K * d + H * d * h + 3 * h * I
    fwd = 2.0 * T * (L * per_layer + h * V) + 4.0 * d * H * L * T * (T + 1) / 2
    return (4.0 * fwd / PEAK_BF16_FLOPS + 7.0 * param_bytes / PEAK_BYTES_PER_S) * 1e3


def train_phase(card: str) -> dict:
    """The training path on the card; returns the kernel launches of the
    three full-width steps."""
    from fei_tpu_torch.engine import restore_checkpoint, save_checkpoint
    from fei_tpu_torch.engine.train import TrainConfig, loss_and_grads, make_train_step
    from fei_tpu_torch.models.configs import get_model_config
    from fei_tpu_torch.models.llama import init_params
    from fei_tpu_torch.ops.quant import param_bytes
    from fei_tpu_torch.utils.tree import flatten, tree_map

    cfg = get_model_config("llama3-8b", num_layers=TRAIN_LAYERS)
    L = cfg.num_layers
    tokens = torch.from_numpy(
        np.random.default_rng(SEED + 3).integers(8, cfg.vocab_size, size=(1, TRAIN_TOKENS)))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, dtype=torch.bfloat16, device="cuda")
    opt, step = make_train_step(cfg, TrainConfig(remat=True))
    state = opt.init(params)
    torch.cuda.synchronize()
    nbytes = param_bytes(params)
    log(f"train: {cfg.name} L={L} h={cfg.hidden_size} H={cfg.num_heads} K={cfg.num_kv_heads} "
        f"I={cfg.intermediate_size} V={cfg.vocab_size}, bf16, {nbytes / 1e9:.3f} GB of "
        f"parameters, two moments beside them; init in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated before the first step")

    # the training path starts here: every kernel count from 0
    reset_counts()
    losses, step_ms, per_step = [], [], []
    for i in range(TRAIN_STEPS):
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, loss = step(params, state, tokens)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        after = read_counts()
        per_step.append({k: after[k] - before[k] for k in after})
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    bound = train_step_bound_ms(cfg, TRAIN_TOKENS - 1, nbytes)
    ln_v = math.log(cfg.vocab_size)
    log(f"train: {TRAIN_STEPS} steps on one sequence of {TRAIN_TOKENS} ids on {card}: loss "
        f"{[round(x, 4) for x in losses]} (ln V = {ln_v:.2f}), step "
        f"{[round(x, 1) for x in step_ms]} ms (bound {bound:.1f} ms), "
        f"{(TRAIN_TOKENS - 1) / (min(step_ms) / 1e3):.1f} training tokens/s at the fastest "
        f"step, peak memory {peak / 1e9:.2f} GB, launches per step "
        f"{[(d['flash_attention_fwd'], d['flash_attention_bwd_dq'], d['flash_attention_bwd_dkv']) for d in per_step]} "
        "(K1, K5a, K5b)")
    check(all(math.isfinite(x) for x in losses), f"a training loss is not finite: {losses}")
    # random weights: logits are ~N(0, 1), so the loss starts near ln V + 1/2
    check(abs(losses[0] - ln_v) < 1.5, f"the first loss {losses[0]} is not near ln V {ln_v:.2f}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    for d in per_step:
        got = (d["flash_attention_fwd"], d["flash_attention_bwd_dq"],
               d["flash_attention_bwd_dkv"])
        check(got == (2 * L, L, L), f"a step launched K1/K5a/K5b {got}, expected "
              f"{(2 * L, L, L)} (forward and recompute; one backward each)")
    check(all(t.dtype == torch.bfloat16 for t in flatten(state["mu"]).values()),
          "the moments are not in the parameters' dtype")
    del params, state, opt, step
    gc.collect()
    torch.cuda.empty_cache()

    # two layers, full width: one step's gradients through the kernels
    # against autograd through the plain attention (flash=False)
    cfg2 = get_model_config("llama3-8b", num_layers=2)
    params = init_params(cfg2, seed=SEED, dtype=torch.bfloat16, device="cuda")
    before = read_counts()
    loss_k, grads_k = loss_and_grads(params, cfg2, tokens, remat=True)
    d = {k: v - before[k] for k, v in read_counts().items()}
    check((d["flash_attention_fwd"], d["flash_attention_bwd_dq"],
           d["flash_attention_bwd_dkv"]) == (4, 2, 2), f"two-layer step launches {d}")
    before = read_counts()
    loss_p, grads_p = loss_and_grads(params, cfg2, tokens, remat=True, flash=False)
    check(read_counts() == before, "flash=False launched a flash kernel")
    # tolerance: the two backwards differ by the bf16 roundings of the
    # attention outputs, of p and of ds (2^-8 relative each, independent
    # from element to element), which reach every leaf through at most two
    # layers: a few parts in a thousand of a leaf's norm. 5e-2 leaves room
    # for the small leaves (norm weights) and is far below a wrong
    # backward's O(1)
    worst = ("", 0.0)
    for (path, gk), gp in zip(flatten(grads_k).items(), flatten(grads_p).values()):
        rel = ((gk.float() - gp.float()).norm() / gp.float().norm().clamp_min(1e-30)).item()
        log(f"train: 2 layers, d loss / d {path}: kernels vs plain attention rel_l2={rel:.4g} "
            f"(|g| {gp.float().norm().item():.4g})")
        check(math.isfinite(rel) and rel <= 5e-2, f"gradient of {path}: rel_l2 {rel} > 5e-2")
        worst = max(worst, (path, rel), key=lambda x: x[1])
    log(f"train: 2 layers, loss {float(loss_k):.6f} (kernels) vs {float(loss_p):.6f} (plain "
        f"attention); worst gradient rel_l2 {worst[1]:.4g} at {worst[0]} (tol 5e-2)")
    check(abs(float(loss_k) - float(loss_p)) <= 1e-2, "kernel and plain losses differ")
    del grads_k, grads_p

    # checkpoint: two steps, save, a third step; restore, one step: bitwise
    # the uninterrupted run's loss, parameters and moments
    opt, step = make_train_step(cfg2, TrainConfig(remat=True))
    state = opt.init(params)
    for _ in range(2):
        params, state, _ = step(params, state, tokens)
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        save_checkpoint(ckpt, 2, params, opt_state=state)
        t_save = time.perf_counter() - t0
        params, state, loss_a = step(params, state, tokens)
        t0 = time.perf_counter()
        out = restore_checkpoint(ckpt, target={"params": params, "opt_state": state})
        t_load = time.perf_counter() - t0
    p2, s2, loss_b = step(out["params"], out["opt_state"], tokens)
    torch.cuda.synchronize()
    check(torch.equal(loss_a, loss_b), f"resumed loss {float(loss_b)} != {float(loss_a)}")
    same = tree_map(torch.equal, {"p": params, "mu": state["mu"], "nu": state["nu"]},
                    {"p": p2, "mu": s2["mu"], "nu": s2["nu"]})
    check(all(flatten(same).values()),
          f"resumed step differs at {[k for k, v in flatten(same).items() if not v]}")
    check(int(s2["count"]) == int(state["count"]) == 3, "optimizer count after the resume")
    log(f"train: checkpoint of 2 layers at full width ({3 * param_bytes(params) / 1e9:.2f} GB "
        f"with the moments) saved in {t_save:.1f} s, restored in {t_load:.1f} s; the resumed "
        f"third step is bitwise the uninterrupted one (loss {float(loss_a):.6f})")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "drives the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False

    from fei_tpu_torch.ops.kernels import build

    if sys.argv[1:] == ["--paged-times"]:
        with ThreadPoolExecutor(2) as pool:
            list(pool.map(build.build, ["paged_attention", "ragged_paged_attention"]))
        paged_times(card)
        return 0
    if sys.argv[1:] == ["--bwd-times"]:
        with ThreadPoolExecutor(2) as pool:
            list(pool.map(build.build, ["flash_attention_fwd", "flash_attention_bwd"]))
        bwd_times(card)
        return 0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source
        for res in pool.map(build.build, KERNELS):
            regs = [ln.strip() for ln in res.log.splitlines() if "registers" in ln]
            log(f"build: {res.name} -> {res.path.name} in {res.seconds:.1f} s; {regs}")
    log(f"build: {time.perf_counter() - t0:.1f} s")

    records = [kernel_phase(card)] + paged_kernel_phase(card)
    bwd_records = flash_bwd_kernel_phase(card)
    int4_record = int4_kernel_phase(card)

    from fei_tpu_torch.ops.kernels.flash_attention import flash_attention

    # the dense path (engine, then serve) and the paged path (paged engine,
    # then paged serve): each with its counts set to 0 just before it
    engine = engine_phase(card)  # zeroes the flash count itself
    dense_launches = flash_attention.launches
    paged_engine, launches = paged_engine_phase(engine, card)
    reset_counts()
    serve_phase(engine, card)
    dense_launches += flash_attention.launches
    check(dense_launches > 0, "the dense path never launched flash_attention_fwd")
    log(f"dense path: flash_attention_fwd launched {dense_launches} times")
    reset_counts()
    paged_serve_phase(paged_engine, card)
    log(f"paged serve: launches {read_counts()}")
    # the agent path (counts each of its runs from 0 itself), on the same engines
    launches_a = agent_phase(engine, paged_engine, card)
    log(f"agent path: launches {launches_a}")
    paged_engine.close()
    for rec in records:
        rec["launches"] = launches[rec["name"]]
        check(rec["launches"] > 0, f"the paged path never launched {rec['name']}")
        # the agent path runs K1 (every prefill), K2 and K3 (its paged turn)
        rec["launches_agent"] = launches_a[rec["name"]]
        check(rec["launches_agent"] > 0, f"the agent path never launched {rec['name']}")
    log(f"paged path (main run): launches {launches}")

    # the quantized paths, after the bf16 engines are released
    from fei_tpu_torch.ops.quant import param_bytes

    bf16_bytes = param_bytes(engine.params)
    del engine, paged_engine
    gc.collect()
    torch.cuda.empty_cache()
    dense4 = quant_dense_phase(card, bf16_bytes)
    launches4 = quant_paged_phase(dense4, card)
    quant_provider_phase(dense4, card)
    int4_record["launches"] = launches4["int4_matmul"]
    records.append(int4_record)
    log(f"int4 paged path (main run): launches {launches4}")

    # the training path, after the quantized engines are released
    del dense4
    gc.collect()
    torch.cuda.empty_cache()
    launches_t = train_phase(card)
    for rec in bwd_records:
        rec["launches"] = launches_t[rec["name"]]
        check(rec["launches"] > 0, f"the training path never launched {rec['name']}")
    records.extend(bwd_records)
    # K1 runs on three paths: "launches" is the paged path's, as before
    records[0]["launches_dense"] = dense_launches
    records[0]["launches_training"] = launches_t["flash_attention_fwd"]
    check(records[0]["name"] == "flash_attention_fwd"
          and records[0]["launches_training"] == 2 * TRAIN_LAYERS * TRAIN_STEPS,
          f"the training path launched K1 {records[0]['launches_training']} times")
    log(f"training path ({TRAIN_STEPS} steps): launches {launches_t}")

    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
