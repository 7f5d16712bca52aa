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
   engine on the plain attention; 128 greedy tokens decode chunked; the
   same request with ``FEI_TPU_KERNEL_LOOP=2`` (chunks of 2 x 16 steps)
   gives the same tokens in fewer ``engine.decode_dispatches`` and sets
   ``engine.kernel_loop_depth`` to steps x layers (in this eager port the
   factor saves host syncs, not launches).
   Phases 5-13 run on the first 16 of these 32 layers (views of the same
   tensors, ``SERVE_LAYERS``; cut for time, every check kept), the KV
   phase on the first 8 (``KV_LAYERS``).
5. Serve (dense path): the OpenAI-compatible server over the same engine
   answers /health and three /v1/chat/completions (one streamed).
6. Paged engine (the paged path): the same 16 layers behind
   ``InferenceEngine(paged=True, batch_size=8)``; eight requests from eight
   threads (short prompts through dense admission, long ones chunked and
   merged with live decode), 128 greedy tokens each. The streams must not
   change with the merged dispatch off or with single-step decode; a tight
   pool must preempt and still finish every stream; chunked paged prefill
   logits are held against the dense engine's; an int8 pool must run the
   kernels' int8 branch.
7. Paged serve: the server over the paged engine answers eight concurrent
   completions (four streamed), each equal to the scheduler's own stream.
   Then the serving controls, as ``python -m fei_tpu_torch serve`` reads
   them: a two-slot paged engine on the same weights built with
   ``FEI_TPU_MAX_QUEUE=1`` in the environment sheds a completion whose
   ``X-FEI-Deadline-S: 0`` passed while it queued (504, as the JAX server
   answers), answers 429 with Retry-After once the queue is full, and
   serves a completion labelled ``X-FEI-Tenant``/``X-FEI-Priority``,
   counting its tokens under the tenant.
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
9. Agent tools (the C6 path), on the same engines: ``ui.cli.build_assistant``
   holds the JAX package's 15 tools (the code tools and MCP's
   ``brave_web_search``); the turn over their union grammar through
   ``TorchLocalProvider`` on the dense engine and the same turn on the
   paged engine agree (or first part at a tie within 2 bf16 ulps, F1).
   The port's Memdir server runs on loopback (started by
   ``MemdirConnector``); ``--memory-tools``'s 24-tool turn runs on the
   paged engine beside three free requests (K3) and its call runs for
   real when the tool only reads files or talks to the scratch Memdir
   server (a writing tool's call is logged, not run); ``memory_create`` -> ``memory_search`` -> ``memory_view``
   round-trips. MCP: Brave with no key gives its error payload, ``mcp
   list`` lists a stdio server set through ``FEI_TPU_MCP_SERVER_ECHO`` and
   one call goes through the registry's ``mcp_*`` dispatcher. Two
   Memorychain nodes vote two memories in over loopback; the embedding
   federation (4 nodes x 1024 x 256 fp32) is copied onto the card by
   ``exchange_banks`` and read back bitwise, and a top-5 this script
   computes there equals the federation's recall, which runs on the host;
   the native grep scanner,
   built with the host compiler, equals the Python route; the TUI,
   headless, streams one reply from the dense engine and answers ``/mem
   list`` from the live server, which ``memory_server_stop`` then stops.
10. Survival (the survival path), on a fresh engine over the same 16
   layers (at 8 its drain finds no stream mid-decode): the threefry PRNG on
   the card against the CPU (the known-answer vector, a 128256-lane draw
   bitwise, 1000 chained splits); four seeded requests of 64 tokens
   equal densely and paged (or first apart at a noise+logit gap within 2
   bf16 ulps over the temperature, F1's rule); eight requests of 32
   tokens (four greedy, four seeded; prompts 96-5000, dense and chunked
   admission) drained in mid-decode (``begin_drain``, deadline 0.2 s) and restored on
   a fresh engine by ``warm_restart``: every completed stream bitwise the
   uninterrupted run's; the same traffic with the session journal at
   ``batch`` and at ``always``, the latter's directory copied in
   mid-stream and recovered on a fresh engine (bitwise again, and a
   second restart finds nothing); POST /drain over HTTP (/health 503, a
   completion 503 with Retry-After). Logged, not checked: drain start ->
   drained, warm restart -> first replayed token per route, aggregate
   tok/s with the journal off / batch / always, and what a sampled step's
   sampling tail launches beside a greedy one's.
11. Speculation (the C3 path), on the same weights and LM head: a ~1000-id
   prompt (a code block repeated), 128 greedy tokens through
   ``generate_lookahead`` (verify blocks of 9 tokens; the plain attention,
   below K1's 64) equal to plain greedy decode, or first apart at a tie
   within 2 bf16 ulps (F1); then a two-row paged engine built with
   ``FEI_TPU_SPECULATE=1`` (``spec_ngram`` 3, ``spec_draft_len`` 8 read from
   the environment): its speculated stream (natural drafts, then the
   model's own continuation as the draft: more than 2 tokens a verify)
   equals its unspeculated one or ties, every verify runs K2's block form
   (``paged_attention.block_launches``), ``scheduler.spec_steps`` > 0 and
   ``spec_disabled`` 0; a tool-call turn whose trigger completes inside a
   verified block drops the rest of the block and makes a valid call.
   Logged: verify steps, tokens accepted, tokens per dispatch, tok/s with
   and without speculation.
12. KV tier (the KV path), on the first 8 of the same weights' layers
   (cut for time: to 16 when the fleet phase was added, to 8 when the tp
   phase was; every check kept), each run on a fresh paged
   engine built with the tier's variables (``FEI_TPU_KV_TIER``, RAM
   budget 8 GiB); the eight prompts of phase 6 as four greedy and four
   top-p 0.9 requests. The roomy traffic (1025 pages, 128 tokens) gives
   the same streams with the tier off and on (every new prompt's prefix
   published). The tight pool (129 pages) preempts: with the tier on,
   victims spill before eviction and resume by scatter, with
   ``kv.spills``, ``kv.fetches`` and ``kv.pages_restored`` counted, no
   fetch fallen back, ``scheduler.preempted_tokens_recomputed`` flat, and
   every stream bitwise the roomy run's. The disk rung (the same tight
   traffic, a RAM budget of one byte) demotes and serves fetches from
   disk with the same streams. An int8 pool (30 pages, four requests of 32
   tokens) spills its scales and equals its tier-off run, also under the
   faults ``kv.fetch`` io/corrupt/hang and ``kv.spill`` io, which fall back
   to replay and are counted. A 3000-token prompt published, the local
   prefix cache evicted through ``run_ctl``, admits through the tier
   (``kv.prefix_hits_tier``, only the suffix prefilled) with the local
   prefix hit's stream (bitwise) and the cold run's (within 2 bf16 ulps,
   F2); ``export_prefix`` -> ``import_prefix`` into a second engine (129
   pages) lands the blob's bytes and serves a prefix hit with the same
   stream; over HTTP, /kv/prefix, /kv/prefix/probe, GET and POST
   /kv/prefix (the peer's next completion hits the push), /kv/export ->
   /kv/import, 409 for a blob of another page size, 400, 404, and
   ``kv_fingerprint`` on /health. Logged: gather and scatter GB/s per
   entry size beside a pinned ``copy_`` of the same bytes, re-admission
   -> next token streamed vs replayed, the tight traffic's wall time
   with the tier off / ram / disk, the publish cost per admission and the
   roomy tok/s with the tier off and on.
13. Fleet and observability (the fleet path), on the survival phase's 16
   layers (at 8 its greedy stream gives too few frames to be dropped):
   two paged replicas of 8 rows and 513 pages with the KV tier in RAM, ``a``
   prefill-heavy in process and ``b`` decode-heavy behind its HTTP server
   (``HttpReplica``), one ``Router`` over both; a third engine alone is
   the reference. Eight sessions (first turns of 96-5000 characters, one
   byte id each; four greedy, four top-p 0.9) take two 32-token turns
   through ``Router.stream_chat``: the prompts of at least 512 ids land
   on ``a`` and hand their prefix off to ``b`` over /kv
   (``router.migrations``, ``router.role_routed``), second turns keep
   their affinity and hit the prefix cache, and every stream's ``fei``
   token ids equal the reference scheduler's on the same turns (or first
   part at a tie within 2 bf16 ulps). A greedy and a seeded 64-token
   stream dropped after 16 frames (by ``a`` in process; by ``b``, whose
   handler dies at the ``replica.crash`` fault and drops the socket) are
   resurrected once each and reach the client bitwise the uninterrupted
   stream. Three ``router.forward`` conn faults on ``a`` eject it while
   ``b`` serves, and after the 1 s cooldown a half-open probe readmits
   it; ``X-FEI-Deadline-S: 0.001`` answers 504 from the router
   (``router.deadline_expired``) and charges no breaker; a cold session on
   ``b`` pulls its prefix off ``a`` by content hash
   (``kv.prefix_hits_remote``). Over ``b``'s HTTP server: /v1/traces (the
   phase's traces, phases in order), /v1/traces/<id> (its flight slice),
   /debug/timeline (``.issue``/``.sync`` of the paged dispatches),
   a 1 s /debug/profile taken under the second turns (its trace names
   a K2/K3 kernel), /metrics (only declared names), ``roofline.frac`` in
   (0, 1.05] against 3350 GB/s and no ``engine.recompiles``. Last,
   ``rolling_restart(drain_deadline_s=0.2)`` over in-process replicas
   under four live 64-token streams: each finishes in place or is
   snapshotted and restored bitwise, none lost. Logged: each step's wall
   seconds.

Phase 3 also holds the int4 matmul kernel (K4) against its plain version
at llama3-8b's four linear shapes and M = 1/8/256/2048 and at its LM head
(K = 4096, N = 128256, the head under ``FEI_TPU_INT4_LM_HEAD=1``) at M =
1/8, shows that two mutants (lo and hi planes swapped; each group read
with the next group's scale) break that bound, that two runs are bitwise
equal and that every row is bitwise the same at every M (the decode split
of K and the prefill pipeline sum in one order), and that split scratch
one segment short is refused at the main shape and at the head's.
After the bf16 engines are released:

14. Quantized dense path: llama3-8b at 16 layers (cut for time) with int4
   weights (random, the same seed): ``param_bytes``; a ~1500-token prefill launches K4 exactly 7
   times per layer and its logits are held against the same weights
   dequantized to bf16 and multiplied plainly; 128 greedy tokens. Then
   int8 weights: ``param_bytes``, 32 greedy tokens, no K4 launch. Then the
   JAX package's two switches as ``from_config`` reads them: an int4
   engine built with ``FEI_TPU_INT4_LM_HEAD=1`` and ``FEI_TPU_QUANT_EMBED=1``
   in the environment holds an int4 LM head and an int8 embedding
   (``param_bytes`` printed), launches K4 7 x 16 + 1 times a forward (the
   head on the last row), and its logits and 64 greedy tokens are held
   against the same weights dequantized (rel_l2 3e-2; the streams equal or
   first apart at a tie within 2 bf16 ulps, F1); its whole tree goes
   through ``engine.weights.save_checkpoint`` / ``restore_checkpoint`` on
   the card and comes back bitwise.
15. Quantized paged path: the int4 weights behind the paged engine, four
   requests from threads; each stream must equal the dense int4 engine's,
   and must not change with the merged dispatch off or in a tight pool
   that preempts.
16. Provider: ``TorchLocalProvider`` built from the configuration with
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

17. MoE (the C2 path): mixtral-8x7b at full width and depth (32 layers,
    h=4096, I=14336, 8 experts, top-2, vocab 32000) with int8 weights
    (random, the seed's): ``param_bytes`` (bf16 would not fit); a
    1500-token prefill launches K1 once a layer and routes every layer
    (``FEI_TPU_ROUTED_MOE`` auto: per-expert matmuls over the sorted
    token blocks, one host copy of the block sizes a layer); its
    MoE output is held against the dense oracle's on the same input at
    rel_l2 1e-2 a layer, its last-position logits at 0.25 (expert pairs
    that flip under bf16 roundings grow with depth), a mutant that drops
    each token's second expert breaks both bounds, and two routed runs are
    bitwise equal; 32 greedy tokens (the dense formulation at one token,
    every int8 expert cast to a bf16 copy, timed); a four-row paged
    engine on the same weights (prompts 96 and 200 admitted densely, 700
    and 1500 in chunks merged with live decode through K3), each stream
    equal to the dense engine's under the formulation its route takes, or
    first apart at a tie within 2 bf16 ulps as the dense engine itself
    reads it (its prefill, then T=1 steps); a chunked prompt's first
    token comes from its chunked prefill, whose logits are held against
    the dense prefill's at rel_l2 0.25 instead; the same mutant on the
    paged engine breaks both rules; one int4 prefill (K4 on wq/wk/wv/wo, the
    experts int8); one training step on two layers at Mixtral's widths
    (bf16, T = 2048: K1 4, K5a 2, K5b 2), its gradients through the
    kernels against ``flash=False``.
18. Training (the training path): llama3-8b at full width and depth, bf16,
    random weights from the seed, ``TrainConfig(remat=True)``, one sequence
    of 2049 ids: three steps on the same batch (finite loss near ln V,
    lower at the third step; K1 twice per layer and step, K5a and K5b once).
    Then at two layers and full width: one step's gradients through the
    kernels against ``flash=False`` (autograd through the plain attention),
    and ``save_checkpoint`` -> ``restore_checkpoint`` -> one more step
    bitwise equal to the uninterrupted run's.
19. Tensor parallel (the tp path, roadmap C4's first half): two ranks
    spawned here join one group (gloo with both on the one card; NCCL on
    a card each where there are two) and each prints its backend and
    device. The sharded wrappers of K2/K3/K4 equal the unsharded kernels
    bitwise at the paged cell's shapes, and a gather in the wrong head
    order breaks that. On llama3-8b's widths at 8 layers (``TP_LAYERS``,
    cut for time when the parallel part joined the phase): the paged
    cell's eight prompts, a seeded stream and a dense chat turn on a tp2
    engine with replicated weights are bitwise one rank's; with Megatron
    weights the 1500-token logits are within rel_l2 3e-2 of one rank's,
    the streams equal or first apart at <= 2 bf16 ulps, and each rank
    holds half the weights; an int4 tp2 prefill (K4 column-sharded,
    wo/w_down int8) is held to one rank on the same weights; a sharded
    load of a 2-layer checkpoint peaks under a rank's share plus one
    tensor; the tp2 engine's exported prefix is one rank's bytes and
    lands on one rank. It prints the collectives' times and tp2 against
    one rank's tok/s. A dp2 paged engine (four rows a rank) sets the
    scheduler's mesh and replica gauges (``engine.mesh_shape``,
    ``engine.mesh.<axis>``, ``scheduler.replica.<g>.slots`` /
    ``.queue_depth``), held to its mesh parked with rows placed by hand
    and read at every update under the eight prompts. Last,
    ``FEI_TPU_MESH=tp2`` makes ``from_config`` start its own follower,
    the server's handler answers with ``/health`` ``mesh: "tp2"``, and a
    drain and ``close`` stop the follower.
20. The parallel part (roadmap C4's second half), in the same two ranks
    after the tp engines are released, at full width and cut depth: sp2
    ring and Ulysses prefill of an 8192-token prompt (llama3-8b and
    mistral-7b with its 4096 window, 4 layers) within rel_l2 2e-2 of one
    rank's K1 prefill, a ring that skips its last rotation breaking it,
    and a paged sp2 engine admitting a 6000-token prompt through the sp
    dispatch beside a decoding stream (both streams one rank's chunked
    admission's, or first apart at <= 2 bf16 ulps; K1 and K2 launched);
    ep2 mixtral-8x7b int8 at 2 layers (4 of 8 experts a rank): a dropless
    1500-token prefill within the MoE phase's 0.25 of one rank's, a
    return trip in the wrong source order breaking it, and a paged engine
    at the default capacity serving four prompts through K1-K3; pp2
    ``pipeline_forward_train`` (4 layers, B 4, T 1024, 2 and 4
    microbatches) within 1e-2 of one rank's ``forward_train``; dp2 and
    tp2 training steps (2 layers, T 2048) whose losses and parameter
    changes after two steps match one rank's, each rank launching K1,
    K5a and K5b; ``exchange_banks`` over the two ranks, bitwise on both.

``python3 chip_smoke.py --paged-times`` only builds K2/K3 and times them at
every shape of phase 3 through their public wrappers; ``--bwd-times`` does
the same for K5a, K5b and the pair at the training shape and at D = 64;
``--kv`` builds K1-K3 and runs phase 12 alone (on the seed's weights with
the serve phase's LM head, cut to 8 layers as in the full run),
``--fleet`` phase 13 likewise (16 layers), ``--quant`` K4's kernel phase and
phase 14's int4 and int4-head engines (K1-K4 built), ``--tp`` phase 19 (K1-K4 built), ``--parallel``
phase 20 alone (every kernel built), ``--tools`` the serving controls and
phase 9, ``--spec`` phase 11 (both on the same 16 layers) and ``--moe`` phase 17. ``--serve-rates`` logs only the dense
decode tok/s (twice) and the paged aggregate tok/s of phases 4 and 6's
traffic, straight into the scheduler and through the SSE path of
``ServeAPI.stream_chat``, so a copy run from an older tree's root measures
what that tree's serving layers cost on the same card. A copy of this file run from an older tree's
root times that tree's kernels.

Every kernel count is set to 0 just before a path is driven and read just
after. The line before the last two is the kernels' JSON record (launches
from the paged paths: K1-K3 from the bf16 run, K4 from the int4 run, K5a and
K5b from the three training steps; K4 also carries ``launches_int4_head``,
the int4-head engine's generate, and ``lm_head``, its kernel rows at the
head's shape; K1-K3 also carry ``launches_agent``, the
sum over the agent path's own runs, each counted from 0: the provider turn,
the paged turns, the paged turn beside its free neighbours and the
``--message`` round; ``launches_tools``, the sum over the agent tools
path's own runs: the dense and paged 15-tool turns, the 24-tool turn
beside its neighbours and the TUI turn; and ``launches_survival``, the sum over the survival
path's own runs: the seeded paged streams, the drained run, the warm
restart, the journaled run and its recovery; ``launches_kv``, the sum
over the KV path's tier-on runs; ``launches_fleet``, the sum over the
fleet path's runs, its reference scheduler not counted; K1 and K2 carry
``launches_spec``, the sum over the speculated runs (the dense lookahead,
the two paged streams, the tool turn); every kernel carries
``launches_moe``, the sum over the MoE path's runs: the routed prefill,
the dense decode, the paged traffic, the int4 prefill and the training
step; K1-K4 carry ``launches_tp``, each rank's count over the tp path,
its one-rank references not counted; K1-K3, K5a and K5b carry
``launches_parallel``, each rank's count over the parallel part's runs,
its one-rank references and mutants not counted), the line before the last is the card,
and the last line is the JSON verdict.
"""

from __future__ import annotations

import contextlib
import faulthandler
import gc
import itertools
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

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


@contextlib.contextmanager
def env_vars(**over: str | None):
    """Environment variables set (None: unset) for a block, then restored."""
    import os

    old = {k: os.environ.get(k) for k in over}
    for k, v in over.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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
# llama3-8b's LM head under FEI_TPU_INT4_LM_HEAD=1 and its rows: a dense
# decode step (and a prefill's last row) and the paged decode batch
INT4_HEAD = ("lm_head", 4096, 128256)
INT4_HEAD_MS = (1, 8)
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
    log(f"kernel int4_matmul [K={K} N={N}]: scratch one segment short of the plan refused "
        f"(error {err})")


def int4_kernel_phase(card: str) -> dict:
    """K4 at llama3-8b's four linear shapes x M in {1, 8, 256, 2048} and at
    its LM head (K = 4096, N = 128256) x M in {1, 8}: held element by
    element against its plain version within ``int4_mm_tolerance``, two
    mutants shown to break that bound, every row bitwise the same at every
    M, and timed beside the plain version, one ``torch.matmul`` on the
    dequantized weight (a yardstick the port never calls) and the bound.
    Returns the main shape's record, with the LM head's rows under
    ``lm_head``."""
    from fei_tpu_torch.ops.kernels.int4_matmul import (
        int4_mm,
        int4_mm_reference,
        int4_mm_tolerance,
    )
    from fei_tpu_torch.ops.quant import QTensor4, dequantize, quantize4

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    record, head = None, []
    shapes = [(*shape, INT4_MS) for shape in INT4_LINEARS] + [(*INT4_HEAD, INT4_HEAD_MS)]
    for label, K, N, row_counts in shapes:
        w = quantize4((torch.randn(K, N, generator=gen, device="cuda") * K ** -0.5).bfloat16())
        x_all = torch.randn(max(row_counts), K, generator=gen, device="cuda").bfloat16()
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
        for M in row_counts:
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
            if label == INT4_HEAD[0]:
                head.append({"M": M, "K": K, "N": N, "max_abs_err": err, "worst_err_over_tol":
                             worst, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                             "library_device_ms": lib_device_ms,
                             "mutants_caught": caught})
            del out, ref, tol, diff
        # row invariance: a row's k-order does not follow M or the kernel
        # (M <= 16 splits K; larger M runs the pipeline): every row of each
        # call equals the same row of every larger call
        for a, b in itertools.combinations(row_counts, 2):
            same = (outs[b][:a] == outs[a]).all(dim=1)
            check(bool(same.all()), f"int4 {label}: rows {(~same).nonzero().flatten()[:8].tolist()} "
                  f"of the M={a} call differ from the M={b} call's")
        log(f"kernel int4_matmul [{label}]: every row bitwise equal across M = {row_counts}")
        if label in (INT4_MAIN[0], INT4_HEAD[0]):
            split_scratch_refused(x_all[:1], w)
        del w, x_all, mutants, w_copies, deq, deq_copies, outs
        torch.cuda.empty_cache()
    record["lm_head"] = head
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
    d0 = counter("engine.decode_dispatches")
    res = engine.generate(prompt, gen)
    dispatches = counter("engine.decode_dispatches") - d0
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
    kernel_loop_check(engine, prompt, gen, res, dispatches, card)
    return engine


def kernel_loop_check(engine, prompt, gen, res, dispatches: float, card: str) -> None:
    """``FEI_TPU_KERNEL_LOOP=2`` beside the factor-1 run ``res`` of the same
    request: the same greedy tokens, fewer ``engine.decode_dispatches``
    (chunks of 2 x 16 steps, one host sync each), and the
    ``engine.kernel_loop_depth`` gauge at steps x layers. In the eager port
    the factor saves host syncs, not launches."""
    d0 = counter("engine.decode_dispatches")
    with env_vars(FEI_TPU_KERNEL_LOOP="2"):
        looped = engine.generate(prompt, gen)
    looped_dispatches = counter("engine.decode_dispatches") - d0
    depth = gauge("engine.kernel_loop_depth")
    want_depth = 2 * gen.chunk * engine.cfg.num_layers
    log(f"engine: FEI_TPU_KERNEL_LOOP=2 on {card}: {looped_dispatches:.0f} decode dispatches "
        f"against {dispatches:.0f} at factor 1, engine.kernel_loop_depth {depth} (expected "
        f"{want_depth}), decode {looped.decode_tokens_per_s:.2f} tok/s against "
        f"{res.decode_tokens_per_s:.2f}; tokens equal: {looped.token_ids == res.token_ids}")
    check(looped.token_ids == res.token_ids, "kernel looping changed the greedy tokens")
    check(looped_dispatches < dispatches,
          f"kernel looping did not cut the dispatches ({looped_dispatches} vs {dispatches})")
    check(depth == want_depth, f"engine.kernel_loop_depth {depth}, expected {want_depth}")


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
    paged_attention.block_launches = 0
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
            "paged_attention_block": paged_attention.block_launches,
            "ragged_paged_attention_int8": ragged_paged_attention.int8_launches}


def counter(name: str) -> float:
    from fei_tpu_torch.utils.metrics import METRICS

    return METRICS.snapshot()["counters"].get(name, 0.0)


def gauge(name: str):
    from fei_tpu_torch.utils.metrics import METRICS

    return METRICS.snapshot()["gauges"].get(name)


def traffic(engine, prompts, new_tokens: int, gens=None) -> dict:
    """Eight requests from eight threads through the scheduler: the short
    prompts start at once, the long ones once every short stream has its
    first token (so their chunks overlap live decode). ``gens`` gives each
    request its own GenerationConfig (default: greedy, ``new_tokens``).
    Returns the token streams, each request's TTFT and the run's wall
    time."""
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
            for tok in engine.scheduler.stream(prompts[i], gen if gens is None else gens[i]):
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
    dev = engine.device
    pool = PagedKVCache.create(engine.cfg, need + 1, 1, width, page_size=PAGE,
                               dtype=engine.dtype, device=dev)
    row = torch.zeros((1, width), dtype=torch.int32, device=dev)
    row[0, :need] = torch.arange(1, need + 1, dtype=torch.int32)
    pool = pool._replace(block_table=row)
    last = None
    for lo in range(0, n, C):
        toks = torch.zeros((1, C), dtype=torch.long)
        toks[0, : min(C, n - lo)] = torch.tensor(prompt[lo:lo + C])
        pool = pool._replace(lengths=torch.tensor([lo], dtype=torch.int32, device=dev))
        hidden, _ = forward_paged_block(engine.params, engine.cfg, toks.to(dev), pool,
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
            device="cuda", paged=True, batch_size=8, page_size=PAGE,
            num_layers=cfg.num_layers, **kw)

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
    equal to the scheduler's own greedy stream; then the serving controls
    (``serving_controls``)."""
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

        serving_controls(eng, card)
    finally:
        server.stop()


def serving_controls(eng, card: str) -> None:
    """The serving controls as ``python -m fei_tpu_torch serve`` reads them:
    a second paged engine on the same weights, two slots, built with
    ``FEI_TPU_MAX_QUEUE=1`` and ``FEI_TPU_RETRY_AFTER_S=2`` in the
    environment. With both slots busy, a completion whose propagated
    deadline has passed (``X-FEI-Deadline-S: 0``) queues and is shed with
    the JAX server's 504; with one more request queued the next one gets
    429 and Retry-After; then a completion labelled ``X-FEI-Tenant`` and
    ``X-FEI-Priority`` is served and counted under its tenant."""
    import os

    from fei_tpu_torch.agent.providers import TorchLocalProvider
    from fei_tpu_torch.engine import GenerationConfig, InferenceEngine
    from fei_tpu_torch.ui.server import ServeAPI, ServingServer

    env = {"FEI_TPU_MAX_QUEUE": "1", "FEI_TPU_RETRY_AFTER_S": "2"}
    os.environ.update(env)
    try:
        capped = InferenceEngine.from_config(
            "llama3-8b", dtype=torch.bfloat16, params=eng.params, max_seq_len=8192,
            device="cuda", paged=True, batch_size=2, page_size=PAGE,
            num_layers=eng.cfg.num_layers)
    finally:
        for k in env:
            del os.environ[k]
    sched = capped.scheduler
    check(sched.max_queue == 1 and sched.retry_after_s == 2.0,
          f"the scheduler read max_queue {sched.max_queue}, retry_after_s {sched.retry_after_s}")
    server = ServingServer(ServeAPI(TorchLocalProvider(engine=capped), model_name=eng.cfg.name),
                           host="127.0.0.1", port=0)
    server.start()
    body = {"messages": [{"role": "user", "content": "pages tables kernels"}],
            "max_tokens": 16, "ignore_eos": True}

    def post(headers):
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/v1/chat/completions",
            data=json.dumps(body).encode(), method="POST",
            headers={"Content-Type": "application/json", **headers})
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.status, json.loads(r.read()), dict(r.headers)
        except urllib.error.HTTPError as exc:
            return exc.code, json.loads(exc.read()), dict(exc.headers)

    hold_gen = GenerationConfig(max_new_tokens=2048, ignore_eos=True)
    hold = []
    try:
        for _ in range(2):  # one at a time: the queue holds one
            hold.append(sched.submit([5] * 64, hold_gen))
            deadline = time.perf_counter() + 120
            while time.perf_counter() < deadline and not hold[-1].generated:
                time.sleep(0.01)
            check(bool(hold[-1].generated), "a holding request never decoded")
        status, payload, _ = post({"X-FEI-Deadline-S": "0"})
        check(status == 504 and payload["error"]["type"] == "timeout_error",
              f"a passed deadline got HTTP {status} {payload}, not the JAX server's 504")
        hold.append(sched.submit([5] * 64, hold_gen))  # queued: the queue is full
        status, payload, headers = post({})
        check(status == 429 and payload["error"]["type"] == "overloaded_error",
              f"a request over FEI_TPU_MAX_QUEUE got HTTP {status}, not 429")
        check(headers.get("Retry-After") == "2", f"429 with Retry-After {headers.get('Retry-After')}")
        for s in hold:
            sched.cancel(s)
        hold = []
        served0 = counter("tenant.card-tenant.tokens_served")
        status, payload, _ = post({"X-FEI-Tenant": "card-tenant", "X-FEI-Priority": "2"})
        served = counter("tenant.card-tenant.tokens_served") - served0
        check(status == 200 and payload["usage"]["completion_tokens"] == 16,
              f"the labelled completion got HTTP {status}")
        check(served == 16, f"tenant card-tenant counted {served} tokens served, not 16")
        log(f"serving controls on {card}: FEI_TPU_MAX_QUEUE=1 read at build; with 2 slots "
            f"busy X-FEI-Deadline-S: 0 -> HTTP 504 timeout_error; with 1 queued -> HTTP 429, "
            f"Retry-After 2; X-FEI-Tenant card-tenant, X-FEI-Priority 2 -> HTTP 200, "
            f"tenant.card-tenant.tokens_served +{served:.0f}")
    finally:
        for s in hold:
            sched.cancel(s)
        server.stop()
        capped.close()
        del capped, sched
        gc.collect()
        torch.cuda.empty_cache()


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
                toks, cache, *_ = free(engine.params, cache, tok, None, done, stops)
            else:
                toks, cache, *_ = cons(
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


# ------------------------------------------------------------ agent tools

# the JAX package's default registry (fei_tpu/ui/cli.py::build_assistant):
# the 14 code tools and the MCP manager's web search; --memory-tools adds
# the nine memory tools before it (tests/test_torch_mcp.py holds both lists
# equal to the JAX package's registries)
DEFAULT_TOOL_NAMES = (
    "GlobTool", "GrepTool", "View", "Edit", "Replace", "LS", "RegexEdit", "BatchGlob",
    "FindInFiles", "SmartSearch", "RepoMap", "RepoSummary", "RepoDependencies", "Shell",
    "brave_web_search")
MEMORY_TOOL_NAMES = DEFAULT_TOOL_NAMES[:-1] + (
    "memory_search", "memory_create", "memory_view", "memory_list", "memory_delete",
    "memory_search_by_tag", "memory_server_start", "memory_server_stop",
    "memory_server_status", "brave_web_search")
# a stdio MCP server: echoes each call's method and params back
STDIO_MCP_SERVER = r"""
import json, sys
for line in sys.stdin:
    req = json.loads(line)
    out = {"jsonrpc": "2.0", "id": req["id"],
           "result": {"method": req["method"], "params": req.get("params", {})}}
    sys.stdout.write(json.dumps(out) + "\n")
    sys.stdout.flush()
"""
# the tools whose handlers the 24-tool turn may run for real: they read
# files or talk to the scratch Memdir server; a call to any other (Edit,
# Replace, RegexEdit, Shell, the server's start and stop) is logged only
READ_ONLY_TOOLS = frozenset(MEMORY_TOOL_NAMES) - {
    "Edit", "Replace", "RegexEdit", "Shell", "memory_server_start", "memory_server_stop"}
TOOLS_NEIGHBOUR_LENS = (40, 120, 250)  # dense admission, decoding while the turn chunks
TOOLS_NEIGHBOUR_NEW = 32
TOOLS_MAX_TOKENS = 96  # the 15- and 24-tool turns' budget: the grammar closes a call within it
TUI_TOKENS = 32
FED_NODES, FED_BANK, FED_DIM = 4, 1024, 256  # the federation: 4 nodes x 1024 x 256 fp32


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def grammar_line(label, grammar, engine, card) -> str:
    table, _ = grammar.device_tables(engine.cfg.vocab_size, engine.device)
    return (f"{label}: union grammar {grammar.table.shape[0]} states, device table "
            f"{tuple(table.shape)} {table.dtype} = {table.numel() * table.element_size() / 1e6:.1f} MB "
            f"on {card}")


def federation_exchange(card: str) -> None:
    """EmbeddingFederation at 4 nodes x bank 1024 x D 256 fp32. The port's
    device work is ``exchange_banks``: the stacked banks copied onto the
    card, read back bitwise. The federation's recall runs on the host
    (``search`` over numpy); a top-5 that this script computes on the card
    over the exchanged bank agrees with it (ids and scores within 1e-6)."""
    from fei_tpu_torch.memory.memorychain.embedding_exchange import (
        EmbeddingFederation, exchange_banks)

    rng = np.random.default_rng(SEED + 11)
    vocab = [f"w{i}" for i in range(4000)]
    feds = [EmbeddingFederation(i, FED_NODES, bank_size=FED_BANK, dim=FED_DIM)
            for i in range(FED_NODES)]
    texts = [[" ".join(rng.choice(vocab, 12)) for _ in range(FED_BANK)] for _ in feds]
    t0 = time.perf_counter()
    for i, fed in enumerate(feds):
        for j in range(FED_BANK):
            fed.add(f"n{i}-m{j}", texts[i][j])
    embed_s = time.perf_counter() - t0
    banks = np.stack([f.local_bank for f in feds])
    ids = [list(f._ids) for f in feds]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = exchange_banks(banks, device="cuda")
    torch.cuda.synchronize()
    xfer_s = time.perf_counter() - t0
    check(out.is_cuda and tuple(out.shape) == (1, FED_NODES, FED_BANK, FED_DIM),
          f"exchange_banks gave {tuple(out.shape)} on {out.device}")
    check(out[0].cpu().numpy().tobytes() == banks.tobytes(), "the exchanged banks differ")
    fed = feds[0]
    fed.sync(banks, device="cuda")
    fed.install_global(fed._global, ids)
    flat = out[0].reshape(-1, FED_DIM)
    worst = 0.0
    for q in range(3):
        # another node's memory, recalled by half of its words
        node, slot = (q + 1) % FED_NODES, int(rng.integers(FED_BANK))
        query = " ".join(texts[node][slot].split()[:6])
        host = fed.search(query, top_k=5)
        qv = fed.embed_fn(query)
        host_all = fed._global.reshape(-1, FED_DIM) @ qv
        scores, idx = torch.topk(flat @ torch.as_tensor(qv, device="cuda"), 5)
        card_hits = list(zip(idx.tolist(), scores.tolist()))
        # rank by rank the same scores; each hit on the card scores the same
        # on the host; the ids agree wherever the score is not an exact tie
        # (hashed bags of words tie often: numpy's argsort and topk order a
        # tie differently)
        err = max(max(abs(s - h["score"]) for (_, s), h in zip(card_hits, host)),
                  max(abs(s - float(host_all[i])) for i, s in card_hits))
        check(err <= 1e-6, f"recall scores differ by {err:.3g} (> 1e-6)")
        for r, ((i, s), h) in enumerate(zip(card_hits, host)):
            tied = np.count_nonzero(np.abs(host_all - s) <= 1e-6) > 1
            check(tied or ids[i // FED_BANK][i % FED_BANK] == h["id"],
                  f"rank {r}: the card recalled {ids[i // FED_BANK][i % FED_BANK]}, "
                  f"the host {h['id']}")
        check(host[0]["id"] == ids[node][slot], f"{query!r} recalled {host[0]}")
        worst = max(worst, err)
    log(f"tools: federation {FED_NODES} nodes x {FED_BANK} x {FED_DIM} fp32 "
        f"({banks.nbytes / 2**20:.0f} MiB): embedded in {embed_s:.2f} s (host); exchange_banks "
        f"copied the banks onto the card in {xfer_s * 1e3:.2f} ms and they read back bitwise; "
        f"the federation's recall runs on the host, and three top-5s computed by this script "
        f"on the card over the exchanged bank equal it (ids up to exact ties, scores within "
        f"{worst:.3g}) on {card}")



def memorychain_over_loopback(tmp: str, card: str) -> None:
    """Two Memorychain nodes of the port over loopback HTTP: two memories
    proposed to the first pass the reference's 51 % vote (the second node
    votes over HTTP), both chains hold them with equal hashes, and both
    nodes answer /health."""
    from fei_tpu_torch.memory.memorychain.node import MemorychainNode

    n1 = MemorychainNode("card-a", 0, f"{tmp}/chain-a")
    n1.start_background()
    n2 = MemorychainNode("card-b", 0, f"{tmp}/chain-b", seed=n1.address)
    n2.start_background()
    try:
        for content in ("flash attention tiles on the card", "paged decode segments"):
            req = urllib.request.Request(
                f"{n1.address}/memorychain/propose", method="POST",
                data=json.dumps({"memory_data": {"content": content}}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                check(r.status == 201, f"/memorychain/propose answered {r.status}")
        for node in (n1, n2):
            with urllib.request.urlopen(f"{node.address}/health", timeout=10) as r:
                health = json.loads(r.read())
            check(health["status"] == "ok" and health["chain_length"] == 3,
                  f"{node.chain.node_id} /health: {health}")
        check([b.hash for b in n1.chain.blocks] == [b.hash for b in n2.chain.blocks]
              and n1.chain.validate_chain() and n2.chain.validate_chain(),
              "the two chains differ or do not validate")
        log(f"tools: memorychain: 2 memories voted in over loopback (2 nodes), chains of "
            f"{len(n1.chain.blocks)} blocks with equal hashes, /health ok on both ({card})")
    finally:
        n1.shutdown()
        n2.shutdown()


def native_scanner(card: str) -> None:
    """The port's C++ scanner, built with the host compiler here, gives
    GrepTool the pure-Python route's matches in the same order."""
    import os

    from fei_tpu_torch.native import scan
    from fei_tpu_torch.native.build import lib_path
    from fei_tpu_torch.tools.code import GrepTool

    t0 = time.perf_counter()
    path = lib_path()
    check(path is not None, "the native scanner did not build")
    build_s = time.perf_counter() - t0
    root = str(Path(__file__).resolve().parent / "fei_tpu_torch")
    files = sorted(str(f) for f in Path(root).rglob("*.py"))
    for pattern in ("launches", "tenant", "deadline"):  # fixed strings: the native route
        check(scan.grep_files(files, pattern, 1000) is not None,
              f"grep {pattern!r}: the native scan was not taken")
        t0 = time.perf_counter()
        native = [(m.file, m.line_number, m.line) for m in GrepTool().search(pattern, path=root)]
        native_s = time.perf_counter() - t0
        os.environ["FEI_TPU_NATIVE"] = "0"
        scan._lib = None
        try:
            t0 = time.perf_counter()
            plain = [(m.file, m.line_number, m.line) for m in GrepTool().search(pattern, path=root)]
            plain_s = time.perf_counter() - t0
        finally:
            del os.environ["FEI_TPU_NATIVE"]
            scan._lib = None
        check(native == plain and 0 < len(native) < 1000,
              f"grep {pattern!r}: native {len(native)} matches, Python {len(plain)}, or apart")
        log(f"tools: native scanner ({Path(path).name}, built in {build_s:.1f} s): grep "
            f"{pattern!r} over {len(files)} files, {len(native)} matches equal to the Python "
            f"route's in order; host {native_s * 1e3:.1f} ms vs {plain_s * 1e3:.1f} ms ({card})")


def tools_phase(dense, paged, card: str) -> dict:
    """The rest of the agent's tool layer on the card (the C6 path), on the
    agent phase's engines (bf16 llama3-8b, the LM head zeroed past the byte
    tokenizer's ids): the default 15-tool registry's constrained turn dense
    and paged; the 24-tool ``--memory-tools`` turn on the paged engine
    beside free requests, its call run for real against a live Memdir
    server when the tool only reads; MCP (a stdio server through the ``mcp_*`` dispatcher, ``mcp
    list``, Brave with no key); Memorychain over loopback; the federation's
    banks exchanged onto the card; the native scanner; the TUI streaming one reply from the
    dense engine. Returns the kernel launches of the path's own runs, each
    counted from 0 just before it: the dense and paged 15-tool turns, the
    24-tool turn with its neighbours and the TUI turn."""
    import argparse
    import asyncio
    import contextlib
    import io
    import os
    import shlex

    from fei_tpu_torch.agent.providers import TorchLocalProvider
    from fei_tpu_torch.engine import GenerationConfig
    from fei_tpu_torch.tools.memdir_connector import MemdirConnector
    from fei_tpu_torch.tools.memory_tools import MemoryToolHandlers
    from fei_tpu_torch.ui import cli, textual_chat
    from fei_tpu_torch.ui.textual_chat import FeiChatApp

    t_phase = time.perf_counter()
    launched = dict.fromkeys(read_counts(), 0)

    @contextlib.contextmanager
    def tools_path():
        reset_counts()
        yield
        for k, v in read_counts().items():
            launched[k] += v

    tmp = tempfile.TemporaryDirectory()
    key, port = "chip-smoke-memdir", free_port()
    url = f"http://127.0.0.1:{port}"
    os.environ.pop("BRAVE_API_KEY", None)
    env = {"FEI_TPU_MCP_SERVER_ECHO": shlex.join([sys.executable, "-u", "-c", STDIO_MCP_SERVER]),
           "MEMDIR_SERVER_URL": url, "MEMDIR_API_KEY": key}
    os.environ.update(env)
    memdir = MemdirConnector(server_url=url, api_key=key, base_dir=f"{tmp.name}/Memdir")
    memory = MemoryToolHandlers(memdir)
    try:
        t0 = time.perf_counter()
        check(memdir.start_server(wait=60), "the port's Memdir server did not come up")
        log(f"tools: Memdir server (python -m fei_tpu_torch.memory.memdir.server) on {url} "
            f"up in {time.perf_counter() - t0:.2f} s")

        def assistant(provider, memory_tools):
            a = cli.build_assistant(argparse.Namespace(
                provider=provider, model=None, max_tool_rounds=1, max_tokens=TOOLS_MAX_TOKENS,
                no_stream=True, memory_tools=memory_tools))
            return a, a.tool_manager.get_tools()

        gen = GenerationConfig(max_new_tokens=TOOLS_MAX_TOKENS, ignore_eos=True)

        # (1) the default registry: the JAX package's 15 tools; its turn
        # dense through the provider, then on the paged engine
        provider = TorchLocalProvider(engine=dense, gen_overrides={"ignore_eos": True})
        asst15, tools15 = assistant(provider, False)
        check([t["name"] for t in tools15] == list(DEFAULT_TOOL_NAMES),
              f"default registry {[t['name'] for t in tools15]}")
        g15 = provider._tool_grammar(tools15)
        log(grammar_line("tools: 15-tool registry", g15, dense, card))
        messages, trig, width = find_trigger(provider, None, tools15)
        full = provider._messages_with_system(messages, None, tools15)
        ids = dense.tokenizer.apply_chat_template(full, add_generation_prompt=True)
        dense_toks: list[int] = []
        stream_fn = dense.generate_stream_toolcalls

        def recording(*a, **kw):  # the provider's own stream, recorded
            for tok in stream_fn(*a, **kw):
                dense_toks.append(tok)
                yield tok

        dense.generate_stream_toolcalls = recording
        provider.last_ttft_s = None
        try:
            with tools_path():
                t0 = time.perf_counter()
                resp = provider.complete(messages, tools=tools15, max_tokens=TOOLS_MAX_TOKENS)
                turn_s = time.perf_counter() - t0
                check(read_counts()["flash_attention_fwd"] >= dense.cfg.num_layers,
                      "the 15-tool turn's prefill did not launch K1")
        finally:
            del dense.generate_stream_toolcalls
        call = check_call(resp, tools15)
        log(f"tools: 15-tool turn, dense, on {card}: trigger {ascii(trig)}, prompt {len(ids)} "
            f"tokens, {len(dense_toks)} tokens, TTFT {provider.last_ttft_s * 1e3:.1f} ms, turn "
            f"{turn_s:.3f} s; call {call.name}({json.dumps(call.arguments)[:120]})")
        with tools_path():
            t0 = time.perf_counter()
            alone = list(paged.generate_stream_toolcalls(ids, gen, grammar=g15, trigger=trig))
            paged_s = time.perf_counter() - t0
            check(read_counts()["paged_attention"] > 0, "the paged 15-tool turn never launched K2")
        verdict = same_or_tie(dense, ids, dense_toks, alone, "15-tool paged turn vs dense")
        log(f"tools: 15-tool turn, paged, on {card}: {len(alone)} tokens in {paged_s:.3f} s; "
            f"vs dense: {verdict}")

        # (2) --memory-tools: 24 tools; one constrained turn on the paged
        # engine beside free requests; its call runs for real if it only reads
        provider24 = TorchLocalProvider(engine=paged, gen_overrides={"ignore_eos": True})
        asst24, tools24 = assistant(provider24, True)
        check([t["name"] for t in tools24] == list(MEMORY_TOOL_NAMES),
              f"--memory-tools registry {[t['name'] for t in tools24]}")
        g24 = provider24._tool_grammar(tools24)
        log(grammar_line("tools: 24-tool registry", g24, paged, card))
        probe = TorchLocalProvider(engine=dense, gen_overrides={"ignore_eos": True})
        messages24, trig24, _ = find_trigger(probe, None, tools24)
        provider24.tool_trigger = trig24
        sched = paged.scheduler
        rng = np.random.default_rng(SEED + 9)
        others = [rng.integers(8, dense.tokenizer.vocab_size, n).tolist()
                  for n in TOOLS_NEIGHBOUR_LENS]
        free_gen = GenerationConfig(max_new_tokens=TOOLS_NEIGHBOUR_NEW, ignore_eos=True)
        merged0 = counter("engine.ragged_dispatches")
        provider24.last_ttft_s = None
        with tools_path():
            seqs = [sched.submit(p, free_gen) for p in others]
            deadline = time.perf_counter() + 300
            while not all(s.generated for s in seqs) and time.perf_counter() < deadline:
                time.sleep(0.005)
            t0 = time.perf_counter()
            resp24 = provider24.complete(messages24, tools=tools24, max_tokens=TOOLS_MAX_TOKENS)
            turn24_s = time.perf_counter() - t0
            streams = [list(sched.drain(s)) for s in seqs]
            check(read_counts()["ragged_paged_attention"] > 0,
                  "the 24-tool turn's chunks never launched K3")
        check(counter("engine.ragged_dispatches") > merged0,
              "the 24-tool turn's chunks never merged with live decode")
        check(all(len(s) == TOOLS_NEIGHBOUR_NEW for s in streams), "a free request came up short")
        call24 = check_call(resp24, tools24)
        if call24.name in READ_ONLY_TOOLS:
            cwd = os.getcwd()
            os.chdir(tmp.name)  # a code tool's relative paths land in the scratch directory
            try:
                t0 = time.perf_counter()
                result = asst24.tool_manager.execute_tool(call24)
                tool_s = time.perf_counter() - t0
            finally:
                os.chdir(cwd)
            check(isinstance(result, dict), f"{call24.name} returned {type(result).__name__}")
            ran = (f"ran for real in {tool_s * 1e3:.1f} ms -> "
                   f"{json.dumps(result, default=str)[:160]}")
        else:
            ran = "not run: the tool writes or starts processes"
        log(f"tools: 24-tool turn, paged beside {len(others)} free requests, on {card}: trigger "
            f"{ascii(trig24)}, prompt {resp24.usage['prompt_tokens']} tokens, "
            f"{resp24.usage['completion_tokens']} tokens, TTFT {provider24.last_ttft_s * 1e3:.1f} "
            f"ms, turn {turn24_s:.3f} s; call {call24.name}({json.dumps(call24.arguments)[:120]}) "
            f"{ran}")
        made = memory.memory_create("the H100 runs K1, K2 and K3 on this path",
                                    subject="card", tags="chip,smoke")
        check("error" not in made, f"memory_create: {made}")
        found = memory.memory_search("#chip", with_content=True)
        check(any(r["id"] == made["created"] for r in found.get("results", [])),
              f"memory_search did not find {made['created']}: {found}")
        viewed = memory.memory_view(made["created"])
        check(viewed.get("content") == "the H100 runs K1, K2 and K3 on this path",
              f"memory_view: {viewed}")
        log(f"tools: memory_create -> memory_search -> memory_view round trip through the live "
            f"server got back its content ({made['created']})")

        # (3) MCP: Brave with no key, `mcp list`, one call through mcp_*
        registry = asst15.tool_manager.registry
        brave = registry.execute_tool("brave_web_search", {"query": "hopper"})
        check(set(brave) == {"error"} and "BRAVE_API_KEY" in brave["error"],
              f"brave_web_search without a key: {brave}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["mcp", "list"])
        listed = out.getvalue().split()
        check(rc == 0 and listed[:2] == ["echo", "stdio"], f"mcp list: rc {rc}, {out.getvalue()!r}")
        echoed = registry.execute_tool("mcp_echo_hello", {"x": 1})
        check(echoed == {"method": "hello", "params": {"x": 1}}, f"mcp_echo_hello: {echoed}")
        log(f"tools: MCP: brave_web_search without a key -> {brave}; `mcp list` -> "
            f"{out.getvalue().strip()[:60]!r}...; mcp_echo_hello through the stdio server -> {echoed}")

        # (4) Memorychain and the federation
        memorychain_over_loopback(tmp.name, card)
        federation_exchange(card)

        # (5) the native scanner
        native_scanner(card)

        # (6) the TUI, headless: one reply streamed from the dense engine
        tui = textual_chat.build_assistant(argparse.Namespace(
            provider=TorchLocalProvider(engine=dense, gen_overrides={"ignore_eos": True}),
            model=None, max_tokens=TUI_TOKENS))
        app = FeiChatApp(assistant=tui, memory_handlers=memory)
        frames = []
        app.invalidate = lambda: frames.append(1)  # one per streamed delta, no terminal
        with tools_path():
            t0 = time.perf_counter()
            asyncio.run(app.handle_user_message("what is on the card"))
            tui_s = time.perf_counter() - t0
            check(read_counts()["flash_attention_fwd"] >= dense.cfg.num_layers,
                  "the TUI turn's prefill did not launch K1")
        reply = app.messages[-1]
        check(reply.role == "assistant" and not reply.live and reply.content,
              f"the TUI's reply: {reply}")
        check(len(frames) > 2, f"the TUI reply arrived in {len(frames)} updates, not streamed")
        listing = app.handle_memory_command("list")
        check(listing.split("\n")[0].endswith(" memories") and made["created"] in listing,
              f"/mem list: {listing[:200]!r}")
        log(f"tools: TUI (headless, {len(tui.tool_manager.get_tools())} tools): one reply of "
            f"{TUI_TOKENS} tokens streamed in {len(frames)} updates, {tui_s:.3f} s on {card}; "
            f"/mem list -> {listing.splitlines()[0]!r}")
    finally:
        # the stdio MCP server stops with its manager's atexit hook
        stopped = memory.memory_server_stop()
        for k in env:
            os.environ.pop(k, None)
        tmp.cleanup()
    check(stopped == {"stopped": True} and not memdir.check_connection(),
          f"memory_server_stop: {stopped}")
    log(f"tools: memory_server_stop -> {stopped}; agent tools phase {time.perf_counter() - t_phase:.1f} s "
        f"on {card}")
    return launched


# ---------------------------------------------------------------- survival

SURVIVAL_SAMPLED = dict(temperature=0.8, top_p=0.9)
DRAIN_AT = 8  # the first short request's delivered tokens at the drain
DRAIN_DEADLINE_S = 0.2
SURVIVAL_NEW = 32  # tokens per request of the eight-request survival traffic
SEEDED_PAIR_LENS = (160, 250, 700, 1500)  # the seeded dense-vs-paged streams


def prng_on_card(card: str) -> None:
    """The threefry PRNG on the card against the CPU: the known-answer
    vector, a 128256-lane draw (bits bitwise, so the uniforms too), a
    chain of 1000 splits; and the time of one draw."""
    from fei_tpu_torch.engine import prng

    dev = torch.device("cuda")
    kat = prng.threefry2x32(*(torch.tensor(v, device=dev) for v in
                              (0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3)))
    check((int(kat[0]), int(kat[1])) == (0xC4923A9C, 0x483DF7A0),
          f"threefry known-answer vector on the card: {[hex(int(x)) for x in kat]}")
    V = 128256
    key = prng.split(prng.PRNGKey(SEED + 9))[1]
    bits = prng.random_bits(key.to(dev), (V,))
    check(torch.equal(bits.cpu(), prng.random_bits(key, (V,))),
          "128256-lane random bits differ between the card and the CPU")
    u_card = prng.uniform(key.to(dev), (V,), minval=torch.finfo(torch.float32).tiny).cpu()
    u_cpu = prng.uniform(key, (V,), minval=torch.finfo(torch.float32).tiny)
    check(torch.equal(u_card.view(torch.int32), u_cpu.view(torch.int32)),
          "uniforms differ between the card and the CPU")
    g_diff = (prng.gumbel(key.to(dev), (V,)).cpu() - prng.gumbel(key, (V,))).abs().max().item()
    k_card, k_cpu = prng.PRNGKey(SEED + 3, dev), prng.PRNGKey(SEED + 3)
    chain_card, chain_cpu = [], []
    for _ in range(1000):
        k_card, s_card = prng.split(k_card)
        k_cpu, s_cpu = prng.split(k_cpu)
        chain_card.append(s_card)
        chain_cpu.append(s_cpu)
    check(torch.equal(torch.stack(chain_card).cpu(), torch.stack(chain_cpu))
          and torch.equal(k_card.cpu(), k_cpu), "a chain of 1000 splits differs on the card")
    logits = torch.randn(8, V, device=dev)
    keys = prng.split(prng.PRNGKey(SEED), 8).to(dev)
    draw_ms = cuda_ms(lambda: prng.categorical(keys, logits))
    log(f"survival: threefry on {card}: known-answer vector, 128256-lane bits and uniforms "
        f"bitwise the CPU's (Gumbel noise within {g_diff:.3g}: torch.log on the card vs the "
        f"CPU), 1000 chained splits equal; an [8, 128256] draw {draw_ms:.3f} ms eager")


def sampler_launches(paged) -> dict:
    """What a sampled decode step adds over a greedy one: the batched
    sampling tail of the scheduler (split, filters, draw) at B = 8 over
    the vocab, greedy rows against sampled ones (temperature 0.8, top-p
    0.9). Counts aten ops dispatched (each launches at most a few kernels)
    and, where the profiler sees the card, the kernels themselves."""
    from types import SimpleNamespace

    from torch.utils._python_dispatch import TorchDispatchMode

    from fei_tpu_torch.engine import GenerationConfig
    from fei_tpu_torch.engine.sched_decode import _make_sampler

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    B, V = paged.batch_size, paged.cfg.vocab_size
    logits = torch.randn(B, V, device="cuda")
    keys = torch.zeros((B, 2), dtype=torch.int64, device="cuda")
    out = {}
    for kind, gen in (("greedy", GenerationConfig()),
                      ("sampled", GenerationConfig(**SURVIVAL_SAMPLED))):
        active = [(b, SimpleNamespace(gen=gen)) for b in range(B)]
        sample = _make_sampler(active, B, V, torch.device("cuda"))
        sample(logits, keys)  # warm
        torch.cuda.synchronize()
        with Ops() as ops:
            sample(logits, keys)
        kernels = None
        try:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                sample(logits, keys)
                torch.cuda.synchronize()
            kernels = sum(e.count for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA) or None
        except Exception as exc:  # noqa: BLE001 — the profiler is optional here
            log(f"survival: the profiler saw no device time ({exc!r})")
        ms = cuda_ms(lambda: sample(logits, keys))
        out[kind] = {"aten_ops": ops.n, "kernels": kernels, "ms": ms}
    return out


def first_sampled_divergence(dense, prompt, gen, want, got):
    """(position, noise+logit gap, allowed gap) where two seeded streams
    first differ: from the dense engine's logits at that position, the
    reference's filters and the key that step draws with, the gap between
    want's and got's token in filtered-logit-plus-Gumbel space; allowed is
    2 bf16 ulps of the larger logit over the temperature (F1's rule)."""
    from fei_tpu_torch.engine import prng
    from fei_tpu_torch.engine.sampling import filter_logits

    j = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    logits, _ = dense.prefill([list(prompt) + list(want[:j])], dense.new_cache(1))
    key = prng.PRNGKey(gen.seed, dense.device)
    for _ in range(j + 1):
        key, sub = prng.split(key)
    noised = filter_logits(logits, gen.temperature, gen.top_k, gen.top_p, gen.min_p) + \
        prng.gumbel(sub, logits.shape)
    pair = noised[0, [want[j], got[j]]]
    _, exp = torch.frexp(logits[0, [want[j], got[j]]].abs().max())
    return j, (pair[0] - pair[1]).item(), 2 * 2.0 ** (exp.item() - 8) / gen.temperature


def survival_traffic(eng, prompts, gens, on_deliver=None) -> dict:
    """All requests submitted at once; each stream read on its own
    thread. ``on_deliver(index, seq)`` runs on the loop thread after each
    delivered token. A stream that ends in EngineDrainingError keeps the
    tokens it got. Returns streams, per-request error, wall time."""
    from fei_tpu_torch.utils.errors import EngineDrainingError

    sched = eng.scheduler
    if on_deliver is not None:
        deliver = sched._deliver
        index: dict = {}

        def hooked(seq, t, key=None):
            deliver(seq, t, key)
            if id(seq) in index:
                on_deliver(index[id(seq)], seq)

        sched._deliver = hooked
    t0 = time.perf_counter()
    seqs = [sched.submit(p, g) for p, g in zip(prompts, gens)]
    if on_deliver is not None:
        index.update({id(s): i for i, s in enumerate(seqs)})
    streams, errors = [[] for _ in seqs], [None] * len(seqs)

    def read(i):
        try:
            for t in sched.drain(seqs[i]):
                streams[i].append(t)
        except EngineDrainingError as exc:
            errors[i] = exc

    with ThreadPoolExecutor(len(seqs)) as ex:
        list(ex.map(read, range(len(seqs))))
    torch.cuda.synchronize()
    if on_deliver is not None:
        sched._deliver = deliver
    return {"streams": streams, "errors": errors, "seqs": seqs,
            "wall": time.perf_counter() - t0}


def survival_phase(dense, paged, card: str) -> dict:
    """Survival on the card (bf16 llama3-8b, the paged engine's widths):
    the PRNG against the CPU; seeded streams dense against paged; a drain
    in mid-decode and a warm restart on a fresh engine; a journal copied
    in mid-stream and recovered; /drain over HTTP. Returns the kernel
    launches of the survival path's own runs (the seeded paged streams,
    the drained run, the warm restart, the journaled crash run, the
    recovery), each counted from 0 just before it; the references (the
    dense seeded streams, the uninterrupted run, the journal-cost run)
    are not counted."""
    import contextlib
    import os
    import shutil

    from fei_tpu_torch.agent.providers import TorchLocalProvider
    from fei_tpu_torch.engine import GenerationConfig, InferenceEngine
    from fei_tpu_torch.engine.checkpoint import load_request_snapshots
    from fei_tpu_torch.ui.server import ServeAPI, ServingServer

    t_phase = time.perf_counter()
    cfg = dense.cfg
    launched = dict.fromkeys(read_counts(), 0)

    @contextlib.contextmanager
    def survival_path():
        reset_counts()
        yield
        for k, v in read_counts().items():
            launched[k] += v

    def fresh(journal_dir=None, sync="batch"):
        with env_vars(FEI_TPU_JOURNAL_DIR=journal_dir or "", FEI_TPU_JOURNAL_SYNC=sync):
            return InferenceEngine.from_config(
                cfg.name, dtype=dense.dtype, params=dense.params, max_seq_len=dense.max_seq_len,
                device=dense.device, paged=True, batch_size=paged.batch_size,
                page_size=paged.page_size, num_layers=cfg.num_layers)

    def release(eng):
        eng.close()
        eng.scheduler.close_journal()
        gc.collect()
        torch.cuda.empty_cache()

    if dense.device.type == "cuda":
        prng_on_card(card)
        tails = sampler_launches(paged)
        log(f"survival: the scheduler's sampling tail at B = {paged.batch_size} on {card}: "
            f"greedy {tails['greedy']}, sampled {tails['sampled']}; a sampled step adds "
            f"{tails['sampled']['aten_ops'] - tails['greedy']['aten_ops']} aten ops"
            + ("" if None in (tails['sampled']['kernels'], tails['greedy']['kernels']) else
               f", {tails['sampled']['kernels'] - tails['greedy']['kernels']} kernels"))

    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(8, cfg.vocab_size, size=n).tolist()
               for n in SHORT_LENS + LONG_LENS]

    # (a) seeded streams: the dense engine against the paged one
    pair = [p for p in prompts if len(p) in SEEDED_PAIR_LENS]
    pair_gens = [GenerationConfig(max_new_tokens=NEW_TOKENS, ignore_eos=True,
                                  temperature=0.8, seed=SEED + 20 + i) for i in range(len(pair))]
    t0 = time.perf_counter()
    want = [list(dense.generate_stream(p, g)) for p, g in zip(pair, pair_gens)]
    with survival_path():
        got = survival_traffic(paged, pair, pair_gens)["streams"]
    verdicts = []
    for p, g, w, s in zip(pair, pair_gens, want, got):
        check(len(s) == NEW_TOKENS and len(set(s)) > 8, "a seeded stream is short or degenerate")
        if s == w:
            verdicts.append("equal")
            continue
        j, gap, allowed = first_sampled_divergence(dense, p, g, w, s)
        log(f"survival: seeded prompt {len(p)}: paged first differs from dense at token {j}, "
            f"noise+logit gap {gap:.6g} (allowed {allowed:.6g})")
        check(abs(gap) <= allowed, f"seeded prompt {len(p)}: gap {gap:.6g} > {allowed:.6g}")
        verdicts.append(f"tie at token {j}")
    log(f"survival: 4 seeded streams (temperature 0.8, {NEW_TOKENS} tokens, prompts "
        f"{[len(p) for p in pair]}) dense vs paged: {verdicts} "
        f"({time.perf_counter() - t0:.1f} s)")

    # (b) the uninterrupted run: four greedy and four seeded requests. The
    # 700-token prompt goes first: it admits in chunks and decodes before
    # the short ones admit densely, so when the first short request has
    # DRAIN_AT tokens both routes are mid-decode with few tokens to replay;
    # the longer prompts' chunks merge with their decode (K3)
    prompts = [prompts[4]] + prompts[:4] + prompts[5:]
    gens = [GenerationConfig(max_new_tokens=SURVIVAL_NEW, ignore_eos=True) if i % 2 == 0 else
            GenerationConfig(max_new_tokens=SURVIVAL_NEW, ignore_eos=True, seed=SEED + 30 + i,
                             **SURVIVAL_SAMPLED) for i in range(len(prompts))]
    # on a fresh engine, as the journaled runs below are: the three
    # aggregate rates then share every cold-start cost
    eng = fresh()
    ref = survival_traffic(eng, prompts, gens)
    release(eng)
    tok_s = {"off": len(prompts) * SURVIVAL_NEW / ref["wall"]}
    check(all(len(s) == SURVIVAL_NEW for s in ref["streams"]), "a reference stream is short")

    # (c) a drain in mid-decode on one engine, a warm restart on a fresh one
    with tempfile.TemporaryDirectory() as snap_dir:
        eng = fresh()
        marks = {}

        def drain_when_chunked_decodes(i, seq):
            if i == 1 and len(seq.generated) == DRAIN_AT and "t0" not in marks:
                marks["t0"] = time.perf_counter()
                eng.scheduler.begin_drain(deadline_s=DRAIN_DEADLINE_S, snapshot_dir=snap_dir)

        with survival_path():
            run = survival_traffic(eng, prompts, gens, drain_when_chunked_decodes)
            check(eng.wait_drained(600), "the drain never finalized")
        drained_s = time.perf_counter() - marks["t0"]
        release(eng)
        for s, r in zip(run["streams"], ref["streams"]):
            check(s == r[:len(s)], "a stream before the drain left the uninterrupted one")
        snaps = {s["rid"]: s for s in load_request_snapshots(snap_dir)}
        done = sum(e is None for e in run["errors"])
        check(len(snaps) + done == len(prompts), "a request was neither finished nor snapshotted")
        with_toks = [s["route"] for s in snaps.values() if s["generated"]]
        check({"dense", "chunked"} <= set(with_toks),
              f"the drain did not strand both routes mid-decode: {with_toks}")
        log(f"survival: drain at {DRAIN_AT} tokens of the {len(prompts[1])}-token request, deadline "
            f"{DRAIN_DEADLINE_S} s: "
            f"start -> drained {drained_s:.3f} s; {done} finished, {len(snaps)} snapshotted "
            f"(delivered {[len(s['generated']) for s in snaps.values()]}, routes "
            f"{[s['route'] for s in snaps.values()]})")

        eng = fresh()
        firsts = {}
        with survival_path():
            t0 = time.perf_counter()
            restored = eng.warm_restart(snap_dir)

            def finish(seq):
                out = []
                for t in eng.scheduler.drain(seq):
                    if not out:
                        firsts[seq.rid] = time.perf_counter() - t0
                    out.append(t)
                return out

            with ThreadPoolExecutor(len(restored)) as ex:
                outs = list(ex.map(finish, restored))
            torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        index = {tuple(p): i for i, p in enumerate(prompts)}
        for seq, out in zip(restored, outs):
            i = index[tuple(seq.prompt_ids)]
            check(out == ref["streams"][i],
                  f"restored request {i} (prompt {len(prompts[i])}) is not the uninterrupted "
                  "stream")
        by_route: dict = {}
        for seq in restored:
            snap = next(s for s in snaps.values() if s["prompt_ids"] == seq.prompt_ids)
            if snap["generated"]:
                by_route.setdefault(snap["route"], []).append(firsts[seq.rid] * 1e3)
        log(f"survival: warm restart on a fresh engine: {len(restored)} requests, every "
            f"completed stream bitwise the uninterrupted run's; first replayed token after "
            f"warm_restart, ms by route {({k: [round(x, 1) for x in v] for k, v in by_route.items()})}; "
            f"all done in {restore_s:.3f} s")

    # (d) the journal: its cost on the same traffic, then a crash
    with tempfile.TemporaryDirectory() as jroot:
        eng = fresh(os.path.join(jroot, "batch"), "batch")
        tok_s["batch"] = len(prompts) * SURVIVAL_NEW / survival_traffic(eng, prompts, gens)["wall"]
        release(eng)
        live, dead = os.path.join(jroot, "always"), os.path.join(jroot, "dead")
        eng = fresh(live, "always")

        def copy_mid_stream(i, seq):
            if i == 1 and len(seq.generated) == DRAIN_AT and not os.path.exists(dead):
                check(eng.scheduler._journal.flush(timeout=120), "the journal did not flush")
                shutil.copytree(live, dead)  # what a kill -9 leaves behind

        with survival_path():
            crash_run = survival_traffic(eng, prompts, gens, copy_mid_stream)
        tok_s["always"] = len(prompts) * SURVIVAL_NEW / crash_run["wall"]
        check(crash_run["streams"] == ref["streams"], "the journaled run changed a stream")
        release(eng)
        eng = fresh(dead)
        with survival_path():
            t0 = time.perf_counter()
            recovered = eng.warm_restart()
            delivered = [len(s.generated) for s in recovered]
            outs = [list(eng.scheduler.drain(s)) for s in recovered]
            torch.cuda.synchronize()
        rec_s = time.perf_counter() - t0
        index = {tuple(p): i for i, p in enumerate(prompts)}
        for seq, out in zip(recovered, outs):
            check(out == ref["streams"][index[tuple(seq.prompt_ids)]],
                  "a recovered stream is not the uninterrupted one")
        check(recovered and eng.warm_restart() == [], "a second restart found sessions")
        log(f"survival: crash (journal always, copied at {DRAIN_AT} tokens of the "
            f"{len(prompts[1])}-token request): {len(recovered)} sessions recovered, delivered "
            f"{delivered}, every stream bitwise the uninterrupted "
            f"run's, in {rec_s:.3f} s; a second restart finds nothing")
        log(f"survival: aggregate tok/s on the same 8 x {SURVIVAL_NEW} traffic on {card}: journal "
            f"off {tok_s['off']:.2f}, batch {tok_s['batch']:.2f}, always {tok_s['always']:.2f}")

        # (e) /drain over HTTP on the recovered engine
        api = ServeAPI(TorchLocalProvider(engine=eng), model_name=cfg.name)
        server = ServingServer(api, host="127.0.0.1", port=0)
        server.start()
        base = f"http://127.0.0.1:{server.port}"

        def http(method, path, body=None):
            req = urllib.request.Request(
                base + path, method=method, headers={"Content-Type": "application/json"},
                data=None if body is None else json.dumps(body).encode())
            try:
                with urllib.request.urlopen(req, timeout=600) as r:
                    return r.status, dict(r.headers), json.loads(r.read())
            except urllib.error.HTTPError as exc:
                return exc.code, dict(exc.headers), json.loads(exc.read())

        try:
            check(http("GET", "/health")[0] == 200, "/health before the drain")
            check(http("POST", "/drain", {"deadline_s": "soon"})[0] == 400,
                  "/drain took a deadline that is not a number")
            status, _, body = http("POST", "/drain", {"deadline_s": 1})
            check(status == 202 and body["status"] == "draining", f"/drain: {status} {body}")
            check(eng.wait_drained(60), "the HTTP drain never finalized")
            status, headers, body = http("GET", "/health")
            check(status == 503 and body["status"] == "draining" and "Retry-After" in headers,
                  f"/health while draining: {status} {body}")
            status, headers, _ = http("POST", "/v1/chat/completions", {
                "messages": [{"role": "user", "content": "hi"}], "max_tokens": 4})
            check(status == 503 and "Retry-After" in headers,
                  f"a completion while draining got {status}")
            log("survival: POST /drain -> 202; /health 503 draining; a new completion 503 "
                f"with Retry-After {headers['Retry-After']}")
        finally:
            server.stop()
            release(eng)
    log(f"survival: phase took {time.perf_counter() - t_phase:.1f} s")
    return launched


# ------------------------------------------------------------------ KV tier

KV_RAM_BYTES = "8g"  # holds every victim of the tight traffic and every publish
# every bf16 serving phase after the engine phase (paged engine through
# fleet) and the quantized phases run on the first 16 of llama3-8b's
# 32 layers at its widths, the KV phase on the first 8 (cut: time, every
# check kept; at 8 the survival drain finds no stream mid-decode and the
# fleet's greedy stream too few frames to drop)
SERVE_LAYERS = 16
KV_LAYERS = 8
KV_NEW = 32  # tokens a request of the int8, fault and prefix runs (cut: time)
KV_SAMPLED = dict(temperature=0.8, top_p=0.9)


def host_memory_gib() -> tuple[float, float]:
    """(MemFree, MemAvailable) of the host in GiB, from /proc/meminfo."""
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            name, value = line.split(":", 1)
            info[name] = int(value.split()[0]) * 1024
    return info["MemFree"] / 2**30, info.get("MemAvailable", 0) / 2**30


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


@contextlib.contextmanager
def resume_timer(eng, out: list):
    """Appends, for each re-admission of a preempted request, the ms from
    that re-admission to the request's next delivered token (host clock):
    a streamed resume's scatter, or a replay's re-prefill and replay."""
    sched = eng.scheduler
    resume, deliver = sched._try_streamed_resume, sched._deliver
    t_admit: dict = {}

    def timed_resume(seq, slot, prefix):
        t_admit[id(seq)] = time.perf_counter()
        return resume(seq, slot, prefix)

    def timed_deliver(seq, t, key=None):
        t0 = t_admit.pop(id(seq), None)
        deliver(seq, t, key)
        if t0 is not None:
            out.append((time.perf_counter() - t0) * 1e3)

    sched._try_streamed_resume, sched._deliver = timed_resume, timed_deliver
    try:
        yield
    finally:
        del sched._try_streamed_resume, sched._deliver


@contextlib.contextmanager
def transfer_timer(out: list, device):
    """Appends one record per page gather (spill or publish) and scatter
    (fetch) the KV tier makes: direction, bytes, seconds (host clock around
    the copy, the device synchronised on both sides), array names."""
    from fei_tpu_torch.kv import pagesio

    gather, scatter = pagesio.gather_pages, pagesio.scatter_pages

    def timed_gather(pool, pages):
        sync(device)
        t0 = time.perf_counter()
        got = gather(pool, pages)
        out.append({"op": "gather", "bytes": sum(a.nbytes for a in got.values()),
                    "s": time.perf_counter() - t0, "names": sorted(got)})
        return got

    def timed_scatter(pool, pages, arrays):
        sync(device)
        t0 = time.perf_counter()
        scatter(pool, pages, arrays)
        sync(device)
        n = len(pages)
        out.append({"op": "scatter", "bytes": sum(np.asarray(a)[:n].nbytes for a in arrays.values()),
                    "s": time.perf_counter() - t0, "names": sorted(arrays)})

    pagesio.gather_pages, pagesio.scatter_pages = timed_gather, timed_scatter
    try:
        yield
    finally:
        pagesio.gather_pages, pagesio.scatter_pages = gather, scatter


def pinned_copy_gbps(nbytes: int) -> tuple[float, float]:
    """(device -> host, host -> device) GB/s of one ``copy_`` of ``nbytes``
    between the card and pinned host memory: the host link's yardstick
    (best of three, host clock around a synchronised copy)."""
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)

    def best(fn) -> float:
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return nbytes / min(times) / 1e9

    return best(lambda: host.copy_(dev)), best(lambda: dev.copy_(host))


def kv_weights():
    """The dense engine the later serving phases run on after the serve
    phase: the seed's llama3-8b with the LM head zeroed past the byte
    tokenizer's ids, its first ``SERVE_LAYERS`` layers (for ``--kv``,
    ``--fleet``, ``--spec`` and ``--tools``, which run their phase alone)."""
    from fei_tpu_torch.engine import InferenceEngine

    dense = InferenceEngine.from_config("llama3-8b", dtype=torch.bfloat16, seed=SEED,
                                        max_seq_len=8192, device="cuda")
    dense.params["lm_head"][:, dense.tokenizer.vocab_size:] = 0
    return depth(dense, SERVE_LAYERS)


def depth(dense, layers: int):
    """A dense engine on the first ``layers`` layers of ``dense``'s weights
    at llama3-8b's widths (views of the same tensors, no copy)."""
    from fei_tpu_torch.engine import InferenceEngine

    params = {**dense.params,
              "layers": {k: v[:layers] for k, v in dense.params["layers"].items()}}
    return InferenceEngine.from_config(
        dense.cfg.name, dtype=dense.dtype, params=params, max_seq_len=dense.max_seq_len,
        device=dense.device, num_layers=layers)


def kv_phase(dense, card: str) -> dict:
    """The KV tier on the card (bf16 llama3-8b, 8 rows, page 64): spill
    before preemption and streamed resume in the tight pool (``ram``, then
    ``disk``), an int8 pool, the fault points, a content-addressed prefix
    hit, prefix migration between engines and the /kv routes over HTTP.
    Every check counts spills and fetches, not only streams. Returns the
    kernel launches of the phase's tier-on runs, each counted from 0 just
    before it; the tier-off references are not counted."""
    import base64
    import dataclasses
    import os

    from fei_tpu_torch.agent.providers import TorchLocalProvider
    from fei_tpu_torch.engine import GenerationConfig, InferenceEngine
    from fei_tpu_torch.engine.faults import FAULTS
    from fei_tpu_torch.kv.pagesio import gather_pages
    from fei_tpu_torch.kv.tier import PageEntry, pack_entry, unpack_entry
    from fei_tpu_torch.ui.server import ServeAPI, ServingServer
    from fei_tpu_torch.utils.metrics import METRICS

    t_phase = time.perf_counter()
    cfg, dev = dense.cfg, dense.device
    free, avail = host_memory_gib()
    log(f"kv: host memory free {free:.1f} GiB, available {avail:.1f} GiB; RAM budget "
        f"{KV_RAM_BYTES} on {card}")
    launched = dict.fromkeys(read_counts(), 0)

    @contextlib.contextmanager
    def kv_path():
        reset_counts()
        yield
        for k, v in read_counts().items():
            launched[k] += v

    def fresh(mode="off", num_pages=None, kv_quant=None, prefix_cache=False, **env):
        with env_vars(**{"FEI_TPU_KV_TIER": mode, "FEI_TPU_KV_RAM_BYTES": KV_RAM_BYTES, **env}):
            return InferenceEngine.from_config(
                cfg.name, dtype=dense.dtype, params=dense.params, max_seq_len=dense.max_seq_len,
                num_layers=cfg.num_layers,
                device=dev, paged=True, batch_size=8, page_size=PAGE, num_pages=num_pages,
                kv_quant=kv_quant, prefix_cache=prefix_cache)

    def release(eng):
        eng.close()
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    def snap():
        return METRICS.snapshot()

    def delta(before, name):
        return counter(name) - before["counters"].get(name, 0.0)

    def span_delta(before, name):
        a = before["spans"].get(name, {"count": 0, "total_s": 0.0})
        b = snap()["spans"].get(name, {"count": 0, "total_s": 0.0})
        return b["count"] - a["count"], b["total_s"] - a["total_s"]

    def divergence(prompt, gen, want, got) -> str:
        if gen.temperature > 0:
            j, gap, allowed = first_sampled_divergence(dense, prompt, gen, want, got)
            return f"token {j}, noise+logit gap {gap:.6g} (2 ulps: {allowed:.6g})"
        j, gap, ulp = first_divergence(dense, prompt, want, got)
        return f"token {j}, logit gap {gap:.6g} ({gap / ulp:.3g} bf16 ulps)"

    kv_names = ("scheduler.preemptions", "kv.spills", "kv.fetches", "kv.pages_spilled",
                "kv.pages_restored", "kv.fetch_fallbacks", "kv.spill_failures",
                "kv.spill_skipped_length", "kv.demotions",
                "scheduler.preempted_tokens_recomputed")

    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(8, cfg.vocab_size, size=n).tolist()
               for n in SHORT_LENS + LONG_LENS]
    # four greedy and four seeded (top-p) requests, both kinds on both routes
    gens = [GenerationConfig(max_new_tokens=NEW_TOKENS, ignore_eos=True) if i % 2 == 0 else
            GenerationConfig(max_new_tokens=NEW_TOKENS, ignore_eos=True, seed=SEED + 40 + i,
                             **KV_SAMPLED) for i in range(len(prompts))]
    short_gens = [dataclasses.replace(g, max_new_tokens=KV_NEW) for g in gens]

    # (a) the roomy traffic with the tier off (the reference) and on
    eng = fresh("off")
    ref = traffic(eng, prompts, NEW_TOKENS, gens)
    release(eng)
    roomy = ref["streams"]
    check(all(len(s) == NEW_TOKENS for s in roomy), "a roomy reference stream is short")
    eng = fresh("ram")
    before = snap()
    pubs: list = []
    with kv_path(), transfer_timer(pubs, dev):
        run = traffic(eng, prompts, NEW_TOKENS, gens)
    n_pub, pub_s = span_delta(before, "kv_spill")
    release(eng)
    check(run["streams"] == roomy, "the tier changed a roomy stream")
    check(n_pub == len(prompts) and delta(before, "kv.cas_stores") == len(prompts),
          f"{n_pub} publishes for {len(prompts)} new prompts")
    total = len(prompts) * NEW_TOKENS
    tok_s = {"off": total / ref["wall"], "ram": total / run["wall"]}
    log(f"kv: roomy 8 x {NEW_TOKENS} (4 greedy, 4 top-p) on {card}: tier off {tok_s['off']:.2f} tok/s, "
        f"ram {tok_s['ram']:.2f} tok/s (the same streams); {n_pub} prefix publishes, "
        f"{pub_s * 1e3 / max(n_pub, 1):.1f} ms each (kv_spill span), "
        f"{sum(x['bytes'] for x in pubs) / 2**20:.1f} MiB in all; by size "
        + ", ".join(f"{x['bytes'] / 2**20:.0f} MiB {x['s'] * 1e3:.1f} ms" for x in pubs))

    # (b) the tight pool: tier off (replay) against ram (streamed resume)
    lat = {"off": [], "ram": []}
    xfers: list = []
    eng = fresh("off", num_pages=129)
    before = snap()
    with resume_timer(eng, lat["off"]):
        t_off = traffic(eng, prompts, NEW_TOKENS, gens)
    d_off = {k: delta(before, k) for k in kv_names}
    release(eng)
    check(d_off["scheduler.preemptions"] >= 1, "the tight pool never preempted")
    same_off = [a == b for a, b in zip(t_off["streams"], roomy)]
    eng = fresh("ram", num_pages=129)
    before = snap()
    with kv_path(), resume_timer(eng, lat["ram"]), transfer_timer(xfers, dev):
        t_ram = traffic(eng, prompts, NEW_TOKENS, gens)
    d = {k: delta(before, k) for k in kv_names}
    release(eng)
    log(f"kv: tight pool (129 pages), 8 x {NEW_TOKENS}: tier off {d_off}; ram {d}")
    log(f"kv: tight pool, tier off: streams equal to the roomy run: {same_off}")
    check(d["scheduler.preemptions"] >= 1, "the tight pool never preempted (ram)")
    check(d["kv.spills"] >= 1, f"no spill in the tight pool: {d}")
    check(d["kv.fetches"] >= 1 and d["kv.pages_restored"] > 0, f"no streamed resume: {d}")
    check(d["kv.fetch_fallbacks"] == 0, f"a resume fell back to replay: {d}")
    check(d["scheduler.preempted_tokens_recomputed"] == 0,
          f"a resume recomputed tokens instead of streaming pages: {d}")
    same = [a == b for a, b in zip(t_ram["streams"], roomy)]
    for i, ok in enumerate(same):
        if not ok:
            log(f"kv: tight ram stream {i} (prompt {len(prompts[i])}, temperature "
                f"{gens[i].temperature}) first differs from the roomy run at "
                + divergence(prompts[i], gens[i], roomy[i], t_ram["streams"][i]))
    check(all(same), f"a streamed resume left the roomy stream: {same}")
    log(f"kv: tight pool, ram: every stream (4 greedy, 4 top-p 0.9) bitwise the roomy run's")

    # (c) the disk rung: a RAM budget below one entry sends all but the
    # newest entry to disk. The tight traffic of (b): at fewer tokens, or
    # in a smaller pool, whether anything preempts depends on when the
    # requests arrive (runs of 8 x 32 in 100 pages preempted 0 to 6 times).
    # A victim is usually resumed before any other entry lands, so its
    # entry is still the newest, in RAM, or its demotion is still being
    # written (one full run read 2 of 29 resumes from disk, the next 0).
    # So before each resume's fetch the smoke puts an empty entry, as
    # another session's spill would, which demotes the victim's, and waits
    # for the writer: every streamed resume of this rung reads disk.
    disk_hits: list = []
    with tempfile.TemporaryDirectory() as ddir:
        eng = fresh("disk", num_pages=129, FEI_TPU_KV_RAM_BYTES="1", FEI_TPU_KV_DISK_DIR=ddir,
                    FEI_TPU_KV_DISK_BYTES="64g")
        tier = eng.scheduler._kv_tier
        fetch = tier.fetch
        push = "smoke:push-to-disk"

        def fetch_from_disk(key):
            # loop thread, like every put: nothing else lands meanwhile
            with tier._lock:
                in_ram = key in tier._ram
            if in_ram:
                tier.put(push, PageEntry(push, 0, PAGE, {}))
            tier.flush()
            if in_ram:
                tier.drop(push)
            with tier._lock:
                on_disk = key in tier._disk
            t0 = time.perf_counter()
            got = fetch(key)
            if got is not None and on_disk:  # read, sha256 and unpack, inline
                disk_hits.append((got.nbytes, time.perf_counter() - t0))
            return got

        tier.fetch = fetch_from_disk
        before = snap()
        x_disk: list = []
        with kv_path(), transfer_timer(x_disk, dev):
            t_disk = traffic(eng, prompts, NEW_TOKENS, gens)
        tier.flush()
        d_disk = {k: delta(before, k) for k in kv_names}
        release(eng)
    log(f"kv: disk rung (129 pages, RAM budget 1 byte), 8 x {NEW_TOKENS}: {d_disk}; fetches served from "
        f"disk {len(disk_hits)} (each pushed there first), {sum(b for b, _ in disk_hits) / 2**20:.0f} MiB read, "
        "checksummed and unpacked at "
        + (f"median {statistics.median(b / t / 1e9 for b, t in disk_hits):.2f} GB/s (min "
           f"{min(b / t / 1e9 for b, t in disk_hits):.2f}, max "
           f"{max(b / t / 1e9 for b, t in disk_hits):.2f})" if disk_hits else "-")
        + f" on {card}")
    check(d_disk["kv.demotions"] >= 1, f"nothing was demoted to disk: {d_disk}")
    check(d_disk["kv.fetches"] >= 1 and len(disk_hits) == d_disk["kv.fetches"],
          f"{len(disk_hits)} of {d_disk['kv.fetches']:.0f} streamed resumes read disk")
    check(d_disk["kv.fetch_fallbacks"] == 0 and d_disk["scheduler.preempted_tokens_recomputed"] == 0,
          f"a disk resume fell back to replay: {d_disk}")
    check(t_disk["streams"] == roomy, "a disk-rung stream left the roomy run's")

    # (d) an int8 pool, tight: spills carry the scales; (e) the fault points
    four = [0, 1, 4, 5]  # prompts 96, 160 (dense admission), 700, 1500 (chunked)
    p4, g4 = [prompts[i] for i in four], [short_gens[i] for i in four]
    eng = fresh("off", num_pages=30, kv_quant="int8")
    before = snap()
    q_off = traffic(eng, p4, KV_NEW, g4)
    pre8 = delta(before, "scheduler.preemptions")
    release(eng)
    x8: list = []
    eng = fresh("ram", num_pages=30, kv_quant="int8")
    before = snap()
    with kv_path(), transfer_timer(x8, dev):
        q_ram = traffic(eng, p4, KV_NEW, g4)
    d8 = {k: delta(before, k) for k in kv_names}
    log(f"kv: int8 pool (30 pages), 4 x {KV_NEW}: tier off {pre8:.0f} preemptions; ram {d8}")
    check(pre8 >= 1 and d8["kv.spills"] >= 1 and d8["kv.fetches"] >= 1,
          f"the int8 pool did not spill and resume: {d8}")
    check(all("k_scales" in x["names"] and "v_scales" in x["names"] for x in x8),
          "an int8 transfer carried no scales")
    check(d8["scheduler.preempted_tokens_recomputed"] == 0, f"an int8 resume replayed: {d8}")
    check(q_ram["streams"] == q_off["streams"], "int8 streams differ with the tier on")
    faults = []
    for point, kind in (("kv.fetch", "io"), ("kv.fetch", "corrupt"), ("kv.fetch", "hang"),
                        ("kv.spill", "io")):
        FAULTS.disarm()
        FAULTS.arm(point, kind, count=99)
        before = snap()
        try:
            with kv_path():
                r = traffic(eng, p4, KV_NEW, g4)
            fired = FAULTS.fired(point)
        finally:
            FAULTS.disarm()
        counted = delta(before, "kv.fetch_fallbacks" if point == "kv.fetch" else "kv.spill_failures")
        faults.append(f"{point}:{kind} fired {fired}, counted {counted:.0f}")
        check(fired >= 1, f"{point}:{kind} never fired")
        check(counted == fired, f"{point}:{kind}: fired {fired}, counted {counted}")
        check(r["streams"] == q_off["streams"], f"{point}:{kind} changed a stream")
    release(eng)
    log(f"kv: faults on the int8 pool, every stream equal to the tier-off run: {faults}")

    # (f) a content-addressed prefix: publish, evict the local prefix cache,
    # admit again through the tier
    p3000 = prompts[SHORT_LENS.__len__() + 2]
    g = GenerationConfig(max_new_tokens=KV_NEW, ignore_eos=True)
    a = fresh("ram", num_pages=257, prefix_cache=True)
    with kv_path():
        cold = list(a.scheduler.stream(p3000, g))
        before = snap()
        local = list(a.scheduler.stream(p3000, g))
        check(delta(before, "prefix.hits") >= 1, "the second admission missed the prefix cache")
        sched = a.scheduler

        def evict_all():
            n = 0
            while sched._prefix._evict_one():
                n += 1
            return n

        evicted = sched.run_ctl(evict_all)
        before = snap()
        cas = list(a.scheduler.stream(p3000, g))
    saved = (len(p3000) - 1) // PAGE * PAGE
    check(delta(before, "kv.prefix_hits_tier") == 1, "the admission did not hit the tier")
    check(delta(before, "scheduler.prefill_tokens") == len(p3000) - saved,
          f"prefilled {delta(before, 'scheduler.prefill_tokens')} tokens, not the "
          f"{len(p3000) - saved}-token suffix")
    check(cas == local, "the tier hit's stream is not the local prefix hit's")
    vs_cold = "bitwise"
    if cas != cold:
        j, gap, ulp = first_divergence(dense, p3000, cold, cas)
        vs_cold = f"first differs at token {j}, logit gap {gap / ulp:.3g} bf16 ulps"
        check(abs(gap) <= 2 * ulp, f"the tier hit left the cold stream by {gap / ulp} ulps")
    log(f"kv: {len(p3000)}-token prompt: {evicted} local prefix entries evicted through "
        f"run_ctl, then a tier hit of {saved // PAGE} pages: prefilled "
        f"{len(p3000) - saved} tokens; stream bitwise the local hit's; against the cold "
        f"run: {vs_cold}")

    # (g) migration to a second engine with a small pool, then the routes
    b = fresh("ram", num_pages=129, prefix_cache=True)
    with kv_path():
        t0 = time.perf_counter()
        blob = a.scheduler.export_prefix(p3000)
        t_exp = time.perf_counter() - t0
        check(blob is not None, "nothing to export")
        entry, _ = unpack_entry(blob)
        t0 = time.perf_counter()
        landed = b.scheduler.import_prefix(blob)
        t_imp = time.perf_counter() - t0
        check(landed == entry.n_pages, f"imported {landed} of {entry.n_pages} pages")
        sb = b.scheduler
        back = sb.run_ctl(lambda: gather_pages(sb._pool, sb._prefix.match(p3000)))
        check(set(back) == set(entry.arrays) and all(
            back[k].tobytes() == entry.arrays[k].tobytes() for k in back),
            "the imported pages are not the blob's bytes")
        before = snap()
        moved = list(b.scheduler.stream(p3000, g))
    check(delta(before, "prefix.hits") >= 1, "the migrated prefix did not hit")
    check(moved == local, "the migrated prefix's stream is not the source's hit stream")
    log(f"kv: migration of {entry.n_pages} pages ({len(blob) / 2**20:.1f} MiB blob) on {card}: export "
        f"{t_exp * 1e3:.1f} ms, import {t_imp * 1e3:.1f} ms; pages bitwise the blob's, the "
        "next admission a prefix hit with the source's stream")

    servers = [ServingServer(ServeAPI(TorchLocalProvider(engine=e), model_name=cfg.name),
                             host="127.0.0.1", port=0) for e in (a, b)]
    for srv in servers:
        srv.start()
    base_a, base_b = (f"http://127.0.0.1:{srv.port}" for srv in servers)

    def http(base, method, path, body=None):
        req = urllib.request.Request(
            base + path, method=method, headers={"Content-Type": "application/json"},
            data=None if body is None else json.dumps(body).encode())
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as exc:
            return exc.code, json.loads(exc.read())

    text = "".join(chr(c) for c in rng.integers(97, 123, size=220))
    msgs = [{"role": "user", "content": text}]
    chat = {"messages": msgs, "max_tokens": 4, "temperature": 0}
    try:
        with kv_path():
            check(http(base_a, "POST", "/v1/chat/completions", chat)[0] == 200, "completion on A")
            status, listed = http(base_a, "GET", "/kv/prefix")
            status, probe = http(base_a, "POST", "/kv/prefix/probe", {"messages": msgs})
            check(status == 200 and probe["have"] and probe["have"][0] in listed["hashes"],
                  f"/kv/prefix does not list the published prefix: {listed} {probe}")
            h = probe["have"][0]
            status, got = http(base_a, "GET", f"/kv/prefix/{h}")
            check(status == 200 and got["hash"] == h, f"GET /kv/prefix/<hash>: {status}")
            status, pushed = http(base_b, "POST", "/kv/prefix", {"hash": h, "blob": got["blob"]})
            check(status == 200 and pushed["stored"] is True, f"POST /kv/prefix: {status} {pushed}")
            before = snap()
            check(http(base_b, "POST", "/v1/chat/completions", chat)[0] == 200, "completion on B")
            check(delta(before, "kv.prefix_hits_tier") == 1, "B's completion did not hit the push")
            status, exported = http(base_a, "POST", "/kv/export", {"messages": msgs})
            check(status == 200, f"/kv/export: {status}")
            status, imported = http(base_b, "POST", "/kv/import", {"blob": exported["blob"]})
            check(status == 200 and imported["pages"] > 0, f"/kv/import: {status} {imported}")
        e, _ = unpack_entry(base64.b64decode(got["blob"]))
        wrong = pack_entry(PageEntry(key=e.key, n_tokens=e.n_tokens, page_size=32,
                                     fingerprint=dict(e.fingerprint, page_size=32),
                                     arrays=e.arrays, layout=e.layout))
        status, err = http(base_b, "POST", "/kv/prefix",
                           {"hash": e.key, "blob": base64.b64encode(wrong).decode()})
        check(status == 409 and err["error"]["theirs"]["page_size"] == 32
              and err["error"]["ours"]["page_size"] == PAGE, f"a page-32 blob got {status}")
        check(http(base_b, "POST", "/kv/import", {"blob": "not base64!!"})[0] == 400,
              "bad base64 was not a 400")
        check(http(base_a, "GET", "/kv/prefix/cas:" + "00" * 32)[0] == 404, "unknown hash")
        status, health = http(base_b, "GET", "/health")
        check(health.get("kv_fingerprint", {}).get("dtype") == "bfloat16"
              and health["kv_layout"]["tp"] == 1, f"/health: {health}")
        log(f"kv: HTTP: /kv/prefix lists the {e.n_pages}-page prefix of a "
            f"{len(listed['hashes'])}-hash tier, GET /kv/prefix/<hash> ({got['bytes'] / 2**20:.1f} "
            "MiB) -> POST /kv/prefix on B (stored) -> B's completion hits it; /kv/export -> "
            f"/kv/import {imported['pages']} pages; page-32 blob 409, bad base64 400, unknown "
            f"hash 404; /health kv_fingerprint {health['kv_fingerprint']}")
    finally:
        for srv in servers:
            srv.stop()
        release(a)
        release(b)

    # (h) times, on the card
    if dev.type == "cuda":
        for run, records in (("tight ram", xfers), ("disk rung", x_disk)):
            by = {}
            for x in records:
                by.setdefault((x["op"], x["bytes"]), []).append(x["bytes"] / x["s"] / 1e9)
            for (op, nbytes), rates in sorted(by.items()):
                d2h, h2d = pinned_copy_gbps(nbytes)
                what = "gather (spill/publish)" if op == "gather" else "scatter (fetch)"
                log(f"kv: {run}: {what} of {nbytes / 2**20:.1f} MiB x {len(rates)}: "
                    f"{statistics.median(rates):.2f} GB/s (min {min(rates):.2f}, max "
                    f"{max(rates):.2f}); a pinned copy_ of the same bytes "
                    f"{d2h if op == 'gather' else h2d:.2f} GB/s "
                    f"({'device -> host' if op == 'gather' else 'host -> device'}) on {card}")
    for mode in ("off", "ram"):
        v = lat[mode]
        log(f"kv: resume -> next token, tier {mode} "
            f"({'replay' if mode == 'off' else 'streamed'}): n={len(v)} "
            + (f"median {statistics.median(v):.1f} ms, min {min(v):.1f}, max {max(v):.1f}"
               if v else "no resume") + f" on {card}")
    log(f"kv: tight traffic (8 x {NEW_TOKENS}, 129 pages) wall: tier off {t_off['wall']:.3f} s, "
        f"ram {t_ram['wall']:.3f} s, disk {t_disk['wall']:.3f} s (every resume read from disk after its "
        f"entry's write was awaited) on {card}")
    log(f"kv: phase took {time.perf_counter() - t_phase:.1f} s; launches {launched}")
    return launched


# ------------------------------------------------- fleet and observability

FLEET_LENS = SHORT_LENS + LONG_LENS  # characters of each session's first turn (byte ids)
FLEET_NEW = 32  # tokens a turn
FLEET_PAGES = 513  # each replica's pool
# top-p 0.9 inside the top 40: the LM head is zeroed past the byte
# tokenizer's ids, and their 128k zero logits would otherwise take most of a
# draw's mass, leaving a stream with no visible text (no content frame, so no
# ``fei`` ids for the router's ledger)
FLEET_SAMPLED = dict(temperature=0.8, top_p=0.9, top_k=40)
FLEET_DROP_NEW = 64  # tokens of a stream dropped by its replica
FLEET_DROP_AFTER = 16  # content frames before the drop
FLEET_SPLIT_IDS = 512  # a first turn of at least this many ids is prefill work


def fleet_text(rng, n: int) -> str:
    """``n`` characters of lowercase words: the byte tokenizer gives one id
    per character."""
    return "".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz   "), size=n).tolist())


def read_sse(frames) -> dict:
    """A stream's content, its ``fei`` token ids, error frames, ids and
    finish reason."""
    from fei_tpu_torch.fleet.router import _parse_sse

    out = {"content": [], "toks": [], "errors": [], "ids": set(), "finish": None,
           "frames": 0}
    for f in frames:
        info = _parse_sse(f)
        if info is None:
            continue
        if info.get("error"):
            out["errors"].append(info["error"])
            continue
        if info.get("id"):
            out["ids"].add(info["id"])
        out["toks"] += list((info.get("fei") or {}).get("toks") or [])
        choice = (info.get("choices") or [{}])[0]
        delta = choice.get("delta") or {}
        if delta.get("content"):
            out["content"].append(delta["content"])
            out["frames"] += 1
        if choice.get("finish_reason"):
            out["finish"] = choice["finish_reason"]
    out["content"] = "".join(out["content"])
    return out


class DroppingReplica:
    """A replica whose next stream, once armed, drops its transport after
    ``after`` content frames: a dead in-process replica as the router sees
    it (the HTTP replica dies for real, through the ``replica.crash``
    fault)."""

    def __init__(self, inner):
        self.inner, self.after = inner, None

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def stream(self, body, headers=None):
        from fei_tpu_torch.fleet.router import _parse_sse

        gen, after, self.after = self.inner.stream(body, headers), self.after, None
        if after is None:
            return gen

        def dropped():
            n = 0
            for f in gen:
                yield f
                choice = ((_parse_sse(f) or {}).get("choices") or [{}])[0]
                if (choice.get("delta") or {}).get("content"):
                    n += 1
                    if n >= after:
                        gen.close()
                        raise ConnectionResetError("replica dropped the stream")
        return dropped()


def fleet_phase(dense, card: str) -> dict:
    """The fleet phase on the card: the fleet router over two paged replicas of
    llama3-8b (``a`` prefill-heavy in process, ``b`` decode-heavy behind
    its HTTP server), the flight recorder, traces, cost model and /debug
    routes watching it. Checks counters, not only streams; returns the
    kernel launches of the fleet's own runs (the one-scheduler reference
    runs are not counted)."""
    import os

    from fei_tpu_torch.agent.providers import TorchLocalProvider
    from fei_tpu_torch.engine import GenerationConfig, InferenceEngine, faults
    from fei_tpu_torch.engine.faults import FAULTS
    from fei_tpu_torch.fleet import HttpReplica, InProcessReplica, Router
    from fei_tpu_torch.obs import METRICS, costmodel, help_for
    from fei_tpu_torch.ui.server import ServeAPI, ServingServer, _gen_overrides

    t_phase, t_epoch = time.perf_counter(), time.time()
    cfg = dense.cfg
    check(costmodel.H100_HBM_GBPS * 1e9 == PEAK_BYTES_PER_S
          and costmodel.H100_BF16_FLOPS == PEAK_BF16_FLOPS,
          "the cost model's ceilings are not this script's")
    launched = dict.fromkeys(read_counts(), 0)
    walls: dict[str, float] = {}
    mark = [time.perf_counter()]

    def wall(name: str) -> None:
        now = time.perf_counter()
        walls[name] = round(now - mark[0], 2)
        mark[0] = now
        log(f"fleet: {name} done in {walls[name]} s")

    @contextlib.contextmanager
    def fleet_path():
        reset_counts()
        yield
        for k, v in read_counts().items():
            launched[k] += v

    env = {"FEI_TPU_KV_TIER": "ram", "FEI_TPU_KV_RAM_BYTES": "1g",
           "FEI_TPU_ROUTER_PREFILL_TOKENS": str(FLEET_SPLIT_IDS // 4)}
    old_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)

    def engine(tier: bool = True):
        os.environ["FEI_TPU_KV_TIER"] = "ram" if tier else "off"
        return InferenceEngine.from_config(
            cfg.name, dtype=dense.dtype, params=dense.params, max_seq_len=dense.max_seq_len,
            num_layers=cfg.num_layers,
            device=dense.device, paged=True, batch_size=8, page_size=PAGE,
            num_pages=FLEET_PAGES, prefix_cache=True)

    def api(eng, role):
        return ServeAPI(TorchLocalProvider(engine=eng), model_name=cfg.name, role=role)

    engines: list = []
    served: dict[str, list] = {"fleet": [], "ref": []}
    scratch: list = []  # directories the phase leaves behind, removed at its end

    def record(eng, side: str):
        """Keep every sequence the engine's scheduler admits: its whole
        token list, visible text or not (``fei`` ids ride content frames
        only), is what the streams are held to."""
        submit = eng.scheduler.submit

        def recorded(*args, **kw):
            seq = submit(*args, **kw)
            served[side].append(seq)
            return seq

        eng.scheduler.submit = recorded
        return eng

    a_api = api(record(engine(), "fleet"), "prefill-heavy")
    b_api = api(record(engine(), "fleet"), "decode-heavy")
    # the one scheduler the streams are held to
    ref_api = api(record(engine(tier=False), "ref"), "mixed")
    engines += [a_api.provider.engine, b_api.provider.engine, ref_api.provider.engine]

    def tokens(side: str, b_) -> list:
        """The completed sequence of ``b_``'s prompt on that side."""
        ids = ref_api._prompt_ids(b_)
        done = [s_ for s_ in served[side] if s_.prompt_ids == ids and s_.status == "completed"]
        check(len(done) >= 1, f"no completed {side} sequence for a {len(ids)}-id prompt")
        return list(done[-1].generated)
    server = ServingServer(b_api, host="127.0.0.1", port=0)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    a = DroppingReplica(InProcessReplica("a", api=a_api))
    b = HttpReplica("b", base, timeout_s=600)
    router = Router([a, b], retries=2, backoff_s=0.05, breaker_fails=3,
                    breaker_cooldown_s=1.0, health_ttl_s=0.0)
    moves: list = []  # (src, dst, seconds, moved) of each migration
    migrate = router._migrate

    def timed_migrate(src, dst, body_):
        t0 = time.perf_counter()
        ok = migrate(src, dst, body_)
        moves.append((src, dst, round(time.perf_counter() - t0, 3), ok))
        return ok

    router._migrate = timed_migrate
    kv_s: dict = {}  # seconds inside each replica's /kv handlers (its share of a move)

    def timed_kv(api_, name):
        fn = getattr(api_, name)

        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                kv_s.setdefault(name, []).append(round(time.perf_counter() - t0, 3))
        setattr(api_, name, run)

    timed_kv(a_api, "_kv_export")
    timed_kv(b_api, "_kv_import")
    counts0 = METRICS.snapshot()["counters"]
    wall("set-up")

    def grew(name: str) -> float:
        return counter(name) - counts0.get(name, 0.0)

    rng = np.random.default_rng(SEED + 5)
    firsts = [fleet_text(rng, n) for n in FLEET_LENS]
    seconds = [fleet_text(rng, 40) for _ in FLEET_LENS]

    def body(messages, i, new=FLEET_NEW):
        b_ = {"messages": messages, "max_tokens": new, "ignore_eos": True, "model": cfg.name}
        b_.update(dict(FLEET_SAMPLED, seed=SEED + 60 + i) if i % 2 else {"temperature": 0})
        return b_

    def gen_of(b_) -> GenerationConfig:
        return GenerationConfig(max_new_tokens=b_["max_tokens"], **_gen_overrides(b_))

    def run_router(bodies, sessions):
        out = [None] * len(bodies)
        errs = []

        def go(i):
            try:
                t0 = time.perf_counter()
                frames = []
                for f in router.stream_chat(dict(bodies[i]), {"X-FEI-Session": sessions[i]}):
                    frames.append(f)
                    if f == b"data: [DONE]\n\n":
                        t_done = time.perf_counter()
                out[i] = read_sse(frames)
                # the client's stream, then the router's handoff after it
                out[i]["s"] = (round(t_done - t0, 2), round(time.perf_counter() - t_done, 2))
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                errs.append(exc)

        ts = [threading.Thread(target=go, args=(i,)) for i in range(len(bodies))]
        [t.start() for t in ts]
        [t.join() for t in ts]
        if errs:
            raise errs[0]
        return out

    def run_ref(bodies):
        out = [None] * len(bodies)

        def go(i):
            kw = ref_api._parse_request(dict(bodies[i]), {})
            out[i] = read_sse(ref_api.stream_chat(dict(bodies[i]), kw))

        ts = [threading.Thread(target=go, args=(i,)) for i in range(len(bodies))]
        [t.start() for t in ts]
        [t.join() for t in ts]
        return out

    def agree(label, b_, want, got) -> str:
        """Equal token streams, or first apart at a tie within 2 bf16 ulps."""
        check(len(got) == len(want) == b_["max_tokens"],
              f"{label}: {len(got)} tokens against {len(want)}")
        if got == want:
            return "equal"
        prompt, gen = ref_api._prompt_ids(b_), gen_of(b_)
        if gen.temperature > 0:
            j, gap, allowed = first_sampled_divergence(dense, prompt, gen, want, got)
        else:
            j, gap, ulp = first_divergence(dense, prompt, want, got)
            allowed = 2 * ulp
        log(f"fleet: {label} first differs at token {j}; gap {gap:.6g} (2 ulps: {allowed:.6g})")
        check(abs(gap) <= allowed, f"{label} differs at token {j} beyond a 2-ulp tie")
        return f"tie at {j}"

    try:
        # (1) eight sessions, two turns each, through the router
        sessions = [f"fleet-{i}" for i in range(len(FLEET_LENS))]
        turn1 = [body([{"role": "user", "content": t}], i) for i, t in enumerate(firsts)]
        before = {k: counter(k) for k in ("router.migrations", "router.role_routed",
                                          "router.affinity_hits", "prefix.hits")}
        with fleet_path():
            got1 = run_router(turn1, sessions)
        wall("turn 1")
        for i, g in enumerate(got1):
            check(not g["errors"] and g["finish"] == "stop" and len(g["ids"]) == 1
                  and g["toks"], f"session {i} turn 1: {g['errors']} {g['finish']}")
        turn2 = [body([{"role": "user", "content": firsts[i]},
                       {"role": "assistant", "content": got1[i]["content"]},
                       {"role": "user", "content": seconds[i]}], i)
                 for i in range(len(firsts))]
        prof: dict = {}

        def profile():
            time.sleep(0.3)  # inside the second wave's decode
            req = urllib.request.Request(base + "/debug/profile", data=b'{"seconds": 1}',
                                         method="POST",
                                         headers={"Content-Type": "application/json"})
            log("fleet: /debug/profile capture starts")
            with urllib.request.urlopen(req, timeout=300) as r:
                prof.update(json.loads(r.read()), status=r.status)
            scratch.append(prof.get("trace_dir"))
            log(f"fleet: /debug/profile answered {prof.get('status')}")

        pt = threading.Thread(target=profile)
        with fleet_path():
            pt.start()
            got2 = run_router(turn2, sessions)
            pt.join()
        wall("turn 2 (profiled)")
        moved = {k: counter(k) - v for k, v in before.items()}
        log(f"fleet: turn 1 (stream s, then handoff s) by session: {[g['s'] for g in got1]}; "
            f"turn 2: {[g['s'] for g in got2]}; migrations (src, dst, s, moved): {moves}; "
            f"inside the /kv handlers: {kv_s}")
        log(f"fleet: two turns x 8 sessions (prompts {FLEET_LENS} ids, {FLEET_NEW} tokens, "
            f"4 greedy, 4 top-p 0.9) on {card}: {json.dumps(moved)}")
        check(moved["router.migrations"] >= 1 and moved["router.role_routed"] > 0,
              f"no prefill -> decode handoff: {moved}")
        check(moved["router.affinity_hits"] >= len(sessions),
              f"second turns lost their affinity: {moved}")
        check(moved["prefix.hits"] >= len(sessions), f"second turns missed the prefix cache: {moved}")

        # the same turns on one scheduler alone
        greedy = body([{"role": "user", "content": fleet_text(rng, 700)}], 0, FLEET_DROP_NEW)
        seeded = body([{"role": "user", "content": fleet_text(rng, 600)}], 1, FLEET_DROP_NEW)
        ref1 = run_ref(turn1)
        ref2 = run_ref(turn2 + [greedy, seeded])
        refs, ref2 = ref2[len(turn2):], ref2[:len(turn2)]
        wall("reference")
        verdicts = []
        for t, (bodies, ref, got) in enumerate(((turn1, ref1, got1), (turn2, ref2, got2))):
            for i in range(len(firsts)):
                mine = tokens("fleet", bodies[i])
                # the frames' ids are the served sequence's, in order
                check(got[i]["toks"] == mine[:len(got[i]["toks"])] and ref[i]["toks"]
                      == tokens("ref", bodies[i])[:len(ref[i]["toks"])],
                      f"session {i} turn {t + 1}: fei ids are not the served tokens")
                verdicts.append(agree(f"session {i} turn {t + 1}", bodies[i],
                                      tokens("ref", bodies[i]), mine))
        log(f"fleet: 16 streams against one scheduler alone: {verdicts}")

        # (2) resurrection: a greedy stream dropped by a (in process), a
        # seeded one by b (its handler dies mid-stream: the socket drops).
        # Both prompts are chunked admissions, so the survivor's replay takes
        # the dead replica's route (a dense admission would replay through
        # chunks: F2's gap); the seeded one reaches b by a session b holds.

        def kill(point):
            # ends b's handler thread at once (quietly: a SystemExit), so the
            # socket closes with no error frame and no [DONE]
            raise SystemExit(point)

        hard_kill = faults._hard_kill
        faults._hard_kill = kill
        try:
            for label, b_, ref, session, arm in (
                    ("greedy, dropped by a", greedy, refs[0], "drop-a",
                     lambda: setattr(a, "after", FLEET_DROP_AFTER)),
                    ("seeded, dropped by b", seeded, refs[1], sessions[1],
                     lambda: FAULTS.arm("replica.crash", "crash", count=FLEET_DROP_AFTER))):
                r0, t0 = counter("router.resurrections"), time.perf_counter()
                arm()
                with fleet_path():
                    got = read_sse(router.stream_chat(dict(b_), {"X-FEI-Session": session}))
                log(f"fleet: {label}: {time.perf_counter() - t0:.2f} s, migrations {moves[-2:]}")
                res = counter("router.resurrections") - r0
                check(res == 1, f"{label}: {res} resurrections")
                check(not got["errors"] and got["finish"] == "stop" and len(got["ids"]) == 1,
                      f"{label}: {got['errors']}")
                check(got["content"] == ref["content"],
                      f"{label}: the client's text is not the uninterrupted stream's")
                # the survivor's sequence (replay included) token for token
                check(tokens("fleet", b_) == tokens("ref", b_),
                      f"{label}: the resurrected tokens are not the uninterrupted stream's")
                log(f"fleet: {label} after {FLEET_DROP_AFTER} frames: resurrected once; the "
                    f"client's {got['frames']} frames and the survivor's "
                    f"{len(tokens('fleet', b_))} tokens bitwise the uninterrupted stream's")
        finally:
            faults._hard_kill = hard_kill
            FAULTS.disarm("replica.crash")
        wall("resurrection")

        # (3) the breaker (a router of its own, so earlier drops charge
        # nothing): three conn faults on a eject it while b serves; after the
        # 1 s cooldown a half-open probe readmits it
        brk = Router([a, b], retries=2, backoff_s=0.05, breaker_fails=3,
                     breaker_cooldown_s=1.0, health_ttl_s=0.0)
        e0, r0 = counter("router.ejections"), counter("router.readmissions")
        f0 = FAULTS.fired("router.forward")
        FAULTS.arm("router.forward", "conn", count=3, match=lambda ctx: ctx.get("replica") == "a")
        with fleet_path():
            for i in range(3):
                g = read_sse(brk.stream_chat(
                    body([{"role": "user", "content": fleet_text(rng, 600)}], 0, 4), {}))
                check(not g["errors"] and g["finish"] == "stop", f"breaker request {i}: {g['errors']}")
        check(FAULTS.fired("router.forward") - f0 == 3 and counter("router.ejections") - e0 == 1
              and not brk._usable("a"), "three conn faults did not eject a")
        time.sleep(1.05)
        check(brk._usable("a") and counter("router.readmissions") - r0 == 1,
              "the half-open probe did not readmit a")
        wall("breaker")

        # (4) a passed deadline: the router answers 504 itself and charges
        # no breaker (every forward sheds 503, the backoff spends the budget)
        d0, e0 = counter("router.deadline_expired"), counter("router.ejections")
        late = Router([a, b], retries=2, backoff_s=10.0, health_ttl_s=1.0)
        FAULTS.arm("router.forward", "http503", count=3)
        res = late.handle("POST", "/v1/chat/completions",
                          body([{"role": "user", "content": "late"}], 0, 4),
                          {"X-FEI-Deadline-S": "0.001"})
        FAULTS.disarm("router.forward")
        check(res[0] == 504 and counter("router.deadline_expired") - d0 == 1,
              f"deadline: {res[:2]}")
        check(counter("router.ejections") == e0
              and {r: late._state[r].fails for r in ("a", "b")} == {"a": 0, "b": 0},
              "the deadline charged a breaker")
        wall("deadline")

        # (5) a cold session on b whose prefix only a holds pulls it by hash
        cold = body([{"role": "user", "content": fleet_text(rng, 250)}], 0, 4)
        status, _, _ = a.request("POST", "/v1/chat/completions", dict(cold), {})
        check(status == 200, f"a answered {status}")
        h0, t0 = counter("kv.prefix_hits_remote"), counter("kv.prefix_hits_tier")
        with fleet_path():
            g = read_sse(router.stream_chat(dict(cold), {"X-FEI-Session": "cold"}))
        check(not g["errors"] and counter("kv.prefix_hits_remote") - h0 >= 1
              and counter("kv.prefix_hits_tier") - t0 >= 1,
              "the cold session did not pull its prefix off a")
        wall("prefix fetch")

        # (6) observability over b's HTTP server
        with urllib.request.urlopen(base + "/v1/traces?limit=1000", timeout=60) as r:
            traces = json.loads(r.read())["data"]
        mine = [t for t in traces if t["spans"] and t["spans"][0]["ts"] >= t_epoch]
        for t in mine:
            phases = [s["phase"] for s in t["spans"]]
            ts = [s["ts"] for s in t["spans"]]
            check(ts == sorted(ts) and phases[0] == "queued", f"trace {t['id']}: {phases}")
            check(t["status"] == "active" or phases[-1] == t["status"],
                  f"trace {t['id']} ends {phases[-1]} with status {t['status']}")
        done = [t for t in mine if t["status"] == "completed"]
        check(len(done) >= 2 * len(FLEET_LENS), f"{len(done)} completed traces in the phase")
        order = ("queued", "admitted", "prefill", "first_token", "completed")
        plain = [t for t in done if [s["phase"] for s in t["spans"]] == list(order)]
        check(plain, "no trace with the plain lifecycle")
        with urllib.request.urlopen(f"{base}/v1/traces/{plain[0]['id']}", timeout=60) as r:
            one = json.loads(r.read())
        check(one["flight"] and one["id"] == plain[0]["id"], "a trace without its flight slice")
        with urllib.request.urlopen(base + "/debug/timeline", timeout=60) as r:
            timeline = json.loads(r.read())
        names = {e["name"] for e in timeline["traceEvents"]}
        check({"dispatch.step.issue", "dispatch.step.sync"} <= names,
              f"the timeline lacks the paged dispatches: {sorted(names)[:20]}")
        check(prof.get("status") == 200 and prof.get("object") == "profile", f"profile: {prof}")
        with open(Path(prof["trace_dir"]) / "trace.json") as f:
            kernels = {e.get("name", "") for e in json.load(f).get("traceEvents", [])
                       if e.get("cat") == "kernel"}
        paged_k = sorted(k for k in kernels if "paged_attn" in k)
        check(paged_k, f"the profile names no K2/K3 kernel: {sorted(kernels)[:10]}")
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            check(r.status == 200 and b"fei_router_requests_total" in r.read(), "/metrics")
        snap = METRICS.snapshot()
        undeclared = [n for sec in ("counters", "gauges", "spans", "histograms")
                      for n in snap[sec] if help_for(n) is None]
        check(not undeclared, f"/metrics lists undeclared names: {undeclared}")
        frac = snap["gauges"].get("roofline.frac", 0.0)
        check(0 < frac <= 1.05, f"roofline.frac {frac} against {costmodel.hbm_gbps()} GB/s")
        check(grew("engine.recompiles") == 0, f"{grew('engine.recompiles')} recompiles")
        log(f"fleet: observability: {len(mine)} traces of the phase (ordered), timeline "
            f"{len(timeline['traceEvents'])} events, profile {prof['trace_dir']} names "
            f"{paged_k[:2]}, roofline.frac {frac} (tok_s_per_chip "
            f"{snap['gauges'].get('roofline.tok_s_per_chip')}) against {costmodel.hbm_gbps()} "
            f"GB/s, engine.recompiles +0, engine.compiles {snap['counters'].get('engine.compiles')}")
        wall("observability")

        # (7) a rolling restart under four live streams, over in-process
        # replicas (an HTTP replica restarts through its supervisor)
        restored: list = []

        def factory(first, role):
            state = {"api": first, "made": False}

            def make():
                if state["made"]:
                    eng = engine()
                    engines.append(eng)
                    warm = eng.warm_restart

                    def capture(d=None):
                        seqs = warm(d)
                        restored.extend(seqs)
                        return seqs

                    eng.warm_restart = capture
                    old = state["api"].provider.engine
                    state["api"] = api(eng, role)
                    old.close()
                state["made"] = True
                return state["api"]
            return make

        tmp = tempfile.mkdtemp(prefix="fleet-drain-")
        scratch.append(tmp)
        # b first: the live (short) streams run there, so its drain strands them
        rr = Router([InProcessReplica("b", factory=factory(b_api, "decode-heavy"),
                                      drain_dir=f"{tmp}/b"),
                     InProcessReplica("a", factory=factory(a_api, "prefill-heavy"),
                                      drain_dir=f"{tmp}/a")],
                    retries=2, backoff_s=0.05, health_ttl_s=0.0)
        rr.prewarm_k = 1
        rr_s: dict = {}

        def timed(name, fn):
            def run(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    rr_s[name] = round(rr_s.get(name, 0.0) + time.perf_counter() - t0, 3)
            return run

        rr.prewarm = timed("prewarm", rr.prewarm)
        for rep_ in rr.replicas.values():
            rep_.restart = timed(f"restart {rep_.rid}", rep_.restart)
            rep_.wait_drained = timed(f"drain {rep_.rid}", rep_.wait_drained)
        live = [body([{"role": "user", "content": fleet_text(rng, n)}], i)
                for i, n in enumerate((96, 160, 200, 250))]
        live_ref = run_ref(live)
        started = [threading.Event() for _ in live]
        outs: list = [None] * len(live)

        def stream_live(i):
            frames = []
            for f in rr.stream_chat(dict(live[i]), {}):
                frames.append(f)
                if b'"content"' in f:
                    started[i].set()
            started[i].set()
            outs[i] = read_sse(frames)

        with fleet_path():
            ts = [threading.Thread(target=stream_live, args=(i,)) for i in range(len(live))]
            [t.start() for t in ts]
            for e in started:
                e.wait(120)
            report = rr.rolling_restart(drain_deadline_s=0.2, wait_s=120)
            [t.join() for t in ts]
            deadline = time.monotonic() + 120
            # the terminal status is set after ``finished``: wait for it
            while any(s.status is None for s in restored) and time.monotonic() < deadline:
                time.sleep(0.05)
        check(all(r["healthy"] for r in report.values()), f"rolling restart: {report}")
        finished = restored_ok = 0
        for i, (out, ref) in enumerate(zip(outs, live_ref)):
            if out["finish"] == "stop" and not out["errors"]:
                agree(f"live stream {i}", live[i], tokens("ref", live[i]),
                      tokens("fleet", live[i]))
                finished += 1
                continue
            check(any("snapshotted" in e.get("message", "") for e in out["errors"]),
                  f"live stream {i} lost: {out['errors']}")
            ids = ref_api._prompt_ids(live[i])
            seq = next((s for s in restored if s.prompt_ids == ids), None)
            check(seq is not None and seq.status == "completed",
                  f"live stream {i} was snapshotted but not restored to completion: "
                  f"{None if seq is None else (seq.finished, seq.status)}, "
                  f"{len(restored)} restored")
            agree(f"restored stream {i}", live[i], tokens("ref", live[i]), list(seq.generated))
            restored_ok += 1
        check(finished + restored_ok == len(live) and restored_ok >= 1,
              f"live streams: {finished} finished, {restored_ok} restored of {len(live)}")
        log(f"fleet: rolling restart (drain deadline 0.2 s) under 4 live streams: {report}; "
            f"seconds {rr_s}; "
            f"{finished} finished in place, {restored_ok} snapshotted and restored bitwise")
        wall("rolling restart")
    finally:
        server.stop()
        for eng in engines:
            eng.close()
        for d in scratch:
            if d:
                shutil.rmtree(d, ignore_errors=True)
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        gc.collect()
        torch.cuda.empty_cache()
    log(f"fleet: phase took {time.perf_counter() - t_phase:.1f} s on {card}; wall seconds "
        f"{json.dumps(walls)}; counters {json.dumps({k: grew(k) for k in ('router.requests', 'router.migrations', 'router.role_routed', 'router.affinity_hits', 'router.resurrections', 'router.ejections', 'router.readmissions', 'router.deadline_expired', 'kv.prefix_hits_remote', 'router.prewarm_pushes', 'router.rolling_restarts')})}; "
        f"launches {launched}")
    return launched


def serve_rates(card: str) -> None:
    """Dense decode tok/s and paged aggregate tok/s of the tree this file
    runs from (a copy run from an older tree's root measures that tree):
    the engine phase's prompt and 128 greedy tokens (chunk 16), twice, then
    eight requests of 128 tokens after a warm-up, once straight into the
    scheduler (the paged phase's traffic) and once through
    ``ServeAPI.stream_chat``, the SSE path a served stream takes (from this
    tree on it exports every token's id and key). Uses only what every tree
    since the paged path has."""
    import fei_tpu_torch
    from fei_tpu_torch.agent.providers import TorchLocalProvider
    from fei_tpu_torch.engine import GenerationConfig, InferenceEngine
    from fei_tpu_torch.ui.server import ServeAPI

    engine = InferenceEngine.from_config("llama3-8b", dtype=torch.bfloat16, seed=SEED,
                                         max_seq_len=8192, device="cuda")
    cfg = engine.cfg
    prompt = np.random.default_rng(SEED).integers(8, cfg.vocab_size, size=1500).tolist()
    engine.generate(prompt, GenerationConfig(max_new_tokens=16, ignore_eos=True, chunk=16))
    gen = GenerationConfig(max_new_tokens=128, ignore_eos=True, chunk=16)
    dense = [engine.generate(prompt, gen).decode_tokens_per_s for _ in range(2)]
    paged = InferenceEngine.from_config(
        "llama3-8b", dtype=torch.bfloat16, params=engine.params, max_seq_len=8192,
        device="cuda", paged=True, batch_size=8, page_size=PAGE)
    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(8, cfg.vocab_size, size=n).tolist() for n in SHORT_LENS + LONG_LENS]
    traffic(paged, prompts, 16)
    agg = len(prompts) * NEW_TOKENS / traffic(paged, prompts, NEW_TOKENS)["wall"]
    api = ServeAPI(TorchLocalProvider(engine=paged), model_name=cfg.name)
    bodies = [{"messages": [{"role": "user", "content": fleet_text(rng, n)}],
               "max_tokens": NEW_TOKENS, "ignore_eos": True, "temperature": 0}
              for n in SHORT_LENS + LONG_LENS]
    frames, errors = [0] * len(bodies), []

    def sse(i):
        try:
            for f in api.stream_chat(dict(bodies[i]), api._parse_request(dict(bodies[i]), {})):
                frames[i] += f.startswith(b"data: {")
                if f.startswith(b'data: {"error"'):
                    errors.append(f"SSE stream {i}: {f[:200]!r}")
        except BaseException as exc:  # noqa: BLE001 — checked below
            errors.append(f"SSE stream {i}: {exc!r}")

    t0 = time.perf_counter()
    ts = [threading.Thread(target=sse, args=(i,)) for i in range(len(bodies))]
    [t.start() for t in ts]
    [t.join() for t in ts]
    check(not errors, f"{errors}")
    sse_agg = len(bodies) * NEW_TOKENS / (time.perf_counter() - t0)
    paged.close()
    log(f"serve rates of {Path(fei_tpu_torch.__file__).parent.parent} on {card}: dense decode "
        f"{dense[0]:.3f}, {dense[1]:.3f} tok/s (1500-token prompt, 128 tokens); paged "
        f"aggregate {agg:.3f} tok/s into the scheduler, {sse_agg:.3f} tok/s through the SSE "
        f"path ({sum(frames)} frames) (8 x {NEW_TOKENS})")


# ------------------------------------------------------ quantized weights

QUANT_LENS = (96, 250, 700, 1500)  # two dense admissions, two chunked
QUANT_NEW = 64


def quant_dense_phase(card: str, bf16_bytes: int):
    """llama3-8b at full width, SERVE_LAYERS deep, with int4 weights (K4 in
    every big linear), then with int8 weights. Returns the int4 engine."""
    from fei_tpu_torch.engine import GenerationConfig, InferenceEngine
    from fei_tpu_torch.ops.quant import QTensor4, dequantize_params, param_bytes

    t0 = time.perf_counter()
    eng = InferenceEngine.from_config(
        "llama3-8b", dtype=torch.bfloat16, seed=SEED, max_seq_len=8192, device="cuda",
        quantize="int4", num_layers=SERVE_LAYERS)
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
        "llama3-8b", dtype=torch.bfloat16, max_seq_len=8192, device="cuda", num_layers=L,
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
    # and 16 layers of such perturbations stay within a few percent of the
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
        quantize="int8", num_layers=L)
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


QUANT_SWITCH_NEW = 64  # greedy tokens of the int4-head engine and its dequantized twin


def quant_switches_phase(dense4, card: str) -> dict:
    """The JAX package's two quantization switches as ``from_config`` reads
    them: an int4 engine built with ``FEI_TPU_INT4_LM_HEAD=1`` and
    ``FEI_TPU_QUANT_EMBED=1`` in the environment (no argument passed) holds
    an int4 ``QTensor4`` LM head and an int8 ``QTensor`` embedding, and its
    layers are ``dense4``'s draws. Its prefill launches K4 once more than
    seven times a layer (the head on the last row) and every decode step
    likewise; its logits and greedy stream are held against the same
    weights dequantized to bf16 (rel_l2 3e-2; the streams equal or first
    apart at a tie within 2 bf16 ulps, F1). Then its whole tree goes
    through ``engine.weights.save_checkpoint`` / ``restore_checkpoint`` on
    the card and comes back bitwise. Returns the K4 launches of its
    generate (prefill and decode) and the steps they cover."""
    from fei_tpu_torch.engine import GenerationConfig, InferenceEngine
    from fei_tpu_torch.engine.weights import restore_checkpoint, save_checkpoint
    from fei_tpu_torch.ops.quant import QTensor, QTensor4, dequantize_params, param_bytes

    t0 = time.perf_counter()
    with env_vars(FEI_TPU_INT4_LM_HEAD="1", FEI_TPU_QUANT_EMBED="1"):
        eng = InferenceEngine.from_config(
            "llama3-8b", dtype=torch.bfloat16, seed=SEED, max_seq_len=8192, device="cuda",
            quantize="int4", num_layers=SERVE_LAYERS)
    torch.cuda.synchronize()
    cfg, L = eng.cfg, eng.cfg.num_layers
    head, embed = eng.params["lm_head"], eng.params["embed"]
    nbytes = param_bytes(eng.params)
    log(f"int4 engine, FEI_TPU_INT4_LM_HEAD=1 FEI_TPU_QUANT_EMBED=1: lm_head "
        f"{type(head).__name__} {tuple(head.p.shape) if isinstance(head, QTensor4) else ''}, "
        f"embed {type(embed).__name__}; param_bytes {nbytes / 1e9:.6f} GB against "
        f"{param_bytes(dense4.params) / 1e9:.6f} GB with both off; weights a decode step reads "
        f"{weight_stream_bytes(eng.params) / 1e9:.6f} GB; random init in "
        f"{time.perf_counter() - t0:.1f} s")
    check(isinstance(head, QTensor4), f"FEI_TPU_INT4_LM_HEAD=1 left the LM head {type(head)}")
    check(isinstance(embed, QTensor), f"FEI_TPU_QUANT_EMBED=1 left the embedding {type(embed)}")
    check(torch.equal(eng.params["layers"]["w_down"].p, dense4.params["layers"]["w_down"].p),
          "the switches changed the layers' draws")
    check(nbytes < param_bytes(dense4.params), "the switches did not shrink param_bytes")
    prompt = np.random.default_rng(SEED).integers(8, cfg.vocab_size, size=1500).tolist()

    # this engine's path: every count from 0
    reset_counts()
    logits, _ = eng.prefill([prompt], eng.new_cache(1))
    torch.cuda.synchronize()
    prefill_k4 = read_counts()["int4_matmul"]
    check(prefill_k4 == 7 * L + 1, f"the int4-head prefill launched int4_matmul {prefill_k4} "
          f"times, expected {7 * L + 1} (7 linears x {L} layers + the head)")
    check(torch.isfinite(logits).all().item(), "int4-head prefill logits not finite")
    gen = GenerationConfig(max_new_tokens=QUANT_SWITCH_NEW, ignore_eos=True, chunk=16)
    reset_counts()
    d0 = counter("engine.decode_dispatches")
    res = eng.generate(prompt, gen)
    launches = read_counts()["int4_matmul"]
    steps = int(counter("engine.decode_dispatches") - d0) * gen.chunk
    check(launches == (7 * L + 1) * (1 + steps),
          f"the int4-head generate launched int4_matmul {launches} times, expected "
          f"{(7 * L + 1) * (1 + steps)} ((7 x {L} + 1) x (the prefill + {steps} decode steps))")
    check(len(res.token_ids) == QUANT_SWITCH_NEW, "int4-head engine: wrong token count")
    log(f"int4 engine, int4 LM head: {len(prompt)}-token prompt, {QUANT_SWITCH_NEW} greedy "
        f"tokens on {card}: TTFT {res.ttft_s * 1e3:.1f} ms, decode "
        f"{res.decode_tokens_per_s:.2f} tok/s; int4_matmul launches {launches} = "
        f"(7 x {L} + 1) x {1 + steps} forwards (the head's {1 + steps} beside the linears' "
        f"{7 * L * (1 + steps)})")

    deq = InferenceEngine.from_config(
        "llama3-8b", dtype=torch.bfloat16, max_seq_len=8192, device="cuda", num_layers=L,
        params=dequantize_params(eng.params, torch.bfloat16, only=(QTensor4,)))
    reset_counts()
    plain, _ = deq.prefill([prompt], deq.new_cache(1))
    want = deq.generate(prompt, gen).token_ids
    check(read_counts()["int4_matmul"] == 0, "the dequantized engine launched int4_matmul")
    rel = ((logits - plain).norm() / plain.norm()).item()
    log(f"int4 engine, int4 LM head: last-position prefill logits vs the dequantized weights: "
        f"max_abs_diff={(logits - plain).abs().max().item():.6g}, rel_l2={rel:.6g} (tol 3e-2), "
        f"argmax {int(logits.argmax())} vs {int(plain.argmax())}")
    check(rel <= 3e-2, f"int4-head vs dequantized prefill logits rel_l2 {rel} > 3e-2")
    if want == res.token_ids:
        log(f"int4 engine, int4 LM head: {QUANT_SWITCH_NEW} greedy tokens equal the "
            f"dequantized weights'")
    else:
        j, gap, ulp = first_divergence(deq, prompt, want, res.token_ids)
        log(f"int4 engine, int4 LM head: the stream first differs from the dequantized "
            f"weights' at token {j}; their logit gap there {gap:.6g} ({gap / ulp:.3g} bf16 ulps)")
        check(abs(gap) <= 2 * ulp, f"the int4-head stream leaves the dequantized one at token "
              f"{j} with a logit gap of {gap / ulp:.3g} bf16 ulps, not a tie")
    del deq, plain
    torch.cuda.empty_cache()

    # the engine-native weight checkpoint of this tree, on the card
    tmp = tempfile.mkdtemp(prefix="fei_weights_")
    try:
        path = str(Path(tmp) / "int4")
        t0 = time.perf_counter()
        save_checkpoint(eng.params, path)
        t_save = time.perf_counter() - t0
        on_disk = sum(f.stat().st_size for f in Path(path).iterdir())
        t0 = time.perf_counter()
        back = restore_checkpoint(path)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0

        def fields(tree, prefix=""):
            for k, v in tree.items():
                if isinstance(v, dict):
                    yield from fields(v, f"{prefix}{k}/")
                elif isinstance(v, tuple):
                    for f in v._fields:
                        yield f"{prefix}{k}.{f}", type(v), getattr(v, f)
                else:
                    yield f"{prefix}{k}", type(v), v

        got = {name: (kind, t) for name, kind, t in fields(back)}
        mine = list(fields(eng.params))
        check(set(got) == {name for name, _, _ in mine}, "the restored tree has other leaves")
        for name, kind, t in mine:
            k2, t2 = got[name]
            check(k2 is kind and t2.is_cuda and t2.dtype == t.dtype and torch.equal(t2, t),
                  f"weights round trip: {name} did not come back bitwise as a {kind.__name__}")
        log(f"weights: save_checkpoint / restore_checkpoint of the int4-head tree "
            f"({len(mine)} tensors, {on_disk / 1e9:.6f} GB on disk) on {card}: save "
            f"{t_save:.2f} s, restore to the card {t_restore:.2f} s; every tensor bitwise, "
            f"lm_head a QTensor4 and embed a QTensor again")
        del back, got
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del eng
    torch.cuda.empty_cache()
    return {"int4_matmul": launches, "forwards": 1 + steps, "prefill": prefill_k4}


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
            device="cuda", paged=True, batch_size=8, page_size=PAGE,
            num_layers=cfg.num_layers, **kw)

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
    # the provider's engine has all 32 layers; wq is drawn first, layer by
    # layer, so its first layers are the cut engine's
    L = dense4.cfg.num_layers
    check(torch.equal(engine.params["layers"]["wq"].p[:L], dense4.params["layers"]["wq"].p),
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


# ------------------------------------------------------------- speculation

SPEC_TOKENS = 128
SPEC_PAGED_SEQ = 4096  # the speculating scheduler's rows: one stream at a time
SPEC_TOOLS = [{
    "name": "LS", "description": "List a directory.",
    "input_schema": {"type": "object", "properties": {"path": {"type": "string"}},
                     "required": ["path"]},
}]


def spec_prompt(tokenizer) -> list[int]:
    """About 1000 byte ids: one block of code repeated."""
    block = ("def merge(a, b):\n    out = []\n    while a and b:\n"
             "        out.append(a.pop(0) if a[0] < b[0] else b.pop(0))\n"
             "    return out + a + b\n\n")
    return tokenizer.encode((block * (1000 // len(block) + 1))[:1000], add_bos=True)


def span_count(name: str) -> int:
    from fei_tpu_torch.utils.metrics import METRICS

    return METRICS.snapshot()["spans"].get(name, {}).get("count", 0)


def spec_phase(dense, card: str) -> dict:
    """Prompt-lookup speculation on the card (bf16 llama3-8b, the serve
    phase's LM head): the dense lookahead against plain greedy decode, the
    paged scheduler with ``FEI_TPU_SPECULATE=1`` against its own
    unspeculated stream (natural drafts, then the model's own continuation
    as the draft), and a tool-call turn that speculates in its free phase.
    Returns the kernel launches of the speculated runs, each counted from 0
    just before it (the plain references are not counted)."""
    from fei_tpu_torch.engine import GenerationConfig, InferenceEngine
    from fei_tpu_torch.engine.grammar import (
        TriggerScanner,
        char_walk,
        compile_agent_tool_grammar,
    )

    launched = dict.fromkeys(read_counts(), 0)

    def add(counts):
        for k, v in counts.items():
            launched[k] += v

    L = dense.cfg.num_layers
    prompt = spec_prompt(dense.tokenizer)
    gen = GenerationConfig(max_new_tokens=SPEC_TOKENS, ignore_eos=True)

    # dense: plain greedy (fused chunks of 16), then the lookahead
    plain = dense.generate(prompt, gen)
    s0, d0 = span_count("spec_step"), span_count("decode_step")
    reset_counts()
    spec = dense.generate_lookahead(prompt, gen)
    add(read_counts())
    steps, singles = span_count("spec_step") - s0, span_count("decode_step") - d0
    check(len(spec.token_ids) == SPEC_TOKENS, f"lookahead decoded {len(spec.token_ids)} tokens")
    verdict = same_or_tie(dense, prompt, plain.token_ids, spec.token_ids, "spec dense")
    # tokens after the prefill's first one, over the dispatches that made them
    after = SPEC_TOKENS - 1
    log(f"spec dense: {len(prompt)}-token repeated code block, {SPEC_TOKENS} greedy tokens on "
        f"{card}: lookahead {verdict} to plain greedy; {steps} verify blocks (T = 9) and "
        f"{singles} single steps, {after - singles - steps} draft tokens accepted, "
        f"{after / max(1, steps + singles):.2f} tokens per dispatch; decode "
        f"{spec.decode_tokens_per_s:.2f} tok/s speculated vs {plain.decode_tokens_per_s:.2f} "
        f"tok/s plain (fused chunks of 16)")

    # paged: one stream through a scheduler built with FEI_TPU_SPECULATE=1
    with env_vars(FEI_TPU_SPECULATE="1"):
        eng = InferenceEngine.from_config(
            dense.cfg.name, dtype=dense.dtype, params=dense.params, max_seq_len=SPEC_PAGED_SEQ,
            device=dense.device, paged=True, batch_size=2, page_size=PAGE,
            num_layers=dense.cfg.num_layers)
    sched = eng.scheduler
    check(sched.speculate and sched.spec_ngram == 3 and sched.spec_draft_len == 8,
          "the scheduler did not read FEI_TPU_SPECULATE / FEI_TPU_SPEC_* with their defaults")
    sched.speculate = False
    t0 = time.perf_counter()
    want = list(sched.stream(prompt, gen))
    plain_s = time.perf_counter() - t0
    sched.speculate = True
    dis0 = counter("scheduler.spec_disabled")

    def spec_run(label, drafts=None):
        if drafts is not None:
            eng._find_draft = drafts
        s0, a0 = counter("scheduler.spec_steps"), counter("scheduler.spec_accepted")
        reset_counts()
        t0 = time.perf_counter()
        got = list(sched.stream(prompt, gen))
        wall = time.perf_counter() - t0
        counts = read_counts()
        add(counts)
        eng.__dict__.pop("_find_draft", None)
        n_steps = int(counter("scheduler.spec_steps") - s0)
        n_acc = int(counter("scheduler.spec_accepted") - a0)
        check(counts["paged_attention_block"] >= n_steps * L,
              f"{label}: {n_steps} verify steps but {counts['paged_attention_block']} launches "
              f"of K2's block form")
        v = same_or_tie(dense, prompt, want, got, f"spec paged {label}")
        log(f"spec paged ({label}): {v} to the unspeculated stream; {n_steps} verify steps, "
            f"{n_acc} draft tokens accepted, {(n_acc + n_steps) / max(1, n_steps):.2f} tokens "
            f"per verify; {len(got)} tokens in {wall:.3f} s ({len(got) / wall:.2f} tok/s; "
            f"unspeculated {len(want) / plain_s:.2f} tok/s); launches {counts}")
        return got, n_steps, n_acc

    oracle, nat_steps, _ = spec_run("natural drafts")
    n = len(prompt)
    # the model's own continuation as the draft: the previous speculated
    # stream, so that a verify reproduces it (the unspeculated stream may
    # part from it at a tie, after which it is not the model's continuation)
    for rnd in range(1, 4):
        oracle, o_steps, o_acc = spec_run(
            f"oracle drafts, round {rnd}",
            lambda ids, ng, dl, prev=oracle: list(prev[len(ids) - n:len(ids) - n + dl]) or None)
        if o_steps and (o_acc + o_steps) / o_steps > 2:
            break
    check(nat_steps + o_steps > 0, "the paged scheduler never speculated")
    check(o_steps > 0 and (o_acc + o_steps) / o_steps > 2,
          f"oracle drafts gave {(o_acc + o_steps) / max(1, o_steps):.2f} tokens per verify (<= 2)")

    # a tool-call turn whose trigger the model reaches inside a verified
    # block: the rest of the block is dropped and the DFA takes over
    g = compile_agent_tool_grammar(SPEC_TOOLS, eng.tokenizer)

    def completes_at(text: str, k: int) -> bool:
        """The scheduler's trigger scan finds ``text`` first at token k."""
        scan = TriggerScanner(eng.tokenizer, text)
        return [scan.feed(t) is not None for t in oracle[:k]].index(True) == k - 1

    trigger = next((t for k in range(3, 40) if (t := eng.tokenizer.decode(oracle[:k]))
                    and completes_at(t, k)), None)
    check(trigger is not None, "no trigger text completes in the model's first 40 tokens")
    eng._find_draft = lambda ids, ng, dl: list(oracle[len(ids) - n:len(ids) - n + dl]) or None
    s0 = counter("scheduler.spec_steps")
    reset_counts()
    toks = list(eng.generate_stream_toolcalls(
        prompt, GenerationConfig(max_new_tokens=96, ignore_eos=True), grammar=g,
        trigger=trigger))
    add(read_counts())
    del eng._find_draft
    text = eng.tokenizer.decode(toks)
    call = text.split(trigger, 1)[1] if trigger in text else ""
    check(call.endswith("</tool_call>"), f"the speculated tool turn made no call: {text[-80:]!r}")
    payload = call[: -len("</tool_call>")]
    check(json.loads(payload)["name"] == "LS" and char_walk(g, payload) == g.accept,
          f"the speculated tool call is not valid: {payload!r}")
    tool_steps = int(counter("scheduler.spec_steps") - s0)
    check(tool_steps > 0, "the tool turn's free phase did not speculate")
    check(counter("scheduler.spec_disabled") == dis0, "speculation was disabled")
    log(f"spec tool turn: trigger {trigger!r} reached inside a verified block ({tool_steps} "
        f"verify steps), then the grammar: valid call {payload!r}")
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return launched


# --------------------------------------------------------------------- MoE

MOE_PROMPT = 1500
MOE_LENS = (96, 200, 700, 1500)  # two dense admissions, two chunked
MOE_NEW = 32  # tokens of the dense engine's timed decode
# tokens a stream of the paged traffic and of the dense streams it is held
# to: every sound and mutant stream first left the dense engine's by token
# 8 in every recorded run, so 16 keeps each split the F1 rule reads
MOE_PAGED_NEW = 16
MOE_SEQ = 4096
MOE_LAYER_TOL = 1e-2
MOE_TOL = 0.25
MOE_GAP_ULPS = 2.0  # a paged stream's first split from the dense engine's (F1)
MOE_TRAIN_TOKENS = 2049


def moe_decode_bounds(cfg, params) -> tuple[float, float]:
    """Batch-1 decode tok/s at the memory peak: one read of every weight a
    step streams (the dense formulation reads every expert), and the same
    with only the top-k experts of each layer read."""
    from fei_tpu_torch.ops.quant import param_bytes

    every = weight_stream_bytes(params)
    experts = sum(param_bytes(params["layers"][k]) for k in ("w_gate", "w_up", "w_down"))
    topk = every - experts + experts * cfg.num_experts_per_tok / cfg.num_experts
    return PEAK_BYTES_PER_S / every, PEAK_BYTES_PER_S / topk


def stepped_divergence(dense, prompt, want, got) -> tuple[int, float, bool]:
    """Where two streams first part, read by the dense engine as it decoded
    ``want``: its prefill of the prompt (the form the engine's prefill
    takes), then one T=1 forward a token of ``want`` with
    ``routed_moe=True`` (under ``_ROUTED_MIN_TOKENS``, the oracle), as its
    fused decode steps. Returns (position j, logit(want[j]) - logit(got[j])
    in bf16 ulps of the larger, whether the read's argmax reproduces
    ``want[:j + 1]``: that the witness is the dense stream itself)."""
    from fei_tpu_torch.models.llama import forward

    j = next(i for i, (a, b) in enumerate(zip(want, got)) if a != b)
    logits, cache = dense.prefill([list(prompt)], dense.new_cache(1))
    rows = [logits[0]]
    live = torch.ones(1, dtype=torch.bool, device=dense.device)
    for t in want[:j]:
        tok = torch.tensor([[t]], dtype=torch.int32, device=dense.device)
        out, cache = forward(dense.params, dense.cfg, tok, cache, live=live, routed_moe=True)
        rows.append(out[0, -1])
    rows = torch.stack(rows)
    pair = rows[j, [want[j], got[j]]]
    _, exp = torch.frexp(pair.abs().max())
    gap = (pair[0] - pair[1]).item() / 2.0 ** (exp.item() - 8)
    return j, gap, rows.argmax(-1).tolist() == list(want[:j + 1])


def drop_second_expert(route):
    """A mutant router: each token's second expert gets weight 0."""
    def mutant(logits, k):
        w, idx = route(logits, k)
        keep = torch.zeros(k, dtype=w.dtype, device=w.device)
        keep[0] = 1.0
        return w * keep, idx

    return mutant


def moe_phase(card: str) -> dict:
    """mixtral-8x7b at full width and depth on the card: int8 weights
    (``moe_int8``), one int4 prefill (``moe_int4``), a training step on two
    layers at Mixtral's widths (``moe_train``), each part's tensors freed
    before the next. Returns the kernel launches of the MoE path's runs,
    each counted from 0 just before it (the oracle, the mutant, the repeat,
    the dense references and the plain-attention gradients are not
    counted)."""
    launched = dict.fromkeys(read_counts(), 0)

    def add(counts):
        for k, v in counts.items():
            launched[k] += v

    for part in (moe_int8, moe_int4, moe_train):
        part(card, add)
        gc.collect()
        torch.cuda.empty_cache()
    return launched


def moe_int8(card: str, add) -> None:
    """int8 mixtral-8x7b: routed prefill against the dense oracle per layer
    and at the logits, a mutant, two runs bitwise, dense decode, the paged
    engine against the dense engine. ``add`` takes each run's launches."""
    from fei_tpu_torch.engine import GenerationConfig, InferenceEngine
    from fei_tpu_torch.models import llama
    from fei_tpu_torch.ops import moe
    from fei_tpu_torch.ops.quant import QTensor, param_bytes

    t0 = time.perf_counter()
    eng = InferenceEngine.from_config("mixtral-8x7b", dtype=torch.bfloat16, seed=SEED,
                                      max_seq_len=MOE_SEQ, device="cuda", quantize="int8")
    torch.cuda.synchronize()
    cfg, L = eng.cfg, eng.cfg.num_layers
    nbytes = param_bytes(eng.params)
    bf16 = 2 * cfg.num_params()
    log(f"moe: {cfg.name} L={L} h={cfg.hidden_size} I={cfg.intermediate_size} "
        f"E={cfg.num_experts} top-{cfg.num_experts_per_tok} V={cfg.vocab_size}, int8: "
        f"param_bytes {nbytes / 1e9:.3f} GB (bf16 {bf16 / 1e9:.3f} GB, past the card's "
        f"80); random init in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    check(40e9 < nbytes < 50e9, f"mixtral int8 param_bytes {nbytes}")
    check(isinstance(eng.params["layers"]["w_up"], QTensor), "the experts are not int8")
    prompt, prompts = moe_prompts(cfg)

    def prefill():
        logits, _ = eng.prefill([prompt], eng.new_cache(1))
        torch.cuda.synchronize()
        return logits

    # the MoE path starts here: the routed prefill, every kernel count from 0;
    # each layer's MoE input and output are kept for the per-layer checks
    routed_io, oracle_in = [], []
    real_moe = llama._moe

    def keep(store, with_out):
        def spy(cfg_, y, lp, allow_routed, moe_mesh=None):
            out = real_moe(cfg_, y, lp, allow_routed, moe_mesh)
            store.append((y, out) if with_out else y)
            return out
        return spy

    routed_calls = []
    real_routed = llama.moe_mlp_routed
    llama.moe_mlp_routed = lambda *a: routed_calls.append(1) or real_routed(*a)
    llama._moe = keep(routed_io, True)
    try:
        reset_counts()
        logits = prefill()
        counts = read_counts()
        add(counts)
    finally:
        llama.moe_mlp_routed = real_routed
        llama._moe = real_moe
    check(counts["flash_attention_fwd"] == L, f"MoE prefill launches {counts} (K1 once a layer)")
    check(len(routed_calls) == L, f"{len(routed_calls)} of {L} layers routed the prefill")
    check(torch.isfinite(logits).all().item() and tuple(logits.shape) == (1, cfg.vocab_size),
          "MoE prefill logits not finite or of the wrong shape")
    t0 = time.perf_counter()
    again = prefill()
    t_routed = time.perf_counter() - t0
    check(torch.equal(again, logits), "two routed prefills are not bitwise equal")
    with env_vars(FEI_TPU_ROUTED_MOE="0"):
        prefill()
        t0 = time.perf_counter()
        llama._moe = keep(oracle_in, False)
        try:
            oracle = prefill()
        finally:
            llama._moe = real_moe
        t_dense = time.perf_counter() - t0
    real_route = moe._route
    moe._route = drop_second_expert(real_route)
    try:
        mutant = prefill()
    finally:
        moe._route = real_route

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    # per layer, on the same input: the routed form against the oracle, and
    # the mutant against the oracle. Tolerance: the two forms pick the same
    # experts (one fp32 router product) and differ by bf16 roundings of the
    # weighted expert outputs and their sum, ~2^-8 of the output; 1e-2
    # leaves room for the per-expert products' other summation order
    layer_rel, layer_mut, flips = [], [], []
    k = cfg.num_experts_per_tok
    for i, ((y, out), y_oracle) in enumerate(zip(routed_io, oracle_in)):
        lp = llama.layer_params(eng.params, i)
        args = (lp["router"], lp["w_gate"], lp["w_up"], lp["w_down"], k)
        want = moe.moe_mlp(y, *args)
        layer_rel.append(rel(out, want))
        moe._route = drop_second_expert(real_route)
        try:
            layer_mut.append(rel(moe.moe_mlp_routed(y, *args), want))
        finally:
            moe._route = real_route
        # tokens whose expert pair differs between the two runs' inputs
        pick = [moe._route(t.reshape(-1, t.shape[-1]).float() @ lp["router"].float(), k)[1]
                .sort(dim=-1).values for t in (y, y_oracle)]
        flips.append(int((pick[0] != pick[1]).any(dim=-1).sum()))
    del routed_io, oracle_in
    log(f"moe: per layer on the same input, routed vs the dense oracle: worst rel_l2 "
        f"{max(layer_rel):.4g} (tol {MOE_LAYER_TOL}); the dropped-expert mutant: least rel_l2 "
        f"{min(layer_mut):.4g}; tokens whose expert pair differs between the routed and the "
        f"oracle run's inputs, by layer: {flips} (of {len(prompt)} real and "
        f"{2048 - len(prompt)} pad rows)")
    check(max(layer_rel) <= MOE_LAYER_TOL, f"a routed MoE layer differs from the oracle by "
          f"rel_l2 {max(layer_rel)} > {MOE_LAYER_TOL}")
    check(min(layer_mut) > MOE_LAYER_TOL, "the dropped-expert mutant stays within the per-layer "
          "tolerance")

    # the whole model: expert pairs that flip between the two runs (above)
    # change a token's MoE output by O(1), and attention carries it to the
    # last position, so the logits' tolerance is the model's, not a layer's
    err = (logits - oracle).abs().max().item()
    log(f"moe: last-position prefill logits of {MOE_PROMPT} tokens (bucket 2048), routed vs "
        f"the dense oracle (FEI_TPU_ROUTED_MOE=0): max_abs_diff={err:.6g}, "
        f"rel_l2={rel(logits, oracle):.6g} (tol {MOE_TOL}), argmax {int(logits.argmax())} vs "
        f"{int(oracle.argmax())}; the mutant: rel_l2={rel(mutant, oracle):.6g}; two routed runs "
        f"bitwise equal; warm prefill {t_routed * 1e3:.1f} ms routed, {t_dense * 1e3:.1f} ms "
        f"the oracle; the routed form copied its expert block sizes to the host "
        f"{moe.ROUTED_SYNCS_PER_LAYER * len(routed_calls)} times a forward "
        f"({moe.ROUTED_SYNCS_PER_LAYER} a layer)")
    check(rel(logits, oracle) <= MOE_TOL, f"routed vs oracle logits rel_l2 "
          f"{rel(logits, oracle)} > {MOE_TOL}")
    check(rel(mutant, oracle) > MOE_TOL, f"the dropped-expert mutant stays within {MOE_TOL}")
    del oracle, mutant, again

    # the dense formulation's bf16 copy of each int8 expert leaf
    leaf = eng.params["layers"]["w_gate"].q[0]
    copy_ms = cuda_ms(lambda: leaf.to(torch.bfloat16), iters=5, warmup=1)
    ttft_bound, _ = serving_bounds(cfg, MOE_PROMPT, MOE_NEW, weight_stream_bytes(eng.params))
    reset_counts()
    res = eng.generate(prompt, GenerationConfig(max_new_tokens=MOE_NEW, ignore_eos=True,
                                                chunk=16))
    add(read_counts())
    check(len(res.token_ids) == MOE_NEW and all(0 <= t < cfg.vocab_size for t in res.token_ids),
          "MoE dense decode")
    every, topk = moe_decode_bounds(cfg, eng.params)
    log(f"moe: dense engine on {card}: TTFT {res.ttft_s * 1e3:.1f} ms (bound "
        f"{ttft_bound:.1f} ms), {MOE_NEW} greedy tokens at {res.decode_tokens_per_s:.2f} tok/s, "
        f"{1e3 / res.decode_tokens_per_s:.1f} ms a token; bound {every:.1f} tok/s reading every "
        f"expert (the dense formulation), {topk:.1f} tok/s reading the top-"
        f"{cfg.num_experts_per_tok}; each step casts every int8 expert leaf to a bf16 copy "
        f"({leaf.numel() * 2 / 1e9:.3f} GB, {copy_ms:.3f} ms each, {3 * L * copy_ms:.1f} ms "
        f"a token for the {3 * L} leaves)")

    # the paged engine: short prompts through dense admission (a routed
    # prefill, as the dense engine's), long ones in chunks (the oracle, as
    # the JAX package's paged chunks) merged with live decode
    gen = GenerationConfig(max_new_tokens=MOE_PAGED_NEW, ignore_eos=True)
    paged = InferenceEngine.from_config("mixtral-8x7b", dtype=torch.bfloat16, params=eng.params,
                                        max_seq_len=MOE_SEQ, device="cuda", paged=True,
                                        batch_size=4, page_size=PAGE)
    chunk = paged.scheduler.prefill_chunk
    merged0 = counter("engine.ragged_dispatches")
    reset_counts()
    run = traffic(paged, prompts, MOE_PAGED_NEW)
    counts = read_counts()
    add(counts)
    merged = counter("engine.ragged_dispatches") - merged0
    check(counts["ragged_paged_attention"] > 0 and merged > 0, "no merged MoE dispatch (K3)")
    check(counts["paged_attention_block"] > 0 and counts["flash_attention_fwd"] > 0,
          f"MoE paged launches {counts}")
    check(all(len(s) == MOE_PAGED_NEW and all(0 <= t < cfg.vocab_size for t in s)
              for s in run["streams"]), "MoE paged streams")
    total = sum(len(s) for s in run["streams"])
    log(f"moe: paged engine (4 rows, {PAGE}-slot pages), prompts {list(MOE_LENS)}, "
        f"{MOE_PAGED_NEW} tokens each on {card}: {merged:.0f} merged dispatches; {total} tokens in "
        f"{run['wall']:.2f} s ({total / run['wall']:.2f} tok/s); TTFT "
        f"{[round(x * 1e3, 1) for x in run['ttft']]} ms; launches {counts}")
    # the merged dispatch off: the chunks through K2's block form alone
    paged.scheduler.ragged_attention = False
    check(traffic(paged, prompts, MOE_PAGED_NEW)["streams"] == run["streams"],
          "MoE paged streams changed with ragged_attention=False")
    paged.scheduler.ragged_attention = True
    # against the dense engine, under the formulation each route takes
    # (dense admission routes; chunks take the oracle), each stream's first
    # split read by the dense engine itself (stepped_divergence); then the
    # same for the paged engine under the dropped-second-expert mutant
    wants = []
    for p in prompts:
        with env_vars(FEI_TPU_ROUTED_MOE=None if len(p) <= chunk else "0"):
            wants.append(eng.generate(p, gen).token_ids)

    def splits(streams):
        out = []
        for p, want, got in zip(prompts, wants, streams):
            if got == want:
                out.append(None)
                continue
            with env_vars(FEI_TPU_ROUTED_MOE=None if len(p) <= chunk else "0"):
                j, gap, same = stepped_divergence(eng, p, want, got)
            out.append((j, round(gap, 3), same))
        return out

    longs = [p for p in prompts if len(p) > chunk]

    def worst(found):
        """The largest gap at a split F1's rule holds: every split but a
        chunked prompt's first token, which its chunked prefill gives (held
        below by its logits against the dense prefill's)."""
        return max((s[1] for p, s in zip(prompts, found)
                    if s is not None and (len(p) <= chunk or s[0] > 0)), default=0.0)

    sound = splits(run["streams"])
    for p, want, got in zip(prompts, wants, run["streams"]):
        if len(p) <= chunk:  # the same routed prefill: the same first token
            check(got[0] == want[0], f"MoE stream of prompt {len(p)}: first token {got[0]} "
                  f"!= the dense engine's {want[0]}")

    def chunked_rel(dense_logits):
        """rel_l2 of each chunked prompt's last-position logits, the chunked
        paged prefill against the dense engine's whole prefill (both the
        oracle)."""
        with env_vars(FEI_TPU_ROUTED_MOE="0"):
            return [round(rel(chunked_paged_logits(paged, p), d), 6)
                    for p, d in zip(longs, dense_logits)]

    with env_vars(FEI_TPU_ROUTED_MOE="0"):
        dls = [eng.prefill([p], eng.new_cache(1))[0] for p in longs]
    sound_rel = chunked_rel(dls)
    moe._route = drop_second_expert(real_route)
    try:
        mutant_streams = traffic(paged, prompts, MOE_PAGED_NEW)["streams"]
        mutant_rel = chunked_rel(dls)
    finally:
        moe._route = real_route
    mutant = splits(mutant_streams)
    log(f"moe: paged streams against the dense engine's, (first split, dense logit gap in "
        f"bf16 ulps, the read reproduces the dense stream) or None where equal: {sound}, "
        f"worst {worst(sound)} past a chunked prompt's first token (tol {MOE_GAP_ULPS}); the "
        f"dropped-second-expert mutant on the paged engine: {mutant}, worst {worst(mutant)}; "
        f"chunked paged prefill of {[len(p) for p in longs]} tokens vs the dense prefill "
        f"(both the oracle): rel_l2 {sound_rel} (tol {MOE_TOL}), the mutant's {mutant_rel}; "
        f"ragged_attention=False gives the same four streams")
    check(all(s[2] for s in sound + mutant if s is not None), "a stepped read does not "
          "reproduce the dense engine's stream")
    check(worst(sound) <= MOE_GAP_ULPS, f"a MoE paged stream first leaves the dense engine's "
          f"at a gap of {worst(sound)} bf16 ulps > {MOE_GAP_ULPS}")
    check(worst(mutant) > MOE_GAP_ULPS, f"the mutant's paged streams stay within "
          f"{MOE_GAP_ULPS} ulps of the dense engine's")
    check(max(sound_rel) <= MOE_TOL, f"MoE chunked paged prefill rel_l2 {sound_rel} > {MOE_TOL}")
    check(max(mutant_rel) > MOE_TOL, f"the mutant's chunked paged prefills stay within "
          f"{MOE_TOL}: {mutant_rel}")
    paged.close()


def moe_prompts(cfg) -> tuple[list[int], list[list[int]]]:
    """The MoE phase's prefill prompt (``MOE_PROMPT`` ids), then its paged
    engine's prompts (``MOE_LENS``), drawn in that order from one generator."""
    rng = np.random.default_rng(SEED + 7)
    prompt = rng.integers(8, cfg.vocab_size, size=MOE_PROMPT).tolist()
    return prompt, [rng.integers(8, cfg.vocab_size, size=n).tolist() for n in MOE_LENS]


def moe_int4(card: str, add) -> None:
    """int4 mixtral-8x7b: K4 on the attention projections, the experts int8."""
    from fei_tpu_torch.engine import InferenceEngine
    from fei_tpu_torch.ops.quant import QTensor, QTensor4, param_bytes

    t0 = time.perf_counter()
    eng4 = InferenceEngine.from_config("mixtral-8x7b", dtype=torch.bfloat16, seed=SEED,
                                       max_seq_len=MOE_SEQ, device="cuda", quantize="int4")
    torch.cuda.synchronize()
    lay = eng4.params["layers"]
    check(isinstance(lay["wq"], QTensor4) and isinstance(lay["w_down"], QTensor),
          "int4 mode: the attention is not int4 or the experts are not int8")
    L = eng4.cfg.num_layers
    reset_counts()
    logits4, _ = eng4.prefill([moe_prompts(eng4.cfg)[0]], eng4.new_cache(1))
    torch.cuda.synchronize()
    counts = read_counts()
    add(counts)
    check(counts["int4_matmul"] == 4 * L, f"int4 MoE prefill launched K4 {counts['int4_matmul']} "
          f"times, expected {4 * L} (wq, wk, wv, wo)")
    check(torch.isfinite(logits4).all().item(), "int4 MoE prefill logits not finite")
    log(f"moe int4: param_bytes {param_bytes(eng4.params) / 1e9:.3f} GB (init "
        f"{time.perf_counter() - t0:.1f} s); a {MOE_PROMPT}-token prefill launched K4 "
        f"{counts['int4_matmul']} times, K1 {counts['flash_attention_fwd']}; logits finite")


def moe_train(card: str, add) -> None:
    """One training step on two layers at Mixtral's widths (the dense
    oracle in every MoE layer, as the JAX package trains), then its
    gradients through the kernels against ``flash=False``."""
    from fei_tpu_torch.engine.train import TrainConfig, loss_and_grads, make_train_step
    from fei_tpu_torch.models import llama
    from fei_tpu_torch.models.configs import get_model_config
    from fei_tpu_torch.ops import moe
    from fei_tpu_torch.ops.quant import param_bytes
    from fei_tpu_torch.utils.tree import flatten

    rng = np.random.default_rng(SEED + 8)
    cfg2 = get_model_config("mixtral-8x7b", num_layers=2)
    params = llama.init_params(cfg2, seed=SEED, dtype=torch.bfloat16, device="cuda")
    tokens = torch.from_numpy(rng.integers(8, cfg2.vocab_size, size=(1, MOE_TRAIN_TOKENS)))
    opt, step = make_train_step(cfg2, TrainConfig(remat=True))
    state = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    params, state, loss = step(params, state, tokens)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    add(counts)
    got = (counts["flash_attention_fwd"], counts["flash_attention_bwd_dq"],
           counts["flash_attention_bwd_dkv"])
    check(math.isfinite(float(loss)), f"MoE training loss {float(loss)}")
    check(got == (4, 2, 2), f"the MoE step launched K1/K5a/K5b {got}, expected (4, 2, 2)")
    log(f"moe train: 2 layers at {cfg2.name}'s widths ({param_bytes(params) / 1e9:.3f} GB bf16, "
        f"two moments), T = {MOE_TRAIN_TOKENS - 1}: loss {float(loss):.4f}, step "
        f"{step_ms:.1f} ms, peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; K1/K5a/K5b {got}")
    del opt, state
    gc.collect()
    torch.cuda.empty_cache()
    # the gradients through the kernels against the plain attention's. The
    # attention roundings differ, so a token whose router logits nearly tie
    # may pick another expert pair in the plain run; the check holds the
    # plain run to the kernel run's expert choices (the router's softmax
    # over the chosen logits still its own) and logs the free run beside it
    picks = []
    real_route = moe._route

    def recorded(logits, k):
        w, idx = real_route(logits, k)
        picks.append(idx)
        return w, idx

    def replayed(choices):
        it = iter(choices)

        def route(logits, k):
            idx = next(it)
            return torch.softmax(logits.gather(-1, idx), dim=-1), idx
        return route

    try:
        moe._route = recorded
        loss_k, grads_k = loss_and_grads(params, cfg2, tokens, remat=True)
        kernel_picks, picks = picks, []
        before = read_counts()
        loss_f, grads_f = loss_and_grads(params, cfg2, tokens, remat=True, flash=False)
        free_picks = picks
        moe._route = replayed(kernel_picks)
        loss_p, grads_p = loss_and_grads(params, cfg2, tokens, remat=True, flash=False)
    finally:
        moe._route = real_route
    check(read_counts() == before, "flash=False launched a flash kernel")

    def rel(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()

    flips = [int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
             for a, b in zip(kernel_picks[:2], free_picks[:2])]
    free_worst = max((rel(gk, gf), path) for (path, gk), gf in
                     zip(flatten(grads_k).items(), flatten(grads_f).values()))
    del grads_f
    worst = ("", 0.0)
    for (path, gk), gp in zip(flatten(grads_k).items(), flatten(grads_p).values()):
        r = rel(gk, gp)
        # tolerance: phase 18's at two layers (bf16 roundings of attention)
        check(math.isfinite(r) and r <= 5e-2, f"MoE gradient of {path}: rel_l2 {r} > 5e-2")
        worst = max(worst, (path, r), key=lambda x: x[1])
    check(abs(float(loss_k) - float(loss_p)) <= 1e-2, "MoE kernel and plain losses differ")
    log(f"moe train: gradients through K1/K5a/K5b vs the plain attention, the expert choices "
        f"held: worst rel_l2 {worst[1]:.4g} at {worst[0]} (tol 5e-2), loss {float(loss_k):.6f} "
        f"vs {float(loss_p):.6f}; free (the plain run routing itself: {flips} of "
        f"{tokens.shape[1] - 1} tokens picked another expert pair in layers 1, 2): worst rel_l2 "
        f"{free_worst[0]:.4g} at {free_worst[1]}, loss {float(loss_f):.6f}")


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


# ------------------------------------------------------------------ tp phase

TP_RANKS = 2
# depth of the tp phase's llama3-8b (cut from SERVE_LAYERS' 16 for time when
# the parallel part joined its ranks; every check kept)
TP_LAYERS = 8
TP_NEW = 32  # greedy tokens per stream of the tp phase
TP_PAGES = 400  # pool pages of the tp phase's paged engines (the traffic needs ~190)
TP_LOAD_LAYERS = 2  # depth of the checkpoint the sharded load reads
TP_GAP_ULPS = 2.0  # F1's rule for the Megatron profile's streams
TP_TOL = 3e-2  # rel_l2 of the Megatron and int4 logits against one rank's


def tp_params(quantize: str | None = None) -> dict:
    """The tp phase's weights, made identically on every rank: llama3-8b
    at its published widths, TP_LAYERS layers deep, from the seed; a
    bf16 LM head zeroed past the byte tokenizer's ids (as the serve phases
    do); under int4, wo/w_down int8, as a tp mesh's engine keeps them."""
    from fei_tpu_torch.engine.tokenizer import load_tokenizer
    from fei_tpu_torch.models.configs import get_model_config
    from fei_tpu_torch.models.llama import init_params

    cfg = get_model_config("llama3-8b", num_layers=TP_LAYERS)
    excl = frozenset({"wo", "w_down"}) if quantize == "int4" else frozenset()
    params = init_params(cfg, seed=SEED, dtype=torch.bfloat16, device="cuda",
                         quantize=quantize, int4_exclude=excl)
    if quantize is None:
        params["lm_head"][:, load_tokenizer("byte").vocab_size:] = 0
    return params


def tp_prompts(cfg) -> list:
    """The paged phase's eight prompts (96-5000 tokens)."""
    rng = np.random.default_rng(SEED + 1)
    return [rng.integers(8, cfg.vocab_size, size=n).tolist() for n in SHORT_LENS + LONG_LENS]


def tp_wrappers(mesh, lead: bool) -> dict:
    """Each sharded wrapper on this rank's kv heads (output columns)
    against the unsharded kernel on all of them, at the paged cell's
    shapes: 8 decode rows at the traffic's context lengths, 32/8 heads,
    D 128, a 64-token block, a merged chunk of 256; K4 at llama3-8b's wq
    and w_gate, M 1/8/256. Bitwise, or K4's tolerance where its narrower
    N changes its tile (said in the result). A gather in the wrong head
    order (the mutant) must break the check."""
    from fei_tpu_torch.ops.kernels.int4_matmul import int4_mm, int4_mm_sharded, int4_mm_tolerance
    from fei_tpu_torch.ops.kernels.paged_attention import (
        paged_attention, paged_attention_block, paged_attention_block_sharded,
        paged_attention_sharded)
    from fei_tpu_torch.ops.kernels.ragged_paged_attention import (
        ragged_paged_attention, ragged_paged_attention_sharded)
    from fei_tpu_torch.ops.quant import quantize4

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    H, K, D, width, n_pages = 32, 8, 128, 128, 256
    lengths = [n + TP_NEW // 2 for n in SHORT_LENS + LONG_LENS]
    kp, vp, _, _ = paged_pool(n_pages, K, D, False, gen)
    bt = paged_table([n + 256 for n in lengths], width, n_pages, SEED + 5)
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    c = mesh.coords["tp"]
    kl, hl = slice(c * K // 2, (c + 1) * K // 2), slice(c * H // 2, (c + 1) * H // 2)
    mine = (kp[:, kl].contiguous(), vp[:, kl].contiguous())
    q = torch.randn(8, H, D, generator=gen, device="cuda").bfloat16()
    qb = torch.randn(8, 64, H, D, generator=gen, device="cuda").bfloat16()
    cq = torch.randn(1, 256, H, D, generator=gen, device="cuda").bfloat16()
    qv, btv, limits, q_lens, modes = merged_inputs(q, cq, bt, ln + 1, 6, lengths[6] - 256)
    out = {}
    want = paged_attention(q, kp, vp, bt, ln)
    got = paged_attention_sharded(q[:, hl].contiguous(), *mine, bt, ln, mesh)
    out["paged_attention"] = bool(torch.equal(got, want))
    want = paged_attention_block(qb, kp, vp, bt, ln)
    got = paged_attention_block_sharded(qb[:, :, hl].contiguous(), *mine, bt, ln, mesh)
    out["paged_attention_block"] = bool(torch.equal(got, want))
    want = ragged_paged_attention(qv, kp, vp, btv, limits, q_lens, modes)
    got = ragged_paged_attention_sharded(qv[:, :, hl].contiguous(), *mine, btv, limits,
                                         q_lens, modes, mesh)
    out["ragged_paged_attention"] = bool(torch.equal(got, want))
    for name, N in (("wq", 4096), ("w_gate", 14336)):
        w = quantize4(torch.randn(4096, N, generator=gen, device="cuda").bfloat16() * 0.02)
        for m in (1, 8, 256):
            x = torch.randn(m, 4096, generator=gen, device="cuda").bfloat16()
            got, want = int4_mm_sharded(x, w, mesh), int4_mm(x, w)
            key = f"int4_mm {name} M{m}"
            if torch.equal(got, want):
                out[key] = True
            else:
                err = (got.float() - want.float()).abs()
                out[key] = bool((err <= 2 * int4_mm_tolerance(x, w)).all())
                out[key + " (K4's tolerance: the N/2 product sums in another order)"] = True
    gather = mesh.all_gather

    def reversed_gather(t, axis, dim):  # the mutant: rank order reversed
        return torch.cat(list(reversed(gather(t, axis, dim).chunk(mesh.shape[axis], dim))), dim)

    mesh.all_gather = reversed_gather
    try:
        got = paged_attention_sharded(q[:, hl].contiguous(), *mine, bt, ln, mesh)
    finally:
        mesh.all_gather = gather
    out["mutant breaks the check"] = not torch.equal(got, paged_attention(q, kp, vp, bt, ln))
    return out


def tp_checkpoint(path: str) -> int:
    """A TP_LOAD_LAYERS-layer llama3-8b safetensors checkpoint (HF names,
    bf16, random from the seed) written to ``path``; returns its largest
    tensor's bytes."""
    from safetensors.torch import save_file

    from fei_tpu_torch.models.configs import get_model_config

    cfg = get_model_config("llama3-8b")
    h, I, V, d = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.head_dim_
    H, K = cfg.num_heads, cfg.num_kv_heads
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)

    def rnd(*shape):
        return (torch.randn(*shape, generator=gen, device="cuda") * 0.02).bfloat16().cpu()

    ts = {"model.embed_tokens.weight": rnd(V, h), "lm_head.weight": rnd(V, h),
          "model.norm.weight": torch.ones(h, dtype=torch.bfloat16)}
    for i in range(TP_LOAD_LAYERS):
        pre = f"model.layers.{i}."
        ts.update({
            pre + "input_layernorm.weight": torch.ones(h, dtype=torch.bfloat16),
            pre + "post_attention_layernorm.weight": torch.ones(h, dtype=torch.bfloat16),
            pre + "self_attn.q_proj.weight": rnd(H * d, h),
            pre + "self_attn.k_proj.weight": rnd(K * d, h),
            pre + "self_attn.v_proj.weight": rnd(K * d, h),
            pre + "self_attn.o_proj.weight": rnd(h, H * d),
            pre + "mlp.gate_proj.weight": rnd(I, h),
            pre + "mlp.up_proj.weight": rnd(I, h),
            pre + "mlp.down_proj.weight": rnd(h, I),
        })
    Path(path).mkdir(parents=True, exist_ok=True)
    save_file(ts, str(Path(path) / "model.safetensors"))
    return max(t.numel() * t.element_size() for t in ts.values())


TP_DP_ROWS = 4  # paged rows of each dp group of the dp2 engine (8 in all)


def dp2_gauges(eng, prompts) -> dict:
    """The scheduler gauges of a dp2 paged engine (rank 0), against its
    mesh. Parked, with rows and queued requests placed by hand, one
    ``_update_sched_gauges`` call must set ``engine.mesh_shape`` 2,
    ``engine.mesh.dp`` 2 and every other axis 1, and each group's
    ``scheduler.replica.<g>.slots`` / ``.queue_depth`` to its block's rows
    and its share of the queue, as the JAX scheduler does. Then the tp
    phase's prompts run through it, every gauge update is read as it
    happens, and each group must have held rows, never more than its
    block. Returns what was read."""
    from types import SimpleNamespace

    from fei_tpu_torch.parallel.mesh import AXES
    from fei_tpu_torch.utils.metrics import METRICS

    sched, mesh = eng.scheduler, eng.mesh
    dp, rows = mesh.shape["dp"], sched.B
    per = rows // dp
    check(dp == 2 and rows == dp * TP_DP_ROWS, f"dp2 engine: dp {dp}, {rows} rows")
    want_mesh = {"engine.mesh_shape": math.prod(mesh.shape.values()),
                 **{f"engine.mesh.{ax}": mesh.shape[ax] for ax in AXES}}

    def read() -> dict:
        g = METRICS.snapshot()["gauges"]
        return {k: v for k, v in g.items()
                if k.startswith(("engine.mesh", "scheduler.replica."))
                or k in ("scheduler.queue_depth", "scheduler.running_slots")}

    # parked: rows 0, 2, 3 of the first block and row 0 of the second
    # occupied, three requests queued
    placed = [i % per in (0, 2, 3) if i < per else i % per == 0 for i in range(rows)]
    for i, taken in enumerate(placed):
        sched._slots[i] = SimpleNamespace(tenant="default", finished=False) if taken else None
    sched._waiting.extend(SimpleNamespace(tenant="default", finished=False) for _ in range(3))
    try:
        sched._update_sched_gauges()
        parked = read()
    finally:
        sched._slots[:] = [None] * rows
        sched._waiting.clear()
    want = dict(want_mesh, **{"scheduler.queue_depth": 3, "scheduler.running_slots": 4})
    for g in range(dp):
        want[f"scheduler.replica.{g}.slots"] = sum(placed[g * per:(g + 1) * per])
        want[f"scheduler.replica.{g}.queue_depth"] = 3 // dp + (1 if g < 3 % dp else 0)
    check(parked == want, f"dp2 parked gauges {parked}, expected {want}")

    most = [0] * dp
    wrong = []
    real = sched._update_sched_gauges

    def watched():
        real()
        now = read()
        if any(now.get(k) != v for k, v in want_mesh.items()):
            wrong.append(now)
        for g in range(dp):
            most[g] = max(most[g], now.get(f"scheduler.replica.{g}.slots", 0))

    sched._update_sched_gauges = watched
    try:
        run = traffic(eng, prompts, TP_NEW)
    finally:
        del sched._update_sched_gauges
    sched._update_sched_gauges()
    idle = read()
    check(not wrong, f"dp2 mesh gauges left the mesh's shape: {wrong[:2]}")
    check(all(0 < m <= per for m in most), f"dp2 replica rows at most {most}, block {per}")
    check(all(idle[f"scheduler.replica.{g}.{k}"] == 0 for g in range(dp)
              for k in ("slots", "queue_depth")), f"dp2 gauges after the traffic: {idle}")
    return {"parked": parked, "most_rows": most, "idle": idle,
            "tok_s": sum(map(len, run["streams"])) / run["wall"]}


def tp_rank_work(rank: int, workdir: str, params: dict) -> dict:
    """One rank's share of the tp phase. Every mesh engine is built on both
    ranks in the same order; rank 0 leads each (its traffic, its checks)
    and closes it, and rank 1 follows inside ``from_config`` until then.
    Rank 0 runs the one-rank references first, then both ranks count K1-K4
    from 0 over the tp path, then rank 0 lands the tp2 prefix on one rank."""
    import torch.distributed as dist

    from fei_tpu_torch.engine import GenerationConfig, InferenceEngine
    from fei_tpu_torch.ops.quant import param_bytes
    from fei_tpu_torch.parallel.mesh import make_mesh
    from fei_tpu_torch.utils.metrics import METRICS

    lead = rank == 0
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh({"tp": TP_RANKS}, device=dev)
    res = {"backend": mesh.backend, "device": str(mesh.device),
           "cards": torch.cuda.device_count()}
    log(f"tp rank {rank}: backend {mesh.backend}, device {mesh.device}, "
        f"{torch.cuda.device_count()} card(s) visible")
    check(mesh.device.type == "cuda", f"tp rank {rank} is not on the card")
    t0 = time.perf_counter()
    res["wrappers"] = tp_wrappers(mesh, lead)
    res["wrapper_s"] = time.perf_counter() - t0

    ckpt = str(Path(workdir) / "ckpt")
    if lead:
        res["largest_tensor"] = tp_checkpoint(ckpt)
    dist.barrier()
    kw = dict(dtype=torch.bfloat16, params=params, max_seq_len=8192, device="cuda",
              num_layers=TP_LAYERS)
    paged_kw = dict(kw, paged=True, batch_size=8, page_size=PAGE, num_pages=TP_PAGES,
                    prefix_cache=True)
    from fei_tpu_torch.models.configs import get_model_config

    cfg = get_model_config("llama3-8b", num_layers=TP_LAYERS)
    prompts = tp_prompts(cfg)
    p1500 = prompts[len(SHORT_LENS) + 1]
    seeded = GenerationConfig(max_new_tokens=TP_NEW, temperature=0.8, top_k=40, seed=7,
                              ignore_eos=True)
    turn = [{"role": "user", "content": "Summarise the tensor-parallel slice in a line."}]
    turn_gen = GenerationConfig(max_new_tokens=TP_NEW)

    # -- one-rank references (rank 0; not the tp path: not counted)
    if lead:
        one = InferenceEngine.from_config("llama3-8b", mesh="ms1", **paged_kw)
        ref = traffic(one, prompts, TP_NEW)
        res["ms1_tok_s"] = sum(map(len, ref["streams"])) / ref["wall"]
        ref_seeded = list(one.scheduler.stream(prompts[0], seeded))
        ref_blob = one.scheduler.export_prefix(p1500)
        one.close()
        del one
        dense1 = InferenceEngine.from_config("llama3-8b", mesh="ms1", **kw)
        ref_turn = dense1.chat(turn, turn_gen).token_ids
        ref_logits = dense1.prefill([p1500], dense1.new_cache(1))[0]
        one4 = InferenceEngine.from_config("llama3-8b", mesh="ms1", **dict(
            kw, params=tp_params("int4")))
        ref4 = one4.prefill([p1500], one4.new_cache(1))[0]
        del one4
        loaded1 = InferenceEngine.from_config("llama3-8b", mesh="ms1", checkpoint_dir=ckpt,
                                              dtype=torch.bfloat16, device="cuda",
                                              num_layers=TP_LOAD_LAYERS, max_seq_len=4096)
        ref_load = loaded1.prefill([p1500], loaded1.new_cache(1))[0]
        res["load_bytes_one_rank"] = param_bytes(loaded1.params)
        del loaded1
        torch.cuda.empty_cache()

    # -- the tp path: every kernel count from 0 on both ranks
    reset_counts()
    METRICS.reset()
    t_path = time.perf_counter()
    eng = InferenceEngine.from_config("llama3-8b", mesh="tp2", mesh_weights="replicated",
                                      **paged_kw)
    res["replicated_bytes"] = param_bytes(eng.params)
    if lead:
        got = traffic(eng, prompts, TP_NEW)
        res["tp2_tok_s"] = sum(map(len, got["streams"])) / got["wall"]
        res["streams_equal"] = [a == b for a, b in zip(got["streams"], ref["streams"])]
        res["seeded_equal"] = list(eng.scheduler.stream(prompts[0], seeded)) == ref_seeded
        res["blob"] = eng.scheduler.export_prefix(p1500)
        # the prompt again, now a prefix-cache hit: the route a landed prefix takes
        res["tp2_p1500_stream"] = list(eng.scheduler.stream(p1500, GenerationConfig(
            max_new_tokens=TP_NEW, ignore_eos=True)))
        span = METRICS.snapshot()["spans"].get("collective.tp", {})
        res["collective_dispatch"] = span
        res["collective_inside"] = {ax: list(v) for ax, v in eng.mesh.stats.items()}
        res["tp2_dispatches"] = eng._spmd_leader.dispatches
        eng.close()
    del eng
    # dp2: each rank serves its block of the paged rows; the scheduler's
    # mesh and replica gauges (F10) are held to the mesh
    dp2 = InferenceEngine.from_config("llama3-8b", mesh="dp2", mesh_weights="replicated",
                                      **dict(paged_kw, batch_size=TP_DP_ROWS))
    if lead:
        res["dp2"] = dp2_gauges(dp2, prompts)
        dp2.close()
    del dp2
    dense = InferenceEngine.from_config("llama3-8b", mesh="tp2", mesh_weights="replicated", **kw)
    if lead:
        res["turn_equal"] = dense.chat(turn, turn_gen).token_ids == ref_turn
        res["turn_len"] = len(ref_turn)
        dense.close()
    del dense

    # the Megatron profile: sharded weights, paged traffic and a 1500-token prefill
    meg = InferenceEngine.from_config("llama3-8b", mesh="tp2", mesh_weights="sharded",
                                      **paged_kw)
    res["sharded_bytes"] = param_bytes(meg.params)
    if lead:
        res["megatron_streams"] = traffic(meg, prompts, TP_NEW)["streams"]
        meg.close()
    del meg
    megd = InferenceEngine.from_config("llama3-8b", mesh="tp2", mesh_weights="sharded", **kw)
    if lead:
        lg = megd.prefill([p1500], megd.new_cache(1))[0]
        res["megatron_rel"] = ((lg - ref_logits).norm() / ref_logits.norm()).item()
        megd.close()
    del megd

    # int4: K4 column-sharded (int4_mm_sharded), wo/w_down int8
    q4 = InferenceEngine.from_config("llama3-8b", mesh="tp2", mesh_weights="replicated",
                                     **dict(kw, params=tp_params("int4")))
    if lead:
        lg4 = q4.prefill([p1500], q4.new_cache(1))[0]
        res["int4_bitwise"] = bool(torch.equal(lg4, ref4))
        res["int4_rel"] = ((lg4 - ref4).norm() / ref4.norm()).item()
        q4.close()
    del q4

    # a sharded streaming load: each rank's slices of each tensor (the
    # engines above are collected first, so no free lands inside the window)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    loaded = InferenceEngine.from_config("llama3-8b", mesh="tp2", mesh_weights="sharded",
                                         checkpoint_dir=ckpt, dtype=torch.bfloat16,
                                         device="cuda", num_layers=TP_LOAD_LAYERS,
                                         max_seq_len=4096)
    res["load_peak"] = torch.cuda.max_memory_allocated() - base
    res["load_bytes"] = param_bytes(loaded.params)
    if lead:
        lg = loaded.prefill([p1500], loaded.new_cache(1))[0]
        res["load_rel"] = ((lg - ref_load).norm() / ref_load.norm()).item()
        loaded.close()
    del loaded
    res["launches_tp"] = read_counts()
    res["tp_path_s"] = time.perf_counter() - t_path

    # -- the tp2 prefix lands on one rank (after the count: one-rank engine)
    if lead:
        from fei_tpu_torch.kv.tier import unpack_entry

        blob = res.pop("blob")
        mine, theirs = unpack_entry(blob)[0], unpack_entry(ref_blob)[0]
        res["blob_layout"] = mine.layout
        res["blob_bitwise"] = mine.n_tokens == theirs.n_tokens and all(
            np.array_equal(mine.arrays[k], theirs.arrays[k]) for k in theirs.arrays)
        fresh = InferenceEngine.from_config("llama3-8b", mesh="ms1", **paged_kw)
        res["landed"] = fresh.scheduler.import_prefix(blob)
        hits = METRICS.snapshot()["counters"].get("prefix.hits", 0)
        nxt = list(fresh.scheduler.stream(p1500, GenerationConfig(max_new_tokens=TP_NEW,
                                                                  ignore_eos=True)))
        res["landed_hit"] = METRICS.snapshot()["counters"].get("prefix.hits", 0) > hits
        res["landed_equal"] = nxt == res.pop("tp2_p1500_stream")
        fresh.close()
        # the Megatron streams: equal, or first apart at <= TP_GAP_ULPS
        gaps = []
        for p, want, got_s in zip(prompts, ref["streams"], res.pop("megatron_streams")):
            if want == got_s:
                gaps.append(None)
                continue
            j, gap, ulp = first_divergence(dense1, p, want, got_s)
            gaps.append((j, gap / ulp))
        res["megatron_gaps"] = gaps
    return res


# ------------------------------------------------------------- parallel part
#
# Sequence, expert and pipeline parallelism, sharded training and the bank
# exchange (roadmap C4, second half), in the tp phase's two ranks after its
# engines are released: each check runs on both ranks (rank 0 leads the
# engines and holds the one-rank references), at full width, cut in depth.

PAR_LAYERS = 4  # llama3-8b / mistral-7b depth of the sp and pp checks (cut: time)
PAR_SP_T = 8192  # the sp prompt: over long_prefill_min and mistral's 4096 window
PAR_SP_PAGED = 6000  # the paged engine's long prompt (admitted through the sp dispatch)
PAR_SP_SHORT = 200  # its short neighbour, decoding while the long one admits
PAR_NEW = 32
# rel_l2 of the ring / Ulysses logits against one rank's K1 prefill: the
# fp32 block products against K1's bf16 P·V (measured 0.0113-0.0125)
PAR_SP_TOL = 2e-2
PAR_EP_LAYERS = 2  # mixtral-8x7b depth (cut: time and memory)
PAR_EP_LENS = (96, 200, 700, 1500)
PAR_EP_NEW = 16
PAR_PP = (4, 1024)  # B, T of the pipeline check
PAR_PP_TOL = 1e-2  # rel_l2 of the pipelined logits against one rank's forward_train
PAR_TRAIN_LAYERS = 2
PAR_TRAIN_T = 2048
PAR_TRAIN_STEPS = 2
PAR_LOSS_TOL = 1e-3  # relative
PAR_UPDATE_TOL = 0.1  # rel_l2 of the parameters' change against one rank's
PAR_BANK = (4, 1024, 256)


def rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def layer_views(params: dict, layers: int) -> dict:
    """The first ``layers`` layers of ``params`` (views, no copy)."""
    return {**params, "layers": {k: v[:layers] for k, v in params["layers"].items()}}


def tree_clone(params: dict) -> dict:
    return {k: tree_clone(v) if isinstance(v, dict) else v.clone() for k, v in params.items()}


class PathCounts:
    """Kernel launches of the parallel path, summed over the sections it
    counts (each read as the difference of the counts around it)."""

    def __init__(self):
        self.total = dict.fromkeys(read_counts(), 0)
        self.by_part: dict[str, dict] = {}

    @contextlib.contextmanager
    def part(self, name: str):
        before = read_counts()
        yield
        torch.cuda.synchronize()
        got = {k: v - before[k] for k, v in read_counts().items()}
        self.by_part[name] = got
        for k, v in got.items():
            self.total[k] += v


def par_sp(rank: int, params: dict, counts: PathCounts, res: dict) -> None:
    """sp2: ring and Ulysses prefill logits against one rank's dense
    prefill (llama3-8b, then mistral-7b's window), a ring that skips its
    last rotation, and the paged engine admitting a long prompt through the
    sp dispatch beside a decoding stream."""
    from fei_tpu_torch.engine import InferenceEngine
    from fei_tpu_torch.models.configs import get_model_config
    from fei_tpu_torch.models.llama import init_params
    from fei_tpu_torch.parallel import ring as ring_mod
    from fei_tpu_torch.parallel.long_prefill import prefill_ring_kv
    from fei_tpu_torch.parallel.mesh import make_mesh

    lead = rank == 0
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh({"sp": 2}, device=dev)
    rng = np.random.default_rng(SEED + 11)
    for name, p in (("llama3-8b", layer_views(params, PAR_LAYERS)), ("mistral-7b", None)):
        cfg = get_model_config(name, num_layers=PAR_LAYERS)
        if p is None:
            p = init_params(cfg, seed=SEED, dtype=torch.bfloat16, device=dev)
        toks = torch.tensor([rng.integers(8, cfg.vocab_size, size=PAR_SP_T).tolist()],
                            device=dev)
        ref = ref_s = None
        if lead:  # one rank's dense prefill (K1), not counted; timed warm
            one = InferenceEngine.from_config(name, mesh="ms1", params=p, dtype=torch.bfloat16,
                                              device="cuda", num_layers=PAR_LAYERS,
                                              max_seq_len=PAR_SP_T)
            for _ in range(2):
                t0 = time.perf_counter()
                ref = one.prefill([toks[0].tolist()], one.new_cache(1))[0]
                torch.cuda.synchronize()
                ref_s = time.perf_counter() - t0
            del one
        out = {}
        for attend in ("ring", "ulysses"):
            with counts.part(f"sp {name} {attend}"):
                t0 = time.perf_counter()
                out[attend] = prefill_ring_kv(p, cfg, toks, mesh, attend=attend)[0]
                torch.cuda.synchronize()
                out[attend + "_s"] = time.perf_counter() - t0
        real_steps = ring_mod.ring_steps
        ring_mod.ring_steps = lambda n, C, w: real_steps(n, C, w) - 1  # the mutant
        try:
            mutant = prefill_ring_kv(p, cfg, toks, mesh, attend="ring")[0]
        finally:
            ring_mod.ring_steps = real_steps
        if lead:
            res[f"sp_{name}"] = {
                "ring": rel_l2(out["ring"], ref), "ulysses": rel_l2(out["ulysses"], ref),
                "mutant": rel_l2(mutant, ref), "ring_s": out["ring_s"],
                "ulysses_s": out["ulysses_s"], "one_rank_s": ref_s,
                "window": cfg.sliding_window or 0,
            }
        del p, out, mutant, ref
        torch.cuda.empty_cache()
    res["sp_stats"] = {k: list(v) for k, v in mesh.stats.items()}

    # the paged engine on sp2: the long prompt admits through the sp dispatch
    cfg = get_model_config("llama3-8b", num_layers=PAR_LAYERS)
    p = layer_views(params, PAR_LAYERS)
    prompts = [rng.integers(8, cfg.vocab_size, size=n).tolist()
               for n in (PAR_SP_SHORT, PAR_SP_PAGED)]
    kw = dict(dtype=torch.bfloat16, params=p, max_seq_len=PAR_SP_T, device="cuda",
              num_layers=PAR_LAYERS)
    paged = dict(kw, paged=True, batch_size=2, page_size=PAGE)
    if lead:  # one rank's chunked admission, not counted
        one = InferenceEngine.from_config("llama3-8b", mesh="ms1", **paged)
        one_run = traffic(one, prompts, PAR_NEW)
        want = one_run["streams"]
        res["sp_paged_ttft_one_rank"] = one_run["ttft"]
        one.close()
        del one
    sp0 = counter("engine.sp_prefills")
    with counts.part("sp paged"):
        eng = InferenceEngine.from_config("llama3-8b", mesh="sp2", mesh_weights="replicated",
                                          long_prefill_min=2048, **paged)
        if lead:
            # one sp dispatch covers the 6000-token prompt (8 x 256 x 2 would not)
            eng.scheduler.sp_admit_factor = -(-PAR_SP_PAGED // (eng.scheduler.prefill_chunk * 2))
            run = traffic(eng, prompts, PAR_NEW)
            res["sp_paged_tok_s"] = sum(map(len, run["streams"])) / run["wall"]
            res["sp_paged_ttft"] = run["ttft"]
            eng.close()
        del eng
    if lead:
        res["sp_prefills"] = counter("engine.sp_prefills") - sp0
        dense = InferenceEngine.from_config("llama3-8b", mesh="ms1", **kw)
        gaps = []
        for prompt, a, b in zip(prompts, want, run["streams"]):
            if a == b:
                gaps.append(None)
                continue
            j, gap, ulp = first_divergence(dense, prompt, a, b)
            gaps.append((j, gap / ulp))
        res["sp_paged_gaps"] = gaps
        del dense
    torch.cuda.empty_cache()


def par_ep(rank: int, counts: PathCounts, res: dict) -> None:
    """ep2: mixtral-8x7b (int8, two layers, 4 of 8 experts a rank): the
    dropless routed prefill against one rank's forward, a return trip in
    the wrong source-rank order, and a paged engine at the default capacity
    serving four prompts."""
    from fei_tpu_torch.engine import InferenceEngine
    from fei_tpu_torch.models.configs import get_model_config
    from fei_tpu_torch.models.llama import KVCache, forward, init_params
    from fei_tpu_torch.parallel.expert import expert_flops_share

    lead = rank == 0
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_model_config("mixtral-8x7b", num_layers=PAR_EP_LAYERS)
    mp = init_params(cfg, seed=SEED, dtype=torch.bfloat16, device=dev, quantize="int8")
    rng = np.random.default_rng(SEED + 13)
    prompt = rng.integers(8, cfg.vocab_size, size=PAR_EP_LENS[-1]).tolist()
    prompts = [rng.integers(8, cfg.vocab_size, size=n).tolist() for n in PAR_EP_LENS]
    kw = dict(dtype=torch.bfloat16, params=mp, max_seq_len=MOE_SEQ, device="cuda",
              num_layers=PAR_EP_LAYERS)
    if lead:  # one rank's routed prefill, not counted; timed warm
        one = InferenceEngine.from_config("mixtral-8x7b", mesh="ms1", **kw)
        for _ in range(2):
            t0 = time.perf_counter()
            ref = one.prefill([prompt], one.new_cache(1))[0]
            torch.cuda.synchronize()
            res["ep_one_rank_s"] = time.perf_counter() - t0
        del one
    with env_vars(FEI_TPU_EP_CAPACITY="dropless", FEI_TPU_ROUTED_MOE=None):
        with counts.part("ep dropless"):
            eng = InferenceEngine.from_config("mixtral-8x7b", mesh="ep2",
                                              mesh_weights="sharded", **kw)
            mine = eng.params
            res["ep_experts_a_rank"] = mine["layers"]["w_up"].q.shape[1]
            if lead:  # timed warm, as the reference
                for _ in range(2):
                    t0 = time.perf_counter()
                    got = eng.prefill([prompt], eng.new_cache(1))[0]
                    torch.cuda.synchronize()
                    res["ep_prefill_s"] = time.perf_counter() - t0
                res["ep_rel"] = rel_l2(got, ref)
                eng.close()
        mesh = eng.mesh
        del eng
        # the mutant on both ranks: the return trip's chunks in the wrong
        # source-rank order (a library call on each rank's own shard)
        real = mesh.all_to_all

        def wrong_order(t, axis, split_dim, concat_dim):
            out = real(t, axis, split_dim, concat_dim)
            if split_dim == 1:
                out = torch.cat(list(reversed(out.chunk(mesh.shape[axis], concat_dim))),
                                concat_dim)
            return out

        mesh.all_to_all = wrong_order
        try:
            cache = KVCache.create(cfg, 1, 2048, dtype=torch.bfloat16, device=dev)
            toks = torch.tensor([prompt], device=dev)
            lg, _ = forward(mine, cfg, toks, cache, lm_head=True, moe_mesh=mesh,
                            kernel_mesh=mesh)
        finally:
            mesh.all_to_all = real
        if lead:
            res["ep_mutant_rel"] = rel_l2(lg[:, -1], ref)
        del mine, lg, cache
    torch.cuda.empty_cache()
    # the paged engine at the default capacity (2.0)
    with env_vars(FEI_TPU_EP_CAPACITY=None, FEI_TPU_ROUTED_MOE=None):
        with counts.part("ep paged"):
            eng = InferenceEngine.from_config("mixtral-8x7b", mesh="ep2", mesh_weights="sharded",
                                              paged=True, batch_size=4, page_size=PAGE, **kw)
            if lead:
                run = traffic(eng, prompts, PAR_EP_NEW)
                res["ep_streams_ok"] = all(
                    len(s) == PAR_EP_NEW and all(0 <= t < cfg.vocab_size for t in s)
                    for s in run["streams"])
                res["ep_paged_tok_s"] = sum(map(len, run["streams"])) / run["wall"]
                res["ep_stats"] = {k: list(v) for k, v in eng.mesh.stats.items()}
                eng.close()
            del eng
    res["ep_flops_share"] = [expert_flops_share(n, cfg.num_experts, cfg.num_experts_per_tok, 2)
                             for n in PAR_EP_LENS]
    del mp
    torch.cuda.empty_cache()


def par_pp(rank: int, params: dict, counts: PathCounts, res: dict) -> None:
    """pp2: pipeline_forward_train with 2 and 4 microbatches against one
    rank's forward_train (K1) on the same weights."""
    from fei_tpu_torch.models.configs import get_model_config
    from fei_tpu_torch.models.llama import forward_train
    from fei_tpu_torch.parallel.mesh import make_mesh
    from fei_tpu_torch.parallel.pipeline import pipeline_forward_train

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh({"pp": 2}, device=dev)
    cfg = get_model_config("llama3-8b", num_layers=PAR_LAYERS)
    p = layer_views(params, PAR_LAYERS)
    B, T = PAR_PP
    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    toks = torch.randint(8, cfg.vocab_size, (B, T), generator=g, device="cuda")
    with torch.no_grad():
        ref = forward_train(p, cfg, toks, remat=False) if rank == 0 else None
        for m in (2, 4):
            with counts.part(f"pp micro {m}"):
                t0 = time.perf_counter()
                got = pipeline_forward_train(p, cfg, toks, mesh, m)
                torch.cuda.synchronize()
            if rank == 0:
                res[f"pp_rel_m{m}"] = rel_l2(got, ref)
                res[f"pp_s_m{m}"] = time.perf_counter() - t0
            del got
    res["pp_stats"] = {k: list(v) for k, v in mesh.stats.items()}
    del ref
    torch.cuda.empty_cache()


def par_train(rank: int, params: dict, counts: PathCounts, res: dict) -> None:
    """dp2 (two sequences, one a rank) and tp2 (one sequence, Megatron
    shards): loss and parameters after two steps against one rank's steps
    on the same batch; each rank launches K1, K5a and K5b."""
    from fei_tpu_torch.engine.train import TrainConfig, make_train_step
    from fei_tpu_torch.models.configs import get_model_config
    from fei_tpu_torch.parallel.mesh import make_mesh
    from fei_tpu_torch.parallel.sharding import shard_params
    from fei_tpu_torch.utils.tree import flatten

    lead = rank == 0
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_model_config("llama3-8b", num_layers=PAR_TRAIN_LAYERS)
    base = layer_views(params, PAR_TRAIN_LAYERS)
    g = torch.Generator(device="cuda").manual_seed(SEED + 19)
    toks = torch.randint(8, cfg.vocab_size, (2, PAR_TRAIN_T + 1), generator=g, device="cuda")
    tc = TrainConfig()
    for spec, batch in (("dp2", toks), ("tp2", toks[:1])):
        mesh = make_mesh(spec, device=dev)
        ref = None
        if lead:  # one rank's steps on the same batch, not counted
            p1 = tree_clone(base)
            opt, step = make_train_step(cfg, tc, device="cuda")
            st = opt.init(p1)
            losses1 = []
            for _ in range(PAR_TRAIN_STEPS):
                p1, st, loss = step(p1, st, batch)
                losses1.append(float(loss))
            ref = shard_params(p1, mesh, False)
            del p1, st
            torch.cuda.empty_cache()
        mine = shard_params(tree_clone(base), mesh, False)
        start = shard_params(base, mesh, False)
        opt, step = make_train_step(cfg, tc, device="cuda", mesh=mesh)
        st = opt.init(mine)
        losses = []
        with counts.part(f"train {spec}"):
            t0 = time.perf_counter()
            for _ in range(PAR_TRAIN_STEPS):
                mine, st, loss = step(mine, st, batch)
                losses.append(float(loss))
            step_s = (time.perf_counter() - t0) / PAR_TRAIN_STEPS
        res[f"train_{spec}_launches"] = counts.by_part[f"train {spec}"]
        if lead:
            num = den = 0.0
            for k, a in flatten(mine).items():
                b, s0 = flatten(ref)[k], flatten(start)[k]
                num += ((a.float() - s0.float()) - (b.float() - s0.float())).square().sum().item()
                den += (b.float() - s0.float()).square().sum().item()
            res[f"train_{spec}"] = {"losses": losses, "losses_one": losses1,
                                    "update_rel": (num / den) ** 0.5, "step_s": step_s}
        del mine, st, ref, start
        torch.cuda.empty_cache()


def par_banks(rank: int, res: dict) -> None:
    """exchange_banks of PAR_BANK fp32 over the two ranks, on the card."""
    import torch.distributed as dist

    from fei_tpu_torch.memory.memorychain.embedding_exchange import exchange_banks

    banks = np.random.default_rng(SEED + 23).standard_normal(PAR_BANK).astype(np.float32)
    t0 = time.perf_counter()
    out = exchange_banks(banks, group=dist.group.WORLD, device="cuda")
    torch.cuda.synchronize()
    res["bank_s"] = time.perf_counter() - t0
    res["bank_device"] = str(out.device)
    res["bank_bitwise"] = out[0].cpu().numpy().tobytes() == banks.tobytes()


def parallel_rank_work(rank: int, params: dict) -> dict:
    """One rank's share of the parallel part (both ranks run every check;
    rank 0 holds the one-rank references). Returns the rank's results and
    its kernel launches on the parallel path (``launches_parallel``)."""
    res: dict = {}
    counts = PathCounts()
    t0 = time.perf_counter()
    for name, part in (("sp", lambda: par_sp(rank, params, counts, res)),
                       ("ep", lambda: par_ep(rank, counts, res)),
                       ("pp", lambda: par_pp(rank, params, counts, res)),
                       ("train", lambda: par_train(rank, params, counts, res)),
                       ("banks", lambda: par_banks(rank, res))):
        t1 = time.perf_counter()
        part()
        gc.collect()
        torch.cuda.empty_cache()
        res[f"{name}_s"] = time.perf_counter() - t1
        log(f"parallel part, rank {rank}: {name} in {res[name + '_s']:.1f} s")
    res["launches_parallel"] = counts.total
    res["launches_by_part"] = counts.by_part
    res["parallel_s"] = time.perf_counter() - t0
    return res


def parallel_report(ranks: list, card: str) -> dict:
    """Checks and logs the parallel part's results; returns each kernel's
    launches per rank on the parallel path."""
    r0 = ranks[0]
    for name in ("llama3-8b", "mistral-7b"):
        s = r0[f"sp_{name}"]
        log(f"parallel sp2 {name} ({PAR_LAYERS} layers, {PAR_SP_T} tokens, window "
            f"{s['window']}): last logits rel_l2 against one rank's K1 prefill: ring "
            f"{s['ring']:.6g}, ulysses {s['ulysses']:.6g} (tol {PAR_SP_TOL}); a ring that "
            f"skips its last rotation {s['mutant']:.6g}; ring {s['ring_s']:.3f} s, "
            f"ulysses {s['ulysses_s']:.3f} s (first call each), one rank's prefill "
            f"{s['one_rank_s']:.3f} s (warm) on {card}")
        check(s["ring"] <= PAR_SP_TOL and s["ulysses"] <= PAR_SP_TOL,
              f"sp2 {name} logits: {s}")
        check(s["mutant"] > PAR_SP_TOL, f"the ring mutant stays within {PAR_SP_TOL}: {s}")
    log(f"parallel sp2: collectives (seconds, calls; staged bytes, calls) {r0['sp_stats']}")
    bad = [g for g in r0["sp_paged_gaps"] if g is not None and abs(g[1]) > TP_GAP_ULPS]
    log(f"parallel sp2 paged engine: {r0['sp_prefills']:.0f} sp prefills; streams of "
        f"{PAR_SP_SHORT} and {PAR_SP_PAGED} tokens against one rank's chunked admission, "
        f"(first split, ulps) or None where equal: {r0['sp_paged_gaps']}; "
        f"{r0['sp_paged_tok_s']:.2f} tok/s, TTFT {[round(x, 3) for x in r0['sp_paged_ttft']]} s "
        f"(one rank, chunked: {[round(x, 3) for x in r0['sp_paged_ttft_one_rank']]} s)")
    check(r0["sp_prefills"] > 0, "the sp2 paged engine never took the sp dispatch")
    check(not bad, f"sp2 paged streams split above {TP_GAP_ULPS} bf16 ulps: {bad}")
    for r, res in enumerate(ranks):
        c = res["launches_by_part"]["sp paged"]
        check(c["paged_attention"] > 0 and c["flash_attention_fwd"] > 0,
              f"rank {r}'s sp paged run launched {c}")
    log(f"parallel ep2 (mixtral-8x7b int8, {PAR_EP_LAYERS} layers, "
        f"{r0['ep_experts_a_rank']} experts a rank): dropless prefill of "
        f"{PAR_EP_LENS[-1]} tokens rel_l2 {r0['ep_rel']:.6g} against one rank's routed "
        f"prefill (tol {MOE_TOL}) in {r0['ep_prefill_s']:.3f} s (one rank's routed prefill "
        f"{r0['ep_one_rank_s']:.3f} s; both warm); wrong source order "
        f"{r0['ep_mutant_rel']:.6g}; paged at capacity 2.0: {r0['ep_paged_tok_s']:.2f} tok/s, "
        f"expert rows (routed, dense-local) a rank {r0['ep_flops_share']}; collectives "
        f"{r0['ep_stats']}")
    check(r0["ep_experts_a_rank"] == 4, "ep2 ranks do not hold 4 of 8 experts each")
    check(r0["ep_rel"] <= MOE_TOL, f"ep2 dropless logits rel_l2 {r0['ep_rel']}")
    check(r0["ep_mutant_rel"] > MOE_TOL, f"the ep2 wrong-order mutant stays within {MOE_TOL}")
    check(r0["ep_streams_ok"], "the ep2 paged streams did not complete")
    for r, res in enumerate(ranks):
        c = res["launches_by_part"]["ep paged"]
        for k in ("flash_attention_fwd", "paged_attention", "ragged_paged_attention"):
            check(c[k] > 0, f"rank {r}'s ep paged run never launched {k}: {c}")
    log(f"parallel pp2 ({PAR_LAYERS} layers, B, T = {PAR_PP}): logits rel_l2 against one "
        f"rank's forward_train: 2 microbatches {r0['pp_rel_m2']:.6g} ({r0['pp_s_m2']:.2f} s), "
        f"4 microbatches {r0['pp_rel_m4']:.6g} ({r0['pp_s_m4']:.2f} s) (tol {PAR_PP_TOL}); "
        f"collectives {r0['pp_stats']}")
    check(max(r0["pp_rel_m2"], r0["pp_rel_m4"]) <= PAR_PP_TOL, "pp2 logits")
    for r, res in enumerate(ranks):
        for m in (2, 4):
            check(res["launches_by_part"][f"pp micro {m}"]["flash_attention_fwd"] > 0,
                  f"rank {r}'s pipeline never launched K1")
    for spec in ("dp2", "tp2"):
        t = r0[f"train_{spec}"]
        loss_rel = max(abs(a - b) / b for a, b in zip(t["losses"], t["losses_one"]))
        log(f"parallel training {spec} (llama3-8b, {PAR_TRAIN_LAYERS} layers, T = "
            f"{PAR_TRAIN_T}): losses {t['losses']} vs one rank's {t['losses_one']} (rel "
            f"{loss_rel:.3g}, tol {PAR_LOSS_TOL}); parameter change rel_l2 "
            f"{t['update_rel']:.6g} (tol {PAR_UPDATE_TOL}); {t['step_s']:.2f} s a step")
        check(loss_rel <= PAR_LOSS_TOL, f"{spec} loss {t}")
        check(t["update_rel"] <= PAR_UPDATE_TOL, f"{spec} parameter change {t}")
        for r, res in enumerate(ranks):
            c = res[f"train_{spec}_launches"]
            for k in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
                check(c[k] > 0, f"rank {r}'s {spec} training never launched {k}: {c}")
    for r, res in enumerate(ranks):
        check(res["bank_bitwise"] and res["bank_device"].startswith("cuda"),
              f"rank {r}'s exchanged bank is not bitwise the whole bank")
    log(f"parallel bank exchange {PAR_BANK} fp32 over 2 ranks: bitwise on both "
        f"({r0['bank_s'] * 1e3:.1f} ms)")
    secs = {k: round(r0[f"{k}_s"], 1) for k in ("sp", "ep", "pp", "train", "banks")}
    log(f"parallel part: {r0['parallel_s']:.1f} s on rank 0 ({secs}) on {card}")
    launches = [res["launches_parallel"] for res in ranks]
    for r, c in enumerate(launches):
        log(f"parallel part: rank {r} launches {c}")
    return {k: [c[k] for c in launches] for k in launches[0]}


def tp_rank_main(rank: int, port: int, workdir: str, parts: tuple) -> None:
    """A spawned rank of the tp phase: NCCL on card ``rank`` when the
    machine has a card per rank, else gloo with both ranks on card 0. It
    runs the tp work, then (its engines released) the parallel part, on
    the same weights; ``parts`` names which."""
    import os
    import pickle
    import traceback

    import torch.distributed as dist

    from fei_tpu_torch.parallel.distributed import choose_backend

    backend, shared = choose_backend("cuda", TP_RANKS)
    torch.cuda.set_device(0 if shared else rank)
    out = {}
    try:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=TP_RANKS, rank=rank)
        params = tp_params()
        got = {}
        if "tp" in parts:
            got["tp"] = tp_rank_work(rank, workdir, params)
        if "parallel" in parts:
            gc.collect()
            torch.cuda.empty_cache()
            got["parallel"] = parallel_rank_work(rank, params)
        out = {"ok": got}
    except BaseException:  # noqa: BLE001 — the parent reports it
        out = {"error": traceback.format_exc()}
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    if dist.is_initialized():
        dist.destroy_process_group()


def tp_serve_check(card: str) -> None:
    """The entry points start their own ranks: ``from_config`` under
    ``FEI_TPU_MESH=tp2`` (as ``fei serve`` builds its engine) spawns the
    follower, the server's handler answers a completion with ``/health``
    reporting ``tp2``, and a drain then ``close`` (what SIGTERM does)
    stops the follower process."""
    from fei_tpu_torch.agent.providers import TorchLocalProvider
    from fei_tpu_torch.engine import InferenceEngine
    from fei_tpu_torch.ui.server import ServeAPI

    t0 = time.perf_counter()
    with env_vars(FEI_TPU_MESH="tp2", FEI_TPU_MESH_WEIGHTS=None):
        eng = InferenceEngine.from_config("llama3-8b", dtype=torch.bfloat16, seed=SEED,
                                          device="cuda", paged=True, batch_size=2,
                                          max_seq_len=1024, num_layers=TP_LOAD_LAYERS)
    procs = list(eng.mesh.launched)
    api = ServeAPI(TorchLocalProvider(engine=eng), model_name="llama3-8b")
    status, health = api.handle("GET", "/health", {}, {})[:2]
    check(status == 200 and health["mesh"] == "tp2" and health["kv_layout"]["tp"] == 2,
          f"/health under FEI_TPU_MESH=tp2: {status} {health}")
    body = {"model": "llama3-8b", "max_tokens": 8, "temperature": 0,
            "messages": [{"role": "user", "content": "hello"}]}
    status, resp = api.handle("POST", "/v1/chat/completions", body, {})[:2]
    check(status == 200, f"completion on the tp2 server: {status} {resp}")
    eng.begin_drain(deadline_s=5)
    check(eng.wait_drained(30), "the tp2 engine did not drain")
    eng.close()
    for p in procs:
        p.join(30)
    check(len(procs) == 1 and all(p.exitcode == 0 for p in procs),
          f"the follower rank did not stop with the engine: {[p.exitcode for p in procs]}")
    log(f"tp phase: FEI_TPU_MESH=tp2 engine started its follower (pid {procs[0].pid}), "
        f"/health mesh {health['mesh']}, a completion answered, drained and closed; the "
        f"follower exited 0 ({time.perf_counter() - t0:.1f} s on {card})")


def tp_phase(card: str, parts: tuple = ("tp", "parallel")) -> tuple[dict, dict]:
    """The tensor-parallel path (roadmap C4, first half), then the parallel
    part (sp, ep, pp, sharded training, the bank exchange: its second half)
    on the card: two ranks spawned here share it over gloo (one rank per
    card over NCCL where there are two cards). ``parts`` names which run.
    Returns each rank's launches on the tp path and on the parallel path."""
    import pickle

    import torch.multiprocessing as mp

    work = tempfile.mkdtemp(prefix="fei-tp-")
    t0 = time.perf_counter()
    try:
        ctx = mp.get_context("spawn")
        port = free_port()
        procs = [ctx.Process(target=tp_rank_main, args=(r, port, work, parts))
                 for r in range(TP_RANKS)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(900)
        for p in procs:
            if p.is_alive():
                p.kill()
        ranks = []
        for r in range(TP_RANKS):
            f = Path(work) / f"rank{r}.pkl"
            check(f.exists(), f"tp rank {r} left no result (exit code {procs[r].exitcode})")
            got = pickle.loads(f.read_bytes())
            check("ok" in got, f"tp rank {r} failed:\n{got.get('error')}")
            ranks.append(got["ok"])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches_tp = tp_report([res["tp"] for res in ranks], card) if "tp" in parts else {}
    launches_par = ({} if "parallel" not in parts
                    else parallel_report([res["parallel"] for res in ranks], card))
    log(f"tp phase: {time.perf_counter() - t0:.1f} s")
    return launches_tp, launches_par


def tp_report(ranks: list, card: str) -> dict:
    """Checks and logs the tp work's results (and runs the server check);
    returns each kernel's launches per rank on the tp path."""
    r0 = ranks[0]
    for r, res in enumerate(ranks):
        check(res["device"].startswith("cuda"), f"tp rank {r} ran on {res['device']}")
        check((res["backend"] == "gloo") == (res["cards"] < TP_RANKS),
              f"tp rank {r}: backend {res['backend']} with {res['cards']} card(s)")
    shared = r0["cards"] < TP_RANKS
    where = (f"{TP_RANKS} ranks share one card ({r0['device']}) over gloo" if shared
             else "one rank per card over NCCL")
    log(f"tp phase: {where}; {card}")
    for name, ok in r0["wrappers"].items():
        log(f"tp phase: sharded wrapper {name}: {'bitwise' if ok else 'FAILED'}"
            if name != "mutant breaks the check" else f"tp phase: head-order mutant caught: {ok}")
        check(ok, f"tp phase: {name}")
    check(all(r0["streams_equal"]), f"tp2 streams vs one rank: {r0['streams_equal']}")
    check(r0["seeded_equal"], "the tp2 seeded stream differs from one rank's")
    check(r0["turn_equal"], "the tp2 dense chat turn differs from one rank's")
    log(f"tp phase (replicated weights): the 8 paged streams x {TP_NEW}, a seeded stream "
        f"and a {r0['turn_len']}-token dense chat turn are bitwise one rank's")
    # the gap is read by the one-rank dense engine's prefill, which may rank
    # a near tie either way (F1), so its size is held, not its sign
    bad = [g for g in r0["megatron_gaps"] if g is not None and abs(g[1]) > TP_GAP_ULPS]
    log(f"tp phase (Megatron weights): 1500-token prefill logits rel_l2 "
        f"{r0['megatron_rel']:.6g} (tol {TP_TOL}); stream first splits "
        f"(token, ulps) {r0['megatron_gaps']}")
    check(r0["megatron_rel"] <= TP_TOL, f"Megatron logits rel_l2 {r0['megatron_rel']}")
    check(not bad, f"Megatron streams split above {TP_GAP_ULPS} bf16 ulps: {bad}")
    for r, res in enumerate(ranks):
        ratio = res["sharded_bytes"] / res["replicated_bytes"]
        log(f"tp phase: rank {r} param_bytes {res['sharded_bytes']} (Megatron) vs "
            f"{res['replicated_bytes']} (replicated): {ratio:.4f}")
        check(0.45 <= ratio <= 0.55, f"rank {r}'s Megatron share is {ratio:.4f}")
    d = r0["dp2"]
    log(f"tp phase (dp2, {2 * TP_DP_ROWS} rows): scheduler gauges parked with placed rows "
        f"{json.dumps(d['parked'], sort_keys=True)}; under the {len(SHORT_LENS + LONG_LENS)} "
        f"prompts each group held at most {d['most_rows']} rows (block {TP_DP_ROWS}); after "
        f"{json.dumps(d['idle'], sort_keys=True)}; {d['tok_s']:.2f} tok/s")
    log(f"tp phase (int4, wo/w_down int8): logits vs one rank on the same weights "
        f"bitwise {r0['int4_bitwise']}, rel_l2 {r0['int4_rel']:.6g} (tol {TP_TOL})")
    check(r0["int4_rel"] <= TP_TOL, f"int4 tp2 logits rel_l2 {r0['int4_rel']}")
    share = r0["load_bytes_one_rank"] / TP_RANKS
    for r, res in enumerate(ranks):
        log(f"tp phase: rank {r} sharded load of a {TP_LOAD_LAYERS}-layer llama3-8b "
            f"checkpoint: params {res['load_bytes']} B, peak allocated while loading "
            f"{res['load_peak']} B (share {share:.0f} + largest tensor "
            f"{r0['largest_tensor']})")
        check(res["load_peak"] <= share + r0["largest_tensor"],
              f"rank {r}'s load peaked at {res['load_peak']} B")
    check(r0["load_rel"] <= TP_TOL, f"sharded-load logits rel_l2 {r0['load_rel']}")
    check(r0["blob_bitwise"] and r0["blob_layout"]["tp"] == TP_RANKS,
          f"the tp2 FKV1 blob (layout {r0['blob_layout']}) is not one rank's bytes")
    check(r0["landed"] > 0 and r0["landed_hit"] and r0["landed_equal"],
          f"the tp2 prefix on one rank: pages {r0['landed']}, hit {r0['landed_hit']}, "
          f"stream equal {r0['landed_equal']}")
    log(f"tp phase: the tp2 engine's exported 1500-token prefix (layout "
        f"{r0['blob_layout']}, bitwise one rank's blob) landed on a one-rank engine "
        f"({r0['landed']} pages), which hit it and streamed the tp2 engine's tokens")
    span, inside = r0["collective_dispatch"], r0["collective_inside"].get("tp", [0.0, 0])
    log(f"tp phase: collective.tp (per decode dispatch, upper bound) count "
        f"{span.get('count', 0)} mean {span.get('mean_s', 0) * 1e3:.3f} ms; inside the "
        f"collectives {inside[0]:.3f} s over {inside[1]} calls "
        f"({inside[0] / max(1, inside[1]) * 1e3:.3f} ms each); "
        f"{r0['tp2_dispatches']} dispatches broadcast")
    log(f"tp phase: paged tok/s tp2 {r0['tp2_tok_s']:.2f} vs one rank {r0['ms1_tok_s']:.2f} "
        f"on {card} ({'two ranks on one card: no interconnect is measured' if shared else 'NCCL'})")
    launches = [res["launches_tp"] for res in ranks]
    for r, c in enumerate(launches):
        log(f"tp phase: rank {r} launches {c}")
        for k in ("flash_attention_fwd", "paged_attention", "ragged_paged_attention",
                  "int4_matmul"):
            check(c[k] > 0, f"tp rank {r} never launched {k}")
    log(f"tp phase: wrappers {r0['wrapper_s']:.1f} s, tp path {r0['tp_path_s']:.1f} s")
    tp_serve_check(card)
    return {k: [c[k] for c in launches] for k in launches[0]}



def main() -> int:
    # a native crash (SIGSEGV in a library) prints every thread's stack
    faulthandler.enable()
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
    if sys.argv[1:] == ["--kv"]:
        with ThreadPoolExecutor(3) as pool:
            list(pool.map(build.build, KERNELS[:1] + KERNELS[2:4]))
        kv_phase(depth(kv_weights(), KV_LAYERS), card)
        return 0
    if sys.argv[1:] == ["--fleet"]:
        with ThreadPoolExecutor(3) as pool:
            list(pool.map(build.build, KERNELS[:1] + KERNELS[2:4]))
        log(f"fleet path: launches {fleet_phase(kv_weights(), card)}")
        return 0
    if sys.argv[1:] == ["--serve-rates"]:
        with ThreadPoolExecutor(3) as pool:
            list(pool.map(build.build, KERNELS[:1] + KERNELS[2:4]))
        serve_rates(card)
        return 0
    if sys.argv[1:] == ["--spec"]:
        with ThreadPoolExecutor(3) as pool:
            list(pool.map(build.build, KERNELS[:1] + KERNELS[2:4]))
        log(f"speculation path: launches {spec_phase(kv_weights(), card)}")
        return 0
    if sys.argv[1:] == ["--moe"]:
        with ThreadPoolExecutor(len(KERNELS)) as pool:
            list(pool.map(build.build, KERNELS))
        log(f"MoE path: launches {moe_phase(card)}")
        return 0
    if sys.argv[1:] == ["--tp"]:
        with ThreadPoolExecutor(4) as pool:
            list(pool.map(build.build, KERNELS[:1] + KERNELS[2:]))
        log(f"tp path: launches per rank {tp_phase(card, ('tp',))[0]}")
        return 0
    if sys.argv[1:] == ["--parallel"]:
        with ThreadPoolExecutor(len(KERNELS)) as pool:
            list(pool.map(build.build, KERNELS))
        log(f"parallel path: launches per rank {tp_phase(card, ('parallel',))[1]}")
        return 0
    if sys.argv[1:] == ["--quant"]:
        with ThreadPoolExecutor(4) as pool:
            list(pool.map(build.build, KERNELS[:1] + KERNELS[2:]))
        from fei_tpu_torch.models.configs import get_model_config
        from fei_tpu_torch.models.llama import init_params
        from fei_tpu_torch.ops.quant import param_bytes

        log(f"int4 kernel: {json.dumps(int4_kernel_phase(card))}")
        # the bf16 tree's bytes at the same depth, from shapes alone
        bf16_bytes = param_bytes(init_params(
            get_model_config("llama3-8b", num_layers=SERVE_LAYERS), device="meta"))
        dense4 = quant_dense_phase(card, bf16_bytes)
        log(f"int4-head path: launches {quant_switches_phase(dense4, card)}")
        return 0
    if sys.argv[1:] == ["--tools"]:
        from fei_tpu_torch.engine import InferenceEngine

        with ThreadPoolExecutor(3) as pool:
            list(pool.map(build.build, KERNELS[:1] + KERNELS[2:4]))
        dense = kv_weights()
        paged = InferenceEngine.from_config(
            "llama3-8b", dtype=torch.bfloat16, params=dense.params, max_seq_len=8192,
            device="cuda", paged=True, batch_size=8, page_size=PAGE,
            num_layers=dense.cfg.num_layers)
        reset_counts()
        serving_controls(paged, card)
        log(f"agent tools path: launches {tools_phase(dense, paged, card)}")
        paged.close()
        return 0

    t0 = last = time.perf_counter()
    phase_s: dict[str, float] = {}

    def stamp(name: str) -> None:
        """Wall seconds since the previous stamp, under the phase's name."""
        nonlocal last
        now = time.perf_counter()
        phase_s[name] = round(now - last, 1)
        last = now

    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source
        for res in pool.map(build.build, KERNELS):
            regs = [ln.strip() for ln in res.log.splitlines() if "registers" in ln]
            log(f"build: {res.name} -> {res.path.name} in {res.seconds:.1f} s; {regs}")
    log(f"build: {time.perf_counter() - t0:.1f} s")

    stamp("build")
    records = [kernel_phase(card)] + paged_kernel_phase(card)
    bwd_records = flash_bwd_kernel_phase(card)
    int4_record = int4_kernel_phase(card)
    stamp("kernels")

    from fei_tpu_torch.engine import InferenceEngine
    from fei_tpu_torch.ops.kernels.flash_attention import flash_attention

    # the dense path (engine, then serve) and the paged path (paged engine,
    # then paged serve): each with its counts set to 0 just before it
    engine = engine_phase(card)  # zeroes the flash count itself
    dense_launches = flash_attention.launches
    stamp("engine")
    # every later bf16 path runs on the first SERVE_LAYERS layers of the
    # same weights (views; cut for time)
    dense = depth(engine, SERVE_LAYERS)
    paged_engine, launches = paged_engine_phase(dense, card)
    stamp("paged engine")
    reset_counts()
    serve_phase(dense, card)
    dense_launches += flash_attention.launches
    check(dense_launches > 0, "the dense path never launched flash_attention_fwd")
    log(f"dense path: flash_attention_fwd launched {dense_launches} times")
    reset_counts()
    paged_serve_phase(paged_engine, card)
    log(f"paged serve: launches {read_counts()}")
    stamp("serve, paged serve, serving controls")
    # the agent path (counts each of its runs from 0 itself), on the same engines
    launches_a = agent_phase(dense, paged_engine, card)
    log(f"agent path: launches {launches_a}")
    stamp("agent")
    # the agent tools path (counts each of its runs from 0 itself), same engines
    launches_tools = tools_phase(dense, paged_engine, card)
    log(f"agent tools path: launches {launches_tools}")
    stamp("agent tools")
    paged_engine.close()
    # the survival and fleet paths (each counts its runs from 0 itself) on a
    # fresh engine over the same views, the KV path on the first KV_LAYERS
    kv16 = depth(engine, SERVE_LAYERS)
    paged16 = InferenceEngine.from_config(
        kv16.cfg.name, dtype=kv16.dtype, params=kv16.params, max_seq_len=kv16.max_seq_len,
        device=kv16.device, paged=True, batch_size=8, page_size=PAGE, num_layers=SERVE_LAYERS)
    launches_s = survival_phase(kv16, paged16, card)
    paged16.close()
    del paged16
    log(f"survival path: launches {launches_s}")
    stamp("survival")
    # the speculation path (counts each of its runs from 0 itself)
    launches_spec = spec_phase(dense, card)
    log(f"speculation path: launches {launches_spec}")
    stamp("speculation")
    launches_kv = kv_phase(depth(engine, KV_LAYERS), card)
    log(f"kv path: launches {launches_kv}")
    stamp("kv")
    launches_f = fleet_phase(kv16, card)
    del kv16
    log(f"fleet path: launches {launches_f}")
    stamp("fleet")
    for rec in records:
        rec["launches"] = launches[rec["name"]]
        check(rec["launches"] > 0, f"the paged path never launched {rec['name']}")
        # the agent path runs K1 (every prefill), K2 and K3 (its paged turn)
        rec["launches_agent"] = launches_a[rec["name"]]
        check(rec["launches_agent"] > 0, f"the agent path never launched {rec['name']}")
        # the tools path prefills its turns (K1), decodes the paged turns
        # (K2) and merges the 24-tool turn's chunks with free requests (K3)
        rec["launches_tools"] = launches_tools[rec["name"]]
        check(rec["launches_tools"] > 0, f"the agent tools path never launched {rec['name']}")
        # the survival path re-prefills (K1), replays and decodes (K2) and
        # merges fresh admissions with restored decode (K3)
        rec["launches_survival"] = launches_s[rec["name"]]
        check(rec["launches_survival"] > 0, f"the survival path never launched {rec['name']}")
        # the KV path admits densely (K1), decodes and restores (K2) and
        # merges chunks with decode and tier-hit suffixes (K3)
        rec["launches_kv"] = launches_kv[rec["name"]]
        check(rec["launches_kv"] > 0, f"the KV path never launched {rec['name']}")
        # the fleet admits short first turns densely (K1), decodes on both
        # replicas (K2) and merges long prompts' chunks with decode (K3)
        rec["launches_fleet"] = launches_f[rec["name"]]
        check(rec["launches_fleet"] > 0, f"the fleet path never launched {rec['name']}")
        # the speculation path prefills densely (K1) and verifies through
        # K2's block form; one stream merges nothing (K3)
        if launches_spec[rec["name"]]:
            rec["launches_spec"] = launches_spec[rec["name"]]
    check(launches_spec["paged_attention_block"] > 0 and launches_spec["flash_attention_fwd"] > 0,
          f"the speculation path launched {launches_spec}")
    log(f"paged path (main run): launches {launches}")

    # the quantized paths, after the bf16 engines are released
    from fei_tpu_torch.ops.quant import param_bytes

    bf16_bytes = param_bytes(dense.params)
    del engine, dense, paged_engine
    gc.collect()
    torch.cuda.empty_cache()
    dense4 = quant_dense_phase(card, bf16_bytes)
    launches_head = quant_switches_phase(dense4, card)
    launches4 = quant_paged_phase(dense4, card)
    quant_provider_phase(dense4, card)
    int4_record["launches"] = launches4["int4_matmul"]
    # the int4-head engine's generate: K4 on every linear and on the head
    int4_record["launches_int4_head"] = launches_head
    records.append(int4_record)
    log(f"int4 paged path (main run): launches {launches4}")
    stamp("quantized")

    # the MoE path, after the quantized engines are released (counts each
    # of its runs from 0 itself)
    del dense4
    gc.collect()
    torch.cuda.empty_cache()
    launches_moe = moe_phase(card)
    log(f"MoE path: launches {launches_moe}")
    stamp("moe")

    # the training path
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
    stamp("training")
    # the MoE path runs every kernel: K1 (prefills), K2 (paged decode, the
    # block form in chunks), K3 (merged), K4 (int4), K5a/K5b (training)
    for rec in records:
        rec["launches_moe"] = launches_moe[rec["name"]]
        check(rec["launches_moe"] > 0, f"the MoE path never launched {rec['name']}")
    check(launches_moe["paged_attention_block"] > 0, "the MoE path never ran K2's block form")

    # the tensor-parallel path: two ranks of its own (each counts from 0)
    gc.collect()
    torch.cuda.empty_cache()
    launches_tp, launches_par = tp_phase(card)
    for rec in records:
        if rec["name"] in launches_tp:
            rec["launches_tp"] = launches_tp[rec["name"]]
        # per rank: sp (K1 in the short stream's admission, K2 decode), ep
        # (K1-K3), pp (K1) and training (K1, K5a, K5b); K4 runs on none
        if rec["name"] in launches_par and rec["name"] != "int4_matmul":
            rec["launches_parallel"] = launches_par[rec["name"]]
            check(all(n > 0 for n in rec["launches_parallel"]),
                  f"the parallel path never launched {rec['name']} on a rank")
    stamp("tp, parallel")
    log(f"phase seconds on {card}: {json.dumps(phase_s)}; "
        f"in all {time.perf_counter() - t0:.1f} s")

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
