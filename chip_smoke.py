#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (fei_tpu_torch) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

1. Card: ``torch.cuda.is_available()`` must be true; prints the card's name
   and power limit as ``nvidia-smi`` reports them.
2. Build: compiles every kernel of the serving path from the sources in
   this checkout (``fei_tpu_torch/csrc/*.cu`` -> ``build/fei_tpu_torch/``).
3. Kernels: holds each kernel against its plain PyTorch version on the card
   at the serving path's shapes and times kernel, plain version, one
   PyTorch library call computing the same function, and the bound.
4. Engine: llama3-8b at full width and depth (32 layers, h=4096, 32/8
   heads, vocab 128256), bf16, random weights from a seed, max_seq_len
   8192. A ~1500-token prefill must launch the flash kernel once per
   layer; its last-position logits are held against the same engine on
   the plain attention; 128 greedy tokens decode chunked (TTFT, tok/s).
5. Serve: the OpenAI-compatible server over the same engine answers
   /health and three /v1/chat/completions (one streamed).

The line before the last two is the kernels' JSON record, the line before
the last is the card, and the last line is the JSON verdict.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import urllib.request

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12

SEED = 0
KERNELS = ["flash_attention_fwd"]


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


def flash_bound_ms(q, k, q_start, kv_length, window):
    """Least time for this call's work: live (query, key) pairs times
    4*D FLOP per head at the bf16 peak, against q + o + the live k/v rows
    at the memory rate; the larger of the two, and which it is."""
    from fei_tpu_torch.ops.attention import visible_mask

    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    pos = q_start.long()[:, None] + torch.arange(T, device=q.device)[None, :]
    vis = visible_mask(pos, kv_length, S, window)  # [B, T, S]
    pairs = int(vis.sum())
    live_keys = int(vis.any(dim=1).sum())
    flops = 4.0 * D * H * pairs
    nbytes = 2.0 * (2 * q.numel() + 2 * live_keys * K * D)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def kernel_phase(card: str) -> dict:
    import torch.nn.functional as F

    from fei_tpu_torch.ops.kernels.flash_attention import (
        flash_attention,
        flash_attention_reference,
        flash_attention_tolerance,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    record = None
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
        if record is None:  # the main shape: time it
            ms = cuda_ms(lambda: flash_attention(q, k, v, qs, kl, window=window))
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
            bound_ms, bound_by = flash_bound_ms(q, k, qs, kl, window)
            log(f"kernel flash_attention_fwd [{label}] on {card}: "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"scaled_dot_product_attention {lib_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by})")
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
            }
        del q, k, v, out, ref
    torch.cuda.empty_cache()
    return record


# ----------------------------------------------------------------- engine

def serving_bounds(cfg, prompt_len: int, new_tokens: int) -> tuple[float, float]:
    """The card's limits for this run's work, at the bf16 and memory peaks:
    the least TTFT (ms) — the larger of the prefill's operations (linear
    layers over the prompt's tokens, causal attention, the LM head for one
    position) and one read of the weights — and the most decode tok/s — one
    read of the weights (not the embedding table, which is gathered) and of
    the live KV per token, at the run's mean context."""
    h, d, L = cfg.hidden_size, cfg.head_dim_, cfg.num_layers
    H, K, I, V = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size, cfg.vocab_size
    per_layer = h * H * d + 2 * h * K * d + H * d * h + 3 * h * I
    head = h * V
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

    t0 = time.perf_counter()
    for name in KERNELS:
        res = build.build(name)
        regs = [ln.strip() for ln in res.log.splitlines() if "registers" in ln]
        log(f"build: {res.name} -> {res.path.name} in {res.seconds:.1f} s; {regs}")
    log(f"build: {time.perf_counter() - t0:.1f} s")

    record = kernel_phase(card)

    from fei_tpu_torch.ops.kernels.flash_attention import flash_attention

    engine = engine_phase(card)
    serve_phase(engine, card)
    record["launches"] = flash_attention.launches
    check(record["launches"] > 0, "the main path never launched flash_attention_fwd")
    log(f"main path: flash_attention_fwd launched {record['launches']} times")

    print(json.dumps({"kernels": [record]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
