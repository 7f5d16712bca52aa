"""The plain reference: Mistral's and Mixtral's forward in fp32.

Written from the published architecture, in plain PyTorch, with no cache,
no kernel and no batching: RMSNorm, rotary embeddings (split halves),
grouped-query attention with a causal mask and, where the configuration
has one, a sliding window (a query at position p sees keys p - W < j <= p),
a SwiGLU MLP or Mixtral's top-k router over SwiGLU experts (the k largest
router logits, softmax over those k, the k expert outputs summed with
those weights). It imports nothing of the program.

It works layer by layer over a list of sequences, remaking each layer's
tensors from (seed, name) with ``portbench.weights``, so it needs one
layer's weights at a time beside the hidden states. ``precision`` picks
how the weights enter:

- ``"served"``: as the configuration serves them: the bf16 tensors, or for
  an int8 configuration their int8 quantization (done here again) times
  its scales. Everything is then computed in fp32.
- ``"control"``: the step below the configuration's precision, which a
  later change might be tempted to take: fp8 (e4m3, one scale per output
  channel) for a bf16 configuration, int4 (one scale per 128 input rows
  and output channel) for an int8 one.

Matrix products run in true fp32: ``fp32_mode`` turns TF32 off while the
reference runs.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from portbench.spec import Model
from portbench.weights import QUANTIZED, draw, draw_layer

FP8_MAX = 448.0  # e4m3's largest finite value
INT4_GROUP = 128


@contextlib.contextmanager
def fp32_mode():
    """TF32 off for the block (both switches), restored after."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def int8_dequant(w: torch.Tensor) -> torch.Tensor:
    """Symmetric int8, one scale per output channel (over the input axis,
    -2): round(w / s) clipped to +-127, times s, with s = amax / 127."""
    w = w.float()
    amax = w.abs().amax(dim=-2, keepdim=True)
    s = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    return torch.clamp(torch.round(w / s), -127, 127) * s


def int4_dequant(w: torch.Tensor) -> torch.Tensor:
    """Symmetric int4 (+-7), one scale per 128 input rows (all of them
    where there are fewer) and output channel."""
    w = w.float()
    K = w.shape[-2]
    group = min(INT4_GROUP, K)
    g = w.reshape(*w.shape[:-2], K // group, group, w.shape[-1])
    amax = g.abs().amax(dim=-2, keepdim=True)
    s = torch.where(amax == 0, torch.ones_like(amax), amax / 7.0)
    return (torch.clamp(torch.round(g / s), -7, 7) * s).reshape(w.shape)


def fp8_dequant(w: torch.Tensor) -> torch.Tensor:
    """e4m3 with one scale per output channel (amax maps to 448)."""
    w = w.float()
    amax = w.abs().amax(dim=-2, keepdim=True)
    s = torch.where(amax == 0, torch.ones_like(amax), amax / FP8_MAX)
    return (w / s).to(torch.float8_e4m3fn).float() * s


def as_computed(m: Model, leaf: str, w: torch.Tensor, precision: str) -> torch.Tensor:
    """A bf16 tensor as the reference uses it, in fp32."""
    if leaf not in QUANTIZED:
        return w.float()
    if precision == "served":
        return int8_dequant(w) if m.quantize == "int8" else w.float()
    if precision == "control":
        return int4_dequant(int8_dequant(w)) if m.quantize == "int8" else fp8_dequant(w)
    raise ValueError(f"unknown precision {precision!r}")


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x, positions, theta):
    """x [T, n, d]: split-half rotation by position."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = positions.float()[:, None] * inv[None, :]
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(q, k, v, window: int, block: int = 1024):
    """q [T, H, d], k/v [T, K, d] -> [T, H, d]; causal (and windowed),
    queries in blocks of ``block`` so the scores stay small."""
    T, H, d = q.shape
    G = H // k.shape[1]
    k = k.repeat_interleave(G, dim=1)  # query head h reads kv head h // G
    v = v.repeat_interleave(G, dim=1)
    out = torch.empty_like(q)
    pos = torch.arange(T, device=q.device)
    for lo in range(0, T, block):
        hi = min(T, lo + block)
        s = torch.einsum("thd,shd->hts", q[lo:hi], k) * d ** -0.5
        p, j = pos[lo:hi, None], pos[None, :]
        vis = j <= p
        if window:
            vis &= j > p - window
        s = s.masked_fill(~vis[None], float("-inf"))
        out[lo:hi] = torch.einsum("hts,shd->thd", torch.softmax(s, dim=-1), v)
    return out


def mlp(m: Model, y, w):
    if not m.is_moe:
        return (F.silu(y @ w["w_gate"]) * (y @ w["w_up"])) @ w["w_down"]
    logits = y @ w["router"]  # [T, E]
    top, idx = torch.topk(logits, m.top_k, dim=-1)
    gate = torch.softmax(top, dim=-1)
    out = torch.zeros_like(y)
    for e in range(m.experts):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        ye = y[rows]
        h = (F.silu(ye @ w["w_gate"][e]) * (ye @ w["w_up"][e])) @ w["w_down"][e]
        out.index_add_(0, rows, h * gate[rows, slot][:, None])
    return out


def block(m: Model, x, w):
    T = x.shape[0]
    pos = torch.arange(T, device=x.device)
    y = rms_norm(x, w["attn_norm"], m.eps)
    q = rope((y @ w["wq"]).view(T, m.heads, m.head_dim), pos, m.rope_theta)
    k = rope((y @ w["wk"]).view(T, m.kv_heads, m.head_dim), pos, m.rope_theta)
    v = (y @ w["wv"]).view(T, m.kv_heads, m.head_dim)
    x = x + attention(q, k, v, m.window).reshape(T, -1) @ w["wo"]
    return x + mlp(m, rms_norm(x, w["mlp_norm"], m.eps), w)


def logits_at(m: Model, seed: int, seqs: list[list[int]], rows: list[list[int]],
              device, precision: str = "served") -> list[torch.Tensor]:
    """For each token sequence, the fp32 logits [len(rows[i]), V] at the
    positions ``rows[i]`` (the logits there predict the next token)."""
    def weight(name, shape, fan_in, leaf):
        return as_computed(m, leaf, draw(seed, name, shape, fan_in, device), precision)

    with fp32_mode(), torch.no_grad():
        embed = draw(seed, "embed", (m.vocab, m.hidden), m.hidden, device).float()
        xs = [embed[torch.tensor(s, device=device)] for s in seqs]
        del embed
        for i in range(m.layers):
            w = {leaf: as_computed(m, leaf, t, precision)
                 for leaf, t in draw_layer(m, seed, i, device).items()}
            xs = [block(m, x, w) for x in xs]
            del w
        norm = draw(seed, "final_norm", (m.hidden,), None, device).float()
        head = weight("lm_head", (m.hidden, m.vocab), m.hidden, "lm_head")
        return [rms_norm(x[torch.tensor(r, device=device)], norm, m.eps) @ head
                for x, r in zip(xs, rows)]
