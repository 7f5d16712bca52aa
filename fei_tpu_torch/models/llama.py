"""Llama-family decoder, dense (counterpart of fei_tpu/models/llama.py).

The parameters are the JAX package's tree as a plain dict of tensors, with
the per-layer leaves stacked on a leading axis (``params["layers"]["wq"]``
is [L, h, H*d]); linears are stored [in, out] so the forward is ``x @ w``.
``models.convert.params_from_jax`` turns a JAX tree into this one, so both
packages compute the same function on the same weights.

The KV cache is a fixed [L, B, S, K, D] buffer with a per-sequence valid
length; prefill and decode are the same code path with different T. Where
JAX returns an updated cache (donated, so updated in place in HBM), this
forward writes the new K/V into the cache tensors in place and returns a
cache with the advanced length. ``forward_train`` is the cache-free,
differentiable forward of the training path: attention over the
projections themselves, through the flash kernels' autograd function on
the card, each layer recomputed in the backward when ``remat`` is set.

Covered here: GQA, q/k/v/o biases, the Phi parallel block with LayerNorm
and partial rotary, tied and biased LM heads, sliding windows, the Gemma
norm offset / GeGLU / scaled embeddings, weight-only int8 / int4
linears (``ops.quant``: every big linear goes through ``mm``, int4 leaves
through the K4 kernel), and Mixtral-style MoE layers (``_moe``: the dense
oracle or the token-routed form of ``ops.moe``, int8 experts raw with their
scales on the products).

**On a tensor-parallel mesh** (``kernel_mesh``, parallel/mesh.py) each rank
holds its kv heads of the caches and, per leaf, the whole weight or its
slice (parallel/sharding.py); the shape of each leaf says which, as a
GSPMD layout would. Every rank computes the rank's query and kv heads (a
whole projection is computed whole and sliced, so each head is the
one-device value), attends with its heads through the sharded kernel
wrappers, whose outputs come back gathered, and continues with replicated
activations. A row-sharded weight (``wo``, ``w_down``: the Megatron
profile) multiplies the rank's slice of its input and the partial sums are
all_reduced; a vocab-sharded embedding looks up its own rows and
all_reduces, a vocab-sharded LM head all_gathers its logits. The public
forwards are ``parallel.serving`` ops: on rank 0 of a mesh engine they
broadcast their call to the follower ranks.

**On an expert-parallel mesh** a forward given ``moe_mesh`` routes each
MoE layer's tokens to the ranks owning their experts
(``parallel.expert.moe_mlp_ep_routed``); without it, experts a rank holds
a slice of run the dense-local ``moe_mlp_ep``. Sequence parallelism
(parallel/long_prefill.py) and the pipeline (parallel/pipeline.py) reuse
the layer pieces here over their own axes. The collectives carry
autograd, so ``forward_train`` trains a rank's Megatron shards.
"""

from __future__ import annotations

import functools
import os
from types import SimpleNamespace
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from fei_tpu_torch.models.configs import ModelConfig
from fei_tpu_torch.obs.flight import FLIGHT
from fei_tpu_torch.ops.attention import attention
from fei_tpu_torch.ops.kernels.flash_attention import flash_attention
from fei_tpu_torch.ops.moe import moe_mlp, moe_mlp_routed
from fei_tpu_torch.ops.quant import (
    QTensor,
    QTensor4,
    _int4_ok,
    embed_lookup,
    mm,
    quantize as _quantize8,
    quantize4 as _quantize4,
    quant_embed_from_env,
    quantize_embed,
    stack_layers,
    tied_logits,
)
from fei_tpu_torch.ops.rmsnorm import rms_norm
from fei_tpu_torch.ops.rope import apply_rope, compute_rope_freqs
from fei_tpu_torch.parallel.serving import spmd_op
from fei_tpu_torch.utils.errors import TrainingError

_FLASH_MIN_T = 64  # below this, the plain path (decode is T = 1)
_ROUTED_MIN_TOKENS = 16  # below this, the sort and gather outweigh the k/E saving


class KVCache(NamedTuple):
    """Static-shape KV cache. k/v: [L, B, S, K, D]; length: [B] int32."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor

    @classmethod
    def create(
        cls, cfg: ModelConfig, batch: int, max_seq: int,
        dtype=torch.bfloat16, device: torch.device | str = "cpu",
        shape: tuple | None = None,
    ) -> "KVCache":
        """A zeroed cache; ``shape`` overrides the K/V shape (a rank's
        shard: its rows and kv heads). ``length`` always covers ``batch``."""
        shape = shape or (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim_)
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            length=torch.zeros((batch,), dtype=torch.int32, device=device),
        )


QUANT_MODES = (None, "int8", "int4")


def init_params(
    cfg: ModelConfig,
    seed: int = 0,
    dtype=torch.bfloat16,
    device: torch.device | str = "cpu",
    quantize: str | None = None,
    int4_lm_head: bool | None = None,
    quant_embed: bool | None = None,
    int4_exclude: frozenset = frozenset(),
) -> dict:
    """Random-init parameter dict (layers stacked on axis 0), made on
    ``device`` from ``seed``: normal(0, fan_in^-1/2) linears and embeddings,
    identity norms, zero biases — the JAX package's scheme, not its numbers
    (the two generators differ; tests share weights via convert).

    ``quantize="int8"|"int4"`` quantizes each big linear as it is drawn
    (drawn in fp32, rounded to ``dtype``, then quantized, one layer at a
    time so the fp32 transient stays one layer big): int4 where
    ``ops.quant._int4_ok`` allows it (``int4_lm_head`` opts the LM head
    in), int8 elsewhere and for the leaves named in ``int4_exclude`` (a tp
    mesh's row-parallel ``wo``/``w_down``). ``quant_embed`` (with a mode)
    row-quantizes the embedding table to int8. Either switch left None
    reads the JAX package's variable, as its ``init_params`` does
    (``FEI_TPU_QUANT_EMBED`` here, ``FEI_TPU_INT4_LM_HEAD`` in ``_int4_ok``). MoE configs draw ``router`` [L, h, E] and the
    stacked experts ``w_gate``/``w_up`` [L, E, h, I] and ``w_down``
    [L, E, I, h] (int8 under either mode), one layer's [E, in, out] at a
    time."""
    if quantize not in QUANT_MODES:
        raise ValueError(f"unsupported quantize mode {quantize!r}; one of {QUANT_MODES}")
    if quant_embed is None:
        quant_embed = quant_embed_from_env()
    # the meta device (shapes only) draws nothing and has no generator
    gen = (None if torch.device(device).type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    h, d = cfg.hidden_size, cfg.head_dim_
    H, K, I, L = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size, cfg.num_layers

    def draw(shape, fan_in):
        return (torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
                * (fan_in ** -0.5)).to(dtype)

    def init(shape, fan_in, name=None):
        """A leaf drawn one slice at a time (the fp32 transient stays one
        slice big), quantized when ``name`` is a big linear and a mode is
        set; the draws are the same in every mode."""
        quant = None
        if name is not None and quantize is not None:
            int4 = quantize == "int4" and name not in int4_exclude and _int4_ok(
                name, SimpleNamespace(shape=shape), cfg.is_moe, int4_lm_head)
            quant = _quantize4 if int4 else _quantize8
        if quant is None or len(shape) == 2:
            out = torch.empty(shape, dtype=dtype, device=device)
            for i in range(shape[0] if gen is not None else 0):
                out[i] = draw(shape[1:], fan_in)
            return out if quant is None else quant(out)
        return stack_layers(shape[0], lambda i: quant(draw(shape[1:], fan_in)))

    def const(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    norm = 0.0 if cfg.norm_offset else 1.0  # Gemma multiplies by (1 + w)
    layers = {
        "attn_norm": const((L, h), norm),
        "wq": init((L, h, H * d), h, "wq"),
        "wk": init((L, h, K * d), h, "wk"),
        "wv": init((L, h, K * d), h, "wv"),
        "wo": init((L, H * d, h), H * d, "wo"),
    }
    if not cfg.parallel_block:
        layers["mlp_norm"] = const((L, h), norm)
    if cfg.norm_kind == "layernorm":
        layers["attn_norm_b"] = const((L, h), 0.0)
        if not cfg.parallel_block:
            layers["mlp_norm_b"] = const((L, h), 0.0)
    if cfg.attn_bias:
        layers.update(
            bq=const((L, H * d), 0.0), bk=const((L, K * d), 0.0),
            bv=const((L, K * d), 0.0),
        )
    if cfg.o_bias:
        layers["bo"] = const((L, h), 0.0)
    if cfg.is_moe:
        E = cfg.num_experts
        layers.update(
            router=init((L, h, E), h),
            w_gate=init((L, E, h, I), h, "w_gate"),
            w_up=init((L, E, h, I), h, "w_up"),
            w_down=init((L, E, I, h), I, "w_down"),
        )
    else:
        layers["w_gate"] = init((L, h, I), h, "w_gate")
        if cfg.mlp_gated:
            layers["w_up"] = init((L, h, I), h, "w_up")
        elif cfg.mlp_bias:
            layers.update(b_gate=const((L, I), 0.0), b_down=const((L, h), 0.0))
        layers["w_down"] = init((L, I, h), I, "w_down")
    embed = init((cfg.vocab_size, h), h)
    params = {
        "embed": quantize_embed(embed) if quantize and quant_embed else embed,
        "layers": layers,
        "final_norm": const((h,), norm),
    }
    if cfg.norm_kind == "layernorm":
        params["final_norm_b"] = const((h,), 0.0)
    if not cfg.tie_embeddings:
        params["lm_head"] = init((h, cfg.vocab_size), h, "lm_head")
        if cfg.lm_head_bias:
            params["lm_head_b"] = const((cfg.vocab_size,), 0.0)
    return params


def _norm(x, w, cfg: ModelConfig, b=None):
    """RMSNorm (Llama families) or LayerNorm with bias (Phi family,
    cfg.norm_kind == "layernorm"; ``b`` is the bias leaf or None)."""
    if cfg.norm_kind == "layernorm":
        xf = x.float()
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.rms_norm_eps) * w.float()
        if b is not None:
            y = y + b.float()
        return y.to(x.dtype)
    return rms_norm(x, w, cfg.rms_norm_eps, offset=cfg.norm_offset)


def _rope(x, cos, sin, positions, rope_dim: int):
    """apply_rope over the first ``rope_dim`` head dims (Phi partial
    rotary; the rest pass through), or the whole head."""
    if rope_dim and rope_dim != x.shape[-1]:
        return torch.cat(
            [apply_rope(x[..., :rope_dim], cos, sin, positions), x[..., rope_dim:]],
            dim=-1,
        )
    return apply_rope(x, cos, sin, positions)


def _mlp_act(cfg: ModelConfig, gate):
    """SwiGLU (silu) for the Llama/Qwen families, GeGLU with the tanh
    approximation for Gemma and Phi (cfg.hidden_act == "gelu")."""
    if cfg.hidden_act == "gelu":
        return F.gelu(gate, approximate="tanh")
    return F.silu(gate)


def _tp(mesh) -> tuple[int, int]:
    """(tp size, this rank's tp coordinate); (1, 0) without a mesh."""
    if mesh is None:
        return 1, 0
    return mesh.shape["tp"], mesh.coords["tp"]


def _dims(w) -> tuple[int, int]:
    """A linear leaf's (in, out) extent: plain, int8 or nibble-packed int4."""
    if isinstance(w, QTensor4):
        return 2 * w.p.shape[-2], w.p.shape[-1]
    t = w.q if isinstance(w, QTensor) else w
    return t.shape[-2], t.shape[-1]


def _local(x, full: int, dim: int, mesh):
    """The rank's 1/tp slice of ``x`` along ``dim`` when ``x`` is whole
    there (extent ``full``); an already-local ``x`` passes."""
    tp, r = _tp(mesh)
    if tp == 1 or x.shape[dim] != full:
        return x
    step = full // tp
    return x.narrow(dim, r * step, step)


def _mm_k(x, w, kernel_mesh=None, full_out: int | None = None):
    """``mm``, except that a whole int4 leaf under a tp mesh runs the
    column-sharded K4 wrapper (each rank its columns, gathered): the
    reference's ``_mm_k``. A leaf already sharded over its columns (the
    Megatron profile) multiplies locally."""
    if (kernel_mesh is not None and isinstance(w, QTensor4)
            and _tp(kernel_mesh)[0] > 1 and w.p.shape[-1] == full_out):
        from fei_tpu_torch.ops.kernels.int4_matmul import int4_mm_sharded

        return int4_mm_sharded(x, w, kernel_mesh)
    return mm(x, w)


def _row_mm(x, w, full_in: int, mesh):
    """A row-parallel linear (``wo``, ``w_down``): a whole weight multiplies
    ``x`` whole; a weight sharded over its input rows (the Megatron
    profile) multiplies the rank's slice of ``x``, and the partial sums are
    all_reduced over tp."""
    if _dims(w)[0] == full_in:
        return mm(x, w)
    return mesh.all_reduce(mm(_local(x, full_in, -1, mesh), w), "tp")


def _mlp_dense(cfg: ModelConfig, y, lp, kernel_mesh=None):
    """Gated MLP (w_gate*w_up -> w_down), or Phi's fc1 -> act -> fc2 with
    biases (cfg.mlp_gated=False; fc1/fc2 live in the w_gate/w_down leaves)."""
    I = cfg.intermediate_size
    if kernel_mesh is not None and _dims(lp["w_gate"])[1] != I:
        y = kernel_mesh.sum_grad(y, "tp")  # column-sharded: each rank its share of dy
    if not cfg.mlp_gated:
        a = _mm_k(y, lp["w_gate"], kernel_mesh, I)
        if "b_gate" in lp:
            a = a + lp["b_gate"]
        out = _row_mm(_mlp_act(cfg, a.float()).to(y.dtype), lp["w_down"], I, kernel_mesh)
        if "b_down" in lp:
            out = out + lp["b_down"]
        return out
    act = _mlp_act(cfg, _mm_k(y, lp["w_gate"], kernel_mesh, I).float()).to(y.dtype)
    return _row_mm(act * _mm_k(y, lp["w_up"], kernel_mesh, I), lp["w_down"], I, kernel_mesh)


def _moe(cfg: ModelConfig, y, lp, allow_routed: bool, moe_mesh=None):
    """Pick the MoE formulation, as the JAX package does. With an ``ep``
    mesh (``moe_mesh``), tokens route to the ranks that own their experts
    (``parallel.expert.moe_mlp_ep_routed``: dispatch and combine masks, two
    all_to_alls, tp-composed), at ``FEI_TPU_EP_CAPACITY`` — ``dropless``
    (exact, worst-case buffers) or a capacity factor (default 2.0: assignments
    beyond twice the balanced load are dropped, GShard's serving trade).
    On one device ``FEI_TPU_ROUTED_MOE=1`` forces the token-routed form,
    ``0`` the dense oracle everywhere (on an ep mesh too), and the default
    ``auto`` routes when the caller allows it and the forward carries at
    least ``_ROUTED_MIN_TOKENS`` tokens."""
    mode = os.environ.get("FEI_TPU_ROUTED_MOE", "auto")
    args = (y, lp["router"], lp["w_gate"], lp["w_up"], lp["w_down"],
            cfg.num_experts_per_tok)
    if mode != "0" and moe_mesh is not None and moe_mesh.shape.get("ep", 1) > 1:
        from fei_tpu_torch.parallel.expert import moe_mlp_ep_routed

        tp = "tp" if moe_mesh.shape.get("tp", 1) > 1 else None
        cap = os.environ.get("FEI_TPU_EP_CAPACITY", "2.0")
        kw = dict(tp_axis=tp, intermediate_size=cfg.intermediate_size)
        if cap == "dropless":
            return moe_mlp_ep_routed(*args, moe_mesh, dropless=True, **kw)
        return moe_mlp_ep_routed(*args, moe_mesh, capacity_factor=float(cap), **kw)
    N = y.shape[0] * y.shape[1]
    use_routed = mode == "1" or (
        mode == "auto" and allow_routed and N >= _ROUTED_MIN_TOKENS)
    fn = moe_mlp_routed if use_routed else moe_mlp
    return fn(*args)


def _experts_split(cfg: ModelConfig, lp) -> bool:
    """True when this rank holds a slice of the experts: some of them (ep)
    or part of each one's intermediate dim (tp, the Megatron profile)."""
    w = lp["w_down"]
    t = w.q if isinstance(w, QTensor) else w
    return t.shape[0] != cfg.num_experts or t.shape[1] != cfg.intermediate_size


def _mlp(cfg: ModelConfig, y, lp, allow_routed: bool, kernel_mesh=None, moe_mesh=None):
    """The block's MLP: the MoE layer or the dense one. An ep mesh routes
    tokens (``_moe``); without one, experts that this rank holds a slice
    of (ep-sliced, or tp-split over their intermediate dim) run the
    dense-local expert-parallel form, ``parallel.expert.moe_mlp_ep``: the
    reference's oracle over sharded leaves, its partial sums all_reduced.
    While the flight recorder captures, a ``model.mlp`` range, or a
    device-timed ``model.moe`` one."""
    if not FLIGHT.capturing:
        return _mlp_block(cfg, y, lp, allow_routed, kernel_mesh, moe_mesh)
    r = FLIGHT.open("model.moe" if cfg.is_moe else "model.mlp", device=cfg.is_moe)
    out = _mlp_block(cfg, y, lp, allow_routed, kernel_mesh, moe_mesh)
    FLIGHT.close(r)
    return out


def _mlp_block(cfg: ModelConfig, y, lp, allow_routed: bool, kernel_mesh, moe_mesh):
    if not cfg.is_moe:
        return _mlp_dense(cfg, y, lp, kernel_mesh)
    routes = (moe_mesh is not None and moe_mesh.shape.get("ep", 1) > 1
              and os.environ.get("FEI_TPU_ROUTED_MOE", "auto") != "0")
    mesh = kernel_mesh if kernel_mesh is not None else moe_mesh
    if not routes and mesh is not None and _experts_split(cfg, lp):
        from fei_tpu_torch.parallel.expert import moe_mlp_ep

        return moe_mlp_ep(y, lp["router"], lp["w_gate"], lp["w_up"], lp["w_down"],
                          cfg.num_experts_per_tok, mesh,
                          intermediate_size=cfg.intermediate_size)
    return _moe(cfg, y, lp, allow_routed, moe_mesh)


def model_dtype(params: dict):
    """The compute dtype, read from a leaf that is never quantized (a
    row-quantized embed table's ``dtype`` is its fp32 scale's)."""
    return params["layers"]["attn_norm"].dtype


def layer_params(params: dict, i: int) -> dict:
    """Layer i's leaves; a quantized leaf is sliced field by field (indexing
    the NamedTuple itself would pick a field, not a layer)."""
    return {
        name: type(leaf)(*(f[i] for f in leaf)) if isinstance(leaf, (QTensor, QTensor4))
        else leaf[i]
        for name, leaf in params["layers"].items()
    }


def embed_tokens(params: dict, cfg: ModelConfig, tokens, dtype, kernel_mesh=None):
    """Embedding lookup (plain or row-quantized table); Gemma scales by
    sqrt(hidden_size) in the compute dtype. A vocab-sharded table (the
    Megatron profile) looks up the ids in its own rows, zeros elsewhere,
    and all_reduces over tp: one rank adds each row, so the sum is exact."""
    table = params["embed"]
    rows = (table.q if isinstance(table, QTensor) else table).shape[0]
    if rows == cfg.vocab_size:
        x = embed_lookup(table, tokens, dtype)
    else:
        idx = tokens - _tp(kernel_mesh)[1] * rows
        own = (idx >= 0) & (idx < rows)
        x = embed_lookup(table, idx.clamp(0, rows - 1), dtype)
        x = kernel_mesh.all_reduce(torch.where(own[..., None], x, torch.zeros_like(x)), "tp")
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=dtype)
    return x


def qkv_proj(lp, y, Hq: int, K: int, d: int, kernel_mesh=None):
    """y -> (q [B,T,Hq,d], k [B,T,K,d], v [B,T,K,d]) with the qkv biases
    when the layer carries them. Under a tp mesh, the rank's Hq/tp query
    and K/tp kv heads: a whole projection is computed whole and sliced,
    so each head is the one-device value."""
    B, T, _ = y.shape
    q = _mm_k(y, lp["wq"], kernel_mesh, Hq * d)
    k = _mm_k(y, lp["wk"], kernel_mesh, K * d)
    v = _mm_k(y, lp["wv"], kernel_mesh, K * d)
    if "bq" in lp:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = _local(q, Hq * d, -1, kernel_mesh)
    k, v = _local(k, K * d, -1, kernel_mesh), _local(v, K * d, -1, kernel_mesh)
    return q.reshape(B, T, -1, d), k.reshape(B, T, -1, d), v.reshape(B, T, -1, d)


def _among_zeros(x, mesh):
    """[B, T, n, D] of this rank's heads -> [B, T, n*tp, D]: zeros with
    ``x`` at the rank's block of heads."""
    tp, r = _tp(mesh)
    n = x.shape[2]
    out = x.new_zeros(*x.shape[:2], n * tp, x.shape[3])
    out[:, :, r * n:(r + 1) * n] = x
    return out


def _attend(q, k, v, kv_length, positions, window: int = 0, flash: bool | None = None,
            mesh=None):
    """Pick the attention path: with ``flash`` None, the flash kernel for
    prefill-sized T on the card and the plain path otherwise; True forces
    the flash wrapper (on CPU tensors that is its plain version), False the
    plain path. ``kv_length`` is the pre-write cache length [B]; keys are
    valid below kv_length + T. Under a tp mesh ``q``/``k``/``v`` hold the
    rank's heads: the flash kernel computes each head alone, but the plain
    path's einsums go to library GEMMs that pick their algorithm by shape,
    so there the rank's heads sit among zeros at the one-device shapes,
    which keeps each head's values the one-device values, and the rank's
    heads are sliced back out."""
    T = q.shape[1]
    if flash or (flash is None and T >= _FLASH_MIN_T and q.is_cuda):
        return flash_attention(q, k, v, kv_length, kv_length + T, window=window)
    tp, r = _tp(mesh)
    if tp > 1:
        n = q.shape[2]
        out = attention(*(_among_zeros(x, mesh) for x in (q, k, v)), positions,
                        kv_length + T, window=window)
        return out[:, :, r * n:(r + 1) * n]
    return attention(q, k, v, positions, kv_length + T, window=window)


def _write_kv(buf, new, positions, live):
    """Write new [B,T,K,D] into buf [B,S,K,D] at each row's positions, in
    place. Rows with ``live`` False keep the slot's old contents, so a
    finished sequence's cache is unchanged (no host sync needed)."""
    B, T = positions.shape
    rows = torch.arange(B, device=buf.device)[:, None].expand(B, T)
    if live is not None:
        new = torch.where(live[:, None, None, None], new, buf[rows, positions])
    buf[rows, positions] = new


def _layer(cfg: ModelConfig, x, lp, cache_k, cache_v, kv_length, positions,
           cos, sin, live=None, flash=None, allow_routed=False, kernel_mesh=None,
           moe_mesh=None):
    """One decoder block. x: [B,T,h]; cache_k/v: this layer's [B,S,K,D],
    written in place, or None for the cache-free training path (attention
    over the [B,T,K,D] projections themselves). ``allow_routed`` lets an
    MoE layer take the token-routed form (``_moe``). Under a mesh the
    cache holds the rank's kv heads (and, where the batch divides dp, its
    rows): it attends with those, and the heads and rows are gathered.
    ``moe_mesh`` is ``_moe``'s expert-parallel mesh. Under autograd on a
    tp mesh the gradient of the attention input sums over tp (each rank
    attends with its own heads). Returns x_out."""
    B, T, _ = x.shape
    K, d, Hq = cfg.num_kv_heads, cfg.head_dim_, cfg.num_heads

    cap = FLIGHT.capturing
    if cap:
        ra = FLIGHT.open("model.attn")
    y = _norm(x, lp["attn_norm"], cfg, b=lp.get("attn_norm_b"))
    yq = y if kernel_mesh is None else kernel_mesh.sum_grad(y, "tp")
    q, k, v = qkv_proj(lp, yq, Hq, K, d, kernel_mesh)
    q = _rope(q, cos, sin, positions, cfg.rope_dim_)
    k = _rope(k, cos, sin, positions, cfg.rope_dim_)
    rows = None
    if cache_k is None:
        cache_k, cache_v = k, v
    else:
        if cache_k.shape[0] != B:  # the rank's dp rows of the batch
            n = cache_k.shape[0]
            rows = slice(kernel_mesh.coords["dp"] * n, (kernel_mesh.coords["dp"] + 1) * n)
            q, k, v, kv_length, positions = (t[rows] for t in (q, k, v, kv_length, positions))
            live = None if live is None else live[rows]
        _write_kv(cache_k, k, positions, live)
        _write_kv(cache_v, v, positions, live)

    attn = _attend(q, cache_k, cache_v, kv_length, positions,
                   window=cfg.sliding_window or 0, flash=flash, mesh=kernel_mesh)
    if kernel_mesh is not None:
        attn = kernel_mesh.all_gather(attn, "tp", dim=2)
        if rows is not None:
            attn = kernel_mesh.all_gather(attn, "dp", dim=0)
    if cap:
        FLIGHT.close(ra)
    return _block_tail(cfg, lp, x, y, attn, allow_routed, kernel_mesh, moe_mesh)


@spmd_op
def _logits(x, params, cfg: ModelConfig, kernel_mesh=None) -> torch.Tensor:
    """LM head in fp32: tied (through the plain or row-quantized embed
    table) or its own, biased for Phi. A vocab-sharded head (the Megatron
    profile) all_gathers each rank's logits."""
    V = cfg.vocab_size
    if kernel_mesh is not None and _head_rows(params, cfg) != V:
        x = kernel_mesh.sum_grad(x, "tp")  # vocab-sharded: each rank its share of dx
    if cfg.tie_embeddings:
        out = tied_logits(x, params["embed"])
    else:
        out = _mm_k(x, params["lm_head"], kernel_mesh, V).float()
        if "lm_head_b" in params:
            out = out + params["lm_head_b"].float()
    if out.shape[-1] != V:
        out = kernel_mesh.all_gather(out, "tp", dim=-1)
    return out


def _head_rows(params: dict, cfg: ModelConfig) -> int:
    """The vocab rows of the LM head this rank holds (all V unless the
    Megatron profile split them over tp)."""
    if cfg.tie_embeddings:
        t = params["embed"]
        return (t.q if isinstance(t, QTensor) else t).shape[0]
    return _dims(params["lm_head"])[1]


@functools.lru_cache(maxsize=16)
def _rope_tables(dim: int, max_seq: int, theta: float, device: str):
    return compute_rope_freqs(dim, max_seq, theta, device=device)


@spmd_op
@torch.no_grad()
def forward(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, T] int
    cache: KVCache,
    lm_head: bool = True,
    live: torch.Tensor | None = None,
    flash: bool | None = None,
    routed_moe: bool = False,
    moe_mesh=None,
    kernel_mesh=None,
) -> tuple[torch.Tensor, KVCache]:
    """Run T tokens through the model against the cache.

    Serves prefill (T = prompt chunk) and decode (T = 1) identically.
    Returns (logits [B, T, V] fp32, cache with length += T); K/V are
    written into ``cache.k``/``cache.v`` in place. ``lm_head=False``
    returns the final-norm hidden states [B, T, h] instead of logits.
    ``live`` ([B] bool, optional) freezes finished rows: their KV slots
    keep their contents and their length does not advance. ``flash``
    picks the attention path (``_attend``): None chooses by T and device.
    ``routed_moe`` lets MoE layers take the token-routed form and
    ``moe_mesh`` (an ep mesh) the expert-parallel one (``_moe``).
    ``kernel_mesh``: this rank's mesh (see the module docstring).
    While the flight recorder captures, the call is a ``model.forward``
    range, its final norm and head a ``model.head`` one.
    """
    B, T = tokens.shape
    cap = FLIGHT.capturing
    if cap:
        rf = FLIGHT.open("model.forward", tokens=B * T)
    tokens = tokens.to(device=cache.k.device, dtype=torch.long)
    positions = (
        cache.length.to(torch.long)[:, None]
        + torch.arange(T, device=cache.k.device)[None, :]
    )
    cos, sin = _rope_tables(
        cfg.rope_dim_, cache.k.shape[2], float(cfg.rope_theta), str(cache.k.device)
    )
    x = embed_tokens(params, cfg, tokens, cache.k.dtype, kernel_mesh)
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        x = _layer(cfg, x, lp, cache.k[i], cache.v[i], cache.length, positions,
                   cos, sin, live=live, flash=flash, allow_routed=routed_moe,
                   kernel_mesh=kernel_mesh, moe_mesh=moe_mesh)
    if cap:
        rh = FLIGHT.open("model.head")
    x = _norm(x, params["final_norm"], cfg, b=params.get("final_norm_b"))
    step = T if live is None else live.to(torch.int32) * T
    new_cache = KVCache(k=cache.k, v=cache.v, length=cache.length + step)
    out = _logits(x, params, cfg, kernel_mesh=kernel_mesh) if lm_head else x
    if cap:
        FLIGHT.close(rh)
        FLIGHT.close(rf)
    return out, new_cache


def check_trainable(node, path: str = "params") -> None:
    """Quantized leaves carry no gradient (int8 values, as JAX's ``grad``
    refuses them too): raise naming the first one found."""
    if isinstance(node, (QTensor, QTensor4)):
        raise TrainingError(
            f"{path} is a {type(node).__name__}: quantized weights carry no "
            "gradient; train the unquantized parameters")
    if isinstance(node, dict):
        for key, leaf in node.items():
            check_trainable(leaf, f"{path}[{key!r}]")


def forward_train(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, T] int
    remat: bool = True,
    flash: bool | None = None,
    layer_leaves=None,
    kernel_mesh=None,
) -> torch.Tensor:
    """Cache-free forward for training and fine-tuning: full causal
    attention over the sequence at positions ``arange(T)``, differentiable
    in every leaf of ``params``. ``remat`` recomputes each layer in the
    backward (``torch.utils.checkpoint``) instead of keeping its
    activations. ``flash`` picks the attention path (``_attend``): None
    takes the flash kernels' autograd function for T >= 64 on the card.
    ``layer_leaves`` (a sequence of one dict per layer) stands in for
    ``layer_params(params, i)``: the train step passes each layer's leaves
    as autograd leaves of their own over the stacked storage.
    MoE layers take the dense oracle unless ``FEI_TPU_ROUTED_MOE=1``;
    experts sliced over ep (or tp) take its expert-parallel form,
    ``parallel.expert.moe_mlp_ep``. ``kernel_mesh``: this rank's mesh when
    ``params`` hold its Megatron shards (training on tp and ep meshes;
    the collectives carry the gradient, ``parallel.mesh``).
    Returns logits [B, T, V] fp32."""
    check_trainable(params)
    B, T = tokens.shape
    dtype = model_dtype(params)
    dev = params["final_norm"].device
    tokens = tokens.to(device=dev, dtype=torch.long)
    positions = torch.arange(T, device=dev)[None, :].expand(B, T)
    cos, sin = _rope_tables(cfg.rope_dim_, T, float(cfg.rope_theta), str(dev))
    kv_length = torch.zeros((B,), dtype=torch.int32, device=dev)
    x = embed_tokens(params, cfg, tokens, dtype, kernel_mesh)
    for i in range(cfg.num_layers):
        lp = layer_params(params, i) if layer_leaves is None else layer_leaves[i]
        args = (cfg, x, lp, None, None, kv_length, positions, cos, sin, None, flash,
                False, kernel_mesh)
        if remat:  # the layer draws no random numbers: no generator state to carry
            x = checkpoint(_layer, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            x = _layer(*args)
    x = _norm(x, params["final_norm"], cfg, b=params.get("final_norm_b"))
    return _logits(x, params, cfg, kernel_mesh=kernel_mesh)


# ---------------------------------------------------------------- paged


def _paged_dtype(params: dict, cache):
    """Activations run in the pool's dtype, or the weights' for int8 pools."""
    return model_dtype(params) if cache.k_scales is not None else cache.k_pages.dtype


def _layer_pools(cache, i: int):
    ks = None if cache.k_scales is None else cache.k_scales[i]
    vs = None if cache.v_scales is None else cache.v_scales[i]
    return cache.k_pages[i], cache.v_pages[i], ks, vs


def _paged_rope_tables(cfg: ModelConfig, cache):
    max_pos = cache.block_table.shape[1] * cache.page_size
    return _rope_tables(cfg.rope_dim_, max_pos, float(cfg.rope_theta),
                        str(cache.k_pages.device))


def _qkv_roped(cfg: ModelConfig, lp, x, positions, cos, sin, kernel_mesh=None):
    """attention norm, q/k/v projections and rope for one side's tokens."""
    y = _norm(x, lp["attn_norm"], cfg, b=lp.get("attn_norm_b"))
    q, k, v = qkv_proj(lp, y, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_, kernel_mesh)
    q = _rope(q, cos, sin, positions, cfg.rope_dim_)
    k = _rope(k, cos, sin, positions, cfg.rope_dim_)
    return y, q, k, v


def _block_tail(cfg: ModelConfig, lp, x, y, attn, allow_routed: bool = False,
                kernel_mesh=None, moe_mesh=None):
    """Output projection, residual and MLP of one decoder block; ``attn``
    holds every head."""
    B, T = x.shape[:2]
    HD = cfg.num_heads * cfg.head_dim_
    o = _row_mm(attn.reshape(B, T, HD), lp["wo"], HD, kernel_mesh)
    if "bo" in lp:
        o = o + lp["bo"]
    if cfg.parallel_block:  # Phi: x + attn(ln x) + mlp(ln x)
        return x + o + _mlp(cfg, y, lp, allow_routed, kernel_mesh, moe_mesh)
    x = x + o
    y = _norm(x, lp["mlp_norm"], cfg, b=lp.get("mlp_norm_b"))
    return x + _mlp(cfg, y, lp, allow_routed, kernel_mesh, moe_mesh)


@torch.no_grad()
def forward_paged(params: dict, cfg: ModelConfig, tokens: torch.Tensor, cache,
                  routed_moe: bool = False, moe_mesh=None, kernel_mesh=None):
    """Single-token decode against a paged KV cache (``PagedKVCache``,
    engine/paged_cache.py): the T = 1 case of ``forward_paged_block``.
    Returns (logits [B, 1, V], cache with lengths += 1)."""
    return forward_paged_block(params, cfg, tokens, cache, routed_moe=routed_moe,
                               moe_mesh=moe_mesh, kernel_mesh=kernel_mesh)


def _sharded_attention(kernel_mesh) -> bool:
    """The paged forwards attend through the sharded wrappers when the
    mesh splits kv heads (tp) or rows (dp)."""
    return kernel_mesh is not None and (
        kernel_mesh.shape["tp"] > 1 or kernel_mesh.shape["dp"] > 1)


@spmd_op
@torch.no_grad()
def forward_paged_block(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, T] int
    cache,  # PagedKVCache
    lm_head: bool = True,
    routed_moe: bool = False,
    moe_mesh=None,
    kernel_mesh=None,
):
    """T tokens per row through the model against the paged pool: K/V of
    all T positions are written into the rows' pages (one indexed write
    per pool and layer), then attention reads through the block table —
    the paged decode kernel (K2) with one query position for T = 1, its
    block form for T > 1. ``lm_head=False`` returns the final-normed
    hidden states [B, T, h] (the chunk body of paged-native prefill);
    ``routed_moe`` lets MoE layers take the token-routed form, ``moe_mesh``
    the expert-parallel one. Under a
    mesh (``kernel_mesh``) the pool holds the rank's kv heads and the
    attention goes through ``paged_attention[_block]_sharded``.
    Returns (out, cache with lengths += T); the pools change in place.
    While the flight recorder captures, the call is a ``model.forward``
    range holding each layer's ``model.attn`` (projections, K/V write,
    attention) and MLP range, and ``model.head``."""
    from fei_tpu_torch.engine.paged_cache import write_token_kv
    from fei_tpu_torch.ops.kernels.paged_attention import (
        paged_attention,
        paged_attention_block,
        paged_attention_block_sharded,
        paged_attention_sharded,
    )

    B, T = tokens.shape
    cap = FLIGHT.capturing
    if cap:
        rf = FLIGHT.open("model.forward", tokens=B * T)
    dev = cache.k_pages.device
    tokens = tokens.to(device=dev, dtype=torch.long)
    cos, sin = _paged_rope_tables(cfg, cache)
    # the pad tail of a chunk may run past the table (its K/V land in the
    # null page, its rows are never read): clamp as the JAX gather does
    positions = (cache.lengths.long()[:, None]
                 + torch.arange(T, device=dev)[None, :]).clamp(max=cos.shape[0] - 1)
    win = cfg.sliding_window or 0
    limits = (cache.lengths + 1).to(torch.int32)
    sharded = _sharded_attention(kernel_mesh)
    x = embed_tokens(params, cfg, tokens, _paged_dtype(params, cache), kernel_mesh)
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        kp, vp, ks, vs = _layer_pools(cache, i)
        if cap:
            ra = FLIGHT.open("model.attn")
        y, q, k, v = _qkv_roped(cfg, lp, x, positions, cos, sin, kernel_mesh)
        write_token_kv(kp, vp, k, v, cache.block_table, cache.lengths, ks, vs)
        if T == 1 and sharded:
            attn = paged_attention_sharded(q[:, 0], kp, vp, cache.block_table, limits,
                                           kernel_mesh, k_scales=ks, v_scales=vs,
                                           window=win)[:, None]
        elif T == 1:
            attn = paged_attention(q[:, 0], kp, vp, cache.block_table, limits,
                                   k_scales=ks, v_scales=vs, window=win)[:, None]
        elif sharded:
            attn = paged_attention_block_sharded(q, kp, vp, cache.block_table,
                                                 cache.lengths, kernel_mesh, k_scales=ks,
                                                 v_scales=vs, window=win)
        else:
            attn = paged_attention_block(q, kp, vp, cache.block_table, cache.lengths,
                                         k_scales=ks, v_scales=vs, window=win)
        if cap:
            FLIGHT.close(ra)
        x = _block_tail(cfg, lp, x, y, attn, routed_moe, kernel_mesh, moe_mesh)
    if cap:
        rh = FLIGHT.open("model.head")
    x = _norm(x, params["final_norm"], cfg, b=params.get("final_norm_b"))
    new_cache = cache._replace(lengths=(cache.lengths + T).to(torch.int32))
    out = _logits(x, params, cfg, kernel_mesh=kernel_mesh) if lm_head else x
    if cap:
        FLIGHT.close(rh)
        FLIGHT.close(rf)
    return out, new_cache


@spmd_op
@torch.no_grad()
def forward_paged_merged(
    params: dict,
    cfg: ModelConfig,
    chunk_toks: torch.Tensor,  # [1, C] one prefill chunk
    chunk_row: torch.Tensor,  # [1, max_pages] the admitting slot's table row
    chunk_pos: int,  # the chunk's absolute start position
    dec_tokens: torch.Tensor,  # [B, 1] one decode token per slot
    cache,  # PagedKVCache under the LIVE table/lengths
    rows: int = 8,
    routed_moe: bool = False,
    moe_mesh=None,
    kernel_mesh=None,
):
    """One dispatch serves a prefill chunk AND a decode step. Per layer the
    chunk's [1, C] tokens and the decode batch's [B, 1] tokens each keep
    their own projections, norms and MLP at the shapes of the solo paths
    (the same GEMM calls), and only the two attention calls merge into one
    ragged kernel launch (K3) over ``B + ceil(C/rows)`` virtual rows —
    decode rows at q_len 1 against the live table, the chunk split into
    ``rows``-position groups against the admitting slot's row. Each query
    row's arithmetic is that of the solo kernels, so the step is
    token-identical to the two solo programs.

    Writes commute: chunk K/V land in the admitting slot's pages (its LIVE
    row is still zero, so no decode row reads them), decode K/V in each
    armed slot's own pages. Returns ``(chunk_hidden [1, C, h] final-normed,
    dec_logits [B, 1, V], cache with lengths += 1)``. While the flight
    recorder captures, the call is a ``model.forward`` range holding each
    layer's ``model.attn`` (both sides' projections and K/V writes, the
    merged attention) and two MLP ranges, and ``model.head``."""
    from fei_tpu_torch.engine.paged_cache import write_token_kv
    from fei_tpu_torch.ops.kernels.ragged_paged_attention import (
        ragged_paged_attention,
        ragged_paged_attention_sharded,
    )

    B = dec_tokens.shape[0]
    C = chunk_toks.shape[1]
    cap = FLIGHT.capturing
    if cap:
        rf = FLIGHT.open("model.forward", tokens=B + C, merged=True)
    dev = cache.k_pages.device
    Hq, d = cfg.num_heads, cfg.head_dim_
    Hl = Hq // _tp(kernel_mesh)[0]  # the rank's query heads
    sharded = _sharded_attention(kernel_mesh)
    R = rows
    nG = -(-C // R)  # chunk groups of R query positions
    Cp = nG * R
    ar = torch.arange(nG, device=dev, dtype=torch.int32)
    chunk_start = torch.full((1,), chunk_pos, dtype=torch.int32, device=dev)
    cos, sin = _paged_rope_tables(cfg, cache)
    # a pad tail past the table: clamped as in forward_paged_block
    chunk_positions = (chunk_pos + torch.arange(C, device=dev)[None, :]).clamp(
        max=cos.shape[0] - 1)
    dec_positions = cache.lengths.long()[:, None]
    win = cfg.sliding_window or 0

    # per-virtual-row metadata: decode rows, then chunk groups
    btv = torch.cat([cache.block_table, chunk_row.expand(nG, -1)]).contiguous()
    limits = torch.cat([cache.lengths + 1, chunk_pos + 1 + ar * R]).to(torch.int32)
    q_lens = torch.cat([torch.ones(B, dtype=torch.int32, device=dev),
                        (C - ar * R).clamp(0, R)]).to(torch.int32)
    modes = torch.cat([torch.ones(B, dtype=torch.int32, device=dev),
                       torch.zeros(nG, dtype=torch.int32, device=dev)])

    dtype = _paged_dtype(params, cache)
    xc = embed_tokens(params, cfg, chunk_toks.to(device=dev, dtype=torch.long), dtype,
                      kernel_mesh)
    xd = embed_tokens(params, cfg, dec_tokens.to(device=dev, dtype=torch.long), dtype,
                      kernel_mesh)
    for i in range(cfg.num_layers):
        lp = layer_params(params, i)
        kp, vp, ks, vs = _layer_pools(cache, i)
        if cap:
            ra = FLIGHT.open("model.attn")
        yc, qc, kc, vc = _qkv_roped(cfg, lp, xc, chunk_positions, cos, sin, kernel_mesh)
        yd, qd, kd, vd = _qkv_roped(cfg, lp, xd, dec_positions, cos, sin, kernel_mesh)
        # chunk writes first, then the decode rows' — page-disjoint
        write_token_kv(kp, vp, kc, vc, chunk_row, chunk_start, ks, vs)
        write_token_kv(kp, vp, kd, vd, cache.block_table, cache.lengths, ks, vs)
        qv = torch.cat([
            F.pad(qd, (0, 0, 0, 0, 0, R - 1)),
            F.pad(qc, (0, 0, 0, 0, 0, Cp - C)).reshape(nG, R, Hl, d),
        ])  # [B + nG, R, Hl, d]
        if sharded:
            av = ragged_paged_attention_sharded(qv, kp, vp, btv, limits, q_lens, modes,
                                                kernel_mesh, k_scales=ks, v_scales=vs,
                                                window=win)
        else:
            av = ragged_paged_attention(qv, kp, vp, btv, limits, q_lens, modes,
                                        k_scales=ks, v_scales=vs, window=win)
        dec_attn = av[:B, :1]
        chunk_attn = av[B:].reshape(1, Cp, Hq, d)[:, :C]
        if cap:
            FLIGHT.close(ra)
        xc = _block_tail(cfg, lp, xc, yc, chunk_attn, routed_moe, kernel_mesh, moe_mesh)
        xd = _block_tail(cfg, lp, xd, yd, dec_attn, routed_moe, kernel_mesh, moe_mesh)
    if cap:
        rh = FLIGHT.open("model.head")
    xc = _norm(xc, params["final_norm"], cfg, b=params.get("final_norm_b"))
    xd = _norm(xd, params["final_norm"], cfg, b=params.get("final_norm_b"))
    new_cache = cache._replace(lengths=(cache.lengths + 1).to(torch.int32))
    logits = _logits(xd, params, cfg, kernel_mesh=kernel_mesh)
    if cap:
        FLIGHT.close(rh)
        FLIGHT.close(rf)
    return xc, logits, new_cache
