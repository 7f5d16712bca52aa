"""Checkpoint loading: an HF safetensors directory -> the stacked param dict
(counterpart of fei_tpu/engine/weights.py).

Maps per-layer HF Llama / Qwen2 / Mistral / Mixtral / Gemma / Phi tensor
names onto
the scan-stacked layout of models/llama.py (layers on a leading axis,
linears transposed to [in, out]; Mixtral's experts stacked [L, E, in, out]). Tensors are read with
``safetensors.torch`` one at a time and copied into preallocated stacked
tensors on the target device, so the host never holds more than one
layer's tensor. If ``config.json`` is present its architecture fields
override the preset (``_merge_hf_config``). ``quantize="int8"|"int4"``
quantizes the big linears while they are read, one layer at a time, from
the checkpoint's stored values in fp32 (numpy copies of the JAX package's
``_quant_host`` / ``_quant4_host``, so the bytes are the JAX loader's).

**Sharded streaming** (``mesh=`` with the ``sharded`` weights profile):
each rank reads only its slice of each tensor (``safe_open(...).get_slice``,
the slice given by parallel/sharding.py's tables) and quantizes it while
it reads, so the whole tree never exists on one rank and each rank's
device holds its share plus the one tensor in flight. Column shards
quantize alone (scales are per output column); an int8 leaf sharded over
its contraction axis (the row-parallel ``wo``/``w_down``) reads the whole
tensor on the host, quantizes it and keeps its rows, since its scales
span every row. The ``replicated`` profile reads everything on every rank.
"""

from __future__ import annotations

import json
import os
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import torch

from fei_tpu_torch.models.configs import ModelConfig
from fei_tpu_torch.models.llama import QUANT_MODES
from fei_tpu_torch.ops.quant import (
    INT4_GROUP,
    QUANT_KEYS,
    QTensor,
    QTensor4,
    _int4_ok,
    stack_layers,
)
from fei_tpu_torch.utils.errors import CheckpointError
from fei_tpu_torch.utils.logging import get_logger

log = get_logger("engine.weights")

# our stacked name -> HF per-layer template
_LAYER_MAP = {
    "attn_norm": "model.layers.{i}.input_layernorm.weight",
    "wq": "model.layers.{i}.self_attn.q_proj.weight",
    "wk": "model.layers.{i}.self_attn.k_proj.weight",
    "wv": "model.layers.{i}.self_attn.v_proj.weight",
    "wo": "model.layers.{i}.self_attn.o_proj.weight",
    "mlp_norm": "model.layers.{i}.post_attention_layernorm.weight",
    "w_gate": "model.layers.{i}.mlp.gate_proj.weight",
    "w_up": "model.layers.{i}.mlp.up_proj.weight",
    "w_down": "model.layers.{i}.mlp.down_proj.weight",
    "bq": "model.layers.{i}.self_attn.q_proj.bias",
    "bk": "model.layers.{i}.self_attn.k_proj.bias",
    "bv": "model.layers.{i}.self_attn.v_proj.bias",
    "bo": "model.layers.{i}.self_attn.o_proj.bias",
}
# Mixtral (block_sparse_moe): the router and the experts' w1/w2/w3
_MOE_LAYER_MAP = {
    "router": "model.layers.{i}.block_sparse_moe.gate.weight",
    "w_gate": "model.layers.{i}.block_sparse_moe.experts.{e}.w1.weight",
    "w_down": "model.layers.{i}.block_sparse_moe.experts.{e}.w2.weight",
    "w_up": "model.layers.{i}.block_sparse_moe.experts.{e}.w3.weight",
}
_TOP_MAP = {
    "embed": "model.embed_tokens.weight",
    "final_norm": "model.norm.weight",
    "lm_head": "lm_head.weight",
}
# Phi (PhiForCausalLM): o_proj is `dense`, the MLP is fc1/fc2 (our
# w_gate/w_down leaves), LayerNorms carry biases, lm_head has a bias
_PHI_LAYER_MAP = {
    **_LAYER_MAP,
    "wo": "model.layers.{i}.self_attn.dense.weight",
    "bo": "model.layers.{i}.self_attn.dense.bias",
    "attn_norm_b": "model.layers.{i}.input_layernorm.bias",
    "w_gate": "model.layers.{i}.mlp.fc1.weight",
    "b_gate": "model.layers.{i}.mlp.fc1.bias",
    "w_down": "model.layers.{i}.mlp.fc2.weight",
    "b_down": "model.layers.{i}.mlp.fc2.bias",
}
_PHI_TOP_MAP = {
    **_TOP_MAP,
    "final_norm": "model.final_layernorm.weight",
    "final_norm_b": "model.final_layernorm.bias",
    "lm_head_b": "lm_head.bias",
}


def _open_index(ckpt_dir: str) -> dict[str, str]:
    """tensor name -> shard filename."""
    idx_path = os.path.join(ckpt_dir, "model.safetensors.index.json")
    if os.path.exists(idx_path):
        with open(idx_path) as f:
            return json.load(f)["weight_map"]
    single = os.path.join(ckpt_dir, "model.safetensors")
    if os.path.exists(single):
        from safetensors import safe_open

        with safe_open(single, framework="pt") as f:
            return {name: "model.safetensors" for name in f.keys()}
    raise CheckpointError(f"no safetensors checkpoint found in {ckpt_dir}")


def _leaf_specs(cfg: ModelConfig) -> dict:
    """{path: (hf name template, our per-layer shape, transpose)} for every
    leaf of the tree; ``path`` is ("layers", key) for stacked leaves. An
    expert template (``{e}``) has the per-layer shape [E, in, out] and
    names one expert's [out, in] tensor."""
    h, d = cfg.hidden_size, cfg.head_dim_
    H, K, I, V = cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size, cfg.vocab_size
    lmap = _PHI_LAYER_MAP if cfg.parallel_block else _LAYER_MAP
    tmap = _PHI_TOP_MAP if cfg.parallel_block else _TOP_MAP
    if cfg.norm_kind == "layernorm" and not cfg.parallel_block:
        raise CheckpointError(
            f"layernorm family {cfg.name!r} without the Phi parallel block has "
            "no weight-map entries for its mlp_norm bias"
        )
    specs = {
        ("embed",): (tmap["embed"], (V, h), False),
        ("final_norm",): (tmap["final_norm"], (h,), False),
        ("layers", "attn_norm"): (lmap["attn_norm"], (h,), False),
        ("layers", "wq"): (lmap["wq"], (h, H * d), True),
        ("layers", "wk"): (lmap["wk"], (h, K * d), True),
        ("layers", "wv"): (lmap["wv"], (h, K * d), True),
        ("layers", "wo"): (lmap["wo"], (H * d, h), True),
        ("layers", "w_gate"): (lmap["w_gate"], (h, I), True),
        ("layers", "w_down"): (lmap["w_down"], (I, h), True),
    }
    if not cfg.parallel_block:
        specs[("layers", "mlp_norm")] = (lmap["mlp_norm"], (h,), False)
    if cfg.norm_kind == "layernorm":
        specs[("layers", "attn_norm_b")] = (lmap["attn_norm_b"], (h,), False)
        specs[("final_norm_b",)] = (tmap["final_norm_b"], (h,), False)
    if cfg.attn_bias:
        specs[("layers", "bq")] = (lmap["bq"], (H * d,), False)
        specs[("layers", "bk")] = (lmap["bk"], (K * d,), False)
        specs[("layers", "bv")] = (lmap["bv"], (K * d,), False)
    if cfg.o_bias:
        specs[("layers", "bo")] = (lmap["bo"], (h,), False)
    if cfg.is_moe:
        E = cfg.num_experts
        specs[("layers", "router")] = (_MOE_LAYER_MAP["router"], (h, E), True)
        specs[("layers", "w_gate")] = (_MOE_LAYER_MAP["w_gate"], (E, h, I), True)
        specs[("layers", "w_up")] = (_MOE_LAYER_MAP["w_up"], (E, h, I), True)
        specs[("layers", "w_down")] = (_MOE_LAYER_MAP["w_down"], (E, I, h), True)
    elif cfg.mlp_gated:
        specs[("layers", "w_up")] = (lmap["w_up"], (h, I), True)
    elif cfg.mlp_bias:
        specs[("layers", "b_gate")] = (lmap["b_gate"], (I,), False)
        specs[("layers", "b_down")] = (lmap["b_down"], (h,), False)
    if not cfg.tie_embeddings:
        specs[("lm_head",)] = (tmap["lm_head"], (h, V), True)
        if cfg.lm_head_bias:
            specs[("lm_head_b",)] = (tmap["lm_head_b"], (V,), False)
    return specs


def _quant_host(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 over contraction axis -2 (ops.quant.quantize); the
    divisions stay float32 so the rounding decisions are the same."""
    w = w.astype(np.float32)
    amax = np.abs(w).max(axis=-2, keepdims=True)
    s = np.where(amax == 0.0, np.float32(1.0), amax / np.float32(127.0))
    q = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    return q, s.astype(np.float32)


def _quant4_host(w: np.ndarray, group: int = INT4_GROUP) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric int4 (ops.quant.quantize4): ±7 per (group, out channel),
    nibble pairs (k, k + K/2) packed into int8, float32 divisions."""
    K = w.shape[-2]
    G = K // group
    w = w.astype(np.float32)
    grouped = w.reshape(*w.shape[:-2], G, group, w.shape[-1])
    amax = np.abs(grouped).max(axis=-2)
    s = np.where(amax == 0.0, np.float32(1.0), amax / np.float32(7.0))
    q = np.clip(np.round(grouped / s[..., :, None, :]), -7, 7).astype(np.int8).reshape(w.shape)
    lo, hi = q[..., : K // 2, :], q[..., K // 2 :, :]
    return ((hi << 4) | (lo & 0xF)).astype(np.int8), s.astype(np.float32)


def _quant_embed_host(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Row-quantized int8 embedding table (ops.quant.quantize_embed)."""
    w = w.astype(np.float32)
    amax = np.abs(w).max(axis=-1, keepdims=True)
    s = np.where(amax == 0.0, np.float32(1.0), amax / np.float32(127.0))
    q = np.clip(np.round(w / s), -127, 127).astype(np.int8)
    return q, s.astype(np.float32)


def load_checkpoint(
    ckpt_dir: str,
    cfg: ModelConfig,
    dtype=torch.bfloat16,
    device: torch.device | str = "cpu",
    quantize: str | None = None,
    int4_lm_head: bool = False,
    quant_embed: bool = False,
    mesh=None,
    weights: str | None = None,
    int4_exclude: frozenset = frozenset(),
) -> tuple[ModelConfig, dict]:
    """Load an unsharded HF safetensors dir into the stacked param dict on
    ``device``. Returns (merged config, params).

    ``quantize="int8"``: the big linears land as ``QTensor``.
    ``quantize="int4"``: the leaves ``ops.quant._int4_ok`` allows (not
    lm_head unless ``int4_lm_head``; contraction divisible by 256) land as
    ``QTensor4``, the rest as int8 ``QTensor``. ``quant_embed`` (with a
    mode) row-quantizes the embedding table. A Mixtral's experts load
    stacked [L, E, in, out], quantized one layer at a time (int8 under
    either mode). ``int4_exclude`` names leaves kept int8.

    ``mesh`` with ``weights="sharded"``: this rank's slices only (see the
    module docstring)."""
    if quantize not in QUANT_MODES:
        raise CheckpointError(f"unsupported quantize mode: {quantize!r}")
    from safetensors import safe_open

    cfg = _merge_hf_config(ckpt_dir, cfg)
    weight_map = _open_index(ckpt_dir)
    files: dict[str, object] = {}
    shardings = None
    if mesh is not None and weights == "sharded":
        from fei_tpu_torch.parallel.sharding import param_shardings_from_cfg

        shardings = param_shardings_from_cfg(cfg, mesh)

    def cut(path: tuple, shape: tuple) -> tuple | None:
        """This rank's per-layer slices of a leaf, or None for all of it."""
        if shardings is None:
            return None
        sh = shardings[path[0]] if len(path) == 1 else shardings["layers"][path[1]]
        if path[0] == "layers":
            sl = sh.slices((cfg.num_layers, *shape))[1:]
        else:
            sl = sh.slices(shape)
        return None if all(x == slice(None) for x in sl) else sl

    def read(name: str, expect: tuple, transpose: bool, sl: tuple | None = None) -> torch.Tensor:
        """The tensor ``name`` in our orientation, or its ``sl`` slice
        (slices in our orientation; only those bytes are read)."""
        if name not in weight_map:
            raise CheckpointError(f"tensor {name!r} missing from checkpoint")
        shard = weight_map[name]
        if shard not in files:
            files[shard] = safe_open(os.path.join(ckpt_dir, shard), framework="pt")
        view = files[shard].get_slice(name)
        hf_shape = tuple(reversed(expect)) if transpose else expect
        if tuple(view.get_shape()) != hf_shape:
            raise CheckpointError(
                f"tensor {name!r} has shape {tuple(view.get_shape())}, config expects "
                f"{hf_shape} — wrong model config for this checkpoint?"
            )
        if sl is None:
            t = files[shard].get_tensor(name)
        else:
            t = view[tuple(reversed(sl)) if transpose else sl]
        return t.T if transpose else t

    def quantizer(key: str, shape: tuple):
        """The host quantizer of a leaf and the NamedTuple it fills, or None
        for a leaf that loads plainly."""
        if quantize and key == "embed" and quant_embed:
            return _quant_embed_host, QTensor
        if quantize is None or key not in QUANT_KEYS:
            return None
        if (quantize == "int4" and key not in int4_exclude
                and _int4_ok(key, SimpleNamespace(shape=shape), cfg.is_moe, int4_lm_head)):
            return _quant4_host, QTensor4
        return _quant_host, QTensor

    def layer(tmpl: str, i: int, shape: tuple, transpose: bool, sl=None) -> torch.Tensor:
        if "{e}" in tmpl:  # one tensor per expert, stacked [E, in, out]
            per = None if sl is None else sl[1:]
            return torch.stack([read(tmpl.format(i=i, e=e), shape[1:], transpose, per)
                                for e in range(shape[0])])[sl[0] if sl else slice(None)]
        return read(tmpl.format(i=i), shape, transpose, sl)

    def quantized(get, sl, quant, kind):
        """Quantize this rank's slice ``sl`` of the tensor ``get`` reads. An
        int8 weight cut over its contraction axis (-2) is quantized whole,
        its scales spanning every row, and then cut."""
        if sl is not None and kind is QTensor and quant is _quant_host \
                and sl[-2] != slice(None):
            q, s = quant(get(None).float().numpy())
            fields = (q[sl], s[(*sl[:-2], slice(None), sl[-1])])
        else:
            fields = quant(get(sl).float().numpy())
        return kind(*(torch.from_numpy(np.ascontiguousarray(f)).to(device) for f in fields))

    params: dict = {"layers": {}}
    for path, (tmpl, shape, transpose) in _leaf_specs(cfg).items():
        how = quantizer(path[-1], shape)
        sl = cut(path, shape)
        if path[0] == "layers" and how is None:
            local = shape if sl is None else tuple(
                len(range(*x.indices(n))) for x, n in zip(sl, shape))
            out = torch.empty((cfg.num_layers, *local), dtype=dtype, device=device)
            for i in range(cfg.num_layers):
                out[i].copy_(layer(tmpl, i, shape, transpose, sl))
            params["layers"][path[1]] = out
        elif path[0] == "layers":  # quantized one layer at a time
            params["layers"][path[1]] = stack_layers(cfg.num_layers, lambda i: quantized(
                lambda s_: layer(tmpl, i, shape, transpose, s_), sl, *how))
        elif how is None:
            params[path[0]] = read(tmpl, shape, transpose, sl).to(device=device, dtype=dtype)
        else:
            params[path[0]] = quantized(lambda s_: read(tmpl, shape, transpose, s_), sl, *how)
    log.info("loaded checkpoint from %s (%d layers%s)", ckpt_dir, cfg.num_layers,
             f", {quantize}" if quantize else "")
    return cfg, params


def _merge_hf_config(ckpt_dir: str, cfg: ModelConfig) -> ModelConfig:
    """config.json architecture fields override the preset (a copy of
    fei_tpu.engine.weights._merge_hf_config)."""
    path = os.path.join(ckpt_dir, "config.json")
    if not os.path.exists(path):
        return cfg
    with open(path) as f:
        hf = json.load(f)
    fields = dict(
        vocab_size=hf.get("vocab_size"),
        hidden_size=hf.get("hidden_size"),
        intermediate_size=hf.get("intermediate_size"),
        num_layers=hf.get("num_hidden_layers"),
        num_heads=hf.get("num_attention_heads"),
        num_kv_heads=hf.get("num_key_value_heads"),
        rope_theta=hf.get("rope_theta"),
        rms_norm_eps=hf.get("rms_norm_eps"),
        max_seq_len=hf.get("max_position_embeddings"),
        tie_embeddings=hf.get("tie_word_embeddings"),
        num_experts=hf.get("num_local_experts"),
        num_experts_per_tok=hf.get("num_experts_per_tok"),
        bos_token_id=hf.get("bos_token_id"),
        eos_token_id=hf.get("eos_token_id"),
        # Llama-family configs expose attention_bias (q/k/v AND o biases);
        # Qwen2 hardcodes qkv-only biases without a config field
        attn_bias=(
            True if hf.get("model_type") == "qwen2" else hf.get("attention_bias")
        ),
        o_bias=(
            False if hf.get("model_type") == "qwen2" else hf.get("attention_bias")
        ),
        head_dim=hf.get("head_dim"),
    )
    if hf.get("model_type") == "phi":
        # LayerNorm + shared-norm parallel block, partial rotary
        # (partial_rotary_factor * head_dim; absent means PhiConfig's 0.5),
        # fc1/fc2 MLP with biases, biased qkv/dense/lm_head
        n_heads = hf.get("num_attention_heads") or cfg.num_heads
        head_dim = (hf.get("hidden_size") or cfg.hidden_size) // n_heads
        factor = hf.get("partial_rotary_factor")
        fields.update(
            norm_kind="layernorm", parallel_block=True, mlp_gated=False,
            mlp_bias=True, attn_bias=True, o_bias=True, lm_head_bias=True,
            hidden_act="gelu", rms_norm_eps=hf.get("layer_norm_eps"),
            rotary_dim=int((0.5 if factor is None else factor) * head_dim),
            num_kv_heads=hf.get("num_key_value_heads") or n_heads,
        )
    if hf.get("model_type") == "gemma":
        # zero-centered norms ((1+w)), sqrt(h)-scaled embeddings, GeGLU;
        # GemmaConfig defaults tie_word_embeddings=True
        act = hf.get("hidden_activation") or hf.get("hidden_act") or "gelu"
        fields.update(
            norm_offset=True, embed_scale=True,
            hidden_act="gelu" if "gelu" in act else act,
            tie_embeddings=(
                True if hf.get("tie_word_embeddings") is None
                else hf["tie_word_embeddings"]
            ),
        )
    fields = {k: v for k, v in fields.items() if v is not None}
    # sliding_window after the None-filter: null must be able to DISABLE a
    # preset's window (Mistral v0.2+)
    if hf.get("model_type") == "mistral":
        fields["sliding_window"] = hf.get("sliding_window")
    elif hf.get("use_sliding_window"):
        # HF Qwen2: only layers >= max_window_layers (absent: 28) slide;
        # the uniform-window decoder refuses partial windowing
        n_layers = hf.get("num_hidden_layers", 0) or 0
        mwl = hf.get("max_window_layers")
        mwl = 28 if mwl is None else mwl
        if mwl >= n_layers:
            fields["sliding_window"] = None
        elif mwl == 0:
            fields["sliding_window"] = hf.get("sliding_window")
        else:
            raise CheckpointError(
                f"per-layer sliding window (max_window_layers={mwl} < "
                f"num_hidden_layers={n_layers}) is not representable in the "
                "uniform-window decoder; refusing to load rather than "
                "mis-window layers"
            )
    return replace(cfg, **fields)
