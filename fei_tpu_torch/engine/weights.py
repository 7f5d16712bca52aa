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

``save_checkpoint(params, path)`` / ``restore_checkpoint(path)`` persist and
restore a whole stacked parameter tree, quantized leaves included, in the
port's safetensors format (the JAX package writes the same pair with
orbax); see the section at the end of this module.
"""

from __future__ import annotations

import json
import os
import shutil
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
    quant_embed_from_env,
    stack_layers,
)
from fei_tpu_torch.utils.errors import CheckpointError
from fei_tpu_torch.utils.fsync import fsync_dir, fsync_file
from fei_tpu_torch.utils.logging import get_logger
from fei_tpu_torch.utils.tree import SEP, unflatten

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
    int4_lm_head: bool | None = None,
    quant_embed: bool | None = None,
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
    mode) row-quantizes the embedding table. Either switch left None
    reads the JAX loader's variable where it reads it
    (``FEI_TPU_QUANT_EMBED`` here, ``FEI_TPU_INT4_LM_HEAD`` in ``_int4_ok``).
    A Mixtral's experts load stacked [L, E, in, out], quantized one layer
    at a time (int8 under either mode). ``int4_exclude`` names leaves kept
    int8.

    ``mesh`` with ``weights="sharded"``: this rank's slices only (see the
    module docstring)."""
    if quantize not in QUANT_MODES:
        raise CheckpointError(f"unsupported quantize mode: {quantize!r}")
    if quant_embed is None:
        quant_embed = quant_embed_from_env()
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


# -- the engine-native weight checkpoint ----------------------------------
#
# ``save_checkpoint(params, path)`` / ``restore_checkpoint(path)`` persist a
# whole stacked parameter tree, quantized leaves included (counterpart of
# fei_tpu/engine/weights.py's pair, which writes with orbax). The port keeps
# its own format: ``<path>/params.safetensors`` (one tensor per leaf, a
# quantized leaf field by field under ``<leaf>/q`` or ``/p`` and ``/s``) beside
# ``<path>/meta.json``, which records the leaves' order and which of them are
# ``QTensor``/``QTensor4``. Both files are fsynced in a temporary directory
# that is then renamed into place.

_PARAMS_FILE = "params.safetensors"
_PARAMS_META = "meta.json"
_PARAMS_FORMAT = "fei_tpu_torch.params/1"


def _is_qtensor_shaped(q, s) -> bool:
    """True iff ``s``'s shape is ``q``'s with exactly one axis collapsed to 1
    (or none: a contraction axis of size 1), the layout ``quantize`` makes
    (fei_tpu.engine.weights._is_qtensor_shaped)."""
    qs, ss = tuple(q.shape), tuple(s.shape)
    if len(qs) != len(ss):
        return False
    mismatch = [i for i, (a, b) in enumerate(zip(qs, ss)) if a != b]
    return len(mismatch) == 0 or (len(mismatch) == 1 and ss[mismatch[0]] == 1)


def _is_qtensor4_shaped(p, s) -> bool:
    """The ``QTensor4`` layout: packed [.., K/2, N] beside grouped scales
    [.., K/g, N] whose group divides K into an even number of rows
    (fei_tpu.engine.weights._is_qtensor4_shaped)."""
    ps, ss = tuple(p.shape), tuple(s.shape)
    if len(ps) != len(ss) or len(ps) < 2 or ps[:-2] != ss[:-2] or ps[-1] != ss[-1]:
        return False
    K, G = 2 * ps[-2], ss[-2]
    return G > 1 and K % G == 0 and (K // G) % 2 == 0


def _check_quantized(path: str, leaf) -> None:
    """Refuse a ``QTensor``/``QTensor4`` whose fields are not that layout:
    int8 values beside fp32 scales of the shape the quantizer makes."""
    if isinstance(leaf, QTensor4):
        values, shaped = leaf.p, _is_qtensor4_shaped(leaf.p, leaf.s)
    else:
        values, shaped = leaf.q, _is_qtensor_shaped(leaf.q, leaf.s)
    if values.dtype != torch.int8 or leaf.s.dtype != torch.float32 or not shaped:
        raise CheckpointError(
            f"{path}: a {type(leaf).__name__} of {values.dtype} {tuple(values.shape)} with "
            f"{leaf.s.dtype} scales {tuple(leaf.s.shape)} is not that layout")


def _own(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a tensor that owns its storage (the file format refuses
    tensors that share memory, such as layer views of a deeper tree)."""
    whole = t.untyped_storage().nbytes() == t.numel() * t.element_size()
    return t if t.is_contiguous() and t.storage_offset() == 0 and whole else t.clone()


def save_checkpoint(params: dict, path: str) -> None:
    """Persist the stacked parameter dict ``params`` (plain tensors,
    ``QTensor`` and ``QTensor4`` leaves, nested dicts) under the directory
    ``path``, replacing what is there. Any other leaf, or a quantized leaf
    of another layout, raises ``CheckpointError`` and writes nothing."""
    from safetensors.torch import save_file

    flat: dict[str, torch.Tensor] = {}
    types: dict[str, str] = {}

    def walk(node, prefix: str) -> None:
        for key, value in node.items():
            if not isinstance(key, str) or SEP in key:
                raise CheckpointError(f"parameter key {key!r} under {prefix or 'the root'!r} "
                                      f"is not a name without {SEP!r}")
            name = f"{prefix}{SEP}{key}" if prefix else key
            if isinstance(value, dict):
                walk(value, name)
            elif isinstance(value, (QTensor, QTensor4)):
                _check_quantized(name, value)
                types[name] = type(value).__name__
                for field in value._fields:
                    flat[f"{name}{SEP}{field}"] = _own(getattr(value, field).detach())
            elif isinstance(value, torch.Tensor):
                flat[name] = _own(value.detach())
            else:
                raise CheckpointError(f"{name}: a {type(value).__name__} is not a parameter "
                                      "leaf (tensor, QTensor or QTensor4)")

    walk(params, "")
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    old = f"{path}.old-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        file = os.path.join(tmp, _PARAMS_FILE)
        save_file(flat, file)
        fsync_file(file)
        meta = os.path.join(tmp, _PARAMS_META)
        with open(meta, "w", encoding="utf-8") as f:
            # the file format sorts its tensors; the tree comes back in the
            # order it was saved in
            json.dump({"format": _PARAMS_FORMAT, "order": list(flat), "types": types}, f)
        fsync_file(meta)
        fsync_dir(tmp)
        if os.path.exists(path):
            os.replace(path, old)
        os.replace(tmp, path)
        fsync_dir(parent)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        if os.path.exists(old) and not os.path.exists(path):
            os.replace(old, path)
        raise
    shutil.rmtree(old, ignore_errors=True)
    log.info("saved %d parameter tensors (%d quantized leaves) -> %s", len(flat), len(types),
             path)


def restore_checkpoint(path: str, device: torch.device | str = "cuda") -> dict:
    """The parameter dict ``save_checkpoint`` wrote under ``path``, on
    ``device`` (the card unless the caller asks for the CPU; without a
    card the default raises), each tensor bitwise as it was saved and each
    quantized leaf rebuilt as its ``QTensor``/``QTensor4``. A directory
    that is not this format, or a quantized leaf whose fields are not that
    layout, raises ``CheckpointError``."""
    from safetensors.torch import load_file

    from fei_tpu_torch.engine.engine import resolve_device

    device = resolve_device(device)
    path = os.path.abspath(path)
    meta_path = os.path.join(path, _PARAMS_META)
    try:
        with open(meta_path, encoding="utf-8") as f:
            meta = json.load(f)
        loaded = load_file(os.path.join(path, _PARAMS_FILE))
    except (OSError, ValueError) as exc:
        raise CheckpointError(f"no parameter checkpoint readable under {path}: {exc}") from exc
    if meta.get("format") != _PARAMS_FORMAT or set(meta.get("order", ())) != set(loaded):
        raise CheckpointError(f"{path} is not a {_PARAMS_FORMAT} checkpoint, or its tensors "
                              "are not the ones its meta.json lists")
    kinds = {"QTensor": QTensor, "QTensor4": QTensor4}
    flat = {}
    for name in meta["order"]:
        t = loaded[name]
        # a copy into memory of the device's allocator: the loaded tensor
        # may sit unaligned in the file's buffer
        flat[name] = torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t)
    tree = unflatten(flat)
    for name, kind in meta.get("types", {}).items():
        cls = kinds.get(kind)
        *parents, key = name.split(SEP)
        node = tree
        for part in parents:
            node = node.get(part) if isinstance(node, dict) else None
        fields = node.get(key) if isinstance(node, dict) else None
        if cls is None or not isinstance(fields, dict) or set(fields) != set(cls._fields):
            raise CheckpointError(f"{path}: leaf {name} is recorded as {kind} but holds "
                                  f"{sorted(fields) if isinstance(fields, dict) else fields!r}")
        leaf = cls(**fields)
        _check_quantized(name, leaf)
        node[key] = leaf
    return tree
