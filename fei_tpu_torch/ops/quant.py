"""Weight-only int8/int4 quantization for the stacked Llama param dict
(counterpart of fei_tpu/ops/quant.py).

Scheme, the JAX package's exactly, so the packed bytes are bit-equal:

- symmetric per-out-channel int8 scales over the contraction axis (always
  -2 in the [.., in, out] layout), so ``(x @ q) * s == x @ (q * s)``: the
  scale is applied to the [.., out] result.
- int4 (``QTensor4``): ±7 per (group of 128 contraction rows, out channel),
  two nibbles per byte. Byte i packs contraction rows i (low nibble) and
  i + K/2 (high nibble), so the product is
  ``x[:, :K/2] @ lo + x[:, K/2:] @ hi``; the port's CUDA kernel
  (ops/kernels/int4_matmul.py) streams each packed byte once.
- fp32 division, ``torch.round`` (half to even, as ``jnp.round``) and a
  clip to ±127 / ±7 — the same rounding decisions as the JAX package.
- norms and the embedding stay in the model dtype unless the caller asks
  for a row-quantized embed table (``quantize_embed``).

``QTensor``/``QTensor4`` are NamedTuples of tensors; a stacked leaf
carries the layer axis on both fields, and ``models.llama`` slices a
layer's leaf field by field. MoE expert leaves are [L, E, in, out] int8
with [L, E, 1, out] scales (they stay int8 under int4: ``_int4_ok``); the
expert products take the raw int8 through ``wcast`` and apply the scale
to their results (``scale_expert_out``, ``scale_rows``).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from fei_tpu_torch.obs.flight import FLIGHT

# stacked-dict keys that hold big linear weights (contraction axis -2)
QUANT_KEYS = frozenset(
    {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head"}
)

# int4 group size along the contraction axis (GPTQ/AWQ-standard 128)
INT4_GROUP = 128


class QTensor(NamedTuple):
    """int8 weight + per-out-channel scale.

    q: int8, the weight's shape [.., in, out]
    s: fp32, [.., 1, out] (the contraction axis collapsed to 1)
    """

    q: torch.Tensor
    s: torch.Tensor

    @property
    def shape(self):
        return tuple(self.q.shape)

    @property
    def dtype(self):  # the dtype of the scale, not the compute dtype
        return self.s.dtype


class QTensor4(NamedTuple):
    """Weight-only int4: nibble-packed int8 + per-group scale.

    p: int8, [.., K/2, out] — byte i: row i (low nibble), row i + K/2 (high)
    s: fp32, [.., K/group, out] — row g scales rows [g*group, (g+1)*group);
       no group straddles the half split, so the low half reads scale rows
       [:K/(2*group)] and the high half the rest.
    """

    p: torch.Tensor
    s: torch.Tensor

    @property
    def shape(self):  # the logical unpacked shape
        return (*self.p.shape[:-2], self.p.shape[-2] * 2, self.p.shape[-1])

    @property
    def dtype(self):
        return self.s.dtype

    @property
    def group_size(self) -> int:
        return 2 * self.p.shape[-2] // self.s.shape[-2]


def _sym_scale(amax: torch.Tensor, levels: float) -> torch.Tensor:
    return torch.where(amax == 0.0, torch.ones_like(amax), amax / levels)


def quantize(w: torch.Tensor, contract_axis: int = -2) -> QTensor:
    """Symmetric int8 with a per-out-channel scale over ``contract_axis``."""
    w32 = w.float()
    s = _sym_scale(w32.abs().amax(dim=contract_axis, keepdim=True), 127.0)
    q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
    return QTensor(q=q, s=s)


def quantize4(w: torch.Tensor, group: int = INT4_GROUP) -> QTensor4:
    """Symmetric int4 (±7) with a per-(group, out-channel) scale over the
    contraction axis (-2). K must divide by 2*group so nibble pairs and
    scale groups both split cleanly at K/2."""
    K = w.shape[-2]
    if K % (2 * group) != 0:
        raise ValueError(
            f"int4 contraction dim {K} must be divisible by 2*group={2 * group}"
        )
    G = K // group
    grouped = w.float().reshape(*w.shape[:-2], G, group, w.shape[-1])
    s = _sym_scale(grouped.abs().amax(dim=-2), 7.0)  # [.., G, out]
    q = torch.clamp(torch.round(grouped / s[..., :, None, :]), -7, 7)
    q = q.to(torch.int8).reshape(w.shape)
    lo, hi = q[..., : K // 2, :], q[..., K // 2 :, :]
    return QTensor4(p=(hi << 4) | (lo & 0xF), s=s)


def unpack4(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed int8 -> (lo, hi) int32 nibble planes, sign-extended."""
    p32 = p.to(torch.int32)
    return (p32 << 28) >> 28, p32 >> 4


def quantize_embed(w: torch.Tensor) -> QTensor:
    """Symmetric int8 embedding table with per-ROW scales (q [V, h],
    s [V, 1]): the lookup gathers a row and its scale, and a tied LM head
    applies the scales to its result columns."""
    return quantize(w, contract_axis=-1)


def embed_lookup(embed, ids: torch.Tensor, dtype) -> torch.Tensor:
    """Row gather for a plain or row-quantized (``quantize_embed``) table."""
    if isinstance(embed, QTensor):
        return (embed.q[ids].float() * embed.s[ids]).to(dtype)
    return embed[ids].to(dtype)


def tied_logits(x: torch.Tensor, embed) -> torch.Tensor:
    """``x @ embed.T`` for a plain or row-quantized table, fp32 out."""
    if isinstance(embed, QTensor):
        out = x @ embed.q.T.to(x.dtype)
        return out.float() * embed.s[:, 0].float()
    return (x @ embed.T.to(x.dtype)).float()


def stack_layers(n: int, make) -> QTensor | QTensor4:
    """One stacked leaf from ``n`` per-layer quantized leaves, ``make(i)``
    each, copied into fields allocated at the first layer: only one
    layer's transients are alive at a time."""
    out = None
    for i in range(n):
        leaf = make(i)
        if out is None:
            out = type(leaf)(*(torch.empty((n, *f.shape), dtype=f.dtype, device=f.device)
                               for f in leaf))
        for dst, f in zip(out, leaf):
            dst[i] = f
    return out


def dequantize(w, dtype=torch.bfloat16):
    """QTensor/QTensor4 -> dense tensor; plain tensors are cast."""
    if isinstance(w, QTensor):
        return (w.q.float() * w.s).to(dtype)
    if isinstance(w, QTensor4):
        lo, hi = unpack4(w.p)
        q = torch.cat([lo, hi], dim=-2).float()
        G, gs = w.s.shape[-2], w.group_size
        grouped = q.reshape(*q.shape[:-2], G, gs, q.shape[-1])
        return (grouped * w.s[..., :, None, :]).reshape(q.shape).to(dtype)
    return w.to(dtype)


def mm(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for plain or quantized weights. int8: the int8 tensor is
    cast to x's dtype and the scale applied to the result. int4: the
    hand-written kernel (``int4_mm``). In eager PyTorch the int8 cast writes
    a dense copy of the weight on every call; the JAX package's XLA fuses it
    into the product."""
    if isinstance(w, QTensor):
        return (x @ _cast(w.q, x.dtype)) * w.s.squeeze(-2).to(x.dtype)
    if isinstance(w, QTensor4):
        from fei_tpu_torch.ops.kernels.int4_matmul import int4_mm

        return int4_mm(x, w)
    return x @ w


def _cast(q: torch.Tensor, dtype) -> torch.Tensor:
    """An int8 weight's dense copy in ``dtype``: the ``quant.cast`` range,
    device-timed, while the flight recorder captures."""
    if not FLIGHT.capturing:
        return q.to(dtype)
    r = FLIGHT.open("quant.cast", device=True)
    out = q.to(dtype)
    FLIGHT.close(r)
    return out


def wcast(w, dtype) -> torch.Tensor:
    """The raw weight as a product operand: a QTensor's int8 cast to the
    compute dtype (its scale goes on the result: ``scale_expert_out`` /
    ``scale_rows``), a plain tensor as it is. In eager PyTorch the cast
    writes a dense copy of the weight each call; the JAX package's XLA fuses
    it into the product."""
    if isinstance(w, QTensor):
        return _cast(w.q, dtype)
    if isinstance(w, QTensor4):  # MoE experts are kept int8 (_int4_ok)
        raise TypeError("QTensor4 has no raw-operand form; use mm/dequantize")
    return w


def scale_expert_out(out: torch.Tensor, w, expert_axis: int) -> torch.Tensor:
    """Apply a stacked-expert QTensor's scale ([E, 1, out]) to a product
    whose last axis is the out dim and whose ``expert_axis`` indexes the
    experts. Exact (the scale is constant along the contraction); a no-op
    for plain weights. Runs before any nonlinearity."""
    if not isinstance(w, QTensor):
        return out
    s = w.s.squeeze(-2)  # [E, out]
    shape = [1] * out.ndim
    shape[expert_axis] = s.shape[0]
    shape[-1] = s.shape[1]
    return out * s.reshape(shape).to(out.dtype)


def scale_rows(out: torch.Tensor, w, expert_ids: torch.Tensor) -> torch.Tensor:
    """Per-row scale of a grouped product: row i belongs to expert
    ``expert_ids[i]`` and takes that expert's [out] scale."""
    if not isinstance(w, QTensor):
        return out
    return out * w.s.squeeze(-2)[expert_ids].to(out.dtype)


def quant_embed_from_env() -> bool:
    """``FEI_TPU_QUANT_EMBED == "1"``: the JAX package's opt-in to an int8
    embedding table with per-row scales under a quantize mode
    (fei_tpu/models/llama.py::init_params, fei_tpu/engine/weights.py)."""
    return os.environ.get("FEI_TPU_QUANT_EMBED") == "1"


def _int4_ok(key: str, w, moe: bool, int4_lm_head: bool | None = None) -> bool:
    """Whether a big-linear leaf takes int4 in mixed int4/int8 mode:
    lm_head stays int8 unless ``int4_lm_head`` (the most scale-sensitive
    linear; None reads ``FEI_TPU_INT4_LM_HEAD``, as the JAX package does),
    stacked MoE experts stay int8, and the contraction must divide by
    2*INT4_GROUP. ``w`` needs only a ``.shape``."""
    if int4_lm_head is None:
        int4_lm_head = os.environ.get("FEI_TPU_INT4_LM_HEAD") == "1"
    if key == "lm_head" and not int4_lm_head:
        return False
    if moe and key in ("w_gate", "w_up", "w_down"):
        return False
    return w.shape[-2] % (2 * INT4_GROUP) == 0


def quantize_params(params: dict, bits: int = 8, int4_lm_head: bool | None = None) -> dict:
    """Quantize the big linear weights of a stacked param dict in place of
    their float leaves; norms, router and embed are left as they are.
    ``bits=4``: int4 where ``_int4_ok`` allows it, int8 elsewhere
    (``int4_lm_head`` None: as ``FEI_TPU_INT4_LM_HEAD`` says)."""
    moe = isinstance(params.get("layers"), dict) and "router" in params["layers"]

    def leaf(k, v):
        if bits == 4 and _int4_ok(k, v, moe, int4_lm_head):
            return quantize4(v)
        return quantize(v)

    def walk(tree):
        if isinstance(tree, dict):
            return {
                k: leaf(k, v)
                if k in QUANT_KEYS and not isinstance(v, (QTensor, QTensor4))
                else walk(v)
                for k, v in tree.items()
            }
        return tree

    return walk(params)


def dequantize_params(params: dict, dtype=torch.bfloat16, only=(QTensor, QTensor4)) -> dict:
    """Every quantized leaf of the kinds in ``only`` back to a dense
    ``dtype`` tensor; other leaves are returned as they are."""

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return dequantize(tree, dtype) if isinstance(tree, only) else tree

    return walk(params)


def param_bytes(params) -> int:
    """Total bytes of a (possibly quantized) param dict's tensors."""

    def walk(tree):
        if isinstance(tree, dict):
            return sum(walk(v) for v in tree.values())
        if isinstance(tree, tuple):
            return sum(walk(v) for v in tree)
        return tree.numel() * tree.element_size()

    return walk(params)
