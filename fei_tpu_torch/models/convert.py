"""Convert the JAX package's parameter tree into the port's.

``params_from_jax`` takes the tree of ``fei_tpu.models.llama.init_params``
(or ``fei_tpu.engine.weights.load_checkpoint``) with every leaf already a
numpy array — ``jax.tree.map(np.asarray, params)`` on the JAX side — and
returns the port's dict of tensors. The layouts are the same (layers
stacked on axis 0, linears [in, out]; quantized leaves as ``QTensor``
(q, s) and ``QTensor4`` (p, s) NamedTuples with the same fields), so both
packages then compute the same function. ``opt_state_from_jax`` does the
same for the state of the JAX package's optimizer (``optax.chain(
clip_by_global_norm, adamw)``), so both packages continue one training
run. This module imports neither jax nor fei_tpu (nor optax).
"""

from __future__ import annotations

import numpy as np
import torch

from fei_tpu_torch.ops.quant import QTensor, QTensor4

_QUANT_LEAVES = {("q", "s"): QTensor, ("p", "s"): QTensor4}


def _tensor(x, dtype, device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.kind not in "fiu":
        # ml_dtypes bfloat16 (and other extension floats): torch cannot
        # wrap them, and the float32 round-trip is exact
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))  # a writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _leaf(x, path: str, dtype, device):
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        # fei_tpu.ops.quant.QTensor / QTensor4: the int8 values and the
        # fp32 scales keep their own dtypes (``dtype`` is the model's)
        kind = _QUANT_LEAVES.get(tuple(x._fields))
        if kind is None:
            raise NotImplementedError(
                f"{path}: quantized leaf {type(x).__name__}{x._fields} has no "
                "counterpart in fei_tpu_torch.ops.quant"
            )
        return kind(*(_tensor(f, None, device) for f in x))
    return _tensor(x, dtype, device)


def params_from_jax(tree: dict, dtype=None, device: torch.device | str = "cpu") -> dict:
    """JAX param tree (numpy leaves) -> port param dict on ``device``.
    ``dtype`` casts every plain floating leaf (None keeps each leaf's own);
    quantized leaves keep their int8 values and fp32 scales."""

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        return _leaf(node, path, dtype, device)

    return walk(tree, "")


def _find_adam(node):
    """The ``ScaleByAdamState`` (fields count, mu, nu) inside optax's
    nested tuples of states, found by its fields."""
    fields = getattr(node, "_fields", ())
    if {"count", "mu", "nu"} <= set(fields):
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _find_adam(child)
            if found is not None:
                return found
    return None


def opt_state_from_jax(state, dtype=None, device: torch.device | str = "cpu") -> dict:
    """The JAX train step's optimizer state (numpy leaves:
    ``jax.tree.map(np.asarray, opt_state)``) -> the port's ``{"count",
    "mu", "nu"}`` on ``device``. The clip and the decay stages of the chain
    carry no state; the Adam stage's step count and moment trees do."""
    adam = _find_adam(state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the given optimizer state")
    return {
        "count": torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32, device=device),
        "mu": params_from_jax(adam.mu, dtype, device),
        "nu": params_from_jax(adam.nu, dtype, device),
    }
