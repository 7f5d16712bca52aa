"""Training / fine-tuning step for the local models (counterpart of
fei_tpu/engine/train.py).

``make_train_step(cfg, tc)`` returns ``(optimizer, train_step)`` with
``train_step(params, opt_state, tokens[B, T]) -> (params, opt_state, loss)``:
the loss is the mean next-token cross-entropy over ``tokens[:, 1:]`` in fp32
from ``forward_train(params, cfg, tokens[:, :-1])``, and the update is the
JAX package's ``optax.chain(clip_by_global_norm, adamw)``: global-norm clip,
then Adam moments with bias correction, decoupled weight decay and the
learning rate (eps 1e-8, moments in the parameters' dtype).

Like the port's other entry points the step runs on the card unless the
caller passes ``device="cpu"``: without a card the default raises, and so
do parameters that lie on another device than the step's (they would
otherwise train on the CPU through the plain attention, no kernel
launched, without a word).

Where JAX donates the parameters and the optimizer state to a pure
function, this step updates both in place and returns them. Memory is the
constraint on one card — parameters, gradients and two moments of an 8B
model in bf16 are 64 GB of its 80 — so nothing here allocates a further
copy the size of the model: the gradients accumulate straight into one
buffer shaped like the parameters (each layer's leaves are autograd leaves
over the stacked storage whose ``.grad`` is a view of that buffer), and the
optimizer walks every leaf in slices of ``UPDATE_SLICE`` elements, its
fp32 temporaries one slice big. The arithmetic runs in fp32 on each slice
and rounds the moments and the parameters to their own dtype.

The optimizer state is a dict shaped like the parameters — ``mu`` and
``nu`` trees and a 0-d int32 ``count`` — so it converts
(``models.convert.opt_state_from_jax``) and checkpoints leaf by leaf.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from fei_tpu_torch.engine.engine import resolve_device
from fei_tpu_torch.models.configs import ModelConfig
from fei_tpu_torch.models.llama import check_trainable, forward_train
from fei_tpu_torch.utils.errors import TrainingError
from fei_tpu_torch.utils.tree import flatten, tree_map

UPDATE_SLICE = 1 << 25  # elements per optimizer slice (fp32 temporaries of 128 MiB)
ADAM_EPS = 1e-8  # optax.adamw's default


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    remat: bool = True


def _slices(t: torch.Tensor):
    if not t.is_contiguous():
        raise TrainingError("the optimizer updates contiguous leaves in place; "
                            f"got strides {t.stride()} for shape {tuple(t.shape)}")
    return t.view(-1).split(UPDATE_SLICE)


class AdamW:
    """Global-norm clip, then AdamW: ``optax.chain(clip_by_global_norm(
    grad_clip), adamw(learning_rate, b1, b2, weight_decay=weight_decay))``."""

    def __init__(self, tc: TrainConfig):
        self.tc = tc

    def init(self, params: dict) -> dict:
        some = next(iter(flatten(params).values()))
        return {
            "count": torch.zeros((), dtype=torch.int32, device=some.device),
            "mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params),
        }

    @torch.no_grad()
    def global_norm(self, grads: dict) -> torch.Tensor:
        """sqrt of the sum of squares over every leaf, fp32, on the device."""
        leaves = list(flatten(grads).values())
        total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for g in leaves:
            for part in _slices(g):
                total += torch.linalg.vector_norm(part, dtype=torch.float32).square()
        return total.sqrt()

    @torch.no_grad()
    def update(self, params: dict, grads: dict, opt_state: dict) -> None:
        """One step, in place in ``params`` and ``opt_state``; ``grads`` is
        left as it is. No host synchronisation: the clip factor and the bias
        corrections stay 0-d tensors on the device."""
        tc = self.tc
        p_flat, g_flat = flatten(params), flatten(grads)
        mu_flat, nu_flat = flatten(opt_state["mu"]), flatten(opt_state["nu"])
        for name, p in p_flat.items():
            for other in (g_flat, mu_flat, nu_flat):
                if name not in other or other[name].shape != p.shape:
                    raise TrainingError(f"gradient or optimizer state does not fit leaf {name}")
        gnorm = self.global_norm(grads)
        clip = gnorm < tc.grad_clip  # optax: leave the gradients when inside the ball
        opt_state["count"] += 1
        count = opt_state["count"].to(torch.float32)
        bc1, bc2 = 1.0 - tc.b1 ** count, 1.0 - tc.b2 ** count
        for name, p in p_flat.items():
            for pc, gc, mc, nc in zip(*map(_slices, (p, g_flat[name], mu_flat[name],
                                                     nu_flat[name]))):
                g = gc.float()
                g = torch.where(clip, g, g / gnorm * tc.grad_clip)
                mc.copy_(mc.float().mul_(tc.b1).add_(g, alpha=1.0 - tc.b1))
                nc.copy_(nc.float().mul_(tc.b2).addcmul_(g, g, value=1.0 - tc.b2))
                # from the stored moments, as optax reads them back rounded
                upd = (mc.float() / bc1) / ((nc.float() / bc2).sqrt_() + ADAM_EPS)
                if tc.weight_decay:
                    upd.add_(pc.float(), alpha=tc.weight_decay)
                pc.copy_(pc.float().add(upd, alpha=-tc.learning_rate))


def make_optimizer(tc: TrainConfig) -> AdamW:
    return AdamW(tc)


def _autograd_leaves(params: dict, grads: dict, num_layers: int):
    """``(top, layer_leaves)``: the parameters as autograd leaves over the
    same storage — the leaves outside ``layers`` in a tree like ``params``
    (its ``layers`` the stacked tensors as they are, no leaves), and one
    dict of leaves per layer — every leaf's ``.grad`` a view of ``grads``:
    the backward then accumulates each gradient in place into the one
    stacked buffer, with no stacked-size temporary per layer."""
    def leaf(t, g):
        x = t.detach().requires_grad_(True)
        x.grad = g
        return x

    top = {k: v if k == "layers" else leaf(v, grads[k]) for k, v in params.items()}
    layer_leaves = [
        {name: leaf(t[i], grads["layers"][name][i]) for name, t in params["layers"].items()}
        for i in range(num_layers)
    ]
    return top, layer_leaves


def _check_on_device(params: dict, device: torch.device) -> None:
    """Training follows no tensor to another device than the one asked for:
    parameters made or restored on the CPU would otherwise train there
    through the plain attention without a word."""
    for name, leaf in flatten(params).items():
        if leaf.device.type != device.type or (
                device.index is not None and leaf.device.index != device.index):
            raise TrainingError(
                f"params[{name}] is on {leaf.device}, the train step runs on {device}: "
                f"move the parameters there, or pass device={str(leaf.device.type)!r}")


def loss_and_grads(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                   remat: bool = True, flash: bool | None = None,
                   device: torch.device | str = "cuda"):
    """``(loss, grads)``: the mean next-token cross-entropy (fp32) of
    ``tokens`` [B, T] and its gradient, a new tree shaped like ``params``.
    ``device`` is where the step runs (the card unless the caller asks for
    the CPU): without a card the default raises, and so do parameters that
    lie elsewhere."""
    device = resolve_device(device)
    check_trainable(params)
    _check_on_device(params, device)
    tokens = tokens.to(device=params["final_norm"].device, dtype=torch.long)
    grads = tree_map(torch.zeros_like, params)
    top, layer_leaves = _autograd_leaves(params, grads, cfg.num_layers)
    logits = forward_train(top, cfg, tokens[:, :-1], remat=remat, flash=flash,
                           layer_leaves=layer_leaves)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1))
    del logits
    loss.backward()
    return loss.detach(), grads


def make_train_step(cfg: ModelConfig, tc: TrainConfig | None = None,
                    flash: bool | None = None, device: torch.device | str = "cuda"):
    """Return ``(optimizer, train_step)``.

    ``train_step(params, opt_state, tokens[B, T]) -> (params, opt_state,
    loss)``; ``params`` and ``opt_state`` are updated in place and handed
    back. ``flash`` is ``forward_train``'s (None: the flash kernels for
    T >= 64 on the card). ``device`` is where the step runs: the card by
    default, which raises ``EngineError`` here when there is none;
    ``train_step`` raises ``TrainingError`` for parameters that lie
    elsewhere (pass ``device="cpu"`` to train on the CPU)."""
    device = resolve_device(device)
    tc = tc or TrainConfig()
    opt = make_optimizer(tc)

    def train_step(params, opt_state, tokens):
        loss, grads = loss_and_grads(params, cfg, tokens, remat=tc.remat, flash=flash,
                                     device=device)
        opt.update(params, grads, opt_state)
        return params, opt_state, loss

    return opt, train_step
