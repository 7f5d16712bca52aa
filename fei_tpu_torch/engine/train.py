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

**Over a mesh** (``make_train_step(..., mesh=)``, the engine's mesh) the
step trains what the reference's GSPMD step trains: each rank holds its
Megatron shards (``parallel.sharding.shard_params``: heads and the MLP's
intermediate dim over tp, experts over ep), the batch splits over dp, and
the forward's collectives carry the gradient (``parallel.mesh``), so each
rank's backward yields its shards' gradients and every replicated leaf's
whole gradient. The gradients are averaged over dp; the clip's global
norm sums each sharded leaf's squares over its axes and each replicated
leaf's once; AdamW updates each rank's shards in place; the loss returned
is the global batch mean. ``save_checkpoint(..., shardings=
train_shardings(...))`` writes the whole tensors, which
``restore_checkpoint(shardings=)`` reads back as any rank's slices.
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
    def global_norm(self, grads: dict, axes: dict | None = None, mesh=None) -> torch.Tensor:
        """sqrt of the sum of squares over every leaf, fp32, on the device.
        ``axes`` maps a leaf's name to the mesh axes it is sharded over:
        each group of leaves sharded alike sums its squares over its axes
        (a replicated leaf counts once)."""
        flat = flatten(grads)
        dev = next(iter(flat.values())).device
        groups: dict[tuple, torch.Tensor] = {}
        for name, g in flat.items():
            key = tuple((axes or {}).get(name, ()))
            total = groups.setdefault(key, torch.zeros((), dtype=torch.float32, device=dev))
            for part in _slices(g):
                total += torch.linalg.vector_norm(part, dtype=torch.float32).square()
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for key in sorted(groups):
            sq = groups[key]
            for ax in key:
                sq = mesh.all_reduce(sq, ax)
            total += sq
        return total.sqrt()

    @torch.no_grad()
    def update(self, params: dict, grads: dict, opt_state: dict,
               gnorm: torch.Tensor | None = None) -> None:
        """One step, in place in ``params`` and ``opt_state``; ``grads`` is
        left as it is. No host synchronisation: the clip factor and the bias
        corrections stay 0-d tensors on the device. ``gnorm``: the global
        norm when the caller took it over a mesh."""
        tc = self.tc
        p_flat, g_flat = flatten(params), flatten(grads)
        mu_flat, nu_flat = flatten(opt_state["mu"]), flatten(opt_state["nu"])
        for name, p in p_flat.items():
            for other in (g_flat, mu_flat, nu_flat):
                if name not in other or other[name].shape != p.shape:
                    raise TrainingError(f"gradient or optimizer state does not fit leaf {name}")
        if gnorm is None:
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


def train_axes(params: dict, cfg: ModelConfig, mesh) -> dict:
    """{leaf name: the mesh axes (size > 1) it is sharded over} under the
    Megatron tables; raises ``TrainingError`` when a leaf is not this
    rank's Megatron shard (a replicated profile's whole leaf under tp
    would take a partial gradient)."""
    from fei_tpu_torch.models.llama import init_params
    from fei_tpu_torch.parallel.sharding import param_shardings

    whole = init_params(cfg, dtype=torch.float32, device="meta")
    sh = flatten(param_shardings(whole, mesh, cfg.is_moe))
    want, got = flatten(whole), flatten(params)
    if want.keys() != got.keys():
        raise TrainingError(f"params do not have {cfg.name}'s leaves: "
                            f"{sorted(want.keys() ^ got.keys())[:4]}")
    axes = {}
    for name, s in sh.items():
        local = s.local_shape(tuple(want[name].shape))
        if tuple(got[name].shape) != local:
            raise TrainingError(
                f"params[{name}] is {tuple(got[name].shape)}, not this rank's Megatron "
                f"shard {local} on {mesh!r}: train on shard_params(..., mesh)'s leaves")
        axes[name] = tuple(ax for ax in s.spec if ax is not None and mesh.shape[ax] > 1)
    return axes


def train_shardings(params: dict, cfg: ModelConfig, mesh) -> dict:
    """The ``shardings`` composite of a sharded training run's checkpoint:
    the params' Megatron shardings, and the same for the optimizer's
    moments (its count restores whole)."""
    from fei_tpu_torch.parallel.sharding import param_shardings

    ps = param_shardings(params, mesh, cfg.is_moe)
    return {"params": ps, "opt_state": {"mu": ps, "nu": ps}}


def _dp_rows(tokens: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of the global batch (the batch splits over dp)."""
    dp = mesh.shape["dp"]
    if tokens.shape[0] % dp:
        raise TrainingError(f"batch {tokens.shape[0]} does not split over dp={dp}")
    n = tokens.shape[0] // dp
    c = mesh.coords["dp"]
    return tokens[c * n:(c + 1) * n]


def loss_and_grads(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                   remat: bool = True, flash: bool | None = None,
                   device: torch.device | str = "cuda", mesh=None):
    """``(loss, grads)``: the mean next-token cross-entropy (fp32) of
    ``tokens`` [B, T] and its gradient, a new tree shaped like ``params``.
    ``device`` is where the step runs (the card unless the caller asks for
    the CPU): without a card the default raises, and so do parameters that
    lie elsewhere. ``mesh``: ``params`` are this rank's Megatron shards;
    every rank passes the same global ``tokens``, takes its dp rows, and
    gets the global loss and its shards' gradients averaged over dp."""
    device = resolve_device(device)
    check_trainable(params)
    _check_on_device(params, device)
    tokens = tokens.to(device=params["final_norm"].device, dtype=torch.long)
    if mesh is not None:
        tokens = _dp_rows(tokens, mesh)
    grads = tree_map(torch.zeros_like, params)
    top, layer_leaves = _autograd_leaves(params, grads, cfg.num_layers)
    logits = forward_train(top, cfg, tokens[:, :-1], remat=remat, flash=flash,
                           layer_leaves=layer_leaves, kernel_mesh=mesh)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1))
    del logits
    loss.backward()
    loss = loss.detach()
    if mesh is not None and mesh.shape["dp"] > 1:
        dp = mesh.shape["dp"]
        loss = mesh.all_reduce(loss, "dp") / dp
        with torch.no_grad():
            for g in flatten(grads).values():
                g.copy_(mesh.all_reduce(g, "dp") / dp)
    return loss, grads


def make_train_step(cfg: ModelConfig, tc: TrainConfig | None = None,
                    flash: bool | None = None, device: torch.device | str = "cuda",
                    mesh=None):
    """Return ``(optimizer, train_step)``.

    ``train_step(params, opt_state, tokens[B, T]) -> (params, opt_state,
    loss)``; ``params`` and ``opt_state`` are updated in place and handed
    back. ``flash`` is ``forward_train``'s (None: the flash kernels for
    T >= 64 on the card). ``device`` is where the step runs: the card by
    default, which raises ``EngineError`` here when there is none;
    ``train_step`` raises ``TrainingError`` for parameters that lie
    elsewhere (pass ``device="cpu"`` to train on the CPU). ``mesh`` (a
    bound mesh; every rank calls the step with the same global batch):
    train this rank's Megatron shards (see the module docstring)."""
    device = resolve_device(device)
    tc = tc or TrainConfig()
    opt = make_optimizer(tc)
    if mesh is not None and mesh.size == 1:
        mesh = None

    axes_of: dict = {}

    def train_step(params, opt_state, tokens):
        axes = None
        if mesh is not None:  # the leaves' axes, checked once
            if "axes" not in axes_of:
                axes_of["axes"] = train_axes(params, cfg, mesh)
            axes = axes_of["axes"]
        loss, grads = loss_and_grads(params, cfg, tokens, remat=tc.remat, flash=flash,
                                     device=device, mesh=mesh)
        gnorm = None if mesh is None else opt.global_norm(grads, axes, mesh)
        opt.update(params, grads, opt_state, gnorm=gnorm)
        return params, opt_state, loss

    return opt, train_step
