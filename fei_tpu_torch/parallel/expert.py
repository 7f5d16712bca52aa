"""Expert parallelism: MoE with experts resident per rank over ``ep``
(counterpart of fei_tpu/parallel/expert.py).

Two formulations, each a function of one rank's view (every rank calls it
with the same replicated tokens; the collectives pair up):

1. ``moe_mlp_ep`` — dense-local: every rank runs its resident experts on
   every token and one all_reduce combines. No routing traffic, E/n of
   the experts' compute on each rank; the oracle of the ep path.
2. ``moe_mlp_ep_routed`` — token-routed (GShard): each rank routes its
   slice of the tokens, one-hot dispatch/combine masks keep every shape
   static (capacity slots per expert per source rank), and two
   ``all_to_all``s carry the activations to the experts' owners and back.

Expert weights may come whole ([E, ...], as the reference's public
functions take them) or as the rank's slice ([E/n, ...], an engine's
leaves under the sharded profile); a whole leaf is sliced here
(``_wspec``: a QTensor's scales follow their weight). Within each expert
the intermediate dim may also be split over tp (the Megatron profile);
then the partial products are all_reduced over tp.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fei_tpu_torch.ops.moe import _route
from fei_tpu_torch.ops.quant import QTensor, scale_expert_out, wcast


def _wspec(w, E: int, mesh, axis_name: str):
    """This rank's E/n experts of ``w``: a whole leaf ([E, ...]) is sliced
    over ``axis_name`` (a QTensor field by field: its [E, 1, out] scales
    follow the experts), a leaf already sliced passes."""
    n, c = mesh.shape[axis_name], mesh.coords[axis_name]
    lead = (w.q if isinstance(w, QTensor) else w).shape[0]
    if lead != E:
        return w
    step = E // n
    if isinstance(w, QTensor):
        return QTensor(q=w.q[c * step:(c + 1) * step], s=w.s[c * step:(c + 1) * step])
    return w[c * step:(c + 1) * step]


def _i_split(w_down, I_full: int | None) -> bool:
    """True when the experts' intermediate dim is split over tp here
    (``w_down`` [E_local, I/tp, H]): the products are partial sums."""
    rows = (w_down.q if isinstance(w_down, QTensor) else w_down).shape[-2]
    return I_full is not None and rows != I_full


def _moe_shard(x, router_w, w_gate, w_up, w_down, *, k: int, mesh, axis_name: str,
               I_full: int | None = None):
    """One rank's dense-local body: x [B, T, H] and router_w [H, E] whole,
    w_gate/w_up [E_local, H, I], w_down [E_local, I, H]. Under autograd the
    experts' input and the routing weights sum their gradients over the
    axes that split the work (``Mesh.sum_grad``)."""
    B, T, H = x.shape
    E = router_w.shape[-1]
    E_local = (w_gate.q if isinstance(w_gate, QTensor) else w_gate).shape[0]
    offset = mesh.coords[axis_name] * E_local
    split = _i_split(w_down, I_full)
    axes = [axis_name] + (["tp"] if split else [])

    xf = x.reshape(B * T, H)
    logits = xf.float() @ router_w.float()
    topw, topi = _route(logits, k)
    weights = torch.einsum("nk,nke->ne", topw, F.one_hot(topi, E).float())
    xe = xf
    for ax in axes:
        xe = mesh.sum_grad(xe, ax)
        weights = mesh.sum_grad(weights, ax)
    local_weights = weights[:, offset:offset + E_local]

    def expert_mm(a, w):
        return scale_expert_out(torch.matmul(a, wcast(w, a.dtype)), w, 0)

    gate = expert_mm(xe, w_gate)
    up = expert_mm(xe, w_up)
    act = F.silu(gate.float()).to(x.dtype) * up
    expert_out = expert_mm(act, w_down)  # [E_local, N, H]
    partial = torch.einsum("ne,enh->nh", local_weights.to(x.dtype), expert_out)
    for ax in axes:
        partial = mesh.all_reduce(partial, ax)
    return partial.reshape(B, T, H)


def moe_mlp_ep(x, router_w, w_gate, w_up, w_down, num_experts_per_tok: int, mesh,
               axis_name: str = "ep", intermediate_size: int | None = None):
    """Expert-parallel MoE: the axis size must divide E (each rank holds
    E/n whole experts). Numerically ``ops.moe.moe_mlp``: each rank
    computes its experts and one all_reduce combines (fp32 sums).
    ``intermediate_size`` names the experts' whole I, so that a leaf split
    over tp is recognised as one."""
    E = router_w.shape[-1]
    n = mesh.shape[axis_name]
    if E % n:
        raise ValueError(f"ep axis size {n} must divide num_experts {E} evenly")
    w_gate, w_up, w_down = (_wspec(w, E, mesh, axis_name) for w in (w_gate, w_up, w_down))
    return _moe_shard(x, router_w, w_gate, w_up, w_down, k=num_experts_per_tok, mesh=mesh,
                      axis_name=axis_name, I_full=intermediate_size)


def _dispatch_masks(xs, router_w, valid, k: int, C: int):
    """GShard routing of a rank's token slice: (dispatch [Nl, E, C],
    combine [Nl, E, C]) one-hot masks. Slots are claimed by a choice-major
    cumsum, so first choices fill first and a full expert drops second
    choices before any first; padding rows route nowhere."""
    Nl = xs.shape[0]
    E = router_w.shape[-1]
    logits = xs.float() @ router_w.float()
    topw, topi = _route(logits, k)
    weights = topw * valid[:, None]  # [Nl, k]
    oh = F.one_hot(topi, E).float() * valid[:, None, None]  # [Nl, k, E]
    ohm = oh.transpose(0, 1).reshape(k * Nl, E)
    pos = torch.cumsum(ohm, dim=0) - ohm  # slot index per assignment
    kept = (pos < C).float() * ohm
    slot = F.one_hot(pos.long().clamp(max=C), C + 1)[..., :C].float()
    assign = (slot * kept[..., None]).reshape(k, Nl, E, C)
    dispatch = assign.sum(0)
    combine = torch.einsum("nk,knec->nec", weights, assign)
    return dispatch, combine


def _routed_shard(x, router_w, w_gate, w_up, w_down, *, k: int, capacity: int, mesh,
                  axis_name: str, tp_axis: str | None = None, I_full: int | None = None):
    """One rank's token-routed body: it routes its ``Nl = ceil(N/n)``
    token slice into (expert, slot) masks, sends each expert's rows to its
    owner (``all_to_all``), runs its experts on what it received, returns
    the results (the inverse ``all_to_all``), combines, and all_gathers the
    token slices. ``capacity`` slots per expert per source rank; overflow
    is dropped (capacity = Nl is dropless)."""
    B, T, H = x.shape
    C = capacity
    n = mesh.shape[axis_name]
    idx = mesh.coords[axis_name]
    N = B * T
    Nl = -(-N // n)
    xf = x.reshape(N, H)
    if Nl * n > N:
        xf = F.pad(xf, (0, 0, 0, Nl * n - N))
    xs = xf[idx * Nl:(idx + 1) * Nl]
    valid = ((idx * Nl + torch.arange(Nl, device=x.device)) < N).float()
    dispatch, combine = _dispatch_masks(xs, router_w, valid, k, C)

    dispatched = torch.einsum("nh,nec->ech", xs.float(), dispatch).to(x.dtype)  # [E, C, H]
    # dispatch trip: the expert axis scatters to the owners, the source
    # ranks' slots concatenate
    recv = mesh.all_to_all(dispatched, axis_name, split_dim=0, concat_dim=1)  # [E_l, n*C, H]

    def expert_mm(a, w):
        return scale_expert_out(torch.matmul(a, wcast(w, a.dtype)), w, 0)

    gate = expert_mm(recv, w_gate)
    up = expert_mm(recv, w_up)
    act = F.silu(gate.float()).to(recv.dtype) * up
    expert_out = expert_mm(act, w_down)  # [E_l, n*C, H]
    if tp_axis is not None and _i_split(w_down, I_full):
        # the experts' I is tp-split: one all_reduce completes each
        # expert's down-projection
        expert_out = mesh.all_reduce(expert_out, tp_axis)
    back = mesh.all_to_all(expert_out, axis_name, split_dim=1, concat_dim=0)  # [E, C, H]
    out_local = torch.einsum("ech,nec->nh", back.float(), combine).to(x.dtype)
    out = mesh.all_gather(out_local, axis_name, dim=0)
    return out[:N].reshape(B, T, H)


def routed_capacity(tokens_per_shard: int, num_experts: int, k: int,
                    capacity_factor: float) -> int:
    """Capacity slots per expert per source rank. ``capacity_factor`` 1.0
    is the perfectly balanced load; serving uses 1.25-2.0, dropless tests
    capacity == tokens per rank."""
    return max(1, -(-int(tokens_per_shard * k * capacity_factor) // num_experts))


def moe_mlp_ep_routed(x, router_w, w_gate, w_up, w_down, num_experts_per_tok: int, mesh,
                      axis_name: str = "ep", capacity_factor: float = 2.0,
                      dropless: bool = False, tp_axis: str | None = None,
                      intermediate_size: int | None = None):
    """Token-routed expert parallelism (a drop-in for ``moe_mlp_ep``).
    Expert compute per rank is E·C·n rows, ≈ capacity_factor·k/E of the
    dense form (``expert_flops_share``). ``dropless=True`` sizes capacity
    to the worst case and is numerically ``ops.moe.moe_mlp``. ``tp_axis``
    names the axis splitting each expert's I (the Megatron profile)."""
    E = router_w.shape[-1]
    n = mesh.shape[axis_name]
    if E % n:
        raise ValueError(f"ep axis size {n} must divide num_experts {E} evenly")
    B, T, _ = x.shape
    Nl = -(-(B * T) // n)
    C = Nl if dropless else routed_capacity(Nl, E, num_experts_per_tok, capacity_factor)
    w_gate, w_up, w_down = (_wspec(w, E, mesh, axis_name) for w in (w_gate, w_up, w_down))
    return _routed_shard(x, router_w, w_gate, w_up, w_down, k=num_experts_per_tok,
                         capacity=C, mesh=mesh, axis_name=axis_name, tp_axis=tp_axis,
                         I_full=intermediate_size)


def expert_flops_share(num_tokens: int, num_experts: int, k: int, ep: int,
                       capacity_factor: float = 2.0) -> tuple[int, int]:
    """(routed, dense) expert-matmul row counts per rank: the FLOPs saving
    of token routing. Dense-local EP runs N·E/n rows a rank; routed runs
    E·C rows with C slots per expert per source rank. Ratio ≈
    capacity_factor·k/E."""
    Nl = -(-num_tokens // ep)
    C = routed_capacity(Nl, num_experts, k, capacity_factor)
    return num_experts * C, num_tokens * (num_experts // ep)
