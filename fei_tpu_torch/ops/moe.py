"""Mixture-of-experts layer: Mixtral-style top-k routing over SwiGLU experts
(counterpart of fei_tpu/ops/moe.py).

Two formulations of one function, as in the JAX package:

- ``moe_mlp``, the dense oracle: every expert runs on every token and the
  router's normalized top-k weights, scattered into a dense [.., E] gate,
  zero out the experts a token did not pick.
- ``moe_mlp_routed``: each token runs only its k experts. The N·k
  (token, expert) assignments are sorted by expert (a stable sort: ties
  keep token order), gathered into contiguous row blocks, and the three
  SwiGLU products run as one matmul per expert over its block (the JAX
  package's ``lax.ragged_dot``, an XLA primitive, not a Pallas kernel).
  The block sizes are read on the host: one device-to-host copy per
  routed MoE layer (``ROUTED_SYNCS_PER_LAYER``). The combine inverts the
  sort to [N, k, H] and sums the k contributions in slot order, with no
  atomics, so two runs are bitwise equal.

Top-k takes the lower expert index first on ties, as ``jax.lax.top_k``
does (a stable descending sort). int8 experts (``QTensor`` [E, in, out]
with [E, 1, out] scales) enter the products raw (``ops.quant.wcast``) and
their scale is applied to each result before the nonlinearity
(``scale_expert_out``, ``scale_rows``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fei_tpu_torch.ops.quant import QTensor, scale_expert_out, scale_rows, wcast

# host copies of the routed form, per MoE layer: the expert block sizes
ROUTED_SYNCS_PER_LAYER = 1


def _route(logits: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(weights, experts), each [.., k]: the k largest fp32 router logits
    (lower index first on ties, as ``jax.lax.top_k``), softmax over them."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(vals[..., :k], dim=-1), idx[..., :k]


def moe_mlp(
    x: torch.Tensor,  # [B, T, H]
    router_w: torch.Tensor,  # [H, E]
    w_gate,  # [E, H, I] tensor or QTensor
    w_up,  # [E, H, I]
    w_down,  # [E, I, H]
    num_experts_per_tok: int,
) -> torch.Tensor:
    """Dense formulation: every expert on every token, gated by the
    normalized top-k weights (zero for the experts a token did not pick)."""
    B, T, H = x.shape
    E = router_w.shape[-1]
    xf = x.reshape(B * T, H)
    logits = xf.float() @ router_w.float()  # [N, E]
    topw, topi = _route(logits, num_experts_per_tok)
    weights = torch.einsum("nk,nke->ne", topw, F.one_hot(topi, E).float())

    def expert_mm(a, w):  # [E, N, in] or [N, in] @ [E, in, out] -> [E, N, out]
        return scale_expert_out(torch.matmul(a, wcast(w, a.dtype)), w, 0)

    gate = expert_mm(xf, w_gate)
    up = expert_mm(xf, w_up)
    act = F.silu(gate.float()).to(x.dtype) * up
    expert_out = expert_mm(act, w_down)  # [E, N, H]
    out = torch.einsum("ne,enh->nh", weights.to(x.dtype), expert_out)
    return out.reshape(B, T, H)


def _expert(w, e: int):
    """Expert ``e``'s [in, out] weight (a QTensor sliced field by field)."""
    return QTensor(w.q[e], w.s[e]) if isinstance(w, QTensor) else w[e]


def grouped_mm(xs: torch.Tensor, w, counts: list[int]) -> torch.Tensor:
    """``lax.ragged_dot``: rows [off_e, off_e + counts[e]) of ``xs`` times
    expert e's weight, one matmul per expert that has rows (an int8 expert
    cast to the compute dtype alone); the int8 scale is the caller's
    (``scale_rows``)."""
    out = xs.new_empty((xs.shape[0], w.shape[-1]))
    lo = 0
    for e, n in enumerate(counts):
        if n:
            out[lo:lo + n] = xs[lo:lo + n] @ wcast(_expert(w, e), xs.dtype)
        lo += n
    return out


def moe_mlp_routed(
    x: torch.Tensor,  # [B, T, H]
    router_w: torch.Tensor,  # [H, E]
    w_gate,  # [E, H, I]
    w_up,  # [E, H, I]
    w_down,  # [E, I, H]
    num_experts_per_tok: int,
) -> torch.Tensor:
    """Token-routed formulation: each token runs only its top-k experts
    (k/E of the dense form's expert products)."""
    B, T, H = x.shape
    E = router_w.shape[-1]
    k = num_experts_per_tok
    N = B * T
    xf = x.reshape(N, H)
    logits = xf.float() @ router_w.float()
    topw, topi = _route(logits, k)  # [N, k]

    flat_expert = topi.reshape(-1)  # [N*k]
    order = torch.argsort(flat_expert, stable=True)  # ties keep token order
    token_of = order // k  # source token of each sorted assignment
    xs = xf[token_of]  # [N*k, H]
    expert_of = flat_expert[order]
    counts = torch.bincount(flat_expert, minlength=E).tolist()  # the host copy

    gate = scale_rows(grouped_mm(xs, w_gate, counts), w_gate, expert_of)
    up = scale_rows(grouped_mm(xs, w_up, counts), w_up, expert_of)
    act = F.silu(gate.float()).to(x.dtype) * up
    outs = scale_rows(grouped_mm(act, w_down, counts), w_down, expert_of)  # [N*k, H]

    wf = topw.reshape(-1)[order].to(x.dtype)
    contrib = outs * wf[:, None]
    # back to assignment order [N, k, H]; sum the k slots in a fixed order
    inv = torch.empty_like(order)
    inv[order] = torch.arange(N * k, device=order.device)
    per = contrib[inv].reshape(N, k, H)
    out = torch.zeros((N, H), dtype=x.dtype, device=x.device)
    for j in range(k):
        out = out + per[:, j]
    return out.reshape(B, T, H)
