"""Pipeline parallelism: a layer-staged GPipe schedule over a ``pp`` mesh
axis (counterpart of fei_tpu/parallel/pipeline.py).

The layer-stacked params ([L, ...] leaves, models/llama.py) split over pp:
stage i holds layers [i·L/n, (i+1)·L/n), and activations hop from stage to
stage with ``Mesh.ppermute``. The batch splits into M microbatches; the
GPipe schedule runs M + n - 1 steps, each stage one microbatch behind its
predecessor. Every rank embeds the whole batch (only stage 0 reads it) and
the last stage's outputs are summed over the axis (the others add zeros),
so every rank returns the logits, as the reference's psum broadcasts them.
Forward only, as the reference's own tests hold it.
"""

from __future__ import annotations

import torch

from fei_tpu_torch.models.configs import ModelConfig
from fei_tpu_torch.models.llama import (
    _layer,
    _logits,
    _norm,
    _rope_tables,
    embed_tokens,
    model_dtype,
)
from fei_tpu_torch.ops.quant import QTensor, QTensor4


def _stage_layers(layers: dict, cfg: ModelConfig, mesh, axis_name: str) -> list[dict]:
    """This stage's L/n contiguous layers, one dict each: sliced from
    whole [L, ...] leaves, or taken as they are from leaves that hold the
    stage's [L/n, ...] already."""
    n, stage = mesh.shape[axis_name], mesh.coords[axis_name]
    per = cfg.num_layers // n

    def lead(leaf):
        return (leaf[0] if isinstance(leaf, (QTensor, QTensor4)) else leaf).shape[0]

    def pick(leaf, i):
        j = i if lead(leaf) == per else stage * per + i
        if isinstance(leaf, (QTensor, QTensor4)):
            return type(leaf)(*(f[j] for f in leaf))
        return leaf[j]

    return [{name: pick(leaf, i) for name, leaf in layers.items()} for i in range(per)]


def _stage_apply(cfg: ModelConfig, local_layers: list[dict], x, positions, cos, sin):
    """Run this stage's layers over x [mb, T, h] with no cache."""
    kv_length = torch.zeros((x.shape[0],), dtype=torch.int32, device=x.device)
    for lp in local_layers:
        x = _layer(cfg, x, lp, None, None, kv_length, positions, cos, sin)
    return x


def _pipeline_shard(layers: list[dict], xs, positions, cos, sin, *, cfg: ModelConfig,
                    mesh, axis_name: str):
    """The GPipe schedule on one stage: xs [M, mb, T, h] the microbatched
    embeddings. Returns the last stage's outputs [M, mb, T, h] on every
    rank."""
    stage = mesh.coords[axis_name]
    n = mesh.shape[axis_name]
    M = xs.shape[0]
    perm = [(i, i + 1) for i in range(n - 1)]  # stage i -> i + 1
    recv = torch.zeros_like(xs[0])
    outs = torch.zeros_like(xs)
    for s in range(M + n - 1):
        mb_idx = s - stage  # the microbatch this stage works on now
        active = 0 <= mb_idx < M
        if active:
            x_in = xs[mb_idx] if stage == 0 else recv
            y = _stage_apply(cfg, layers, x_in, positions, cos, sin)
            if stage == n - 1:  # the last stage banks its finished microbatch
                outs[mb_idx] = y
        else:  # an idle step of the bubble: nothing to compute, the hop still pairs
            y = torch.zeros_like(recv)
        recv = mesh.ppermute(y, axis_name, perm)
    # every rank gets the last stage's results: the others add zeros
    if stage != n - 1:
        outs.zero_()
    return mesh.all_reduce(outs, axis_name)


def pipeline_forward_train(params: dict, cfg: ModelConfig, tokens: torch.Tensor, mesh,
                           num_micro: int, axis_name: str = "pp") -> torch.Tensor:
    """Cache-free forward with the layers pipelined over ``axis_name``;
    ``models.llama.forward_train``'s function. B must divide into
    ``num_micro`` microbatches and L over the axis. Returns logits
    [B, T, V] fp32 on every rank."""
    B, T = tokens.shape
    n = mesh.shape[axis_name]
    L = cfg.num_layers
    if L % n:
        raise ValueError(f"num_layers {L} must divide pp axis {n}")
    if B % num_micro:
        raise ValueError(f"batch {B} must divide num_micro {num_micro}")
    mb = B // num_micro
    dev = params["final_norm"].device
    positions = torch.arange(T, device=dev)[None, :].expand(mb, T)
    cos, sin = _rope_tables(cfg.rope_dim_, T, float(cfg.rope_theta), str(dev))
    dtype = model_dtype(params)
    x = embed_tokens(params, cfg, tokens.to(device=dev, dtype=torch.long), dtype)
    xs = x.reshape(num_micro, mb, T, -1)
    layers = _stage_layers(params["layers"], cfg, mesh, axis_name)
    ys = _pipeline_shard(layers, xs, positions, cos, sin, cfg=cfg, mesh=mesh,
                         axis_name=axis_name)
    x = ys.reshape(B, T, -1)
    x = _norm(x, params["final_norm"], cfg, b=params.get("final_norm_b"))
    return _logits(x, params, cfg, kernel_mesh=mesh)
