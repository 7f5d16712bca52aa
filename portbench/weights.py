"""Seeded weights, made on the device one tensor at a time.

Every tensor is drawn from its own generator, seeded from (``--seed``, the
tensor's name), so any single tensor can be made again alone: the program
gets the whole tree through ``params=``, and the reference remakes each
layer's tensors when it needs them. Linears, the router and the embedding
are normal(0, fan_in^-1/2); norm scales are 1 + 0.1 normal. Each tensor is
drawn in fp32 and rounded to bf16, the dtype the configurations serve in.

Names: ``embed``, ``lm_head``, ``final_norm`` and ``layers.<i>.<leaf>``,
where an MoE layer's expert leaves hold all of its experts ([E, in, out]).
"""

from __future__ import annotations

import hashlib

import torch

from portbench.spec import Model

NORM_SPREAD = 0.1


def tensor_seed(seed: int, name: str) -> int:
    digest = hashlib.sha256(f"{seed}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1  # 63 bits: manual_seed's range


def draw(seed: int, name: str, shape: tuple, fan_in: int | None, device) -> torch.Tensor:
    """One bf16 tensor; ``fan_in`` None draws a norm scale."""
    gen = torch.Generator(device=device).manual_seed(tensor_seed(seed, name))
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    x = 1.0 + NORM_SPREAD * x if fan_in is None else x * fan_in ** -0.5
    return x.to(torch.bfloat16)


def layer_leaves(m: Model) -> dict[str, tuple[tuple, int | None]]:
    """Each layer's leaves: name -> (shape, fan_in), in the program's
    [in, out] layout; fan_in None marks a norm scale."""
    h, d, H, K, I = m.hidden, m.head_dim, m.heads, m.kv_heads, m.inter
    leaves = {
        "attn_norm": ((h,), None),
        "wq": ((h, H * d), h),
        "wk": ((h, K * d), h),
        "wv": ((h, K * d), h),
        "wo": ((H * d, h), H * d),
        "mlp_norm": ((h,), None),
    }
    if m.is_moe:
        E = m.experts
        leaves.update(router=((h, E), h), w_gate=((E, h, I), h), w_up=((E, h, I), h),
                      w_down=((E, I, h), I))
    else:
        leaves.update(w_gate=((h, I), h), w_up=((h, I), h), w_down=((I, h), I))
    return leaves


# leaves that a quantized configuration stores in int8 (the router, the
# norms and the embedding stay bf16)
QUANTIZED = frozenset({"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head"})


def top_leaves(m: Model) -> dict[str, tuple[tuple, int | None]]:
    return {
        "embed": ((m.vocab, m.hidden), m.hidden),
        "final_norm": ((m.hidden,), None),
        "lm_head": ((m.hidden, m.vocab), m.hidden),
    }


def draw_layer(m: Model, seed: int, i: int, device) -> dict[str, torch.Tensor]:
    return {leaf: draw(seed, f"layers.{i}.{leaf}", shape, fan_in, device)
            for leaf, (shape, fan_in) in layer_leaves(m).items()}


def program_params(m: Model, seed: int, device, quantize_fn=None) -> dict:
    """The program's parameter tree: per-layer leaves stacked on a leading
    axis. With ``quantize_fn`` (the program's own int8 quantizer, for a
    quantized configuration) each tensor in ``QUANTIZED`` is quantized as
    it is made, so the bf16 model never exists whole."""
    def store(leaf, t):
        return quantize_fn(t) if quantize_fn is not None and leaf in QUANTIZED else t

    layers: dict = {}
    for i in range(m.layers):
        for leaf, t in draw_layer(m, seed, i, device).items():
            t = store(leaf, t)
            fields = t if isinstance(t, tuple) else (t,)
            if leaf not in layers:
                stacked = [torch.empty((m.layers, *f.shape), dtype=f.dtype, device=f.device)
                           for f in fields]
                layers[leaf] = type(t)(*stacked) if isinstance(t, tuple) else stacked[0]
            dst = layers[leaf] if isinstance(t, tuple) else (layers[leaf],)
            for d, f in zip(dst, fields):
                d[i] = f
        del t
    params = {"layers": layers}
    for leaf, (shape, fan_in) in top_leaves(m).items():
        params[leaf] = store(leaf, draw(seed, leaf, shape, fan_in, device))
    return params
