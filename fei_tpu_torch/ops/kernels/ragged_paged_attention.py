"""Ragged paged attention (K3): the CUDA kernel's wrapper and its plain version.

Counterpart of fei_tpu/ops/pallas/ragged_paged_attention.py
(``ragged_paged_attention`` over ``_ragged_kernel``). The kernel is
``fei_tpu_torch/csrc/ragged_paged_attention.cu``, K2's body
(``csrc/paged_attention.cuh``) with per-row metadata: row b carries its
first position's key limit, how many of its R query positions are live
(``q_lens``) and whether it is a decode row (``modes`` 1: at most one live
position). Decode rows and prefill-chunk groups share one launch.

``ragged_paged_attention`` launches the kernel for CUDA tensors and raises
when it cannot; tensors on the CPU take the plain version
(``ragged_paged_attention_plain``). ``ragged_paged_attention.launches``
counts launches (``int8_launches`` those over int8 pools). The tolerance
is K2's (``paged_rows_tolerance``) with the effective q_lens.
``ragged_paged_attention_sharded`` is the tensor-parallel wrapper (K3 on
the rank's kv heads, the heads gathered).
"""

from __future__ import annotations

import threading

import torch

from fei_tpu_torch.ops.kernels.paged_attention import launch, paged_rows_plain

KERNEL = "ragged_paged_attention"

_COUNT_LOCK = threading.Lock()


def effective_q_lens(q_lens: torch.Tensor, modes: torch.Tensor | None) -> torch.Tensor:
    """q_lens with decode rows (mode 1) cut to at most one position."""
    if modes is None:
        return q_lens
    return torch.where(modes == 1, q_lens.clamp(max=1), q_lens).to(torch.int32)


def ragged_paged_attention_plain(q, k_pages, v_pages, block_table, limits, q_lens,
                                 modes=None, scale=None, k_scales=None,
                                 v_scales=None, window=0) -> torch.Tensor:
    """The kernel's function in plain PyTorch (K2's plain rows with the
    effective q_lens). Returns [Bv, R, H, D]; dead positions are zeros."""
    return paged_rows_plain(q, k_pages, v_pages, block_table, limits,
                            effective_q_lens(q_lens, modes), scale, k_scales,
                            v_scales, window)


def ragged_paged_attention(
    q: torch.Tensor,  # [Bv, R, H, D] R query positions per virtual row
    k_pages: torch.Tensor,  # [P, K, ps, D]
    v_pages: torch.Tensor,
    block_table: torch.Tensor,  # [Bv, max_pages] int32
    limits: torch.Tensor,  # [Bv] int32: first position's key limit (start + 1)
    q_lens: torch.Tensor,  # [Bv] int32 live positions (0 = dead row)
    modes: torch.Tensor | None = None,  # [Bv] int32: 1 = decode row
    scale: float | None = None,
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
    window: int = 0,
) -> torch.Tensor:
    """Mixed prefill + decode paged attention in one launch. A decode row is
    (limit = length + 1, q_len = 1, mode = 1); a chunk group starting at
    absolute position s is (limit = s + 1, q_len <= R, mode = 0). All rows'
    K/V must already be in the pool. Returns [Bv, R, H, D]."""
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(q, k_pages, v_pages, block_table, limits,
                                            q_lens, modes, scale, k_scales, v_scales,
                                            window)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention runs on cuda or cpu, not {q.device}")
    if modes is None:
        modes = torch.zeros_like(q_lens)
    out = launch(KERNEL, "fei_ragged_paged_attention", q, k_pages, v_pages,
                 block_table, [("limits", limits), ("q_lens", q_lens),
                               ("modes", modes)],
                 scale, k_scales, v_scales, window)
    with _COUNT_LOCK:
        ragged_paged_attention.launches += 1
        ragged_paged_attention.int8_launches += int(k_scales is not None)
    return out


ragged_paged_attention.launches = 0
ragged_paged_attention.int8_launches = 0


def ragged_paged_attention_sharded(
    q: torch.Tensor,  # [Bv, R, H/tp, D] this rank's heads
    k_pages: torch.Tensor,  # [P, K/tp, ps, D] this rank's kv heads
    v_pages: torch.Tensor,
    block_table: torch.Tensor,
    limits: torch.Tensor,
    q_lens: torch.Tensor,
    modes: torch.Tensor | None = None,
    mesh=None,
    axis_name: str = "tp",
    k_scales: torch.Tensor | None = None,
    v_scales: torch.Tensor | None = None,
    window: int = 0,
) -> torch.Tensor:
    """Tensor-parallel ragged attention: K3 on this rank's kv heads, the
    heads gathered inside the wrapper (``paged_attention._sharded_paged``).
    A dp axis splits the virtual rows only when they divide evenly (they
    rarely do for a merged prefill + decode batch). Returns [Bv, R, H, D]."""
    from fei_tpu_torch.ops.kernels.paged_attention import _sharded_paged

    if mesh is None:
        raise ValueError("ragged_paged_attention_sharded needs a mesh")
    if modes is None:
        modes = torch.zeros_like(q_lens)
    return _sharded_paged(ragged_paged_attention, 2, q, k_pages, v_pages, block_table,
                          [limits, q_lens, modes], mesh, axis_name, k_scales, v_scales,
                          window)
