"""K5a's and K5b's design per head dim, and K5b's schedule of causal work.

``kernel_design`` names the kernel each head dim launches, in the forward
and the backward alike: the wgmma pipeline at D 64 and 128, the first
mma.sync kernels at D 80 and 256, and an error for any other D.
``flash_attention_bwd_dkv_steps`` is the dk/dv kernel's schedule in plain
Python (the (query head, q tile) steps each block walks, for each cluster
size the launch may pick); it is held here against a brute-force count of
the live (key tile, q tile) pairs from ``ops.attention.visible_mask``, so
that the work it reports is the work there is, and against the balance the
pairing of key tiles promises. The ``cuda``-marked test at the end, which
skips without a card, holds it against the counts the kernel itself
reports; ``tests/test_torch_flash_bwd.py`` and chip_smoke.py hold the
kernels against the plain backward.
"""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import numpy as np
import pytest
import torch

from fei_tpu_torch.ops.attention import visible_mask
from fei_tpu_torch.ops.kernels.flash_attention import (
    DESIGNS,
    DKV_TILES,
    HEAD_DIMS,
    flash_attention_bwd_dkv_block_steps,
    flash_attention_bwd_dkv_steps,
    flash_attention_fwd,
    kernel_design,
)

# name: (T, S, H, K, D, q_start, kv_length, window): chip_smoke's backward
# shapes and a few smaller ones
SCHEDULES = {
    "train llama3-8b": (2048, 2048, 32, 8, 128, [0], [2048], 0),
    "ragged": (512, 1024, 32, 8, 128, [0, 256], [512, 700], 0),
    "unaligned": (333, 555, 8, 2, 128, [100], [433], 0),
    "window": (4096, 4096, 32, 8, 128, [0], [4096], 1024),
    "MHA D=64": (512, 512, 16, 16, 64, [0], [512], 0),
    "odd key tiles": (300, 300, 4, 2, 64, [0], [300], 0),
    "dead row": (256, 512, 8, 2, 128, [0, 0], [256, 0], 0),
    "D=80 phi-2": (512, 512, 32, 32, 80, [0], [512], 0),
    "D=256 gemma": (512, 512, 16, 16, 256, [0], [512], 0),
}


@pytest.mark.parametrize("D", sorted(DESIGNS))
def test_kernel_design_bwd_per_head_dim(D):
    want = "wgmma" if D in (64, 128) else "mma.sync"
    assert kernel_design(D) == want


@pytest.mark.parametrize("D", [32, 96, 112, 160, 0])
def test_kernel_design_bwd_refuses_other_head_dims(D):
    assert D not in HEAD_DIMS
    with pytest.raises(ValueError, match="head dim"):
        kernel_design(D)


def _live_pairs(T, S, H, K, q_start, kv_length, window, bn, bm):
    """Brute force: G times the live (key tile, q tile) pairs of each key
    tile, per batch row, from the visibility mask itself."""
    pos = torch.tensor(q_start)[:, None] + torch.arange(T)[None, :]
    vis = visible_mask(pos, torch.tensor(kv_length), S, window)  # [B, T, S]
    counts = []
    for b in range(len(q_start)):
        for k0 in range(0, S, bn):
            sees = vis[b, :, k0:k0 + bn].any(dim=1)  # [T]: the query sees a key of the tile
            qts = {int(t) // bm for t in torch.nonzero(sees).flatten()}
            counts.append((H // K) * (max(qts) - min(qts) + 1 if qts else 0))
    return counts


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_dkv_steps_cover_exactly_the_live_work(name):
    """Every key tile's steps, summed over the blocks, are G times its live
    q-tile span, for every batch row; the number of blocks is the kernel's
    grid (for wgmma a cluster of 2, 4 or 8 blocks a pair of 128-key tiles,
    which split each tile's steps within one; for mma.sync one tile a
    block)."""
    T, S, H, K, D, qs, kl, window = SCHEDULES[name]
    wgmma = kernel_design(D) == "wgmma"
    bn, bm = DKV_TILES[D]
    n_kt = -(-S // bn)
    live = K * sum(_live_pairs(T, S, H, K, qs, kl, window, bn, bm))
    for cluster in (2, 4, 8) if wgmma else (2,):
        steps = flash_attention_bwd_dkv_steps(T, S, H, K, D, qs, kl, window, cluster)
        assert len(steps) == (cluster * -(-n_kt // 2) if wgmma else n_kt) * K * len(qs)
        assert sum(steps) == live
        if wgmma:  # the blocks of a cluster differ by one step per tile at most
            for c in range(0, len(steps), cluster):
                assert max(steps[c:c + cluster]) - min(steps[c:c + cluster]) <= 2


def test_dkv_pairing_balances_the_causal_training_shape():
    """At the training shape (T = S = 2048 from position 0) every block of
    the wgmma design walks the same half of 34 q tiles times 4 heads; one
    key tile a block (the mma.sync schedule at D = 80) leaves the first
    blocks with about twice the mean."""
    steps = flash_attention_bwd_dkv_steps(2048, 2048, 32, 8, 128, [0], [2048])
    assert len(steps) == 128 and set(steps) == {68}
    one_tile = flash_attention_bwd_dkv_steps(2048, 2048, 32, 8, 80, [0], [2048])
    assert max(one_tile) / np.mean(one_tile) > 1.9


def test_dkv_steps_of_a_dead_batch_row_are_zero():
    """Blocks run (key tile pair, batch row, kv head, rank in the cluster),
    so the dead second row's blocks are every other group of K * 2."""
    steps = flash_attention_bwd_dkv_steps(256, 512, 8, 2, 128, [0, 0], [256, 0])
    row = [(i // 4) % 2 for i in range(len(steps))]
    assert sum(s for s, b in zip(steps, row) if b == 1) == 0
    assert sum(s for s, b in zip(steps, row) if b == 0) > 0


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernels are CUDA C++ for sm_90a")
    return torch.device("cuda")


def test_block_steps_need_the_card():
    q = torch.zeros(1, 64, 2, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 64, 1, 128, dtype=torch.bfloat16)
    stats = torch.zeros(1, 2, 64)
    qs, kl = torch.tensor([0], dtype=torch.int32), torch.tensor([64], dtype=torch.int32)
    with pytest.raises(ValueError, match="cuda"):
        flash_attention_bwd_dkv_block_steps(q, k, k, qs, kl, stats, stats, q)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [n for n, c in SCHEDULES.items() if c[4] in (64, 128)])
def test_kernel_walks_the_schedule_on_card(cuda_device, name):
    """The steps the wgmma kernel counts per block, in launch order, are
    the schedule's for the cluster size the launch picked."""
    T, S, H, K, D, qs_l, kl_l, window = SCHEDULES[name]
    B = len(qs_l)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    mk = lambda *shape: torch.randn(*shape, generator=gen, device=cuda_device).bfloat16()
    q, k, v, dout = mk(B, T, H, D), mk(B, S, K, D), mk(B, S, K, D), mk(B, T, H, D)
    qs = torch.tensor(qs_l, dtype=torch.int32, device=cuda_device)
    kl = torch.tensor(kl_l, dtype=torch.int32, device=cuda_device)
    out, lse = flash_attention_fwd(q, k, v, qs, kl, window=window)
    dsum = (dout.float() * out).sum(-1).permute(0, 2, 1).contiguous()
    got = flash_attention_bwd_dkv_block_steps(q, k, v, qs, kl, lse, dsum, dout, window=window)
    units = -(-S // 256) * K * B
    assert len(got) % units == 0 and len(got) // units in (2, 4, 8)
    assert got == flash_attention_bwd_dkv_steps(T, S, H, K, D, qs_l, kl_l, window,
                                                len(got) // units)
