"""The port's flash-attention wrapper against the JAX Pallas kernel.

On the CPU the wrapper runs its plain version (the kernel is CUDA only);
the JAX side runs ``fei_tpu.ops.pallas.flash_attention`` in interpret mode,
as the JAX package's own tests do. Inputs come from numpy with a fixed
seed; tolerance atol 1e-5 in fp32 (online vs two-pass softmax: summation
order only). The kernel itself is held against the plain version by the
``cuda``-marked test, which skips without a card, and by chip_smoke.py.
jax is imported inside the parity test only, so that the ``cuda`` test
also runs where jax is not installed (``pytest -m cuda --noconftest``).
"""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import numpy as np
import pytest
import torch

from fei_tpu_torch.ops.attention import NEG_INF, visible_mask
from fei_tpu_torch.ops.kernels.flash_attention import (
    HEAD_DIMS,
    flash_attention,
    flash_attention_reference,
    flash_attention_tolerance,
    kernel_design,
)

CASES = {
    # name: (B, T, H, K, D, S, q_start, kv_length, window)
    "q_start": (1, 16, 4, 2, 32, 48, [20], [36], 0),
    "ragged": (2, 16, 4, 2, 32, 48, [0, 10], [16, 20], 0),
    "window": (1, 24, 4, 4, 32, 48, [8], [32], 6),
    # batch row 1 has no live key at all: the kernel contract writes zeros
    "dead_row": (2, 8, 4, 2, 32, 32, [0, 0], [8, 0], 0),
}


def _inputs(B, T, H, K, D, S, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, K, D)).astype(np.float32)
    v = rng.standard_normal((B, S, K, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("name", list(CASES))
def test_flash_matches_pallas_interpret(name):
    jnp = pytest.importorskip("jax.numpy")
    from fei_tpu.ops.pallas.flash_attention import flash_attention as jax_flash

    B, T, H, K, D, S, qs, kl, window = CASES[name]
    q, k, v = _inputs(B, T, H, K, D, S)
    qs, kl = np.asarray(qs, np.int32), np.asarray(kl, np.int32)
    want = jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qs),
        jnp.asarray(kl), window=window, interpret=True,
    )
    got = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(qs), torch.from_numpy(kl), window=window,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    if name == "dead_row":
        assert not got[1].any()


def test_cpu_dispatch_takes_plain_path():
    """A CPU tensor never reaches the kernel: the plain version runs and
    the launch count does not move."""
    q, k, v = _inputs(1, 8, 4, 2, 32, 16)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.tensor([0], dtype=torch.int32), torch.tensor([8], dtype=torch.int32))
    before = flash_attention.launches
    got = flash_attention(*args)
    assert flash_attention.launches == before
    assert torch.equal(got, flash_attention_reference(*args))


def _bf16_emulation(q, k, v, q_start, kv_length, window):
    """The kernel's arithmetic on the CPU: fp32 scores and row sums, the
    softmax weights rounded to bf16 before the P.V product, the output
    rounded to bf16."""
    B, T, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    pos = q_start.long()[:, None] + torch.arange(T)[None, :]
    s = torch.einsum("btkgd,bskd->btkgs", q.reshape(B, T, K, H // K, D), k) * D ** -0.5
    vis = visible_mask(pos, kv_length, S, window)[:, :, None, None, :]
    s = torch.where(vis, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True)) * vis
    o = torch.einsum("btkgs,bskd->btkgd", p.bfloat16().float(), v)
    o = o / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return o.reshape(B, T, H, D).bfloat16().float()


def test_tolerance_holds_kernel_roundings_and_catches_one_key():
    """The per-element bound the kernel is held to on the card: the
    kernel's roundings, emulated here, stay inside it; attention that sees
    one key more per row (a causal or window check off by one) does not."""
    B, T, H, K, D, S, window = 2, 256, 4, 2, 64, 512, 96
    q, k, v = (torch.from_numpy(a).bfloat16().float() for a in _inputs(B, T, H, K, D, S))
    qs = torch.tensor([0, 200], dtype=torch.int32)
    kl = torch.tensor([256, 456], dtype=torch.int32)
    for w in (0, window):
        tol = flash_attention_tolerance(q, k, v, qs, kl, window=w)
        ref = flash_attention_reference(q, k, v, qs, kl, window=w)
        assert ((_bf16_emulation(q, k, v, qs, kl, w) - ref).abs() <= tol).all()
        one_more = flash_attention_reference(q, k, v, qs + 1, kl, window=w + (w > 0))
        assert ((one_more - ref).abs() > tol).any()
        if w:
            wider = flash_attention_reference(q, k, v, qs, kl, window=w + 1)
            assert ((wider - ref).abs() > tol).any()


def test_head_dim_dispatch_names_a_design():
    """K1's dispatch on D: every head dim the kernel is built for names a
    design (the Hopper wgmma pipeline at 64 and 128, the mma.sync kernel at
    80 and 256), and any other D is refused."""
    assert {D: kernel_design(D) for D in HEAD_DIMS} == {
        64: "wgmma", 80: "mma.sync", 128: "wgmma", 256: "mma.sync"}
    for D in (32, 96, 112, 160, 512):
        with pytest.raises(ValueError, match=f"head dim {D}"):
            kernel_design(D)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernel is CUDA C++ for sm_90a")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 80, 128, 256])
def test_kernel_matches_plain_on_card(cuda_device, D):
    """bf16 kernel vs the plain version in fp32 on the same inputs, element
    by element within ``flash_attention_tolerance`` (p and o are rounded to
    bf16)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    B, T, H, K, S = 2, 200, 8, 2, 512
    q = torch.randn(B, T, H, D, generator=gen, device=cuda_device).bfloat16()
    k = torch.randn(B, S, K, D, generator=gen, device=cuda_device).bfloat16()
    v = torch.randn(B, S, K, D, generator=gen, device=cuda_device).bfloat16()
    qs = torch.tensor([0, 100], dtype=torch.int32, device=cuda_device)
    kl = torch.tensor([200, 300], dtype=torch.int32, device=cuda_device)
    window = 64 if D == 80 else 0
    before = flash_attention.launches
    out = flash_attention(q, k, v, qs, kl, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = flash_attention_reference(q.float(), k.float(), v.float(), qs, kl, window=window)
    tol = flash_attention_tolerance(q, k, v, qs, kl, window=window)
    assert ((out.float() - ref).abs() <= tol).all()
