"""The port's flash-attention backward against the JAX Pallas kernels.

On the CPU the wrappers run their plain versions (the kernels are CUDA
only); the JAX side runs ``fei_tpu.ops.pallas.flash_attention`` in interpret
mode, as the JAX package's own tests do (tests/test_pallas_kernels.py,
``TestFlashAttentionVJP``), at those tests' shapes: aligned, offset into a
longer buffer, unaligned, ragged, windowed, all with GQA. Inputs come from
numpy with a fixed seed. Tolerance: atol 2e-5 on fp32 gradients of
magnitude ~1 — the two sides compute the same recompute formulas and differ
in summation order only (blockwise against whole-tensor). The kernels
themselves are held against the plain version by the ``cuda``-marked tests,
which skip without a card, and by chip_smoke.py. jax is imported inside the
parity tests only, so that the ``cuda`` tests also run where jax is not
installed (``pytest -m cuda --noconftest``).
"""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import numpy as np
import pytest
import torch

from fei_tpu_torch.ops.attention import attention
from fei_tpu_torch.ops.kernels.flash_attention import (
    FlashAttention,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_bwd_tolerance,
    flash_attention_fwd,
    flash_attention_reference,
)

ATOL = 2e-5

CASES = {
    # name: (B, T, H, K, D, S, q_start, kv_length, window, block_q, block_k)
    "aligned": (2, 32, 4, 2, 32, 32, [0, 0], [32, 32], 0, 16, 16),
    "offset": (2, 16, 4, 2, 32, 64, [17, 17], [33, 33], 0, 16, 16),
    "unaligned": (1, 21, 2, 1, 32, 30, [0], [21], 0, 8, 16),
    "ragged": (2, 16, 4, 2, 32, 48, [0, 10], [16, 20], 0, 8, 16),
    "window": (1, 24, 4, 4, 32, 48, [8], [32], 6, 8, 8),
    "window_gqa": (2, 20, 4, 2, 32, 40, [3, 11], [23, 31], 5, 8, 16),
}


def _inputs(B, T, H, K, D, S, seed=0):
    rng = np.random.default_rng(seed)
    q = (0.3 * rng.standard_normal((B, T, H, D))).astype(np.float32)
    k = (0.3 * rng.standard_normal((B, S, K, D))).astype(np.float32)
    v = (0.3 * rng.standard_normal((B, S, K, D))).astype(np.float32)
    return q, k, v


def _case(name):
    B, T, H, K, D, S, qs, kl, window, bq, bk = CASES[name]
    q, k, v = _inputs(B, T, H, K, D, S)
    return q, k, v, np.asarray(qs, np.int32), np.asarray(kl, np.int32), window, bq, bk


def _torch_grads(fn, q, k, v):
    """Gradients of sum(fn(q, k, v) ** 2), the JAX tests' loss."""
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    return torch.autograd.grad(fn(*leaves).square().sum(), leaves)


@pytest.mark.parametrize("name", list(CASES))
def test_reference_lse_matches_pallas_interpret(name):
    """``flash_attention_reference(return_lse=True)`` against the Pallas
    forward with ``save_lse=True`` in interpret mode: the output and the
    logsumexp residual the backward reads."""
    jnp = pytest.importorskip("jax.numpy")
    from fei_tpu.ops.pallas.flash_attention import _fwd_impl

    q, k, v, qs, kl, window, bq, bk = _case(name)
    T = q.shape[1]
    want_out, want_lse = _fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qs), jnp.asarray(kl),
        q.shape[-1] ** -0.5, bq, bk, True, save_lse=True, window=window)
    out, lse = flash_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v, qs, kl)), window=window, return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[:, :, :T, 0], atol=ATOL, rtol=0)


def test_reference_lse_is_inf_for_dead_rows():
    """A batch row with no live key: zeros out, +inf lse, as the Pallas
    kernel's finalize writes them, and zero gradients everywhere."""
    jnp = pytest.importorskip("jax.numpy")
    from fei_tpu.ops.pallas.flash_attention import _fwd_impl

    q, k, v = _inputs(2, 8, 4, 2, 32, 32)
    qs, kl = np.zeros(2, np.int32), np.asarray([8, 0], np.int32)
    _, want_lse = _fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qs), jnp.asarray(kl),
        32 ** -0.5, 8, 8, True, save_lse=True, window=0)
    t = [torch.from_numpy(a) for a in (q, k, v, qs, kl)]
    out, lse = flash_attention_reference(*t, return_lse=True)
    assert np.isposinf(np.asarray(want_lse)[1]).all()
    assert torch.isposinf(lse[1]).all() and torch.isfinite(lse[0]).all()
    dq, dk, dv = flash_attention_bwd_reference(*t, out, lse, torch.ones_like(out))
    assert not dq[1].any() and not dk[1].any() and not dv[1].any()
    assert dq[0].any() and torch.isfinite(dq).all()


@pytest.mark.parametrize("name", list(CASES))
def test_bwd_matches_pallas_interpret(name):
    """jax.grad through the Pallas flash kernels (interpret mode) against
    the port's autograd function and against the plain backward called on
    the saved residuals."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from fei_tpu.ops.pallas.flash_attention import flash_attention as jax_flash

    q, k, v, qs, kl, window, bq, bk = _case(name)

    def loss(q, k, v):
        out = jax_flash(q, k, v, jnp.asarray(qs), jnp.asarray(kl), block_q=bq, block_k=bk,
                        interpret=True, window=window)
        return jnp.sum(out ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tqs, tkl = torch.from_numpy(qs), torch.from_numpy(kl)
    got = _torch_grads(lambda q, k, v: flash_attention(q, k, v, tqs, tkl, window=window),
                       q, k, v)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = flash_attention_fwd(tq, tk, tv, tqs, tkl, window=window)
    direct = flash_attention_bwd_reference(tq, tk, tv, tqs, tkl, out, lse, 2 * out,
                                           window=window)
    for g, d, w, leaf in zip(got, direct, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=0,
                                   err_msg=f"d{leaf} through the autograd function")
        np.testing.assert_allclose(d.numpy(), np.asarray(w), atol=ATOL, rtol=0,
                                   err_msg=f"d{leaf} from the plain backward")


@pytest.mark.parametrize("name", list(CASES))
def test_bwd_matches_autograd_through_plain_attention(name):
    """The recompute backward against torch autograd through
    ``ops.attention.attention`` (the oracle of roadmap K5)."""
    q, k, v, qs, kl, window, _, _ = _case(name)
    tqs, tkl = torch.from_numpy(qs), torch.from_numpy(kl)
    pos = tqs.long()[:, None] + torch.arange(q.shape[1])[None, :]
    got = _torch_grads(lambda q, k, v: flash_attention(q, k, v, tqs, tkl, window=window),
                       q, k, v)
    want = _torch_grads(lambda q, k, v: attention(q, k, v, pos, tkl, window=window), q, k, v)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("window", [0, 5])
def test_gradcheck_fp64(window):
    """Numerical against analytical gradients of the autograd function in
    double precision (the plain paths keep fp64 inputs in fp64)."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 9, 4, 8))).requires_grad_(True)
    k = torch.from_numpy(rng.standard_normal((2, 14, 2, 8))).requires_grad_(True)
    v = torch.from_numpy(rng.standard_normal((2, 14, 2, 8))).requires_grad_(True)
    qs = torch.tensor([0, 4], dtype=torch.int32)
    kl = torch.tensor([9, 13], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda q, k, v: FlashAttention.apply(q, k, v, qs, kl, None, window), (q, k, v))


def test_keys_past_kv_length_and_unseen_keys_get_zero_grads():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 2, 1, 16, 32))
    qs = torch.tensor([4], dtype=torch.int32)
    kl = torch.tensor([10], dtype=torch.int32)  # positions 4..11 but keys only below 10
    out, lse = flash_attention_fwd(q, k, v, qs, kl, window=2)
    dq, dk, dv = flash_attention_bwd(q, k, v, qs, kl, out, lse, torch.ones_like(out), window=2)
    assert not dk[:, 10:].any() and not dv[:, 10:].any()  # past kv_length
    assert not dk[:, :3].any() and not dv[:, :3].any()  # below every query's window
    assert dv[:, 3:10].abs().sum(dim=(0, 2, 3)).gt(0).all()
    # the query at position 11 sees keys 10 and 11 only, both past kv_length
    assert torch.isposinf(lse[0, :, 7]).all() and not dq[0, 7].any()


def test_cpu_dispatch_takes_plain_path():
    """CPU tensors never reach the kernels: the launch counts do not move."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _inputs(1, 8, 4, 2, 32, 16))
    qs, kl = torch.tensor([0], dtype=torch.int32), torch.tensor([8], dtype=torch.int32)
    before = (flash_attention.launches, flash_attention_bwd.launches_dq,
              flash_attention_bwd.launches_dkv)
    flash_attention(q, k, v, qs, kl).sum().backward()
    assert q.grad is not None and k.grad is not None and v.grad is not None
    assert before == (flash_attention.launches, flash_attention_bwd.launches_dq,
                      flash_attention_bwd.launches_dkv)


@pytest.mark.parametrize("window", [0, 96])
def test_tolerance_holds_kernel_roundings_and_catches_mutants(window):
    """The per-element bounds the kernels are held to on the card: the
    kernels' roundings (p and ds to bf16 before the products, the results
    to bf16), emulated here, stay inside them; a backward without the
    row-sum term, and one that sees one key more per row, do not."""
    B, T, H, K, D, S = 2, 256, 4, 2, 64, 512
    q, k, v = (torch.from_numpy(a / 0.3).bfloat16().float() for a in _inputs(B, T, H, K, D, S))
    dout = torch.from_numpy(np.random.default_rng(5).standard_normal((B, T, H, D))
                            .astype(np.float32)).bfloat16().float()
    qs = torch.tensor([0, 200], dtype=torch.int32)
    kl = torch.tensor([256, 456], dtype=torch.int32)
    out, lse = flash_attention_fwd(q, k, v, qs, kl, window=window)
    out = out.bfloat16().float()  # the kernel's output is bf16
    args = (q, k, v, qs, kl, out, lse, dout)
    tols = flash_attention_bwd_tolerance(*args, window=window)
    refs = flash_attention_bwd_reference(*args, window=window)
    emulated = flash_attention_bwd_reference(*args, window=window, round_bf16=True)
    for e, r, tol in zip(emulated, refs, tols):
        assert ((e - r).abs() <= tol).all()
    # dv does not read the row-sum term, so that mutant shows in dq and dk
    for mutant, seen_in in (("no_dsum", "qk"), ("one_more", "qkv")):
        wrong = flash_attention_bwd_reference(*args, window=window, mutant=mutant)
        for w, r, tol, leaf in zip(wrong, refs, tols, "qkv"):
            if leaf in seen_in:
                share = ((w - r).abs() > tol).float().mean().item()
                assert share >= 0.05, f"{mutant} seen at {share:.2%} of d{leaf} only"


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the flash kernels are CUDA C++ for sm_90a")
    return torch.device("cuda")


def _card_inputs(dev, D, B=2, T=200, H=8, K=2, S=512):
    gen = torch.Generator(device=dev).manual_seed(0)
    mk = lambda *shape: torch.randn(*shape, generator=gen, device=dev).bfloat16()
    qs = torch.tensor([0, 100], dtype=torch.int32, device=dev)
    kl = torch.tensor([200, 300], dtype=torch.int32, device=dev)
    return mk(B, T, H, D), mk(B, S, K, D), mk(B, S, K, D), qs, kl, mk(B, T, H, D)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 80, 128, 256])
def test_lse_kernel_matches_plain_on_card(cuda_device, D):
    """K1 with the logsumexp output: ``out`` bitwise the primal's, lse
    within 1e-4 of the plain version's (fp32 sums in another order, exp2
    against exp) and +inf exactly where the plain version's is."""
    q, k, v, qs, kl, _ = _card_inputs(cuda_device, D)
    kl = kl.clone()
    kl[1] = 0  # a batch row with no live key
    out, lse = flash_attention_fwd(q, k, v, qs, kl)
    assert torch.equal(out, flash_attention(q, k, v, qs, kl))
    _, ref = flash_attention_reference(q.float(), k.float(), v.float(), qs, kl, return_lse=True)
    assert torch.equal(torch.isposinf(lse), torch.isposinf(ref))
    assert torch.isposinf(lse[1]).all()
    live = torch.isfinite(ref)
    assert (lse[live] - ref[live]).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 80, 128, 256])
def test_bwd_kernels_match_plain_on_card(cuda_device, D):
    """K5a and K5b (bf16) against the plain backward in fp32 on the same
    values and residuals, element by element within
    ``flash_attention_bwd_tolerance``; a second run is bitwise the same, and
    so is each batch row run alone. Two shapes: a ragged one (a window at
    D = 80), and a causal one from position 0 with several 128-key tiles
    for K5b's wgmma clusters to pair (T = S = 640)."""
    q640, k640, v640, _, _, dout640 = _card_inputs(cuda_device, D, T=640, S=640)
    shapes = [_card_inputs(cuda_device, D) + (64 if D == 80 else 0,),
              (q640, k640, v640, torch.tensor([0, 37], dtype=torch.int32, device=cuda_device),
               torch.tensor([640, 600], dtype=torch.int32, device=cuda_device), dout640, 0)]
    for q, k, v, qs, kl, dout, window in shapes:
        out, lse = flash_attention_fwd(q, k, v, qs, kl, window=window)
        before = (flash_attention_bwd.launches_dq, flash_attention_bwd.launches_dkv)
        got = flash_attention_bwd(q, k, v, qs, kl, out, lse, dout, window=window)
        torch.cuda.synchronize()
        assert (flash_attention_bwd.launches_dq, flash_attention_bwd.launches_dkv) == (
            before[0] + 1, before[1] + 1)
        f = (q.float(), k.float(), v.float(), qs, kl, out.float(), lse, dout.float())
        refs = flash_attention_bwd_reference(*f, window=window)
        tols = flash_attention_bwd_tolerance(q, k, v, qs, kl, out, lse, dout, window=window)
        for g, r, tol in zip(got, refs, tols):
            assert torch.isfinite(g).all()
            assert ((g.float() - r).abs() <= tol).all()
        again = flash_attention_bwd(q, k, v, qs, kl, out, lse, dout, window=window)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        for b in range(q.shape[0]):
            one = slice(b, b + 1)
            alone = flash_attention_bwd(q[one], k[one], v[one], qs[one], kl[one], out[one],
                                        lse[one].contiguous(), dout[one], window=window)
            assert all(torch.equal(a, g[one]) for a, g in zip(alone, got))


@pytest.mark.cuda
def test_autograd_function_launches_kernels_on_card(cuda_device):
    q, k, v, qs, kl, dout = _card_inputs(cuda_device, 128)
    q.requires_grad_(True), k.requires_grad_(True), v.requires_grad_(True)
    before = (flash_attention.launches, flash_attention_bwd.launches_dq,
              flash_attention_bwd.launches_dkv)
    flash_attention(q, k, v, qs, kl).backward(dout)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_bwd.launches_dq,
            flash_attention_bwd.launches_dkv) == tuple(b + 1 for b in before)
    assert q.grad.dtype == torch.bfloat16 and k.grad.shape == k.shape


@pytest.mark.cuda
def test_train_step_runs_the_kernels_on_the_card(cuda_device):
    """A bf16 train step at T = 128 on the card, at a head dim the kernels
    are built for (64): K1 twice per layer (forward and recompute), K5a and
    K5b once per layer, a falling loss."""
    from fei_tpu_torch.engine.train import TrainConfig, make_train_step
    from fei_tpu_torch.models.configs import get_model_config
    from fei_tpu_torch.models.llama import init_params

    cfg = get_model_config("tiny", num_layers=2, hidden_size=256, num_heads=4,
                           num_kv_heads=2, intermediate_size=512)
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=cuda_device)
    opt, step = make_train_step(cfg, TrainConfig(learning_rate=1e-2))
    state = opt.init(params)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 129)))
    before = (flash_attention.launches, flash_attention_bwd.launches_dq,
              flash_attention_bwd.launches_dkv)
    losses = []
    for _ in range(3):
        params, state, loss = step(params, state, toks)
        losses.append(float(loss))
    after = (flash_attention.launches, flash_attention_bwd.launches_dq,
             flash_attention_bwd.launches_dkv)
    assert tuple(a - b for a, b in zip(after, before)) == (12, 6, 6)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


@pytest.mark.cuda
def test_cpu_params_raise_on_the_card_unless_the_cpu_is_asked_for(cuda_device, tmp_path):
    """With a card the train step and the restore default to it: parameters
    left on the CPU raise instead of training there through the plain
    attention; ``device="cpu"`` asks for the CPU."""
    from fei_tpu_torch.engine import restore_checkpoint, save_checkpoint
    from fei_tpu_torch.engine.train import loss_and_grads, make_train_step
    from fei_tpu_torch.models.configs import get_model_config
    from fei_tpu_torch.models.llama import init_params
    from fei_tpu_torch.utils.errors import TrainingError

    cfg = get_model_config("tiny")
    params = init_params(cfg, seed=0, dtype=torch.float32)  # on the CPU
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 9)))
    _, step = make_train_step(cfg)
    with pytest.raises(TrainingError, match="is on cpu.*runs on cuda"):
        step(params, {}, toks)
    loss, _ = loss_and_grads(params, cfg, toks, device="cpu")
    assert torch.isfinite(loss)
    save_checkpoint(str(tmp_path), 0, params)
    restored = restore_checkpoint(str(tmp_path))["params"]
    assert restored["embed"].is_cuda
    assert torch.equal(restored["embed"].cpu(), params["embed"])
