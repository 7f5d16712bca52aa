"""The port's threefry PRNG (fei_tpu_torch/engine/prng.py) against
``jax.random`` (partitionable threefry, the JAX default): keys, splits,
random bits and uniforms are bitwise equal for seeds 0-31 at every shape
the samplers draw, including a [1, V] draw with one key (the dense
engine) and a [V] draw per row (the scheduler). Gumbel noise goes through
``log``, where ``torch.log`` and XLA's may round one ulp apart, so the
sampled tokens are held equal and a mismatch reports the winning
noise-plus-logit gap instead of passing under a tolerance.
"""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fei_tpu.engine import sampling as jax_sampling
from fei_tpu_torch.engine import prng
from fei_tpu_torch.engine import sampling as pt_sampling

SEEDS = range(32)
TINY = float(np.finfo(np.float32).tiny)


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _words(jax_key) -> np.ndarray:
    """A JAX key's uint32 words, widened as the port holds them."""
    return np.asarray(jax.random.key_data(jax_key), np.uint32).astype(np.int64)


def test_known_answer_vector():
    """Random123's threefry-2x32 (20 rounds) known-answer vector."""
    k1, k2, x1, x2 = (torch.tensor(v) for v in (0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3))
    out = prng.threefry2x32(k1, k2, x1, x2)
    assert (int(out[0]), int(out[1])) == (0xC4923A9C, 0x483DF7A0)


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 + 5, 2**40 + 3, -1])
def test_prng_key_words(seed):
    assert prng.PRNGKey(seed).tolist() == _words(_jkey(seed)).tolist()


def test_splits_bitwise():
    for seed in SEEDS:
        key, jk = prng.PRNGKey(seed), _jkey(seed)
        assert prng.split(key).tolist() == _words(jax.random.split(jk)).tolist()
        assert prng.split(key, 5).tolist() == _words(jax.random.split(jk, 5)).tolist()
        batch = jax.random.split(jk, 4)
        got = prng.split(torch.from_numpy(_words(batch)))
        assert got.tolist() == _words(jax.vmap(jax.random.split)(batch)).tolist()


def test_chain_of_200_splits():
    """The decode loop's chain, ``rng, sub = split(rng)`` 200 times: every
    carried key and every drawn subkey equal."""
    for seed in SEEDS:
        key, jk = prng.PRNGKey(seed), _jkey(seed)
        carried, subs = [], []
        jcarried, jsubs = [], []
        for _ in range(200):
            key, sub = prng.split(key)
            carried.append(key)
            subs.append(sub)
            jk, jsub = jax.random.split(jk)
            jcarried.append(jk)
            jsubs.append(jsub)
        assert torch.stack(carried).tolist() == _words(jnp.stack(jcarried)).tolist()
        assert torch.stack(subs).tolist() == _words(jnp.stack(jsubs)).tolist()


SHAPES = [(7,), (128,), (1, 1000), (4, 1000), (128256,)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bits_and_uniforms_bitwise(shape):
    for seed in SEEDS:
        key, jk = prng.PRNGKey(seed), _jkey(seed)
        bits = prng.random_bits(key, shape)
        want = np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64)
        np.testing.assert_array_equal(bits.numpy(), want)
        for lo in (0.0, TINY):
            u = prng.uniform(key, shape, minval=lo).numpy()
            ju = np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=1.0))
            np.testing.assert_array_equal(u.view(np.int32), ju.view(np.int32))


def test_one_key_flat_layout_and_per_row_keys():
    """A [V] and a [1, V] draw with one key are the same bits (the flat
    index is the counter), and a [B, 2] batch of keys draws row b from key
    b alone, as the reference's vmap does."""
    V = 1001
    for seed in SEEDS:
        key = prng.PRNGKey(seed)
        assert torch.equal(prng.random_bits(key, (V,)), prng.random_bits(key, (1, V))[0])
        keys = jax.random.split(_jkey(seed), 3)
        rows = prng.random_bits(torch.from_numpy(_words(keys)), (V,))
        want = jax.vmap(lambda k: jax.random.bits(k, (V,), jnp.uint32))(keys)
        np.testing.assert_array_equal(rows.numpy(), np.asarray(want).astype(np.int64))
        for b in range(3):
            alone = prng.random_bits(torch.from_numpy(_words(keys[b])), (V,))
            assert torch.equal(rows[b], alone)


def _gap_report(noise_logits: np.ndarray, a: int, b: int) -> str:
    return (f"tokens {a} (port) and {b} (jax) differ; their noise+logit "
            f"values {noise_logits[a]!r} and {noise_logits[b]!r} are "
            f"{abs(noise_logits[a] - noise_logits[b]):.3e} apart")


@pytest.mark.parametrize("V", [1000, 4097, 128256])
def test_categorical_tokens_equal(V):
    rng = np.random.default_rng(V)
    for seed in SEEDS:
        logits = (rng.standard_normal((1, V)) * 3).astype(np.float32)
        key, jk = prng.PRNGKey(seed), _jkey(seed)
        got = int(prng.categorical(key, torch.from_numpy(logits))[0])
        want = int(jax.random.categorical(jk, jnp.asarray(logits), axis=-1)[0])
        if got != want:
            noise = prng.gumbel(key, (1, V)).numpy()[0] + logits[0]
            pytest.fail(_gap_report(noise, got, want))


KNOBS = [
    dict(temperature=0.8),
    dict(temperature=0.9, top_k=40),
    dict(temperature=1.1, top_p=0.9),
    dict(temperature=1.0, min_p=0.05),
    dict(temperature=0.7, top_k=50, top_p=0.8, min_p=0.02),
]


@pytest.mark.parametrize("knobs", KNOBS, ids=["plain", "top_k", "top_p", "min_p", "all"])
def test_sample_logits_matches_reference(knobs):
    """The dense engine's sampler: one key, a [1, V] block."""
    rng = np.random.default_rng(1)
    for seed in SEEDS:
        logits = (rng.standard_normal((1, 4097)) * 2).astype(np.float32)
        got = pt_sampling.sample_logits(torch.from_numpy(logits), prng.PRNGKey(seed), **knobs)
        want = jax_sampling.sample_logits(jnp.asarray(logits), _jkey(seed), **knobs)
        assert got.tolist() == np.asarray(want).tolist(), (seed, knobs)


@pytest.mark.parametrize("mix", ["mixed", "sampled_only", "greedy_only"])
def test_sample_logits_dynamic_matches_reference(mix):
    """The scheduler's batched sampler: per-row keys and knobs, greedy rows
    mixed with sampled ones, each filter on and off by row."""
    B, V = 6, 1000
    temps = {"mixed": [0.8, 0.0, 1.2, 0.7, 0.0, 1.0],
             "sampled_only": [0.8, 0.9, 1.2, 0.7, 1.1, 1.0],
             "greedy_only": [0.0] * B}[mix]
    top_ks = [0, 5, 40, 0, 3, 0]
    top_ps = [1.0, 0.9, 0.8, 0.95, 1.0, 1.0]
    min_ps = [0.0, 0.0, 0.05, 0.1, 0.0, 0.0]
    rng = np.random.default_rng(2)
    for seed in SEEDS:
        logits = (rng.standard_normal((B, V)) * 2).astype(np.float32)
        keys = jax.random.split(_jkey(seed), B)
        got = pt_sampling.sample_logits_dynamic(
            torch.from_numpy(logits), torch.from_numpy(_words(keys)),
            temps, top_ks, top_ps, min_ps)
        want = jax_sampling.sample_logits_dynamic(
            jnp.asarray(logits), keys, jnp.asarray(temps, jnp.float32),
            jnp.asarray(top_ks, jnp.int32), jnp.asarray(top_ps, jnp.float32),
            jnp.asarray(min_ps, jnp.float32))
        assert got.tolist() == np.asarray(want).tolist(), seed
