"""Threefry-2x32 keys and draws, bit for bit those of ``jax.random``
(the part of it the JAX package's samplers use).

- A key is a ``[..., 2]`` int64 tensor holding two uint32 words on the
  engine's device. ``PRNGKey(seed)`` is ``[0, seed mod 2**32]``, the
  reference's key with 64-bit types off (its default).
- ``split`` and ``random_bits`` follow the partitionable layout
  (``jax_threefry_partitionable``, on by default since JAX 0.5): element
  i of a draw of any shape hashes the counter pair ``(i >> 32, i & mask)``
  of its flat index, and the 32 random bits are the two output words
  xor-ed. A split's key j is the output pair of counter j. So a ``[V]``
  draw and a ``[1, V]`` draw with one key give the same bits.
- ``uniform``, ``gumbel`` and ``categorical`` take the mantissa trick and
  the clamp of ``jax._src.random._uniform`` and the "low" Gumbel mode.

The uint32 arithmetic runs in int64 with ``& 0xFFFFFFFF`` (PyTorch has no
uint32 add or shift on the CPU). Everything stays on the keys' device:
no split or draw reads a value back to the host.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counters ``(x1, x2)`` under
    key ``(k1, k2)``; all int64 tensors of uint32 values that broadcast
    together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + k1) & MASK
    x1 = (x2 + k2) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) & MASK) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:  # noqa: N802 - jax's name
    """``jax.random.PRNGKey(seed)``: int64 ``[2]``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64, device=device)


def key_from_words(words, device=None) -> torch.Tensor:
    """A key (or a batch of keys) from uint32 words: a list such as a
    journal's ``[hi, lo]``, or numpy's view of a JAX key."""
    return torch.as_tensor(words, dtype=torch.int64, device=device) & MASK


def _counters(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` for one key ``[2]`` → ``[num, 2]``, and for a
    batch ``[B, 2]`` → ``[B, num, 2]`` (the reference's
    ``jax.vmap(jax.random.split)``)."""
    hi, lo = _counters(num, key.device)
    b1, b2 = threefry2x32(key[..., 0:1], key[..., 1:2], hi, lo)
    return torch.stack((b1, b2), dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits (int64 of uint32 values) of ``shape``. A key ``[2]``
    fills the whole shape; a batch of keys ``[B, 2]`` fills one ``shape``
    per key, ``[B, *shape]``, each row from its own key alone."""
    shape = tuple(shape)
    n = 1
    for d in shape:
        n *= d
    hi, lo = _counters(n, key.device)
    if key.dim() == 1:
        b1, b2 = threefry2x32(key[0], key[1], hi, lo)
        return (b1 ^ b2).reshape(shape)
    b1, b2 = threefry2x32(key[:, 0:1], key[:, 1:2], hi[None], lo[None])
    return (b1 ^ b2).reshape((key.shape[0], *shape))


def uniform(key: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """float32 uniforms in ``[minval, maxval)``, as ``_uniform`` makes
    them: 23 random mantissa bits under exponent 0 give ``[1, 2)``, minus
    one, scaled, shifted and clamped below at ``minval``."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # the bounds and their span rounded to float32 on the host, as the
    # reference converts them before the device arithmetic
    lo = torch.tensor(minval, dtype=torch.float32)
    span = (torch.tensor(maxval, dtype=torch.float32) - lo).item()
    lo = lo.item()
    return (f * span + lo).clamp_min(lo)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """Standard Gumbel noise (the "low" mode): ``-log(-log(u))`` with
    ``u`` uniform in ``[tiny, 1)``."""
    return -torch.log(-torch.log(uniform(key, shape, minval=_TINY, maxval=1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis: argmax of logits
    plus Gumbel noise. One key draws noise for the whole ``logits`` shape
    (its flat index); a batch of keys ``[B, 2]`` draws row b of a
    ``[B, V]`` ``logits`` from key b alone. Returns int64 ids."""
    if key.dim() == 1:
        noise = gumbel(key, logits.shape)
    else:
        noise = gumbel(key, logits.shape[1:])
    return torch.argmax(noise + logits, dim=-1)
