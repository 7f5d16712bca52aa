"""The port's paged cache (engine/paged_cache.py) against fei_tpu's: the
same writes give the same pools (bf16, fp32 and int8, a position past the
table width landing in the null page 0), the same int8 row rule, and the
allocator and prefix registry step through the same sequence of
operations to the same state. Inputs come from numpy with a fixed seed;
pools must be bitwise equal (the writes are copies, and the int8 rule is
the same IEEE arithmetic on both sides)."""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fei_tpu.engine import paged_cache as jpc
from fei_tpu_torch.engine import paged_cache as pc

P, K, PS, D = 10, 2, 4, 8
TABLE = np.array([[3, 5, 1], [7, 2, 0]], np.int32)


def _np(x):
    """numpy view of a torch or jax array (bf16 widened to fp32, exactly)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_write_token_kv_matches_jax(dtype):
    rng = np.random.default_rng(0)
    T = 5
    new_k = rng.standard_normal((2, T, K, D)).astype(np.float32)
    new_v = rng.standard_normal((2, T, K, D)).astype(np.float32)
    # row 0 writes positions 6..10; row 1 writes 9..13, whose last two lie
    # past the table's 3 pages of 4 slots and must land in page 0
    lengths = np.array([6, 9], np.int32)
    int8 = dtype == "int8"
    jdt = {"bfloat16": jnp.bfloat16, "float32": jnp.float32, "int8": jnp.int8}[dtype]
    tdt = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int8": torch.int8}[dtype]
    jk = jnp.zeros((P, K, PS, D), jdt)
    jv = jnp.zeros((P, K, PS, D), jdt)
    jks = jnp.ones((P, K, 1, PS), jnp.float32) if int8 else None
    jvs = jnp.ones((P, K, 1, PS), jnp.float32) if int8 else None
    src_dt = jnp.float32 if int8 else jdt
    for t in range(T):
        out = jpc.write_token_kv(jk, jv, jnp.asarray(new_k[:, t], src_dt),
                                 jnp.asarray(new_v[:, t], src_dt), jnp.asarray(TABLE),
                                 jnp.asarray(lengths + t), k_scales=jks, v_scales=jvs)
        if int8:
            jk, jv, jks, jvs = out
        else:
            jk, jv = out
    tk = torch.zeros((P, K, PS, D), dtype=tdt)
    tv = torch.zeros((P, K, PS, D), dtype=tdt)
    tks = torch.ones((P, K, 1, PS)) if int8 else None
    tvs = torch.ones((P, K, 1, PS)) if int8 else None
    src = torch.float32 if int8 else tdt
    pc.write_token_kv(tk, tv, torch.from_numpy(new_k).to(src), torch.from_numpy(new_v).to(src),
                      torch.from_numpy(TABLE), torch.from_numpy(lengths), tks, tvs)
    # page 0 took the two overflow positions of row 1 (the same slots on
    # both sides); every page must be equal
    for got, want in ((tk, jk), (tv, jv)) + (((tks, jks), (tvs, jvs)) if int8 else ()):
        np.testing.assert_array_equal(_np(got), _np(want))
    assert (_np(tk)[0] != 0).any()


def test_quant_kv_rows_matches_jax():
    x = np.random.default_rng(1).standard_normal((3, 4, 16)).astype(np.float32) * 3
    x[0, 0] = 0.0  # an all-zero row takes scale 1
    jq, js = jpc.quant_kv_rows(jnp.asarray(x))
    tq, ts = pc.quant_kv_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0, 0] == 1.0


def test_allocator_and_prefix_cache_track_jax():
    """The same operations on both allocators (and prefix registries over
    them) leave the same free lists, owners, refcounts and matches."""
    ja, ta = jpc.PageAllocator(12, 4), pc.PageAllocator(12, 4)
    jp, tp = jpc.PrefixCache(ja, max_entries=3), pc.PrefixCache(ta, max_entries=3)
    prompt = list(range(1, 14))  # 3 full pages + 1 token

    def both(fn):
        a, b = fn(ja, jp), fn(ta, tp)
        assert a == b
        return a

    both(lambda a, p: a.alloc(0, 4))
    both(lambda a, p: a.alloc(1, 2, contiguous=True))
    both(lambda a, p: p.register(prompt, a.pages_for(0)))
    both(lambda a, p: a.free(0))
    hit = both(lambda a, p: p.match(prompt + [99]))
    assert len(hit) == 3
    both(lambda a, p: a.share(2, hit))
    both(lambda a, p: a.try_alloc(3, 20))
    both(lambda a, p: a.release_prefix(2, 1))
    both(lambda a, p: p.evict_for(10))
    both(lambda a, p: a.free(2))
    both(lambda a, p: (sorted(a._free), a._owned, a._refs, a.free_pages))
    assert pc.build_block_table([[3, 4], [5]], 3).tolist() == [[3, 4, 0], [5, 0, 0]]


def test_paged_attention_reference_matches_jax():
    rng = np.random.default_rng(2)
    kp = rng.standard_normal((P, K, PS, D)).astype(np.float32)
    vp = rng.standard_normal((P, K, PS, D)).astype(np.float32)
    q = rng.standard_normal((2, 4, D)).astype(np.float32)
    ln = np.array([9, 7], np.int32)
    for w in (0, 3):
        want = jpc.paged_attention_reference(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                             jnp.asarray(TABLE), jnp.asarray(ln), window=w)
        got = pc.paged_attention_reference(*map(torch.from_numpy, (q, kp, vp, TABLE, ln)),
                                           window=w)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
