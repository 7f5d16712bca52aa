"""Sequence parallelism in the port (fei_tpu_torch/parallel/ring.py and
long_prefill.py, the engine's and the scheduler's sp routes) against
fei_tpu, at tiny configs in fp32 with the same weights
(``params_from_jax``).

The port's side runs in two gloo ranks on the CPU
(tests/torch_mesh_ranks.py: one two-rank group runs every case once for
all the parallel test files); fei_tpu's runs on the conftest's virtual CPU
mesh with an sp axis of 2. Tolerance 1e-4: the two compute the same fp32
formulas in another summation order.

- ``ring_attention`` / ``ulysses_attention`` per rank chunk, concatenated,
  against fei_tpu's over GQA, MQA (Ulysses raises the reference's error
  there) and a sliding window;
- ``prefill_ring_kv`` (ring and Ulysses, ``true_len``) and
  ``prefill_ring`` on ``tiny`` and ``tiny-swa``;
- the reference's errors: ``T % n``, an unknown attend, Ulysses heads;
- the sp2 engine's dense prefill and the sp2 scheduler's admission beside
  live decode: greedy streams equal fei_tpu's single-chip streams, with
  ``engine.sp_prefills`` rising (the twin of
  tests/test_long_prefill_engine.py).
"""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fei_tpu.engine.engine import GenerationConfig as JaxGen
from fei_tpu.engine.engine import InferenceEngine as JaxEngine
from fei_tpu.models.configs import get_model_config
from fei_tpu.models.llama import init_params
from fei_tpu.parallel.long_prefill import prefill_ring, prefill_ring_kv
from fei_tpu.parallel.mesh import make_mesh
from fei_tpu.parallel.ring import ring_attention, ulysses_attention

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_mesh_ranks import (  # noqa: E402
    ATT_CASES, LIVE_PROMPT, MAX_SEQ, PREFILL_LENS, PREFILL_T, SP_CHUNK, SP_PROMPT,
    att_inputs, parallel_results, tokens,
)

ATOL = 1e-4


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return parallel_results(tmp_path_factory)["two"]


def _sp():
    return make_mesh({"sp": 2}, devices=jax.devices()[:2])


def _params(name):
    return init_params(get_model_config(name, num_layers=2), jax.random.PRNGKey(0),
                       dtype=jnp.float32)


@pytest.mark.parametrize("H,K,w", ATT_CASES)
@pytest.mark.parametrize("fn", ["ring", "ulysses"])
def test_attention_matches_fei_tpu(two, fn, H, K, w):
    q, k, v = att_inputs(H, K)
    mesh = _sp()
    ref = ring_attention if fn == "ring" else ulysses_attention
    key = f"{fn} {H} {K} {w}"
    try:
        want = np.asarray(ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh, window=w))
    except ValueError as exc:
        assert two[0][key] == two[1][key] == f"ValueError: {exc}"
        return
    got = np.concatenate([r[key] for r in two], axis=1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["tiny", "tiny-swa"])
@pytest.mark.parametrize("attend", ["ring", "ulysses"])
def test_prefill_ring_kv_matches_fei_tpu(two, name, attend):
    cfg = get_model_config(name, num_layers=2)
    toks = jnp.asarray(tokens((2, PREFILL_T), 7), dtype=jnp.int32)
    logits, k, v = prefill_ring_kv(_params(name), cfg, toks, _sp(), attend=attend,
                                   true_len=jnp.asarray(PREFILL_LENS, dtype=jnp.int32))
    for r in two:  # every rank holds the logits and the whole K/V
        lg, ka, va = r[f"prefill {name} {attend}"]
        np.testing.assert_allclose(lg, np.asarray(logits), atol=ATOL, rtol=0)
        np.testing.assert_allclose(ka, np.asarray(k), atol=ATOL, rtol=0)
        np.testing.assert_allclose(va, np.asarray(v), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["tiny", "tiny-swa"])
def test_prefill_ring_cache_matches_fei_tpu(two, name):
    cfg = get_model_config(name, num_layers=2)
    toks = jnp.asarray(tokens((1, PREFILL_T), 7)[:1], dtype=jnp.int32)
    logits, cache = prefill_ring(_params(name), cfg, toks, _sp(), max_seq_len=48)
    lg, k, length = two[0][f"prefill_ring {name}"]
    np.testing.assert_allclose(lg, np.asarray(logits), atol=ATOL, rtol=0)
    np.testing.assert_allclose(k, np.asarray(cache.k), atol=ATOL, rtol=0)
    assert k.shape == tuple(cache.k.shape) and length.tolist() == [PREFILL_T]


@pytest.mark.parametrize("case,call", [
    ("err T % n", lambda p, m: prefill_ring_kv(
        p, get_model_config("tiny", num_layers=2), jnp.zeros((1, 31), jnp.int32), m)),
    ("err attend", lambda p, m: prefill_ring_kv(
        p, get_model_config("tiny", num_layers=2), jnp.zeros((1, 32), jnp.int32), m,
        attend="spiral")),
    ("err ulysses heads", lambda p, m: prefill_ring_kv(
        p, get_model_config("tiny", num_layers=2, num_kv_heads=1),
        jnp.zeros((1, 32), jnp.int32), m, attend="ulysses")),
])
def test_errors_are_the_reference_errors(two, case, call):
    with pytest.raises(ValueError) as err:
        call(_params("tiny"), _sp())
    assert two[0][case] == str(err.value) == two[1][case]


@pytest.fixture(scope="module")
def jax_streams():
    gen = JaxGen(max_new_tokens=8, ignore_eos=True)
    dense = JaxEngine.from_config("tiny", dtype=jnp.float32, max_seq_len=MAX_SEQ, num_layers=2)
    out = {"dense": dense.generate(SP_PROMPT, gen).token_ids,
           "short": dense.generate(LIVE_PROMPT, gen).token_ids}
    paged = JaxEngine.from_config("tiny", dtype=jnp.float32, max_seq_len=MAX_SEQ, num_layers=2,
                                  paged=True, batch_size=2, long_prefill_min=1 << 30)
    paged.scheduler.prefill_chunk = SP_CHUNK  # serial chunks, as the twin's reference
    out["long"] = list(paged.scheduler.stream(SP_PROMPT, JaxGen(max_new_tokens=12,
                                                                ignore_eos=True)))
    out["live"] = list(paged.scheduler.stream(LIVE_PROMPT, JaxGen(max_new_tokens=48,
                                                                  ignore_eos=True)))
    paged.close()
    return out


def test_sp_engine_prefill_routes_and_matches_single_chip(two, jax_streams):
    r0 = two[0]
    assert r0["sp_tag"] == "sp2"
    assert r0["sp_dense_prefills"] == 1
    assert r0["sp_dense"] == jax_streams["dense"]


def test_short_prompt_stays_on_the_dense_prefill(two, jax_streams):
    assert two[0]["sp_short_prefills"] == 0
    assert two[0]["sp_short"] == jax_streams["short"]


def test_sp_admission_beside_live_decode_matches_single_chip(two, jax_streams):
    r0 = two[0]
    assert r0["sp_paged_prefills"] == 1, "the scheduler did not admit through sp"
    assert r0["sp_paged"]["long"] == jax_streams["long"]
    assert r0["sp_paged"]["live"] == jax_streams["live"]

