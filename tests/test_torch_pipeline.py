"""Pipeline parallelism in the port (fei_tpu_torch/parallel/pipeline.py and
a pp2 engine) against fei_tpu, at tiny configs in fp32 with the same
weights (``params_from_jax``).

The port's side runs in the two-rank gloo group of
tests/torch_mesh_ranks.py; fei_tpu's ``pipeline_forward_train`` runs on
the conftest's virtual CPU mesh with a pp axis of 2. Tolerance 1e-4 (the
same fp32 formulas in another summation order). Forward only, as the
reference's own tests hold it (tests/test_pipeline.py, tests/test_phi.py).

- the GPipe forward with 2 and 4 microbatches on ``tiny`` and ``tiny-phi``
  (Phi's parallel block), on every rank;
- the reference's ``L % n`` and ``B % num_micro`` errors;
- a pp2 engine builds (no table names pp: every rank holds every layer)
  and streams fei_tpu's single-chip greedy tokens.
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
from fei_tpu.parallel.mesh import make_mesh
from fei_tpu.parallel.pipeline import pipeline_forward_train

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_mesh_ranks import MAX_SEQ, N_NEW, PP_SHAPE, PROMPTS, parallel_results, tokens  # noqa: E402

ATOL = 1e-4


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return parallel_results(tmp_path_factory)["two"]


def _pp():
    return make_mesh({"pp": 2}, devices=jax.devices()[:2])


def _params(name):
    return init_params(get_model_config(name, num_layers=2), jax.random.PRNGKey(0),
                       dtype=jnp.float32)


@pytest.mark.parametrize("name", ["tiny", "tiny-phi"])
@pytest.mark.parametrize("num_micro", [2, 4])
def test_pipeline_forward_matches_fei_tpu(two, name, num_micro):
    cfg = get_model_config(name, num_layers=2)
    want = pipeline_forward_train(_params(name), cfg, jnp.asarray(tokens(PP_SHAPE, 8),
                                                                  dtype=jnp.int32),
                                  _pp(), num_micro)
    for r in two:
        np.testing.assert_allclose(r[f"pp {name} {num_micro}"], np.asarray(want), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("case,layers,num_micro", [("err L % n", 3, 2),
                                                   ("err B % micro", 2, 3)])
def test_errors_are_the_reference_errors(two, case, layers, num_micro):
    with pytest.raises(ValueError) as err:
        pipeline_forward_train(_params("tiny"), get_model_config("tiny", num_layers=layers),
                               jnp.asarray(tokens(PP_SHAPE, 8), dtype=jnp.int32), _pp(),
                               num_micro)
    assert two[0][case] == str(err.value) == two[1][case]


def test_pp2_engine_streams_fei_tpu_single_chip(two):
    eng = JaxEngine.from_config("tiny", dtype=jnp.float32, max_seq_len=MAX_SEQ, num_layers=2)
    want = eng.generate(PROMPTS[0], JaxGen(max_new_tokens=N_NEW, ignore_eos=True)).token_ids
    assert two[0]["pp_tag"] == "pp2"
    assert two[0]["pp_stream"] == want
