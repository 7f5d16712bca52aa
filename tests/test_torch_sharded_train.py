"""Training over a mesh in the port (``make_train_step(..., mesh=)``,
fei_tpu_torch/engine/train.py) against fei_tpu's GSPMD step on the same
mesh shape, at ``tiny`` in fp32 with the same weights
(``params_from_jax``) and the same batch.

The port's ranks (tests/torch_mesh_ranks.py: dp2 and tp2 in the two-rank
group, dp2tp2 in the four-rank group) each train their Megatron shards
(``shard_params``): the batch splits over dp, the forward's collectives
carry the gradient, the clip's global norm sums each sharded leaf over its
axes; the dp2tp2 ranks then save a checkpoint whole and restore their
slices. fei_tpu's step runs jitted over its params sharded on the conftest's
virtual CPU mesh. The tolerance is tests/test_torch_train.py's ``ATOL``
(1e-5) on the losses and on every rank's parameter shards after two steps
at the default learning rate; then the loss falls over five dp2tp2 steps,
the twin of tests/test_parallel.py's sharded training test.
"""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from fei_tpu.engine import train as jax_train
from fei_tpu.models.configs import get_model_config
from fei_tpu.models.llama import init_params
from fei_tpu.parallel.mesh import make_mesh
from fei_tpu.parallel.sharding import shard_params
from fei_tpu_torch.models.configs import get_model_config as pt_get_model_config
from fei_tpu_torch.models.llama import init_params as pt_init_params
from fei_tpu_torch.parallel.mesh import Mesh
from fei_tpu_torch.parallel.sharding import param_shardings
from fei_tpu_torch.utils.tree import flatten

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_mesh_ranks import TRAIN_SHAPE, TRAIN_STEPS, parallel_results, tokens  # noqa: E402

ATOL = 1e-5
SHAPES = {"dp2": {"dp": 2}, "tp2": {"tp": 2}, "dp2tp2": {"dp": 2, "tp": 2}}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    return parallel_results(tmp_path_factory)


@pytest.fixture(scope="module", params=list(SHAPES))
def jax_run(request):
    """fei_tpu's two steps on the mesh shape: (losses, whole params after)."""
    shape = SHAPES[request.param]
    n = int(np.prod(list(shape.values())))
    mesh = make_mesh(shape, devices=jax.devices()[:n])
    cfg = get_model_config("tiny", num_layers=2)
    params = shard_params(init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32), mesh,
                          cfg.is_moe)
    opt, step = jax_train.make_train_step(cfg, jax_train.TrainConfig(learning_rate=1e-4))
    state = opt.init(params)
    toks = jax.device_put(jnp.asarray(tokens(TRAIN_SHAPE, 9), dtype=jnp.int32),
                          NamedSharding(mesh, P("dp", None)))
    losses = []
    for _ in range(TRAIN_STEPS):
        params, state, loss = step(params, state, toks)
        losses.append(float(loss))
    return request.param, losses, flatten(jax.tree.map(np.asarray, params))


def _ranks(groups, spec):
    if spec == "dp2tp2":
        return [r["train"] for r in groups["four"]]
    return [r[f"train {spec}"] for r in groups["two"]]


def test_losses_match_fei_tpu_on_the_same_mesh(groups, jax_run):
    spec, losses, _ = jax_run
    for got, _ in _ranks(groups, spec):  # every rank returns the global batch mean
        np.testing.assert_allclose(got, losses, atol=ATOL, rtol=0)


def test_parameter_shards_match_fei_tpu_on_the_same_mesh(groups, jax_run):
    spec, _, want = jax_run
    whole = pt_init_params(pt_get_model_config("tiny", num_layers=2), dtype=torch.float32,
                           device="meta")
    for rank, (_, got) in enumerate(_ranks(groups, spec)):
        shards = flatten(param_shardings(whole, Mesh(SHAPES[spec], rank=rank), False))
        assert set(got) == set(want)
        for path, leaf in got.items():
            part = want[path][shards[path].slices(want[path].shape)]
            np.testing.assert_allclose(leaf, part, atol=ATOL, rtol=0,
                                       err_msg=f"{spec} rank {rank}: {path}")


def test_sharded_checkpoint_saves_whole_and_restores_each_rank(groups, jax_run):
    """``save_checkpoint(shardings=)`` from the dp2tp2 ranks writes the
    whole tensors (fei_tpu's step's parameters, within ATOL);
    ``restore_checkpoint(shardings=)`` gives each rank its own slices of
    the parameters and moments back bitwise."""
    assert all(r["restored_bitwise"] for r in groups["four"])
    spec, _, want = jax_run
    if spec != "dp2tp2":
        return
    saved = groups["four"][0]["saved_whole"]
    assert set(saved) == set(want)
    for path, leaf in saved.items():
        np.testing.assert_allclose(leaf, want[path], atol=ATOL, rtol=0, err_msg=path)


def test_tp_ranks_hold_their_megatron_shards(groups):
    wq = {r["train tp2"][1]["layers/wq"].shape for r in groups["two"]}
    assert wq == {(2, 64, 32)}  # [L, h, H*d / tp]
    dp = [r["train dp2"][1]["layers/wq"] for r in groups["two"]]
    np.testing.assert_array_equal(dp[0], dp[1])  # dp peers: one replica


def test_loss_falls_over_five_dp2tp2_steps(groups):
    """The twin of tests/test_parallel.py's test_train_step_reduces_loss_sharded."""
    for r in groups["four"]:
        losses = r["fall"]
        assert all(np.isfinite(losses))
        assert losses[-1] < losses[0], f"loss did not decrease: {losses}"
    assert len({tuple(r["fall"]) for r in groups["four"]}) == 1
