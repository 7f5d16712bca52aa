"""The paged scheduler's occupancy and mesh gauges against the JAX package's
``PagedScheduler._update_sched_gauges`` (fei_tpu/engine/scheduler.py):
``engine.mesh_shape``, ``engine.mesh.<axis>`` for every axis,
``scheduler.replica.<g>.slots`` and ``.queue_depth`` for each dp group,
beside ``scheduler.queue_depth`` and ``running_slots``. Each package's
parked scheduler is given the same occupancy by hand
(``torch_mesh_ranks.sched_gauges``) and one call's gauges are compared:
on one device, and on a dp2 mesh (the reference on two of the host's
virtual CPU devices; the port's scheduler on rank 0 of the two-rank gloo
group that ``torch_mesh_ranks.parallel_results`` runs once per session).
"""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import math
import os
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from fei_tpu.engine.engine import InferenceEngine as JaxEngine
from fei_tpu.utils.metrics import METRICS as JAX_METRICS
from fei_tpu_torch.engine.engine import InferenceEngine
from fei_tpu_torch.utils.metrics import METRICS

sys.path.insert(0, str(Path(__file__).resolve().parent))
from conftest import requires_shard_map  # noqa: E402
from torch_mesh_ranks import GAUGE_SLOTS, GAUGE_WAITING, parallel_results, sched_gauges  # noqa: E402

AXES = ("dp", "tp", "ep", "sp", "pp")


def _jax_paged(mesh_spec: str | None, batch_size: int):
    old = os.environ.pop("FEI_TPU_MESH", None)
    if mesh_spec:
        os.environ["FEI_TPU_MESH"] = mesh_spec
    try:
        return JaxEngine.from_config("tiny", dtype=jnp.float32, paged=True,
                                     batch_size=batch_size, max_seq_len=128, num_layers=2)
    finally:
        os.environ.pop("FEI_TPU_MESH", None)
        if old is not None:
            os.environ["FEI_TPU_MESH"] = old


def _occupancy(sizes: dict, rows: int) -> dict:
    """The gauges the placed occupancy should read on a mesh of ``sizes``."""
    slots = [GAUGE_SLOTS[i % len(GAUGE_SLOTS)] for i in range(rows)]
    want = {"scheduler.queue_depth": GAUGE_WAITING, "scheduler.running_slots": sum(slots),
            "engine.mesh_shape": math.prod(sizes.values())}
    want.update({f"engine.mesh.{ax}": sizes.get(ax, 1) for ax in AXES})
    dp = sizes.get("dp", 1)
    if dp > 1:
        per = rows // dp
        for g in range(dp):
            want[f"scheduler.replica.{g}.slots"] = sum(slots[g * per:(g + 1) * per])
            want[f"scheduler.replica.{g}.queue_depth"] = (
                GAUGE_WAITING // dp + (1 if g < GAUGE_WAITING % dp else 0))
    return want


def _shown(gauges: dict) -> dict:
    return {k: v for k, v in gauges.items() if not k.startswith("pool.")}


def test_one_device_gauges_match_jax():
    jeng = _jax_paged(None, 4)
    eng = InferenceEngine.from_config("tiny", paged=True, batch_size=4, device="cpu",
                                      dtype=torch.float32, max_seq_len=128, num_layers=2)
    try:
        want = sched_gauges(jeng.scheduler, JAX_METRICS)
        got = sched_gauges(eng.scheduler, METRICS)
    finally:
        eng.close()
        jeng.scheduler.close()
    assert _shown(got) == _shown(want) == _occupancy({}, 4)
    assert not any(k.startswith("scheduler.replica.") for k in got)


@requires_shard_map
def test_dp2_gauges_match_jax(tmp_path_factory):
    jeng = _jax_paged("dp2", 2)
    try:
        assert jeng.scheduler.B == 4  # 2 slots a replica group x dp2
        want = sched_gauges(jeng.scheduler, JAX_METRICS)
    finally:
        jeng.scheduler.close()
    rank0 = parallel_results(tmp_path_factory)["two"][0]
    assert rank0["dp2_slots"] == 4
    got = rank0["dp2_gauges"]
    assert _shown(got) == _shown(want) == _occupancy({"dp": 2}, 4)
    # the replica shares add up to the scheduler's own gauges
    assert sum(got[f"scheduler.replica.{g}.slots"] for g in range(2)) == sum(
        GAUGE_SLOTS[i % len(GAUGE_SLOTS)] for i in range(4))
