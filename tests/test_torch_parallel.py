"""The port's mesh (fei_tpu_torch/parallel/mesh.py) against fei_tpu's:
the same spellings parse to the same shapes, the same errors, tags and
geometry; a rank's coordinates follow the reference's row-major device
layout; the engine refuses what the reference refuses (an unknown
weights profile, a tp that does not divide the kv heads) at construction;
and the sp2, tp2ep2 and pp2 engines build on gloo ranks and serve what the
reference serves (tests/torch_mesh_ranks.py's parallel groups). Mirrors
tests/test_sharded_serving.py (TestMeshEnv) and tests/test_parallel.py's
mesh cases."""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fei_tpu.engine.engine import GenerationConfig as JaxGen
from fei_tpu.engine.engine import InferenceEngine as JaxEngine
from fei_tpu.parallel import mesh as jmesh
from fei_tpu_torch.engine.engine import InferenceEngine
from fei_tpu_torch.obs.costmodel import chips_for_tag
from fei_tpu_torch.parallel import mesh as pmesh

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_mesh_ranks import (  # noqa: E402
    EP_PROMPT, LONG_MIN, MAX_SEQ, N_NEW, PROMPTS, SP_PROMPT, parallel_results,
)

SPECS = ["tp2", "dp2tp2", "tp2dp2", "dp=2,tp=4", "tp4dp2", "ep4", "dp1tp2", "tp1",
         "dp=2, tp=2", "sp2pp2"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_and_tags_match_reference(spec):
    assert pmesh.parse_mesh_shape(spec) == jmesh.parse_mesh_shape(spec)
    assert pmesh.env_mesh_tag(spec) == jmesh.env_mesh_tag(spec)


@pytest.mark.parametrize("spec", ["tp2xx", "zz9", "bogus=2", "tp2,dp"])
def test_garbage_specs_raise_like_reference(spec):
    with pytest.raises(ValueError) as want:
        jmesh.parse_mesh_shape(spec)
    with pytest.raises(ValueError) as got:
        pmesh.parse_mesh_shape(spec)
    assert type(got.value) is type(want.value)
    assert pmesh.env_mesh_tag(spec) == jmesh.env_mesh_tag(spec)


def test_single_device_spellings():
    for spec in ("", "0", "off", "none", "single", "ms1", "tp1"):
        assert pmesh.mesh_from_env(env=spec) is None
        assert jmesh.mesh_from_env(env=spec) is None
        assert pmesh.env_mesh_tag(spec) == jmesh.env_mesh_tag(spec) == "ms1"
    assert pmesh.mesh_geometry(None) == jmesh.mesh_geometry(None)
    assert pmesh.mesh_tag(None) == jmesh.mesh_tag(None) == "ms1"


@pytest.mark.parametrize("spec", ["tp2", "dp2tp2", "dp=2,tp=2"])
def test_env_mesh_geometry_matches_reference(spec):
    got = pmesh.mesh_from_env(num_kv_heads=2, env=spec)
    want = jmesh.mesh_from_env(num_kv_heads=2, env=spec)
    assert pmesh.mesh_geometry(got) == jmesh.mesh_geometry(want)
    assert pmesh.mesh_tag(got) == jmesh.mesh_tag(want)
    assert not got.bound  # geometry only until the engine starts its ranks
    assert got.devices.size == want.devices.size


def test_errors_match_reference():
    with pytest.raises(ValueError, match="devices"):
        jmesh.mesh_from_env(num_kv_heads=64, env="tp64")
    with pytest.raises(ValueError, match="devices"):
        pmesh.mesh_from_env(num_kv_heads=64, env="tp64", devices=8)
    for mod in (jmesh, pmesh):
        with pytest.raises(ValueError, match="kv heads"):
            mod.mesh_from_env(num_kv_heads=2, env="tp4")
    with pytest.raises(ValueError):
        jmesh.make_mesh({"tp": 3}, devices=jax.devices()[:8])
    with pytest.raises(ValueError, match="devices"):
        pmesh.make_mesh({"tp": 3}, devices=8)


@pytest.mark.parametrize("n,kv,experts", [(8, 8, 0), (8, 2, 4), (1, 8, 0), (6, 8, 0), (4, 4, 8)])
def test_best_mesh_shape_matches_reference(n, kv, experts):
    assert pmesh.best_mesh_shape(n, kv, experts) == jmesh.best_mesh_shape(n, kv, experts)


def test_coords_follow_reference_layout():
    """Rank r sits where the reference's devices.reshape(sizes) puts device
    r."""
    shape = {"dp": 2, "tp": 2}
    ref = jmesh.make_mesh(shape, devices=jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(ref.devices)
    ids = ids - ids.min()
    for r in range(4):
        m = pmesh.make_mesh(shape, devices=4, rank=r)
        where = tuple(int(i) for i in np.argwhere(ids == r)[0])
        assert tuple(m.coords[ax] for ax in pmesh.AXES) == where
        assert m.devices[where] == r


def test_unbound_mesh_collectives_are_identity_on_size_one_axes():
    m = pmesh.Mesh({"tp": 2}, rank=1)
    x = torch.arange(6.0).reshape(2, 3)
    assert m.all_gather(x, "dp", dim=0) is x
    assert m.all_reduce(x, "dp") is x
    assert m.coords["tp"] == 1 and repr(m).startswith("Mesh(tp2")


@pytest.mark.parametrize("tag,n", [("ms1", 1), ("tp2", 2), ("dp2tp2", 4), ("sp2pp2", 4),
                                   ("garbage", 1), (None, 1)])
def test_chips_for_tag(tag, n):
    assert chips_for_tag(tag) == n


@pytest.mark.parametrize("spec", ["sp2", "tp2ep2", "pp2"])
def test_engine_refuses_unported_axes(spec, tmp_path_factory):
    """An engine on a mesh with an sp, ep or pp axis builds on its gloo
    ranks (it refused these axes before they were ported) and streams the
    greedy tokens of fei_tpu's single-chip engine: sp2 through its
    sequence-sharded prefill, tp2ep2 through the routed experts
    (dropless), pp2 with every layer on every rank."""
    groups = parallel_results(tmp_path_factory)
    name, prompt = {"sp2": ("tiny", SP_PROMPT), "tp2ep2": ("tiny-moe", EP_PROMPT),
                    "pp2": ("tiny", PROMPTS[0])}[spec]
    n = 8 if spec == "sp2" else N_NEW
    ref = JaxEngine.from_config(name, dtype=jnp.float32, max_seq_len=MAX_SEQ, num_layers=2)
    want = ref.generate(prompt, JaxGen(max_new_tokens=n, ignore_eos=True)).token_ids
    r0 = groups["four"][0] if spec == "tp2ep2" else groups["two"][0]
    tag, got = {"sp2": ("sp_tag", "sp_dense"), "tp2ep2": ("tag", "stream"),
                "pp2": ("pp_tag", "pp_stream")}[spec]
    assert r0[tag] == spec and r0[got] == want
    if spec == "sp2":
        assert r0["sp_dense_prefills"] == 1 and len(SP_PROMPT) >= LONG_MIN


def test_engine_validates_weights_profile(monkeypatch):
    monkeypatch.setenv("FEI_TPU_MESH_WEIGHTS", "diagonal")
    monkeypatch.setenv("FEI_TPU_MESH", "tp2")
    with pytest.raises(ValueError, match="weights profile"):
        InferenceEngine.from_config("tiny", device="cpu", dtype=torch.float32,
                                    num_layers=1, paged=True, batch_size=2)


def test_engine_tp_must_divide_kv_heads():
    with pytest.raises(ValueError, match="kv heads"):
        InferenceEngine.from_config("tiny", device="cpu", dtype=torch.float32,
                                    num_layers=1, mesh="tp8")


def test_single_device_engine_records_ms1():
    eng = InferenceEngine.from_config("tiny", device="cpu", dtype=torch.float32,
                                      num_layers=1, paged=True, batch_size=2, mesh="ms1")
    try:
        assert eng.mesh is None and eng.mesh_tag == "ms1" and eng.tp == 1
        assert eng.kv_layout() == {"tp": 1, "head_slices": [[0, 2]]}
    finally:
        eng.close()
