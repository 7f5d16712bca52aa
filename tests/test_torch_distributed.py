"""Multi-host init of the port (fei_tpu_torch/parallel/distributed.py),
mirroring tests/test_distributed.py: two processes given the reference's
three variables (FEI_TPU_COORDINATOR, FEI_TPU_NUM_PROCESSES,
FEI_TPU_PROCESS_ID) join one group through ``initialize()``, see each other
in ``process_info()`` and run collectives over a mesh bound to the group;
without the variables ``initialize`` is a no-op, and half of them raise."""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import sys
from pathlib import Path

import pytest

from fei_tpu_torch.parallel import distributed

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_mesh_ranks import run_ranks  # noqa: E402


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(2, "initialize", {}, str(tmp_path_factory.mktemp("init")),
                     env_init=True)


def test_two_ranks_see_each_other(ranks):
    for r in ranks:
        assert r["initialized"] is True and r["again"] is True  # idempotent
        info = r["info"]
        assert info["process_count"] == 2 and info["global_devices"] == 2
        assert info["local_devices"] == 1 and info["backend"] == "gloo"
    assert {r["info"]["process_index"] for r in ranks} == {0, 1}


def test_gathers_are_exact_and_in_rank_order(ranks):
    """The gather gives every rank's bf16 words in rank order."""
    for r in ranks:
        assert r["gather"] == [0.5, 0.5, 0.5, 1.5, 1.5, 1.5]


def test_all_reduce_sums_over_the_axis(ranks):
    assert [r["sum"] for r in ranks] == [3.0, 3.0]


def test_initialize_without_env_is_a_no_op(monkeypatch):
    for var in ("FEI_TPU_COORDINATOR", "FEI_TPU_NUM_PROCESSES", "FEI_TPU_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False
    assert distributed.is_initialized() is False
    info = distributed.process_info()
    assert info["process_count"] == 1 and info["distributed"] is False


def test_partial_env_raises(monkeypatch):
    monkeypatch.setenv("FEI_TPU_COORDINATOR", "127.0.0.1:1")
    monkeypatch.delenv("FEI_TPU_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("FEI_TPU_PROCESS_ID", raising=False)
    with pytest.raises(ValueError, match="FEI_TPU_NUM_PROCESSES"):
        distributed.initialize()


@pytest.mark.parametrize("device,cards,ranks_on_host,want", [
    ("cpu", 0, 2, ("gloo", True)),
    ("cpu", 0, 1, ("gloo", True)),
    ("cuda", 1, 2, ("gloo", True)),  # two ranks on one card: NCCL refuses that
    ("cuda", 1, 1, ("nccl", False)),
    ("cuda", 2, 2, ("nccl", False)),
    ("cuda", 8, 4, ("nccl", False)),
])
def test_backend_follows_where_ranks_live(monkeypatch, device, cards, ranks_on_host, want):
    monkeypatch.setattr(distributed.torch.cuda, "device_count", lambda: cards)
    assert distributed.choose_backend(device, ranks_on_host) == want


@pytest.mark.parametrize("coordinator,local,want", [
    ("127.0.0.1:1234", None, 4),
    ("localhost:1234", None, 4),
    ("tcp://127.0.0.1:1234", None, 4),
    ("10.0.0.5:1234", None, 1),  # one rank a host unless told otherwise
    ("10.0.0.5:1234", "2", 2),
    ("127.0.0.1:1234", "1", 1),
])
def test_ranks_on_host(monkeypatch, coordinator, local, want):
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    assert distributed.ranks_on_host(coordinator, 4) == want
