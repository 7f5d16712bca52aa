"""The embedding federation of fei_tpu_torch against fei_tpu's:
``hash_embed`` bitwise, the federation's recall on the same texts, and
``exchange_banks`` on CPU tensors with no process group, with a one-rank
gloo group, and over two gloo ranks (tests/torch_mesh_ranks.py's two-rank
group) against fei_tpu's on a two-device CPU mesh (its row 0)."""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from fei_tpu.memory.memorychain import embedding_exchange as ref
from fei_tpu_torch.memory.memorychain import embedding_exchange as port
from fei_tpu_torch.memory.memorychain.embedding_exchange import exchange_banks, hash_embed

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_mesh_ranks import BANKS, parallel_results  # noqa: E402

TEXTS = [
    "ring attention rotates kv blocks", "paged kv cache block tables",
    "feicoin wallet reward balance", "the flash attention pallas kernel for prefill",
    "maildir folder hierarchy statistics", "", "UPPER lower MiXeD 123 tokens!",
    "naïve unicode — dashes and émigré accents", "a " * 300,
]

TOPICS = [
    ("m-kernels", "flash attention kernel tiling on the card"),
    ("m-memdir", "maildir atomic delivery tmp new cur"),
    ("m-chain", "proof of work consensus quorum voting"),
    ("m-mesh", "process group all gather collectives"),
]


@pytest.mark.parametrize("dim", [16, 64, 256])
@pytest.mark.parametrize("text", TEXTS)
def test_hash_embed_is_bitwise_the_reference(text, dim):
    ours, theirs = hash_embed(text, dim), ref.hash_embed(text, dim)
    assert ours.dtype == theirs.dtype == np.float32
    assert ours.tobytes() == theirs.tobytes()


def _federations(mod, n=4, bank=8, dim=64):
    feds = [mod.EmbeddingFederation(i, n, bank_size=bank, dim=dim) for i in range(n)]
    for i, fed in enumerate(feds):
        for j in range(3):
            mem_id, text = TOPICS[(i + j) % len(TOPICS)]
            fed.add(f"{mem_id}@{i}.{j}", f"{text} note {j}")
    return feds


@pytest.mark.parametrize("query", ["atomic maildir delivery", "quorum voting",
                                   "flash attention kernel", "nothing in common"])
def test_federation_recall_equals_the_reference(query):
    """The same memories, exchanged (the port through CPU tensors, the
    reference as a host view), recall the same ids and scores."""
    ours, theirs = _federations(port), _federations(ref)
    banks = np.stack([f.local_bank for f in ours])
    assert banks.tobytes() == np.stack([f.local_bank for f in theirs]).tobytes()
    ids = [list(f._ids) for f in ours]
    for a, b in zip(ours, theirs):
        a.sync(banks, device="cpu")
        a.install_global(a._global, ids)
        b.install_global(banks, ids)
    for a, b in zip(ours, theirs):
        assert a.search(query, top_k=3) == b.search(query, top_k=3)
    # before any exchange each node recalls from its own bank, as there
    local_a, local_b = _federations(port), _federations(ref)
    assert local_a[1].search(query) == local_b[1].search(query)


def test_exchange_without_a_group_stacks_the_banks_on_the_device():
    banks = np.random.default_rng(0).normal(size=(4, 8, 16)).astype(np.float32)
    out = exchange_banks(banks, device="cpu")
    assert out.device.type == "cpu" and tuple(out.shape) == (1, 4, 8, 16)
    assert out[0].numpy().tobytes() == banks.tobytes()


@pytest.fixture()
def one_rank_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


@pytest.mark.parametrize("n_nodes", [1, 4])
def test_exchange_over_a_one_rank_gloo_group(one_rank_group, n_nodes):
    """Every node's bank reaches the rank: the reference's all-gather at
    axis size 1, more nodes than ranks included."""
    banks = np.random.default_rng(n_nodes).normal(size=(n_nodes, 4, 8)).astype(np.float32)
    out = exchange_banks(banks, group=one_rank_group, device="cpu")
    assert tuple(out.shape) == (1, n_nodes, 4, 8)
    assert out[0].numpy().tobytes() == banks.tobytes()


def test_rejects_nodes_indivisible_by_the_group(one_rank_group, monkeypatch):
    """The reference's error: n_nodes must be a multiple of the group size
    (a group of 3 ranks is stood in for by its reported size)."""
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 3)
    with pytest.raises(ValueError, match="multiple"):
        exchange_banks(np.zeros((4, 4, 8), np.float32), group=one_rank_group, device="cpu")


def test_rejects_bad_node_index_as_the_reference():
    for mod in (ref, port):
        with pytest.raises(ValueError):
            mod.EmbeddingFederation(5, 4)


def test_the_card_is_the_default_and_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no card")
    with pytest.raises((RuntimeError, AssertionError)):
        exchange_banks(np.zeros((2, 4, 8), np.float32))


def test_exchange_over_two_gloo_ranks_equals_the_reference(tmp_path_factory):
    """Each rank contributes its contiguous share of the nodes; both end
    with every bank in rank order, bitwise fei_tpu's gathered row 0."""
    from fei_tpu.parallel.mesh import make_mesh

    two = parallel_results(tmp_path_factory)["two"]
    banks = np.random.default_rng(12).standard_normal(BANKS).astype(np.float32)
    want = np.asarray(ref.exchange_banks(banks, make_mesh({"dp": 2},
                                                          devices=jax.devices()[:2]))[0])
    assert want.tobytes() == banks.tobytes()
    for r in two:
        assert r["banks"].shape == BANKS and r["banks"].tobytes() == want.tobytes()
