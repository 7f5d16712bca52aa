"""fei_tpu_torch against fei_tpu: the scenarios of tests/test_memorychain.py run on the port's copy, then the
cross-package checks at the end of this file.

Memorychain tests: blocks/PoW, wallet, multi-node loopback consensus,
task lifecycle with rewards, chain sync, HTTP node federation — the
hermetic distributed tests the reference lacks (SURVEY.md §4)."""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import json
import urllib.request

import pytest

from fei_tpu_torch.memory.memorychain.chain import (
    DIFFICULTY_REWARDS,
    INITIAL_GRANT,
    FeiCoinWallet,
    MemoryBlock,
    MemoryChain,
)
from fei_tpu_torch.memory.memorychain.transport import LoopbackTransport


def make_cluster(tmp_path, n=3, difficulty=1):
    """n chains wired over a loopback transport, fully meshed."""
    transport = LoopbackTransport()
    chains = []
    for i in range(n):
        c = MemoryChain(f"node-{i}", str(tmp_path / f"n{i}"),
                        transport=transport, difficulty=difficulty)
        transport.register(f"node-{i}", c)
        chains.append(c)
    for c in chains:
        for other in chains:
            if other is not c:
                c.register_peer(other.node_id)
    return chains, transport


class TestBlock:
    def test_mine_meets_difficulty(self):
        b = MemoryBlock(1, 1.0, "m1", {"content": "x"}, "0" * 64)
        b.mine(2)
        assert b.hash.startswith("00") and b.hash == b.calculate_hash()

    def test_hash_covers_payload(self):
        b = MemoryBlock(1, 1.0, "m1", {"content": "x"}, "0" * 64)
        b.mine(1)
        h = b.hash
        b.memory_data = {"content": "tampered"}
        assert b.calculate_hash() != h

    def test_difficulty_plurality(self):
        b = MemoryBlock(1, 1.0, "t", {"content": "task"}, "0" * 64, is_task=True)
        b.vote_on_difficulty("a", 2)
        b.vote_on_difficulty("b", 3)
        assert b.vote_on_difficulty("c", 3) == 3


class TestWallet:
    def test_initial_grant_and_transfer(self, tmp_path):
        w = FeiCoinWallet(str(tmp_path / "w.json"))
        assert w.balance("a") == INITIAL_GRANT
        assert w.transfer("a", "b", 30.0)
        assert w.balance("a") == 70.0 and w.balance("b") == 130.0
        assert not w.transfer("a", "b", 1e9)

    def test_persistence(self, tmp_path):
        path = str(tmp_path / "w.json")
        FeiCoinWallet(path).add_funds("a", 5.0)
        w2 = FeiCoinWallet(path)
        assert w2.balance("a") == INITIAL_GRANT + 5.0
        assert any(t["kind"] == "reward" for t in w2.history("a"))


class TestChain:
    def test_genesis_and_persistence(self, tmp_path):
        c = MemoryChain("solo", str(tmp_path))
        c.add_block({"content": "first"})
        reloaded = MemoryChain("solo", str(tmp_path))
        assert len(reloaded.blocks) == 2
        assert reloaded.validate_chain()

    def test_validate_detects_tamper(self, tmp_path):
        c = MemoryChain("solo", str(tmp_path), difficulty=1)
        c.add_block({"content": "a"})
        c.blocks[1].memory_data = {"content": "evil"}
        assert not c.validate_chain()

    def test_solo_propose_commits(self, tmp_path):
        c = MemoryChain("solo", str(tmp_path), difficulty=1)
        block = c.propose_memory({"content": "alone"})
        assert block is not None and c.validate_chain()


class TestConsensus:
    def test_quorum_accepts_and_broadcasts(self, tmp_path):
        chains, _ = make_cluster(tmp_path, 3)
        block = chains[0].propose_memory({"content": "agreed", "tags": ["x"]})
        assert block is not None
        for c in chains:
            assert len(c.blocks) == 2
            assert c.blocks[1].memory_id == block.memory_id
            assert c.validate_chain()

    def test_responsible_node_deterministic(self, tmp_path):
        chains, _ = make_cluster(tmp_path, 3)
        block = chains[1].propose_memory({"content": "who owns this"})
        assert block.responsible_node in {c.node_id for c in chains}

    def test_invalid_proposal_rejected(self, tmp_path):
        chains, _ = make_cluster(tmp_path, 3)
        assert chains[0].vote_on_proposal({"memory_data": {}}) is False
        # peers reject schema-less proposals; 1/3 < quorum
        assert chains[0].propose_memory("not-a-dict") is None  # type: ignore[arg-type]

    def test_unreachable_peers_count_as_no(self, tmp_path):
        transport = LoopbackTransport()
        a = MemoryChain("a", str(tmp_path / "a"), transport=transport, difficulty=1)
        transport.register("a", a)
        a.register_peer("ghost-1")
        a.register_peer("ghost-2")
        assert a.propose_memory({"content": "lonely"}) is None  # 1/3

    def test_longest_chain_adoption(self, tmp_path):
        chains, _ = make_cluster(tmp_path, 2)
        a, b = chains
        a.propose_memory({"content": "one"})
        a.propose_memory({"content": "two"})
        assert len(b.blocks) == 3  # broadcast kept b in sync
        # b must refuse a shorter or diverged chain
        assert not b.receive_chain_update([blk.to_dict() for blk in b.blocks[:2]])
        forged = [blk.to_dict() for blk in b.blocks]
        forged[1]["memory_data"] = {"content": "forged"}
        assert not b.receive_chain_update(forged + [forged[-1]])


class TestTasks:
    def test_full_lifecycle_with_reward(self, tmp_path):
        chains, _ = make_cluster(tmp_path, 3)
        a, b, c = chains
        task = a.propose_task("port the kernel", difficulty=2)
        assert task is not None and task.task_state == "proposed"
        assert a.claim_task(task.memory_id, "node-1")
        assert a.validate_chain()  # suffix re-mined after mutation
        entry = a.submit_solution(task.memory_id, "done: see patch", "node-1")
        assert entry is not None
        before = a.wallet.balance("node-1")
        state = a.vote_on_solution(task.memory_id, entry["id"], True, "node-0")
        assert state == "solution_submitted"  # 1/3 approvals yet
        state = a.vote_on_solution(task.memory_id, entry["id"], True, "node-2")
        assert state == "completed"
        assert a.wallet.balance("node-1") == before + DIFFICULTY_REWARDS[2]

    def test_rejected_solution_dropped(self, tmp_path):
        chains, _ = make_cluster(tmp_path, 3)
        a = chains[0]
        task = a.propose_task("hard thing")
        a.claim_task(task.memory_id)
        entry = a.submit_solution(task.memory_id, "wrong answer")
        a.vote_on_solution(task.memory_id, entry["id"], False, "node-1")
        state = a.vote_on_solution(task.memory_id, entry["id"], False, "node-2")
        assert state == "claimed"
        assert a.get_block(task.memory_id).solutions == []

    def test_list_tasks_by_state(self, tmp_path):
        chains, _ = make_cluster(tmp_path, 3)
        a = chains[0]
        a.propose_task("t1")
        t2 = a.propose_task("t2")
        a.claim_task(t2.memory_id)
        assert len(a.list_tasks()) == 2
        assert len(a.list_tasks("claimed")) == 1


class TestHTTPNode:
    @pytest.fixture
    def nodes(self, tmp_path):
        from fei_tpu_torch.memory.memorychain.node import MemorychainNode

        n1 = MemorychainNode("http-a", 0, str(tmp_path / "a"))
        n1.start_background()
        n2 = MemorychainNode("http-b", 0, str(tmp_path / "b"), seed=n1.address)
        n2.start_background()
        # n1 learns about n2 through the register call n2 made
        yield n1, n2
        n1.shutdown()
        n2.shutdown()

    def _post(self, addr, path, payload):
        req = urllib.request.Request(
            f"{addr}{path}", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        with urllib.request.urlopen(req, timeout=10) as resp:
            return json.loads(resp.read())

    def _get(self, addr, path):
        with urllib.request.urlopen(f"{addr}{path}", timeout=10) as resp:
            return json.loads(resp.read())

    def test_register_and_health(self, nodes):
        n1, n2 = nodes
        assert self._get(n1.address, "/health")["status"] == "ok"
        assert n2.address in n1.chain.peers
        assert n1.address in n2.chain.peers

    def test_propose_replicates_over_http(self, nodes):
        n1, n2 = nodes
        out = self._post(n1.address, "/memorychain/propose",
                         {"memory_data": {"content": "over http"}})
        assert "block" in out
        chain2 = self._get(n2.address, "/memorychain/chain")
        assert chain2["length"] == 2 and chain2["valid"]

    def test_task_over_http_and_wallet(self, nodes):
        n1, n2 = nodes
        out = self._post(n1.address, "/memorychain/propose_task",
                         {"description": "http task", "difficulty": 1})
        tid = out["block"]["memory_id"]
        assert self._post(n1.address, "/memorychain/claim_task",
                          {"task_id": tid, "node_id": "worker"})["claimed"]
        sol = self._post(n1.address, "/memorychain/submit_solution",
                         {"task_id": tid, "solution": "ok", "node_id": "worker"})
        state = self._post(n1.address, "/memorychain/vote_solution",
                           {"task_id": tid, "solution_id": sol["solution"]["id"],
                            "approve": True, "voter": "http-b"})["task_state"]
        assert state == "solution_submitted"  # 1 of 2 voters < 51 %
        state = self._post(n1.address, "/memorychain/vote_solution",
                           {"task_id": tid, "solution_id": sol["solution"]["id"],
                            "approve": True, "voter": "http-a"})["task_state"]
        assert state == "completed"
        bal = self._get(n1.address, "/memorychain/wallet/worker")["balance"]
        assert bal == 100.0 + DIFFICULTY_REWARDS[1]

    def test_network_status(self, nodes):
        n1, n2 = nodes
        status = self._get(n1.address, "/memorychain/network_status")
        assert status["reachable"] == 2


# ----------------------------------------------------- across the packages

@pytest.mark.parametrize("writer,reader", [("fei_tpu", "fei_tpu_torch"),
                                           ("fei_tpu_torch", "fei_tpu")])
def test_chain_saved_by_one_package_loads_in_the_other(writer, reader, tmp_path):
    """Chain files are JSON blocks: a chain saved by either package loads
    and validates in the other with equal block hashes, and a block mined
    by the reader extends it validly for the writer."""
    import importlib

    W = importlib.import_module(f"{writer}.memory.memorychain.chain")
    R = importlib.import_module(f"{reader}.memory.memorychain.chain")
    w = W.MemoryChain("node-x", str(tmp_path), difficulty=1)
    w.propose_memory({"subject": "kernels", "content": "flash attention tiles"})
    w.propose_memory({"subject": "memdir", "content": "atomic delivery"})
    r = R.MemoryChain("node-x", str(tmp_path), difficulty=1)
    assert [b.hash for b in r.blocks] == [b.hash for b in w.blocks]
    assert [b.to_dict() for b in r.blocks] == [b.to_dict() for b in w.blocks]
    assert r.validate_chain() and W.validate_block_dicts(
        [b.to_dict() for b in r.blocks])
    # one hash function: a block rebuilt from its dict hashes the same
    for b in w.blocks:
        assert R.MemoryBlock.from_dict(b.to_dict()).calculate_hash() == b.hash
    r.propose_memory({"subject": "chain", "content": "quorum voting"})
    again = W.MemoryChain("node-x", str(tmp_path), difficulty=1)
    assert len(again.blocks) == len(w.blocks) + 1 and again.validate_chain()
    assert again.blocks[-1].hash == r.blocks[-1].hash
