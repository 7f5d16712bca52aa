"""fei_tpu_torch against fei_tpu: the scenarios of tests/test_connectors.py run on the port's copy, then the
cross-package checks at the end of this file.

Connector tests: real in-process servers on ephemeral ports.

This is the hermetic multi-process-boundary coverage the reference lacks
(SURVEY.md §4 — it only mocks Popen); here the actual HTTP request path is
exercised end-to-end against MemdirServer / MemorychainNode threads.
"""

from __future__ import annotations

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import pytest

from fei_tpu_torch.memory.memdir.server import MemdirServer
from fei_tpu_torch.memory.memorychain.node import MemorychainNode
from fei_tpu_torch.tools.memdir_connector import MemdirConnector
from fei_tpu_torch.tools.memorychain_connector import (
    MemorychainConnector,
    add_memory_from_conversation,
)
from fei_tpu_torch.utils.errors import ConnectionError_, MemoryError_


@pytest.fixture()
def memdir_server(tmp_path):
    server = MemdirServer(base=str(tmp_path / "Memdir"), port=0, api_key="test-key")
    server.start_background()
    yield server
    server.shutdown()


@pytest.fixture()
def memdir(memdir_server):
    return MemdirConnector(
        server_url=f"http://127.0.0.1:{memdir_server.port}", api_key="test-key"
    )


@pytest.fixture()
def chain_node(tmp_path):
    node = MemorychainNode(node_id="test-node", port=0,
                           base_dir=str(tmp_path / "chain"))
    node.start_background()
    yield node
    node.shutdown()


@pytest.fixture()
def chain(chain_node):
    return MemorychainConnector(node_url=chain_node.address)


class TestMemdirConnector:
    def test_health(self, memdir):
        assert memdir.check_connection()
        assert memdir.server_status()["running"]

    def test_bad_api_key_rejected(self, memdir_server):
        conn = MemdirConnector(
            server_url=f"http://127.0.0.1:{memdir_server.port}", api_key="wrong"
        )
        with pytest.raises(MemoryError_, match="401"):
            conn.list_memories()

    def test_crud_roundtrip(self, memdir):
        mem = memdir.create_memory(
            "remember the mesh layout", headers={"Subject": "mesh"},
            tags=["tpu", "sharding"],
        )
        mid = mem["id"]
        assert memdir.get_memory(mid)["content"] == "remember the mesh layout"
        listed = memdir.list_memories(status="new")
        assert any(m["id"] == mid for m in listed)

        moved = memdir.move_memory(mid, ".Projects")
        assert moved["folder"] == ".Projects"
        assert memdir.delete_memory(mid) is True  # → .Trash
        trashed = memdir.list_memories(folder=".Trash", status="cur")
        assert any(m["id"] == mid for m in trashed)

    def test_search_query_language(self, memdir):
        memdir.create_memory("jax pjit notes", tags=["tpu"])
        memdir.create_memory("grocery list", tags=["home"])
        out = memdir.search("#tpu", with_content=True)
        assert out["count"] == 1
        assert "pjit" in out["results"][0]["content"]
        out = memdir.search("grocery", with_content=True)
        assert out["count"] == 1
        assert "grocery" in out["results"][0]["content"]

    def test_folders(self, memdir):
        created = memdir.create_folder("projects/tpu")
        assert created.startswith(".")
        assert created in memdir.list_folders()
        stats = memdir.folder_stats(created)
        assert stats["total"] == 0
        assert memdir.delete_folder(created, force=True)

    def test_filters_run(self, memdir):
        memdir.create_memory("some python trick", tags=["python"])
        stats = memdir.run_filters()
        assert isinstance(stats, dict)

    def test_connection_error_when_down(self):
        conn = MemdirConnector(server_url="http://127.0.0.1:1", api_key="k")
        with pytest.raises(ConnectionError_):
            conn.list_memories()
        assert not conn.check_connection()

    def test_start_server_command_shape(self, memdir):
        cmd = memdir.start_server_command()
        assert "fei_tpu_torch.memory.memdir.server" in cmd
        assert "--api-key" in cmd


class TestMemorychainConnector:
    def test_health_and_status(self, chain):
        assert chain.check_connection()
        status = chain.node_status()
        assert status["node_id"] == "test-node"
        net = chain.network_status()
        assert net["reachable"] == 1

    def test_add_and_search_memory(self, chain):
        block = chain.add_memory("ring attention beats naive at 32k",
                                 tags=["attention", "perf"])
        assert block["memory_data"]["content"].startswith("ring attention")
        mid = block["memory_data"]["memory_id"]
        hits = chain.search_memories("ring attention")
        assert any(h["memory_id"] == mid for h in hits)
        by_tag = chain.search_by_tag("#perf")
        assert any(h["memory_id"] == mid for h in by_tag)
        assert chain.get_memory(mid)["memory_id"] == mid
        assert chain.get_memory("ffffffff") is None

    def test_chain_validation(self, chain):
        chain.add_memory("block one")
        assert chain.validate_chain() is True
        assert len(chain.get_chain()) >= 2  # genesis + memory

    def test_stats(self, chain):
        chain.add_memory("tagged", tags=["x"])
        stats = chain.get_chain_stats()
        assert stats["length"] >= 2
        assert stats["valid"] is True

    def test_wallet_id_with_space_roundtrips(self, chain):
        assert chain.wallet_balance("node 1") >= 100.0  # percent-encoding path

    def test_reference_extraction(self, chain):
        block = chain.add_memory("anchor memory")
        mid = block["memory_data"]["memory_id"]
        text = f"see #mem:{mid} for details"
        assert chain.extract_references(text) == [mid]
        resolved = chain.resolve_references(text)
        assert resolved[mid]["memory_id"] == mid

    def test_task_lifecycle_over_http(self, chain):
        task = chain.propose_task("write a pallas kernel", difficulty=2)
        tid = task["memory_id"]
        assert chain.claim_task(tid, "worker-1")
        sol = chain.submit_solution(tid, "def kernel(): ...", "worker-1")
        assert sol["id"]
        state = chain.vote_solution(tid, sol["id"], True, "voter-1")
        assert state in ("completed", "solution_submitted")
        tasks = chain.list_tasks()
        assert any(t["memory_id"] == tid for t in tasks)
        assert chain.get_task(tid)["memory_id"] == tid

    def test_wallet(self, chain):
        bal = chain.wallet_balance("test-node")
        assert bal >= 100.0  # initial grant
        assert isinstance(chain.wallet_transactions("test-node"), list)

    def test_update_status(self, chain):
        out = chain.update_status(status="busy", load=0.7)
        assert out["status"] == "busy"
        assert chain.network_status()["nodes"][0]["load"] == 0.7

    def test_add_memory_from_conversation(self, chain):
        messages = [
            {"role": "user", "content": "how do I shard the KV cache?"},
            {"role": "assistant", "content": [{"type": "text", "text": "over tp"}]},
        ]
        block = add_memory_from_conversation(chain, messages, tags=["kv"])
        content = block["memory_data"]["content"]
        assert "user: how do I shard" in content
        assert "assistant: over tp" in content


# ----------------------------------------------------- across the packages

_CROSS = [("fei_tpu", "fei_tpu_torch"), ("fei_tpu_torch", "fei_tpu")]


@pytest.mark.parametrize("client_pkg,server_pkg", _CROSS)
def test_memdir_connector_against_the_other_packages_server(client_pkg, server_pkg, tmp_path):
    """One package's MemdirConnector is answered by the other package's
    Memdir server: the CRUD round trip, the query language and folders."""
    import importlib

    Server = importlib.import_module(f"{server_pkg}.memory.memdir.server").MemdirServer
    Conn = importlib.import_module(f"{client_pkg}.tools.memdir_connector").MemdirConnector
    srv = Server(base=str(tmp_path / "Memdir"), port=0, api_key="cross-key")
    srv.start_background()
    try:
        conn = Conn(server_url=f"http://127.0.0.1:{srv.port}", api_key="cross-key")
        assert conn.check_connection()
        mid = conn.create_memory("remember the page table", headers={"Subject": "kv"},
                                 tags=["kv"])["id"]
        assert conn.get_memory(mid)["content"] == "remember the page table"
        out = conn.search("#kv", with_content=True)
        assert out["count"] == 1 and out["results"][0]["id"] == mid
        assert conn.move_memory(mid, ".Projects")["folder"] == ".Projects"
        assert ".Projects" in conn.list_folders()
        assert conn.delete_memory(mid) is True
        assert any(m["id"] == mid for m in conn.list_memories(folder=".Trash", status="cur"))
    finally:
        srv.shutdown()


@pytest.mark.parametrize("client_pkg,server_pkg", _CROSS)
def test_memorychain_connector_against_the_other_packages_node(client_pkg, server_pkg, tmp_path):
    """One package's MemorychainConnector is answered by the other
    package's node: memories, chain validation, and a task."""
    import importlib

    Node = importlib.import_module(f"{server_pkg}.memory.memorychain.node").MemorychainNode
    Conn = importlib.import_module(
        f"{client_pkg}.tools.memorychain_connector").MemorychainConnector
    node = Node(node_id="cross-node", port=0, base_dir=str(tmp_path / "chain"))
    node.start_background()
    try:
        conn = Conn(node_url=node.address)
        assert conn.node_status()["node_id"] == "cross-node"
        mid = conn.add_memory("paged attention spec", tags=["kv"])["memory_data"]["memory_id"]
        assert any(h["memory_id"] == mid for h in conn.search_memories("paged attention"))
        assert conn.validate_chain() is True
        tid = conn.propose_task("port the scanner", difficulty=1)["memory_id"]
        assert conn.claim_task(tid, "worker-1")
        assert conn.get_task(tid)["memory_id"] == tid
    finally:
        node.shutdown()
