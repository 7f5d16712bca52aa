"""fei_tpu_torch against fei_tpu: the scenarios of tests/test_memory_tools.py run on the port's copy, then the
cross-package checks at the end of this file.

Memory tool suite tests: registry-dispatched handlers over a live
in-process Memdir server, plus MemoryManager fan-out over both stores."""

from __future__ import annotations

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import pytest

from fei_tpu_torch.memory.memdir.server import MemdirServer
from fei_tpu_torch.memory.memorychain.node import MemorychainNode
from fei_tpu_torch.tools.memdir_connector import MemdirConnector
from fei_tpu_torch.tools.memorychain_connector import MemorychainConnector
from fei_tpu_torch.tools.memory_tools import (
    MEMORY_TOOL_DEFINITIONS,
    MemoryManager,
    create_memory_tools,
)
from fei_tpu_torch.tools.registry import ToolRegistry


@pytest.fixture()
def memdir_server(tmp_path):
    server = MemdirServer(base=str(tmp_path / "Memdir"), port=0, api_key="k")
    server.start_background()
    yield server
    server.shutdown()


@pytest.fixture()
def registry(memdir_server):
    reg = ToolRegistry()
    conn = MemdirConnector(
        server_url=f"http://127.0.0.1:{memdir_server.port}", api_key="k"
    )
    names = create_memory_tools(reg, conn)
    assert len(names) == len(MEMORY_TOOL_DEFINITIONS) == 9
    return reg


class TestMemoryTools:
    def test_all_tools_registered_with_schemas(self, registry):
        for d in MEMORY_TOOL_DEFINITIONS:
            assert d["name"] in registry.list_tools()
        schemas = registry.get_schemas()
        assert any(s["name"] == "memory_search" for s in schemas)

    def test_create_then_search_via_registry(self, registry):
        out = registry.execute_tool("memory_create", {
            "content": "pallas flash attention tiling notes",
            "subject": "pallas", "tags": "tpu,kernels", "flags": "F",
        })
        assert out["created"]
        found = registry.execute_tool("memory_search", {
            "query": "#kernels", "with_content": True,
        })
        assert found["count"] == 1
        assert "tiling" in found["results"][0]["content"]

    def test_view_list_delete(self, registry):
        created = registry.execute_tool("memory_create", {"content": "temp note"})
        mid = created["created"]
        view = registry.execute_tool("memory_view", {"memory_id": mid})
        assert view["content"] == "temp note"
        listed = registry.execute_tool("memory_list", {"status": "new"})
        assert listed["count"] >= 1
        deleted = registry.execute_tool("memory_delete", {"memory_id": mid})
        assert deleted["deleted"] is True

    def test_search_by_tag_rewrites_query(self, registry):
        registry.execute_tool("memory_create",
                              {"content": "x", "tags": "solo"})
        out = registry.execute_tool("memory_search_by_tag", {"tag": "#solo"})
        assert out["count"] == 1

    def test_validation_rejects_missing_required(self, registry):
        from fei_tpu_torch.utils.errors import ToolValidationError

        with pytest.raises(ToolValidationError, match="content"):
            registry.execute_tool("memory_create", {})

    def test_server_status_tool(self, registry):
        out = registry.execute_tool("memory_server_status", {})
        assert out["running"] is True

    def test_error_payload_not_exception(self, memdir_server):
        reg = ToolRegistry()
        conn = MemdirConnector(server_url="http://127.0.0.1:1", api_key="k")
        create_memory_tools(reg, conn)
        out = reg.execute_tool("memory_list", {})
        assert "error" in out


class TestMemoryManager:
    def test_fanout_and_replication(self, memdir_server, tmp_path):
        node = MemorychainNode(node_id="mm-node", port=0,
                               base_dir=str(tmp_path / "chain"))
        node.start_background()
        try:
            mgr = MemoryManager(
                MemdirConnector(f"http://127.0.0.1:{memdir_server.port}",
                                api_key="k"),
                MemorychainConnector(node.address),
            )
            assert mgr.status() == {"memdir": True, "memorychain": True}
            saved = mgr.save("shared fact about rope scaling",
                             tags=["rope"], replicate=True, Subject="rope")
            assert saved["memdir"] and saved["memorychain"]
            out = mgr.search_all("rope scaling")
            assert out["count"] >= 2  # found in both stores
            assert not out["errors"]
        finally:
            node.shutdown()

    def test_fanout_isolates_store_failure(self, memdir_server):
        mgr = MemoryManager(
            MemdirConnector(f"http://127.0.0.1:{memdir_server.port}", api_key="k"),
            MemorychainConnector("http://127.0.0.1:1"),
        )
        mgr.memdir.create_memory("only in memdir please")
        out = mgr.search_all("only in memdir")
        assert len(out["memdir"]) == 1
        assert "memorychain" in out["errors"]


# ----------------------------------------------------- across the packages

def test_memory_tool_definitions_equal_the_reference():
    from fei_tpu.tools.memory_tools import MEMORY_TOOL_DEFINITIONS as REF

    assert MEMORY_TOOL_DEFINITIONS == REF


def test_tool_calls_give_the_references_payloads(memdir_server):
    """The same calls through both packages' registries, against one live
    server, return the same payloads (ids and times aside)."""
    from fei_tpu.tools.memdir_connector import MemdirConnector as RefConnector
    from fei_tpu.tools.memory_tools import create_memory_tools as ref_create
    from fei_tpu.tools.registry import ToolRegistry as RefRegistry

    url = f"http://127.0.0.1:{memdir_server.port}"
    ours, theirs = ToolRegistry(), RefRegistry()
    create_memory_tools(ours, MemdirConnector(server_url=url, api_key="k"))
    ref_create(theirs, RefConnector(server_url=url, api_key="k"))

    def norm(x):
        if isinstance(x, dict):
            return {k: norm(v) for k, v in x.items()
                    if k not in ("id", "filename", "created", "memory_id", "Date",
                                 "timestamp", "path", "date")}
        if isinstance(x, list):
            return [norm(v) for v in x]
        return x

    for reg in (ours, theirs):
        reg.execute_tool("memory_create", {"content": "grammar tables", "tags": "dfa"})
    calls = [("memory_search", {"query": "#dfa"}),
             ("memory_search_by_tag", {"tag": "dfa"}),
             ("memory_list", {}),
             ("memory_server_status", {})]
    for name, args in calls:
        a, b = ours.execute_tool(name, args), theirs.execute_tool(name, args)
        assert norm(a) == norm(b), name
