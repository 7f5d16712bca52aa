"""fei_tpu_torch against fei_tpu: the scenarios of tests/test_mcp.py run on the port's copy, then the
cross-package checks at the end of this file.

MCP client tests.

Where the reference mocks subprocess.Popen with canned stdout lines
(fei/tests/test_mcp.py:42-93), these tests spawn a REAL tiny JSON-RPC stdio
server (a python -c script) and a real in-process HTTP JSON-RPC endpoint —
exercising the actual pipe/reader-thread/process-group machinery.
"""

from __future__ import annotations

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from fei_tpu_torch.agent.mcp import (
    MCPClient,
    MCPManager,
    ProcessManager,
    register_mcp_tools,
)
from fei_tpu_torch.tools.registry import ToolRegistry
from fei_tpu_torch.utils.errors import MCPError

# A minimal stdio JSON-RPC server: echoes method/params back as the result;
# method "sleep" never answers (for timeout tests); method "boom" errors.
STDIO_SERVER = r"""
import json, sys
for line in sys.stdin:
    req = json.loads(line)
    m = req["method"]
    if m == "sleep":
        continue
    if m == "boom":
        out = {"jsonrpc": "2.0", "id": req["id"], "error": {"code": -1, "message": "boom"}}
    else:
        out = {"jsonrpc": "2.0", "id": req["id"],
               "result": {"method": m, "params": req.get("params", {})}}
    sys.stdout.write(json.dumps(out) + "\n")
    sys.stdout.flush()
"""

STDIO_CMD = [sys.executable, "-u", "-c", STDIO_SERVER]


@pytest.fixture()
def client(monkeypatch):
    monkeypatch.setenv("FEI_TPU_MCP_SERVER_ECHO",
                       " ".join([sys.executable, "-u", "-c", repr(STDIO_SERVER)]))
    c = MCPClient(process_manager=ProcessManager())
    # env-spec round-trips through shlex; register directly for reliability
    c.add_stdio_server("echo", STDIO_CMD)
    yield c
    c.close()


class TestStdio:
    def test_roundtrip(self, client):
        out = client.call_service("echo", "hello", {"x": 1})
        assert out == {"method": "hello", "params": {"x": 1}}

    def test_concurrent_requests_route_by_id(self, client):
        results = {}

        def call(i):
            results[i] = client.call_service("echo", f"m{i}", {"i": i})

        threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
        [t.start() for t in threads]
        [t.join() for t in threads]
        for i in range(8):
            assert results[i]["params"] == {"i": i}

    def test_error_response_raises(self, client):
        with pytest.raises(MCPError, match="boom"):
            client.call_service("echo", "boom")

    def test_timeout(self, client):
        with pytest.raises(MCPError, match="timed out"):
            client.call_service("echo", "sleep", timeout=0.3)
        # server still usable afterwards
        assert client.call_service("echo", "ok")["method"] == "ok"

    def test_stop_and_restart(self, client):
        client.call_service("echo", "warm")
        assert client.stop_server("echo") is True
        # next call restarts the process transparently
        assert client.call_service("echo", "again")["method"] == "again"

    def test_child_death_fails_inflight_calls_fast(self, client):
        import time

        client.call_service("echo", "warm")
        proc = client.processes.get("echo")
        results = []

        def call():
            t0 = time.time()
            try:
                client.call_service("echo", "sleep", timeout=30.0)
            except MCPError as exc:
                results.append((time.time() - t0, str(exc)))

        t = threading.Thread(target=call)
        t.start()
        time.sleep(0.3)
        proc.proc.kill()  # child dies with the call in flight
        t.join(timeout=5)
        assert results, "in-flight call never returned"
        elapsed, message = results[0]
        assert elapsed < 5, f"took {elapsed:.1f}s — waited out the timeout"
        assert "exited" in message

    def test_unknown_service(self, client):
        with pytest.raises(MCPError, match="unknown mcp service"):
            client.call_service("nope", "m")

    def test_env_config_registers_server(self, monkeypatch):
        monkeypatch.setenv("FEI_TPU_MCP_SERVER_FOO", "http://127.0.0.1:9/rpc")
        c = MCPClient(process_manager=ProcessManager())
        assert "foo" in c.list_services()
        assert c.servers["foo"].type == "http"


class _RPCHandler(BaseHTTPRequestHandler):
    def do_POST(self):
        req = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        if req["method"] == "fail":
            out = {"jsonrpc": "2.0", "id": req["id"],
                   "error": {"message": "http fail"}}
        else:
            out = {"jsonrpc": "2.0", "id": req["id"],
                   "result": {"echo": req["method"]}}
        data = json.dumps(out).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *a):
        pass


@pytest.fixture()
def http_rpc():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _RPCHandler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{server.server_address[1]}/rpc"
    server.shutdown()


class TestHTTP:
    def test_http_roundtrip(self, http_rpc):
        c = MCPClient(process_manager=ProcessManager())
        c.add_http_server("svc", http_rpc)
        assert c.call_service("svc", "ping") == {"echo": "ping"}

    def test_http_error(self, http_rpc):
        c = MCPClient(process_manager=ProcessManager())
        c.add_http_server("svc", http_rpc)
        with pytest.raises(MCPError, match="http fail"):
            c.call_service("svc", "fail")

    def test_invalid_url_rejected(self):
        c = MCPClient(process_manager=ProcessManager())
        with pytest.raises(MCPError, match="invalid"):
            c.add_http_server("bad", "http://")


class TestServicesAndRegistry:
    def test_memory_service_methods(self, http_rpc):
        mgr = MCPManager()
        mgr.client.add_http_server("memory", http_rpc)
        assert mgr.memory.available()
        assert mgr.memory.read_graph() == {"echo": "read_graph"}
        assert mgr.memory.search_nodes("q") == {"echo": "search_nodes"}
        assert mgr.memory.create_entities([{"name": "a"}]) == {"echo": "create_entities"}

    def test_fetch_service(self, http_rpc):
        mgr = MCPManager()
        mgr.client.add_http_server("fetch", http_rpc)
        assert mgr.fetch.fetch("http://example.com") == {"echo": "fetch"}

    def test_passthrough_dispatch(self, http_rpc):
        mgr = MCPManager()
        mgr.client.add_http_server("memory", http_rpc)
        reg = ToolRegistry()
        register_mcp_tools(reg, mgr)
        out = reg.execute_tool("mcp_memory_search_nodes", {"query": "x"})
        assert out == {"echo": "search_nodes"}
        out = reg.execute_tool("mcp_unknown_svc_method", {})
        assert "error" in out

    def test_brave_fallback_no_key_is_error_payload(self, monkeypatch):
        monkeypatch.delenv("BRAVE_API_KEY", raising=False)
        mgr = MCPManager()  # no brave_search server configured
        mgr.brave_search.api_key = ""
        reg = ToolRegistry()
        register_mcp_tools(reg, mgr)
        out = reg.execute_tool("brave_web_search", {"query": "anything"})
        assert "error" in out

    def test_github_service_shapes(self, http_rpc):
        mgr = MCPManager()
        mgr.client.add_http_server("github", http_rpc)
        assert mgr.github.search_repositories("jax")["echo"] == "search_repositories"
        assert mgr.github.get_file_contents("o", "r", "p")["echo"] == "get_file_contents"

    def test_mcp_probe_subcommand(self, http_rpc, capsys):
        """fei mcp probe — discovery-method probing (parity: the reference's
        check_mcp_methods.py, no hardcoded key)."""
        import argparse

        from fei_tpu_torch.ui.cli import handle_mcp_probe

        mgr = MCPManager()
        mgr.client.add_http_server("probeme", http_rpc)
        args = argparse.Namespace(service="probeme")
        rc = handle_mcp_probe(args, mgr)
        out = capsys.readouterr().out
        assert rc == 0
        assert "✓ tools/list" in out and "discovery methods answered" in out

    def test_mcp_probe_unknown_service(self, capsys):
        import argparse

        from fei_tpu_torch.ui.cli import handle_mcp_probe

        mgr = MCPManager()
        args = argparse.Namespace(service="ghost")
        rc = handle_mcp_probe(args, mgr)
        assert rc == 1
        assert "0/" in capsys.readouterr().out


# ----------------------------------------------------- across the packages

def _build_args(memory_tools: bool):
    import argparse

    return argparse.Namespace(provider="mock", model=None, max_tool_rounds=8,
                              max_tokens=4000, no_stream=True,
                              memory_tools=memory_tools)


@pytest.fixture(scope="module", params=[False, True], ids=["default", "memory-tools"])
def both_registries(request):
    """Both packages' ``build_assistant`` tool definitions, with and
    without ``--memory-tools`` (no MCP server configured)."""
    from fei_tpu.ui.cli import build_assistant as ref_build
    from fei_tpu_torch.ui.cli import build_assistant

    mp = pytest.MonkeyPatch()
    mp.delenv("BRAVE_API_KEY", raising=False)
    try:
        args = _build_args(request.param)
        yield (request.param, build_assistant(args).tool_manager.get_tools(),
               ref_build(args).tool_manager.get_tools())
    finally:
        mp.undo()


def test_build_assistant_registry_equals_the_reference(both_registries):
    memory_tools, ours, theirs = both_registries
    assert ours == theirs
    names = [t["name"] for t in ours]
    assert "brave_web_search" in names
    assert len(names) == (24 if memory_tools else 15)


def test_default_tool_names_in_chip_smoke_are_the_references(both_registries):
    """chip_smoke.py (where no jax is installed) holds the default turn's
    15 tool names as a literal list; it must be the reference's."""
    import importlib.util
    import pathlib

    memory_tools, _, theirs = both_registries
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_chip_smoke_names", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = smoke.MEMORY_TOOL_NAMES if memory_tools else smoke.DEFAULT_TOOL_NAMES
    assert list(want) == [t["name"] for t in theirs]


def test_union_grammar_tables_equal_the_reference(both_registries):
    """The tool-call union grammar compiled from each registry is bit for
    bit the reference's on the byte tokenizer."""
    import numpy as np

    from fei_tpu.engine import grammar as jg
    from fei_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
    from fei_tpu_torch.engine import grammar as tg
    from fei_tpu_torch.engine.tokenizer import ByteTokenizer

    _, ours, theirs = both_registries
    a = jg.compile_agent_tool_grammar(theirs, JaxByteTokenizer())
    b = tg.compile_agent_tool_grammar(ours, ByteTokenizer())
    assert a.table.dtype == b.table.dtype and np.array_equal(a.table, b.table)
    assert np.array_equal(a.mask_table, b.mask_table)
    assert np.array_equal(a.min_dist, b.min_dist)
    assert a.accepting_states == b.accepting_states
    assert (a.entry, a.accept) == (b.entry, b.accept)


def _cli_both(argv, capsys):
    """Run both packages' CLI ``main`` in-process; (rc, stdout) of each."""
    from fei_tpu.ui.cli import main as ref_main
    from fei_tpu_torch.ui.cli import main

    out = []
    for fn in (main, ref_main):
        rc = fn(list(argv))
        out.append((rc, capsys.readouterr().out))
    return out


@pytest.mark.parametrize("argv", [
    ["mcp", "list"],
    ["mcp", "call", "echo", "hello", "--params", '{"x": 1}'],
    ["mcp", "probe", "echo"],
    ["search", "x"],
    ["--provider", "mock", "--no-stream", "ask", "what is a page table"],
], ids=["list", "call", "probe", "search", "ask"])
def test_mcp_search_and_ask_commands_equal_the_reference(argv, monkeypatch, capsys):
    """``mcp list|call|probe`` against a stdio server set through
    FEI_TPU_MCP_SERVER_ECHO, and ``search``/``ask`` with no Brave key and no
    network, print what the reference prints and exit as it exits."""
    import shlex

    monkeypatch.delenv("BRAVE_API_KEY", raising=False)
    monkeypatch.setenv("FEI_TPU_MCP_SERVER_ECHO", shlex.join(STDIO_CMD))
    ours, theirs = _cli_both(argv, capsys)
    assert ours == theirs
    if argv[0] == "mcp" and argv[1] == "list":
        assert ours[1].startswith("echo ")
    if argv[0] == "ask":
        assert "[mock] echo: what is a page table" in ours[1]


def test_brave_without_key_is_the_references_error_payload(monkeypatch):
    from fei_tpu.agent.mcp import MCPManager as RefManager
    from fei_tpu.agent.mcp import register_mcp_tools as ref_register
    from fei_tpu.tools.registry import ToolRegistry as RefRegistry

    monkeypatch.delenv("BRAVE_API_KEY", raising=False)
    ours, theirs = ToolRegistry(), RefRegistry()
    register_mcp_tools(ours, MCPManager())
    ref_register(theirs, RefManager())
    a = ours.execute_tool("brave_web_search", {"query": "anything"})
    assert a == theirs.execute_tool("brave_web_search", {"query": "anything"})
    assert set(a) == {"error"}
