"""MCP (Model Context Protocol) client: stdio + HTTP JSON-RPC services.

Capability parity with the reference (fei/core/mcp.py:40-1184):

- ``ProcessManager`` — child-server lifecycle: spawn in its own process
  group, SIGTERM→SIGKILL escalation on stop, atexit cleanup (reference
  :52-174). A dedicated reader thread per process replaces the reference's
  30 s stdout polling loop (:594-608), so responses resolve as soon as the
  line arrives.
- ``MCPClient`` — server configs from Config + ``FEI_TPU_MCP_SERVER_<NAME>``
  env vars (reference ``FEI_MCP_SERVER_*`` :272-277), http(s) URL validation
  (:300), line-delimited JSON-RPC 2.0 over stdin/stdout for stdio servers
  (:553-621) and JSON-RPC POST for HTTP servers (:683-694).
- Typed wrappers ``MCPMemoryService`` (9 knowledge-graph methods, :761-864),
  ``MCPFetchService`` (:867), ``MCPBraveSearchService`` with direct-REST
  fallback (:954-1010), ``MCPGitHubService`` (:1045).
- ``MCPManager`` — the facade the agent runtime holds (:1097-1114), plus
  ``make_mcp_dispatcher`` wiring ``mcp_<service>_<method>`` passthrough tool
  names into the ToolRegistry (reference fei/tools/registry.py:409-452).

All calls are synchronous; the registry already runs tool handlers in its
thread pool, so no nested event loops (a reference flaw, FLAWS.md) exist.

A copy of ``fei_tpu/agent/mcp.py`` that imports only the port.
"""

from __future__ import annotations

import atexit
import json
import os
import queue
import shlex
import signal
import subprocess
import threading
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass, field

from fei_tpu_torch.utils.config import get_config
from fei_tpu_torch.utils.errors import MCPError
from fei_tpu_torch.utils.logging import get_logger

log = get_logger("agent.mcp")

DEFAULT_TIMEOUT = 30.0  # reference mcp.py:600,689


@dataclass
class MCPServerConfig:
    name: str
    type: str  # "stdio" | "http"
    command: list[str] = field(default_factory=list)  # stdio
    url: str = ""  # http
    env: dict = field(default_factory=dict)


class _StdioProcess:
    """One child MCP server: JSON-RPC lines over stdin/stdout, with a reader
    thread routing responses by request id."""

    def __init__(self, name: str, command: list[str], env: dict | None = None):
        self.name = name
        self.command = command
        self.proc = subprocess.Popen(
            command,
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
            env={**os.environ, **(env or {})},
            start_new_session=True,
            text=True,
            bufsize=1,
        )
        self._pending: dict[int, queue.Queue] = {}
        self._lock = threading.Lock()
        self._write_lock = threading.Lock()
        self._next_id = 0
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _read_loop(self) -> None:
        try:
            for line in self.proc.stdout:  # type: ignore[union-attr]
                line = line.strip()
                if not line:
                    continue
                try:
                    msg = json.loads(line)
                except ValueError:
                    log.debug("mcp %s: non-JSON line: %.100s", self.name, line)
                    continue
                rid = msg.get("id")
                with self._lock:
                    waiter = self._pending.pop(rid, None)
                if waiter is not None:
                    waiter.put(msg)
        except ValueError:
            pass  # stdout closed mid-read
        # EOF: the child exited — fail every in-flight call immediately
        # rather than letting each one run out its full timeout.
        with self._lock:
            pending, self._pending = list(self._pending.values()), {}
        exit_err = {"error": {"message": f"mcp server '{self.name}' exited "
                                         f"(code {self.proc.poll()})"}}
        for waiter in pending:
            waiter.put(exit_err)

    def call(self, method: str, params: dict | None = None,
             timeout: float = DEFAULT_TIMEOUT) -> dict:
        if self.proc.poll() is not None:
            raise MCPError(f"mcp server '{self.name}' exited "
                           f"(code {self.proc.returncode})")
        with self._lock:
            self._next_id += 1
            rid = self._next_id
            waiter: queue.Queue = queue.Queue(maxsize=1)
            self._pending[rid] = waiter
        request = {"jsonrpc": "2.0", "id": rid, "method": method,
                   "params": params or {}}
        try:
            assert self.proc.stdin is not None
            # registry handlers run in a thread pool, so concurrent calls are
            # normal; serialize write+flush or large payloads interleave
            # mid-line once they exceed the BufferedWriter capacity
            with self._write_lock:
                self.proc.stdin.write(json.dumps(request) + "\n")
                self.proc.stdin.flush()
        except (BrokenPipeError, OSError) as exc:
            with self._lock:
                self._pending.pop(rid, None)
            raise MCPError(f"mcp server '{self.name}' pipe broken: {exc}") from exc
        try:
            msg = waiter.get(timeout=timeout)
        except queue.Empty:
            with self._lock:
                self._pending.pop(rid, None)
            raise MCPError(
                f"mcp server '{self.name}' timed out after {timeout}s on {method}"
            ) from None
        if "error" in msg:
            raise MCPError(f"mcp server '{self.name}' error: {msg['error']}")
        return msg.get("result", {})

    def stop(self, grace: float = 3.0) -> None:
        if self.proc.poll() is not None:
            return
        try:
            pgid = os.getpgid(self.proc.pid)
            os.killpg(pgid, signal.SIGTERM)
            try:
                self.proc.wait(timeout=grace)
            except subprocess.TimeoutExpired:
                os.killpg(pgid, signal.SIGKILL)
                self.proc.wait(timeout=grace)
        except (ProcessLookupError, PermissionError):
            pass


class ProcessManager:
    """Registry of running stdio servers with atexit cleanup
    (reference mcp.py:40-174)."""

    def __init__(self):
        self._procs: dict[str, _StdioProcess] = {}
        self._lock = threading.Lock()
        atexit.register(self.stop_all)

    def start(self, name: str, command: list[str], env: dict | None = None) -> _StdioProcess:
        with self._lock:
            existing = self._procs.get(name)
            if existing is not None and existing.proc.poll() is None:
                return existing
            proc = _StdioProcess(name, command, env)
            self._procs[name] = proc
            log.info("started mcp server '%s': %s", name, " ".join(command))
            return proc

    def get(self, name: str) -> _StdioProcess | None:
        with self._lock:
            return self._procs.get(name)

    def stop(self, name: str) -> bool:
        with self._lock:
            proc = self._procs.pop(name, None)
        if proc is None:
            return False
        proc.stop()
        return True

    def stop_all(self) -> None:
        with self._lock:
            procs, self._procs = list(self._procs.values()), {}
        for proc in procs:
            proc.stop()


class MCPClient:
    """Dispatch ``call_service(service, method, params)`` to the right
    transport (reference mcp.py:194-718)."""

    def __init__(self, config=None, process_manager: ProcessManager | None = None):
        self.config = config or get_config()
        self.processes = process_manager or ProcessManager()
        self.servers: dict[str, MCPServerConfig] = {}
        self._load_servers()

    # ----------------------------------------------------------- config load
    def _load_servers(self) -> None:
        """Config file section [mcp] server_<name> = <url or command>, then
        env ``FEI_TPU_MCP_SERVER_<NAME>`` overrides (reference :242-296)."""
        section = self.config.as_dict().get("mcp", {})
        for option, value in section.items():
            if option.startswith("server_") and value:
                self._add_server(option[len("server_"):], str(value))
        for key, value in os.environ.items():
            if key.startswith("FEI_TPU_MCP_SERVER_") and value:
                self._add_server(key[len("FEI_TPU_MCP_SERVER_"):].lower(), value)

    def _add_server(self, name: str, spec: str) -> None:
        if spec.startswith(("http://", "https://")):
            parsed = urllib.parse.urlparse(spec)
            if not parsed.netloc:
                raise MCPError(f"invalid mcp server url for '{name}': {spec}")
            self.servers[name] = MCPServerConfig(name, "http", url=spec)
        else:
            self.servers[name] = MCPServerConfig(name, "stdio",
                                                 command=shlex.split(spec))

    def add_stdio_server(self, name: str, command: list[str],
                         env: dict | None = None) -> None:
        self.servers[name] = MCPServerConfig(name, "stdio", command=command,
                                             env=env or {})

    def add_http_server(self, name: str, url: str) -> None:
        self._add_server(name, url)

    def list_services(self) -> list[str]:
        return sorted(self.servers)

    # -------------------------------------------------------------- dispatch
    def call_service(self, service: str, method: str,
                     params: dict | None = None,
                     timeout: float = DEFAULT_TIMEOUT) -> dict:
        server = self.servers.get(service)
        if server is None:
            raise MCPError(f"unknown mcp service '{service}' "
                           f"(configured: {self.list_services()})")
        if server.type == "stdio":
            proc = self.processes.start(service, server.command, server.env)
            return proc.call(method, params, timeout)
        return self._call_http(server, method, params, timeout)

    @staticmethod
    def _call_http(server: MCPServerConfig, method: str,
                   params: dict | None, timeout: float) -> dict:
        payload = {"jsonrpc": "2.0", "id": 1, "method": method,
                   "params": params or {}}
        req = urllib.request.Request(
            server.url,
            data=json.dumps(payload).encode("utf-8"),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                msg = json.loads(resp.read())
        except (urllib.error.URLError, OSError, ValueError) as exc:
            raise MCPError(f"mcp http service '{server.name}' failed: {exc}") from exc
        if "error" in msg:
            raise MCPError(f"mcp http service '{server.name}' error: {msg['error']}")
        return msg.get("result", {})

    def stop_server(self, service: str) -> bool:
        return self.processes.stop(service)

    def close(self) -> None:
        self.processes.stop_all()


# ------------------------------------------------------------ typed services


class MCPBaseService:
    service = ""

    def __init__(self, client: MCPClient):
        self.client = client

    def _call(self, method: str, params: dict | None = None) -> dict:
        return self.client.call_service(self.service, method, params)

    def available(self) -> bool:
        return self.service in self.client.servers


class MCPMemoryService(MCPBaseService):
    """Knowledge-graph memory server (reference mcp.py:753-864)."""

    service = "memory"

    def create_entities(self, entities: list[dict]) -> dict:
        return self._call("create_entities", {"entities": entities})

    def create_relations(self, relations: list[dict]) -> dict:
        return self._call("create_relations", {"relations": relations})

    def add_observations(self, observations: list[dict]) -> dict:
        return self._call("add_observations", {"observations": observations})

    def delete_entities(self, entity_names: list[str]) -> dict:
        return self._call("delete_entities", {"entityNames": entity_names})

    def delete_observations(self, deletions: list[dict]) -> dict:
        return self._call("delete_observations", {"deletions": deletions})

    def delete_relations(self, relations: list[dict]) -> dict:
        return self._call("delete_relations", {"relations": relations})

    def read_graph(self) -> dict:
        return self._call("read_graph")

    def search_nodes(self, query: str) -> dict:
        return self._call("search_nodes", {"query": query})

    def open_nodes(self, names: list[str]) -> dict:
        return self._call("open_nodes", {"names": names})


class MCPFetchService(MCPBaseService):
    service = "fetch"

    def fetch(self, url: str, max_length: int = 8000) -> dict:
        return self._call("fetch", {"url": url, "max_length": max_length})


class MCPBraveSearchService(MCPBaseService):
    """Web/local search with direct-REST fallback when the MCP server is
    unavailable (reference mcp.py:911-1042). No hardcoded API key — the
    reference's fallback key at cli.py:589 is a known defect."""

    service = "brave_search"

    def __init__(self, client: MCPClient, api_key: str | None = None):
        super().__init__(client)
        self.api_key = api_key or os.environ.get("BRAVE_API_KEY") or \
            get_config().get("brave", "api_key", "")

    def web_search(self, query: str, count: int = 10) -> dict:
        try:
            return self._call("brave_web_search",
                              {"query": query, "count": count})
        except MCPError as exc:
            log.info("mcp brave_search unavailable (%s); trying direct API", exc)
            return self._direct_search(query, count, kind="web")

    def local_search(self, query: str, count: int = 5) -> dict:
        try:
            return self._call("brave_local_search",
                              {"query": query, "count": count})
        except MCPError:
            # reference falls local → web (:1032-1042)
            return self.web_search(query, count)

    def _direct_search(self, query: str, count: int, kind: str) -> dict:
        if not self.api_key:
            raise MCPError("brave search unavailable: no MCP server and no "
                           "BRAVE_API_KEY configured")
        url = ("https://api.search.brave.com/res/v1/web/search?"
               + urllib.parse.urlencode({"q": query, "count": count}))
        req = urllib.request.Request(url, headers={
            "Accept": "application/json",
            "X-Subscription-Token": self.api_key,
        })
        try:
            with urllib.request.urlopen(req, timeout=DEFAULT_TIMEOUT) as resp:
                data = json.loads(resp.read())
        except (urllib.error.URLError, OSError, ValueError) as exc:
            raise MCPError(f"brave direct search failed: {exc}") from exc
        results = [
            {"title": r.get("title", ""), "url": r.get("url", ""),
             "description": r.get("description", "")}
            for r in data.get("web", {}).get("results", [])[:count]
        ]
        return {"results": results, "query": query}


class MCPGitHubService(MCPBaseService):
    service = "github"

    def search_repositories(self, query: str) -> dict:
        return self._call("search_repositories", {"query": query})

    def get_file_contents(self, owner: str, repo: str, path: str,
                          branch: str | None = None) -> dict:
        params = {"owner": owner, "repo": repo, "path": path}
        if branch:
            params["branch"] = branch
        return self._call("get_file_contents", params)

    def create_issue(self, owner: str, repo: str, title: str,
                     body: str = "") -> dict:
        return self._call("create_issue", {"owner": owner, "repo": repo,
                                           "title": title, "body": body})

    def list_issues(self, owner: str, repo: str) -> dict:
        return self._call("list_issues", {"owner": owner, "repo": repo})


class MCPManager:
    """Facade the Assistant holds (reference mcp.py:1097-1114)."""

    def __init__(self, config=None):
        self.client = MCPClient(config)
        self.memory = MCPMemoryService(self.client)
        self.fetch = MCPFetchService(self.client)
        self.brave_search = MCPBraveSearchService(self.client)
        self.github = MCPGitHubService(self.client)

    def list_services(self) -> list[str]:
        return self.client.list_services()

    def close(self) -> None:
        self.client.close()


# --------------------------------------------------- registry integration

BRAVE_WEB_SEARCH = {
    "name": "brave_web_search",
    "description": (
        "Search the web. Returns titles, URLs, and snippets. Use for current "
        "events or any information beyond the local filesystem."
    ),
    "input_schema": {
        "type": "object",
        "properties": {
            "query": {"type": "string", "description": "Search query"},
            "count": {"type": "integer", "description": "Max results (default 10)"},
        },
        "required": ["query"],
    },
}


def make_mcp_dispatcher(manager: MCPManager):
    """Dispatcher for ``mcp_<service>_<method>`` passthrough tool names
    (reference fei/tools/registry.py:409-452)."""

    def dispatch(name: str, args: dict):
        rest = name[len("mcp_"):]
        # longest name first: with services 'brave' and 'brave_search'
        # configured, mcp_brave_search_web_search must hit 'brave_search'
        for service in sorted(manager.list_services(), key=len, reverse=True):
            if rest.startswith(service + "_"):
                method = rest[len(service) + 1:]
                try:
                    return manager.client.call_service(service, method, args)
                except MCPError as exc:
                    return {"error": str(exc)}
        return {"error": f"no mcp service matches tool '{name}' "
                         f"(configured: {manager.list_services()})"}

    return dispatch


def register_mcp_tools(registry, manager: MCPManager) -> None:
    """Wire brave_web_search + the mcp_* passthrough into a ToolRegistry."""
    registry.mcp_dispatcher = make_mcp_dispatcher(manager)

    def brave_web_search(query: str, count: int = 10) -> dict:
        try:
            return manager.brave_search.web_search(query, count)
        except MCPError as exc:
            return {"error": str(exc)}

    registry.register(BRAVE_WEB_SEARCH, brave_web_search)
