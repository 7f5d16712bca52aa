"""Memdir REST client with server auto-start.

Capability parity with the reference connector (fei/tools/memdir_connector.py:
25-644): URL/API-key resolution from config + env, ``X-API-Key``-authed JSON
requests, port-in-use probing, spawning ``python -m fei_tpu_torch.memory.memdir.server``
as a detached child with a log file and atexit cleanup, health checking with
startup wait, and thin wrappers over the server's CRUD / search / folders /
filters routes (fei_tpu_torch/memory/memdir/server.py).

Differences from the reference: stdlib ``urllib`` instead of ``requests``
(no extra dependency), and the child is killed via its process group with a
SIGTERM→SIGKILL escalation instead of the reference's bare killpg.

A copy of ``fei_tpu/tools/memdir_connector.py`` that imports only the port.
"""

from __future__ import annotations

import atexit
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.parse
import urllib.request

from fei_tpu_torch.utils.config import get_config
from fei_tpu_torch.utils.errors import ConnectionError_, MemoryError_
from fei_tpu_torch.utils.logging import get_logger

log = get_logger("tools.memdir_connector")

DEFAULT_URL = "http://127.0.0.1:5000"


class MemdirConnector:
    """HTTP client for the Memdir server; can spawn the server itself."""

    def __init__(
        self,
        server_url: str | None = None,
        api_key: str | None = None,
        auto_start: bool = False,
        base_dir: str | None = None,
        timeout: float = 10.0,
    ):
        cfg = get_config()
        self.server_url = (
            server_url
            or os.environ.get("MEMDIR_SERVER_URL")
            or cfg.get("memdir", "server_url", DEFAULT_URL)
        ).rstrip("/")
        self.api_key = (
            api_key
            or os.environ.get("MEMDIR_API_KEY")
            or cfg.get("memdir", "api_key", "")
            or "fei-tpu-memdir"
        )
        self.auto_start = auto_start
        self.base_dir = base_dir
        self.timeout = timeout
        self._server_proc: subprocess.Popen | None = None

    # ------------------------------------------------------------- requests
    def _make_request(self, method: str, path: str, params: dict | None = None,
                      body: dict | None = None, _retry: bool = True) -> dict:
        url = f"{self.server_url}{path}"
        if params:
            url += "?" + urllib.parse.urlencode(params)
        data = json.dumps(body).encode("utf-8") if body is not None else None
        req = urllib.request.Request(
            url,
            data=data,
            method=method,
            headers={
                "X-API-Key": self.api_key,
                "Content-Type": "application/json",
            },
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            try:
                payload = json.loads(exc.read())
            except Exception:  # noqa: BLE001
                payload = {"error": str(exc)}
            raise MemoryError_(
                f"memdir server error {exc.code}: {payload.get('error', payload)}"
            ) from exc
        except (urllib.error.URLError, socket.timeout, ConnectionError) as exc:
            # one retry after an auto-start; never re-send non-idempotent
            # requests that may have reached a slow server
            if (self.auto_start and _retry and method == "GET"
                    and self._maybe_start_server()):
                return self._make_request(method, path, params, body, _retry=False)
            if self.auto_start and _retry and method != "GET":
                started = (self._is_local and not self._port_in_use()
                           and self._maybe_start_server())
                if started:
                    return self._make_request(method, path, params, body,
                                              _retry=False)
            raise ConnectionError_(
                f"cannot reach memdir server at {self.server_url}: {exc}"
            ) from exc

    # ------------------------------------------------------- server control
    @property
    def _port(self) -> int:
        parsed = urllib.parse.urlparse(self.server_url)
        return parsed.port or 5000

    @property
    def _is_local(self) -> bool:
        host = urllib.parse.urlparse(self.server_url).hostname
        return host in ("127.0.0.1", "localhost", "::1")

    def _port_in_use(self) -> bool:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.settimeout(0.5)
            return s.connect_ex(("127.0.0.1", self._port)) == 0

    def start_server_command(self) -> list[str]:
        cmd = [
            sys.executable, "-m", "fei_tpu_torch.memory.memdir.server",
            "--port", str(self._port), "--api-key", self.api_key,
        ]
        if self.base_dir:
            cmd += ["--base", self.base_dir]
        return cmd

    def _maybe_start_server(self) -> bool:
        """Spawn the server if the URL is local and the port is free; never
        auto-start for a remote server_url — a local replacement would be a
        different (empty) store."""
        if not self._is_local:
            return False
        if self._server_proc is not None and self._server_proc.poll() is None:
            return self._wait_healthy(5.0)
        if self._port_in_use():
            return self._wait_healthy(2.0)
        return self.start_server()

    def start_server(self, wait: float = 10.0) -> bool:
        log_path = os.path.join(
            self.base_dir or os.path.expanduser("~/.fei_tpu"), "memdir_server.log"
        )
        os.makedirs(os.path.dirname(log_path), exist_ok=True)
        log.info("starting memdir server: %s", " ".join(self.start_server_command()))
        with open(log_path, "ab") as logf:
            self._server_proc = subprocess.Popen(
                self.start_server_command(),
                stdout=logf,
                stderr=subprocess.STDOUT,
                start_new_session=True,
            )
        atexit.register(self.stop_server)
        return self._wait_healthy(wait)

    def _wait_healthy(self, wait: float) -> bool:
        deadline = time.time() + wait
        while time.time() < deadline:
            if self.check_connection():
                return True
            time.sleep(0.15)
        return False

    def stop_server(self) -> bool:
        proc, self._server_proc = self._server_proc, None
        if proc is None or proc.poll() is not None:
            return False
        try:
            os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
            try:
                proc.wait(timeout=3)
            except subprocess.TimeoutExpired:
                os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
                proc.wait(timeout=3)
        except (ProcessLookupError, PermissionError):
            pass
        return True

    def check_connection(self) -> bool:
        try:
            req = urllib.request.Request(f"{self.server_url}/health")
            with urllib.request.urlopen(req, timeout=2) as resp:
                return json.loads(resp.read()).get("status") == "ok"
        except Exception:  # noqa: BLE001
            return False

    def server_status(self) -> dict:
        running = self.check_connection()
        return {
            "running": running,
            "url": self.server_url,
            "managed_pid": self._server_proc.pid
            if self._server_proc and self._server_proc.poll() is None
            else None,
        }

    # ---------------------------------------------------------------- CRUD
    def create_memory(self, content: str, headers: dict | None = None,
                      folder: str = "", flags: str = "",
                      tags: list[str] | str | None = None) -> dict:
        if isinstance(tags, str):
            tags = [t.strip() for t in tags.split(",") if t.strip()]
        out = self._make_request("POST", "/memories", body={
            "content": content, "headers": headers or {},
            "folder": folder, "flags": flags, "tags": tags,
        })
        return out.get("memory", out)

    def list_memories(self, folder: str = "", status: str = "new",
                      with_content: bool = False) -> list[dict]:
        out = self._make_request("GET", "/memories", params={
            "folder": folder, "status": status,
            "with_content": "true" if with_content else "false",
        })
        return out.get("memories", [])

    def get_memory(self, memory_id: str, folder: str | None = None) -> dict:
        params = {"folder": folder} if folder else None
        return self._make_request("GET", f"/memories/{memory_id}",
                                  params=params).get("memory", {})

    def update_memory(self, memory_id: str, folder: str | None = None,
                      status: str | None = None, flags: str | None = None,
                      headers: dict | None = None) -> dict:
        body: dict = {}
        if folder is not None:
            body["folder"] = folder
        if status is not None:
            body["status"] = status
        if flags is not None:
            body["flags"] = flags
        if headers is not None:
            body["headers"] = headers
        return self._make_request("PUT", f"/memories/{memory_id}",
                                  body=body).get("memory", {})

    def move_memory(self, memory_id: str, target_folder: str,
                    status: str = "cur") -> dict:
        return self.update_memory(memory_id, folder=target_folder, status=status)

    def delete_memory(self, memory_id: str, hard: bool = False) -> bool:
        out = self._make_request("DELETE", f"/memories/{memory_id}",
                                 params={"hard": "true" if hard else "false"})
        return bool(out.get("deleted"))

    # -------------------------------------------------------------- search
    def search(self, query: str, folder: str | None = None,
               with_content: bool = False, limit: int | None = None) -> dict:
        if limit is not None and "limit:" not in query:
            query = f"{query} limit:{limit}".strip()
        params = {"q": query, "with_content": "true" if with_content else "false"}
        if folder:
            params["folder"] = folder
        out = self._make_request("GET", "/search", params=params)
        return {"results": out.get("results", []), "count": out.get("count", 0)}

    # ------------------------------------------------------------- folders
    def list_folders(self) -> list[str]:
        return self._make_request("GET", "/folders").get("folders", [])

    def create_folder(self, name: str) -> str:
        return self._make_request("POST", "/folders",
                                  body={"name": name}).get("folder", name)

    def delete_folder(self, name: str, force: bool = False) -> bool:
        quoted = urllib.parse.quote(name, safe="")
        out = self._make_request("DELETE", f"/folders/{quoted}",
                                 params={"force": "true" if force else "false"})
        return bool(out.get("deleted"))

    def rename_folder(self, name: str, new_name: str) -> str:
        quoted = urllib.parse.quote(name, safe="")
        return self._make_request("PUT", f"/folders/{quoted}",
                                  body={"rename": new_name}).get("folder", new_name)

    def folder_stats(self, name: str) -> dict:
        quoted = urllib.parse.quote(name, safe="")
        return self._make_request("GET", f"/folders/{quoted}/stats").get("stats", {})

    # ------------------------------------------------------------- filters
    def run_filters(self, folder: str = "") -> dict:
        return self._make_request("POST", "/filters/run",
                                  body={"folder": folder}).get("stats", {})
