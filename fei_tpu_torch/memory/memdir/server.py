"""Memdir HTTP server: REST API over the store with X-API-Key auth.

Capability parity with the reference's Flask app (memdir_tools/server.py:46-
380) — /health, /memories CRUD, /search with the query language, /folders
CRUD+stats, /filters/run — built on stdlib http.server so it has no web-
framework dependency and none of the reference's import defects
(server.py:14,31-37: removed werkzeug API + nonexistent module-level
functions). Auth uses hmac.compare_digest (constant-time).

Run: ``python -m fei_tpu_torch.memory.memdir.server --port 5000 --api-key KEY``.

A copy of ``fei_tpu/memory/memdir/server.py`` that imports only the port.
"""

from __future__ import annotations

import argparse
import hmac
import json
import os
import re
import secrets
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlparse

from fei_tpu_torch.memory.memdir.filters import FilterManager
from fei_tpu_torch.memory.memdir.folders import MemdirFolderManager
from fei_tpu_torch.memory.memdir.search import parse_search_args, search_memories
from fei_tpu_torch.memory.memdir.store import MemdirStore
from fei_tpu_torch.utils.errors import MemoryError_
from fei_tpu_torch.utils.logging import get_logger

log = get_logger("memory.server")

DEFAULT_PORT = 5000


class MemdirAPI:
    """Framework-free request router so it can be tested without sockets."""

    def __init__(self, store: MemdirStore, api_key: str):
        self.store = store
        self.api_key = api_key
        self.folders = MemdirFolderManager(store)

    def authorized(self, headers: dict) -> bool:
        provided = ""
        for k, v in headers.items():
            if k.lower() == "x-api-key":
                provided = v
                break
        return hmac.compare_digest(str(provided), self.api_key)

    def handle(self, method: str, path: str, query: dict, body: dict,
               headers: dict) -> tuple[int, dict]:
        if path == "/health":
            return 200, {"status": "ok", "base": self.store.base}
        if not self.authorized(headers):
            return 401, {"error": "invalid or missing X-API-Key"}
        try:
            return self._route(method, path, query, body)
        except MemoryError_ as exc:
            return 400, {"error": str(exc)}
        except Exception as exc:  # noqa: BLE001
            log.warning("server error on %s %s: %s", method, path, exc)
            return 500, {"error": f"{type(exc).__name__}: {exc}"}

    def _route(self, method: str, path: str, query: dict, body: dict) -> tuple[int, dict]:
        q1 = lambda key, default=None: (query.get(key) or [default])[0]  # noqa: E731

        if path == "/memories" and method == "GET":
            folder = q1("folder", "")
            status = q1("status", "new")
            with_content = q1("with_content", "false") == "true"
            mems = self.store.list(folder, status, with_content=with_content)
            return 200, {"memories": [m.to_dict(with_content) for m in mems],
                         "count": len(mems)}
        if path == "/memories" and method == "POST":
            if "content" not in body:
                return 400, {"error": "content required"}
            mem = self.store.save(
                body["content"],
                headers=body.get("headers"),
                folder=body.get("folder", ""),
                flags=body.get("flags", ""),
                tags=body.get("tags"),
            )
            return 201, {"memory": mem.to_dict(False)}

        m = re.match(r"^/memories/([0-9a-f]{8})$", path)
        if m:
            mid = m.group(1)
            if method == "GET":
                mem = self.store.get(mid, query.get("folder", [None])[0])
                if mem is None:
                    return 404, {"error": f"memory {mid} not found"}
                return 200, {"memory": mem.to_dict(True)}
            if method == "PUT":
                # move and/or flag update (reference server.py:124-216)
                mem = self.store.get(mid)
                if mem is None:
                    return 404, {"error": f"memory {mid} not found"}
                if "headers" in body:
                    mem = self.store.rewrite_headers(mid, body["headers"], mem.folder)
                target = body.get("folder", mem.folder)
                status = body.get("status", mem.status if body.get("folder") is None else "cur")
                flags = body.get("flags")
                mem = self.store.move(mid, target, mem.folder, status,
                                      flags if flags is not None else None)
                return 200, {"memory": mem.to_dict(False)}
            if method == "DELETE":
                hard = q1("hard", "false") == "true"
                if not self.store.delete(mid, hard=hard):
                    return 404, {"error": f"memory {mid} not found"}
                return 200, {"deleted": mid, "hard": hard}

        if path == "/search" and method == "GET":
            qstr = q1("q", "")
            sq = parse_search_args(unquote(qstr))
            if q1("with_content", "false") == "true":
                sq.with_content = True
            folder = q1("folder")
            mems = search_memories(
                self.store, sq, folders=[folder] if folder else None
            )
            return 200, {
                "results": [m.to_dict(sq.with_content) for m in mems],
                "count": len(mems),
            }

        if path == "/folders" and method == "GET":
            return 200, {"folders": self.folders.list_folders()}
        if path == "/folders" and method == "POST":
            name = body.get("name", "")
            return 201, {"folder": self.folders.create_folder(name)}
        m = re.match(r"^/folders/(.+)/stats$", path)
        if m and method == "GET":
            return 200, {"stats": self.folders.get_folder_stats(unquote(m.group(1)))}
        m = re.match(r"^/folders/(.+)$", path)
        if m:
            name = unquote(m.group(1))
            if method == "DELETE":
                force = q1("force", "false") == "true"
                return 200, {"deleted": self.folders.delete_folder(name, force)}
            if method == "PUT" and "rename" in body:
                return 200, {"folder": self.folders.rename_folder(name, body["rename"])}

        if path == "/filters/run" and method == "POST":
            stats = FilterManager(self.store).process_memories(body.get("folder", ""))
            return 200, {"stats": stats}

        return 404, {"error": f"no route {method} {path}"}


def make_handler(api: MemdirAPI):
    class Handler(BaseHTTPRequestHandler):
        def _respond(self):
            parsed = urlparse(self.path)
            query = parse_qs(parsed.query)
            body = {}
            length = int(self.headers.get("Content-Length") or 0)
            if length:
                try:
                    body = json.loads(self.rfile.read(length).decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    body = {}
            status, payload = api.handle(
                self.command, parsed.path, query, body, dict(self.headers)
            )
            data = json.dumps(payload, default=str).encode("utf-8")
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        do_GET = do_POST = do_PUT = do_DELETE = _respond

        def log_message(self, fmt, *args):  # route through our logger
            log.debug("http: " + fmt, *args)

    return Handler


class MemdirServer:
    def __init__(self, base: str | None = None, port: int = DEFAULT_PORT,
                 api_key: str | None = None, host: str = "127.0.0.1"):
        self.store = MemdirStore(base)
        self.api_key = api_key or os.environ.get("MEMDIR_API_KEY") or secrets.token_hex(16)
        self.api = MemdirAPI(self.store, self.api_key)
        self.httpd = ThreadingHTTPServer((host, port), make_handler(self.api))
        self.port = self.httpd.server_address[1]

    def serve_forever(self):
        log.info("memdir server on :%d base=%s", self.port, self.store.base)
        self.httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="Memdir HTTP server")
    p.add_argument("--port", type=int,
                   default=int(os.environ.get("MEMDIR_PORT", DEFAULT_PORT)))
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--base", default=None, help="Memdir base directory")
    p.add_argument("--api-key", default=None)
    p.add_argument("--generate-key", action="store_true",
                   help="print a fresh API key and exit")
    args = p.parse_args(argv)
    if args.generate_key:
        print(secrets.token_hex(16))
        return 0
    server = MemdirServer(args.base, args.port, args.api_key, args.host)
    print(f"memdir server listening on {args.host}:{server.port} "
          f"(base {server.store.base})", flush=True)
    if not args.api_key and not os.environ.get("MEMDIR_API_KEY"):
        print(f"generated api key: {server.api_key}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
