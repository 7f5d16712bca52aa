"""Memorychain node: HTTP server exposing one chain to its peers.

Route parity with the reference's Flask node (memdir_tools/memorychain.py:
1224-1694): vote/update/propose/propose_task/claim_task/submit_solution/
vote_solution/vote_difficulty/wallet/register/sync_nodes/chain/tasks/
network_status/responsible/health/node_status/update_status — on stdlib
http.server, with the node's self-reported status metrics
(status/ai_model/load/current_task, reference :1624-1685).

Run: ``python -m fei_tpu_torch.memory.memorychain.node --port 6789``.

A copy of ``fei_tpu/memory/memorychain/node.py`` that imports only the port.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlparse

from fei_tpu_torch.memory.memorychain.chain import MemoryChain
from fei_tpu_torch.memory.memorychain.transport import HTTPTransport
from fei_tpu_torch.utils.errors import MemoryError_
from fei_tpu_torch.utils.logging import get_logger

log = get_logger("memory.memorychain.node")

DEFAULT_PORT = 6789


class NodeAPI:
    """Socket-free router (same pattern as memdir's MemdirAPI)."""

    def __init__(self, chain: MemoryChain):
        self.chain = chain
        self.status = {
            "status": "idle",  # idle|busy|offline
            "ai_model": "torch_local",
            "load": 0.0,
            "current_task": None,
        }

    def handle(self, method: str, path: str, query: dict, body: dict) -> tuple[int, dict]:
        try:
            return self._route(method, path, query, body)
        except MemoryError_ as exc:
            return 400, {"error": str(exc)}
        except Exception as exc:  # noqa: BLE001
            log.warning("node error on %s %s: %s", method, path, exc)
            return 500, {"error": f"{type(exc).__name__}: {exc}"}

    def _route(self, method: str, path: str, query: dict, body: dict) -> tuple[int, dict]:
        c = self.chain
        if path == "/health":
            return 200, {"status": "ok", "node_id": c.node_id,
                         "chain_length": len(c.blocks)}
        if path == "/memorychain/vote" and method == "POST":
            return 200, {"vote": c.vote_on_proposal(body), "node_id": c.node_id}
        if path == "/memorychain/update" and method == "POST":
            return 200, {"adopted": c.receive_chain_update(body.get("chain", []))}
        if path == "/memorychain/propose" and method == "POST":
            block = c.propose_memory(body.get("memory_data", body))
            if block is None:
                return 409, {"error": "proposal rejected by quorum"}
            return 201, {"block": block.to_dict()}
        if path == "/memorychain/propose_task" and method == "POST":
            block = c.propose_task(
                body.get("description", ""),
                difficulty=int(body.get("difficulty", 1)),
                metadata=body.get("metadata"),
            )
            if block is None:
                return 409, {"error": "task rejected by quorum"}
            return 201, {"block": block.to_dict()}
        if path == "/memorychain/claim_task" and method == "POST":
            ok = c.claim_task(body["task_id"], body.get("node_id"))
            if ok:  # claiming marks the node busy (reference :1324-1330)
                self.status["status"] = "busy"
                self.status["current_task"] = body["task_id"]
            return 200, {"claimed": ok}
        if path == "/memorychain/submit_solution" and method == "POST":
            entry = c.submit_solution(body["task_id"], body.get("solution", ""),
                                      body.get("node_id"))
            if entry is None:
                return 409, {"error": "task not claimable for solutions"}
            return 201, {"solution": entry}
        if path == "/memorychain/vote_solution" and method == "POST":
            state = c.vote_on_solution(body["task_id"], body["solution_id"],
                                       bool(body.get("approve")), body.get("voter"))
            return 200, {"task_state": state}
        if path == "/memorychain/vote_difficulty" and method == "POST":
            result = c.vote_on_task_difficulty(body["task_id"],
                                               int(body["difficulty"]),
                                               body.get("voter"))
            return 200, {"difficulty": result}

        m = re.match(r"^/memorychain/wallet/([^/]+)/transactions$", path)
        if m:
            return 200, {"transactions": c.wallet.history(unquote(m.group(1)))}
        m = re.match(r"^/memorychain/wallet/([^/]+)$", path)
        if m:
            node_id = unquote(m.group(1))
            return 200, {"node_id": node_id,
                         "balance": c.wallet.balance(node_id)}

        if path == "/memorychain/register" and method == "POST":
            address = body.get("address", "")
            added = c.register_peer(address) if address else False
            return 200, {"registered": added, "peers": c.peers,
                         "node_id": c.node_id}
        if path == "/memorychain/sync_nodes":
            return 200, {"peers": c.peers, "node_id": c.node_id}
        if path == "/memorychain/chain":
            return 200, {"chain": [b.to_dict() for b in c.blocks],
                         "length": len(c.blocks), "valid": c.validate_chain()}
        m = re.match(r"^/memorychain/tasks/([0-9a-f]+)$", path)
        if m:
            block = c.get_block(m.group(1))
            if block is None or not block.is_task:
                return 404, {"error": "no such task"}
            return 200, {"task": block.to_dict()}
        if path == "/memorychain/tasks":
            state = (query.get("state") or [None])[0]
            return 200, {"tasks": [b.to_dict() for b in c.list_tasks(state)]}
        m = re.match(r"^/memorychain/responsible/([^/]+)$", path)
        if m:
            return 200, {"memories": [b.to_dict()
                                      for b in c.responsible_memories(unquote(m.group(1)))]}
        if path == "/memorychain/stats":
            return 200, c.stats()
        if path == "/memorychain/node_status":
            return 200, {"node_id": c.node_id, **self.status}
        if path == "/memorychain/update_status" and method == "POST":
            for key in ("status", "ai_model", "load", "current_task"):
                if key in body:
                    self.status[key] = body[key]
            return 200, {"node_id": c.node_id, **self.status}
        if path == "/memorychain/network_status":
            return 200, self._network_status()
        return 404, {"error": f"no route {method} {path}"}

    def _network_status(self) -> dict:
        """Poll peers' node_status in parallel (reference :1535-1577)."""
        import urllib.request

        statuses = [{"node_id": self.chain.node_id, **self.status, "reachable": True}]

        def poll(peer: str) -> dict:
            try:
                with urllib.request.urlopen(
                    f"{peer}/memorychain/node_status", timeout=3
                ) as resp:
                    data = json.loads(resp.read())
                    data["reachable"] = True
                    return data
            except Exception:  # noqa: BLE001
                return {"node_id": peer, "reachable": False}

        if self.chain.peers:
            with ThreadPoolExecutor(max_workers=min(10, len(self.chain.peers))) as pool:
                statuses.extend(pool.map(poll, self.chain.peers))
        loads = [s.get("load", 0.0) for s in statuses if s.get("reachable")]
        return {
            "nodes": statuses,
            "reachable": sum(1 for s in statuses if s.get("reachable")),
            "mean_load": sum(loads) / len(loads) if loads else 0.0,
            "chain_length": len(self.chain.blocks),
        }


def make_handler(api: NodeAPI):
    class Handler(BaseHTTPRequestHandler):
        def _respond(self):
            parsed = urlparse(self.path)
            body = {}
            length = int(self.headers.get("Content-Length") or 0)
            if length:
                try:
                    body = json.loads(self.rfile.read(length).decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    body = {}
            status, payload = api.handle(
                self.command, parsed.path, parse_qs(parsed.query), body
            )
            data = json.dumps(payload, default=str).encode("utf-8")
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        do_GET = do_POST = _respond

        def log_message(self, fmt, *args):
            log.debug("http: " + fmt, *args)

    return Handler


class MemorychainNode:
    def __init__(self, node_id: str | None = None, port: int = DEFAULT_PORT,
                 base_dir: str | None = None, host: str = "127.0.0.1",
                 seed: str | None = None):
        self.chain = MemoryChain(node_id, base_dir, transport=HTTPTransport())
        self.api = NodeAPI(self.chain)
        self.httpd = ThreadingHTTPServer((host, port), make_handler(self.api))
        self.port = self.httpd.server_address[1]
        self.address = f"http://{host}:{self.port}"
        if seed:
            self.connect(seed)

    def connect(self, seed: str) -> None:
        """Join via a seed node: register ourselves, adopt its peer list and
        chain (reference connect_to_network :1726-1765)."""
        transport = self.chain.transport
        try:
            out = transport._post(f"{seed}/memorychain/register",
                                  {"address": self.address})
            self.chain.register_peer(seed)
            for peer in out.get("peers", []):
                if peer != self.address:
                    self.chain.register_peer(peer)
            self.chain.receive_chain_update(transport.fetch_chain(seed))
        except Exception as exc:  # noqa: BLE001
            log.warning("could not join network via %s: %s", seed, exc)

    def serve_forever(self):
        log.info("memorychain node %s on %s", self.chain.node_id, self.address)
        self.httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="Memorychain node")
    p.add_argument("--port", type=int, default=DEFAULT_PORT)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--node-id", default=os.environ.get("MEMORYCHAIN_NODE_ID"))
    p.add_argument("--base-dir", default=None)
    p.add_argument("--seed", default=None, help="address of an existing node to join")
    args = p.parse_args(argv)
    node = MemorychainNode(args.node_id, args.port, args.base_dir,
                           args.host, args.seed)
    print(f"memorychain node {node.chain.node_id} listening on {node.address}",
          flush=True)
    try:
        node.serve_forever()
    except KeyboardInterrupt:
        node.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
