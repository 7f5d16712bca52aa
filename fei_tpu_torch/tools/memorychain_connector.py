"""Memorychain node HTTP client.

Capability parity with the reference connector (fei/tools/
memorychain_connector.py:33-716): node address from env/config
(``MEMORYCHAIN_NODE``), health + node/network status, ``add_memory`` via
``/memorychain/propose``, chain fetch, client-side content/tag search over
the fetched chain, chain statistics histograms, ``#mem:id`` reference
extraction/resolution, chain validation with a local fallback, plus the task
lifecycle (propose/claim/submit/vote) and FeiCoin wallet wrappers the
reference exposes through its CLI (memdir_tools/memorychain_cli.py:513-801).

A copy of ``fei_tpu/tools/memorychain_connector.py`` that imports only the port.
"""

from __future__ import annotations

import json
import os
import re
import socket
import urllib.error
import urllib.parse
import urllib.request
import uuid

from fei_tpu_torch.utils.config import get_config
from fei_tpu_torch.utils.errors import ConnectionError_, MemoryError_
from fei_tpu_torch.utils.logging import get_logger

log = get_logger("tools.memorychain_connector")

DEFAULT_NODE = "http://127.0.0.1:6789"

# reference memorychain_connector.py:495-541 — inline memory references
MEM_REF_RE = re.compile(r"#mem:([0-9a-f]{6,})")


class MemorychainConnector:
    """HTTP client for one Memorychain node (fei_tpu_torch/memory/memorychain/node.py)."""

    def __init__(self, node_url: str | None = None, timeout: float = 10.0):
        cfg = get_config()
        self.node_url = (
            node_url
            or os.environ.get("MEMORYCHAIN_NODE")
            or cfg.get("memorychain", "node_url", DEFAULT_NODE)
        ).rstrip("/")
        self.timeout = timeout

    # ------------------------------------------------------------ plumbing
    def _request(self, method: str, path: str, body: dict | None = None,
                 params: dict | None = None) -> dict:
        url = f"{self.node_url}{path}"
        if params:
            url += "?" + urllib.parse.urlencode(params)
        data = json.dumps(body).encode("utf-8") if body is not None else None
        req = urllib.request.Request(
            url, data=data, method=method,
            headers={"Content-Type": "application/json"},
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
                f"memorychain node error {exc.code}: {payload.get('error', payload)}"
            ) from exc
        except (urllib.error.URLError, socket.timeout, ConnectionError) as exc:
            raise ConnectionError_(
                f"cannot reach memorychain node at {self.node_url}: {exc}"
            ) from exc

    def check_connection(self) -> bool:
        try:
            return self._request("GET", "/health").get("status") == "ok"
        except Exception:  # noqa: BLE001 — predicate must never raise
            return False

    # -------------------------------------------------------------- status
    def node_status(self) -> dict:
        return self._request("GET", "/memorychain/node_status")

    def network_status(self) -> dict:
        return self._request("GET", "/memorychain/network_status")

    def update_status(self, **fields) -> dict:
        return self._request("POST", "/memorychain/update_status", body=fields)

    # ------------------------------------------------------------ memories
    def add_memory(self, content: str, headers: dict | None = None,
                   tags: list[str] | str | None = None,
                   priority: str = "medium") -> dict:
        """Propose a memory to the chain (reference :158-219)."""
        if isinstance(tags, str):
            tags = [t.strip() for t in tags.split(",") if t.strip()]
        hdrs = dict(headers or {})
        hdrs.setdefault("Subject", content.splitlines()[0][:80] if content else "")
        if tags:
            hdrs["Tags"] = ",".join(tags)
        hdrs.setdefault("Priority", priority)
        memory_data = {
            "memory_id": uuid.uuid4().hex[:8],
            "headers": hdrs,
            "content": content,
            "tags": tags or [],  # chain.stats() histograms read this field
        }
        out = self._request("POST", "/memorychain/propose",
                            body={"memory_data": memory_data})
        return out.get("block", out)

    def get_chain(self) -> list[dict]:
        return self._request("GET", "/memorychain/chain").get("chain", [])

    def validate_chain(self) -> bool:
        """Use the node's verdict when present; otherwise validate the fetched
        chain locally (reference :543-576)."""
        out = self._request("GET", "/memorychain/chain")
        if "valid" in out:
            return bool(out["valid"])
        from fei_tpu_torch.memory.memorychain.chain import validate_block_dicts

        return validate_block_dicts(out.get("chain", []))

    # ------------------------------------------------- client-side search
    @staticmethod
    def _block_memory(block: dict) -> dict:
        data = block.get("memory_data") or {}
        return {
            "block_index": block.get("index"),
            "memory_id": data.get("memory_id", ""),
            "headers": data.get("headers", {}),
            "content": data.get("content", ""),
            "responsible_node": block.get("responsible_node"),
            "timestamp": block.get("timestamp"),
        }

    def search_memories(self, query: str, limit: int = 20) -> list[dict]:
        """Substring search over headers+content of the fetched chain
        (reference :273-324 — search is client-side by design)."""
        needle = query.lower()
        hits = []
        for block in self.get_chain():
            mem = self._block_memory(block)
            if not mem["memory_id"]:
                continue
            haystack = (mem["content"] + " " +
                        " ".join(str(v) for v in mem["headers"].values())).lower()
            if needle in haystack:
                hits.append(mem)
            if len(hits) >= limit:
                break
        return hits

    def search_by_tag(self, tag: str, limit: int = 20) -> list[dict]:
        tag = tag.lstrip("#").lower()
        hits = []
        for block in self.get_chain():
            mem = self._block_memory(block)
            tags = [t.strip().lower()
                    for t in str(mem["headers"].get("Tags", "")).split(",")]
            if tag in tags:
                hits.append(mem)
            if len(hits) >= limit:
                break
        return hits

    def get_memory(self, memory_id: str) -> dict | None:
        for block in self.get_chain():
            mem = self._block_memory(block)
            if mem["memory_id"] == memory_id:
                return mem
        return None

    def get_chain_stats(self) -> dict:
        """Node-side stats when available, else the same-shaped histograms
        computed from the fetched chain (reference :396-447). Both paths
        return {length, tags, tasks, responsible, valid}."""
        try:
            return self._request("GET", "/memorychain/stats")
        except MemoryError_:
            pass
        chain = self.get_chain()
        tags: dict[str, int] = {}
        states: dict[str, int] = {}
        nodes: dict[str, int] = {}
        for block in chain[1:]:  # skip genesis, as chain.stats() does
            for t in (block.get("memory_data") or {}).get("tags", []):
                tags[t] = tags.get(t, 0) + 1
            if block.get("is_task"):
                state = block.get("task_state", "")
                states[state] = states.get(state, 0) + 1
            rn = block.get("responsible_node")
            if rn:
                nodes[rn] = nodes.get(rn, 0) + 1
        from fei_tpu_torch.memory.memorychain.chain import validate_block_dicts

        return {
            "length": len(chain),
            "tags": tags,
            "tasks": states,
            "responsible": nodes,
            "valid": validate_block_dicts(chain),
        }

    # ----------------------------------------------------- #mem references
    @staticmethod
    def extract_references(text: str) -> list[str]:
        return MEM_REF_RE.findall(text or "")

    def resolve_references(self, text: str) -> dict[str, dict | None]:
        refs = self.extract_references(text)
        if not refs:
            return {}
        by_id = {}  # one chain fetch for all references
        for block in self.get_chain():
            mem = self._block_memory(block)
            if mem["memory_id"]:
                by_id[mem["memory_id"]] = mem
        return {mid: by_id.get(mid) for mid in refs}

    # ---------------------------------------------------------------- tasks
    def propose_task(self, description: str, difficulty: int = 1,
                     metadata: dict | None = None) -> dict:
        out = self._request("POST", "/memorychain/propose_task", body={
            "description": description, "difficulty": difficulty,
            "metadata": metadata or {},
        })
        return out.get("block", out)

    def list_tasks(self, state: str | None = None) -> list[dict]:
        params = {"state": state} if state else None
        return self._request("GET", "/memorychain/tasks",
                             params=params).get("tasks", [])

    def get_task(self, task_id: str) -> dict:
        return self._request("GET", f"/memorychain/tasks/{task_id}").get("task", {})

    def claim_task(self, task_id: str, node_id: str | None = None) -> bool:
        out = self._request("POST", "/memorychain/claim_task",
                            body={"task_id": task_id, "node_id": node_id})
        return bool(out.get("claimed"))

    def submit_solution(self, task_id: str, solution: str,
                        node_id: str | None = None) -> dict:
        out = self._request("POST", "/memorychain/submit_solution", body={
            "task_id": task_id, "solution": solution, "node_id": node_id,
        })
        return out.get("solution", out)

    def vote_solution(self, task_id: str, solution_id: str, approve: bool,
                      voter: str | None = None) -> str:
        out = self._request("POST", "/memorychain/vote_solution", body={
            "task_id": task_id, "solution_id": solution_id,
            "approve": approve, "voter": voter,
        })
        return out.get("task_state", "")

    def vote_difficulty(self, task_id: str, difficulty: int,
                        voter: str | None = None) -> dict:
        return self._request("POST", "/memorychain/vote_difficulty", body={
            "task_id": task_id, "difficulty": difficulty, "voter": voter,
        })

    # --------------------------------------------------------------- wallet
    def wallet_balance(self, node_id: str) -> float:
        quoted = urllib.parse.quote(node_id, safe="")
        return float(self._request(
            "GET", f"/memorychain/wallet/{quoted}").get("balance", 0.0))

    def wallet_transactions(self, node_id: str) -> list[dict]:
        quoted = urllib.parse.quote(node_id, safe="")
        return self._request(
            "GET", f"/memorychain/wallet/{quoted}/transactions"
        ).get("transactions", [])


def add_memory_from_conversation(
    connector: MemorychainConnector,
    messages: list[dict],
    tags: list[str] | None = None,
    max_chars: int = 4000,
) -> dict:
    """Condense a conversation into one chain memory
    (reference memorychain_connector.py:592-643)."""
    lines = []
    for msg in messages:
        role = msg.get("role", "user")
        content = msg.get("content", "")
        if isinstance(content, list):  # anthropic-style content blocks
            content = " ".join(
                b.get("text", "") for b in content if isinstance(b, dict)
            )
        if content:
            lines.append(f"{role}: {content}")
    body = "\n".join(lines)[:max_chars]
    subject = next((ln for ln in lines if ln.startswith("user:")), lines[0] if lines else "conversation")
    return connector.add_memory(
        body,
        headers={"Subject": subject[:80], "Source": "conversation"},
        tags=(tags or []) + ["conversation"],
    )
