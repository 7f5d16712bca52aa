"""Agent-facing memory tools bridging the tool registry to Memdir (+chain).

Capability parity with the reference (fei/tools/memory_tools.py:23-812): the
8 registered tools — memory_search / memory_create / memory_view /
memory_list / memory_delete / memory_search_by_tag plus server start/stop
(+status) — each a JSON-schema definition and a handler over a
MemdirConnector, and the ``MemoryManager`` that fans a query out over both
stores (Memdir + Memorychain) and merges results.

Handlers return ``{"error": ...}`` payloads instead of raising, matching the
registry's contract that tool failures go back into the conversation
(reference fei/tools/registry.py:290-297).

A copy of ``fei_tpu/tools/memory_tools.py`` that imports only the port.
"""

from __future__ import annotations

from fei_tpu_torch.tools.memdir_connector import MemdirConnector
from fei_tpu_torch.tools.memorychain_connector import MemorychainConnector
from fei_tpu_torch.utils.errors import MemoryError_
from fei_tpu_torch.utils.logging import get_logger

log = get_logger("tools.memory")

# --------------------------------------------------------------- definitions

MEMORY_SEARCH = {
    "name": "memory_search",
    "description": (
        "Search stored memories with the Memdir query language. Supports plain "
        "keywords (OR across subject+content), #tag filters, field:value, "
        "field>value with relative dates (now-7d), /regex/, sort:field, "
        "limit:N, and with_content. Example: '#python sort:date limit:5'."
    ),
    "input_schema": {
        "type": "object",
        "properties": {
            "query": {"type": "string", "description": "Query string"},
            "folder": {"type": "string", "description": "Restrict to one folder"},
            "with_content": {"type": "boolean", "description": "Include memory bodies"},
            "limit": {"type": "integer", "description": "Max results"},
        },
        "required": ["query"],
    },
}

MEMORY_CREATE = {
    "name": "memory_create",
    "description": (
        "Store a new memory. Provide the content, an optional subject, "
        "comma-separated tags, target folder, and flags (S=seen, R=replied, "
        "F=flagged, P=priority)."
    ),
    "input_schema": {
        "type": "object",
        "properties": {
            "content": {"type": "string", "description": "Memory body text"},
            "subject": {"type": "string", "description": "One-line subject"},
            "tags": {"type": "string", "description": "Comma-separated tags"},
            "folder": {"type": "string", "description": "Target folder ('' = inbox)"},
            "flags": {"type": "string", "description": "Flag string, e.g. 'F' or 'FP'"},
        },
        "required": ["content"],
    },
}

MEMORY_VIEW = {
    "name": "memory_view",
    "description": "View one memory (headers + full content) by its 8-hex id.",
    "input_schema": {
        "type": "object",
        "properties": {
            "memory_id": {"type": "string", "description": "Memory id (8 hex chars)"},
            "folder": {"type": "string", "description": "Folder hint"},
        },
        "required": ["memory_id"],
    },
}

MEMORY_LIST = {
    "name": "memory_list",
    "description": "List memories in a folder (default inbox) by status (new/cur).",
    "input_schema": {
        "type": "object",
        "properties": {
            "folder": {"type": "string", "description": "Folder ('' = inbox)"},
            "status": {"type": "string", "enum": ["new", "cur", "tmp"]},
            "with_content": {"type": "boolean"},
        },
    },
}

MEMORY_DELETE = {
    "name": "memory_delete",
    "description": (
        "Delete a memory by id. By default moves it to .Trash; set hard=true "
        "to remove permanently."
    ),
    "input_schema": {
        "type": "object",
        "properties": {
            "memory_id": {"type": "string"},
            "hard": {"type": "boolean", "description": "Permanently delete"},
        },
        "required": ["memory_id"],
    },
}

MEMORY_SEARCH_BY_TAG = {
    "name": "memory_search_by_tag",
    "description": "Find all memories carrying a tag (with or without leading #).",
    "input_schema": {
        "type": "object",
        "properties": {
            "tag": {"type": "string", "description": "Tag to match"},
            "limit": {"type": "integer"},
        },
        "required": ["tag"],
    },
}

MEMORY_SERVER_START = {
    "name": "memory_server_start",
    "description": "Start the Memdir memory server if it is not already running.",
    "input_schema": {"type": "object", "properties": {}},
}

MEMORY_SERVER_STOP = {
    "name": "memory_server_stop",
    "description": "Stop the Memdir memory server started by this session.",
    "input_schema": {"type": "object", "properties": {}},
}

MEMORY_SERVER_STATUS = {
    "name": "memory_server_status",
    "description": "Report whether the Memdir memory server is reachable.",
    "input_schema": {"type": "object", "properties": {}},
}

MEMORY_TOOL_DEFINITIONS = [
    MEMORY_SEARCH,
    MEMORY_CREATE,
    MEMORY_VIEW,
    MEMORY_LIST,
    MEMORY_DELETE,
    MEMORY_SEARCH_BY_TAG,
    MEMORY_SERVER_START,
    MEMORY_SERVER_STOP,
    MEMORY_SERVER_STATUS,
]


# ------------------------------------------------------------------ handlers


class MemoryToolHandlers:
    """Handlers bound to one MemdirConnector (reference memory_tools.py:146-524)."""

    def __init__(self, connector: MemdirConnector | None = None):
        self.connector = connector or MemdirConnector(auto_start=True)

    def _guard(self, fn, *args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except MemoryError_ as exc:
            return {"error": str(exc)}

    def memory_search(self, query: str, folder: str | None = None,
                      with_content: bool = False, limit: int | None = None) -> dict:
        return self._guard(self.connector.search, query, folder=folder,
                           with_content=with_content, limit=limit)

    def memory_create(self, content: str, subject: str | None = None,
                      tags: str | None = None, folder: str = "",
                      flags: str = "") -> dict:
        headers = {"Subject": subject} if subject else None
        out = self._guard(self.connector.create_memory, content,
                          headers=headers, folder=folder, flags=flags, tags=tags)
        if "error" in out:
            return out
        return {"created": out.get("id"), "folder": out.get("folder", folder)}

    def memory_view(self, memory_id: str, folder: str | None = None) -> dict:
        out = self._guard(self.connector.get_memory, memory_id, folder)
        if isinstance(out, dict) and not out.get("error") and not out:
            return {"error": f"memory {memory_id} not found"}
        return out

    def memory_list(self, folder: str = "", status: str = "new",
                    with_content: bool = False) -> dict:
        out = self._guard(self.connector.list_memories, folder, status, with_content)
        if isinstance(out, dict) and "error" in out:
            return out
        return {"memories": out, "count": len(out)}

    def memory_delete(self, memory_id: str, hard: bool = False) -> dict:
        out = self._guard(self.connector.delete_memory, memory_id, hard)
        if isinstance(out, dict) and "error" in out:
            return out
        return {"deleted": bool(out), "memory_id": memory_id, "hard": hard}

    def memory_search_by_tag(self, tag: str, limit: int | None = None) -> dict:
        # rewrite to a #tag query (reference memory_tools.py:447-458)
        tag = tag.lstrip("#")
        return self.memory_search(f"#{tag}", limit=limit)

    def memory_server_start(self) -> dict:
        if self.connector.check_connection():
            return {"running": True, "already": True}
        ok = self.connector.start_server()
        return {"running": ok}

    def memory_server_stop(self) -> dict:
        return {"stopped": self.connector.stop_server()}

    def memory_server_status(self) -> dict:
        return self.connector.server_status()


def create_memory_tools(registry, connector: MemdirConnector | None = None) -> list[str]:
    """Register the memory tool suite on ``registry``; returns the names
    (reference memory_tools.py:526-610)."""
    handlers = MemoryToolHandlers(connector)
    names = []
    for definition in MEMORY_TOOL_DEFINITIONS:
        registry.register(definition, getattr(handlers, definition["name"]))
        names.append(definition["name"])
    return names


# ------------------------------------------------------------ MemoryManager


class MemoryManager:
    """Unified view over both stores: Memdir (file store) + Memorychain
    (distributed ledger), with per-store error isolation
    (reference memory_tools.py:613-812)."""

    def __init__(self, memdir: MemdirConnector | None = None,
                 chain: MemorychainConnector | None = None):
        self.memdir = memdir or MemdirConnector(auto_start=True)
        self.chain = chain or MemorychainConnector()

    def search_all(self, query: str, limit: int = 20) -> dict:
        """Fan the query out to both stores; failures surface per-store."""
        results: dict = {"memdir": [], "memorychain": [], "errors": {}}
        try:
            results["memdir"] = self.memdir.search(
                query, with_content=True, limit=limit
            )["results"]
        except MemoryError_ as exc:
            results["errors"]["memdir"] = str(exc)
        try:
            results["memorychain"] = self.chain.search_memories(query, limit=limit)
        except MemoryError_ as exc:
            results["errors"]["memorychain"] = str(exc)
        results["count"] = len(results["memdir"]) + len(results["memorychain"])
        return results

    def save(self, content: str, tags: list[str] | str | None = None,
             replicate: bool = False, **headers) -> dict:
        """Save to Memdir; optionally also propose to the chain."""
        out: dict = {}
        mem = self.memdir.create_memory(
            content, headers=headers or None, tags=tags
        )
        out["memdir"] = mem.get("id")
        if replicate:
            try:
                block = self.chain.add_memory(content, headers=headers, tags=tags)
                out["memorychain"] = block.get("memory_id") or block.get(
                    "memory_data", {}
                ).get("memory_id")
            except MemoryError_ as exc:
                out["memorychain_error"] = str(exc)
        return out

    def status(self) -> dict:
        return {
            "memdir": self.memdir.check_connection(),
            "memorychain": self.chain.check_connection(),
        }
