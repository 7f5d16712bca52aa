"""The Maildir-style storage engine.

Behavior parity with the reference's memdir_tools/utils.py:16-387: folder
layout ``<base>/<folder>/{tmp,new,cur}``, filename format
``<timestamp>.<uid8>.<hostname>:2,<FLAGS>``, header/body files separated by
``---``, atomic delivery (tmp → rename → new), status promotion new→cur,
flag updates via rename. Differences by design: everything is a method of
``MemdirStore`` (the reference uses module-level functions against a global
base path), and header parsing is a single shared codec.

A copy of ``fei_tpu/memory/memdir/store.py`` that imports only the port.
"""

from __future__ import annotations

import os
import re
import socket
import threading
import time
import uuid
from dataclasses import dataclass, field

from fei_tpu_torch.utils.errors import MemoryError_
from fei_tpu_torch.utils.logging import get_logger

log = get_logger("memory.memdir")

STANDARD_FOLDERS = [""]  # root folder; others are created on demand
SPECIAL_FOLDERS = [".Trash", ".ToDoLater", ".Projects", ".Archive"]
STATUS_DIRS = ("tmp", "new", "cur")

# flags: S=Seen, R=Replied, F=Flagged, P=Priority (reference utils.py:25-30)
FLAGS = {"S": "Seen", "R": "Replied", "F": "Flagged", "P": "Priority"}

_FILENAME_RX = re.compile(
    r"^(?P<ts>\d+(?:\.\d+)?)\.(?P<uid>[0-9a-f]{8})\.(?P<host>[^:]+):2,(?P<flags>[A-Z]*)$"
)


@dataclass
class Memory:
    """A parsed memory: identity, location, metadata, content."""

    id: str  # the uid component — stable across moves/flag changes
    filename: str
    folder: str
    status: str
    timestamp: float
    hostname: str
    flags: str
    headers: dict[str, str] = field(default_factory=dict)
    content: str = ""

    @property
    def tags(self) -> list[str]:
        raw = self.headers.get("Tags", "")
        return [t.strip() for t in raw.split(",") if t.strip()]

    def to_dict(self, with_content: bool = True) -> dict:
        d = {
            "id": self.id,
            "filename": self.filename,
            "folder": self.folder,
            "status": self.status,
            "timestamp": self.timestamp,
            "flags": self.flags,
            "headers": dict(self.headers),
            "tags": self.tags,
        }
        if with_content:
            d["content"] = self.content
        return d


def generate_filename(flags: str = "", timestamp: float | None = None,
                      hostname: str | None = None) -> str:
    ts = timestamp if timestamp is not None else time.time()
    uid = uuid.uuid4().hex[:8]
    host = (hostname or socket.gethostname()).replace(":", "_").replace("/", "_")
    return f"{int(ts)}.{uid}.{host}:2,{''.join(sorted(set(flags)))}"


def parse_filename(name: str) -> dict | None:
    m = _FILENAME_RX.match(name)
    if not m:
        return None
    return {
        "timestamp": float(m.group("ts")),
        "id": m.group("uid"),
        "hostname": m.group("host"),
        "flags": m.group("flags"),
    }


def render_memory_file(headers: dict[str, str], content: str) -> str:
    head = "\n".join(f"{k}: {v}" for k, v in headers.items())
    return f"{head}\n---\n{content}"


def parse_memory_file(raw: str) -> tuple[dict[str, str], str]:
    headers: dict[str, str] = {}
    if "\n---\n" in raw:
        head, _, body = raw.partition("\n---\n")
    elif raw.startswith("---\n"):
        head, body = "", raw[4:]
    else:
        head, body = "", raw
    for line in head.splitlines():
        key, sep, val = line.partition(":")
        if sep:
            headers[key.strip()] = val.strip()
    return headers, body


class MemdirStore:
    """All Memdir operations against one base directory."""

    def __init__(self, base: str | None = None):
        self.base = os.path.abspath(
            base or os.environ.get("MEMDIR_BASE", "./Memdir")
        )
        self._lock = threading.Lock()

    # -- layout --------------------------------------------------------------

    def folder_path(self, folder: str = "") -> str:
        folder = folder.strip("/")
        if folder in ("", "."):
            return self.base
        if ".." in folder.split("/"):
            raise MemoryError_(f"invalid folder name: {folder!r}")
        return os.path.join(self.base, folder)

    def ensure_folder(self, folder: str = "") -> str:
        path = self.folder_path(folder)
        for status in STATUS_DIRS:
            os.makedirs(os.path.join(path, status), exist_ok=True)
        return path

    def list_folders(self) -> list[str]:
        out = [""]
        if not os.path.isdir(self.base):
            return out
        for dirpath, dirnames, _ in os.walk(self.base):
            rel = os.path.relpath(dirpath, self.base)
            dirnames[:] = [d for d in dirnames if d not in STATUS_DIRS]
            if rel != "." and self._is_folder(dirpath):
                out.append(rel.replace(os.sep, "/"))
        return sorted(out)

    @staticmethod
    def _is_folder(path: str) -> bool:
        return all(os.path.isdir(os.path.join(path, s)) for s in STATUS_DIRS)

    # -- write path ----------------------------------------------------------

    def save(
        self,
        content: str,
        headers: dict[str, str] | None = None,
        folder: str = "",
        flags: str = "",
        tags: list[str] | None = None,
    ) -> Memory:
        """Atomic delivery: write to tmp/, rename into new/
        (reference utils.py:192-198)."""
        headers = dict(headers or {})
        headers.setdefault("Date", time.strftime("%a, %d %b %Y %H:%M:%S %z"))
        headers.setdefault("Subject", (content.strip().splitlines() or [""])[0][:80])
        if tags:
            existing = [t.strip() for t in headers.get("Tags", "").split(",") if t.strip()]
            headers["Tags"] = ",".join(dict.fromkeys(existing + list(tags)))
        path = self.ensure_folder(folder)
        name = generate_filename(flags)
        tmp_path = os.path.join(path, "tmp", name)
        with open(tmp_path, "w", encoding="utf-8") as fh:
            fh.write(render_memory_file(headers, content))
        os.rename(tmp_path, os.path.join(path, "new", name))
        meta = parse_filename(name)
        return Memory(
            id=meta["id"], filename=name, folder=folder, status="new",
            timestamp=meta["timestamp"], hostname=meta["hostname"],
            flags=meta["flags"], headers=headers, content=content,
        )

    # -- read path -----------------------------------------------------------

    def list(self, folder: str = "", status: str = "new",
             with_content: bool = False) -> list[Memory]:
        if status not in STATUS_DIRS:
            raise MemoryError_(f"invalid status {status!r}")
        sdir = os.path.join(self.folder_path(folder), status)
        out: list[Memory] = []
        if not os.path.isdir(sdir):
            return out
        for name in sorted(os.listdir(sdir)):
            mem = self._read(folder, status, name, with_content)
            if mem is not None:
                out.append(mem)
        return out

    def _read(self, folder: str, status: str, name: str,
              with_content: bool = True) -> Memory | None:
        meta = parse_filename(name)
        if meta is None:
            return None
        fp = os.path.join(self.folder_path(folder), status, name)
        headers: dict[str, str] = {}
        content = ""
        try:
            with open(fp, "r", encoding="utf-8", errors="replace") as fh:
                headers, content = parse_memory_file(fh.read())
        except OSError:
            return None
        return Memory(
            id=meta["id"], filename=name, folder=folder, status=status,
            timestamp=meta["timestamp"], hostname=meta["hostname"],
            flags=meta["flags"], headers=headers,
            content=content if with_content else "",
        )

    def get(self, memory_id: str, folder: str | None = None) -> Memory | None:
        """Find a memory by uid (optionally constrained to a folder)."""
        folders = [folder] if folder is not None else self.list_folders()
        for fld in folders:
            for status in STATUS_DIRS:
                sdir = os.path.join(self.folder_path(fld), status)
                if not os.path.isdir(sdir):
                    continue
                for name in os.listdir(sdir):
                    meta = parse_filename(name)
                    if meta and meta["id"] == memory_id:
                        return self._read(fld, status, name)
        return None

    # -- mutation ------------------------------------------------------------

    def move(
        self,
        memory_id: str,
        target_folder: str,
        source_folder: str | None = None,
        target_status: str = "cur",
        flags: str | None = None,
    ) -> Memory:
        """Move across folders/statuses, optionally rewriting flags — a pure
        rename, content untouched (reference utils.py:255-297)."""
        mem = self.get(memory_id, source_folder)
        if mem is None:
            raise MemoryError_(f"memory not found: {memory_id}")
        if target_status not in STATUS_DIRS:
            raise MemoryError_(f"invalid status {target_status!r}")
        new_flags = mem.flags if flags is None else "".join(sorted(set(flags)))
        base, _, _ = mem.filename.partition(":")
        new_name = f"{base}:2,{new_flags}"
        src = os.path.join(self.folder_path(mem.folder), mem.status, mem.filename)
        self.ensure_folder(target_folder)
        dst = os.path.join(self.folder_path(target_folder), target_status, new_name)
        with self._lock:
            os.rename(src, dst)
        mem.folder, mem.status = target_folder, target_status
        mem.filename, mem.flags = new_name, new_flags
        return mem

    def update_flags(self, memory_id: str, flags: str,
                     folder: str | None = None) -> Memory:
        mem = self.get(memory_id, folder)
        if mem is None:
            raise MemoryError_(f"memory not found: {memory_id}")
        return self.move(mem.id, mem.folder, mem.folder, mem.status, flags)

    def mark_seen(self, memory_id: str, folder: str | None = None) -> Memory:
        """Promote new→cur adding the S flag (Maildir read semantics)."""
        mem = self.get(memory_id, folder)
        if mem is None:
            raise MemoryError_(f"memory not found: {memory_id}")
        flags = mem.flags if "S" in mem.flags else mem.flags + "S"
        return self.move(mem.id, mem.folder, mem.folder, "cur", flags)

    def delete(self, memory_id: str, folder: str | None = None,
               hard: bool = False) -> bool:
        """Soft delete moves to .Trash (server semantics, reference
        server.py:218-238); hard delete unlinks."""
        mem = self.get(memory_id, folder)
        if mem is None:
            return False
        if hard:
            os.remove(
                os.path.join(self.folder_path(mem.folder), mem.status, mem.filename)
            )
            return True
        self.move(mem.id, ".Trash", mem.folder)
        return True

    def rewrite_headers(self, memory_id: str, updates: dict[str, str],
                        folder: str | None = None) -> Memory:
        """Rewrite headers in place (used by the archiver's status rules)."""
        mem = self.get(memory_id, folder)
        if mem is None:
            raise MemoryError_(f"memory not found: {memory_id}")
        mem.headers.update(updates)
        fp = os.path.join(self.folder_path(mem.folder), mem.status, mem.filename)
        tmp = fp + ".rewrite"
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(render_memory_file(mem.headers, mem.content))
        os.replace(tmp, fp)
        return mem

    # -- naive search (the query language lives in search.py) ----------------

    def search_text(self, needle: str, folders: list[str] | None = None,
                    statuses: tuple[str, ...] = ("new", "cur")) -> list[Memory]:
        needle_l = needle.lower()
        out = []
        for folder in folders if folders is not None else self.list_folders():
            for status in statuses:
                for mem in self.list(folder, status, with_content=True):
                    hay = (mem.headers.get("Subject", "") + "\n" + mem.content).lower()
                    if needle_l in hay:
                        out.append(mem)
        return out
