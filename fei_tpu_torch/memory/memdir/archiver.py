"""Archiver: lifecycle maintenance over the store.

Behavior parity with the reference's memdir_tools/archiver.py:45-640 —
age/tag-based archiving into ``.Archive/<year>``, cleanup rules, trash
expiry, retention caps with importance scoring, and content-driven Status
header rewriting.

A copy of ``fei_tpu/memory/memdir/archiver.py`` that imports only the port.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field

from fei_tpu_torch.memory.memdir.store import Memory, MemdirStore
from fei_tpu_torch.utils.logging import get_logger

log = get_logger("memory.archiver")

DEFAULT_ARCHIVE_DAYS = 90
DEFAULT_TRASH_DAYS = 30


@dataclass
class Rule:
    name: str
    max_age_days: float | None = None
    tags: list[str] = field(default_factory=list)
    headers: dict[str, str] = field(default_factory=dict)  # header → regex
    flags: str = ""  # every listed flag must be present
    action: str = "archive"  # archive|trash|delete

    def matches(self, mem: Memory, now: float) -> bool:
        if self.max_age_days is not None:
            if now - mem.timestamp < self.max_age_days * 86400:
                return False
        if self.tags and not any(t.lower() in (x.lower() for x in mem.tags)
                                 for t in self.tags):
            return False
        for header, pattern in self.headers.items():
            try:
                if not re.search(pattern, mem.headers.get(header, ""), re.IGNORECASE):
                    return False
            except re.error:
                return False
        return all(f in mem.flags for f in self.flags)


class MemoryArchiver:
    def __init__(
        self,
        store: MemdirStore,
        archive_days: float = DEFAULT_ARCHIVE_DAYS,
        trash_days: float = DEFAULT_TRASH_DAYS,
    ):
        self.store = store
        self.archive_days = archive_days
        self.trash_days = trash_days
        self.rules: list[Rule] = []

    def add_rule(self, rule: Rule) -> None:
        self.rules.append(rule)

    @staticmethod
    def _archive_folder(mem: Memory) -> str:
        year = time.localtime(mem.timestamp).tm_year
        return f".Archive/{year}"

    def _working_folders(self) -> list[str]:
        return [f for f in self.store.list_folders()
                if not f.startswith((".Archive", ".Trash"))]

    def archive_old_memories(self, now: float | None = None) -> dict:
        """Default age rule + custom rules over non-archive folders."""
        now = now or time.time()
        stats = {"archived": 0, "trashed": 0, "deleted": 0}
        for folder in self._working_folders():
            for status in ("new", "cur"):
                for mem in self.store.list(folder, status, with_content=True):
                    action = None
                    for rule in self.rules:
                        if rule.matches(mem, now):
                            action = rule.action
                            break
                    if action is None and now - mem.timestamp > self.archive_days * 86400:
                        action = "archive"
                    if action == "archive":
                        self.store.move(mem.id, self._archive_folder(mem), folder)
                        stats["archived"] += 1
                    elif action == "trash":
                        self.store.move(mem.id, ".Trash", folder)
                        stats["trashed"] += 1
                    elif action == "delete":
                        self.store.delete(mem.id, folder, hard=True)
                        stats["deleted"] += 1
        return stats

    def empty_trash(self, now: float | None = None) -> int:
        """Hard-delete trash that has BEEN IN TRASH for trash_days. The move
        into .Trash is a rename, which bumps the inode ctime — expiring on
        ctime (not the creation timestamp in the filename) gives old
        memories the same grace period as fresh ones."""
        import os as _os

        now = now or time.time()
        removed = 0
        for status in ("new", "cur"):
            for mem in self.store.list(".Trash", status):
                fp = _os.path.join(
                    self.store.folder_path(".Trash"), status, mem.filename
                )
                try:
                    trashed_at = _os.stat(fp).st_ctime
                except OSError:
                    continue
                if now - trashed_at > self.trash_days * 86400:
                    if self.store.delete(mem.id, ".Trash", hard=True):
                        removed += 1
        return removed

    @staticmethod
    def importance(mem: Memory) -> float:
        """Eviction score: flags and tags buy retention
        (reference archiver.py:465-486)."""
        score = 0.0
        if "F" in mem.flags:
            score += 2.0
        if "P" in mem.flags:
            score += 3.0
        if "R" in mem.flags:
            score += 1.0
        score += 0.5 * len(mem.tags)
        return score

    def apply_retention(self, folder: str = "", max_memories: int = 1000) -> int:
        """Cap a folder's population; evict lowest importance, oldest first."""
        mems = (self.store.list(folder, "cur", with_content=True)
                + self.store.list(folder, "new", with_content=True))
        excess = len(mems) - max_memories
        if excess <= 0:
            return 0
        mems.sort(key=lambda m: (self.importance(m), m.timestamp))
        for mem in mems[:excess]:
            self.store.move(mem.id, ".Trash", folder)
        return excess

    STATUS_RULES = [
        (r"\[x\]|\bcompleted\b|\bdone\b", "completed"),
        (r"\bin.progress\b|\bworking on\b", "in-progress"),
        (r"\btodo\b|\[ \]", "todo"),
    ]

    def update_statuses(self, dormant_days: float = 60.0,
                        now: float | None = None) -> int:
        """Content-regex → Status header; unseen+old → dormant
        (reference archiver.py:517-619)."""
        now = now or time.time()
        updated = 0
        for folder in self._working_folders():
            for status in ("new", "cur"):
                for mem in self.store.list(folder, status, with_content=True):
                    new_status = None
                    for pattern, value in self.STATUS_RULES:
                        if re.search(pattern, mem.content, re.IGNORECASE):
                            new_status = value
                            break
                    if (new_status is None
                            and "S" not in mem.flags and "R" not in mem.flags
                            and now - mem.timestamp > dormant_days * 86400):
                        new_status = "dormant"
                    if new_status and mem.headers.get("Status") != new_status:
                        self.store.rewrite_headers(
                            mem.id, {"Status": new_status}, mem.folder
                        )
                        updated += 1
        return updated

    def run_maintenance(self) -> dict:
        stats = self.archive_old_memories()
        stats["trash_emptied"] = self.empty_trash()
        stats["statuses_updated"] = self.update_statuses()
        return stats
