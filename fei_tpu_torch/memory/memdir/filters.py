"""Filter engine: email-style rules applied to newly-delivered memories.

Behavior parity with the reference's memdir_tools/filter.py:20-359 — each
rule is regex conditions over headers/content plus actions (move to folder,
add flags, copy, tag), run against everything in ``new/``; plus the
reference's six default rules (filter.py:263-309).

A copy of ``fei_tpu/memory/memdir/filters.py`` that imports only the port.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from fei_tpu_torch.memory.memdir.store import Memory, MemdirStore
from fei_tpu_torch.utils.logging import get_logger

log = get_logger("memory.filters")


@dataclass
class MemoryFilter:
    name: str
    conditions: dict[str, str]  # field → regex (field: Subject/content/Tags/…)
    actions: dict[str, object] = field(default_factory=dict)
    # actions: {"move": folder} | {"flag": "FP"} | {"copy": folder} | {"tag": [..]}

    def matches(self, mem: Memory) -> bool:
        for fld, pattern in self.conditions.items():
            if fld.lower() == "content":
                hay = mem.content
            elif fld.lower() == "tags":
                hay = ",".join(mem.tags)
            else:
                hay = mem.headers.get(fld, "")
            try:
                if not re.search(pattern, hay, re.IGNORECASE):
                    return False
            except re.error:
                return False
        return True

    def apply(self, store: MemdirStore, mem: Memory) -> list[str]:
        applied: list[str] = []
        if self.actions.get("copy"):
            target = str(self.actions["copy"])
            store.save(mem.content, dict(mem.headers), folder=target, flags=mem.flags)
            applied.append(f"copy:{target}")
        if self.actions.get("tag"):
            tags = list(self.actions["tag"])  # type: ignore[arg-type]
            merged = ",".join(dict.fromkeys(mem.tags + tags))
            store.rewrite_headers(mem.id, {"Tags": merged}, mem.folder)
            mem.headers["Tags"] = merged
            applied.append(f"tag:{','.join(tags)}")
        if self.actions.get("flag"):
            flags = "".join(sorted(set(mem.flags + str(self.actions["flag"]))))
            mem = store.update_flags(mem.id, flags, mem.folder)
            applied.append(f"flag:{flags}")
        if self.actions.get("move"):
            target = str(self.actions["move"])
            mem = store.move(mem.id, target, mem.folder, target_status="cur")
            applied.append(f"move:{target}")
        return applied


def create_default_filters() -> list[MemoryFilter]:
    """The reference's default routing rules (filter.py:263-309)."""
    return [
        MemoryFilter("python-routing", {"content": r"\bpython\b"},
                     {"tag": ["python"], "move": ".Projects/Python"}),
        MemoryFilter("ai-routing", {"content": r"\b(AI|machine learning|neural)\b"},
                     {"tag": ["ai"], "move": ".Projects/AI"}),
        MemoryFilter("learning-routing", {"Subject": r"\b(learn|tutorial|course)\b"},
                     {"tag": ["learning"]}),
        MemoryFilter("priority-flagging", {"Subject": r"\b(urgent|important|critical)\b"},
                     {"flag": "FP"}),
        MemoryFilter("completed-archive", {"content": r"\[x\]|\bcompleted\b"},
                     {"move": ".Archive"}),
        MemoryFilter("trash-tagged", {"Tags": r"\btrash\b"},
                     {"move": ".Trash"}),
    ]


class FilterManager:
    def __init__(self, store: MemdirStore,
                 filters: list[MemoryFilter] | None = None):
        self.store = store
        self.filters = filters if filters is not None else create_default_filters()

    def process_memories(self, folder: str = "") -> dict:
        """Run all filters over ``new/`` in ``folder``; non-matching memories
        are promoted to cur (standard Maildir processing)."""
        stats = {"processed": 0, "matched": 0, "actions": []}
        for mem in self.store.list(folder, "new", with_content=True):
            stats["processed"] += 1
            acted = False
            moved_away = False
            for filt in self.filters:
                if filt.matches(mem):
                    try:
                        actions = filt.apply(self.store, mem)
                    except Exception as exc:  # noqa: BLE001
                        log.warning("filter %s failed on %s: %s",
                                    filt.name, mem.id, exc)
                        continue
                    stats["actions"].append(
                        {"filter": filt.name, "memory": mem.id, "applied": actions}
                    )
                    acted = True
                    if filt.actions.get("move"):
                        moved_away = True
                        break  # moved away: later filters don't apply
                    # folder-constrained refresh — an unconstrained get()
                    # walks the whole store per memory (O(n^2) I/O)
                    mem = self.store.get(mem.id, folder) or mem
            if acted:
                stats["matched"] += 1
            if not moved_away:
                current = self.store.get(mem.id, folder)
                if current is not None and current.status == "new":
                    self.store.move(mem.id, folder, folder, "cur")
        return stats


def run_filters(store: MemdirStore | None = None, folder: str = "") -> dict:
    return FilterManager(store or MemdirStore()).process_memories(folder)
