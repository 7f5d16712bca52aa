"""memdir CLI: create/list/view/move/search/flag/mkdir/filters/maintenance.

Parity with the reference's memdir_tools/cli.py:69-270 and
memdir_tools/__main__.py:11-90 command routing.

A copy of ``fei_tpu/memory/memdir/cli.py`` that imports only the port.
"""

from __future__ import annotations

import argparse
import json
import sys

from fei_tpu_torch.memory.memdir.archiver import MemoryArchiver
from fei_tpu_torch.memory.memdir.filters import FilterManager
from fei_tpu_torch.memory.memdir.folders import MemdirFolderManager
from fei_tpu_torch.memory.memdir.search import (
    format_results,
    parse_search_args,
    search_memories,
)
from fei_tpu_torch.memory.memdir.store import MemdirStore
from fei_tpu_torch.utils.errors import MemoryError_


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="memdir", description="Memdir memory store")
    p.add_argument("--base", default=None, help="Memdir base directory")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("create", help="save a new memory")
    c.add_argument("content")
    c.add_argument("--folder", default="")
    c.add_argument("--tags", default="")
    c.add_argument("--flags", default="")
    c.add_argument("--subject", default=None)

    ls = sub.add_parser("list", help="list memories")
    ls.add_argument("--folder", default="")
    ls.add_argument("--status", default="new", choices=["new", "cur", "tmp"])
    ls.add_argument("--format", default="text",
                    choices=["text", "json", "csv", "compact"])

    v = sub.add_parser("view", help="view one memory")
    v.add_argument("memory_id")

    mv = sub.add_parser("move", help="move a memory")
    mv.add_argument("memory_id")
    mv.add_argument("target_folder")

    s = sub.add_parser("search", help="search with the query language")
    s.add_argument("query", nargs="+")
    s.add_argument("--format", default="text",
                   choices=["text", "json", "csv", "compact"])

    f = sub.add_parser("flag", help="set flags on a memory")
    f.add_argument("memory_id")
    f.add_argument("flags", help="e.g. SF (Seen+Flagged); empty string clears")

    mk = sub.add_parser("mkdir", help="create a folder")
    mk.add_argument("name")

    fl = sub.add_parser("folders", help="list folders with stats")

    rf = sub.add_parser("run-filters", help="apply filters to new/ memories")
    rf.add_argument("--folder", default="")

    mt = sub.add_parser("maintenance", help="archive/trash/status maintenance")

    args = p.parse_args(argv)
    store = MemdirStore(args.base)
    try:
        return _dispatch(args, store)
    except MemoryError_ as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1


def _dispatch(args, store: MemdirStore) -> int:
    if args.cmd == "create":
        headers = {}
        if args.subject:
            headers["Subject"] = args.subject
        tags = [t for t in args.tags.split(",") if t.strip()]
        mem = store.save(args.content, headers=headers, folder=args.folder,
                         flags=args.flags, tags=tags)
        print(f"created {mem.id} in {mem.folder or '(root)'}/new")
    elif args.cmd == "list":
        mems = store.list(args.folder, args.status, with_content=True)
        print(format_results(mems, args.format))
    elif args.cmd == "view":
        mem = store.get(args.memory_id)
        if mem is None:
            print(f"not found: {args.memory_id}", file=sys.stderr)
            return 1
        print(format_results([mem], "text", with_content=True))
        store.mark_seen(mem.id, mem.folder)
    elif args.cmd == "move":
        mem = store.move(args.memory_id, args.target_folder)
        print(f"moved {mem.id} to {mem.folder}/{mem.status}")
    elif args.cmd == "search":
        q = parse_search_args(" ".join(args.query))
        mems = search_memories(store, q)
        print(format_results(mems, args.format, q.with_content))
    elif args.cmd == "flag":
        mem = store.update_flags(args.memory_id, args.flags)
        print(f"{mem.id} flags: {mem.flags or '(none)'}")
    elif args.cmd == "mkdir":
        name = MemdirFolderManager(store).create_folder(args.name)
        print(f"created folder {name}")
    elif args.cmd == "folders":
        mgr = MemdirFolderManager(store)
        for name in mgr.list_folders():
            stats = mgr.get_folder_stats(name)
            print(f"{name or '(root)':30s} total={stats['total']} "
                  f"new={stats['by_status'].get('new', 0)} "
                  f"cur={stats['by_status'].get('cur', 0)}")
    elif args.cmd == "run-filters":
        stats = FilterManager(store).process_memories(args.folder)
        print(json.dumps(stats, indent=2))
    elif args.cmd == "maintenance":
        stats = MemoryArchiver(store).run_maintenance()
        print(json.dumps(stats, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
