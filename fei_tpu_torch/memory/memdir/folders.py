"""Folder manager: hierarchy operations + per-folder statistics.

Behavior parity with the reference's memdir_tools/folders.py:45-784 —
create/rename/delete/move/copy folders (special folders protected), stats
(counts per status/flag/tag, newest/oldest), bulk tagging.

A copy of ``fei_tpu/memory/memdir/folders.py`` that imports only the port.
"""

from __future__ import annotations

import os
import shutil

from fei_tpu_torch.memory.memdir.store import (
    SPECIAL_FOLDERS,
    STATUS_DIRS,
    MemdirStore,
)
from fei_tpu_torch.utils.errors import MemoryError_
from fei_tpu_torch.utils.logging import get_logger

log = get_logger("memory.folders")


def _only_store_symlinks(path: str, store_base: str) -> bool:
    """True if ``path`` is a directory tree containing nothing but symlinks
    that point INTO ``store_base`` (plus empty directories) — i.e.
    scaffolding this module built and may safely replace. A real file, or a
    user's own symlink farm (targets elsewhere), makes it untouchable."""
    base = os.path.realpath(store_base)
    for dirpath, dirnames, filenames in os.walk(path):
        for fn in filenames:
            p = os.path.join(dirpath, fn)
            if not os.path.islink(p):
                return False
            if os.path.commonpath([base, os.path.realpath(p)]) != base:
                return False
        for d in list(dirnames):
            p = os.path.join(dirpath, d)
            if os.path.islink(p):
                dirnames.remove(d)  # don't descend through links
                if os.path.commonpath([base, os.path.realpath(p)]) != base:
                    return False
    return True


class MemdirFolderManager:
    def __init__(self, store: MemdirStore | None = None):
        self.store = store or MemdirStore()

    @staticmethod
    def _normalize(name: str) -> str:
        """Non-special folders get the leading dot the reference applies
        (folders.py:55)."""
        name = name.strip("/")
        if not name:
            return name
        head = name.split("/")[0]
        if not head.startswith("."):
            name = "." + name
        return name

    def create_folder(self, name: str) -> str:
        name = self._normalize(name)
        if not name:
            raise MemoryError_("folder name required")
        self.store.ensure_folder(name)
        return name

    def delete_folder(self, name: str, force: bool = False) -> bool:
        name = self._normalize(name)
        if name in SPECIAL_FOLDERS:
            raise MemoryError_(f"cannot delete special folder {name}")
        path = self.store.folder_path(name)
        if not os.path.isdir(path):
            return False
        # include every nested subfolder: rmtree would destroy their
        # memories too, so they all get rescued into .Trash
        affected = [name] + [
            f for f in self.store.list_folders() if f.startswith(name + "/")
        ]
        contents = [
            (fld, mem)
            for fld in affected
            for status in ("new", "cur")
            for mem in self.store.list(fld, status)
        ]
        if contents and not force:
            raise MemoryError_(
                f"folder {name} holds {len(contents)} memories "
                f"(incl. subfolders); use force"
            )
        for fld, mem in contents:  # preserve memories through forced deletes
            self.store.move(mem.id, ".Trash", fld)
        shutil.rmtree(path)
        return True

    def rename_folder(self, old: str, new: str) -> str:
        old, new = self._normalize(old), self._normalize(new)
        if old in SPECIAL_FOLDERS:
            raise MemoryError_(f"cannot rename special folder {old}")
        src, dst = self.store.folder_path(old), self.store.folder_path(new)
        if not os.path.isdir(src):
            raise MemoryError_(f"no such folder {old}")
        if os.path.exists(dst):
            raise MemoryError_(f"target exists: {new}")
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        os.rename(src, dst)
        return new

    def move_folder(self, name: str, new_parent: str) -> str:
        name = self._normalize(name)
        base = os.path.basename(name)
        return self.rename_folder(
            name, f"{self._normalize(new_parent)}/{base}" if new_parent else base
        )

    def copy_folder(self, src: str, dst: str) -> int:
        src, dst = self._normalize(src), self._normalize(dst)
        self.store.ensure_folder(dst)
        n = 0
        for status in ("new", "cur"):
            for mem in self.store.list(src, status, with_content=True):
                self.store.save(mem.content, dict(mem.headers),
                                folder=dst, flags=mem.flags)
                n += 1
        return n

    def bulk_tag_folder(self, name: str, tags: list[str]) -> int:
        name = self._normalize(name) if name else name
        n = 0
        for status in ("new", "cur"):
            for mem in self.store.list(name, status, with_content=True):
                merged = ",".join(dict.fromkeys(mem.tags + list(tags)))
                self.store.rewrite_headers(mem.id, {"Tags": merged}, name)
                n += 1
        return n

    def list_folders(self) -> list[str]:
        return self.store.list_folders()

    def make_symlinks(self, target_dir: str | None = None) -> list[str]:
        """Friendly (dot-less) symlinks to every folder, for shell/file-
        manager navigation of the Maildir tree (parity: reference
        memdir_tools/folders.py:382). Nested folders become nested link
        directories; stale links are replaced, real files never touched.
        Returns the created/refreshed link paths."""
        target = os.path.abspath(
            target_dir or os.path.join(self.store.base, "links")
        )
        os.makedirs(target, exist_ok=True)
        created: list[str] = []
        folders = [f for f in self.store.list_folders() if f]
        folder_set = set(folders)
        for folder in folders:
            # skip the links dir itself (when placed inside the store base,
            # it would otherwise self-reference)
            if os.path.abspath(
                self.store.folder_path(folder)
            ).startswith(target + os.sep):
                continue
            # a subfolder whose ancestor is also linked is reachable
            # through the ancestor's symlink; linking it separately would
            # resolve through that symlink into the real store and fail
            # the non-symlink guard
            parts = folder.split("/")
            if any("/".join(parts[:i]) in folder_set for i in range(1, len(parts))):
                continue
            friendly = "/".join(
                part.lstrip(".") or part for part in folder.split("/")
            )
            link = os.path.join(target, friendly)
            src = self.store.folder_path(folder)
            os.makedirs(os.path.dirname(link), exist_ok=True)
            if os.path.islink(link):
                if os.readlink(link) == src:
                    created.append(link)
                    continue
                os.unlink(link)
            elif os.path.isdir(link) and _only_store_symlinks(
                link, self.store.base
            ):
                # a previous run (before this folder existed) built a real
                # directory here to hold nested links; it contains only
                # store-pointing symlinks, so replacing it with the folder's
                # own link loses nothing (children stay reachable through it)
                shutil.rmtree(link)
            elif os.path.exists(link):
                raise MemoryError_(
                    f"refusing to replace non-symlink {link!r} with a link"
                )
            os.symlink(src, link)
            created.append(link)
        return created

    def get_folder_stats(self, name: str = "") -> dict:
        name = self._normalize(name) if name else name
        stats: dict = {
            "folder": name or "(root)",
            "by_status": {},
            "by_flag": {f: 0 for f in "SRFP"},
            "by_tag": {},
            "total": 0,
            "newest": None,
            "oldest": None,
        }
        for status in STATUS_DIRS:
            mems = self.store.list(name, status)
            stats["by_status"][status] = len(mems)
            stats["total"] += len(mems)
            for mem in mems:
                for f in mem.flags:
                    if f in stats["by_flag"]:
                        stats["by_flag"][f] += 1
                for t in mem.tags:
                    stats["by_tag"][t] = stats["by_tag"].get(t, 0) + 1
                if stats["newest"] is None or mem.timestamp > stats["newest"]:
                    stats["newest"] = mem.timestamp
                if stats["oldest"] is None or mem.timestamp < stats["oldest"]:
                    stats["oldest"] = mem.timestamp
        return stats
