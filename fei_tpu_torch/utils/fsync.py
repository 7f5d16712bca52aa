"""Durable writes: fsync a file, and the directory whose entry a rename,
create or unlink changed (shared by checkpoints, drain snapshots and the
session journal)."""

from __future__ import annotations

import os


def fsync_file(path: str) -> None:
    """fsync an already-written file by path. tmp-write + ``os.replace``
    alone survives a process crash but NOT a host power cut: the rename
    can hit the disk before the data blocks do, leaving a torn or empty
    file behind a durable name."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(directory: str) -> None:
    """fsync a directory so a rename/create/unlink inside it is durable
    (the directory entry itself lives in the parent's data blocks).
    Best-effort on platforms whose directories reject O_RDONLY fsync."""
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
