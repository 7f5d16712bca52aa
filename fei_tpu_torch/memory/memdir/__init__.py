"""Memdir: Maildir-semantics memory store.

Layout: ``<base>/<folder>/{tmp,new,cur}``; a memory is one file whose name
encodes timestamp, unique id, hostname and flags, and whose content is
``Key: value`` headers, a ``---`` separator, then the body. Delivery is
atomic (write to tmp/, rename into new/) — the reference's core invariant
(memdir_tools/utils.py:153-200).

A copy of ``fei_tpu/memory/memdir/__init__.py`` that imports only the port.
"""

from fei_tpu_torch.memory.memdir.store import (
    FLAGS,
    SPECIAL_FOLDERS,
    STANDARD_FOLDERS,
    MemdirStore,
)
from fei_tpu_torch.memory.memdir.search import SearchQuery, parse_search_args, search_memories

__all__ = [
    "FLAGS",
    "MemdirStore",
    "SPECIAL_FOLDERS",
    "STANDARD_FOLDERS",
    "SearchQuery",
    "parse_search_args",
    "search_memories",
]
