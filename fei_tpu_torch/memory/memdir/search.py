"""Memdir search: query language + evaluator.

Behavior parity with the reference's memdir_tools/search.py:21-594 —
query strings combine free keywords (OR across Subject+content), ``#tag``,
``+F`` flag filters, ``field:value`` / ``=`` / ``!=`` / ``<`` / ``>``
conditions (with relative dates ``now-7d``), ``/regex/`` content matching,
``sort:<field>``, ``limit:<n>`` and ``with_content`` directives.

A copy of ``fei_tpu/memory/memdir/search.py`` that imports only the port.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field as dfield
from typing import Any

from fei_tpu_torch.memory.memdir.store import Memory, MemdirStore

_REL_DATE_RX = re.compile(r"^now([+-])(\d+)([dwmyhM])$")
_UNIT_SECONDS = {
    "h": 3600, "d": 86400, "w": 7 * 86400, "m": 30 * 86400,
    "M": 60, "y": 365 * 86400,
}


def _resolve_date(value: str) -> float | None:
    """'now-7d' → epoch seconds; also accepts raw epoch numbers."""
    value = value.strip()
    if value == "now":
        return time.time()
    m = _REL_DATE_RX.match(value)
    if m:
        sign = 1 if m.group(1) == "+" else -1
        return time.time() + sign * int(m.group(2)) * _UNIT_SECONDS[m.group(3)]
    try:
        return float(value)
    except ValueError:
        return None


@dataclass
class Condition:
    field: str
    op: str  # contains|equals|not_equals|lt|gt|regex|has_tag|has_flag|keyword
    value: Any


@dataclass
class SearchQuery:
    conditions: list[Condition] = dfield(default_factory=list)
    keywords: list[str] = dfield(default_factory=list)
    sort_by: str = "date"
    reverse: bool = True
    limit: int | None = None
    offset: int = 0
    with_content: bool = False

    def add(self, field: str, op: str, value: Any) -> "SearchQuery":
        self.conditions.append(Condition(field, op, value))
        return self


def _field_value(mem: Memory, field: str) -> Any:
    """Special fields content/flags/date/id/folder/status/subject/tags; any
    other name reads the header of that name (reference search.py:97-139)."""
    f = field.lower()
    if f == "content":
        return mem.content
    if f == "flags":
        return mem.flags
    if f in ("date", "timestamp"):
        return mem.timestamp
    if f == "id":
        return mem.id
    if f == "folder":
        return mem.folder
    if f == "status":
        return mem.status
    if f == "subject":
        return mem.headers.get("Subject", "")
    if f == "tags":
        return ",".join(mem.tags)
    for k, v in mem.headers.items():
        if k.lower() == f:
            return v
    return ""


def _matches(mem: Memory, cond: Condition) -> bool:
    val = _field_value(mem, cond.field)
    if cond.op == "has_tag":
        return str(cond.value).lower() in (t.lower() for t in mem.tags)
    if cond.op == "has_flag":
        return str(cond.value) in mem.flags
    if cond.op == "regex":
        try:
            return re.search(cond.value, str(val), re.IGNORECASE) is not None
        except re.error:
            return False
    if cond.op in ("lt", "gt"):
        if cond.field.lower() in ("date", "timestamp"):
            target = _resolve_date(str(cond.value))
            if target is None:
                return False
            return (val < target) if cond.op == "lt" else (val > target)
        try:
            fv, tv = float(val), float(cond.value)
            return (fv < tv) if cond.op == "lt" else (fv > tv)
        except (TypeError, ValueError):
            sv, tv = str(val), str(cond.value)
            return (sv < tv) if cond.op == "lt" else (sv > tv)
    sval, scond = str(val).lower(), str(cond.value).lower()
    if cond.op == "equals":
        return sval == scond
    if cond.op == "not_equals":
        return sval != scond
    if cond.op == "startswith":
        return sval.startswith(scond)
    if cond.op == "endswith":
        return sval.endswith(scond)
    return scond in sval  # contains (default)


def _memory_matches(mem: Memory, q: SearchQuery) -> bool:
    # keywords are OR across Subject+content; conditions are AND
    # (reference search.py:244-331)
    if q.keywords:
        hay = (mem.headers.get("Subject", "") + "\n" + mem.content).lower()
        if not any(k.lower() in hay for k in q.keywords):
            return False
    return all(_matches(mem, c) for c in q.conditions)


def search_memories(
    store: MemdirStore,
    query: SearchQuery,
    folders: list[str] | None = None,
    statuses: tuple[str, ...] = ("new", "cur"),
) -> list[Memory]:
    results: list[Memory] = []
    for folder in folders if folders is not None else store.list_folders():
        for status in statuses:
            for mem in store.list(folder, status, with_content=True):
                if _memory_matches(mem, q=query):
                    results.append(mem)
    key = {
        "date": lambda m: m.timestamp,
        "subject": lambda m: m.headers.get("Subject", "").lower(),
        "folder": lambda m: m.folder,
        "flags": lambda m: m.flags,
    }.get(query.sort_by, lambda m: m.timestamp)
    results.sort(key=key, reverse=query.reverse)
    if query.offset:
        results = results[query.offset:]
    if query.limit is not None:
        results = results[: query.limit]
    return results


_FIELD_OP_RX = re.compile(
    r"^(?P<field>[A-Za-z_][\w-]*)(?P<op>!=|>=|<=|[:=<>])(?P<value>.*)$"
)


def parse_search_args(query_string: str) -> SearchQuery:
    """Parse the query string syntax (reference search.py:392-519):
    ``#tag``, ``+F``, ``field:value``, ``field=value``, ``field!=value``,
    ``field<v``/``field>v``, ``/regex/``, ``sort:``, ``limit:``, ``offset:``,
    ``with_content``; bare words are keywords."""
    q = SearchQuery()
    # pull /regex/ chunks out first (may contain spaces)
    def grab_regex(m: re.Match) -> str:
        q.add("content", "regex", m.group(1))
        return " "

    # a /regex/ must stand alone as a token — slashes inside field values
    # (hierarchical folders like .Projects/Python) are not delimiters
    rest = re.sub(r"(?:(?<=\s)|^)/((?:[^/\\]|\\.)+)/(?=\s|$)", grab_regex,
                  query_string)
    for tok in rest.split():
        if tok == "with_content":
            q.with_content = True
        elif tok.startswith("#"):
            q.add("tags", "has_tag", tok[1:])
        elif tok.startswith("+") and len(tok) == 2 and tok[1].isupper():
            q.add("flags", "has_flag", tok[1])
        else:
            m = _FIELD_OP_RX.match(tok)
            if m:
                fld, op, val = m.group("field"), m.group("op"), m.group("value")
                lf = fld.lower()
                if lf == "sort" and op == ":":
                    if val.startswith("-"):
                        q.sort_by, q.reverse = val[1:], True
                    else:
                        q.sort_by, q.reverse = val, False
                elif lf == "limit" and op == ":":
                    q.limit = int(val) if val.isdigit() else None
                elif lf == "offset" and op == ":":
                    q.offset = int(val) if val.isdigit() else 0
                elif op in (":",):
                    q.add(fld, "contains", val)
                elif op == "=":
                    q.add(fld, "equals", val)
                elif op == "!=":
                    q.add(fld, "not_equals", val)
                elif op in ("<", "<="):
                    q.add(fld, "lt", val)
                elif op in (">", ">="):
                    q.add(fld, "gt", val)
            else:
                q.keywords.append(tok)
    return q


def format_results(memories: list[Memory], fmt: str = "text",
                   with_content: bool = False) -> str:
    """text/json/csv/compact output (reference search.py:521-594)."""
    if fmt == "json":
        import json

        return json.dumps([m.to_dict(with_content) for m in memories], indent=2)
    if fmt == "csv":
        import csv
        import io

        buf = io.StringIO()
        w = csv.writer(buf)
        w.writerow(["id", "folder", "status", "flags", "date", "subject", "tags"])
        for m in memories:
            w.writerow([
                m.id, m.folder, m.status, m.flags,
                time.strftime("%Y-%m-%d %H:%M", time.localtime(m.timestamp)),
                m.headers.get("Subject", ""), ",".join(m.tags),
            ])
        return buf.getvalue()
    if fmt == "compact":
        return "\n".join(
            f"{m.id} [{m.flags:4s}] {m.headers.get('Subject', '')[:60]}"
            for m in memories
        )
    lines = []
    for m in memories:
        stamp = time.strftime("%Y-%m-%d %H:%M", time.localtime(m.timestamp))
        lines.append(f"id: {m.id}  folder: {m.folder or '(root)'}  "
                     f"status: {m.status}  flags: {m.flags}")
        lines.append(f"date: {stamp}  subject: {m.headers.get('Subject', '')}")
        if m.tags:
            lines.append(f"tags: {', '.join(m.tags)}")
        if with_content:
            lines.append(m.content)
        lines.append("-" * 60)
    return "\n".join(lines)
