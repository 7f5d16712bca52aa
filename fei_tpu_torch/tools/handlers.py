"""Handlers mapping each tool definition to its implementation, plus
``create_code_tools(registry)`` which registers all 14 local tools
(parity: fei/tools/handlers.py:49-590, code.py:1727-1866).

A copy of ``fei_tpu/tools/handlers.py`` that imports only the port.
"""

from __future__ import annotations

import os
import re
from concurrent.futures import ThreadPoolExecutor

from fei_tpu_torch.tools import code as _code
from fei_tpu_torch.tools import definitions as defs
from fei_tpu_torch.utils.logging import get_logger

log = get_logger("tools.handlers")


def glob_tool_handler(pattern: str, path: str | None = None) -> dict:
    files = _code.glob_finder.find(pattern, path)
    return {"pattern": pattern, "files": files, "count": len(files)}


def grep_tool_handler(pattern: str, path: str | None = None, include: str | None = None) -> dict:
    matches = _code.grep_tool.search(pattern, path, include)
    return {
        "pattern": pattern,
        "matches": [
            {"file": m.file, "line_number": m.line_number, "line": m.line} for m in matches
        ],
        "count": len(matches),
    }


def view_handler(file_path: str, offset: int = 0, limit: int | None = None) -> dict:
    return _code.file_viewer.view(file_path, offset=offset, limit=limit)


def edit_handler(file_path: str, old_string: str, new_string: str) -> dict:
    return _code.code_editor.edit_file(file_path, old_string, new_string)


def replace_handler(file_path: str, content: str) -> dict:
    return _code.code_editor.replace_file(file_path, content)


def ls_handler(path: str, ignore: list[str] | None = None) -> dict:
    return _code.directory_explorer.list_directory(path, ignore=ignore)


def regex_edit_handler(
    file_path: str, pattern: str, replacement: str, validate: bool = True
) -> dict:
    return _code.code_editor.regex_replace(file_path, pattern, replacement, validate)


def batch_glob_handler(patterns: list[str], path: str | None = None) -> dict:
    results: dict[str, list[str]] = {}
    with ThreadPoolExecutor(max_workers=min(5, max(1, len(patterns)))) as pool:
        futures = {pool.submit(_code.glob_finder.find, p, path): p for p in patterns}
        for fut, pat in futures.items():
            try:
                results[pat] = fut.result()
            except Exception as exc:  # noqa: BLE001
                results[pat] = []
                log.warning("batch glob %s failed: %s", pat, exc)
    return {"results": results, "total": sum(len(v) for v in results.values())}


def find_in_files_handler(files: list[str], pattern: str) -> dict:
    rx = re.compile(pattern)
    by_file: dict[str, list[dict]] = {}
    for f in files:
        matches = _code.grep_tool._search_file(f, rx, 1000)
        if matches:
            by_file[f] = [{"line_number": m.line_number, "line": m.line} for m in matches]
    return {"pattern": pattern, "files": by_file, "count": sum(len(v) for v in by_file.values())}


# language hint → (globs, definition-pattern template)
_LANGUAGE_MAP = {
    "python": ("*.py", r"(def|class)\s+{sym}\b"),
    "javascript": ("*.{js,jsx}", r"(function\s+{sym}\b|const\s+{sym}\s*=|class\s+{sym}\b)"),
    "typescript": ("*.{ts,tsx}", r"(function\s+{sym}\b|const\s+{sym}\s*=|class\s+{sym}\b|interface\s+{sym}\b)"),
    "go": ("*.go", r"func\s+(\([^)]*\)\s*)?{sym}\b|type\s+{sym}\b"),
    "rust": ("*.rs", r"(fn|struct|enum|trait)\s+{sym}\b"),
    "java": ("*.java", r"(class|interface|enum)\s+{sym}\b|\w+\s+{sym}\s*\("),
    "c": ("*.{c,h}", r"\b{sym}\s*\("),
    "cpp": ("*.{cc,cpp,cxx,h,hpp}", r"\b{sym}\s*\(|class\s+{sym}\b"),
    "ruby": ("*.rb", r"(def|class|module)\s+{sym}\b"),
    "shell": ("*.sh", r"{sym}\s*\(\)"),
}


def smart_search_handler(query: str, context: str | None = None) -> dict:
    """Parse 'function foo in python'-style queries into glob+regex searches."""
    q = query.strip()
    language = None
    for lang in _LANGUAGE_MAP:
        if re.search(rf"\bin\s+{lang}\b|\b{lang}\b", q, re.IGNORECASE):
            language = lang
            q = re.sub(rf"\bin\s+{lang}\b|\b{lang}\b", "", q, flags=re.IGNORECASE).strip()
            break
    kind = None
    m = re.match(r"^(function|class|method|def|symbol|variable)\s+(.*)$", q, re.IGNORECASE)
    if m:
        kind, q = m.group(1).lower(), m.group(2).strip()
    symbol = re.split(r"\s+", q)[0] if q else ""
    if not symbol:
        return {"query": query, "matches": [], "count": 0, "note": "no symbol in query"}
    include, pat_tpl = _LANGUAGE_MAP.get(language, ("*", r"\b{sym}\b"))
    pattern = pat_tpl.format(sym=re.escape(symbol))
    matches = _code.grep_tool.search(pattern, include=include, max_results=200)
    return {
        "query": query,
        "language": language,
        "kind": kind,
        "symbol": symbol,
        "matches": [
            {"file": m.file, "line_number": m.line_number, "line": m.line} for m in matches
        ],
        "count": len(matches),
    }


def repo_map_handler(path: str | None = None, token_budget: int = 1024,
                     exclude: list[str] | None = None) -> dict:
    from fei_tpu_torch.tools.repomap import generate_repo_map

    return generate_repo_map(path or os.getcwd(), token_budget=token_budget, exclude=exclude)


def repo_summary_handler(path: str | None = None) -> dict:
    from fei_tpu_torch.tools.repomap import generate_repo_summary

    return generate_repo_summary(path or os.getcwd())


def repo_deps_handler(path: str | None = None, file: str | None = None) -> dict:
    from fei_tpu_torch.tools.repomap import generate_repo_dependencies

    return generate_repo_dependencies(path or os.getcwd(), file=file)


def shell_handler(command: str, timeout: int = 60, background: bool = False,
                  cwd: str | None = None) -> dict:
    return _code.shell_runner.run(command, timeout=timeout, background=background, cwd=cwd)


_HANDLERS = {
    "GlobTool": glob_tool_handler,
    "GrepTool": grep_tool_handler,
    "View": view_handler,
    "Edit": edit_handler,
    "Replace": replace_handler,
    "LS": ls_handler,
    "RegexEdit": regex_edit_handler,
    "BatchGlob": batch_glob_handler,
    "FindInFiles": find_in_files_handler,
    "SmartSearch": smart_search_handler,
    "RepoMap": repo_map_handler,
    "RepoSummary": repo_summary_handler,
    "RepoDependencies": repo_deps_handler,
    "Shell": shell_handler,
}


def create_code_tools(registry) -> list[str]:
    """Register all local code tools on ``registry``; returns the names."""
    names = []
    for definition in defs.TOOL_DEFINITIONS:
        handler = _HANDLERS[definition["name"]]
        registry.register(definition, handler)
        names.append(definition["name"])
    return names
