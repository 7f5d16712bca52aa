"""Repository mapper: symbol extraction, cross-file dependency graph, ranked
token-budgeted map (capability parity: fei/tools/repomap.py:31-711).

Design differences from the reference: Python files use ``ast`` (exact), other
languages use regex definition patterns; tree-sitter is optional and not
required. Ranking is the reference's scheme (incoming + 0.5·outgoing symbol
references) which approximates PageRank at far lower cost.

A copy of ``fei_tpu/tools/repomap.py`` that imports only the port.
"""

from __future__ import annotations

import ast
import os
import re
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from fei_tpu_torch.utils.logging import get_logger

log = get_logger("tools.repomap")

LANGUAGE_EXTENSIONS = {
    ".py": "python",
    ".js": "javascript",
    ".jsx": "javascript",
    ".ts": "typescript",
    ".tsx": "typescript",
    ".go": "go",
    ".rs": "rust",
    ".java": "java",
    ".c": "c",
    ".h": "c",
    ".cc": "cpp",
    ".cpp": "cpp",
    ".hpp": "cpp",
    ".rb": "ruby",
    ".sh": "shell",
}

# definition-extraction regexes for non-Python languages
DEF_PATTERNS = {
    "javascript": r"^\s*(?:export\s+)?(?:async\s+)?(?:function\s+(\w+)|class\s+(\w+)|const\s+(\w+)\s*=\s*(?:async\s*)?\()",
    "typescript": r"^\s*(?:export\s+)?(?:async\s+)?(?:function\s+(\w+)|class\s+(\w+)|interface\s+(\w+)|type\s+(\w+)\s*=|const\s+(\w+)\s*=\s*(?:async\s*)?\()",
    "go": r"^\s*func\s+(?:\([^)]*\)\s*)?(\w+)|^\s*type\s+(\w+)",
    "rust": r"^\s*(?:pub\s+)?(?:fn|struct|enum|trait)\s+(\w+)",
    "java": r"^\s*(?:public|private|protected)?\s*(?:static\s+)?(?:class|interface|enum)\s+(\w+)",
    "c": r"^\w[\w\s\*]*\b(\w+)\s*\([^;]*$",
    "cpp": r"^\s*(?:class|struct)\s+(\w+)|^\w[\w\s\*:<>,]*\b(\w+)\s*\([^;]*$",
    "ruby": r"^\s*(?:def|class|module)\s+(\w+)",
    "shell": r"^\s*(?:function\s+)?(\w+)\s*\(\)",
}

DEFAULT_EXCLUDES = [
    ".git", "__pycache__", "node_modules", ".venv", "venv", "build", "dist",
    ".fei_backups", ".pytest_cache", ".mypy_cache", "*.egg-info",
]


@dataclass
class FileSymbols:
    path: str
    language: str
    symbols: list[str] = field(default_factory=list)
    loc: int = 0


def _extract_python(path: str, source: str) -> list[str]:
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return []
    syms = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            syms.append(node.name)
        elif isinstance(node, ast.ClassDef):
            syms.append(node.name)
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    syms.append(f"{node.name}.{sub.name}")
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id.isupper():
                    syms.append(tgt.id)
    return syms


def _extract_regex(language: str, source: str) -> list[str]:
    rx = re.compile(DEF_PATTERNS.get(language, r"$^"), re.MULTILINE)
    syms = []
    for m in rx.finditer(source):
        for g in m.groups():
            if g:
                syms.append(g)
                break
    return syms


def _scan_file(path: str) -> FileSymbols | None:
    ext = os.path.splitext(path)[1]
    language = LANGUAGE_EXTENSIONS.get(ext)
    if language is None:
        return None
    try:
        if os.path.getsize(path) > 2 * 1024 * 1024:
            return None
        with open(path, "r", encoding="utf-8", errors="replace") as fh:
            source = fh.read()
    except OSError:
        return None
    if language == "python":
        syms = _extract_python(path, source)
    else:
        syms = _extract_regex(language, source)
    return FileSymbols(path, language, syms, source.count("\n") + 1)


class RepoMapper:
    """Walk → extract symbols (parallel) → reference graph → rank → render."""

    def __init__(self, root: str, exclude: list[str] | None = None):
        self.root = os.path.realpath(root)
        self.exclude = list(DEFAULT_EXCLUDES) + list(exclude or [])

    def _walk(self) -> list[str]:
        import fnmatch

        out = []
        for dirpath, dirnames, filenames in os.walk(self.root):
            dirnames[:] = [
                d for d in dirnames
                if not any(fnmatch.fnmatch(d, pat) for pat in self.exclude)
            ]
            for fn in filenames:
                if any(fnmatch.fnmatch(fn, pat) for pat in self.exclude):
                    continue
                if os.path.splitext(fn)[1] in LANGUAGE_EXTENSIONS:
                    out.append(os.path.join(dirpath, fn))
        return sorted(out)

    def scan(self) -> list[FileSymbols]:
        files = self._walk()
        results: list[FileSymbols] = []
        with ThreadPoolExecutor(max_workers=min(8, max(1, os.cpu_count() or 4))) as pool:
            for fs in pool.map(_scan_file, files):
                if fs is not None and fs.symbols:
                    results.append(fs)
        return results

    def dependency_graph(self, scanned: list[FileSymbols]) -> dict[str, dict[str, list[str]]]:
        """edges[src][dst] = symbols defined in dst that src references."""
        # symbol → defining files (skip very short/common names)
        defs: dict[str, list[str]] = {}
        for fs in scanned:
            for sym in fs.symbols:
                base = sym.split(".")[-1]
                if len(base) < 3:
                    continue
                defs.setdefault(base, []).append(fs.path)
        sources: dict[str, str] = {}
        for fs in scanned:
            try:
                with open(fs.path, "r", encoding="utf-8", errors="replace") as fh:
                    sources[fs.path] = fh.read()
            except OSError:
                sources[fs.path] = ""
        edges: dict[str, dict[str, list[str]]] = {}
        for fs in scanned:
            src_text = sources[fs.path]
            own = set(s.split(".")[-1] for s in fs.symbols)
            for sym, defined_in in defs.items():
                if sym in own:
                    continue
                if re.search(rf"\b{re.escape(sym)}\b", src_text):
                    for dst in defined_in:
                        if dst != fs.path:
                            edges.setdefault(fs.path, {}).setdefault(dst, []).append(sym)
        return edges

    def rank(self, scanned: list[FileSymbols],
             edges: dict[str, dict[str, list[str]]]) -> dict[str, float]:
        incoming: dict[str, int] = {fs.path: 0 for fs in scanned}
        outgoing: dict[str, int] = {fs.path: 0 for fs in scanned}
        for src, dsts in edges.items():
            outgoing[src] = outgoing.get(src, 0) + len(dsts)
            for dst in dsts:
                incoming[dst] = incoming.get(dst, 0) + 1
        return {p: incoming.get(p, 0) + 0.5 * outgoing.get(p, 0) for p in incoming}

    def generate_map(self, token_budget: int = 1024) -> dict:
        scanned = self.scan()
        edges = self.dependency_graph(scanned)
        ranks = self.rank(scanned, edges)
        ordered = sorted(scanned, key=lambda fs: -ranks.get(fs.path, 0.0))
        lines: list[str] = []
        used = 0
        shown = 0
        for fs in ordered:
            rel = os.path.relpath(fs.path, self.root)
            chunk = [f"{rel}  (rank {ranks.get(fs.path, 0):.1f}, {fs.loc} loc)"]
            for sym in fs.symbols[:24]:
                chunk.append(f"  {sym}")
            cost = sum(_token_estimate(ln) for ln in chunk)
            if used + cost > token_budget and shown > 0:
                break
            lines.extend(chunk)
            used += cost
            shown += 1
        return {
            "root": self.root,
            "map": "\n".join(lines),
            "files_total": len(scanned),
            "files_shown": shown,
            "token_estimate": used,
        }

    def generate_json(self) -> dict:
        scanned = self.scan()
        edges = self.dependency_graph(scanned)
        ranks = self.rank(scanned, edges)
        return {
            "root": self.root,
            "files": [
                {
                    "path": os.path.relpath(fs.path, self.root),
                    "language": fs.language,
                    "symbols": fs.symbols,
                    "loc": fs.loc,
                    "rank": ranks.get(fs.path, 0.0),
                }
                for fs in scanned
            ],
            "edges": [
                {
                    "from": os.path.relpath(src, self.root),
                    "to": os.path.relpath(dst, self.root),
                    "symbols": sorted(set(syms)),
                }
                for src, dsts in edges.items()
                for dst, syms in dsts.items()
            ],
        }


def _token_estimate(text: str) -> int:
    return max(1, int(len(text.split()) * 1.3))


def generate_repo_map(path: str, token_budget: int = 1024,
                      exclude: list[str] | None = None) -> dict:
    return RepoMapper(path, exclude=exclude).generate_map(token_budget)


def generate_repo_summary(path: str) -> dict:
    mapper = RepoMapper(path)
    scanned = mapper.scan()
    modules: dict[str, dict] = {}
    for fs in scanned:
        rel = os.path.relpath(fs.path, mapper.root)
        mod = rel.split(os.sep)[0] if os.sep in rel else "."
        entry = modules.setdefault(
            mod, {"files": 0, "loc": 0, "languages": set(), "top_symbols": []}
        )
        entry["files"] += 1
        entry["loc"] += fs.loc
        entry["languages"].add(fs.language)
        entry["top_symbols"].extend(fs.symbols[:3])
    return {
        "root": mapper.root,
        "modules": {
            mod: {
                "files": e["files"],
                "loc": e["loc"],
                "languages": sorted(e["languages"]),
                "top_symbols": e["top_symbols"][:12],
            }
            for mod, e in sorted(modules.items())
        },
    }


def generate_repo_dependencies(path: str, file: str | None = None) -> dict:
    mapper = RepoMapper(path)
    data = mapper.generate_json()
    edges = data["edges"]
    if file:
        rel = os.path.relpath(os.path.realpath(file), mapper.root)
        edges = [e for e in edges if e["from"] == rel or e["to"] == rel]
    return {"root": data["root"], "edges": edges, "count": len(edges)}
