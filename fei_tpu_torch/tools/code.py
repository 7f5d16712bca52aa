"""File/search/edit/shell machinery behind the code tools.

Capability parity with the reference's fei/tools/code.py:49-1724 (GlobFinder,
GrepTool, CodeEditor, FileViewer, DirectoryExplorer, SystemInfo, ShellRunner),
with the reference's known defects fixed:

- path-safety uses ``os.path.commonpath`` instead of the bypassable string
  prefix check (reference code.py:77-81);
- no ``shell=True`` for foreground commands unless the command needs shell
  features (pipes/redirection), and the allow/deny check runs on every
  pipeline segment, not just the first token;
- backups are atomic and pruned under a lock.

A native C++ scan engine (fei_tpu_torch.native) accelerates the grep hot
loop when built; the pure-Python path is the always-available fallback.

A copy of fei_tpu/tools/code.py whose system-info tool reports the CUDA
devices through ``torch.cuda``.
"""

from __future__ import annotations

import fnmatch
import glob as _glob
import hashlib
import os
import re
import shlex
import shutil
import signal
import stat
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor, as_completed
from dataclasses import dataclass

from fei_tpu_torch.utils.errors import ToolError
from fei_tpu_torch.utils.logging import get_logger

log = get_logger("tools.code")

MAX_FILE_SIZE = 10 * 1024 * 1024  # 10 MB read cap (parity: reference code.py:33)
MAX_OUTPUT_CHARS = 50_000  # shell output truncation (parity: reference code.py:35)
_BINARY_SNIFF = 4096


def _is_within(base: str, path: str) -> bool:
    """True if ``path`` is inside ``base`` (commonpath, not prefix-string)."""
    try:
        base = os.path.realpath(base)
        path = os.path.realpath(path)
        return os.path.commonpath([base, path]) == base
    except ValueError:  # different drives / mixed abs-rel
        return False


def _looks_binary(path: str) -> bool:
    try:
        with open(path, "rb") as fh:
            chunk = fh.read(_BINARY_SNIFF)
        return b"\0" in chunk
    except OSError:
        return True


def _expand_brace(pattern: str) -> list[str]:
    """Expand one level of {a,b} alternation (fnmatch has none)."""
    m = re.search(r"\{([^{}]*)\}", pattern)
    if not m:
        return [pattern]
    out = []
    for alt in m.group(1).split(","):
        out.extend(_expand_brace(pattern[: m.start()] + alt + pattern[m.end():]))
    return out


class GlobFinder:
    """Glob matching with a result cache and an optional base-path jail."""

    def __init__(self, base_path: str | None = None, cache_ttl: float = 60.0):
        self.base_path = os.path.realpath(base_path) if base_path else None
        self.cache_ttl = cache_ttl
        self._cache: dict[tuple[str, str], tuple[float, list[str]]] = {}
        self._lock = threading.Lock()

    def _check_path(self, path: str) -> None:
        if self.base_path and not _is_within(self.base_path, path):
            raise ToolError(f"path {path!r} escapes the allowed base {self.base_path!r}")

    def find(self, pattern: str, path: str | None = None) -> list[str]:
        root = os.path.realpath(path or os.getcwd())
        self._check_path(root)
        key = (pattern, root)
        now = time.time()
        with self._lock:
            hit = self._cache.get(key)
            if hit and now - hit[0] < self.cache_ttl:
                return list(hit[1])
        matches: list[str] = []
        for pat in _expand_brace(pattern):
            full = pat if os.path.isabs(pat) else os.path.join(root, pat)
            matches.extend(p for p in _glob.glob(full, recursive=True) if os.path.isfile(p))
        matches = sorted(set(matches), key=lambda p: -_safe_mtime(p))
        with self._lock:
            self._cache[key] = (now, matches)
        return matches


def _safe_mtime(path: str) -> float:
    try:
        return os.path.getmtime(path)
    except OSError:
        return 0.0


@dataclass
class GrepMatch:
    file: str
    line_number: int
    line: str


class GrepTool:
    """Parallel regex content search with compiled-pattern caching."""

    def __init__(self, max_workers: int = 8):
        self.max_workers = max_workers
        self._regex_cache: dict[str, re.Pattern] = {}
        self._lock = threading.Lock()

    def _compile(self, pattern: str) -> re.Pattern:
        with self._lock:
            rx = self._regex_cache.get(pattern)
            if rx is None:
                rx = re.compile(pattern)
                self._regex_cache[pattern] = rx
        return rx

    def _candidate_files(self, path: str, include: str | None) -> list[str]:
        files: list[str] = []
        skip_dirs = {".git", "__pycache__", "node_modules", ".venv", "venv", ".fei_backups"}
        inc_pats = _expand_brace(include) if include else None
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = [d for d in dirnames if d not in skip_dirs]
            for fn in filenames:
                if inc_pats and not any(fnmatch.fnmatch(fn, p) for p in inc_pats):
                    continue
                files.append(os.path.join(dirpath, fn))
        return files

    def search(
        self,
        pattern: str,
        path: str | None = None,
        include: str | None = None,
        max_results: int = 1000,
    ) -> list[GrepMatch]:
        rx = self._compile(pattern)
        root = os.path.realpath(path or os.getcwd())
        if os.path.isfile(root):
            return self._search_file(root, rx, max_results)
        files = self._candidate_files(root, include)
        # Try the native C++ scanner first (fei_tpu_torch.native, task: hot loop).
        try:
            from fei_tpu_torch.native import scan as native_scan

            raw = native_scan.grep_files(files, pattern, max_results)
            if raw is not None:
                matches = [GrepMatch(f, ln, text) for f, ln, text in raw]
                # same ordering contract as the Python path
                matches.sort(
                    key=lambda m: (-_safe_mtime(m.file), m.file, m.line_number)
                )
                return matches[:max_results]
        except Exception:  # noqa: BLE001 — native path is best-effort
            pass
        results: list[GrepMatch] = []
        with ThreadPoolExecutor(max_workers=min(self.max_workers, max(1, len(files)))) as pool:
            futures = {pool.submit(self._search_file, f, rx, max_results): f for f in files}
            for fut in as_completed(futures):
                results.extend(fut.result())
                if len(results) >= max_results:
                    for other in futures:
                        other.cancel()
                    break
        results.sort(key=lambda m: (-_safe_mtime(m.file), m.file, m.line_number))
        return results[:max_results]

    def _search_file(self, path: str, rx: re.Pattern, limit: int) -> list[GrepMatch]:
        out: list[GrepMatch] = []
        try:
            if os.path.getsize(path) > MAX_FILE_SIZE or _looks_binary(path):
                return out
            with open(path, "r", encoding="utf-8", errors="replace") as fh:
                for i, line in enumerate(fh, 1):
                    if rx.search(line):
                        out.append(GrepMatch(path, i, line.rstrip("\n")))
                        if len(out) >= limit:
                            break
        except OSError:
            pass
        return out


def _check_brackets(content: str, lang: str = "js") -> str | None:
    """Comment/string-aware bracket balance for brace-family languages.

    Not a parser: it exists to reject the failure modes edits actually
    produce (truncated blocks, a deleted closing brace) while never
    rejecting valid code. ``lang``:

    - "js"    — ``'…'`` is a string; regex literals (after operators or
                regex-context keywords) are skipped; ``#field`` is code.
    - "c"     — preprocessor lines (incl. backslash continuations) are
                skipped; single quotes are short char literals only.
    - "brace" — go/java/rust: char-literal single quotes (so Rust
                lifetimes pass), no preprocessor, no regex literals.
    """
    pairs = {")": "(", "]": "[", "}": "{"}
    # '/' after these starts a regex, after a value it's division — the
    # standard JS lexer heuristic, extended with regex-context keywords
    _REGEX_PUNCT = "(=,:[!&|?{};\n<>+-*%~^"
    _REGEX_KEYWORDS = {
        "return", "typeof", "case", "in", "of", "delete", "void", "do",
        "else", "instanceof", "new", "throw", "yield", "await",
    }
    stack: list[tuple[str, int]] = []
    line = 1
    i, n = 0, len(content)
    prev_sig = "\n"  # last non-whitespace char outside comments/strings
    word = ""  # identifier/keyword accumulator ending at prev_sig
    word_dotted = False  # word is a property access (obj.in) — not a keyword
    while i < n:
        c = content[i]
        if c == "\n":
            line += 1
        elif c == "/" and i + 1 < n and content[i + 1] == "/":
            i = content.find("\n", i)
            if i < 0:
                break
            continue
        elif (
            c == "#"
            and lang == "c"  # never JS ('#field' is a class member) or rust
            and (i == 0 or content[i - 1] in "\n\t ")
        ):
            # preprocessor line: skip to EOL, following backslash
            # continuations (#define WRAP(x) do { \ ... } while (0))
            while True:
                eol = content.find("\n", i)
                if eol < 0:
                    i = n
                    break
                line += 1
                i = eol + 1
                skipped = content[content.rfind("\n", 0, eol) + 1:eol]
                if not skipped.rstrip().endswith("\\"):
                    break
            continue
        elif c == "/" and i + 1 < n and content[i + 1] == "*":
            end = content.find("*/", i + 2)
            if end < 0:
                return f"unterminated block comment starting line {line}"
            line += content.count("\n", i, end)
            i = end + 2
            continue
        elif (
            c == "/" and lang == "js"
            and (
                prev_sig in _REGEX_PUNCT
                or (word in _REGEX_KEYWORDS and not word_dotted)
            )
        ):
            # regex literal — quotes/brackets inside are not code
            j, in_class = i + 1, False
            while j < n and content[j] != "\n":
                cj = content[j]
                if cj == "\\":
                    j += 2
                    continue
                if cj == "[":
                    in_class = True
                elif cj == "]":
                    in_class = False
                elif cj == "/" and not in_class:
                    break
                j += 1
            if j < n and content[j] == "/":
                i = j + 1
                prev_sig, word = "/", ""
                continue
            # no closing '/': treat as division, fall through
        elif c == "'" and lang in ("c", "brace"):
            # consume only a genuine char literal: exactly one char ('a',
            # '{') or an escape ('\n', '\u{1F600}'). A lone quote (Rust
            # lifetime, apostrophe) is plain text — a wide window with
            # any closing quote would swallow code like <'a>(x: &'a [u8]).
            j, limit = i + 1, min(i + 12, n)
            is_escape = j < n and content[j] == "\\"
            while j < limit and content[j] != "'" and content[j] != "\n":
                j += 2 if content[j] == "\\" else 1
            if (
                j < limit and content[j] == "'"
                and (j == i + 2 or is_escape)
            ):
                i = j + 1
                continue
        elif c in ("'", '"', "`") and not (c == "'" and lang in ("c", "brace")):
            quote, start_line = c, line
            i += 1
            while i < n:
                if content[i] == "\\":
                    i += 2
                    continue
                if content[i] == "\n":
                    line += 1
                    if quote != "`":  # ordinary strings don't span lines
                        break
                if content[i] == quote:
                    break
                i += 1
            if i >= n:
                return f"unterminated string starting line {start_line}"
            i += 1
            prev_sig, word = quote, ""  # a string is a value: '/' divides
            continue
        elif c in "([{":
            stack.append((c, line))
        elif c in ")]}":
            if not stack or stack[-1][0] != pairs[c]:
                return f"unbalanced {c!r} at line {line}"
            stack.pop()
        if not c.isspace():
            if c.isalnum() or c in "_$":
                if not word:
                    word_dotted = prev_sig == "."
                word += c
            else:
                word = ""
            prev_sig = c
        i += 1
    if stack:
        ch, ln = stack[-1]
        return f"unclosed {ch!r} opened at line {ln}"
    return None


class CodeEditor:
    """Edit/create/replace files with rolling backups and syntax validation."""

    def __init__(self, backup_dir: str = ".fei_backups", max_backups: int = 10):
        self.backup_dir = backup_dir
        self.max_backups = max_backups
        self._lock = threading.Lock()

    def _backup(self, file_path: str) -> str | None:
        if not os.path.exists(file_path):
            return None
        bdir = os.path.join(os.path.dirname(os.path.abspath(file_path)), self.backup_dir)
        os.makedirs(bdir, exist_ok=True)
        stamp = time.strftime("%Y%m%d-%H%M%S") + f"-{int(time.time_ns() % 1_000_000):06d}"
        dest = os.path.join(bdir, f"{os.path.basename(file_path)}.{stamp}")
        with self._lock:
            shutil.copy2(file_path, dest)
            # prune oldest beyond max_backups for this file
            base = os.path.basename(file_path) + "."
            backups = sorted(p for p in os.listdir(bdir) if p.startswith(base))
            for old in backups[: max(0, len(backups) - self.max_backups)]:
                try:
                    os.remove(os.path.join(bdir, old))
                except OSError:
                    pass
        return dest

    @staticmethod
    def _validate_code(path: str, content: str) -> str | None:
        """Tiered post-edit validation (capability parity with the
        reference's ast→esprima→pylint/flake8 ladder at
        fei/tools/code.py:827-932, without its external-tool deps):

        - .py          — exact: stdlib ast
        - .json        — exact: json.loads
        - .yaml/.yml   — exact when PyYAML importable, else skipped
        - brace langs  — js/ts/c/c++/java/go/rust: comment/string-aware
                         bracket balance (catches the truncated-edit and
                         mismatched-block failures edits actually produce)
        - anything else— no validation (plain text is always legal)
        """
        ext = os.path.splitext(path)[1].lower()
        if ext == ".py":
            import ast

            try:
                ast.parse(content)
                return None
            except SyntaxError as exc:
                return f"python syntax error at line {exc.lineno}: {exc.msg}"
        if ext == ".json":
            import json

            try:
                json.loads(content)
                return None
            except ValueError as exc:
                return f"invalid json: {exc}"
        if ext in (".yaml", ".yml"):
            try:
                import yaml
            except ImportError:
                return None
            try:
                yaml.safe_load(content)
                return None
            except yaml.YAMLError as exc:
                return f"invalid yaml: {exc}"
        if ext in (".js", ".jsx", ".ts", ".tsx", ".mjs", ".cjs"):
            return _check_brackets(content, lang="js")
        if ext in (".c", ".h", ".cc", ".cpp", ".hpp"):
            return _check_brackets(content, lang="c")
        if ext in (".java", ".go", ".rs"):
            return _check_brackets(content, lang="brace")
        return None

    def edit_file(self, file_path: str, old_string: str, new_string: str) -> dict:
        """Unique-match replace; empty old_string creates a new file.

        Contract parity: reference fei/tools/code.py:618-668 + the uniqueness
        rule in definitions.py:81-92.
        """
        if old_string == "":
            return self.create_file(file_path, new_string)
        if not os.path.isfile(file_path):
            raise ToolError(f"file not found: {file_path}")
        with open(file_path, "r", encoding="utf-8", errors="replace") as fh:
            content = fh.read()
        count = content.count(old_string)
        if count == 0:
            raise ToolError("old_string not found in file — include exact text with context")
        if count > 1:
            raise ToolError(
                f"old_string matches {count} locations — add surrounding context to make it unique"
            )
        new_content = content.replace(old_string, new_string, 1)
        err = self._validate_code(file_path, new_content)
        if err:
            raise ToolError(f"edit rejected, result does not parse: {err}")
        backup = self._backup(file_path)
        _atomic_write(file_path, new_content)
        return {"file_path": file_path, "backup": backup, "replaced": 1}

    def create_file(self, file_path: str, content: str) -> dict:
        if os.path.exists(file_path):
            raise ToolError(f"file already exists: {file_path} (use Replace to overwrite)")
        err = self._validate_code(file_path, content)
        if err:
            raise ToolError(f"create rejected, content does not parse: {err}")
        os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)
        _atomic_write(file_path, content)
        return {"file_path": file_path, "created": True, "bytes": len(content.encode())}

    def replace_file(self, file_path: str, content: str) -> dict:
        err = self._validate_code(file_path, content)
        if err:
            raise ToolError(f"replace rejected, content does not parse: {err}")
        backup = self._backup(file_path)
        os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)
        _atomic_write(file_path, content)
        return {"file_path": file_path, "backup": backup, "bytes": len(content.encode())}

    def regex_replace(
        self, file_path: str, pattern: str, replacement: str, validate: bool = True
    ) -> dict:
        if not os.path.isfile(file_path):
            raise ToolError(f"file not found: {file_path}")
        rx = re.compile(pattern, re.MULTILINE)
        with open(file_path, "r", encoding="utf-8", errors="replace") as fh:
            content = fh.read()
        new_content, n = rx.subn(replacement, content)
        if n == 0:
            return {"file_path": file_path, "replaced": 0}
        if validate:
            err = self._validate_code(file_path, new_content)
            if err:
                raise ToolError(f"regex edit rejected, result does not parse: {err}")
        backup = self._backup(file_path)
        _atomic_write(file_path, new_content)
        return {"file_path": file_path, "backup": backup, "replaced": n}


def _atomic_write(path: str, content: str) -> None:
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(content)
    os.replace(tmp, path)


class FileViewer:
    """Read files with numbered lines, size caps, offset/limit, hashing."""

    def view(self, file_path: str, offset: int = 0, limit: int | None = None) -> dict:
        if not os.path.isfile(file_path):
            raise ToolError(f"file not found: {file_path}")
        size = os.path.getsize(file_path)
        if size > MAX_FILE_SIZE:
            raise ToolError(f"file too large ({size} bytes > {MAX_FILE_SIZE})")
        if _looks_binary(file_path):
            return {"file_path": file_path, "binary": True, "size": size}
        lines: list[str] = []
        total = 0
        with open(file_path, "r", encoding="utf-8", errors="replace") as fh:
            for i, line in enumerate(fh):
                total = i + 1
                if i < offset:
                    continue
                if limit is not None and len(lines) >= limit:
                    # keep counting total lines cheaply
                    continue
                lines.append(f"{i + 1:6d}\t{line.rstrip(chr(10))}")
        return {
            "file_path": file_path,
            "content": "\n".join(lines),
            "total_lines": total,
            "offset": offset,
            "shown": len(lines),
        }

    @staticmethod
    def count_lines(file_path: str) -> int:
        n = 0
        with open(file_path, "rb") as fh:
            for chunk in iter(lambda: fh.read(1 << 20), b""):
                n += chunk.count(b"\n")
        return n

    @staticmethod
    def file_hash(file_path: str) -> str:
        h = hashlib.sha256()
        with open(file_path, "rb") as fh:
            for chunk in iter(lambda: fh.read(1 << 20), b""):
                h.update(chunk)
        return h.hexdigest()


class DirectoryExplorer:
    """Directory listing with ignore patterns and recursive mode."""

    def list_directory(
        self,
        path: str,
        ignore: list[str] | None = None,
        recursive: bool = False,
        max_entries: int = 2000,
    ) -> dict:
        if not os.path.isdir(path):
            raise ToolError(f"not a directory: {path}")
        ignore = ignore or []

        def ignored(name: str) -> bool:
            return any(fnmatch.fnmatch(name, pat) for pat in ignore)

        entries: list[dict] = []
        if recursive:
            for dirpath, dirnames, filenames in os.walk(path):
                dirnames[:] = [d for d in dirnames if not ignored(d)]
                for name in sorted(dirnames):
                    entries.append({"path": os.path.join(dirpath, name), "type": "dir"})
                for name in sorted(filenames):
                    if ignored(name):
                        continue
                    fp = os.path.join(dirpath, name)
                    entries.append({"path": fp, "type": "file", "size": _safe_size(fp)})
                if len(entries) >= max_entries:
                    break
        else:
            for name in sorted(os.listdir(path)):
                if ignored(name):
                    continue
                fp = os.path.join(path, name)
                if os.path.isdir(fp):
                    entries.append({"path": fp, "type": "dir"})
                else:
                    entries.append({"path": fp, "type": "file", "size": _safe_size(fp)})
        truncated = len(entries) > max_entries
        return {"path": path, "entries": entries[:max_entries], "truncated": truncated}


def _safe_size(path: str) -> int:
    try:
        return os.path.getsize(path)
    except OSError:
        return 0


class SystemInfo:
    """OS / memory / disk information (psutil optional)."""

    def get_info(self) -> dict:
        import platform

        info: dict = {
            "platform": platform.platform(),
            "python": platform.python_version(),
            "cpu_count": os.cpu_count(),
            "cwd": os.getcwd(),
        }
        try:
            usage = shutil.disk_usage("/")
            info["disk"] = {"total": usage.total, "free": usage.free}
        except OSError:
            pass
        try:
            with open("/proc/meminfo") as fh:
                mem = dict(
                    (k.strip(), v.strip())
                    for k, _, v in (ln.partition(":") for ln in fh)
                )
            info["memory"] = {
                "total": mem.get("MemTotal"),
                "available": mem.get("MemAvailable"),
            }
        except OSError:
            pass
        try:
            import torch

            if torch.cuda.is_available():
                n = torch.cuda.device_count()
                info["accelerator"] = {
                    "backend": "cuda",
                    "devices": [torch.cuda.get_device_name(i) for i in range(n)],
                    "count": n,
                }
            else:
                info["accelerator"] = {"backend": "cpu", "devices": [], "count": 0}
        except Exception:  # noqa: BLE001
            pass
        return info


# Commands the agent may run. A command is allowed iff EVERY pipeline segment's
# argv[0] basename is in ALLOWED_COMMANDS and no DENIED pattern matches the
# whole line (parity: reference code.py:1352-1404, with per-segment checks).
ALLOWED_COMMANDS = {
    # inspection
    "ls", "cat", "head", "tail", "wc", "file", "stat", "du", "df", "find",
    "grep", "egrep", "fgrep", "rg", "awk", "sed", "sort", "uniq", "cut", "tr",
    "diff", "cmp", "md5sum", "sha256sum", "which", "whereis", "realpath",
    "basename", "dirname", "pwd", "echo", "printf", "env", "date", "uname",
    "xargs", "tee", "jq", "column", "nl", "strings", "od", "hexdump", "tree",
    # vcs
    "git",
    # build / test
    "python", "python3", "pip", "pytest", "make", "cmake", "ninja", "g++",
    "gcc", "cc", "ld", "ar", "nm", "objdump", "bazel", "protoc", "node",
    "npm", "npx", "tar", "gzip", "gunzip", "zip", "unzip", "touch", "mkdir",
}

DENIED_PATTERNS = [
    r"\brm\s+(-[a-zA-Z]*\s+)*/((\s|$)|\*)",  # rm at filesystem root
    r"\bdd\b.*\bof=/dev/",
    r"\bmkfs\b",
    r"\bshutdown\b|\breboot\b|\bhalt\b",
    r":\(\)\s*\{.*\};:",  # fork bomb
    r"\bcurl\b.*\|\s*(ba)?sh",
    r"\bwget\b.*\|\s*(ba)?sh",
    r"\bchmod\s+777\s+/",
    r"\bsudo\b|\bsu\b\s",
    r">\s*/dev/sd",
]

INTERACTIVE_COMMANDS = {"vi", "vim", "nano", "emacs", "less", "more", "top", "htop",
                        "ssh", "ftp", "telnet"}


class ShellRunner:
    """Allowlisted shell execution with timeout, background mode, truncation."""

    def __init__(self, allowed: set[str] | None = None, denied: list[str] | None = None):
        self.allowed = allowed or ALLOWED_COMMANDS
        self.denied = [re.compile(p) for p in (denied or DENIED_PATTERNS)]
        self._lock = threading.RLock()
        self._background: dict[int, subprocess.Popen] = {}

    def _segments(self, command: str) -> list[list[str]] | str:
        """Quote-aware pipeline segmentation; str return = parse error."""
        try:
            lex = shlex.shlex(command, posix=True, punctuation_chars=True)
            lex.whitespace_split = True
            tokens = list(lex)
        except ValueError as exc:
            return f"unparseable command: {exc}"
        segments: list[list[str]] = [[]]
        for tok in tokens:
            if tok in ("|", "||", "&&", ";", "&", "|&") or set(tok) <= {"|", "&", ";"}:
                segments.append([])
            elif tok.startswith((">", "<", ">>", "2>")):
                continue
            else:
                segments[-1].append(tok)
        return segments

    @staticmethod
    def _segment_prog(argv: list[str]) -> str | None:
        # skip env-var assignments prefix (FOO=bar cmd ...)
        i = 0
        while i < len(argv) and re.match(r"^[A-Za-z_][A-Za-z0-9_]*=", argv[i]):
            i += 1
        return os.path.basename(argv[i]) if i < len(argv) else None

    def is_interactive(self, command: str) -> bool:
        """Heuristic from the reference (fei/tools/code.py:1494-1519): any
        pipeline segment whose program expects a terminal. Allowed
        interactive commands run under the PTY wrapper with prompt
        auto-confirmation instead of hanging on a missing tty; note the
        allowlist still gates first, so members of INTERACTIVE_COMMANDS
        only reach the PTY when a caller's custom allowlist includes them
        — the default allowlist admits only the flag/subcommand cases
        (python -i, git rebase -i, npm init, pip uninstall)."""
        segments = self._segments(command)
        if isinstance(segments, str):
            return False
        progs = {self._segment_prog(a) for a in segments}
        if progs & INTERACTIVE_COMMANDS:
            return True
        # flag/subcommand-based interactivity of otherwise-batch programs
        for argv in segments:
            prog = self._segment_prog(argv)
            rest = argv[argv.index(prog) if prog in argv else 0:]
            if prog in ("python", "python3") and "-i" in rest:
                return True
            if prog == "git" and (
                ("rebase" in rest and "-i" in rest)
                or ("add" in rest and ("-p" in rest or "-i" in rest))
            ):
                return True
            if prog == "npm" and any(s in rest for s in ("init", "login")):
                return True
            if prog == "pip" and "uninstall" in rest and "-y" not in rest:
                return True
        return False

    def check_command(self, command: str) -> str | None:
        """Return a denial reason, or None if the command is allowed."""
        for rx in self.denied:
            if rx.search(command):
                return f"command denied by policy: {rx.pattern}"
        segments = self._segments(command)
        if isinstance(segments, str):
            return segments
        for argv in segments:
            prog = self._segment_prog(argv)
            if prog is None:
                continue
            if prog not in self.allowed:
                return f"command not in allowlist: {prog}"
        return None

    def run(
        self,
        command: str,
        timeout: int = 60,
        background: bool = False,
        cwd: str | None = None,
    ) -> dict:
        reason = self.check_command(command)
        if reason:
            return {"error": reason, "exit_code": -1}
        if background:
            return self._run_background(command, timeout, cwd)
        if self.is_interactive(command):
            return self._run_pty(command, timeout, cwd)
        try:
            proc = subprocess.run(
                command,
                shell=True,
                capture_output=True,
                text=True,
                timeout=timeout,
                cwd=cwd,
                start_new_session=True,
            )
            out, err = proc.stdout, proc.stderr
            truncated = False
            if len(out) > MAX_OUTPUT_CHARS:
                out, truncated = out[:MAX_OUTPUT_CHARS] + "\n…[truncated]", True
            if len(err) > MAX_OUTPUT_CHARS:
                err, truncated = err[:MAX_OUTPUT_CHARS] + "\n…[truncated]", True
            return {
                "stdout": out,
                "stderr": err,
                "exit_code": proc.returncode,
                "truncated": truncated,
            }
        except subprocess.TimeoutExpired:
            return {"error": f"command timed out after {timeout}s", "exit_code": -1}

    def _run_pty(self, command: str, timeout: int, cwd: str | None) -> dict:
        """Run an interactive command under the PTY wrapper: it gets a real
        tty and its confirmation prompts are auto-answered
        (tools/pty_wrapper.py; the upstream wrapper script's behavior,
        generalized). Output is the captured transcript."""
        from fei_tpu_torch.tools.pty_wrapper import PtyWrapper

        if cwd:
            command = f"cd {shlex.quote(cwd)} && {command}"
        try:
            wrapper = PtyWrapper(
                ["bash", "-c", command], echo=False, timeout=float(timeout)
            )
            code = wrapper.run()
            out = wrapper.output
            truncated = len(out) > MAX_OUTPUT_CHARS
            if truncated:
                out = out[:MAX_OUTPUT_CHARS] + "\n…[truncated]"
            result = {
                "stdout": out, "stderr": "", "exit_code": code,
                "interactive": True, "truncated": truncated,
            }
            if wrapper.timed_out:
                # same contract as the subprocess path: timeouts are errors
                result["error"] = f"command timed out after {timeout}s"
            return result
        except Exception as exc:  # noqa: BLE001 — pty can fail in odd envs
            return {"error": f"pty execution failed: {exc}", "exit_code": -1}

    def _run_background(self, command: str, timeout: int, cwd: str | None) -> dict:
        proc = subprocess.Popen(
            command,
            shell=True,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
            cwd=cwd,
            start_new_session=True,
        )
        with self._lock:
            self._background[proc.pid] = proc
        if timeout:
            killer = threading.Timer(timeout, self._kill_group, args=(proc,))
            killer.daemon = True
            killer.start()
        return {"pid": proc.pid, "background": True}

    @staticmethod
    def _kill_group(proc: subprocess.Popen) -> None:
        if proc.poll() is None:
            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
                time.sleep(2)
                if proc.poll() is None:
                    os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass

    def stop_background(self, pid: int) -> bool:
        with self._lock:
            proc = self._background.pop(pid, None)
        if proc is None:
            return False
        self._kill_group(proc)
        return True


# Module singletons, mirroring the reference's convenience instances
# (fei/tools/code.py:1717-1724).
glob_finder = GlobFinder()
grep_tool = GrepTool()
code_editor = CodeEditor()
file_viewer = FileViewer()
directory_explorer = DirectoryExplorer()
system_info = SystemInfo()
shell_runner = ShellRunner()
