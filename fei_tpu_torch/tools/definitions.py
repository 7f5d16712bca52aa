"""The 15 core tool declarations (JSON schema), parity with the reference's
fei/tools/definitions.py:11-441. Descriptions carry the behavior contracts the
model must follow (e.g. the Edit uniqueness rule, definitions.py:81-92).

A copy of ``fei_tpu/tools/definitions.py`` that imports only the port.
"""

from __future__ import annotations

GLOB_TOOL = {
    "name": "GlobTool",
    "description": (
        "Fast file-pattern matching for any codebase size. Supports glob patterns like "
        "'**/*.js' or 'src/**/*.ts'. Returns matching file paths sorted by modification "
        "time (newest first). Use when you need to find files by name pattern."
    ),
    "input_schema": {
        "type": "object",
        "properties": {
            "pattern": {"type": "string", "description": "Glob pattern to match files against"},
            "path": {"type": "string", "description": "Directory to search in (defaults to cwd)"},
        },
        "required": ["pattern"],
    },
}

GREP_TOOL = {
    "name": "GrepTool",
    "description": (
        "Fast content search using regular expressions. Searches file contents, returning "
        "matching lines with file and line number. Filter files with the include glob. "
        "Use when you need to find code by content rather than name."
    ),
    "input_schema": {
        "type": "object",
        "properties": {
            "pattern": {"type": "string", "description": "Regex to search for in file contents"},
            "path": {"type": "string", "description": "Directory to search in (defaults to cwd)"},
            "include": {"type": "string", "description": "Glob filter, e.g. '*.py' or '*.{ts,tsx}'"},
        },
        "required": ["pattern"],
    },
}

VIEW_TOOL = {
    "name": "View",
    "description": (
        "Read a file from the filesystem. Returns numbered lines. By default reads from "
        "the beginning; pass offset/limit for long files. Files over 10 MB are rejected."
    ),
    "input_schema": {
        "type": "object",
        "properties": {
            "file_path": {"type": "string", "description": "Absolute path to the file to read"},
            "offset": {"type": "integer", "description": "Line number to start reading from"},
            "limit": {"type": "integer", "description": "Number of lines to read"},
        },
        "required": ["file_path"],
    },
}

EDIT_TOOL = {
    "name": "Edit",
    "description": (
        "Edit a file by replacing one unique occurrence of old_string with new_string. "
        "CONTRACT: old_string must match EXACTLY one location in the file, including all "
        "whitespace and surrounding context — include at least 3 lines of context before "
        "and after the change point to make the match unique. If old_string matches zero "
        "or multiple locations the edit is rejected. To create a new file, pass the new "
        "path with an empty old_string and the full contents as new_string."
    ),
    "input_schema": {
        "type": "object",
        "properties": {
            "file_path": {"type": "string", "description": "Absolute path to the file to modify"},
            "old_string": {"type": "string", "description": "Text to replace (must be unique)"},
            "new_string": {"type": "string", "description": "Replacement text"},
        },
        "required": ["file_path", "old_string", "new_string"],
    },
}

REPLACE_TOOL = {
    "name": "Replace",
    "description": (
        "Write a file to the filesystem, fully overwriting any existing content. "
        "Prefer Edit for partial changes; use Replace to create or rewrite whole files."
    ),
    "input_schema": {
        "type": "object",
        "properties": {
            "file_path": {"type": "string", "description": "Absolute path to the file to write"},
            "content": {"type": "string", "description": "Complete new file content"},
        },
        "required": ["file_path", "content"],
    },
}

LS_TOOL = {
    "name": "LS",
    "description": (
        "List files and directories at a path. Optionally ignore glob patterns. "
        "Returns entries with type and size."
    ),
    "input_schema": {
        "type": "object",
        "properties": {
            "path": {"type": "string", "description": "Absolute path to the directory to list"},
            "ignore": {
                "type": "array",
                "items": {"type": "string"},
                "description": "Glob patterns to exclude",
            },
        },
        "required": ["path"],
    },
}

BRAVE_SEARCH_TOOL = {
    "name": "brave_web_search",
    "description": (
        "Search the web with the Brave Search API. Use for current events, external "
        "documentation, or anything not in the local filesystem."
    ),
    "input_schema": {
        "type": "object",
        "properties": {
            "query": {"type": "string", "description": "Search query"},
            "count": {"type": "integer", "description": "Number of results (1-20)", "minimum": 1, "maximum": 20},
        },
        "required": ["query"],
    },
}

REGEX_EDIT_TOOL = {
    "name": "RegexEdit",
    "description": (
        "Edit a file by applying a regex substitution to every match. Supports capture "
        "group references (\\1, \\g<name>) in the replacement. Validates the edited "
        "result parses (Python files are ast-checked) before committing."
    ),
    "input_schema": {
        "type": "object",
        "properties": {
            "file_path": {"type": "string", "description": "Absolute path to the file to modify"},
            "pattern": {"type": "string", "description": "Regular expression to match"},
            "replacement": {"type": "string", "description": "Replacement (supports backrefs)"},
            "validate": {"type": "boolean", "description": "Syntax-check result before saving (default true)"},
        },
        "required": ["file_path", "pattern", "replacement"],
    },
}

BATCH_GLOB_TOOL = {
    "name": "BatchGlob",
    "description": (
        "Run multiple glob patterns in one call, in parallel. Returns a mapping from "
        "pattern to matched paths. Use to explore several file families at once."
    ),
    "input_schema": {
        "type": "object",
        "properties": {
            "patterns": {
                "type": "array",
                "items": {"type": "string"},
                "description": "Glob patterns to match",
            },
            "path": {"type": "string", "description": "Directory to search in (defaults to cwd)"},
        },
        "required": ["patterns"],
    },
}

FIND_IN_FILES_TOOL = {
    "name": "FindInFiles",
    "description": (
        "Search for a regex across a specific list of files (rather than a directory "
        "tree). Returns matches grouped by file with line numbers."
    ),
    "input_schema": {
        "type": "object",
        "properties": {
            "files": {
                "type": "array",
                "items": {"type": "string"},
                "description": "Files to search",
            },
            "pattern": {"type": "string", "description": "Regex to search for"},
        },
        "required": ["files", "pattern"],
    },
}

SMART_SEARCH_TOOL = {
    "name": "SmartSearch",
    "description": (
        "Code-aware search: give a natural query like 'function parse_args in python' "
        "and it combines language-specific file globs with definition-pattern regexes "
        "(def/class/function/etc.) to find the symbol."
    ),
    "input_schema": {
        "type": "object",
        "properties": {
            "query": {"type": "string", "description": "Search query, may include a language hint"},
            "context": {"type": "string", "description": "Optional extra context about what you're looking for"},
        },
        "required": ["query"],
    },
}

REPO_MAP_TOOL = {
    "name": "RepoMap",
    "description": (
        "Generate a ranked map of the repository: files with their key symbols "
        "(classes/functions), ordered by cross-file reference importance, within a "
        "token budget. Use to orient in an unfamiliar codebase."
    ),
    "input_schema": {
        "type": "object",
        "properties": {
            "path": {"type": "string", "description": "Repository root (defaults to cwd)"},
            "token_budget": {"type": "integer", "description": "Approximate token budget for the map"},
            "exclude": {"type": "array", "items": {"type": "string"}, "description": "Glob patterns to exclude"},
        },
    },
}

REPO_SUMMARY_TOOL = {
    "name": "RepoSummary",
    "description": (
        "Summarize repository structure by module/directory: file counts, languages, "
        "top symbols per module. Coarser and cheaper than RepoMap."
    ),
    "input_schema": {
        "type": "object",
        "properties": {
            "path": {"type": "string", "description": "Repository root (defaults to cwd)"},
        },
    },
}

REPO_DEPS_TOOL = {
    "name": "RepoDependencies",
    "description": (
        "Extract the cross-file symbol dependency graph: which files reference symbols "
        "defined in which other files. Returns edges with the symbols involved."
    ),
    "input_schema": {
        "type": "object",
        "properties": {
            "path": {"type": "string", "description": "Repository root (defaults to cwd)"},
            "file": {"type": "string", "description": "Restrict to dependencies of this file"},
        },
    },
}

SHELL_TOOL = {
    "name": "Shell",
    "description": (
        "Run a shell command. Only allowlisted commands are permitted (file inspection, "
        "build tools, test runners, version control); destructive or interactive "
        "commands are denied. Long-running commands can be sent to the background."
    ),
    "input_schema": {
        "type": "object",
        "properties": {
            "command": {"type": "string", "description": "The command to execute"},
            "timeout": {"type": "integer", "description": "Seconds before the command is killed"},
            "background": {"type": "boolean", "description": "Run detached, returning a process id"},
            "cwd": {"type": "string", "description": "Working directory for the command"},
        },
        "required": ["command"],
    },
}

TOOL_DEFINITIONS = [
    GLOB_TOOL,
    GREP_TOOL,
    VIEW_TOOL,
    EDIT_TOOL,
    REPLACE_TOOL,
    LS_TOOL,
    REGEX_EDIT_TOOL,
    BATCH_GLOB_TOOL,
    FIND_IN_FILES_TOOL,
    SMART_SEARCH_TOOL,
    REPO_MAP_TOOL,
    REPO_SUMMARY_TOOL,
    REPO_DEPS_TOOL,
    SHELL_TOOL,
]

# The Anthropic-format list additionally exposes web search (parity:
# fei/tools/definitions.py:425-441).
ANTHROPIC_TOOL_DEFINITIONS = TOOL_DEFINITIONS + [BRAVE_SEARCH_TOOL]
