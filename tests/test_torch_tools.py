"""The port's tool layer (``fei_tpu_torch.tools``) against fei_tpu's: each
of the 14 code tools, called through each package's own registry with
the same arguments on the same temporary tree, gives the same result
(and leaves the same files); the registries hold the same schemas and
validate the same way; the system-info tool names the CUDA devices."""

import shutil

import pytest

from fei_tpu.tools import ToolRegistry as JaxRegistry
from fei_tpu.tools import create_code_tools as jax_create
from fei_tpu.tools.definitions import TOOL_DEFINITIONS as JAX_DEFS
from fei_tpu.utils.errors import ToolError as JaxToolError
from fei_tpu_torch.tools import TOOL_DEFINITIONS, ToolRegistry, create_code_tools
from fei_tpu_torch.tools.code import SystemInfo
from fei_tpu_torch.utils.errors import ToolError


def _tree(root):
    (root / "src").mkdir(parents=True)
    (root / "src" / "app.py").write_text(
        "import os\nfrom util import load_config\n\n\ndef main():\n"
        "    return helper()\n\n\ndef helper():\n    return 42  # TODO tidy\n")
    (root / "src" / "util.py").write_text(
        "class Config:\n    pass\n\n\ndef load_config():\n    return Config()\n")
    (root / "README.md").write_text("# demo\nhello world\nTODO: docs\n")
    (root / "data.bin").write_bytes(b"\x00\x01\x02")
    return root


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and ".fei_backups" not in p.parts}


# (tool, arguments) — ``{root}`` is the tree's path
CASES = [
    ("GlobTool", {"pattern": "**/*.py", "path": "{root}"}),
    ("GrepTool", {"pattern": "TODO", "path": "{root}"}),
    ("GrepTool", {"pattern": "def \\w+", "path": "{root}", "include": "*.py"}),
    ("View", {"file_path": "{root}/src/app.py", "offset": 2, "limit": 4}),
    ("View", {"file_path": "{root}/data.bin"}),
    ("Edit", {"file_path": "{root}/src/app.py", "old_string": "return 42",
              "new_string": "return 43"}),
    ("Edit", {"file_path": "{root}/src/app.py", "old_string": "return",
              "new_string": "yield"}),
    ("Replace", {"file_path": "{root}/src/new.py", "content": "X = 1\n"}),
    ("LS", {"path": "{root}"}),
    ("LS", {"path": "{root}", "ignore": ["*.bin"]}),
    ("RegexEdit", {"file_path": "{root}/src/util.py", "pattern": "Config",
                   "replacement": "Settings"}),
    ("BatchGlob", {"patterns": ["*.md", "src/*.py"], "path": "{root}"}),
    ("FindInFiles", {"files": ["{root}/src/app.py", "{root}/README.md"],
                     "pattern": "TODO"}),
    ("SmartSearch", {"query": "load_config"}),
    ("RepoMap", {"path": "{root}", "token_budget": 256}),
    ("RepoSummary", {"path": "{root}"}),
    ("RepoDependencies", {"path": "{root}", "file": "src/app.py"}),
    ("Shell", {"command": "ls src | sort", "cwd": "{root}"}),
    ("Shell", {"command": "rm -rf src"}),
]


def _fill(v, root):
    if isinstance(v, str):
        return v.replace("{root}", str(root))
    if isinstance(v, list):
        return [_fill(x, root) for x in v]
    return v


def _run(registry, name, args, root, error_type):
    try:
        return {"ok": registry.execute_tool(name, {k: _fill(v, root) for k, v in args.items()})}
    except error_type as exc:
        return {"error": type(exc).__name__, "message": str(exc)}


def _scrub(x, root):
    """Paths of the tree written relative; volatile fields dropped."""
    if isinstance(x, dict):
        return {_scrub(k, root): _scrub(v, root) for k, v in x.items()
                if k not in ("backup", "backup_path", "duration_s", "elapsed_s", "mtime")}
    if isinstance(x, (list, tuple)):
        return [_scrub(v, root) for v in x]
    if isinstance(x, str):
        return x.replace(str(root), "<root>")
    return x


def test_registries_hold_the_same_schemas():
    assert TOOL_DEFINITIONS == JAX_DEFS
    assert len(TOOL_DEFINITIONS) == 14
    ours, theirs = ToolRegistry(), JaxRegistry()
    assert create_code_tools(ours) == jax_create(theirs)
    for fmt in ("anthropic", "openai"):
        assert ours.get_schemas(fmt) == theirs.get_schemas(fmt)


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_code_tool_matches_reference(case, tmp_path, monkeypatch):
    name, args = CASES[case]
    base = _tree(tmp_path / "base")
    results, trees = [], []
    for label, make, create, err in (("jax", JaxRegistry, jax_create, JaxToolError),
                                     ("torch", ToolRegistry, create_code_tools, ToolError)):
        root = tmp_path / label / "tree"
        shutil.copytree(base, root)
        monkeypatch.chdir(root)
        registry = make()
        create(registry)
        results.append(_scrub(_run(registry, name, args, root, err), root))
        trees.append(_files(root))
    assert results[0] == results[1]
    assert trees[0] == trees[1]


@pytest.mark.parametrize("name,args", [
    ("View", {}),  # a required argument missing
    ("LS", {"path": 3}),  # a wrong type
    ("Nope", {}),  # no such tool
])
def test_validation_matches_reference(name, args):
    got = []
    for make, create, err in ((JaxRegistry, jax_create, JaxToolError),
                              (ToolRegistry, create_code_tools, ToolError)):
        registry = make()
        create(registry)
        with pytest.raises(err) as info:
            registry.execute_tool(name, args)
        got.append((type(info.value).__name__, str(info.value)))
    assert got[0] == got[1]


def test_system_info_names_the_cuda_devices():
    import torch

    acc = SystemInfo().get_info()["accelerator"]
    if torch.cuda.is_available():
        assert acc["backend"] == "cuda" and acc["count"] == torch.cuda.device_count()
    else:
        assert acc == {"backend": "cpu", "devices": [], "count": 0}
