"""fei_tpu_torch stands alone: importing it and every submodule loads
neither jax nor any module of the JAX package (fei_tpu, fei_tpu.*)."""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
import fei_tpu_torch
names = ["fei_tpu_torch"]
for mod in pkgutil.walk_packages(fei_tpu_torch.__path__, "fei_tpu_torch."):
    importlib.import_module(mod.name)
    names.append(mod.name)
loaded = sorted(sys.modules)
print(json.dumps({
    "imported": names,
    "jax": [m for m in loaded if m == "jax" or m.startswith("jax.")],
    "fei_tpu": [m for m in loaded if m == "fei_tpu" or m.startswith("fei_tpu.")],
}))
"""


def _probe() -> dict:
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        timeout=120, check=True, cwd=REPO,
    )
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_without_jax_or_fei_tpu():
    got = _probe()
    # every module of the slice is importable (the walk reached them all)
    for name in (
        "fei_tpu_torch.models.llama", "fei_tpu_torch.models.convert",
        "fei_tpu_torch.ops.kernels.flash_attention",
        "fei_tpu_torch.ops.kernels.paged_attention",
        "fei_tpu_torch.ops.kernels.ragged_paged_attention",
        "fei_tpu_torch.ops.quant", "fei_tpu_torch.ops.kernels.int4_matmul",
        "fei_tpu_torch.engine.engine", "fei_tpu_torch.engine.weights",
        "fei_tpu_torch.engine.paged_cache", "fei_tpu_torch.engine.scheduler",
        "fei_tpu_torch.engine.sched_admission", "fei_tpu_torch.engine.sched_decode",
        "fei_tpu_torch.engine.tenancy", "fei_tpu_torch.engine.faults",
        "fei_tpu_torch.agent.providers", "fei_tpu_torch.ui.server",
        "fei_tpu_torch.engine.train", "fei_tpu_torch.engine.checkpoint",
        "fei_tpu_torch.utils.tree", "fei_tpu_torch.__main__",
        "fei_tpu_torch.engine.grammar", "fei_tpu_torch.engine.sched_constrain",
        "fei_tpu_torch.agent.assistant", "fei_tpu_torch.agent.conversation",
        "fei_tpu_torch.agent.task_executor", "fei_tpu_torch.tools.registry",
        "fei_tpu_torch.tools.definitions", "fei_tpu_torch.tools.handlers",
        "fei_tpu_torch.tools.code", "fei_tpu_torch.tools.repomap",
        "fei_tpu_torch.tools.pty_wrapper", "fei_tpu_torch.utils.openai_stub",
        "fei_tpu_torch.obs.render", "fei_tpu_torch.ui.cli",
        "fei_tpu_torch.engine.prng", "fei_tpu_torch.engine.journal",
        "fei_tpu_torch.utils.fsync",
        "fei_tpu_torch.kv", "fei_tpu_torch.kv.tier", "fei_tpu_torch.kv.pagesio",
        "fei_tpu_torch.parallel", "fei_tpu_torch.parallel.mesh",
        "fei_tpu_torch.parallel.distributed", "fei_tpu_torch.parallel.sharding",
        "fei_tpu_torch.parallel.serving",
        "fei_tpu_torch.kv.migrate", "fei_tpu_torch.kv.content",
        "fei_tpu_torch.agent.mcp", "fei_tpu_torch.native", "fei_tpu_torch.native.build",
        "fei_tpu_torch.native.scan", "fei_tpu_torch.tools.memory_tools",
        "fei_tpu_torch.tools.memdir_connector", "fei_tpu_torch.tools.memorychain_connector",
        "fei_tpu_torch.memory", "fei_tpu_torch.memory.memdir",
        "fei_tpu_torch.memory.memdir.store", "fei_tpu_torch.memory.memdir.folders",
        "fei_tpu_torch.memory.memdir.filters", "fei_tpu_torch.memory.memdir.search",
        "fei_tpu_torch.memory.memdir.archiver", "fei_tpu_torch.memory.memdir.server",
        "fei_tpu_torch.memory.memdir.cli", "fei_tpu_torch.memory.memdir.samples",
        "fei_tpu_torch.memory.memdir.__main__", "fei_tpu_torch.memory.memorychain",
        "fei_tpu_torch.memory.memorychain.chain", "fei_tpu_torch.memory.memorychain.transport",
        "fei_tpu_torch.memory.memorychain.node", "fei_tpu_torch.memory.memorychain.cli",
        "fei_tpu_torch.memory.memorychain.embedding_exchange",
        "fei_tpu_torch.ui.textual_chat",
        "fei_tpu_torch.fleet", "fei_tpu_torch.fleet.router",
        "fei_tpu_torch.fleet.replica", "fei_tpu_torch.obs",
        "fei_tpu_torch.obs.metrics", "fei_tpu_torch.obs.prom",
        "fei_tpu_torch.obs.trace", "fei_tpu_torch.obs.flight",
        "fei_tpu_torch.obs.registry", "fei_tpu_torch.obs.costmodel",
    ):
        assert name in got["imported"], name
    assert got["jax"] == [], got["jax"]
    assert got["fei_tpu"] == [], got["fei_tpu"]


_SLICE_PROBE = r"""
import json, sys
import fei_tpu_torch.engine.grammar, fei_tpu_torch.agent, fei_tpu_torch.tools
import fei_tpu_torch.ui.cli
from fei_tpu_torch.tools.code import SystemInfo
SystemInfo().get_info()  # the system-info tool reads torch.cuda, never jax
loaded = sorted(sys.modules)
print(json.dumps([m for m in loaded if m in ("jax", "fei_tpu")
                  or m.startswith(("jax.", "fei_tpu."))]))
"""


def test_agent_modules_load_neither_jax_nor_fei_tpu():
    out = subprocess.run(
        [sys.executable, "-c", _SLICE_PROBE], capture_output=True, text=True,
        timeout=120, check=True, cwd=REPO,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


_KV_PROBE = r"""
import json, sys
import fei_tpu_torch.kv.tier, fei_tpu_torch.kv.pagesio
import fei_tpu_torch.kv.migrate, fei_tpu_torch.kv.content
loaded = sorted(sys.modules)
print(json.dumps([m for m in loaded if m in ("jax", "fei_tpu", "ml_dtypes")
                  or m.startswith(("jax.", "fei_tpu.", "ml_dtypes."))]))
"""


def test_kv_modules_load_neither_jax_nor_fei_tpu():
    """The KV tier carries bf16 as 2-byte words: not even ml_dtypes loads."""
    out = subprocess.run(
        [sys.executable, "-c", _KV_PROBE], capture_output=True, text=True,
        timeout=120, check=True, cwd=REPO,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


_TOOLS_PROBE = r"""
import argparse, json, sys
from fei_tpu_torch.ui.cli import build_assistant
from fei_tpu_torch.ui.textual_chat import FeiChatApp
from fei_tpu_torch.native import scan
from fei_tpu_torch.memory.memorychain.embedding_exchange import exchange_banks, hash_embed
a = build_assistant(argparse.Namespace(provider="mock", model=None, max_tool_rounds=1,
                                       max_tokens=8, no_stream=True, memory_tools=True))
FeiChatApp(assistant=a).handle_memory_command("help")
scan.grep_files([__import__("fei_tpu_torch").__file__], "import", 10)
exchange_banks(hash_embed("a b")[None, None], device="cpu")
loaded = sorted(sys.modules)
print(json.dumps([m for m in loaded if m in ("jax", "fei_tpu")
                  or m.startswith(("jax.", "fei_tpu."))]))
"""


def test_tools_modules_load_neither_jax_nor_fei_tpu():
    """Driving the agent's tool layer (MCP, the memory tools, the native
    scanner, the TUI, the federation) loads no module of the JAX package."""
    out = subprocess.run(
        [sys.executable, "-c", _TOOLS_PROBE], capture_output=True, text=True,
        timeout=120, check=True, cwd=REPO,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


_FLEET_PROBE = r"""
import json, sys
import fei_tpu_torch.fleet, fei_tpu_torch.obs
from fei_tpu_torch.fleet import HttpReplica, InProcessReplica, Router
from fei_tpu_torch.obs import FLIGHT, METRICS, TRACES, costmodel
FLIGHT.event("probe")
TRACES.finish(TRACES.start(prompt_tokens=1), "completed")
METRICS.prometheus_text()
costmodel.chips_for_tag("tp2dp2")
loaded = sorted(sys.modules)
print(json.dumps([m for m in loaded if m in ("jax", "fei_tpu")
                  or m.startswith(("jax.", "fei_tpu."))]))
"""


def test_fleet_and_obs_modules_load_neither_jax_nor_fei_tpu():
    """The router, the replicas, the flight recorder, the traces and the
    cost model load no module of the JAX package, even when used."""
    out = subprocess.run(
        [sys.executable, "-c", _FLEET_PROBE], capture_output=True, text=True,
        timeout=120, check=True, cwd=REPO,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


_PARALLEL_PROBE = r"""
import json, sys
import fei_tpu_torch.parallel.ring, fei_tpu_torch.parallel.long_prefill
import fei_tpu_torch.parallel.expert, fei_tpu_torch.parallel.pipeline
loaded = sorted(sys.modules)
print(json.dumps([m for m in loaded if m in ("jax", "fei_tpu")
                  or m.startswith(("jax.", "fei_tpu."))]))
"""


def test_parallel_modules_load_neither_jax_nor_fei_tpu():
    """Sequence, expert and pipeline parallelism import no module of the
    JAX package."""
    out = subprocess.run(
        [sys.executable, "-c", _PARALLEL_PROBE], capture_output=True, text=True,
        timeout=120, check=True, cwd=REPO,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
