"""fei_tpu_torch stands alone: importing it and every submodule loads
neither jax nor any module of the JAX package (fei_tpu, fei_tpu.*)."""

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
