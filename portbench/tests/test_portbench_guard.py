"""The import guard, the reference's independence, and a run's refusal
where it cannot measure."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from portbench import spec
from portbench.guard import forbidden_modules


def test_guard_compares_whole_top_level_names():
    names = ["fei_tpu_torch", "fei_tpu_torch.engine.engine", "jaxtyping", "flaxen",
             "fei_tpu", "fei_tpu.engine", "jax.numpy", "jaxlib", "flax.linen"]
    assert forbidden_modules(names) == ["fei_tpu", "fei_tpu.engine", "flax.linen", "jax.numpy",
                                        "jaxlib"]
    assert forbidden_modules(["fei_tpu_torch.ops", "portbench.run"]) == []


def loaded_after(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         cwd=spec.ROOT, capture_output=True, text=True, check=True,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_a_run_loads_nothing_of_the_jax_side():
    mods = loaded_after("import portbench.run, portbench.calibrate, portbench.trace\n"
                        "import fei_tpu_torch.engine.engine, fei_tpu_torch.engine.scheduler")
    assert forbidden_modules(mods) == []


def test_the_reference_imports_nothing_of_the_program():
    mods = loaded_after("import portbench.reference.model, portbench.correctness")
    assert not [m for m in mods if m.split(".")[0] == "fei_tpu_torch"]
    assert forbidden_modules(mods) == []


def test_no_card_no_result():
    """Without a CUDA device a run exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", "mistral-7b.chat",
                          "--seed", "3", "--seconds", "1"], cwd=spec.ROOT,
                         capture_output=True, text=True,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_files_alone_are_not_enough(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files,
    a run exits non-zero and prints no result."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", "mistral-7b.chat",
                          "--seed", "3", "--seconds", "1"], cwd=tmp_path,
                         capture_output=True, text=True,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout.strip() == ""
