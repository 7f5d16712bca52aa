"""The check that decides ``correct``, driven through a whole run on the
CPU at tiny sizes (the harness's look for a card skipped): a sound run
passes, and a run with the timed path broken underneath fails, once for
each fault a served cell can have; and the control (the reference a
precision step lower in the program's place) reads far above a sound run,
and fails each cell's own limits where the model is deep enough for the
lower precision's error to build up as it does at the cell's size.
"""

from __future__ import annotations

import time

import pytest
import torch

from portbench import correctness, run, spec
from portbench.tests import tiny

SEED = 3_000_000_019
CPU = torch.device("cpu")


DEEP = 16  # layers at which the tiny control reads as far out as the cells' controls
CELLS = {"mistral-7b.chat": tiny.SWA, "mixtral-8x7b-int8.chat": tiny.MOE}


def serve(raw=tiny.SWA, mix=tiny.CHAT, cell=None, seconds=1.5):
    cell = cell or tiny.cell(raw, mix)
    return run.serve(cell, SEED, seconds, False, CPU, time.time())


@pytest.mark.parametrize("raw", [tiny.SWA, tiny.MOE], ids=["tiny-swa", "tiny-moe-int8"])
def test_sound_run_is_correct(raw):
    result, compared, picked, _ = serve(raw)
    assert result["correct"], compared
    assert picked and result["metrics"]["output_tok_s"]["value"] > 0


def test_chunked_admission_is_correct(monkeypatch):
    """Chunks of 16 tokens: every prompt of the tiny mix (8-40 tokens) over
    one chunk admits through the paged-native chunked route (K3's path),
    and crosses tiny-swa's window of 8."""
    monkeypatch.setenv("FEI_TPU_PREFILL_CHUNK", "16")
    result, compared, picked, _ = serve()
    assert result["correct"], compared
    assert max(len(r.prompt) for r in picked) > 16


def test_token_altered_where_it_is_produced(monkeypatch):
    from fei_tpu_torch.engine import sched_decode

    real = sched_decode.sample_rows
    monkeypatch.setattr(sched_decode, "sample_rows",
                        lambda logits, *a, **k: (real(logits, *a, **k) + 1) % logits.shape[-1])
    result, compared, _, _ = serve()
    assert not result["correct"], compared


def test_decode_step_leaves_the_cache_unchanged(monkeypatch):
    from fei_tpu_torch.engine import paged_cache

    monkeypatch.setattr(paged_cache, "write_token_kv", lambda *a, **k: None)
    result, compared, _, _ = serve()
    assert not result["correct"], compared


@pytest.mark.parametrize("raw", [tiny.SWA, tiny.MOE], ids=["fp8-for-bf16", "int4-for-int8"])
def test_control_fails_the_limit(raw):
    result, compared, picked, _ = serve(raw)
    control = correctness.numbers(correctness.control_gaps(tiny.cell(raw).model, SEED, picked, CPU))
    assert compared[0][1] <= tiny.LIMIT < control["max_logit_gap"]


@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_fails_each_cells_own_limits(name):
    """The control's first choices in place of the served tokens, judged
    with the limits in the cell's workload file (the widest gap for
    Mistral, the mean gap for Mixtral): not correct, where a sound run of
    the same cell is."""
    raw = {**CELLS[name], "num_hidden_layers": DEEP}
    cell = tiny.cell(raw, name=name)
    cell.workload["check"]["limits"] = spec.read_json(
        spec.HERE / "workloads" / f"{name}.json")["check"]["limits"]
    result, compared, picked, _ = serve(cell=cell, seconds=5.0)
    assert result["correct"] and sum(len(r.tokens) for r in picked) >= 48, compared
    control = correctness.numbers(correctness.control_gaps(cell.model, SEED, picked, CPU))
    judged, correct = correctness.judge(control, cell.workload["check"]["limits"])
    assert not correct, judged
