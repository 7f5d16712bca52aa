"""The plain reference against the program on the CPU, at tiny sizes and
in fp32 on both sides: the same function on the same weights, with the
sliding window crossed (tiny-swa, window 8) and the top-2 router over
int8 experts (tiny-moe)."""

from __future__ import annotations

import pytest
import torch

from portbench import weights
from portbench.reference import model as ref
from portbench.spec import model_from_config, port_overrides
from portbench.tests import tiny

SEED = 987654321987


def program_logits(raw: dict, tokens: list[int]) -> torch.Tensor:
    from fei_tpu_torch.models.configs import get_model_config
    from fei_tpu_torch.models.llama import KVCache, forward
    from fei_tpu_torch.ops.quant import QTensor, quantize

    m = model_from_config("tiny", raw)
    cfg = get_model_config(raw["port_preset"], **port_overrides(raw))
    params = weights.program_params(m, SEED, "cpu", quantize if m.quantize else None)

    def fp32(t):  # int8 leaves stay int8; everything else computes in fp32
        return t if isinstance(t, QTensor) else t.float()

    params = {k: ({n: fp32(v) for n, v in t.items()} if k == "layers" else fp32(t))
              for k, t in params.items()}
    cache = KVCache.create(cfg, 1, len(tokens), dtype=torch.float32)
    logits, _ = forward(params, cfg, torch.tensor([tokens]), cache)
    return logits[0]


@pytest.mark.parametrize("raw", [tiny.SWA, tiny.MOE], ids=["tiny-swa", "tiny-moe-int8"])
def test_reference_matches_the_program_in_fp32(raw):
    tokens = [(7 * i + 3) % 509 + 3 for i in range(24)]  # three windows of 8
    got = program_logits(raw, tokens)
    m = model_from_config("tiny", raw)
    want = ref.logits_at(m, SEED, [tokens], [list(range(24))], "cpu")[0]
    assert torch.allclose(got, want, rtol=0, atol=1e-4 * want.abs().max().item())


def test_the_window_matters():
    """A reference without the window reads other logits past it."""
    tokens = [(5 * i + 1) % 509 + 3 for i in range(24)]
    m = model_from_config("tiny", tiny.SWA)
    full = model_from_config("tiny", {**tiny.SWA, "sliding_window": None})
    a = ref.logits_at(m, SEED, [tokens], [[3, 20]], "cpu")[0]
    b = ref.logits_at(full, SEED, [tokens], [[3, 20]], "cpu")[0]
    assert torch.allclose(a[0], b[0]) and not torch.allclose(a[1], b[1])


def test_reference_runs_with_tf32_off():
    seen = []
    with ref.fp32_mode():
        seen.append(torch.backends.cuda.matmul.allow_tf32)
    assert seen == [False]


def test_quantizers_round_as_stated():
    w = torch.tensor([[1.0, -2.0], [0.5, 4.0], [-0.25, 1.0]])
    q8 = ref.int8_dequant(w)
    assert torch.allclose(q8[:, 1], torch.tensor([-2.0, 4.0, 1.0]), atol=4 / 127)
    s4 = w.abs().amax(dim=0) / 7  # one group: every input row of a column
    q4 = ref.int4_dequant(w)
    steps = q4 / s4
    assert torch.allclose(steps, torch.round(steps), atol=1e-5)
    assert (q4 - w).abs().le(s4 / 2 + 1e-6).all()
    f8 = ref.fp8_dequant(w)
    assert torch.allclose(f8, w, rtol=0.07)
