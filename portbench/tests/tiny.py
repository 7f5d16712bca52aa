"""Tiny cells for the CPU tests: the program's tiny-swa and tiny-moe
presets, with small mixes, under a real cell's name so that a run
reports that cell's metrics."""

from __future__ import annotations

from portbench import spec

SWA = {"port_preset": "tiny-swa", "vocab_size": 512, "hidden_size": 64, "intermediate_size": 128,
       "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
       "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "max_position_embeddings": 2048,
       "sliding_window": 8, "tie_word_embeddings": False, "quantize": None}
MOE = {**SWA, "port_preset": "tiny-moe", "sliding_window": None, "rope_theta": 500000.0,
       "num_local_experts": 4, "num_experts_per_tok": 2, "quantize": "int8"}
CHAT = {"kind": "closed_chat", "clients": 4, "prompt": {"mean": 18, "std": 9, "min": 8, "max": 40},
        "output": {"mean": 13, "std": 6, "min": 4, "max": 24}}
# the widest gap sound tiny runs read is ~1e-2 (bf16 against fp32)
LIMIT = 0.05


def cell(raw: dict = SWA, traffic: dict = CHAT, name: str = "mistral-7b.chat") -> spec.Cell:
    workload = {"rows": 4, "cpu_pages": 128, "kernels": [], "ramp_s": 0.5,
                "check": {"tokens": 64, "limits": {"max_logit_gap": LIMIT}}}
    return spec.Cell(name, raw, spec.model_from_config("tiny", raw), traffic, workload, 1)
