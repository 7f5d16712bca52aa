"""Find a cell's files by name and turn them into what a run needs.

``BENCHMARK.json`` names each cell, its configuration and its traffic mix;
the files behind those names live here, one per name:

- ``configs/<config>.json``: the published ``config.json`` of the model
  (HF keys), plus ``port_preset`` (the program's preset of the same
  model), ``quantize`` and the sizes assumed;
- ``traffic/<traffic>.json``: a generator ``kind`` and its parameters;
- ``workloads/<cell>.json``: what the cell sets on the engine (rows, the
  memory kept back from the KV pool) and the correctness sample's size.

A later change adds a cell, a mix or a configuration by adding files.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PAGE_SIZE = 64  # tokens a KV page holds, as the configurations assume

# published config.json key -> the program's ModelConfig field
HF_TO_PORT = {
    "vocab_size": "vocab_size",
    "hidden_size": "hidden_size",
    "intermediate_size": "intermediate_size",
    "num_hidden_layers": "num_layers",
    "num_attention_heads": "num_heads",
    "num_key_value_heads": "num_kv_heads",
    "rope_theta": "rope_theta",
    "rms_norm_eps": "rms_norm_eps",
    "max_position_embeddings": "max_seq_len",
    "sliding_window": "sliding_window",
    "num_local_experts": "num_experts",
    "num_experts_per_tok": "num_experts_per_tok",
    "tie_word_embeddings": "tie_embeddings",
    "bos_token_id": "bos_token_id",
    "eos_token_id": "eos_token_id",
}


@dataclass(frozen=True)
class Model:
    """The sizes the benchmark and its reference work from (published
    names, read from the configuration file)."""

    name: str
    vocab: int
    hidden: int
    inter: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    rope_theta: float
    eps: float
    window: int  # 0: full causal
    experts: int  # 0: dense MLP
    top_k: int
    quantize: str | None  # None (bf16) or "int8"

    @property
    def is_moe(self) -> bool:
        return self.experts > 0


def model_from_config(name: str, raw: dict) -> Model:
    return Model(
        name=name,
        vocab=raw["vocab_size"],
        hidden=raw["hidden_size"],
        inter=raw["intermediate_size"],
        layers=raw["num_hidden_layers"],
        heads=raw["num_attention_heads"],
        kv_heads=raw["num_key_value_heads"],
        head_dim=raw.get("head_dim") or raw["hidden_size"] // raw["num_attention_heads"],
        rope_theta=float(raw["rope_theta"]),
        eps=float(raw["rms_norm_eps"]),
        window=raw.get("sliding_window") or 0,
        experts=raw.get("num_local_experts", 0),
        top_k=raw.get("num_experts_per_tok", 0),
        quantize=raw.get("quantize"),
    )


def port_overrides(raw: dict) -> dict:
    """The program's ModelConfig fields that the configuration file sets."""
    return {port: raw[hf] for hf, port in HF_TO_PORT.items() if hf in raw}


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict  # the configuration file as written
    model: Model
    traffic: dict
    workload: dict
    chips: int


def load_manifest(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing: run from the repository's root")
    return read_json(path)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    manifest = load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    raw = read_json(root / configs[w["config"]]["file"])
    return Cell(
        name=name,
        config=raw,
        model=model_from_config(w["config"], raw),
        traffic=read_json(HERE / "traffic" / f"{w['traffic']}.json"),
        workload=read_json(HERE / "workloads" / f"{name}.json"),
        chips=w["chips"],
    )


def metrics_for(name: str, trace: bool, root: Path = ROOT) -> list[dict]:
    """The metrics this cell reports: its end-to-end ones untraced, its
    per-layer ones traced. A metric without ``workloads`` is every cell's."""
    manifest = load_manifest(root)
    key = "per_layer" if trace else "end_to_end"
    return [m for m in manifest[key] if name in m.get("workloads", [name])]
