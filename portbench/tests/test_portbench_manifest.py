"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files that the harness finds by that name."""

from __future__ import annotations

import re

import pytest

from portbench import spec

MANIFEST = spec.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in MANIFEST["end_to_end"]}


def reports(cell: str, metric: dict) -> bool:
    return cell in metric.get("workloads", [cell])


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51


@pytest.mark.parametrize("entry", MANIFEST["configs"] + MANIFEST["workloads"]
                         + MANIFEST["end_to_end"] + MANIFEST["per_layer"],
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_end_to_end_metrics():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    assert len(E2E) - 1 <= 4
    for m in E2E.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cell_files_and_metrics(cell):
    assert cell["chips"] == 1
    c = spec.load_cell(cell["name"])
    assert c.traffic["kind"] and c.workload["rows"] > 0
    e2e = [m for m in MANIFEST["end_to_end"] if reports(cell["name"], m)]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    layers = [m for m in MANIFEST["per_layer"] if reports(cell["name"], m)]
    assert layers
    for m in layers:
        assert reports(cell["name"], E2E[m["moves"]]), (m["name"], m["moves"])


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"] + MANIFEST["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    if metric["name"] != "setup_s":
        assert (spec.HERE / "metrics" / f"{metric['name']}.py").exists()


def test_per_layer_layers_are_named_alike():
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in E2E and m["layer"].strip() == m["layer"]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("config", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_files_hold_the_published_sizes(config):
    raw = spec.read_json(spec.ROOT / config["file"])
    assert raw["source"] == config["source"] and raw["reduced"] == config["reduced"] == []
    from fei_tpu_torch.models.configs import get_model_config

    preset = get_model_config(raw["port_preset"])
    assert get_model_config(raw["port_preset"], **spec.port_overrides(raw)) == preset


def test_check_budget_fits():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (MANIFEST["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_manifest_is_small():
    assert (spec.ROOT / 'BENCHMARK.json').stat().st_size < 64 * 1024
