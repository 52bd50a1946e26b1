"""``BENCHMARK.json`` and the files it names: present, parsed, within the
limits the benchmark's contract sets, and agreeing with one another."""

from __future__ import annotations

import re

import pytest

from fhebench import harness

BENCH = harness.load_json(harness.BENCHMARK)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
ROOT = harness.ROOT
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = [w["name"] for w in BENCH["workloads"]]


def text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["fhebench"]
    assert BENCH["command"][:3] == ["python3", "-m", "fhebench.run"]
    assert all(text_ok(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert (harness.BENCHMARK.stat().st_size) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and text_ok(entry["source"]) and text_ok(entry["why"])
    assert entry["file"] == f"fhebench/configs/{entry['name']}.json"
    cfg = harness.load_json(ROOT.parent / entry["file"])
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"] == []
    assert {"assumed", "deployment", "guarantees"} <= set(cfg)
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("name,preset", [("default-n635-N1024", "DEFAULT_PARAMS"),
                                         ("pbs-n714-N2048", "PBS_PARAMS")])
def test_config_is_the_ports_preset(name, preset):
    """Every TFHEParams field of the file equals the port's preset: nothing
    is cut."""
    from rustfhe_tpu_torch import params
    import dataclasses

    cfg = harness.load_json(ROOT / "configs" / f"{name}.json")
    p = getattr(params, preset)
    for f in dataclasses.fields(p):
        assert cfg[f.name] == getattr(p, f.name), f.name


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_files(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["config"]) and NAME.match(entry["traffic"])
    assert entry["chips"] == 1 and text_ok(entry["why"])
    cell = harness.load_json(ROOT / "workloads" / f"{entry['name']}.json")
    for k in ("config", "traffic", "chips", "why"):
        assert cell[k] == entry[k], k
    mix = harness.load_json(ROOT / "traffic" / f"{entry['traffic']}.json")
    assert (ROOT / "traffic" / f"{mix['generator']}.py").exists()
    assert (ROOT / "configs" / f"{entry['config']}.json").exists()
    names = [m["name"] for m in harness.metric_list(BENCH, entry["name"], False)]
    assert "setup_s" in names and len(names) >= 2
    assert harness.metric_list(BENCH, entry["name"], True)


def test_pairs_and_names_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert (ROOT / "metrics" / f"{m['name']}.py").exists()
    assert all(c in CELLS for c in m.get("workloads", CELLS))
    if m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert text_ok(m["layer"])
        moved = E2E[m["moves"]]
        assert all(c in moved.get("workloads", CELLS) for c in m["workloads"])
    if "roofline" in m["name"]:
        assert m["unit"] == "%" and m["name"].split(".")[0].endswith("_roofline")


def test_check_time_fits():
    """A full check of 24 cells at this run length fits its 43,200 s."""
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_layers_are_named_alike():
    """Metrics of one layer give the same name letter for letter."""
    by_stem: dict[str, set] = {}
    for m in BENCH["per_layer"]:
        by_stem.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_stem.values())
