"""Stand-in cells for the CPU tests: every generator and metric file of the
benchmark, copied into a temporary root beside configurations and mixes
small enough for the CPU (n = 16, N = 256), found by name as the real ones
are."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from fhebench import harness

TINY = {"n": 16, "N": 256, "alpha_lv0": 2.0 ** -20, "alpha_lv1": 2.0 ** -30,
        "bgbit": 6, "l": 3, "iks_basebit": 2, "iks_l": 8}
TINY_PBS = {**TINY, "l": 4, "iks_basebit": 4, "iks_l": 4}

# cell -> (config, mix, the real mix it shrinks, the settings changed)
CELLS = {
    "gates.default.b16k": ("tiny", "gates_tiny", "gates_b16k",
                           {"lanes": 8, "pool": 2, "check": {"requests": 6, "lanes": 4}}),
    "radix.pbs.x256": ("tiny-pbs", "radix_tiny", "radix8_x256",
                       {"lanes": 2, "pool": 2, "check": {"share": 0.5, "rows": 2, "cap": 32}}),
    "expr.default.b1": ("tiny", "expr_tiny", "expr_b1",
                        {"ops_max": 4, "pool": 8, "check": {"share": 1.0, "rows": 2, "cap": 64}}),
    "uint8.default.x32": ("tiny", "uint_tiny", "uint8_x32",
                          {"lanes": 2, "pool": 2, "check": {"share": 0.3, "rows": 2, "cap": 32}}),
}


def write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=2) + "\n")


def make_root(tmp: Path) -> tuple[Path, dict]:
    """A root holding the stand-in cells, and a benchmark dict naming them
    with the real metrics."""
    real = harness.load_json(harness.BENCHMARK)
    for sub in ("traffic", "metrics"):
        shutil.copytree(harness.ROOT / sub, tmp / sub, ignore=shutil.ignore_patterns("*.json"))
    write(tmp / "configs" / "tiny.json", TINY)
    write(tmp / "configs" / "tiny-pbs.json", TINY_PBS)
    workloads = []
    for cell, (config, mix, real_mix, change) in CELLS.items():
        entry = next(w for w in real["workloads"] if w["name"] == cell)
        write(tmp / "traffic" / f"{mix}.json",
              {**harness.load_json(harness.ROOT / "traffic" / f"{real_mix}.json"), **change})
        settings = harness.load_json(harness.ROOT / "workloads" / f"{cell}.json")
        write(tmp / "workloads" / f"{cell}.json",
              {**settings, "config": config, "traffic": mix, "profile_seconds": 0.2})
        workloads.append({**entry, "config": config, "traffic": mix})
    return tmp, {**real, "workloads": workloads}


def run(tmp: Path, cell: str, seed: int = 7, seconds: float = 0.0, trace: bool = False,
        tamper=None) -> dict:
    root, bench = make_root(tmp)
    return harness.run_cell(cell, seed, seconds, trace, "cpu", bench=bench, root=root,
                            tamper=tamper, log=lambda msg: None)
