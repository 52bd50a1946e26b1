"""What the benchmark imports: no module whose top-level name is jax,
jaxlib, flax or rustfhe_tpu (compared whole: rustfhe_tpu_torch is not
rustfhe_tpu), and the reference nothing of the port either.  Each check
runs in a fresh interpreter, so the test process's own imports do not
count."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from fhebench import harness

REPO = harness.ROOT.parent
FILES = [p for p in harness.ROOT.rglob("*.py") if "tests" not in p.parts]
MODULES = sorted(".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
                 for p in FILES if "." not in p.stem)
BY_PATH = sorted(str(p) for p in FILES
                 if p.parent.name in ("metrics", "traffic") and not p.stem.startswith("_"))


def top_level_after(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_every_module_is_free_of_jax():
    code = "import importlib\n" + "".join(f"importlib.import_module({m!r})\n" for m in MODULES)
    code += "from fhebench import harness\n" + "".join(
        f"harness.load_module(__import__('pathlib').Path({p!r}))\n" for p in BY_PATH)
    found = top_level_after(code) & set(harness.FORBIDDEN)
    assert not found


def test_a_cell_run_is_free_of_jax(tmp_path):
    """A whole stand-in run, the port's kernels' plain versions and all."""
    code = ("from pathlib import Path\nfrom fhebench.tests import standin\n"
            f"standin.run(Path({str(tmp_path)!r}), 'expr.default.b1', seconds=0.0)\n")
    assert not top_level_after(code) & set(harness.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_port():
    mods = top_level_after("import fhebench.reference.tfhe, fhebench.reference.truth")
    assert not mods & {"rustfhe_tpu", "rustfhe_tpu_torch", "jax", "jaxlib", "flax"}


@pytest.mark.parametrize("name,want", [("rustfhe_tpu_torch.ints", []), ("jax.numpy", ["jax"]),
                                       ("rustfhe_tpu.params", ["rustfhe_tpu"])])
def test_names_are_compared_whole(monkeypatch, name, want):
    before = set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, name, object())
    assert set(harness.forbidden_modules()) - before == set(want) - before


def test_run_refuses_without_a_card(tmp_path):
    """On the CPU the command exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, "-m", "fhebench.run", "--workload",
                          "gates.default.b16k", "--seed", str(2 ** 33), "--seconds", "1",
                          "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_refuses_in_a_tree_of_the_benchmark_alone(tmp_path):
    """A directory holding only BENCHMARK.json and fhebench/ has no program
    to run: the command exits non-zero and prints nothing."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.ROOT, tmp_path / "fhebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "fhebench.run", "--workload",
                          "expr.default.b1", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert Path(tmp_path / "fhebench").exists()
