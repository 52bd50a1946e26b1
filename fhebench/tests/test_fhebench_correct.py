"""``correct`` on the stand-in cells: true for the program as it is, false
for the control (the reference in float32 in the program's place) and for
each fault a cell can have, planted under the timed path:

* ``step_unchanged``: a blind-rotation step returns its state unchanged
  (K1's step and K3's whole rotation);
* ``half_batch``: half of each bootstrap's rows left out, the first half's
  outputs copied into their place;
* ``answer_altered``: one output row of each bootstrap negated where it is
  produced, which flips the bit or digit it carries.

There is one chip here, so no exchange between chips can be left out.
Each stand-in runs its warm-up and one block of requests (``seconds`` 0).
"""

from __future__ import annotations

import pytest
import torch

from fhebench import checks
from fhebench.tests import standin

CELLS = list(standin.CELLS)


def step_unchanged(run, patches):
    patches.replace("rustfhe_tpu_torch.engine.cmux_k:cmux_step",
                    lambda fn: lambda acc, *a, **k: acc)
    patches.replace("rustfhe_tpu_torch.engine.rotate_all_k:rotate_all",
                    lambda fn: lambda acc, *a, **k: acc)


def _each_probe(run, patches, change):
    for probe in run.traffic.probes:
        def make(fn, probe=probe):
            def wrapper(*args, **kwargs):
                return change(fn(*args, **kwargs), args[probe["ct"]])
            return wrapper
        patches.replace(probe["target"], make)


def half_batch(run, patches):
    def change(out, ct):
        flat = out.reshape((-1,) + tuple(out.shape[ct.dim() - 1:]))
        h = (flat.shape[0] + 1) // 2
        if flat.shape[0] > 1:
            flat[h:] = flat[: flat.shape[0] - h]
        return out
    _each_probe(run, patches, change)


def answer_altered(run, patches):
    def change(out, ct):
        out = out.clone()
        out.reshape((-1,) + tuple(out.shape[ct.dim() - 1:]))[0] *= -1
        return out
    _each_probe(run, patches, change)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(tmp_path, cell):
    res = standin.run(tmp_path, cell, seed=2 ** 31 + 12345)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res["checks"]) == ["wrong_outputs", "wrong_words"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tmp_path, cell):
    res = standin.run(tmp_path, cell, seed=3, tamper=checks.control)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", [step_unchanged, half_batch, answer_altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_faults_are_not_correct(tmp_path, cell, fault):
    res = standin.run(tmp_path, cell, seed=4, tamper=fault)
    assert not res["correct"], res["checks"]


def test_the_words_compared_are_many(tmp_path):
    """The capture keeps rows of the timed path's bootstraps for the word
    comparison."""
    root, bench = standin.make_root(tmp_path)
    from fhebench import harness

    seen = {}

    def keep(run, patches):
        seen["run"] = run

    harness.run_cell("uint8.default.x32", 9, 0.0, False, "cpu", bench=bench, root=root,
                     tamper=keep, log=lambda m: None)
    wrong, compared = checks.captured_words(seen["run"])
    assert wrong == 0 and compared >= 4 * 17
    assert torch.is_tensor(seen["run"].capture.items[0].ct)
