"""The ``luts`` generator on a CPU stand-in of ``luts.pbs.b16k`` (n = 16,
N = 256, the test parameters of PBS): a stand-in root made as
``standin.make_root`` makes the others, with this cell written beside them.

The program reads 0 wrong outputs and 0 wrong words; one table entry of
one row changed in the program's call, and the float32 control, do not
read correct.  A traced run reads 1.5 lookups a rotation from the
program's spans, whose ``pbs.prepare`` and ``extract`` lie in the window;
the device readers read nothing on the CPU, and the readers of the
program's spans read nothing from a program without a tracer.
"""

from __future__ import annotations

import pytest
import torch

from fhebench import checks, harness
from fhebench.tests import standin
from fhebench.tests.test_fhebench_program import forget_the_switch

CELL = "luts.pbs.b16k"
MIX = {"lanes": 4, "pool": 2, "check": {"share": 0.5, "rows": 2, "cap": 32}}
DEVICE = ("rotate_roofline.radix", "keyswitch_share_pct.luts", "device_idle_pct.radix")
PROGRAM = ("keyswitch_share_pct.luts", "lookups_per_rotation.luts")


def test_the_cells_configuration_is_the_pbs_set_as_it_is():
    """The deployment's file holds every ``TFHEParams`` field of the port's
    ``PBS_PARAMS`` and of ``pbs-n714-N2048``'s file unchanged, cuts nothing
    and names a source of its own."""
    import dataclasses

    from rustfhe_tpu_torch import params

    bench = harness.load_json(harness.BENCHMARK)
    name = next(w for w in bench["workloads"] if w["name"] == CELL)["config"]
    cfg = harness.load_json(harness.ROOT / "configs" / f"{name}.json")
    base = harness.load_json(harness.ROOT / "configs" / "pbs-n714-N2048.json")
    for f in dataclasses.fields(params.PBS_PARAMS):
        assert cfg[f.name] == base[f.name] == getattr(params.PBS_PARAMS, f.name), f.name
    assert cfg["reduced"] == [] and cfg["source"] != base["source"]


def make_root(tmp):
    """``standin.make_root``'s root and benchmark, with this cell's
    stand-in: the real mix at ``MIX``'s sizes on the ``tiny-pbs``
    configuration."""
    root, bench = standin.make_root(tmp)
    entry = next(w for w in harness.load_json(harness.BENCHMARK)["workloads"]
                 if w["name"] == CELL)
    real = harness.load_json(harness.ROOT / "traffic" / f"{entry['traffic']}.json")
    standin.write(root / "traffic" / "luts_tiny.json", {**real, **MIX})
    settings = harness.load_json(harness.ROOT / "workloads" / f"{CELL}.json")
    standin.write(root / "workloads" / f"{CELL}.json",
                  {**settings, "config": "tiny-pbs", "traffic": "luts_tiny",
                   "profile_seconds": 0.2})
    cell = {**entry, "config": "tiny-pbs", "traffic": "luts_tiny"}
    return root, {**bench, "workloads": bench["workloads"] + [cell]}


def run(tmp, seed=7, trace_on=False, tamper=None):
    root, bench = make_root(tmp)
    return harness.run_cell(CELL, seed, 0.0, trace_on, "cpu", bench=bench, root=root,
                            tamper=tamper, log=lambda msg: None)


def wrong_table_entry(run, patches):
    """Row 0's table entry at row 0's own value, changed in what the
    program is given (every table of the row for ``apply_luts``); the
    generator's tables, which the judge and the capture read, stay as
    they are."""
    traffic = run.traffic

    def make(fn):
        def wrapper(ck, ct, table, **kwargs):
            k = next(i for i in range(len(traffic.cts)) if torch.equal(ct, traffic.cts[i]))
            x = int(traffic.values[k, 0])
            table = table.clone()
            table[0, ..., x] = (table[0, ..., x] + 1) % traffic.space
            return fn(ck, ct, table, **kwargs)
        return wrapper

    for probe in traffic.probes:
        patches.replace(probe["target"], make)


def test_the_program_reads_correct(tmp_path):
    held = []
    res = run(tmp_path, seed=2 ** 31 + 26, tamper=lambda r, p: held.append(r))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] == 2
    assert {k: c["value"] for k, c in res["checks"].items()} == {"wrong_outputs": 0,
                                                                "wrong_words": 0}
    assert sorted(r.req[0] for r in held[0].records) == ["lut", "luts2"]
    assert held[0].units() == 2 * MIX["lanes"]
    kinds = {it.kind for it in held[0].capture.items}
    assert kinds and kinds <= {"pbs", "pbs_many"}
    assert checks.captured_words(held[0])[1] > 0


@pytest.mark.parametrize("tamper", [wrong_table_entry, checks.control],
                         ids=["wrong_table_entry", "control"])
def test_a_fault_and_the_control_are_not_correct(tmp_path, tamper):
    res = run(tmp_path, seed=5, tamper=tamper)
    assert not res["correct"], res["checks"]


def test_the_wrong_table_entry_shows_in_every_output_it_reaches(tmp_path):
    """Every request reads row 0 through the changed entry: each output
    of row 0 decodes wrong, and no other does."""
    res = run(tmp_path, seed=6, tamper=wrong_table_entry)
    assert res["checks"]["wrong_outputs"]["value"] == 1 + 2  # lut: 1 table, luts2: 2
    assert res["failed"] == 2


@pytest.fixture
def fresh_switch():
    """The tracer as in a process of its own (``test_fhebench_program``)."""
    forget_the_switch()
    yield
    forget_the_switch()


def test_the_traced_run_reads_the_programs_spans(tmp_path, fresh_switch, monkeypatch):
    held = []
    res = run(tmp_path, seed=2 ** 33 + 26, trace_on=True, tamper=lambda r, p: held.append(r))
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert m["lookups_per_rotation.luts"] == {"value": 1.5, "unit": "lookups/rotation"}
    for name in DEVICE:  # no device operation on the CPU
        assert name not in m, name
    from fhebench.metrics import _program

    r = held[0]
    recs = _program.records(r)
    pbs = {x.id: x for x in recs if x.name == "pbs"}
    half = len(r.records) // 2  # whole blocks of one request of each kind
    assert sorted(x.attrs["tables"] for x in pbs.values()) == [1] * half + [2] * half
    lanes = MIX["lanes"]
    for name in ("pbs.prepare", "extract", "blind_rotate", "key_switch"):
        got = [x for x in recs if x.name == name]
        assert sorted(x.parent for x in got) == sorted(pbs), name
        for x in got:
            t = pbs[x.parent].attrs["tables"]
            want = {"pbs.prepare": {"rows": lanes, "tv_rows": lanes, "t": t},
                    "extract": {"rows": lanes, "t": t},
                    "key_switch": {"rows": lanes * t}}.get(name)
            if want:
                assert x.attrs == want, name
            else:
                assert (x.attrs["rows"], x.attrs["tv_rows"]) == (lanes, lanes)
    monkeypatch.setattr(_program, "tracer", None)  # a program from before its tracer
    for name in PROGRAM:
        assert harness.load_module(harness.ROOT / "metrics" / f"{name}.py").read(r) is None
