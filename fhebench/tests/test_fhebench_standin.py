"""A new cell, configuration, traffic generator, mix and metric are found by
name: files written into a fresh root run through the unchanged harness."""

from __future__ import annotations

from fhebench import harness
from fhebench.tests import standin

GENERATOR = '''
from fhebench.reference import tfhe as ref
from fhebench.traffic import _common


class Traffic:
    """A stand-in kind: NOT gates on a few lanes."""

    probes = ({"target": "rustfhe_tpu_torch.context:TFHE.bootstrap_raw", "kind": "gate", "ct": 1},)
    block = 1

    def __init__(self, run):
        self.run = run
        self.bits = ref.bits(run.gen, (run.mix["lanes"],), run.device)
        self.cts = _common.encrypt_bits(run, self.bits)

    def warm(self):
        return [0]

    def request(self, i):
        return i

    def send(self, req):
        return self.run.ctx.not_(self.cts)

    def units(self, req):
        return len(self.bits)

    def judge(self, run):
        want = 1 - self.bits
        bad = sum(int((ref.decrypt_bits(r.out, run.keys.s0) != want).sum()) for r in run.records)
        return {"wrong_outputs": (bad, 0)}, 0
'''

METRIC = '''
def read(run):
    return float(len(run.records))
'''


def test_new_files_are_found_by_name(tmp_path):
    root, bench = standin.make_root(tmp_path)
    standin.write(root / "configs" / "stand-in.json", standin.TINY)
    (root / "traffic" / "notgates.py").write_text(GENERATOR)
    standin.write(root / "traffic" / "not_x4.json", {"generator": "notgates", "lanes": 4})
    entry = {"name": "not.stand-in.x4", "config": "stand-in", "traffic": "not_x4", "chips": 1,
             "why": "a stand-in"}
    standin.write(root / "workloads" / "not.stand-in.x4.json", {**entry, "profile_seconds": 0.1})
    (root / "metrics" / "requests_seen.py").write_text(METRIC)
    bench = {**bench, "workloads": bench["workloads"] + [entry],
             "per_layer": bench["per_layer"] + [
                 {"name": "requests_seen", "unit": "requests", "better": "higher",
                  "source": "host_clock", "layer": "stand-in", "moves": "setup_s",
                  "workloads": ["not.stand-in.x4"]}]}
    res = harness.run_cell("not.stand-in.x4", 5, 0.0, True, "cpu", bench=bench, root=root,
                           log=lambda m: None)
    assert res["correct"] and res["metrics"]["requests_seen"]["value"] == res["attempted"] >= 2
    res = harness.run_cell("not.stand-in.x4", 5, 0.0, False, "cpu", bench=bench, root=root,
                           log=lambda m: None)
    assert set(res["metrics"]) == {"setup_s"}
