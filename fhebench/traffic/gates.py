"""Wide gate levels: each request is one context gate on ``lanes`` lanes.

Mix parameters: ``gates`` (the kinds, one of each per block), ``lanes``,
``pool`` (encrypted input sets, each three bit batches: x, y and the MUX's
third input), ``check.requests`` and ``check.lanes`` (the sample the
reference recomputes word for word).  A MUX counts as one gate.
"""

from __future__ import annotations

import numpy as np
import torch

from fhebench import harness
from fhebench.reference import tfhe as ref
from fhebench.reference import truth
from fhebench.traffic import _common

METHOD = {"nand": "nand", "and": "and_", "or": "or_", "xor": "xor", "not": "not_", "mux": "mux"}
ARITY = {"not": 1, "mux": 3}


class Traffic:
    probes = ({"target": "rustfhe_tpu_torch.context:TFHE.bootstrap_raw", "kind": "gate", "ct": 1},)

    def __init__(self, run):
        self.run = run
        mix = run.mix
        self.kinds = list(mix["gates"])
        self.block = len(self.kinds)
        self.lanes = int(mix["lanes"])
        self.bits = ref.bits(run.gen, (mix["pool"], 3, self.lanes), run.device)
        self.cts = _common.encrypt_bits(run, self.bits)  # (pool, 3, lanes, n+1)
        self.schedule = _common.Schedule(run.rng, self.kinds, mix["pool"])

    def warm(self):
        """One gate of each arity: the two-input gates differ only in their
        pre-combination's constants, so one of them warms every shape."""
        first = {ARITY.get(k, 2): k for k in reversed(self.kinds)}
        return [(k, 0) for k in first.values()]

    def request(self, i):
        return self.schedule(i)

    def send(self, req):
        op, k = req
        out = getattr(self.run.ctx, METHOD[op])(*self.cts[k][:ARITY.get(op, 2)])
        harness.sync(self.run.device)
        return out

    def units(self, req) -> int:
        return self.lanes

    def judge(self, run):
        s0 = run.keys.s0
        bits = self.bits.cpu().numpy()
        wrong = failed = 0
        for r in run.records:
            op, k = r.req
            bad = int((ref.decrypt_bits(r.out, s0).cpu().numpy() != truth.gate(op, *bits[k])).sum())
            wrong += bad
            failed += bad > 0
        return {"wrong_outputs": (wrong, 0), "wrong_words": (self._words(run), 0)}, failed

    def _words(self, run) -> int:
        """Recompute the sampled lanes of sampled requests from the inputs:
        every first pass in one reference bootstrap, the MUXes' second
        pass in another."""
        chk = run.mix["check"]
        picks = run.rng.choice(len(run.records), min(chk["requests"], len(run.records)),
                               replace=False)
        rp, keys = run.rp, run.keys
        pre, entries, offset = [], [], 0  # entries: (op, offset in pre, lanes, program's rows)
        for j in sorted(picks):
            op, k = run.records[j].req
            lanes = torch.as_tensor(np.sort(run.rng.choice(self.lanes, chk["lanes"], replace=False)),
                                    device=run.device)
            x, y, z = (self.cts[k][a][lanes] for a in range(3))
            if op == "mux":
                rows = [ref.precombine("and", x, z, rp), ref.precombine("andn", x, y, rp)]
            else:
                rows = [ref.precombine(op, x, y if op != "not" else None, rp)]
            pre.extend(rows)
            entries.append((op, offset, len(lanes), run.records[j].out[lanes]))
            offset += len(rows) * len(lanes)
        first = ref.gate_bootstrap(torch.cat(pre), keys, rp)
        mux = [(o, n) for op, o, n, _ in entries if op == "mux"]
        if mux:
            second = ref.gate_bootstrap(torch.cat([
                ref.precombine("or", first[o:o + n], first[o + n:o + 2 * n], rp) for o, n in mux]),
                keys, rp)
        wrong = pos = 0
        for op, o, n, got in entries:
            if op == "mux":
                want, pos = second[pos:pos + n], pos + n
            else:
                want = first[o:o + n]
            wrong += int((want != got).sum())
        return wrong
