"""Short encrypted vectors: each request is one ``FheUint`` operator on
``lanes`` lanes of ``width``-bit integers (``rustfhe_tpu_torch.ints``).

Mix parameters: ``ops`` (one of each per block: add, sub, lt, eq, min,
select), ``lanes``, ``width``, ``pool`` (encrypted operand sets a, b and a
select bit c), ``check`` (the capture of sampled bootstraps: ``share`` of
calls, ``rows`` a call, ``cap`` rows in all).  An integer op is one lane of
one operator.
"""

from __future__ import annotations

import torch

from fhebench import checks, harness
from fhebench.reference import tfhe as ref
from fhebench.reference import truth
from fhebench.traffic import _common


class Traffic:
    probes = ({"target": "rustfhe_tpu_torch.context:TFHE.bootstrap_raw", "kind": "gate", "ct": 1},)

    def __init__(self, run):
        from rustfhe_tpu_torch.ints import FheUint

        self.run, self.FheUint = run, FheUint
        mix = run.mix
        self.kinds = list(mix["ops"])
        self.block = len(self.kinds)
        self.lanes, self.width, pool = int(mix["lanes"]), int(mix["width"]), int(mix["pool"])
        g, dev = run.gen, run.device
        self.values = torch.randint(0, 1 << self.width, (pool, 2, self.lanes), generator=g,
                                    device=dev)
        self.cond = ref.bits(g, (pool, self.lanes), dev)
        self.cts = _common.encrypt_bits(run, _common.split(self.values, self.width, 1))
        self.cond_cts = _common.encrypt_bits(run, self.cond)
        self.schedule = _common.Schedule(run.rng, self.kinds, pool)

    def warm(self):
        return [(k, 0) for k in self.kinds]

    def request(self, i):
        return self.schedule(i)

    def send(self, req):
        op, k = req
        a, b = (self.FheUint(self.run.ctx, self.cts[k, j]) for j in range(2))
        if op == "add":
            out = (a + b).bits
        elif op == "sub":
            out = (a - b).bits
        elif op == "lt":
            out = a.lt(b)
        elif op == "eq":
            out = a.eq(b)
        elif op == "min":
            out = a.min_(b).bits
        else:
            out = a.select(self.cond_cts[k], b).bits
        harness.sync(self.run.device)
        return out

    def units(self, req) -> int:
        return self.lanes

    def judge(self, run):
        s0 = run.keys.s0
        values, cond = self.values.cpu().numpy(), self.cond.cpu().numpy()
        wrong = failed = 0
        for r in run.records:
            op, k = r.req
            got = ref.decrypt_bits(r.out, s0).cpu().numpy()
            if got.ndim == 2:
                got = _common.join(got, 1)
            want = truth.uint_op(op, values[k, 0], values[k, 1], cond[k], self.width)
            bad = int((got != want).sum())
            wrong += bad
            failed += bad > 0
        words, _ = checks.captured_words(run)
        return {"wrong_outputs": (wrong, 0), "wrong_words": (words, 0)}, failed
