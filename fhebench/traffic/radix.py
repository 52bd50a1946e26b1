"""Radix-PBS integer vectors: each request is one ``RadixUint`` operator on
``lanes`` lanes of ``digits`` 2-bit digits (``rustfhe_tpu_torch.radix``).

Mix parameters: ``ops`` (one of each per block: add, sub, lt, min),
``lanes``, ``digits``, ``pool`` (encrypted operand pairs), ``check`` (the
capture of sampled lookups and gate bootstraps: ``share`` of calls,
``rows`` a call, ``cap`` rows in all).  An integer op is one lane of one
operator.  A digit's ciphertext encodes it at space 8 (one padding bit,
one carry bit); its value is the decoded bucket mod 4.
"""

from __future__ import annotations

import torch

from fhebench import checks, harness
from fhebench.reference import tfhe as ref
from fhebench.reference import truth
from fhebench.traffic import _common

SPACE = 8
DIGIT_BITS = 2


class Traffic:
    probes = (
        {"target": "rustfhe_tpu_torch.pbs:pbs", "kind": "pbs", "ct": 1, "table": 2},
        {"target": "rustfhe_tpu_torch.pbs:pbs_many", "kind": "pbs_many", "ct": 1, "table": 2},
        {"target": "rustfhe_tpu_torch.context:TFHE.bootstrap_raw", "kind": "gate", "ct": 1},
    )

    def __init__(self, run):
        from rustfhe_tpu_torch.radix import RadixUint

        self.run, self.RadixUint = run, RadixUint
        mix = run.mix
        self.kinds = list(mix["ops"])
        self.block = len(self.kinds)
        self.lanes, self.digits, pool = int(mix["lanes"]), int(mix["digits"]), int(mix["pool"])
        self.width = DIGIT_BITS * self.digits
        self.values = torch.randint(0, 1 << self.width, (pool, 2, self.lanes), generator=run.gen,
                                    device=run.device)
        digs = _common.split(self.values, self.digits, DIGIT_BITS)
        self.cts = ref.encrypt(run.gen, run.keys.s0, ref.encode_int(digs, SPACE), run.rp.alpha_lv0)
        self.schedule = _common.Schedule(run.rng, self.kinds, pool)

    def warm(self):
        return [(k, 0) for k in self.kinds]

    def request(self, i):
        return self.schedule(i)

    def send(self, req):
        op, k = req
        a, b = (self.RadixUint(self.run.ctx, self.cts[k, j]) for j in range(2))
        if op == "add":
            out = (a + b).digits
        elif op == "sub":
            out = (a - b).digits
        elif op == "lt":
            out = a.lt(b)
        else:
            out = a.min_(b).digits
        harness.sync(self.run.device)
        return out

    def units(self, req) -> int:
        return self.lanes

    def judge(self, run):
        s0 = run.keys.s0
        values = self.values.cpu().numpy()
        wrong = failed = 0
        for r in run.records:
            op, k = r.req
            if op == "lt":
                got = ref.decrypt_bits(r.out, s0).cpu().numpy()
            else:
                digs = ref.decrypt_int(r.out, s0, SPACE).cpu().numpy() % (1 << DIGIT_BITS)
                got = _common.join(digs, DIGIT_BITS)
            want = truth.uint_op(op, values[k, 0], values[k, 1], None, self.width)
            bad = int((got != want).sum())
            wrong += bad
            failed += bad > 0
        words, _ = checks.captured_words(run)
        return {"wrong_outputs": (wrong, 0), "wrong_words": (words, 0)}, failed
