"""Wide table lookups: each request is one programmable bootstrap of
``lanes`` encrypted values in [0, space), each lane through a table of its
own: ``lut`` sends ``TFHE.apply_lut`` with the row's first table (t = 1),
``luts2`` sends ``TFHE.apply_luts`` with both of the row's tables (t = 2,
PBSmanyLUT: one blind rotation for the two).

Mix parameters: ``ops`` (one of each per block), ``lanes``, ``space``,
``pool`` (encrypted input sets, each with its own tables (lanes, 2,
space), drawn from the seed and kept on the device as a server keeps a
model's tables), ``check`` (the capture of sampled lookups, as radix).
An op is one lane of one request: one value through its row's table or
tables, one blind rotation either way.
"""

from __future__ import annotations

import torch

from fhebench import checks, harness
from fhebench.reference import tfhe as ref
from fhebench.traffic import _common

TABLES = 2  # a row's tables: ``luts2`` reads both, ``lut`` the first


class Traffic:
    probes = (
        {"target": "rustfhe_tpu_torch.pbs:pbs", "kind": "pbs", "ct": 1, "table": 2},
        {"target": "rustfhe_tpu_torch.pbs:pbs_many", "kind": "pbs_many", "ct": 1, "table": 2},
    )

    def __init__(self, run):
        self.run = run
        mix = run.mix
        self.kinds = list(mix["ops"])
        self.block = len(self.kinds)
        self.lanes, self.space, pool = int(mix["lanes"]), int(mix["space"]), int(mix["pool"])
        self.values = torch.randint(0, self.space, (pool, self.lanes), generator=run.gen,
                                    device=run.device)
        self.tables = torch.randint(0, self.space, (pool, self.lanes, TABLES, self.space),
                                    generator=run.gen, device=run.device)
        self.cts = ref.encrypt(run.gen, run.keys.s0, ref.encode_int(self.values, self.space),
                               run.rp.alpha_lv0)
        self.schedule = _common.Schedule(run.rng, self.kinds, pool)

    def warm(self):
        return [(k, 0) for k in self.kinds]

    def request(self, i):
        return self.schedule(i)

    def send(self, req):
        op, k = req
        ctx = self.run.ctx
        if op == "lut":
            out = ctx.apply_lut(self.cts[k], self.tables[k][:, 0], self.space)
        else:
            out = ctx.apply_luts(self.cts[k], self.tables[k], self.space)
        harness.sync(self.run.device)
        return out

    def units(self, req) -> int:
        return self.lanes

    def judge(self, run):
        """Every output of the window decrypted and held to its row's
        table entries at the row's value, then the captured rows' words."""
        s0 = run.keys.s0
        rows = torch.arange(self.lanes, device=self.values.device)
        wrong = failed = 0
        for r in run.records:
            op, k = r.req
            t = 1 if op == "lut" else TABLES
            got = ref.decrypt_int(r.out.reshape(self.lanes, t, -1), s0, self.space)
            want = self.tables[k][rows, :t, self.values[k]]  # (lanes, t)
            bad = int((got != want).sum())
            wrong += bad
            failed += bad > 0
        words, _ = checks.captured_words(run)
        return {"wrong_outputs": (wrong, 0), "wrong_words": (words, 0)}, failed
