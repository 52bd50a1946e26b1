"""The comparisons that decide ``correct``, and the control.

Two numbers, each an exact comparison with the limit 0:

* ``wrong_outputs``: outputs of the window's requests, every one of them,
  whose decryption under the benchmark's secret key differs from the
  cleartext answer (``reference.truth``);
* ``wrong_words``: 32-bit words that differ between the program's output
  and the reference's for a seed-drawn sample of rows.  Generators whose
  requests are single gates recompute the sampled lanes from the
  benchmark's own ciphertexts; the others hold each sampled bootstrap of
  the timed path (``hooks.Capture``) to the reference's bootstrap of the
  same input rows.

The control (``control``) puts the reference, computed in float32, in the
program's place at the generator's probes: its products are not exact, and
it has to come out as not correct.
"""

from __future__ import annotations

import torch

from .hooks import tables_rows
from .reference import tfhe as ref


def captured_words(run, dtype=torch.float64) -> tuple[int, int]:
    """(wrong words, words compared) over the captured rows: each group of
    rows with the same extraction count and key-switch flag is one
    reference rotation."""
    rp, keys, dev = run.rp, run.keys, run.keys.s0.device
    groups: dict[tuple[int, bool], list] = {}
    for it in run.capture.items:
        ct = it.ct.to(dev)
        if it.kind in ("gate", "gate_lv1"):
            t, switch, tv = 1, it.kind == "gate", ref.gate_testvec(rp, ct.shape[0], dev)
        else:
            t, switch = it.tables.shape[1], True
            tv = ref.lut_testvec(it.tables.to(dev), it.space, rp, it.raw)
            ct = ref.pbs_input(ct, it.space, t, rp)
        groups.setdefault((t, switch), []).append((ct, tv, it.out.to(dev)))
    wrong = total = 0
    for (t, switch), rows in groups.items():
        want = ref.bootstrap_rows(torch.cat([r[0] for r in rows]), torch.cat([r[1] for r in rows]),
                                  keys, rp, t, switch, dtype)
        got = torch.cat([r[2] for r in rows])
        wrong += int((want != got).sum())
        total += got.numel()
    return wrong, total


def control(run, patches) -> None:
    """Replace each of the generator's probes by the reference in float32."""
    rp, keys = run.rp, run.keys

    def replacement(probe):
        def fn(*args, **kwargs):
            ct = args[probe["ct"]]
            lead, width = ct.shape[:-1], ct.shape[-1]
            rows = ct.reshape(-1, width)
            if probe["kind"] in ("gate", "gate_lv1"):
                out = ref.gate_bootstrap(rows, keys, rp, torch.float32, probe["kind"] == "gate")
                return out.reshape(tuple(lead) + (out.shape[-1],))
            tabs = tables_rows(probe, args, lead).to(ct.device)
            out = ref.pbs(rows, tabs, kwargs["space"], bool(kwargs.get("raw", False)), keys, rp,
                          torch.float32)
            tail = out.shape[-1:] if probe["kind"] == "pbs" else out.shape[-2:]
            return out.reshape(tuple(lead) + tuple(tail))
        return fn

    torch.backends.cuda.matmul.allow_tf32 = False
    for probe in run.traffic.probes:
        patches.replace(probe["target"], lambda _orig, probe=probe: replacement(probe))
