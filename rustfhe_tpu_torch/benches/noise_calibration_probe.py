"""The noise model against counted failures on the card.

Counterpart of ``benches/noise_calibration_probe.py``.  The analytic model
(``utils.noise.noise_budget``) predicts the decode margin in sigmas, the
one-sided failure rate P_fail = Phi(-margin) and so the expected wrong
decodes in a batch of B.  Two deliberately marginal presets raise alpha_lv1
until the blind-rotate variance, 2*l*N*(Bg/2)^2*alpha_lv1^2 a step, sets
the margin near 3-4 sigma; DEFAULT_PARAMS is the control.  For each, a
NAND batch of B runs on the card through K1 (the port's engines are exact,
so every wrong decode is noise), and the wrong decodes are counted beside
the prediction.

The control must decode all right.  A marginal preset with more than half
its batch wrong is a broken kernel, not noise, and fails the check.
Otherwise the counts are measurements, not gates.  Each preset's keys come
from a fresh ``torch.Generator`` seeded 42; the inputs from numpy seed 3.
Timing: the host clock around keygen and the batch, the card synchronised.

Usage: python -m rustfhe_tpu_torch.benches.noise_calibration_probe [B]
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from .. import gates, keys, tlwe
from ..engine import select_engine
from ..params import DEFAULT_PARAMS, TFHEParams
from ..utils.noise import noise_budget
from . import _timing

DEFAULT_B = 131072
PRESETS = (
    ("alpha_lv1=2^-21.5", DEFAULT_PARAMS.replace(alpha_lv1=2.0 ** -21.5)),
    ("alpha_lv1=2^-21.8", DEFAULT_PARAMS.replace(alpha_lv1=2.0 ** -21.8)),
    ("default (control)", DEFAULT_PARAMS),
)
CONTROL = PRESETS[-1][0]


def predict(params: TFHEParams, B: int) -> tuple[float, float, float]:
    """(margin in sigmas, P_fail, expected wrong decodes in B)."""
    margin = noise_budget(params).margin_sigmas
    p_fail = 0.5 * math.erfc(margin / math.sqrt(2))
    return margin, p_fail, p_fail * B


def run_preset(tag: str, params: TFHEParams, B: int, device, out=print) -> tuple[int, float]:
    """(wrong decodes, expected) of one preset's NAND batch at B."""
    margin, p_fail, expect = predict(params, B)
    out(f"[{tag}] predicted margin {margin:.2f} sigma, P_fail {p_fail:.2e}, "
        f"expected {expect:.1f}/{B}")
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(42)
    eng = select_engine(params, device)
    sk, ck = keys.gen_keys(gen, params, device, eng)
    rs = np.random.RandomState(3)
    bx, by = (torch.from_numpy(rs.randint(0, 2, size=B).astype(np.int32)).to(device)
              for _ in range(2))
    cx, cy = (tlwe.encrypt_binary(gen, sk.lv0, b, params) for b in (bx, by))
    before = _timing.rotation_launches()
    out_ct = gates.hom_bootstrap(ck, gates.precombine("nand", cx, cy, params=params),
                                 params=params, engine_name=eng)
    bad = int((tlwe.decrypt_binary(out_ct, sk.lv0) != 1 - (bx & by)).sum())
    dt = time.perf_counter() - t0
    ratio = bad / expect if expect > 0 else float("inf")
    out(f"[{tag}] MEASURED {bad}/{B} wrong decodes (predicted {expect:.1f}; measured/predicted "
        f"= {ratio:.2f}; keygen+run {dt:.1f} s; {eng}: {_timing.ran(before)})")
    if tag == CONTROL and bad:
        raise AssertionError(f"the control preset decoded {bad}/{B} wrong")
    if bad > B // 2:
        raise AssertionError(f"[{tag}] {bad}/{B} wrong: a broken kernel, not noise")
    return bad, expect


def run(B: int = DEFAULT_B, out=print) -> dict[str, tuple[int, float]]:
    """Every preset at batch B on the card; {preset: (wrong, expected)}."""
    device = _timing.require_cuda()
    out(f"# noise calibration on {_timing.card()}  B={B}")
    return {tag: run_preset(tag, p, B, device, out) for tag, p in PRESETS}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    run(int(argv[0]) if argv else DEFAULT_B)
    return 0


if __name__ == "__main__":
    sys.exit(main())
