"""Analytic noise-budget model for gate bootstrapping parameter sets.

Counterpart of ``rustfhe_tpu/utils/noise.py``, copied rather than imported
(importing the JAX package imports jax).  It is float arithmetic on the
parameters, in the JAX module's order of operations, so that every float
and every message string is equal to JAX's (``tests/test_torch_noise.py``).

``noise_budget(params)`` returns the per-stage error variances of one
bootstrapped gate and the decision margin in sigmas; ``check_params``
turns that into a pass/warn verdict.  Model (standard TFHE analysis,
variances of torus-valued errors in [0, 1)):

* fresh gate input: two lv0 ciphertexts summed -> 2 * alpha_lv0^2;
* blind-rotate phase rounding to 2N buckets: (n+1) * 2^(-2*(nbit+2)) / 3;
* per CMux step: the key's noise 2 * l * N * (Bg/2)^2 * alpha_lv1^2 (the
  worst-case digit magnitude) plus the gadget rounding
  CAL_ROUNDING * (1 + N) * eps^2, eps = 2^-(l*bgbit), over n steps;
* identity key switch: N * iks_l * alpha_lv0^2 plus the dropped digits
  N * 2^(-2*(iks_basebit*iks_l + 1)) / 3.

A gate decodes right while the phase error stays below 1/16.

The model carries the calibration anchors that the JAX package measured
on its own runs (its module docstring gives each one): CAL_ROUNDING fitted
to FAST_PARAMS' failure rate (anchor 1), the 1.6x optimism of the model at
DEFAULT_PARAMS (anchor 3) and its 2.7x conservatism at PBS_PARAMS (anchor
4).  They are noise statistics of the parameter sets, the same on any
exact engine; none of them is a measurement of this package.  Each anchor
is keyed on the port's own preset objects (``_preset_corrections``), which
hash and compare by their fields, as the JAX presets do; a set built with
``replace()`` that differs from every preset is unanchored and gets the
worst-case correction.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..params import TFHEParams

MARGIN = 1.0 / 16.0

# Fitted to anchor 1 (FAST: 12/8192 ~ 3 sigma).
CAL_ROUNDING = 2.5

# Anchor 3: measured/predicted output sigma at the DEFAULT set (1.08e-2 /
# 6.9e-3 ~= 1.6); calibrated_margin() below is the per-preset form.
DEFAULT_SIGMA_INFLATION = 1.6


def _preset_corrections():
    """Measured true-sigma multipliers (measured / predicted output sigma),
    keyed by the anchor presets.  >1: the model was optimistic there (the
    unsafe direction); <1: conservative (real headroom)."""
    from ..params import DEFAULT_PARAMS, FAST_PARAMS, PBS_PARAMS

    return {
        FAST_PARAMS: 1.0,  # anchor 1: CAL_ROUNDING fitted on this axis
        DEFAULT_PARAMS: DEFAULT_SIGMA_INFLATION,  # anchor 3: 1.08e-2/6.9e-3
        PBS_PARAMS: 7.5e-4 / 2.02e-3,  # anchor 4: ~2.7x conservative
    }


#: Correction applied to UNMEASURED parameter sets: the worst bias
#: direction measured (anchor 3's 1.6x optimism).
WORST_CASE_SIGMA_CORRECTION = DEFAULT_SIGMA_INFLATION


def sigma_correction(params: TFHEParams) -> tuple[float, bool]:
    """(true-sigma multiplier, anchored?) for ``params``.

    Anchored presets get their measured correction; anything else gets the
    worst measured direction (a margin quoted through this is a lower
    bound, never a best case)."""
    corr = _preset_corrections().get(params)
    if corr is not None:
        return corr, True
    return WORST_CASE_SIGMA_CORRECTION, False


@dataclass(frozen=True)
class CalibratedMargin:
    """A decision margin stated both ways.

    ``predicted_sigmas``: the uncorrected analytic model's margin.
    ``lower_bound_sigmas``: the margin after applying the preset's measured
    sigma correction in the unsafe direction only: corrections < 1 (the
    model measured conservative, e.g. PBS_PARAMS) are clamped to 1.  This
    is the number every verdict gates on.
    """

    predicted_sigmas: float
    lower_bound_sigmas: float
    sigma_predicted: float
    sigma_correction: float
    anchored: bool

    def describe(self) -> str:
        src = "anchored" if self.anchored else "worst-case (unmeasured set)"
        return (
            f"margin {self.lower_bound_sigmas:.1f} sigma lower bound "
            f"(predicted {self.predicted_sigmas:.1f} sigma, "
            f"sigma={self.sigma_predicted:.2e}, "
            f"correction x{self.sigma_correction:.2f} {src})"
        )


def calibrate(params: TFHEParams, sigma_predicted: float,
              decision_margin: float) -> CalibratedMargin:
    """Apply the preset's measured correction to an already-modeled sigma
    (custom variance models, e.g. radix carry sums, enter here)."""
    corr, anchored = sigma_correction(params)
    return CalibratedMargin(
        predicted_sigmas=decision_margin / sigma_predicted,
        lower_bound_sigmas=decision_margin / (sigma_predicted * max(corr, 1.0)),
        sigma_predicted=sigma_predicted,
        sigma_correction=corr,
        anchored=anchored,
    )


def calibrated_margin(params: TFHEParams, decision_margin: float = MARGIN,
                      extra_var: float = 0.0) -> CalibratedMargin:
    """Calibrated (predicted, lower-bound) margin pair for a decision
    half-width ``decision_margin`` (1/16 for gates, 1/(4*space) for PBS),
    with ``extra_var`` added to the modeled phase variance (e.g. the
    pbs_many t^2 drift excess)."""
    nb = noise_budget(params)
    sigma = math.sqrt(nb.sigma_total**2 + extra_var)
    return calibrate(params, sigma, decision_margin)


@dataclass(frozen=True)
class NoiseBudget:
    var_fresh: float
    var_rounding: float
    var_bootstrap: float  # accumulated over the n CMux steps
    var_keyswitch: float
    sigma_total: float
    margin_sigmas: float

    def components(self) -> dict:
        return {
            "fresh_inputs": self.var_fresh,
            "phase_rounding": self.var_rounding,
            "blind_rotate": self.var_bootstrap,
            "key_switch": self.var_keyswitch,
        }


def noise_budget(params: TFHEParams) -> NoiseBudget:
    p = params
    var_fresh = 2.0 * p.alpha_lv0**2
    var_rounding = (p.n + 1) * (2.0 ** (-2 * (p.nbit + 2))) / 3.0

    eps = 2.0 ** -(p.l * p.bgbit)  # uncentered: biased quirky-mask rounding
    var_step = (
        2.0 * p.l * p.N * (p.bg / 2.0) ** 2 * p.alpha_lv1**2
        + CAL_ROUNDING * (1.0 + p.N) * eps**2
    )
    var_bootstrap = p.n * var_step

    var_ks = (
        p.N * p.iks_l * p.alpha_lv0**2
        + p.N * (2.0 ** (-2 * (p.iks_basebit * p.iks_l + 1))) / 3.0
    )

    sigma = math.sqrt(var_fresh + var_rounding + var_bootstrap + var_ks)
    return NoiseBudget(
        var_fresh=var_fresh,
        var_rounding=var_rounding,
        var_bootstrap=var_bootstrap,
        var_keyswitch=var_ks,
        sigma_total=sigma,
        margin_sigmas=MARGIN / sigma,
    )


def check_params(params: TFHEParams, min_sigmas: float = 5.0) -> tuple[bool, str]:
    """(ok, message): ok iff the decode margin's calibrated lower bound
    exceeds ``min_sigmas``.

    5 sigma ~= 3e-7 per-gate failure.  The bound applies the preset's
    measured sigma correction in the unsafe direction only
    (``calibrated_margin``): FAST_PARAMS scores 3.0 sigma here, DEFAULT's
    predicted 9.1 sigma is stated as 5.7, and PBS_PARAMS (measured
    conservative) keeps its uncorrected prediction as the bound."""
    b = noise_budget(params)
    cm = calibrated_margin(params)
    dominant = max(b.components(), key=lambda k: b.components()[k])
    msg = f"{cm.describe()}; dominant term: {dominant}"
    return cm.lower_bound_sigmas >= min_sigmas, msg
