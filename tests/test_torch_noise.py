"""The port's noise model (``utils/noise.py``) and the PBS margin checks
against the JAX package's: the 7 cases of ``tests/test_noise.py`` replayed
on the port, then every float of ``noise_budget``, ``calibrated_margin``,
``check_params``, ``check_pbs_space`` and ``check_pbs_many`` on the six
presets, each ``==`` to JAX's, and every message equal to JAX's.

The model is float arithmetic on the parameters; the port keeps JAX's order
of operations, so equality is exact (no tolerance).
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustfhe_tpu import params as jparams
from rustfhe_tpu import pbs as jpbs
from rustfhe_tpu.utils import noise as jnoise
from rustfhe_tpu_torch import params, pbs
from rustfhe_tpu_torch.utils import noise
from rustfhe_tpu_torch.utils.noise import check_params, noise_budget

PRESETS = ["DEFAULT_PARAMS", "FAST_PARAMS", "N2048_PARAMS", "PBS_PARAMS", "PBS_TEST_PARAMS",
           "TEST_PARAMS"]


def both(name):
    return getattr(params, name), getattr(jparams, name)


# ------------------- tests/test_noise.py, on the port ------------------- #
def test_default_params_have_margin():
    ok, msg = check_params(params.DEFAULT_PARAMS)
    assert ok, msg
    assert noise_budget(params.DEFAULT_PARAMS).margin_sigmas > 8
    assert (ok, msg) == jnoise.check_params(jparams.DEFAULT_PARAMS)


def test_fast_preset_flagged_unsound():
    b = noise_budget(params.FAST_PARAMS)
    assert 2.5 < b.margin_sigmas < 4.5, b
    ok, msg = check_params(params.FAST_PARAMS)
    assert not ok, msg
    comps = b.components()
    assert max(comps, key=comps.get) == "blind_rotate"
    assert comps == jnoise.noise_budget(jparams.FAST_PARAMS).components()


def test_other_presets_sound():
    for name in ("TEST_PARAMS", "N2048_PARAMS"):
        p, jp = both(name)
        ok, msg = check_params(p)
        assert not ok, (name, msg)
        assert "lower bound" in msg and "predicted" in msg, msg
        assert check_params(p, min_sigmas=4.0)[0], (name, msg)
        assert (ok, msg) == jnoise.check_params(jp)


def test_calibrated_margin_pairs():
    from rustfhe_tpu_torch.utils.noise import calibrated_margin

    cm_d = calibrated_margin(params.DEFAULT_PARAMS)
    assert cm_d.anchored
    assert abs(cm_d.lower_bound_sigmas - cm_d.predicted_sigmas / 1.6) < 1e-9
    cm_p = calibrated_margin(params.PBS_PARAMS)
    assert cm_p.anchored and cm_p.sigma_correction < 1.0
    assert cm_p.lower_bound_sigmas == cm_p.predicted_sigmas  # clamped at 1
    cm_u = calibrated_margin(params.N2048_PARAMS)
    assert not cm_u.anchored
    assert abs(cm_u.lower_bound_sigmas - cm_u.predicted_sigmas / 1.6) < 1e-9
    for cm, jp in ((cm_d, jparams.DEFAULT_PARAMS), (cm_p, jparams.PBS_PARAMS),
                   (cm_u, jparams.N2048_PARAMS)):
        assert dataclasses.asdict(cm) == dataclasses.asdict(jnoise.calibrated_margin(jp))


def test_default_borderline_pbs_many_gated():
    """The DEFAULT-set borderline pbs_many(space=4, t=2), a 4.2-sigma
    lower bound: the check flags it, the gate warns, and below 3 sigma
    (space 8) the public entry refuses before touching the key; with
    unsafe=True the gate is passed (the None key then fails later)."""
    p = params.DEFAULT_PARAMS
    ok, msg = pbs.check_pbs_many(p, 4, 2)
    assert not ok and "4.2" in msg, msg
    assert (ok, msg) == jpbs.check_pbs_many(jparams.DEFAULT_PARAMS, 4, 2)
    with pytest.warns(UserWarning, match="lower-bound margin"):
        pbs._gate_margin(p, 4, 2, False, "pbs_many")
    dummy_ct = torch.zeros((2, p.n + 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="lower-bound margin") as port_exc:
        pbs.pbs(None, dummy_ct, np.zeros((8,), np.uint32), space=8, params=p)
    with pytest.raises(ValueError) as jax_exc:
        jpbs.pbs(None, jnp.zeros((2, p.n + 1), jnp.uint32), jnp.zeros((8,), jnp.uint32),
                 space=8, params=jparams.DEFAULT_PARAMS)
    assert str(port_exc.value) == str(jax_exc.value)
    with pytest.raises(Exception) as exc:
        pbs.pbs(None, dummy_ct, np.zeros((8,), np.uint32), space=8, params=p, unsafe=True)
    assert "lower-bound margin" not in str(exc.value)
    with pytest.raises(ValueError, match="lower-bound margin"):
        pbs.pbs_many(None, dummy_ct, np.zeros((2, 8), np.uint32), space=8, params=p)


def test_second_calibration_anchor_recorded():
    for exp, lo, hi in ((21.5, 2.5, 3.2), (21.8, 3.1, 3.8)):
        p = params.DEFAULT_PARAMS.replace(alpha_lv1=2.0 ** -exp)
        b = noise_budget(p)
        assert lo < b.margin_sigmas < hi, (exp, b.margin_sigmas)
        ok, _ = check_params(p)
        assert not ok
        jp = jparams.DEFAULT_PARAMS.replace(alpha_lv1=2.0 ** -exp)
        assert dataclasses.asdict(b) == dataclasses.asdict(jnoise.noise_budget(jp))


def test_budget_components_positive():
    b = noise_budget(params.DEFAULT_PARAMS)
    assert all(v > 0 for v in b.components().values())
    assert abs(sum(b.components().values()) - b.sigma_total**2) < 1e-12


# --------------- every float and message, on every preset --------------- #
def test_constants_equal_jax():
    for name in ("MARGIN", "CAL_ROUNDING", "DEFAULT_SIGMA_INFLATION",
                 "WORST_CASE_SIGMA_CORRECTION"):
        assert getattr(noise, name) == getattr(jnoise, name), name
    assert (pbs.RAISE_BELOW_SIGMAS, pbs.WARN_BELOW_SIGMAS) == (
        jpbs.RAISE_BELOW_SIGMAS, jpbs.WARN_BELOW_SIGMAS)


@pytest.mark.parametrize("name", PRESETS)
def test_preset_fields_equal_jax(name):
    """The presets the corrections are keyed on, field by field."""
    p, jp = both(name)
    assert dataclasses.asdict(p) == dataclasses.asdict(jp)
    assert (p.nbit, p.bg, p.half_bg, p.decomp_mask, p.iks_t, p.iks_round, p.mu) == (
        jp.nbit, jp.bg, jp.half_bg, jp.decomp_mask, jp.iks_t, jp.iks_round, jp.mu)


@pytest.mark.parametrize("name", PRESETS)
def test_noise_budget_and_margin_equal_jax(name):
    p, jp = both(name)
    b, jb = noise_budget(p), jnoise.noise_budget(jp)
    assert dataclasses.asdict(b) == dataclasses.asdict(jb)
    assert b.components() == jb.components()
    assert noise.sigma_correction(p) == jnoise.sigma_correction(jp)
    for margin in (noise.MARGIN, 1 / 32, 1 / 64):
        for extra in (0.0, 3 * b.var_rounding):
            cm = noise.calibrated_margin(p, margin, extra_var=extra)
            jcm = jnoise.calibrated_margin(jp, margin, extra_var=extra)
            assert dataclasses.asdict(cm) == dataclasses.asdict(jcm)
            assert cm.describe() == jcm.describe()
    cal = noise.calibrate(p, 1.234e-3, 1 / 32)
    assert dataclasses.asdict(cal) == dataclasses.asdict(jnoise.calibrate(jp, 1.234e-3, 1 / 32))
    for bar in (3.0, 4.0, 5.0):
        assert check_params(p, bar) == jnoise.check_params(jp, bar)


@pytest.mark.parametrize("name", PRESETS)
def test_pbs_checks_equal_jax(name):
    p, jp = both(name)
    for space in (2, 4, 8, 16):
        if space > p.N:
            continue
        assert pbs.check_pbs_space(p, space) == jpbs.check_pbs_space(jp, space)
        for t in (1, 2, 4):
            if space * t > p.N:
                continue
            assert pbs.check_pbs_many(p, space, t) == jpbs.check_pbs_many(jp, space, t)
            cm, jcm = pbs.pbs_margin(p, space, t), jpbs.pbs_margin(jp, space, t)
            assert dataclasses.asdict(cm) == dataclasses.asdict(jcm)
            assert cm.describe() == jcm.describe()


def test_gate_messages_equal_jax():
    """The gate's warning and error texts, word for word."""
    for name, space, t in (("DEFAULT_PARAMS", 4, 2), ("TEST_PARAMS", 4, 1),
                           ("DEFAULT_PARAMS", 8, 1), ("TEST_PARAMS", 2, 4)):
        p, jp = both(name)
        got, want = [], []
        for fn, prm, out in ((pbs._gate_margin, p, got), (jpbs._gate_margin, jp, want)):
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                try:
                    fn(prm, space, t, False, "pbs_many")
                    out.append(None)
                except ValueError as e:
                    out.append(str(e))
            out.extend(str(w.message) for w in rec)
        assert got == want, (name, space, t)
        assert got != [None], (name, space, t)  # every case raises or warns


def test_corrections_keyed_on_the_port_presets():
    """The anchors key on the presets by value: the same preset built again
    from its fields is anchored; a ``replace()`` that changes a field is
    not, and gets the worst-case correction, as in JAX."""
    for name in ("FAST_PARAMS", "DEFAULT_PARAMS", "PBS_PARAMS"):
        p = getattr(params, name)
        again = params.TFHEParams(**dataclasses.asdict(p))
        assert hash(again) == hash(p) and noise.sigma_correction(again)[1]
    moved = params.PBS_PARAMS.replace(n=16)
    assert noise.sigma_correction(moved) == (noise.WORST_CASE_SIGMA_CORRECTION, False)
    assert noise.sigma_correction(moved) == jnoise.sigma_correction(
        jparams.PBS_PARAMS.replace(n=16))
    mine = {tuple(sorted(dataclasses.asdict(k).items())): v
            for k, v in noise._preset_corrections().items()}
    ref = {tuple(sorted(dataclasses.asdict(k).items())): v
           for k, v in jnoise._preset_corrections().items()}
    assert mine == ref
