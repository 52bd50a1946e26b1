"""The port's studies (``rustfhe_tpu_torch/benches``, the JAX package's
``benches/`` scripts) on the CPU: every check that runs on any device, at
small sizes, on the kernels' plain versions, and the numbers that do not
need a card held to JAX's.

* every key-switch form equal to ``identity_key_switch`` at TEST_PARAMS;
* the transform-domain product equal to the oracle;
* the optimizer arms' levels and lanes equal to JAX's on the same circuits;
* ``step_var`` at unroll 4 equal to four single steps, and the prebuilt
  pieces equal to the step;
* K1 and P4 exact against the composed "matmul" step;
* the noise presets' predicted margins and P_fail equal to JAX's floats;
* each study's ``run`` refusing without a card (``_timing.require_cuda``).
"""

import importlib
import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

from rustfhe_tpu import native as jnative
from rustfhe_tpu.apps import circuits as JC
from rustfhe_tpu.params import DEFAULT_PARAMS as JDEFAULT
from rustfhe_tpu.utils.noise import noise_budget as jnoise_budget
from rustfhe_tpu_torch import params
from rustfhe_tpu_torch.benches import (keyswitch_probe, karatsuba_probe, n2048_probe,
                                       noise_calibration_probe, nuss_transform_probe,
                                       optimizer_probe, unroll_probe)
from rustfhe_tpu_torch.engine import karatsuba_probe as kp
from rustfhe_tpu_torch.benches.k2_floor_probe import draw_step

STUDIES = ("multibit_probe", "keyswitch_probe", "latency_probe", "repl_latency_probe",
           "pipeline_repl_probe", "unroll_probe", "hybrid_unroll_probe", "n2048_probe",
           "nuss_transform_probe", "noise_calibration_probe", "optimizer_probe",
           "adder_ab_probe", "karatsuba_probe", "kernels")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def ks_forms():
    return keyswitch_probe.setup(128, params.TEST_PARAMS, CPU)


@pytest.mark.parametrize("form", keyswitch_probe.CHECKED)
def test_key_switch_form_equals_identity_key_switch(ks_forms, form):
    forms, ct = ks_forms
    small = ct[: keyswitch_probe.CHECK_ROWS]
    got = (forms.dot_only(small, forms.onehot(forms.digits(small))) if form == "dot_only"
           else getattr(forms, form)(small))
    assert got.dtype == torch.int32
    assert torch.equal(got, forms.current(small))


def test_key_switch_check_and_chained_forms(ks_forms):
    forms, ct = ks_forms
    lines = []
    keyswitch_probe.check(forms, ct, lines.append)
    assert "equal to identity_key_switch" in lines[0]
    p = params.TEST_PARAMS
    for case in keyswitch_probe.cases(forms, ct):  # each chain maps (B, N+1) to (B, N+1)
        assert case.step(case.x0).shape == (ct.shape[0], p.N + 1)
    assert forms.ksk8t.shape[0] % 256 == 0 and forms.cols == (p.n + 1) * 4


def test_nuss_exactness_equals_the_oracle():
    lines = []
    nuss_transform_probe.exactness(CPU, lines.append)
    assert "exact against the oracle: True" in lines[0]


def _load_jax(name):
    path = pathlib.Path(__file__).resolve().parents[1] / "benches" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_plan(circuit, on: bool):
    """(gates, levels, lanes) of JAX's evaluate_encrypted on ``circuit``:
    the optimized, folded lowering or the JAX probe's unfolded one."""
    if on:
        c, lowered = JC.optimize(circuit), JC.lower_folded
    else:
        c, lowered = circuit, _load_jax("optimizer_probe").lower_unfolded
    coeff, in_a, in_b, out_w, n_wires, _, _ = lowered(c)
    n = len(out_w)
    inputs3 = np.stack([in_a, in_b, np.full(n, -1, np.int64)], axis=1)
    levels, depth = jnative.levelize(n, n_wires, c.n_inputs, inputs3, out_w)
    lanes = sum(JC._bucket(int((levels == lv).sum())) for lv in range(1, depth + 1))
    return len(c.gates), depth, lanes


@pytest.mark.parametrize("on", [True, False])
@pytest.mark.parametrize("case", [0, 1])
def test_optimizer_arms_plan_like_jax(case, on):
    name, circ = optimizer_probe.cases()[case]
    jcirc = (JC.prefix_comparator(16), JC.comparator(8))[case]
    assert optimizer_probe.plan(circ, on) == _jax_plan(jcirc, on), name


def test_optimizer_arm_swaps_and_restores():
    from rustfhe_tpu_torch.apps import circuits as C

    orig = C.optimize, C.lower_folded
    with pytest.raises(RuntimeError):
        with optimizer_probe.arm(False):
            assert C.lower_folded is optimizer_probe.lower_unfolded
            raise RuntimeError
    assert (C.optimize, C.lower_folded) == orig


def test_step_var_unroll4_equals_four_single_steps():
    p = params.DEFAULT_PARAMS.replace(N=256)
    flat, a_t, table, _, _ = draw_step(np.random.RandomState(3), 4, CPU, p)
    a4, tabs = unroll_probe.stacked(a_t, table, 4, p)
    want = flat
    for s in range(4):
        want = kp.step_var(want, a4[:, s].contiguous(), table, p)
    assert torch.equal(kp.step_var(flat, a4, tabs, p, unroll=4), want)


def test_unroll_probe_checks():
    lines = []
    unroll_probe.checks(CPU, params.DEFAULT_PARAMS.replace(N=256), B=4, out=lines.append)
    assert lines and lines[0].startswith("# exact on cpu")


def test_k1_and_p4_exact_against_the_composed_step():
    lines = []
    n2048_probe.checks(CPU, params.N2048_PARAMS.replace(N=256), rows_n=4, out=lines.append)
    karatsuba_probe.checks(CPU, params.DEFAULT_PARAMS, rows_n=4, out=lines.append)
    assert len(lines) == 3 and all("exact" in line for line in lines)


@pytest.mark.parametrize("preset", range(len(noise_calibration_probe.PRESETS)))
def test_noise_predictions_equal_jax(preset):
    tag, p = noise_calibration_probe.PRESETS[preset]
    jp = JDEFAULT.replace(alpha_lv1=p.alpha_lv1)
    margin = jnoise_budget(jp).margin_sigmas
    p_fail = 0.5 * math.erfc(margin / math.sqrt(2))
    B = noise_calibration_probe.DEFAULT_B
    assert noise_calibration_probe.predict(p, B) == (margin, p_fail, p_fail * B), tag


@pytest.mark.parametrize("name", STUDIES)
def test_study_refuses_without_a_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"rustfhe_tpu_torch.benches.{name}")
    with pytest.raises(SystemExit, match="need a CUDA device"):
        mod.run()
