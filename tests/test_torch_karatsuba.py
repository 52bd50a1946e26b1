"""The port's Karatsuba step (``engine/karatsuba.py``), its probe wrappers
P4, P8, P1, P2 (``engine/karatsuba_probe.py``) and their entry points
(``rustfhe_tpu_torch/benches``), against the JAX package.

Everything here is word for word (tolerance zero).  The residue layout,
the tree, the rotation and the leaf table are held to
``rustfhe_tpu/engine/pallas_k.py``; the plain step to
``fused_cmux_step_k(levels=2)`` in interpret mode and to the port's K1
through ``scan_exit``; every wrapper's plain version, form by form, to
the JAX probe's own Pallas kernel in interpret mode.  The probe scripts of
``benches/`` are loaded as they are: ``sys.argv`` is set, ``PRESET`` unset
and the module's ``P``, ``B`` and ``TB`` set (``monkeypatch`` restores
them), and ``pl.pallas_call`` runs in interpret mode.  The fast cases run
at N=512, so that the leaf size ns=128 equals the probes' panel depth,
with l=1 so that each interpret-mode kernel compiles within seconds; the
slow ones at DEFAULT_PARAMS (N=1024, l=3).  The CUDA kernels are held to
the plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import functools
import importlib.util
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rustfhe_tpu.engine import pallas_k as jk
from rustfhe_tpu.engine.pallas_k import PallasKaratsubaEngine, fused_cmux_step_k
from rustfhe_tpu.engine.pallas_step import build_panels_doubling
from rustfhe_tpu.params import DEFAULT_PARAMS as J_DEFAULT
from rustfhe_tpu_torch import _u32, params, poly
from rustfhe_tpu_torch.benches import (coissue_probe, k2_floor_probe, karatsuba2_probe,
                                       vpu_reduce_probe)
from rustfhe_tpu_torch.engine import cmux_k, plain
from rustfhe_tpu_torch.engine import karatsuba as ka
from rustfhe_tpu_torch.engine import karatsuba_probe as kp

BENCHES = pathlib.Path(__file__).resolve().parents[1] / "benches"
B = 16  # two tiles of tb=8
TB = 8
FAST = dict(N=512, l=1)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _jp(N, l):
    return J_DEFAULT.replace(N=N, l=l)


def _p(N, l):
    return params.DEFAULT_PARAMS.replace(N=N, l=l)


def _load_probe(name, monkeypatch, N, l):
    """benches/<name>.py as a fresh module: batch B, tile TB, preset cut to (N, l)."""
    monkeypatch.setattr(sys, "argv", ["probe", str(B)])
    monkeypatch.delenv("PRESET", raising=False)
    monkeypatch.setattr(sys, "dont_write_bytecode", True)
    monkeypatch.setattr(sys, "path", list(sys.path))  # the probes insert "."
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", BENCHES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.B == B
    mod.P, mod.TB = _jp(N, l), TB
    return mod, mod.P


def _inputs(seed, N, l, b=B, a_cols=1):
    """Residue-layout acc (with edge words), a~ (with the edge rotations 0,
    1, N, 2N-1), random rows and random JAX-layout table bytes."""
    rs = np.random.RandomState(seed)
    rows = rs.randint(0, 2**32, size=(2 * l, 2, N), dtype=np.uint64).astype(np.uint32)
    acc = rs.randint(0, 2**32, size=(b, 2 * N), dtype=np.uint64).astype(np.uint32)
    acc[0, :5] = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
    ai = rs.randint(0, 2 * N, size=(b, a_cols)).astype(np.int32)
    ai[:4, 0] = [0, 1, N, 2 * N - 1]
    qd = rs.randint(-128, 128, size=(2, 2 * l * 4 * 9, N // 2)).astype(np.int8)
    return rows, acc, ai, qd


def _t(acc, ai, qd):
    return (_u32.from_numpy(acc), torch.from_numpy(np.ascontiguousarray(ai)),
            ka.table_from_qd(torch.from_numpy(qd)))


# --------------------------------------------------------------------- #
# The pieces against pallas_k.py
# --------------------------------------------------------------------- #
def test_tree_planes_and_combine_match_jax():
    rs = np.random.RandomState(1)
    for n in (1, 2, 4):
        res = [rs.randint(-32, 32, size=(3, 16)).astype(np.int32) for _ in range(n)]
        want = jk.tree_planes([jnp.asarray(x) for x in res], lambda a, b: a + b)
        got = ka.tree_planes([torch.from_numpy(x) for x in res], lambda a, b: a + b)
        assert len(got) == 3 ** (n.bit_length() - 1)
        assert all(np.array_equal(g.numpy(), np.asarray(w)) for g, w in zip(got, want))
        ms = [rs.randint(0, 2**32, size=(3, 16), dtype=np.uint64).astype(np.uint32)
              for _ in range(len(want))]
        want = jk.tree_combine([jnp.asarray(x) for x in ms], lambda v: jk._shiftz1_u32(v, 16))
        got = ka.tree_combine([_u32.from_numpy(x) for x in ms], ka.shiftz1)
        assert len(got) == n
        assert all(np.array_equal(_u32.to_numpy(g), np.asarray(w)) for g, w in zip(got, want))
    m = rs.randint(-2**24, 2**24, size=(2, 16)).astype(np.int32)
    assert np.array_equal(ka.shiftz1(torch.from_numpy(m)).numpy(),
                          np.asarray(jk._shiftz1_i32(jnp.asarray(m), 16)))


def test_scan_layout_matches_jax():
    N = 64
    eng = PallasKaratsubaEngine(levels=2)
    acc = np.random.RandomState(2).randint(0, 2**32, size=(3, 2, N), dtype=np.uint64)
    acc = acc.astype(np.uint32)
    flat = ka.scan_enter(_u32.from_numpy(acc))
    assert np.array_equal(_u32.to_numpy(flat), np.asarray(eng.scan_enter(jnp.asarray(acc),
                                                                         _jp(N, 3))))
    assert np.array_equal(_u32.to_numpy(ka.scan_exit(flat)), acc)


@pytest.mark.parametrize("N", [64, 256])
def test_residue_rotation_matches_jax_for_every_a(N):
    # every a~ in [0, 2N), one sample each
    rs = np.random.RandomState(3)
    x = rs.randint(0, 2**32, size=(2 * N, 2 * N), dtype=np.uint64).astype(np.uint32)
    a = np.arange(2 * N, dtype=np.int32)
    got = ka.rotate_res(_u32.from_numpy(x), torch.from_numpy(a))
    want = jk._rotate_res_inkernel(jnp.asarray(x), jnp.asarray(a)[:, None], N // 4, 2)
    assert np.array_equal(_u32.to_numpy(got), np.asarray(want))
    # the standard index gives the same words (the kernels' way)
    std = poly.rotate(ka.scan_exit(_u32.from_numpy(x)), torch.from_numpy(a)[:, None])
    assert torch.equal(ka.scan_enter(std), got)


@pytest.mark.parametrize("N,l", [(64, 3), (512, 1), (1024, 3)])
def test_leaf_table_matches_prepare_trgsw_and_prepare_k2(N, l, monkeypatch):
    rows = np.random.RandomState(4).randint(0, 2**32, size=(2 * l, 2, N), dtype=np.uint64)
    rows = rows.astype(np.uint32)
    rows[0, 0, :5] = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
    jp = _jp(N, l)
    qd = np.array(PallasKaratsubaEngine(levels=2).prepare_trgsw(jnp.asarray(rows), jp))
    mod, _ = _load_probe("karatsuba2_probe", monkeypatch, N, l)
    assert np.array_equal(np.asarray(mod.prepare_k2(jnp.asarray(rows), jp)), qd)  # P1's builder
    got = ka.prepare_table(_u32.from_numpy(rows))
    assert got.dtype == torch.int8 and got.is_contiguous()
    assert got.shape == ka.table_shape(_p(N, l))
    assert torch.equal(got, ka.table_from_qd(torch.from_numpy(qd)))


def test_table_from_qd_moves_random_bytes():
    N, l = 64, 3
    _, _, _, qd = _inputs(5, N, l)
    got = ka.table_from_qd(torch.from_numpy(qd)).numpy()
    ns = N // 4
    c, t, k, j, x = np.meshgrid(*(np.arange(n) for n in got.shape), indexing="ij")
    assert np.array_equal(got, qd[c, (j * 4 + k) * 9 + t, (x - ns) % (2 * ns)])
    with pytest.raises(ValueError):
        ka.table_from_qd(torch.from_numpy(qd[:1]))
    with pytest.raises(ValueError):
        ka.table_from_qd(torch.from_numpy(qd[:, :30]))
    with pytest.raises(ValueError):
        ka.table_from_qd(torch.from_numpy(qd).to(torch.int32))


@pytest.mark.parametrize("N,l", [(256, 3), (1024, 3), (512, 2)])
def test_plain_step_equals_k1_through_the_scan_layout(N, l):
    p = _p(N, l)
    rows, acc, ai, _ = _inputs(6, N, l)
    t_rows, t_ai = _u32.from_numpy(rows), torch.from_numpy(ai[:, 0].copy())
    std = ka.scan_exit(_u32.from_numpy(acc))
    want = cmux_k.cmux_step_plain(std, t_ai, plain.prepare_trgsw(t_rows), p)
    table = ka.prepare_table(t_rows)
    flat = ka.scan_enter(std)
    forms = [f for f in kp.FORMS if f.exact]  # P4 full, P8's exact forms, P1, both P2 orders
    assert len(forms) == 8
    for form in forms:
        got = ka.step_plain(flat, t_ai, table, p, form)
        assert torch.equal(ka.scan_exit(got), want), form


def test_plain_step_matches_fused_cmux_step_k(interpret):
    N, l = FAST["N"], FAST["l"]
    jp, p = _jp(N, l), _p(N, l)
    rows, acc, ai, _ = _inputs(7, N, l)
    prep = PallasKaratsubaEngine(levels=2).prepare_trgsw(jnp.asarray(rows), jp)
    panels = build_panels_doubling(prep, N // 4, 128)
    want = fused_cmux_step_k(jnp.asarray(acc), jnp.asarray(ai[:, 0]), panels, params=jp,
                             levels=2, tb=TB, interpret=True)
    t_acc, t_ai = _u32.from_numpy(acc), torch.from_numpy(ai[:, 0].copy())
    got = ka.step_plain(t_acc, t_ai, ka.prepare_table(_u32.from_numpy(rows)), p)
    assert np.array_equal(_u32.to_numpy(got), np.asarray(want))


# --------------------------------------------------------------------- #
# Every wrapper's plain version against the JAX probe kernels (interpret)
# --------------------------------------------------------------------- #
def _panels(qd, N):
    return build_panels_doubling(jnp.asarray(qd), N // 4, 128)


def _check_p4(monkeypatch, N, l, variant, tm=128):
    mod, _ = _load_probe("k2_floor_probe", monkeypatch, N, l)
    _, acc, ai, qd = _inputs(8, N, l)
    want = np.asarray(mod.make_step(_panels(qd, N), jnp.asarray(ai), variant)(jnp.asarray(acc)))
    before = kp.step_ablate.launches
    got = kp.step_ablate(*_t(acc, ai[:, 0], qd), _p(N, l), variant, tm)
    assert kp.step_ablate.launches == before  # the plain version launches nothing
    assert np.array_equal(_u32.to_numpy(got), want), variant


@pytest.mark.parametrize("variant", list(kp.ABLATIONS))
def test_step_ablate_matches_k2_floor_probe(variant, interpret, monkeypatch):
    _check_p4(monkeypatch, FAST["N"], FAST["l"], variant)


# P8's forms: the JAX script's keywords (vpu_reduce_probe.py:253-301) -> the port's.
P8_FORMS = {
    "leaf_u32": {}, "limb_outer": dict(leaf_combine=False), "int16": dict(planes16=True),
    "shift": dict(extract_shift=True), "int16+shift": dict(planes16=True, extract_shift=True),
    "sar": dict(extract_sar=True), "skip_rotate": dict(skip_rotate=True),
    "skip_rotate+sar": dict(skip_rotate=True, extract_sar=True),
}


def _check_p8(monkeypatch, N, l, name):
    mod, jp = _load_probe("vpu_reduce_probe", monkeypatch, N, l)
    _, acc, ai, qd = _inputs(9, N, l, a_cols=2)
    panels = _panels(qd, N)
    t_acc, t_ai, table = _t(acc, ai, qd)
    if name == "unroll2":  # the same table twice, as the JAX script times it
        want = mod.step_var(jnp.asarray(acc), jnp.asarray(ai), jnp.stack([panels, panels]),
                            params=jp, tb=TB, unroll=2)
        got = kp.step_var(t_acc, t_ai, torch.stack([table, table]), _p(N, l), unroll=2)
        one = kp.step_var(t_acc, t_ai[:, 0].contiguous(), table, _p(N, l))
        assert torch.equal(got, kp.step_var(one, t_ai[:, 1].contiguous(), table, _p(N, l)))
    else:
        kw = P8_FORMS[name]
        want = mod.step_var(jnp.asarray(acc), jnp.asarray(ai[:, 0]), panels, params=jp, tb=TB,
                            **kw)
        got = kp.step_var(t_acc, t_ai[:, 0].contiguous(), table, _p(N, l), **kp.VAR_FORMS[name])
    assert np.array_equal(_u32.to_numpy(got), np.asarray(want)), name


@pytest.mark.parametrize("name", list(kp.VAR_FORMS) + ["unroll2"])
def test_step_var_matches_vpu_reduce_probe(name, interpret, monkeypatch):
    _check_p8(monkeypatch, FAST["N"], FAST["l"], name)


def _check_p1(monkeypatch, N, l):
    mod, jp = _load_probe("karatsuba2_probe", monkeypatch, N, l)
    _, acc, ai, qd = _inputs(11, N, l)
    want = mod.step_k2(jnp.asarray(acc), jnp.asarray(ai[:, 0]), _panels(qd, N), params=jp, tb=TB,
                       tm=128)
    got = kp.step_k2(*_t(acc, ai[:, 0], qd), _p(N, l))
    assert np.array_equal(_u32.to_numpy(got), np.asarray(want))
    # P1 is P8's limb-outer form
    assert torch.equal(got, kp.step_var(*_t(acc, ai[:, 0], qd), _p(N, l), leaf_combine=False))


def test_step_k2_matches_karatsuba2_probe(interpret, monkeypatch):
    _check_p1(monkeypatch, FAST["N"], FAST["l"])


def _check_p2(monkeypatch, N, l, grouped):
    mod, _ = _load_probe("coissue_probe", monkeypatch, N, l)
    _, acc, ai, qd = _inputs(12, N, l)
    want = mod.make_split(_panels(qd, N), jnp.asarray(ai[:, 0]), TB, grouped)(jnp.asarray(acc))
    got = kp.step_split(*_t(acc, ai[:, 0], qd), _p(N, l), grouped)
    assert np.array_equal(_u32.to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("grouped", [False, True])
def test_step_split_matches_coissue_probe(grouped, interpret, monkeypatch):
    _check_p2(monkeypatch, FAST["N"], FAST["l"], grouped)


DEFAULT_CASES = ([("P4", v) for v in kp.ABLATIONS]
                 + [("P8", n) for n in list(kp.VAR_FORMS) + ["unroll2"]]
                 + [("P1", None), ("P2", False), ("P2", True)])


@pytest.mark.slow
@pytest.mark.parametrize("probe,form", DEFAULT_CASES)
def test_probes_match_jax_at_default_params(probe, form, interpret, monkeypatch):
    N, l = 1024, 3
    if probe == "P4":
        _check_p4(monkeypatch, N, l, form)
    elif probe == "P8":
        _check_p8(monkeypatch, N, l, form)
    elif probe == "P1":
        _check_p1(monkeypatch, N, l)
    else:
        _check_p2(monkeypatch, N, l, form)


def test_nodots_depends_on_tm_as_specified():
    N, l = 256, 3
    p = _p(N, l)
    _, acc, ai, qd = _inputs(13, N, l, b=4)
    t_acc, t_ai, table = _t(acc, ai[:, 0], qd)
    ns = N // 4
    tree = ka.step_digits(t_acc, t_ai, p, ka.Step())  # (B, T, 2L, ns)
    L = table.to(torch.int64)
    for tm in (16, 32, 64):
        part = torch.zeros((4, 9, 2, 4, ns), dtype=torch.int64)
        for j in range(2 * l):
            for i in range(0, ns, tm):
                w = L[:, :, :, j, torch.arange(ns) - i + ns]  # (c, t, k, n)
                part += tree[:, :, j, i][:, :, None, None, None] + w.transpose(0, 1)[None]
        leaves = [sum(part[:, t, :, k] << (8 * k) for k in range(4)) for t in range(9)]
        outs = torch.stack(ka.tree_combine(leaves, ka.shiftz1), dim=2).reshape(4, 2 * N)
        want = _u32.wrap(t_acc.to(torch.int64) + outs)
        assert torch.equal(kp.step_ablate(t_acc, t_ai, table, p, "nodots", tm=tm), want), tm


# --------------------------------------------------------------------- #
# The wrappers check their operands
# --------------------------------------------------------------------- #
def test_wrapper_checks():
    N, l = 128, 3
    p = _p(N, l)
    _, acc, ai, qd = _inputs(14, N, l, b=4)
    t_acc, t_ai, table = _t(acc, ai[:, 0], qd)
    with pytest.raises(ValueError, match="unknown variant"):
        kp.step_ablate(t_acc, t_ai, table, p, "wide")
    with pytest.raises(ValueError, match="must divide"):
        kp.step_ablate(t_acc, t_ai, table, p, "nodots", tm=24)
    with pytest.raises(TypeError):
        kp.step_k2(t_acc, t_ai.to(torch.int64), table, p)
    with pytest.raises(TypeError):
        kp.step_split(t_acc, t_ai, table.to(torch.int32), p)
    with pytest.raises(ValueError, match="must have shape"):
        kp.step_var(t_acc, t_ai, table[:, :8].contiguous(), p)
    with pytest.raises(ValueError, match="must have shape"):
        kp.step_ablate(t_acc.reshape(4, 2, N), t_ai, table, p)
    with pytest.raises(ValueError, match="must have shape"):  # unroll=2 takes (B, 2) and two tables
        kp.step_var(t_acc, t_ai, table, p, unroll=2)
    with pytest.raises(ValueError, match="unroll"):
        kp.step_var(t_acc, t_ai, table, p, unroll=3)
    with pytest.raises(ValueError, match="no form"):  # a form the entry points do not run
        kp.step_var(t_acc, t_ai, table, p, leaf_combine=False, planes=16)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        kp.step_k2(t_acc.to("meta"), t_ai.to("meta"), table.to("meta"), p)
    big = params.TFHEParams(n=8, N=1 << 16, l=4, bgbit=6)  # 2L*ns*128*128 = 2^31
    with pytest.raises(ValueError, match="2\\^31"):
        ka.check_bound(big)
    with pytest.raises(ValueError, match="int8"):  # half_bg * 4 = 512 digit sums
        ka.check_bound(params.FAST_PARAMS)
    with pytest.raises(ValueError, match="int8"):
        kp.step_k2(t_acc, t_ai, table, params.FAST_PARAMS.replace(N=N, l=l))


def test_form_codes_are_distinct_and_exactness_is_labelled():
    codes = {kp.form_code(f) for f in kp.FORMS}
    assert len(codes) == len(kp.FORMS) == 17
    assert kp.form_code(ka.Step()) == 0 and kp.form_code(kp.ABLATIONS["accio"]) == 1 << 12
    assert {n for n, f in kp.ABLATIONS.items() if f.exact} == {"full"}
    assert kp.var_form(extract="sar") == kp.ABLATIONS["full"]
    assert not kp.var_form(skip_rotate=True).exact and kp.K2_FORM.exact


def test_smem_budget_at_default_params():
    # one half's leaf table + the tile's digit trees + one sample's leaves
    assert kp.smem_bytes(params.DEFAULT_PARAMS) == 110592 + 110592 + 9216 <= 232448


# --------------------------------------------------------------------- #
# The entry points
# --------------------------------------------------------------------- #
def test_entry_points_parse_the_jax_scripts_arguments(monkeypatch):
    monkeypatch.delenv("PRESET", raising=False)
    assert k2_floor_probe.parse([]) == (8192, tuple(kp.ABLATIONS))
    assert k2_floor_probe.parse(["64", "nodots", "full"]) == (64, ("full", "nodots"))
    with pytest.raises(SystemExit, match="unknown variant"):
        k2_floor_probe.parse(["64", "wide"])
    for mod in (vpu_reduce_probe, karatsuba2_probe, coissue_probe):
        assert mod.parse([]) == 8192 and mod.parse(["256"]) == 256
    assert k2_floor_probe.MACS_FULL == 50331648 == vpu_reduce_probe.MACS_FULL


def test_k2_floor_probe_refuses_pbs(monkeypatch):
    monkeypatch.setenv("PRESET", "pbs")
    with pytest.raises(ValueError, match="bytes of shared memory"):
        k2_floor_probe.parse([])


def test_entry_points_refuse_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("PRESET", raising=False)
    for mod in (k2_floor_probe, vpu_reduce_probe, karatsuba2_probe, coissue_probe):
        with pytest.raises(SystemExit, match="need a CUDA device"):
            mod.main(["64"])


def test_entry_point_cases_run_their_plain_versions():
    # The control flow of the four probes at a small batch on the CPU: every
    # case's step maps its input to the next input, and the exact lines agree.
    cpu = torch.device("cpu")
    c4 = k2_floor_probe.cases(16, tuple(kp.ABLATIONS), cpu)
    assert [c.name for c in c4] == list(kp.ABLATIONS)
    outs = {c.name: c.step(c.x0) for c in c4}
    assert all(o.shape == (16, 2048) and o.dtype == torch.int32 for o in outs.values())
    lines = [x for x in vpu_reduce_probe.cases(16, cpu) if not isinstance(x, str)]
    exact = [c for c in lines if "inexact" not in c.name and "unroll2" not in c.name
             and "k1 " not in c.name]
    x1 = [c.step(c.x0) for c in exact]
    assert len(exact) == 7 and all(torch.equal(x, x1[0]) for x in x1)
    u2 = next(c for c in lines if "unroll2" in c.name)
    assert u2.steps_per_call == 2 and torch.equal(u2.step(u2.x0), exact[0].step(x1[0]))
    notes = [x for x in karatsuba2_probe.cases(16, cpu) if isinstance(x, str)]
    assert any("tm=256" in n and "no Hopper counterpart" in n for n in notes)
    split = [x for x in coissue_probe.cases(16, cpu) if not isinstance(x, str)]
    assert [c.name for c in split][:3] == ["baseline (Karatsuba step)", "split-serial (2x4)",
                                          "split-grouped (2x4)"]
    assert all(torch.equal(c.step(c.x0), split[0].step(split[0].x0)) for c in split)
