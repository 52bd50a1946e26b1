"""The port's Karatsuba step (``engine/karatsuba.py``), its probe wrappers
P4, P8, P1, P2, P3 (``engine/karatsuba_probe.py``), the pieces of their
kernels (tree digits, leaf panels, leaves, combine) and their entry points
(``rustfhe_tpu_torch/benches``), against the JAX package.

Everything here is word for word (tolerance zero).  The residue layout,
the tree, the rotation and the leaf table are held to
``rustfhe_tpu/engine/pallas_k.py``; the plain step to
``fused_cmux_step_k(levels=2)`` in interpret mode and to the port's K1
through ``scan_exit``; every wrapper's plain version, form by form, to
the JAX probe's own Pallas kernel in interpret mode, and so is the
composition of the pieces' plain versions, which equals ``step_plain`` for
every form at N = 64, 256, 1024.  The probe scripts of
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
from rustfhe_tpu_torch.benches import (coissue2_probe, coissue_probe, k2_floor_probe,
                                       karatsuba2_probe, vpu_reduce_probe)
from rustfhe_tpu_torch.engine import cmux_k, limb_step, plain
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


def _composed(acc, a_tilde, table, p, form, tm=kp.TM):
    """The four pieces' plain versions in the kernels' order: tree digits,
    leaf panels, leaves, combine."""
    if form.accio:
        return kp.step_ablate(acc, a_tilde, table, p, "accio", tm)
    digits = kp.tree_digits_plain(acc, a_tilde, p, form)
    leaves = kp.leaves_plain(digits, kp.leaf_panel_plain(table, p), table, p, form, tm)
    return kp.combine_plain(acc, leaves, p, form)


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
    forms = [f for f in kp.FORMS if f.exact]  # P4 full, P8's exact forms, P1, P2's and P3's two
    assert len(forms) == 10
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
    composed = _composed(*_t(acc, ai[:, 0], qd), _p(N, l), kp.ABLATIONS[variant], tm)
    assert np.array_equal(_u32.to_numpy(composed), want), variant


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
        composed = _composed(t_acc, t_ai[:, 0].contiguous(), table, _p(N, l),
                             kp.var_form(**kp.VAR_FORMS[name]))
        assert np.array_equal(_u32.to_numpy(composed), np.asarray(want)), name
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
    composed = _composed(*_t(acc, ai[:, 0], qd), _p(N, l), kp.K2_FORM)
    assert np.array_equal(_u32.to_numpy(composed), np.asarray(want))
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
    form = ka.Step(extract="mul", split=kp.SPLITS[grouped])
    assert np.array_equal(_u32.to_numpy(_composed(*_t(acc, ai[:, 0], qd), _p(N, l), form)),
                          np.asarray(want))


@pytest.mark.parametrize("grouped", [False, True])
def test_step_split_matches_coissue_probe(grouped, interpret, monkeypatch):
    _check_p2(monkeypatch, FAST["N"], FAST["l"], grouped)


def _check_p3(monkeypatch, N, l, pipelined, tm=128, b=B):
    mod, jp = _load_probe("coissue2_probe", monkeypatch, N, l)
    _, acc, ai, qd = _inputs(15, N, l, b=b)
    panels = build_panels_doubling(jnp.asarray(qd), N // 4, tm)
    want = mod.step_coissue(jnp.asarray(acc), jnp.asarray(ai[:, 0]), panels, params=jp, tb=TB,
                            tm=tm, pipelined=pipelined)
    before = kp.step_coissue.launches
    got = kp.step_coissue(*_t(acc, ai[:, 0], qd), _p(N, l), pipelined)
    assert kp.step_coissue.launches == before  # the plain version launches nothing
    assert np.array_equal(_u32.to_numpy(got), np.asarray(want))
    form = kp.COISSUE_FORMS[kp.BUILDS[pipelined]]
    assert np.array_equal(_u32.to_numpy(_composed(*_t(acc, ai[:, 0], qd), _p(N, l), form, tm)),
                          np.asarray(want))
    # B and C compute P8's leaf-first multiply-extract step (its baseline A)
    assert torch.equal(got, kp.step_var(*_t(acc, ai[:, 0], qd), _p(N, l)))


@pytest.mark.parametrize("pipelined", [False, True])
def test_step_coissue_matches_coissue2_probe(pipelined, interpret, monkeypatch):
    # N=256 (ns=64, the TPU panel depth cut to 64) and one tile: a few
    # seconds in interpret mode
    _check_p3(monkeypatch, 256, 1, pipelined, tm=64, b=TB)


DEFAULT_CASES = ([("P4", v) for v in kp.ABLATIONS]
                 + [("P8", n) for n in list(kp.VAR_FORMS) + ["unroll2"]]
                 + [("P1", None), ("P2", False), ("P2", True), ("P3", False), ("P3", True)])


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
    elif probe == "P2":
        _check_p2(monkeypatch, N, l, form)
    else:
        _check_p3(monkeypatch, N, l, form)


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
# The pieces of the kernels: their plain versions, composed, are step_plain
# --------------------------------------------------------------------- #
PIECE_FORMS = [(f"{probe}-{label}", form) for probe, label, _, _, form in kp.calls()]


@pytest.mark.parametrize("N", [64, 256, 1024])
@pytest.mark.parametrize("name,form", PIECE_FORMS, ids=[n for n, _ in PIECE_FORMS])
def test_pieces_compose_to_step_plain(name, form, N):
    # tree digits -> leaf panels -> leaves -> combine, every form; on the CPU
    # each wrapper runs the plain version (and launches nothing)
    p = _p(N, 3)
    _, acc, ai, qd = _inputs(16, N, 3, b=5)
    t_acc, t_ai, table = _t(acc, ai[:, 0], qd)
    tm = min(kp.TM, N // 4)
    want = ka.step_plain(t_acc, t_ai, table, p, form, tm)
    assert torch.equal(_composed(t_acc, t_ai, table, p, form, tm), want), name
    if not form.accio:  # the wrappers of the pieces, on the CPU
        digits = kp.tree_digits(t_acc, t_ai, p, form)
        leaves = kp.leaves(digits, kp.leaf_panel(table, p), table, p, form, tm)
        assert torch.equal(kp.combine(t_acc, leaves, p, form), want), name


@pytest.mark.parametrize("N,l", [(64, 3), (256, 3), (1024, 3), (2048, 4)])
def test_leaf_pieces_match_the_step_parts(N, l):
    # the tree digits are karatsuba.step_digits' (zeros past ns); each leaf's
    # panel is K4's limb panel of that leaf's table at N := ns; the product
    # through the panels, per limb, is karatsuba.leaf_parts' circulant
    # product, and recombined it is their sum << 8k mod 2^32
    p = _p(N, l)
    _, acc, ai, qd = _inputs(17, N, l, b=4)
    t_acc, t_ai, table = _t(acc, ai[:, 0], qd)
    ns = N // 4
    form = ka.Step()
    digits = kp.tree_digits_plain(t_acc, t_ai, p, form)
    assert digits.dtype == torch.int8 and digits.shape == kp.digit_shape(p, 4)
    assert torch.equal(digits[..., :ns].to(torch.int64), ka.step_digits(t_acc, t_ai, p, form))
    assert not digits[..., ns:].any()
    panel = kp.leaf_panel_plain(table, p)
    assert panel.shape == kp.panel_shape(p)
    for t in (0, 8):
        leaf_table = table[:, t].permute(2, 0, 1, 3).contiguous()  # (2L, 2, K, 2ns)
        assert torch.equal(panel[t], limb_step.limb_panel_plain(leaf_table, p.replace(N=ns)))
    parts = ka.leaf_parts(digits[..., :ns].to(torch.int64), table, form, 128)  # (B, T, 2, K, ns)
    per_limb = kp.leaves_plain(digits, panel, table, p, kp.K2_FORM)
    assert per_limb.dtype == torch.int32 and torch.equal(per_limb.to(torch.int64), parts)
    rec = kp.leaves_plain(digits, panel, table, p, form)
    assert torch.equal(_u32.as_u32_int64(rec),
                       sum(parts[:, :, :, k] << (8 * k) for k in range(4)) & 0xFFFFFFFF)
    limb0 = kp.leaves_plain(digits, panel, table, p, kp.ABLATIONS["norecomb"])
    assert torch.equal(limb0.to(torch.int64), parts[:, :, :, 0])


def test_build_forms_read_the_residue_leaves_only():
    # P3's sum leaves are __vadd4 sums of the residue leaves (no byte lane
    # overflows at bgbit = 6): the producer's build gives the upfront planes
    p = _p(256, 3)
    _, acc, ai, qd = _inputs(18, 256, 3, b=4)
    t_acc, t_ai, _ = _t(acc, ai[:, 0], qd)
    d = kp.tree_digits_plain(t_acc, t_ai, p, kp.COISSUE_FORMS["leaf"]).to(torch.int64)
    r0, r2, r1, r3 = (d[:, t] for t in kp.RESIDUE_LEAVES)
    for t, want in ((2, r0 + r2), (5, r1 + r3), (6, r0 + r1), (7, r2 + r3),
                    (8, r0 + r1 + r2 + r3)):
        assert torch.equal(d[:, t], want) and int(want.abs().max()) <= 128, t


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
    # the pieces: shapes, the forms they carry, tm
    digits = kp.tree_digits(t_acc, t_ai, p)
    panel = kp.leaf_panel(table, p)
    with pytest.raises(ValueError, match="no pieces"):
        kp.tree_digits(t_acc, t_ai, p, kp.ABLATIONS["accio"])
    with pytest.raises(ValueError, match="must have shape"):
        kp.leaves(digits[:, :4].contiguous(), panel, table, p)
    with pytest.raises(ValueError, match="must have shape"):
        kp.combine(t_acc, kp.leaves(digits, panel, table, p, tm=32), p, kp.K2_FORM)
    with pytest.raises(ValueError, match="must divide"):
        kp.leaves(digits, panel, table, p, kp.ABLATIONS["nodots"], tm=24)
    with pytest.raises(TypeError):
        kp.leaf_panel(table.to(torch.int32), p)
    with pytest.raises(ValueError, match="power of two"):
        kp.check_shape(_p(16, 3))


def test_form_codes_are_distinct_and_exactness_is_labelled():
    codes = {kp.form_code(f) for f in kp.FORMS}
    assert len(codes) == len(kp.FORMS) == 19
    assert kp.form_code(ka.Step()) == 0 and kp.form_code(kp.ABLATIONS["accio"]) == 1 << 12
    assert {n for n, f in kp.ABLATIONS.items() if f.exact} == {"full"}
    assert kp.var_form(extract="sar") == kp.ABLATIONS["full"]
    assert not kp.var_form(skip_rotate=True).exact and kp.K2_FORM.exact


def test_smem_budget_at_default_params():
    # The leaf product is K1's product kernel: its shared memory is K1's ring
    # at any shape, 1 KiB of alignment, 4 stages of a 128 x 128 B digit box
    # and four 64 x 128 B panel boxes (each a multiple of the 1024-byte
    # swizzle atom), 8 barriers.
    D, PBS = params.DEFAULT_PARAMS, params.PBS_PARAMS
    assert cmux_k.SMEM_BYTES == 1024 + 4 * (16384 + 4 * 8192) + 64 == 197696 <= 232448
    assert 128 * 128 % 1024 == 64 * 128 % 1024 == 0
    # the bytes a step moves at DEFAULT: tree digits 13.5 KiB a sample, leaf
    # panels 20.25 MiB (rows [x0, 2ns) = [128, 512)), leaves 18 KiB a sample
    assert kp.digit_shape(D, 1) == (1, 9, 6, 256) and 9 * 6 * 256 == 13824
    assert kp.panel_shape(D) == (9, 6, 2, 4, 384, 128)
    assert int(np.prod(kp.panel_shape(D))) == 21233664 == 20.25 * 2**20
    assert kp.leaf_shape(D, 1, ka.Step()) == (1, 9, 2, 256) and 4 * 9 * 2 * 256 == 18432
    assert kp.leaf_shape(D, 1, kp.K2_FORM) == (1, 9, 2, 4, 256)  # limb-outer: per limb
    assert kp.leaf_shape(D, 7, kp.ABLATIONS["nodots"]) == (2 * 9 * 4 * 256 + 7 * 9,)  # W, D
    # PBS_PARAMS (ns = 512, l = 4): four 128-byte slices a plane, rows [128, 1024)
    assert kp.digit_shape(PBS, 1) == (1, 9, 8, 512)
    assert kp.panel_shape(PBS) == (9, 8, 2, 4, 896, 128)
    # leaf sizes below one slice: the digit planes pad to 128 bytes
    assert kp.digit_shape(_p(64, 3), 2) == (2, 9, 6, 128)


# --------------------------------------------------------------------- #
# The entry points
# --------------------------------------------------------------------- #
def test_entry_points_parse_the_jax_scripts_arguments(monkeypatch):
    monkeypatch.delenv("PRESET", raising=False)
    assert k2_floor_probe.parse([]) == (8192, tuple(kp.ABLATIONS))
    assert k2_floor_probe.parse(["64", "nodots", "full"]) == (64, ("full", "nodots"))
    with pytest.raises(SystemExit, match="unknown variant"):
        k2_floor_probe.parse(["64", "wide"])
    for mod in (vpu_reduce_probe, karatsuba2_probe, coissue_probe, coissue2_probe):
        assert mod.parse([]) == 8192 and mod.parse(["256"]) == 256
    assert k2_floor_probe.MACS_FULL == 50331648 == vpu_reduce_probe.MACS_FULL


def test_k2_floor_probe_refuses_pbs(monkeypatch):
    # Since the tensor-core redesign PRESET=pbs no longer refuses: the probe
    # runs at PBS_PARAMS (N=2048, l=4), as the JAX probe does; here its
    # plain version, on the CPU.
    monkeypatch.setenv("PRESET", "pbs")
    assert k2_floor_probe.parse([]) == (8192, tuple(kp.ABLATIONS))
    p = k2_floor_probe.preset()
    assert p == params.PBS_PARAMS
    (case,) = k2_floor_probe.cases(3, ("full",), torch.device("cpu"), p)
    acc0, a_t, tab, key, std = k2_floor_probe.draw_step(np.random.RandomState(0), 3,
                                                        torch.device("cpu"), p)
    got = case.step(case.x0)
    assert torch.equal(case.x0, acc0) and got.shape == (3, 2 * p.N)
    assert torch.equal(ka.scan_exit(got), cmux_k.cmux_step_plain(std, a_t, key, p))
    assert case.ops == 2 * 3 * k2_floor_probe.macs(p)


def test_entry_points_refuse_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("PRESET", raising=False)
    for mod in (k2_floor_probe, vpu_reduce_probe, karatsuba2_probe, coissue_probe, coissue2_probe):
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
    assert [c.name for c in split][:3] == ["baseline (Karatsuba step)", "split-serial (2x64)",
                                          "split-grouped (2x64)"]
    assert all(torch.equal(c.step(c.x0), split[0].step(split[0].x0)) for c in split)
    co = coissue2_probe.cases(16, cpu)
    assert [c.name[:2] for c in co] == ["A:", "B:", "C:"]
    assert all(torch.equal(c.step(c.x0), co[0].step(co[0].x0)) for c in co)
