"""The port's limb-step probes P5/P6 (``engine/limb_probe.py``), its int8
GEMM P7/P9 (``engine/int8_gemm.py``), the map from the JAX package's limb
table (``plain.limb_table_from_qd``) and the probes' entry points
(``rustfhe_tpu_torch/benches``).

On the CPU the wrappers run the kernels' plain versions; these, and the
composition of the variants' pieces (K4/K6's limb panel and digits, the
digits without rotation, the products, the nodots part), are held word
for word (tolerance zero) to the JAX probes' own Pallas kernels in
interpret mode.  The probe scripts of ``benches/`` are loaded as they are:
they read the batch from ``sys.argv`` when imported, so ``sys.argv`` is
set first, and ``pl.pallas_call`` is patched to interpret mode for the
test (``monkeypatch`` restores both).  ``pallas_matmul_probe.py`` runs its
measurement when imported, so its ``make_pallas`` is compiled out of the
file's syntax tree alone.  The fast cases run at N=256 (DEFAULT_PARAMS'
l and Bg), the slow ones at N=1024.  The CUDA kernels are compared with
their plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import ast
import functools
import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rustfhe_tpu.engine.pallas_step import PallasEngine, build_panels, fused_external_product
from rustfhe_tpu.params import DEFAULT_PARAMS as J_DEFAULT
from rustfhe_tpu_torch import _u32, params
from rustfhe_tpu_torch.benches import limb_order_probe, matmul_probe, step_breakdown_probe
from rustfhe_tpu_torch.engine import cmux_k, int8_gemm, limb_probe, limb_step, plain

BENCHES = pathlib.Path(__file__).resolve().parents[1] / "benches"
B = 16  # the probes' batch here: two tiles of tb=8
TB = 8


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _load_probe(name, monkeypatch, N):
    """benches/<name>.py as a fresh module, its preset P cut to N."""
    monkeypatch.setattr(sys, "argv", ["probe", str(B)])
    monkeypatch.setattr(sys, "dont_write_bytecode", True)
    monkeypatch.setattr(sys, "path", list(sys.path))  # the probe inserts "."
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", BENCHES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.B == B
    mod.P = J_DEFAULT.replace(N=N)
    return mod, mod.P


def _make_pallas(Bv, K, N):
    """``make_pallas`` of benches/pallas_matmul_probe.py, compiled alone."""
    path = BENCHES / "pallas_matmul_probe.py"
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "make_pallas")
    ns = {"pl": pl, "pltpu": pltpu, "jax": jax, "jnp": jnp, "B": Bv, "K": K, "N": N}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(path), "exec"), ns)
    return ns["make_pallas"]


def _step_inputs(seed, N, b=B):
    """acc, a~ (with the edge rotations) and random bytes as the probes' qd."""
    rs = np.random.RandomState(seed)
    acc = rs.randint(0, 2**32, size=(b, 2, N), dtype=np.uint64).astype(np.uint32)
    acc[0, 0, :5] = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
    ai = rs.randint(0, 2 * N, size=(b,)).astype(np.int32)
    ai[:4] = [0, 1, N, 2 * N - 1]
    qd = rs.randint(-128, 128, size=(2, 2 * J_DEFAULT.l * 4, 2 * N)).astype(np.int8)
    return acc, ai, qd


def _port(acc, ai, qd):
    return (_u32.from_numpy(acc), torch.from_numpy(ai),
            plain.limb_table_from_qd(torch.from_numpy(qd)))


def _p(N):
    return params.DEFAULT_PARAMS.replace(N=N)


def _variant_pieces(acc, a_tilde, table, p, variant, tm=limb_probe.TM):
    """P6's kernels' pieces in their order, plain: the limb panel, the
    digits (of acc itself for norot), then K6's product or the nodots
    part."""
    rotate, dots = limb_probe.VARIANTS[variant]
    panel = limb_step.limb_panel_plain(table, p)
    digits = limb_probe.step_digits(acc, a_tilde, p, rotate)
    if dots:
        return cmux_k.panel_product_plain(digits, panel, acc, p)
    return limb_probe.nodots(digits, acc, p, tm)


def _order_pieces(acc, a_tilde, table, p, order):
    """P5's kernels' pieces in their order, plain: the limb panel, the
    digits, then K4's product, drained per plane (j-outer) or once."""
    panel = limb_step.limb_panel(table, p)
    digits = cmux_k.step_digits(acc, a_tilde, p)
    if limb_probe.ORDERS[order]:
        return limb_probe.drain_product(digits, panel, acc, p)
    return limb_step.merged_product(digits, panel, acc, p)


# --------------------------------------------------------------------- #
# The limb table from the JAX layout
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("N,l,bgbit", [(128, 2, 8), (256, 3, 6)])
def test_limb_table_from_qd_matches_prepare_trgsw(N, l, bgbit):
    from rustfhe_tpu.params import TFHEParams as JParams

    rows = np.random.RandomState(1).randint(0, 2**32, size=(2 * l, 2, N), dtype=np.uint64)
    rows = rows.astype(np.uint32)
    rows[0, 0, :5] = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
    jp = JParams(n=8, N=N, l=l, bgbit=bgbit)
    qd = np.array(PallasEngine(tb=8).prepare_trgsw(jnp.asarray(rows), jp))
    got = plain.limb_table_from_qd(torch.from_numpy(qd))
    assert got.dtype == torch.int8 and got.is_contiguous()
    assert torch.equal(got, plain.prepare_trgsw_limbs(_u32.from_numpy(rows)))


def test_limb_table_from_qd_moves_random_bytes():
    N = 128
    _, _, qd = _step_inputs(2, N)
    got = plain.limb_table_from_qd(torch.from_numpy(qd)).numpy()
    j, c, k, x = np.meshgrid(np.arange(6), np.arange(2), np.arange(4), np.arange(2 * N),
                             indexing="ij")
    assert np.array_equal(got, qd[c, j * 4 + k, (x - N) % (2 * N)])
    with pytest.raises(ValueError):
        plain.limb_table_from_qd(torch.from_numpy(qd[:1]))
    with pytest.raises(ValueError):
        plain.limb_table_from_qd(torch.from_numpy(qd).to(torch.int32))


def test_limb_table_from_qd_carries_random_bytes_through_k5(interpret):
    # JAX's K5 on random bytes (no negacyclic table) equals the port's
    # limb product on the mapped table.
    N = 256
    jp = J_DEFAULT.replace(N=N)
    _, _, qd = _step_inputs(3, N)
    d = np.random.RandomState(4).randint(-32, 32, size=(B, 2 * jp.l, N)).astype(np.int8)
    want = fused_external_product(jnp.asarray(d.reshape(B, -1)), build_panels(jnp.asarray(qd), jp),
                                  params=jp, tb=TB, interpret=True)
    got = plain.external_product_limbs(torch.from_numpy(d),
                                       plain.limb_table_from_qd(torch.from_numpy(qd)))
    assert np.array_equal(_u32.to_numpy(got), np.asarray(want))


# --------------------------------------------------------------------- #
# P6 and P5 plain against the JAX probes' kernels (interpret mode)
# --------------------------------------------------------------------- #
def _check_variants(monkeypatch, N, variants):
    mod, jp = _load_probe("step_breakdown_probe", monkeypatch, N)
    acc, ai, qd = _step_inputs(5, N)
    panels = build_panels(jnp.asarray(qd), jp, 128)
    t_acc, t_ai, table = _port(acc, ai, qd)
    for variant in variants:
        rotate, dots = limb_probe.VARIANTS[variant]
        want = np.asarray(mod.make_variant(panels, jnp.asarray(ai), TB, 128, rotate, dots)(
            jnp.asarray(acc)))
        before = limb_probe.step_variant.launches
        got = limb_probe.step_variant(t_acc, t_ai, table, _p(N), variant)
        assert limb_probe.step_variant.launches == before  # the plain version launches nothing
        assert np.array_equal(_u32.to_numpy(got), want), variant
        pieces = _variant_pieces(t_acc, t_ai, table, _p(N), variant)
        assert np.array_equal(_u32.to_numpy(pieces), want), variant
        if variant == "full":  # = K6
            assert torch.equal(got, limb_step.cmux_step_split(t_acc, t_ai, table, _p(N)))


@pytest.mark.parametrize("variant", ["full", "nodots", "norot"])
def test_step_variant_matches_make_variant(variant, interpret, monkeypatch):
    _check_variants(monkeypatch, 256, [variant])


def _check_orders(monkeypatch, N, orders):
    mod, jp = _load_probe("limb_order_probe", monkeypatch, N)
    acc, ai, qd = _step_inputs(6, N)
    panels = build_panels(jnp.asarray(qd), jp, 128)
    t_acc, t_ai, table = _port(acc, ai, qd)
    k4 = limb_step.cmux_step_merged(t_acc, t_ai, table, _p(N))
    for order in orders:
        limb_outer = not limb_probe.ORDERS[order]
        want = np.asarray(mod.make_step(panels, jnp.asarray(ai), TB, 128, limb_outer)(
            jnp.asarray(acc)))
        got = limb_probe.step_order(t_acc, t_ai, table, _p(N), order)
        assert np.array_equal(_u32.to_numpy(got), want), order
        assert torch.equal(got, k4)
        pieces = _order_pieces(t_acc, t_ai, table, _p(N), order)
        assert np.array_equal(_u32.to_numpy(pieces), want), order


@pytest.mark.parametrize("order", ["j-outer", "limb-outer"])
def test_step_order_matches_make_step(order, interpret, monkeypatch):
    _check_orders(monkeypatch, 256, [order])


@pytest.mark.slow
def test_probes_match_jax_at_n1024(interpret, monkeypatch):
    _check_variants(monkeypatch, 1024, list(limb_probe.VARIANTS))
    _check_orders(monkeypatch, 1024, list(limb_probe.ORDERS))


@pytest.mark.parametrize("N", [64, 256, 1024])
def test_probe_pieces_compose_to_the_plain_steps(N):
    # every P6 variant and P5 order: the pieces' plain versions, composed in
    # the kernels' order, equal the variant's plain step
    acc, ai, qd = _step_inputs(11, N, b=5)
    t_acc, t_ai, table = _port(acc, ai, qd)
    p = _p(N)
    tm = min(limb_probe.TM, N)
    for variant, (rotate, dots) in limb_probe.VARIANTS.items():
        want = limb_probe.variant_step_plain(t_acc, t_ai, table, p, rotate, dots, tm)
        assert torch.equal(_variant_pieces(t_acc, t_ai, table, p, variant, tm), want), variant
    k4 = limb_step.cmux_step_plain(t_acc, t_ai, table, p)
    for order in limb_probe.ORDERS:
        assert torch.equal(_order_pieces(t_acc, t_ai, table, p, order), k4), order


def test_norot_digits_are_the_digits_of_acc():
    # step_digits_kernel<false>'s plain version: acc's own decomposition,
    # padded to one 128-byte slice at N < 128
    from rustfhe_tpu_torch.trgsw import decompose_trlwe

    for N in (64, 256):
        acc, ai, _ = _step_inputs(12, N, b=4)
        t_acc, t_ai = _u32.from_numpy(acc), torch.from_numpy(ai)
        p = _p(N)
        got = limb_probe.step_digits(t_acc, t_ai, p, rotate=False)
        assert got.shape == (4, 2 * p.l, max(N, 128)) and got.dtype == torch.int8
        assert torch.equal(got[..., :N], decompose_trlwe(t_acc, p).to(torch.int8))
        assert not got[..., N:].any()
        assert torch.equal(limb_probe.step_digits(t_acc, t_ai, p),
                           cmux_k.step_digits_plain(t_acc, t_ai, p))


def test_nodots_depends_on_tm_as_specified():
    N = 256
    acc, ai, qd = _step_inputs(7, N, b=4)
    t_acc, t_ai, table = _port(acc, ai, qd)
    p = _p(N)
    from rustfhe_tpu_torch import poly
    from rustfhe_tpu_torch.trgsw import decompose_trlwe

    digits = decompose_trlwe(poly.rotate(t_acc, t_ai[:, None]) - t_acc, p).to(torch.int64)
    for tm in (64, 128, 256):
        s = digits[:, :, ::tm].sum(dim=(1, 2))  # one digit per block of tm, all planes
        want = (t_acc.to(torch.int64) + (s * 0x01010101)[:, None, None]) & 0xFFFFFFFF
        got = limb_probe.step_variant(t_acc, t_ai, table, p, "nodots", tm=tm)
        assert torch.equal(_u32.as_u32_int64(got), want)


# --------------------------------------------------------------------- #
# P7 and P9 plain against the JAX probes' dots
# --------------------------------------------------------------------- #
def _gemm_operands(seed, M, K, N):
    rs = np.random.RandomState(seed)
    w = rs.randint(-128, 128, size=(K, N)).astype(np.int8)
    d = rs.randint(-128, 128, size=(M, K)).astype(np.int8)
    d[0] = -128  # the largest products
    w[:, 0] = -128
    return d, w


@pytest.mark.parametrize("tm", [128, 0])
def test_int8_matmul_matches_make_dot(tm, interpret, monkeypatch):
    mod, jp = _load_probe("step_breakdown_probe", monkeypatch, 256)
    d, w = _gemm_operands(8, B, 512, jp.N)
    want = np.asarray(mod.make_dot(jnp.asarray(w), TB, tm)(jnp.asarray(d)))
    assert np.array_equal(want, np.asarray(jnp.dot(jnp.asarray(d), jnp.asarray(w),
                                                   preferred_element_type=jnp.int32)))
    t_d, t_w = torch.from_numpy(d), torch.from_numpy(w)
    assert np.array_equal(int8_gemm.int8_matmul_plain(t_d, t_w).numpy(), want)


def test_int8_matmul_matches_make_pallas(interpret):
    M, K, N = 16, 256, 512
    d, w = _gemm_operands(9, M, K, N)
    want = np.asarray(_make_pallas(M, K, N)(8, 256, 128)(jnp.asarray(d), jnp.asarray(w)))
    assert np.array_equal(want, np.asarray(jnp.dot(jnp.asarray(d), jnp.asarray(w),
                                                   preferred_element_type=jnp.int32)))
    t_d, wt = torch.from_numpy(d), int8_gemm.prepare_rhs(torch.from_numpy(w))
    before = int8_gemm.int8_matmul.launches
    for tile in int8_gemm.TILES:
        rows = int8_gemm.tile_shape(tile)[0]
        got = int8_gemm.int8_matmul(t_d.repeat(rows // M, 1), wt, tile)
        assert np.array_equal(got.numpy()[:M], want), tile
    assert int8_gemm.int8_matmul.launches == before


def test_int8_matmul_at_the_exactness_edge():
    # every product -128 * -128 at K = 2^17 - DEPTH (128): 2^31 - 2^21, the
    # largest sum at a depth the kernel takes
    K = (1 << 17) - int8_gemm.DEPTH
    d = torch.full((64, K), -128, dtype=torch.int8)
    wt = torch.full((64, K), -128, dtype=torch.int8)
    got = int8_gemm.int8_matmul(d, wt, "64x64")
    assert got.dtype == torch.int32 and bool((got == K * 16384).all())


# --------------------------------------------------------------------- #
# The wrappers check their operands
# --------------------------------------------------------------------- #
def test_gemm_wrapper_checks():
    d = torch.zeros((128, 256), dtype=torch.int8)
    wt = torch.zeros((256, 256), dtype=torch.int8)
    assert int8_gemm.int8_matmul(d, wt, "128x256").shape == (128, 256)
    d200, wt200 = d[:, :200].contiguous(), wt[:, :200].contiguous()
    for bad_d, bad_wt, tile in ((d[:100], wt, "64x64"),      # M ragged
                                (d, wt[:200], "128x128"),    # N ragged
                                (d200, wt200, "64x64"),      # K ragged
                                (d[:64], wt, "128x128")):    # M below the tile
        with pytest.raises(ValueError, match="does not divide tile"):
            int8_gemm.int8_matmul(bad_d, bad_wt, tile)
    with pytest.raises(ValueError, match="unknown tile"):
        int8_gemm.int8_matmul(d, wt, "32x32")
    with pytest.raises(ValueError, match="must have shape"):
        int8_gemm.int8_matmul(d, wt[:, :128], "64x64")
    with pytest.raises(TypeError):
        int8_gemm.int8_matmul(d.to(torch.int32), wt, "64x64")
    with pytest.raises(TypeError):
        int8_gemm.prepare_rhs(wt.to(torch.int32))
    with pytest.raises(ValueError, match="2\\^31"):
        int8_gemm.check_bound(1 << 17)
    with pytest.raises(ValueError, match="2\\^31"):
        int8_gemm.int8_matmul_plain(torch.zeros((1, 1 << 17), dtype=torch.int8),
                                    torch.zeros((1 << 17, 1), dtype=torch.int8))
    with pytest.raises(ValueError, match="no kernel or plain version"):
        int8_gemm.int8_matmul(d.to("meta"), wt.to("meta"), "64x64")
    assert int8_gemm.prepare_rhs(wt[:, :128]).is_contiguous()


def test_probe_wrapper_checks():
    N = 128
    acc, ai, qd = _step_inputs(10, N, b=4)
    t_acc, t_ai, table = _port(acc, ai, qd)
    p = _p(N)
    with pytest.raises(ValueError, match="unknown variant"):
        limb_probe.step_variant(t_acc, t_ai, table, p, "wide")
    with pytest.raises(ValueError, match="must divide"):
        limb_probe.step_variant(t_acc, t_ai, table, p, "nodots", tm=96)
    with pytest.raises(ValueError, match="unknown order"):
        limb_probe.step_order(t_acc, t_ai, table, p, "k-outer")
    with pytest.raises(TypeError):
        limb_probe.step_variant(t_acc, t_ai.to(torch.int64), table, p)
    with pytest.raises(ValueError):
        limb_probe.step_order(t_acc, t_ai, table[:2], p)
    with pytest.raises(ValueError, match="2\\^31"):
        limb_probe.step_order(torch.zeros((1, 2, 16384), dtype=torch.int32),
                              torch.zeros((1,), dtype=torch.int32),
                              torch.zeros((8, 2, 4, 32768), dtype=torch.int8),
                              params.TFHEParams(n=8, N=16384, l=4, bgbit=8))


# --------------------------------------------------------------------- #
# The entry points
# --------------------------------------------------------------------- #
def test_entry_points_parse_the_jax_scripts_arguments():
    assert step_breakdown_probe.parse([]) == (8192, ("full", "nodots", "norot", "tm256", "dots"))
    assert step_breakdown_probe.parse(["64", "merged", "wide"]) == (64, ("merged", "wide"))
    with pytest.raises(SystemExit, match="unknown variant"):
        step_breakdown_probe.parse(["64", "tm512"])
    assert step_breakdown_probe.MACS_PER_GATE_STEP == 50331648
    assert limb_order_probe.DEFAULT_B == 8192 and matmul_probe.DEFAULT_B == 4096


def test_entry_points_refuse_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (step_breakdown_probe, limb_order_probe, matmul_probe):
        with pytest.raises(SystemExit, match="need a CUDA device"):
            mod.main(["64"])


def test_entry_point_cases_run_their_plain_versions():
    # The control flow of the probes at a small batch on the CPU: every
    # case's step maps its input to the next input, and the GEMM lines
    # agree with the plain product.
    cases = step_breakdown_probe.cases(256, ("dots", "tm256"), torch.device("cpu"))
    notes = [c for c in cases if isinstance(c, str)]
    assert any("tm256" in n and "no Hopper counterpart" in n for n in notes)
    names = [c.name for c in cases if not isinstance(c, str)]
    assert names == ["tm256 -> K4", "tm256 -> K6"] + [f"dot tile={t}" for t in int8_gemm.TILES] \
        + ["dot torch._int_mm (cuBLASLt)"]
    dots = [c for c in cases if not isinstance(c, str) and c.name.startswith("dot")]
    outs = [c.step(c.x0) for c in dots]
    assert all(o.shape == (256, 6144) and o.dtype == torch.int8 for o in outs)
    assert all(torch.equal(o, outs[0]) for o in outs)
    mm = matmul_probe.cases(64, torch.device("cpu"))
    assert [c.name for c in mm][0] == "torch._int_mm int8 (cuBLASLt)" and len(mm) == 4
    assert mm[0].ops == 2 * 64 * 6144 * 8192
    order = limb_order_probe.cases(8, torch.device("cpu"))
    assert [c.name for c in order] == ["rep0 j-outer (P5)", "rep0 limb-outer (P5)",
                                       "rep1 j-outer (P5)", "rep1 limb-outer (P5)",
                                       "K4 (cmux_step_merged)"]
