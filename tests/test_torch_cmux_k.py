"""K1 (blind-rotate CMux step) and K2 (external product) of the port.

On the CPU the wrappers run the kernels' plain versions; these are held
word for word (tolerance zero) to the JAX reference that the TPU kernels
themselves are held to: ``rotate_binary`` + ``decompose_trlwe`` +
``MatmulEngine`` (tests/test_poly.py::test_pallas_k2_interpret_exact), and,
in the slow tests, the Pallas kernels in interpret mode.  The CUDA kernels
themselves are compared with their plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import ctypes
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustfhe_tpu import poly as jpoly
from rustfhe_tpu import trgsw as jtrgsw
from rustfhe_tpu.engine import get_engine
from rustfhe_tpu.params import TFHEParams as JParams
from rustfhe_tpu_torch import TFHE, _u32, params
from rustfhe_tpu_torch.engine import build, cmux_k, launch, matmul, oracle, plain

U32 = jnp.uint32
P1024 = params.TFHEParams(n=8, N=1024)
J1024 = JParams(n=8, N=1024)


def _case(seed, B, p):
    rs = np.random.RandomState(seed)
    rows = rs.randint(0, 2**32, size=(2 * p.l, 2, p.N), dtype=np.uint64).astype(np.uint32)
    acc = rs.randint(0, 2**32, size=(B, 2, p.N), dtype=np.uint64).astype(np.uint32)
    acc[0, 0, :5] = [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
    ai = rs.randint(0, 2 * p.N, size=(B,)).astype(np.int32)
    ai[:4] = [0, 1, p.N, 2 * p.N - 1][:B]
    digits = rs.randint(-p.half_bg, p.half_bg, size=(B, 2 * p.l, p.N)).astype(np.int32)
    return rows, acc, ai, digits


def _jax_step(rows, acc, ai, jp):
    m = get_engine("matmul")
    rot = jpoly.rotate_binary(jnp.asarray(acc), jnp.asarray(ai)[:, None])
    diff = (rot - jnp.asarray(acc)).astype(U32)
    want = (jnp.asarray(acc) + m.external_product_digits(
        m.prepare_trgsw(jnp.asarray(rows), jp), jtrgsw.decompose_trlwe(diff, jp), jp)).astype(U32)
    return np.asarray(want)


def _port_step(rows, acc, ai, p, device="cpu"):
    key = plain.prepare_trgsw(_u32.from_numpy(rows, device))
    out = cmux_k.cmux_step(_u32.from_numpy(acc, device), torch.from_numpy(ai).to(device), key, p)
    return _u32.to_numpy(out)


def test_cmux_step_matches_jax_composed_reference():
    rows, acc, ai, _ = _case(31, 8, P1024)
    before = cmux_k.cmux_step.launches
    got = _port_step(rows, acc, ai, P1024)
    assert np.array_equal(got, _jax_step(rows, acc, ai, J1024))
    assert cmux_k.cmux_step.launches == before  # the plain version launches nothing


def test_cmux_step_matches_oracle_composition():
    # The same step composed from the port's own oracle, at TEST_PARAMS.
    p = params.TEST_PARAMS
    rows, acc, ai, _ = _case(32, 5, p)
    from rustfhe_tpu_torch import poly, trgsw

    t_acc = _u32.from_numpy(acc)
    diff = poly.rotate(t_acc, torch.from_numpy(ai)[:, None]) - t_acc
    want = t_acc + oracle.external_product(_u32.from_numpy(rows), trgsw.decompose_trlwe(diff, p))
    assert np.array_equal(_port_step(rows, acc, ai, p), _u32.to_numpy(want))


def test_external_product_matches_jax():
    rows, _, _, digits = _case(33, 8, P1024)
    m = get_engine("matmul")
    want = np.asarray(m.external_product_digits(
        m.prepare_trgsw(jnp.asarray(rows), J1024), jnp.asarray(digits), J1024))
    key = plain.prepare_trgsw(_u32.from_numpy(rows))
    got = cmux_k.external_product(torch.from_numpy(digits).to(torch.int8), key, P1024)
    assert np.array_equal(_u32.to_numpy(got), want)


def test_wrappers_check_their_operands():
    p = params.TEST_PARAMS
    rows, acc, ai, digits = _case(34, 3, p)
    key = plain.prepare_trgsw(_u32.from_numpy(rows))
    t_acc, t_ai = _u32.from_numpy(acc), torch.from_numpy(ai)
    with pytest.raises(TypeError):
        cmux_k.cmux_step(t_acc, t_ai.to(torch.int64), key, p)
    with pytest.raises(ValueError):
        cmux_k.cmux_step(t_acc[:, :, :32], t_ai, key, p)
    with pytest.raises(ValueError):
        cmux_k.cmux_step(t_acc.transpose(0, 1).contiguous().transpose(0, 1), t_ai, key, p)
    with pytest.raises(TypeError):
        cmux_k.external_product(torch.from_numpy(digits), key, p)


# The product behind each plain step (``plain.cmux_step``): K1's, the limb
# engine's (K4-K6), and the "matmul" engine's, which takes int32 digits.
PLAIN_PRODUCTS = {
    "K1": (lambda rows: (lambda d: plain.external_product(
        d, plain.prepare_trgsw(_u32.from_numpy(rows)))), torch.int8),
    "limb": (lambda rows: (lambda d: plain.external_product_limbs(
        d, plain.prepare_trgsw_limbs(_u32.from_numpy(rows)))), torch.int8),
    "matmul": (lambda rows: (lambda d: matmul.MatmulEngine().external_product_digits(
        matmul.MatmulEngine().prepare_trgsw(_u32.from_numpy(rows)), d, P1024)), torch.int32),
}


@pytest.mark.parametrize("product", list(PLAIN_PRODUCTS))
def test_plain_cmux_step_on_each_product_matches_jax(product):
    # the one plain step (rotation, difference, digits, then the product) on
    # each product = the JAX composition, word for word
    rows, acc, ai, _ = _case(33, 5, P1024)
    make, dtype = PLAIN_PRODUCTS[product]
    t_acc, t_ai = _u32.from_numpy(acc), torch.from_numpy(ai)
    got = plain.cmux_step(t_acc, t_ai, P1024, make(rows), dtype)
    assert np.array_equal(_u32.to_numpy(got), _jax_step(rows, acc, ai, J1024))
    rot = jpoly.rotate_binary(jnp.asarray(acc), jnp.asarray(ai)[:, None])
    want = jtrgsw.decompose_trlwe((rot - jnp.asarray(acc)).astype(U32), J1024)
    assert np.array_equal(plain.step_digits(t_acc, t_ai, P1024).numpy(), np.asarray(want))


# --------------------------------------------------------------------- #
# The launch module: what every wrapper checks before an entry reads a
# tensor by address, where it dispatches, and how a library is bound.
# --------------------------------------------------------------------- #
_T = torch.zeros((3, 4), dtype=torch.int32)
LAUNCH_CHECKS = {
    "dtype": (lambda: launch.check_tensor("x", _T.to(torch.int64), torch.int32, (3, 4),
                                          _T.device), TypeError, "x must be torch.int32"),
    "shape": (lambda: launch.check_tensor("x", _T[:2], torch.int32, (3, 4), _T.device),
              ValueError, r"x must have shape \(3, 4\), got \(2, 4\)"),
    "device": (lambda: launch.check_tensor("x", _T, torch.int32, (3, 4), torch.device("meta")),
               ValueError, "x is on cpu, expected meta"),
    "contiguity": (lambda: launch.check_tensor("x", _T.t().contiguous().t(), torch.int32, (3, 4),
                                               _T.device), ValueError, "x must be contiguous"),
    "unsupported device": (lambda: launch.dispatch(torch.device("meta")), ValueError,
                           "no kernel or plain version for device meta"),
}


@pytest.mark.parametrize("case", list(LAUNCH_CHECKS))
def test_launch_checks_tensors_and_dispatches(case):
    fn, error, message = LAUNCH_CHECKS[case]
    with pytest.raises(error, match=message):
        fn()
    launch.check_tensor("x", _T, torch.int32, (3, 4), _T.device)  # all four hold: no error
    assert launch.dispatch(torch.device("cpu")) is False
    assert launch.dispatch(torch.device("cuda", 1)) is True


def test_launch_binds_a_library_from_its_table(monkeypatch):
    # bind against a stand-in library: every entry of the table gets its
    # argument types and an int result, the error string its signature;
    # check decodes an error with the library's own string
    def entry():
        return SimpleNamespace(argtypes=None, restype=None)

    lib = SimpleNamespace(rustfhe_a=entry(), rustfhe_b=entry(), rustfhe_c=entry(),
                          rustfhe_cuda_error_string=entry())
    loaded = []
    monkeypatch.setattr(build, "load", lambda name: loaded.append(name) or lib)
    table = {"rustfhe_a": [launch.VP, launch.INT], "rustfhe_b": [launch.INT_P, launch.UINT]}
    assert launch.bind("stand_in", table) is lib
    assert loaded == ["stand_in"]
    for name, args in table.items():
        assert (getattr(lib, name).argtypes, getattr(lib, name).restype) == (args, ctypes.c_int)
    assert (lib.rustfhe_c.argtypes, lib.rustfhe_c.restype) == (None, None)  # not in the table
    assert lib.rustfhe_cuda_error_string.argtypes == [ctypes.c_int]
    assert lib.rustfhe_cuda_error_string.restype is ctypes.c_char_p
    lib.rustfhe_cuda_error_string = lambda err: b"invalid argument" if err == 1 else b"?"
    launch.check(lib, 0, "rustfhe_a")
    with pytest.raises(RuntimeError, match=r"rustfhe_a launch failed: CUDA error 1 "
                                           r"\(invalid argument\)"):
        launch.check(lib, 1, "rustfhe_a")


# --------------------------------------------------------------------- #
# The step's pieces: key panels, digits and the panel product, as the
# kernels compute them, composed against the references.
# --------------------------------------------------------------------- #
PIECE_PARAMS = {"TEST_PARAMS": (params.TEST_PARAMS, JParams(n=16, N=64)),  # N=64: padded
                "DEFAULT_PARAMS": (params.DEFAULT_PARAMS, JParams()),
                "FAST_PARAMS": (params.FAST_PARAMS, JParams(bgbit=8, l=2)),
                "PBS_PARAMS": (params.PBS_PARAMS, None)}  # N=2048, l=4


def _edge_case(seed, B, p):
    """_case with rows of the limb edges 0x80808080 and 0xFFFFFFFF (a whole
    row polynomial each) and the a~ edges 0, 1, N, 2N-1."""
    rows, acc, ai, digits = _case(seed, B, p)
    rows[0, 0], rows[1, 1] = 0x80808080, 0xFFFFFFFF
    return rows, acc, ai, digits


def _pieces_step(rows, acc, ai, p):
    key = plain.prepare_trgsw(_u32.from_numpy(rows))
    t_acc, t_ai = _u32.from_numpy(acc), torch.from_numpy(ai)
    digits = cmux_k.step_digits_plain(t_acc, t_ai, p)
    got = cmux_k.panel_product_plain(digits, cmux_k.key_panel_plain(key, p), t_acc, p)
    return got, key, t_acc, t_ai


@pytest.mark.parametrize("name", list(PIECE_PARAMS))
def test_step_pieces_compose_to_the_step(name):
    # plain panel + plain digits through the kernel's product = the plain step
    # and (but at N=2048, l=4, whose JAX circulant alone takes 256 MiB) the
    # JAX MatmulEngine composition, word for word
    p, jp = PIECE_PARAMS[name]
    rows, acc, ai, _ = _edge_case(50, 5, p)
    got, key, t_acc, t_ai = _pieces_step(rows, acc, ai, p)
    assert torch.equal(got, cmux_k.cmux_step_plain(t_acc, t_ai, key, p))
    if jp is not None:
        assert np.array_equal(_u32.to_numpy(got), _jax_step(rows, acc, ai, jp))


@pytest.mark.parametrize("name", list(PIECE_PARAMS))
def test_panel_product_is_the_external_product(name):
    # K2's function: the caller's digits (any int8) padded to whole slices
    p, jp = PIECE_PARAMS[name]
    rows, _, _, _ = _edge_case(51, 3, p)
    digits = np.random.RandomState(52).randint(-128, 128, size=(3, 2 * p.l, p.N)).astype(np.int8)
    digits[0, 0, :2] = [-128, 127]
    key = plain.prepare_trgsw(_u32.from_numpy(rows))
    d8 = torch.from_numpy(digits)
    padded = torch.nn.functional.pad(d8, (0, cmux_k.geometry(p.N)[0] - p.N))
    got = cmux_k.panel_product_plain(padded, cmux_k.key_panel_plain(key, p), None, p)
    assert torch.equal(got, cmux_k.external_product_plain(d8, key))
    if jp is not None:
        m = get_engine("matmul")
        want = m.external_product_digits(m.prepare_trgsw(jnp.asarray(rows), jp),
                                         jnp.asarray(digits.astype(np.int32)), jp)
        assert np.array_equal(_u32.to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("name", ["TEST_PARAMS", "DEFAULT_PARAMS"])
def test_key_panel_holds_jax_limbs_in_sliding_rows(name):
    # panel[j, c, t, x - x0, r] = limb t of T[x - r] = JAX's limb table
    # [limbs(q), limbs(-q)] at (x - r + N) mod 2N; zeros past r = N and x = 2N
    p, jp = PIECE_PARAMS[name]
    rows, _, _, _ = _edge_case(53, 1, p)
    N = p.N
    npad, x0, nrows = cmux_k.geometry(N)
    panel = cmux_k.key_panel_plain(plain.prepare_trgsw(_u32.from_numpy(rows)), p).numpy()
    assert panel.shape == (2 * p.l, 2, 4, nrows, 128)
    table = np.asarray(get_engine("matmul").prepare_trgsw(jnp.asarray(rows), jp))
    x = np.arange(nrows)[:, None] + x0
    r = np.arange(128)[None, :]
    live = (r < N) & (x < 2 * N)
    want = table[..., (x - r + N) % (2 * N)]
    assert np.array_equal(panel, np.where(live, want, 0))


@pytest.mark.parametrize("name", ["TEST_PARAMS", "DEFAULT_PARAMS", "FAST_PARAMS"])
def test_step_digits_match_jax_decomposition(name):
    p, jp = PIECE_PARAMS[name]
    _, acc, ai, _ = _edge_case(54, 6, p)
    got = cmux_k.step_digits_plain(_u32.from_numpy(acc), torch.from_numpy(ai), p).numpy()
    rot = jpoly.rotate_binary(jnp.asarray(acc), jnp.asarray(ai)[:, None])
    want = np.asarray(jtrgsw.decompose_trlwe((rot - jnp.asarray(acc)).astype(U32), jp))
    assert got.shape == (6, 2 * p.l, cmux_k.geometry(p.N)[0])
    assert np.array_equal(got[..., : p.N], want.astype(np.int8))
    assert not got[..., p.N:].any()


def test_geometry_and_shapes():
    # (npad, x0, rows): N=1024: 1,920 rows of 128 B, 48 panels = 11.25 MiB
    assert cmux_k.geometry(1024) == (1024, 128, 1920)
    assert cmux_k.geometry(64) == (128, 64, 64)
    assert cmux_k.geometry(8) == (128, 8, 64)
    assert cmux_k.geometry(2048) == (2048, 128, 3968)
    assert int(np.prod(cmux_k.panel_shape(params.DEFAULT_PARAMS))) == 11.25 * 2**20
    for N in (8, 64, 1024, 2048):
        cmux_k.check_shape(N, 8)
    for N in (4, 4096, 96):
        with pytest.raises(ValueError, match="power of two"):
            cmux_k.check_shape(N, 6)
    with pytest.raises(ValueError, match="exact int32 range"):
        cmux_k.check_shape(2048, 64)  # 64 * 2048 * 2^14 = 2^31


# --------------------------------------------------------------------- #
# Without a card, a CUDA request raises; it never runs on the CPU instead.
# --------------------------------------------------------------------- #
def test_cuda_request_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the CPU-only host")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cmux_k.load_library()
    with pytest.raises(RuntimeError, match="is_available"):
        TFHE.new(0, params.TEST_PARAMS, device="cuda")
    p = params.TEST_PARAMS
    meta = torch.empty((2, 2, p.N), dtype=torch.int32, device="meta")
    key = torch.empty((2 * p.l, 2, 2 * p.N), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        cmux_k.cmux_step(meta, torch.empty((2,), dtype=torch.int32, device="meta"), key, p)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        cmux_k.key_panel(key, p)


# --------------------------------------------------------------------- #
# Slow: the Pallas kernels themselves (interpret mode) as the reference.
# --------------------------------------------------------------------- #
@pytest.mark.slow
def test_cmux_step_matches_pallas_k2_interpret():
    from rustfhe_tpu.engine.pallas_k import PallasKaratsubaEngine

    rows, acc, ai, _ = _case(35, 8, P1024)
    k2 = PallasKaratsubaEngine(interpret=True, levels=2)
    prep = k2.prepare_trgsw(jnp.asarray(rows), J1024)
    want = k2.scan_exit(k2.cmux_step(prep, k2.scan_enter(jnp.asarray(acc), J1024),
                                     jnp.asarray(ai), J1024), J1024)
    assert np.array_equal(_port_step(rows, acc, ai, P1024), np.asarray(want))


@pytest.mark.slow
def test_external_product_matches_pallas_k2_interpret():
    from rustfhe_tpu.engine.pallas_k import PallasKaratsubaEngine

    rows, _, _, digits = _case(36, 8, P1024)
    k2 = PallasKaratsubaEngine(interpret=True, levels=2)
    want = k2.external_product_digits(k2.prepare_trgsw(jnp.asarray(rows), J1024),
                                      jnp.asarray(digits), J1024)
    key = plain.prepare_trgsw(_u32.from_numpy(rows))
    got = cmux_k.external_product(torch.from_numpy(digits).to(torch.int8), key, P1024)
    assert np.array_equal(_u32.to_numpy(got), np.asarray(want))
