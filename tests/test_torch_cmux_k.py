"""K1 (blind-rotate CMux step) and K2 (external product) of the port.

On the CPU the wrappers run the kernels' plain versions; these are held
word for word (tolerance zero) to the JAX reference that the TPU kernels
themselves are held to: ``rotate_binary`` + ``decompose_trlwe`` +
``MatmulEngine`` (tests/test_poly.py::test_pallas_k2_interpret_exact), and,
in the slow tests, the Pallas kernels in interpret mode.  The CUDA kernels
themselves are compared with their plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustfhe_tpu import poly as jpoly
from rustfhe_tpu import trgsw as jtrgsw
from rustfhe_tpu.engine import get_engine
from rustfhe_tpu.params import TFHEParams as JParams
from rustfhe_tpu_torch import TFHE, _u32, params
from rustfhe_tpu_torch.engine import cmux_k, oracle, plain

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
