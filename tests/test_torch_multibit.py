"""The grouped (multi-bit, k=2) blind rotation of the port's
``benches/multibit_probe.py``: the two cases of tests/test_multibit.py (a
NAND truth table at TEST_PARAMS, and odd n=15, N=64, which runs the
trailing standard step), and the rotation equal to the JAX probe's word
for word on the same raw grouped-key rows, ciphertexts and test vector,
on the "matmul" engine.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustfhe_tpu.engine import get_engine as jget_engine
from rustfhe_tpu.params import TEST_PARAMS as JTEST
from rustfhe_tpu.params import TFHEParams as JParams
from rustfhe_tpu_torch import _u32, params
from rustfhe_tpu_torch.benches import multibit_probe

ODD = dict(n=15, N=64, alpha_lv0=2.0**-20, alpha_lv1=2.0**-28)


def _load_jax_probe():
    path = pathlib.Path(__file__).resolve().parents[1] / "benches" / "multibit_probe.py"
    spec = importlib.util.spec_from_file_location("jax_multibit_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_grouped2_nand_truth_table():
    bad, batch = multibit_probe.check_correctness(device="cpu")
    assert bad == 0, f"{bad}/{batch} grouped-2 NAND outputs wrong"


def test_grouped2_odd_n_leftover_step():
    p = params.TFHEParams(**ODD)
    bad, batch = multibit_probe.check_correctness(params=p, batch=32, seed=9, device="cpu")
    assert bad == 0, f"{bad}/{batch} grouped-2 NAND outputs wrong at odd n"


@pytest.mark.parametrize("shape", ["TEST_PARAMS", "odd n=15"])
def test_blind_rotate_grouped2_equals_jax(shape):
    """Random raw rows, ciphertext words and the mu test vector: the
    rotation's algebra, word for word (the truth tables above hold the
    construction to decryption)."""
    jparams = JTEST if shape == "TEST_PARAMS" else JParams(**ODD)
    p = params.TEST_PARAMS if shape == "TEST_PARAMS" else params.TFHEParams(**ODD)
    jmod = _load_jax_probe()
    jeng = jget_engine("matmul")
    rs = np.random.RandomState(21)
    words = lambda *shape: rs.randint(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    raw = words(p.n // 2, 3, 2 * p.l, 2, p.N)
    raw_last = words(1, 2 * p.l, 2, p.N) if p.n % 2 else None
    ct = words(16, p.n + 1)
    testvec = np.zeros((2, p.N), np.uint32)
    testvec[0] = p.mu  # trlwe.trivial: (mu, 0)

    bkg, bk_last = (None if r is None else jeng.prepare_trgsw(jnp.asarray(r), jparams)
                    for r in (raw, raw_last))
    rotate = jax.jit(lambda c: jmod.blind_rotate_grouped2(c, bkg, bk_last, jnp.asarray(testvec),
                                                          jparams, jeng))
    want = np.asarray(rotate(jnp.asarray(ct)))

    dev = torch.device("cpu")
    bkg, bk_last = (None if r is None
                    else multibit_probe.prepare(_u32.from_numpy(r, dev), p, "matmul")
                    for r in (raw, raw_last))
    got = multibit_probe.blind_rotate_grouped2(_u32.from_numpy(ct, dev), bkg, bk_last,
                                               _u32.from_numpy(testvec, dev), p, "matmul")
    assert got.dtype == torch.int32
    assert np.array_equal(_u32.to_numpy(got), want)
