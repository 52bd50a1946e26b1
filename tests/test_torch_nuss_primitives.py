"""P10, the Nussbaumer primitives kernel (``engine/nuss_primitives.py``),
against the JAX probe ``benches/nussbaumer_primitives_probe.py``.

The plain version is held, word for word, to the script's host reference
(``block_neg_roll_host`` / ``butterfly_host``) at several rolls, and to the
script's Pallas ``kernel`` in interpret mode at its roll S=17
(``pltpu.roll`` runs there).  The script is loaded as it is.  The CUDA
kernel is held to the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rustfhe_tpu_torch import _u32
from rustfhe_tpu_torch.benches import nussbaumer_primitives_probe as probe
from rustfhe_tpu_torch.engine import nuss_primitives as npk

SCRIPT = pathlib.Path(__file__).resolve().parents[1] / "benches" / "nussbaumer_primitives_probe.py"


def _script(monkeypatch):
    monkeypatch.setattr(sys, "dont_write_bytecode", True)
    spec = importlib.util.spec_from_file_location("_jax_nussbaumer_primitives_probe", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_port_draws_the_script_input_and_reference(monkeypatch):
    mod = _script(monkeypatch)
    assert (probe.TB, probe.W, npk.BL, npk.ROLL) == (mod.tb, mod.W, mod.BL, mod.S)
    rs = np.random.RandomState(0)
    x0 = rs.randint(0, 2**32, size=(mod.tb, mod.W), dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(probe.draw(), x0)
    assert np.array_equal(probe.butterfly_host(probe.block_neg_roll_host(x0, 17)),
                          mod.butterfly_host(mod.block_neg_roll_host(x0, 17)))


@pytest.mark.parametrize("s", [0, 1, 17, 63])
def test_plain_matches_host_reference(s):
    x0 = probe.draw()
    x0[0, :4] = [0, 1, 0x80000000, 0xFFFFFFFF]
    before = npk.nuss_primitives.launches
    got = npk.nuss_primitives(_u32.from_numpy(x0), s)
    assert npk.nuss_primitives.launches == before  # the CPU runs the plain version
    want = probe.butterfly_host(probe.block_neg_roll_host(x0, s))
    assert np.array_equal(_u32.to_numpy(got), want)


def test_plain_matches_jax_kernel_interpret(monkeypatch):
    mod = _script(monkeypatch)
    x0 = probe.draw()
    f = pl.pallas_call(mod.kernel, out_shape=jax.ShapeDtypeStruct((mod.tb, mod.W), jnp.uint32),
                       interpret=True)
    want = np.asarray(jax.jit(f)(jnp.asarray(x0)))
    got = npk.nuss_primitives(_u32.from_numpy(x0), mod.S)
    assert np.array_equal(_u32.to_numpy(got), want)


def test_wrapper_checks():
    x = torch.zeros((4, 256), dtype=torch.int32)
    assert npk.nuss_primitives(x, 5).shape == (4, 256)
    with pytest.raises(ValueError, match="multiple of 128"):
        npk.nuss_primitives(torch.zeros((4, 192), dtype=torch.int32))
    with pytest.raises(ValueError, match="roll S"):
        npk.nuss_primitives(x, 64)
    with pytest.raises(TypeError):
        npk.nuss_primitives(x.to(torch.int64))
    with pytest.raises(ValueError, match="no kernel or plain version"):
        npk.nuss_primitives(x.to("meta"))


def test_entry_point_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="need a CUDA device"):
        probe.main([])
