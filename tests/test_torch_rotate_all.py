"""K3 (the single-launch blind rotation) and the latency path of the port.

On the CPU ``rotate_all_k.rotate_all`` runs K3's plain version.  It is held
word for word (tolerance zero: every path is exact mod 2^32) to the JAX
package's ``bootstrap.blind_rotate`` with the ``matmul`` engine, and, in
the slow test, to ``fused_rotate_all_k`` itself in interpret mode.  Keys
come from the JAX package's ``gen_cloud_key_raw`` through
``keys.from_jax_keys``; ciphertexts are random words from a numpy seed.
The CUDA kernel is held to its plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustfhe_tpu import bootstrap as jbootstrap
from rustfhe_tpu import keys as jkeys
from rustfhe_tpu import trlwe as jtrlwe
from rustfhe_tpu.engine import get_engine
from rustfhe_tpu.params import TEST_PARAMS as J_TEST
from rustfhe_tpu.params import TFHEParams as JParams
from rustfhe_tpu_torch import TFHE, _u32, bootstrap, keys, params, trlwe
from rustfhe_tpu_torch.engine import cmux_k, rotate_all_k

SMALL = {  # name: (port params, JAX params)
    "TEST_PARAMS": (params.TEST_PARAMS, J_TEST),
    "n13_N256": (params.TFHEParams(n=13, N=256, alpha_lv0=2.0**-20, alpha_lv1=2.0**-28),
                 JParams(n=13, N=256, alpha_lv0=2.0**-20, alpha_lv1=2.0**-28)),
}


@functools.lru_cache(maxsize=None)
def _jax_raw_keys(name, seed=7):
    _, jp = SMALL[name]
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    sk = jkeys.gen_secret_key(k1, jp)
    bk_raw, ksk_raw = jkeys.gen_cloud_key_raw(k2, sk, jp, "matmul")
    return tuple(np.asarray(x) for x in (sk.lv0, sk.lv1, bk_raw, ksk_raw))


def _port_keys(name):
    p, _ = SMALL[name]
    return keys.from_jax_keys(*_jax_raw_keys(name), p, "cpu")


def _random_cts(p, B, seed):
    rs = np.random.RandomState(seed)
    ct = rs.randint(0, 2**32, size=(B, p.n + 1), dtype=np.uint64).astype(np.uint32)
    ct[0, 1:5] = [0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF][: p.n]
    return ct


def _testvec(p, rs):
    return rs.randint(0, 2**32, size=(2, p.N), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_rotate_all_plain_matches_jax_blind_rotate(name):
    p, jp = SMALL[name]
    _, ck = _port_keys(name)
    bk_raw = _jax_raw_keys(name)[2]
    m = get_engine("matmul")
    ct = _random_cts(p, 6, 11)
    tv = _testvec(p, np.random.RandomState(12))
    want = np.asarray(jbootstrap.blind_rotate(jnp.asarray(ct), m.prepare_trgsw(jnp.asarray(bk_raw), jp),
                                              jnp.asarray(tv), jp, m))
    acc, a_steps = bootstrap.rotation_start(_u32.from_numpy(ct), _u32.from_numpy(tv), p)
    got = rotate_all_k.rotate_all(acc, a_steps, ck.bk, p)
    assert np.array_equal(_u32.to_numpy(got), want)
    # and through blind_rotate with the latency key, at the batch's own shape
    lat = keys.cloud_key_latency(ck)
    got2 = bootstrap.blind_rotate(_u32.from_numpy(ct).reshape(2, 3, p.n + 1), lat.bk,
                                  _u32.from_numpy(tv), p)
    assert np.array_equal(_u32.to_numpy(got2).reshape(6, 2, p.N), want)


def test_rotate_all_plain_is_the_k1_loop():
    p = params.TEST_PARAMS
    _, ck = _port_keys("TEST_PARAMS")
    acc, a_steps = bootstrap.rotation_start(_u32.from_numpy(_random_cts(p, 3, 13)),
                                            trlwe.trivial(torch.full((p.N,), p.mu,
                                                                     dtype=torch.int32)), p)
    want = acc
    for i in range(p.n):
        want = cmux_k.cmux_step(want, a_steps[i], ck.bk[i], p)
    before = rotate_all_k.rotate_all.launches
    assert torch.equal(rotate_all_k.rotate_all(acc, a_steps, ck.bk, p), want)
    assert rotate_all_k.rotate_all.launches == before  # the plain version launches nothing


def test_rotate_all_checks_its_operands():
    p = params.TEST_PARAMS
    _, ck = _port_keys("TEST_PARAMS")
    acc = torch.zeros((2, 2, p.N), dtype=torch.int32)
    a = torch.zeros((p.n, 2), dtype=torch.int32)
    with pytest.raises(TypeError):
        rotate_all_k.rotate_all(acc, a.to(torch.int64), ck.bk, p)
    with pytest.raises(ValueError):
        rotate_all_k.rotate_all(acc, a[:, :1].contiguous(), ck.bk, p)
    with pytest.raises(ValueError):
        rotate_all_k.rotate_all(acc, a, ck.bk[:-1], p)
    with pytest.raises(ValueError):
        rotate_all_k.rotate_all(acc, a.t().contiguous().t(), ck.bk, p)


class _Spy:
    """Counts the calls of a module function and forwards them."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


def test_dispatch_rule_single_launch_then_k1_loop(monkeypatch):
    p = params.TEST_PARAMS
    _, ck = _port_keys("TEST_PARAMS")
    lat = keys.cloud_key_latency(ck)
    assert isinstance(lat.bk, keys.LatencyBK) and lat.bk.bk is ck.bk
    assert keys.cloud_key_latency(lat) is lat  # idempotent
    ra = _Spy(rotate_all_k.rotate_all)
    k1 = _Spy(cmux_k.cmux_step)
    monkeypatch.setattr(rotate_all_k, "rotate_all", ra)
    monkeypatch.setattr(cmux_k, "cmux_step", k1)
    monkeypatch.setattr(rotate_all_k, "MAX_BATCH", 4)
    tv = trlwe.trivial(torch.full((p.N,), p.mu, dtype=torch.int32))
    cts = _u32.from_numpy(_random_cts(p, 5, 14))
    want = bootstrap.blind_rotate(cts, ck.bk, tv, p)  # the standard key: the K1 loop
    assert (ra.calls, k1.calls) == (0, p.n)

    # At the cap: one single-launch rotation, no K1 step.
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = bootstrap.blind_rotate(cts[:4], lat.bk, tv, p)
    assert (ra.calls, k1.calls) == (1, p.n)
    assert torch.equal(got, want[:4])

    # Above the cap: the K1 loop, with one warning for this key, then none.
    with pytest.warns(UserWarning, match="latency-mode key"):
        got = bootstrap.blind_rotate(cts, lat.bk, tv, p)
    assert (ra.calls, k1.calls) == (1, 2 * p.n)
    assert torch.equal(got, want)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        bootstrap.blind_rotate(cts, lat.bk, tv, p)
    assert (ra.calls, k1.calls) == (1, 3 * p.n)


def test_latency_context_gates_truth_tables(monkeypatch):
    ra = _Spy(rotate_all_k.rotate_all)
    monkeypatch.setattr(rotate_all_k, "rotate_all", ra)
    ctx = TFHE.new(17, params.TEST_PARAMS, device="cpu", latency_mode=True)
    assert isinstance(ctx.ck.bk, keys.LatencyBK)
    x, y = ctx.encrypt([0, 1, 0, 1]), ctx.encrypt([0, 0, 1, 1])
    assert ctx.decrypt(ctx.nand(x, y)).tolist() == [1, 1, 1, 0]
    assert ctx.decrypt(ctx.xor(x, y)).tolist() == [0, 1, 1, 0]
    combos = np.array([[c, a, b] for c in (0, 1) for a in (0, 1) for b in (0, 1)])
    c, i0, i1 = (ctx.encrypt(combos[:, k]) for k in range(3))
    want = np.where(combos[:, 0] == 1, combos[:, 2], combos[:, 1])
    assert ctx.decrypt(ctx.mux(c, i0, i1)).tolist() == want.tolist()
    assert ra.calls == 4  # NAND, XOR, and MUX's two passes: one rotation each


@pytest.mark.slow
@pytest.mark.parametrize("B", [8, 16])  # one and two tiles of tb=8
def test_rotate_all_plain_matches_fused_rotate_all_k_interpret(B):
    from rustfhe_tpu.engine.pallas_k import PallasKaratsubaEngine

    name = "n13_N256"
    p, jp = SMALL[name]
    _, ck = _port_keys(name)
    eng = PallasKaratsubaEngine(interpret=True, tb=8, levels=1)
    bk_raw = _jax_raw_keys(name)[2]
    panels = jkeys.cloud_key_panels(
        jkeys.CloudKey(bk=eng.prepare_trgsw(jnp.asarray(bk_raw), jp), ksk=None), jp, eng)
    assert panels.bk.ndim == 4  # the panel form the single-launch kernel takes
    ct = _random_cts(p, B, 15)
    tv = jtrlwe.trivial(jnp.full((jp.N,), jp.mu, jnp.uint32))
    want = np.asarray(jbootstrap.blind_rotate(jnp.asarray(ct), panels.bk, tv, jp, eng))
    acc, a_steps = bootstrap.rotation_start(_u32.from_numpy(ct), _u32.from_numpy(np.asarray(tv)), p)
    got = rotate_all_k.rotate_all(acc, a_steps, ck.bk, p)
    assert np.array_equal(_u32.to_numpy(got), want)
