"""K3 (the single-launch blind rotation) and the latency path of the port.

On the CPU ``rotate_all_k.rotate_all`` runs K3's plain version.  It is held
word for word (tolerance zero: every path is exact mod 2^32) to the JAX
package's ``bootstrap.blind_rotate`` with the ``matmul`` engine, and, in
the slow test, to ``fused_rotate_all_k`` itself in interpret mode.  Keys
come from the JAX package's ``gen_cloud_key_raw`` through
``keys.from_jax_keys``; ciphertexts are random words from a numpy seed.
K3's step in its own orientation (the digit circulant as the doubled
reversed array, the key's limbs as columns; ``circulant_step_plain``) is
held to K1's plain step word for word.  The CUDA kernel is held to its
plain version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import functools
import types
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

    # Above the cap: the K1 loop, the faster path there, without a warning
    # (the latency key holds nothing beyond the standard key).
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = bootstrap.blind_rotate(cts, lat.bk, tv, p)
        assert (ra.calls, k1.calls) == (1, 2 * p.n)
        assert torch.equal(got, want)
        bootstrap.blind_rotate(cts, lat.bk, tv, p)
    assert (ra.calls, k1.calls) == (1, 3 * p.n)


def test_latency_context_gates_truth_tables(monkeypatch):
    ra = _Spy(rotate_all_k.rotate_all)
    monkeypatch.setattr(rotate_all_k, "rotate_all", ra)
    ctx = TFHE.new(17, params.TEST_PARAMS, device="cpu", latency_mode=True, engine_name="cmux_k")
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


# --------------------------------------------------------------------- #
# K3's orientation: A the doubled reversed digits, B the key's limb columns
# --------------------------------------------------------------------- #
ORIENTATION = {"TEST_PARAMS": (params.TEST_PARAMS, (1, 3)),
               "DEFAULT_PARAMS": (params.DEFAULT_PARAMS, (1, 3)),
               "N2048_PARAMS": (params.N2048_PARAMS, (3,))}


@pytest.mark.parametrize("name", sorted(ORIENTATION))
def test_circulant_step_equals_the_k1_step(name):
    p, batches = ORIENTATION[name]
    rs = np.random.RandomState(21)
    rows = rs.randint(0, 2**32, size=(2 * p.l, 2, p.N), dtype=np.uint64).astype(np.uint32)
    rows[0, 0, :3] = [0x80808080, 0x7F7F7F7F, 0xFFFFFFFF]
    key = cmux_k.plain.prepare_trgsw(_u32.from_numpy(rows))
    for B in batches:
        acc = rs.randint(0, 2**32, size=(B, 2, p.N), dtype=np.uint64).astype(np.uint32)
        acc[0, 0, :4] = [0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
        ai = rs.randint(0, 2 * p.N, size=(B,)).astype(np.int32)
        ai[0] = p.N  # the whole accumulator negated
        t_acc, t_ai = _u32.from_numpy(acc), torch.from_numpy(ai)
        got = rotate_all_k.circulant_step_plain(t_acc, t_ai, key, p)
        assert torch.equal(got, cmux_k.cmux_step_plain(t_acc, t_ai, key, p)), B


def test_k3_shape_and_exactness_checks():
    for p in (params.TEST_PARAMS, params.DEFAULT_PARAMS, params.N2048_PARAMS,
              params.PBS_PARAMS):
        rotate_all_k.check_shape(p)  # every shape the "cmux_k" engine takes
    with pytest.raises(ValueError, match="power of two"):
        rotate_all_k.check_shape(params.TEST_PARAMS.replace(N=32))
    with pytest.raises(ValueError, match="power of two"):
        rotate_all_k.check_shape(params.DEFAULT_PARAMS.replace(N=4096))
    with pytest.raises(ValueError, match="Bg <= 2\\^7"):
        rotate_all_k.check_shape(params.FAST_PARAMS)  # digits of -128 have no int8 negation
    # half_bg * 128 * 2L * N = 2^31: one past the int32 range (no preset gets there)
    edge = types.SimpleNamespace(N=2048, l=64, bgbit=7, half_bg=64)
    with pytest.raises(ValueError, match="2\\^31"):
        rotate_all_k.check_shape(edge)
    rotate_all_k.check_shape(types.SimpleNamespace(N=2048, l=63, bgbit=7, half_bg=64))
    assert rotate_all_k.takes(params.DEFAULT_PARAMS)
    assert not rotate_all_k.takes(params.FAST_PARAMS)


# Shapes of the "cmux_k" engine that K3 does not take: Bg = 2^8 (FAST_PARAMS'
# base: digits of -128 have no int8 negation) and N below 64.
K1_ONLY = {"Bg=2^8": params.TEST_PARAMS.replace(bgbit=8, l=2),
           "N=32": params.TEST_PARAMS.replace(N=32)}


@pytest.mark.parametrize("name", sorted(K1_ONLY))
def test_latency_key_takes_the_k1_loop_where_k3_does_not_take_the_shape(monkeypatch, name):
    p = K1_ONLY[name]
    assert not rotate_all_k.takes(p)
    ra, k1 = _Spy(rotate_all_k.rotate_all), _Spy(cmux_k.cmux_step)
    monkeypatch.setattr(rotate_all_k, "rotate_all", ra)
    monkeypatch.setattr(cmux_k, "cmux_step", k1)
    ctx = TFHE.new(23, p, device="cpu", latency_mode=True, engine_name="cmux_k")
    assert isinstance(ctx.ck.bk, keys.LatencyBK)
    x, y = ctx.encrypt([0, 1, 0, 1]), ctx.encrypt([0, 0, 1, 1])
    assert ctx.decrypt(ctx.nand(x, y)).tolist() == [1, 1, 1, 0]
    assert (ra.calls, k1.calls) == (0, p.n)
