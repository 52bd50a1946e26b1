"""The port's hybrid keys (``keys.cloud_key_hybrid``, ``keys.HybridBK``) on
``"cmux_k"``'s plain path, and the panel-memory guard.

A hybrid rotation runs the even steps on their tables (K1) and the odd
steps on prebuilt panels (``cmux_k.cmux_step_panel``), with a tail step
when n is odd; with ``full_panels`` every step runs on a prebuilt panel.
On the JAX package's carried keys, the hybrid key's NAND must equal the
standard key's and JAX's word for word (tolerance zero), at TEST_PARAMS
and at a copy with odd n, with and without full panels.  The guard cases
of ``tests/test_keys_guard.py`` are replayed at the port's panel sizes
on shape-only (``meta``) keys, so nothing is allocated.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustfhe_tpu import gates as jgates
from rustfhe_tpu import keys as jkeys
from rustfhe_tpu import tlwe as jtlwe
from rustfhe_tpu.engine import get_engine
from rustfhe_tpu.params import TEST_PARAMS as J_TEST
from rustfhe_tpu_torch import _u32, gates, keys
from rustfhe_tpu_torch.engine import cmux_k
from rustfhe_tpu_torch.params import DEFAULT_PARAMS, PBS_PARAMS, TEST_PARAMS

GIB = 1024**3
V5E_HBM = 16 * GIB  # the JAX guard tests' device
H100 = 80 * 10**9
U32 = jnp.uint32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's ops here are small: one intra-op thread each, so that
    torch's idle threads do not spin on the cores parallel test workers
    need."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=[16, 13], ids=["n16", "n13"])
def carried(request):
    """JAX keys and a NAND batch at TEST_PARAMS with n = 16 or 13 (odd:
    the tail step runs), the port's keys from them, and JAX's NAND."""
    n = request.param
    jp, p = dataclasses.replace(J_TEST, n=n), TEST_PARAMS.replace(n=n)
    ks, kc, ke = jax.random.split(jax.random.PRNGKey(23), 3)
    jsk = jkeys.gen_secret_key(ks, jp)
    bk_raw, ksk_raw = jkeys.gen_cloud_key_raw(kc, jsk, jp, "matmul")
    m = get_engine("matmul")
    jck = jkeys.CloudKey(bk=m.prepare_trgsw(bk_raw, jp), ksk=m.prepare_ksk(ksk_raw, jp))
    bits = jnp.zeros((8,), U32).at[1::2].set(1)
    cx = jtlwe.encrypt_binary(jax.random.fold_in(ke, 0), jsk.lv0, bits, jp)
    cy = jtlwe.encrypt_binary(jax.random.fold_in(ke, 1), jsk.lv0, 1 - bits, jp)
    ref = np.asarray(jgates.hom_nand(jck, cx, cy, params=jp, engine_name="matmul"))
    _, ck = keys.from_jax_keys(*(np.asarray(a) for a in (jsk.lv0, jsk.lv1, bk_raw, ksk_raw)), p,
                               "cpu", "cmux_k")
    pre = gates.precombine("nand", _u32.from_numpy(np.asarray(cx)),
                           _u32.from_numpy(np.asarray(cy)), params=p)
    return p, ck, pre, ref


def _nand(ck, pre, p):
    return _u32.to_numpy(gates.hom_bootstrap(ck, pre, params=p))


@pytest.mark.parametrize("full", [False, True], ids=["odd_panels", "full_panels"])
def test_hybrid_rotation_bit_exact(carried, full):
    p, ck, pre, ref = carried
    hk = keys.cloud_key_hybrid(ck, p, "cmux_k", full_panels=full)
    hb = hk.bk
    assert isinstance(hb, keys.HybridBK) and hb.full_panels == full
    npairs, tail = p.n // 2, p.n % 2
    panel = (npairs,) + cmux_k.panel_shape(p)
    assert tuple(hb.panels_odd.shape) == panel and hb.panels_odd.dtype == torch.int8
    assert hb.prep_even.shape[0] == npairs and hb.prep_tail.shape[0] == tail
    assert tuple(hb.prep_even.shape[1:]) == (panel[1:] if full else tuple(ck.bk.shape[1:]))
    assert hk.ksk is ck.ksk
    assert np.array_equal(_nand(ck, pre, p), ref)
    assert np.array_equal(_nand(hk, pre, p), ref)


def test_hybrid_panels_are_the_steps_panels(carried):
    """Slot i of the odd panels is step 2i + 1's key panel; with full
    panels, the even and tail slots hold theirs."""
    p, ck, _, _ = carried
    hb = keys.cloud_key_hybrid(ck, p, full_panels=True).bk
    for i in (0, p.n // 2 - 1):
        assert torch.equal(hb.panels_odd[i], cmux_k.key_panel_plain(ck.bk[2 * i + 1], p))
        assert torch.equal(hb.prep_even[i], cmux_k.key_panel_plain(ck.bk[2 * i], p))
    if p.n % 2:
        assert torch.equal(hb.prep_tail[0], cmux_k.key_panel_plain(ck.bk[-1], p))


def test_panel_step_plain_equals_the_step(carried):
    """cmux_step_panel's plain version on a step's panel = cmux_step_plain
    on its table (B = 1 and 8)."""
    p, ck, pre, _ = carried
    from rustfhe_tpu_torch import bootstrap, trlwe

    mu = torch.full((p.N,), p.mu, dtype=torch.int32)
    acc, a_steps = bootstrap.rotation_start(pre, trlwe.trivial(mu), p)
    for b in (1, 8):
        for i in (0, 1, p.n - 1):
            want = cmux_k.cmux_step_plain(acc[:b], a_steps[i, :b], ck.bk[i], p)
            got = cmux_k.cmux_step_panel(acc[:b], a_steps[i, :b],
                                         cmux_k.key_panel(ck.bk[i], p), p)
            assert torch.equal(got, want)


def test_hybrid_idempotent_and_latency_tables(carried):
    p, ck, pre, ref = carried
    hk = keys.cloud_key_hybrid(ck, p)
    assert keys.cloud_key_hybrid(hk, p) is hk
    assert keys.cloud_key_hybrid(hk, p, full_panels=True) is hk
    assert keys.cloud_key_latency(hk) is hk  # a hybrid key never takes K3
    lat = keys.cloud_key_hybrid(keys.cloud_key_latency(ck), p)
    assert isinstance(lat.bk, keys.HybridBK)
    assert np.array_equal(_nand(lat, pre, p), ref)


@pytest.mark.parametrize("engine", ["limb", "matmul"])
def test_hybrid_noop_for_engines_without_pair_step(engine):
    p = TEST_PARAMS
    gen = torch.Generator().manual_seed(0)
    _, ck = keys.gen_keys(gen, p, "cpu", engine)
    out = keys.cloud_key_hybrid(ck, p, engine)
    assert out is ck
    assert keys.cloud_key_hybrid(ck, p, "cmux_k") is ck  # not a K1 table: unchanged


def _meta_key(params):
    """A shape-only prepared key: the guard reads sizes, and must raise
    before any panel is built."""
    bk = torch.empty((params.n, 2 * params.l, 2, 2 * params.N), dtype=torch.int32,
                     device="meta")
    return keys.CloudKey(bk=bk, ksk=None)


def test_no_full_panels_at_n2048_on_a_small_device():
    with pytest.raises(MemoryError, match="no latency/panel mode"):
        keys.cloud_key_hybrid(_meta_key(PBS_PARAMS), PBS_PARAMS, full_panels=True,
                              device_bytes_limit=V5E_HBM)
    with pytest.raises(MemoryError, match="no latency/panel mode"):
        keys.guard_panel_memory(keys.panels_nbytes(PBS_PARAMS, True), PBS_PARAMS,
                                "cloud_key_hybrid", V5E_HBM)
    # the half-size table fits there, and both fit the 80 GB card
    keys.guard_panel_memory(keys.panels_nbytes(PBS_PARAMS), PBS_PARAMS, "x", V5E_HBM)
    keys.guard_panel_memory(keys.panels_nbytes(PBS_PARAMS, True), PBS_PARAMS, "x", H100)


def test_panel_sizes_match_documented():
    """11.8 MB a step at DEFAULT_PARAMS (3.74 GB for the 317 odd steps, 7.49
    GB with full panels); 32.5 MB at PBS_PARAMS (11.6 GB, 23.2 GB)."""
    step = np.prod(cmux_k.panel_shape(DEFAULT_PARAMS))
    assert round(step / 1e6, 1) == 11.8
    assert round(keys.panels_nbytes(DEFAULT_PARAMS) / 1e9, 2) == 3.74
    assert round(keys.panels_nbytes(DEFAULT_PARAMS, True) / 1e9, 2) == 7.49
    assert round(np.prod(cmux_k.panel_shape(PBS_PARAMS)) / 1e6, 1) == 32.5
    assert round(keys.panels_nbytes(PBS_PARAMS) / 1e9, 1) == 11.6
    assert round(keys.panels_nbytes(PBS_PARAMS, True) / 1e9, 1) == 23.2


def test_second_large_key_is_not_refused():
    """JAX's one-large-panel-key-per-process rule guards XLA's uncompacted
    memory; the port does not carry it (torch's allocator reuses a freed
    key's blocks): a second build of the same size passes the guard."""
    need = keys.panels_nbytes(DEFAULT_PARAMS, True)
    for _ in range(2):
        keys.guard_panel_memory(need, DEFAULT_PARAMS, "cloud_key_hybrid", V5E_HBM)


def test_small_tables_never_tripped():
    for _ in range(4):
        keys.guard_panel_memory(64 * 1024**2, DEFAULT_PARAMS, "cloud_key_hybrid", V5E_HBM)


def test_unknown_limit_is_permissive():
    """On the CPU no device limit is known: nothing is blocked."""
    assert keys.card_memory_bytes("cpu") is None
    keys.guard_panel_memory(10**12, DEFAULT_PARAMS, "cloud_key_hybrid", None)
