"""The port's sharded gates (``rustfhe_tpu_torch.parallel.sharded``) against
the JAX package's, on the cases of ``tests/test_sharding.py``.

The JAX package makes the keys and ciphertexts (TEST_PARAMS, the
``"matmul"`` engine, ``PRNGKey(3)``) and computes every gate unsharded
and sharded on its 8-virtual-device CPU mesh; the port runs as gloo
worlds of 2 and 4 rank processes (``torch_ranks.py``) on the meshes (2, 1),
(1, 2) and (2, 2), on the carried keys.  Every port output, put back
together from the ranks' blocks, must equal JAX's sharded and unsharded
outputs word for word (tolerance zero): all six gates under the
``model`` reduction and the ``all_to_all`` key switch, a sharded NAND on
every key form the port has, the bootstrap with lead lanes (sharded and
whole), and the tensor-parallel gate on ``"matmul"`` and ``"fft64"``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from rustfhe_tpu import gates, keys, tlwe
from rustfhe_tpu.engine import get_engine
from rustfhe_tpu.parallel import (make_mesh, shard_cloud_key, shard_cloud_key_tp,
                                  sharded_bootstrap_fn, sharded_gate_fn, tp_gate_fn)
from rustfhe_tpu.params import TEST_PARAMS as p

from torch_ranks import World, gather

MESHES = [(2, 1), (1, 2), (2, 2)]
KINDS = ["nand", "and", "or", "xor", "not", "mux"]
FORMS = ["latency", "hybrid", "hybrid_full", "limb", "matmul"]
U32 = jnp.uint32
B = 16


@pytest.fixture(scope="module")
def run():
    """The carried keys and ciphertexts, the port's worlds (started first,
    running while JAX computes), JAX's outputs, and the worlds' results."""
    kg, ke = jax.random.split(jax.random.PRNGKey(3))
    ks, kc = jax.random.split(kg)  # keys.gen_keys(kg)'s draws, with the raw keys kept
    sk = keys.gen_secret_key(ks, p)
    bk_raw, ksk_raw = keys.gen_cloud_key_raw(kc, sk, p, "matmul")
    m = get_engine("matmul")
    ck = keys.CloudKey(bk=m.prepare_trgsw(bk_raw, p), ksk=m.prepare_ksk(ksk_raw, p))
    bx = jax.random.bernoulli(jax.random.fold_in(ke, 0), 0.5, (B,)).astype(U32)
    by = jax.random.bernoulli(jax.random.fold_in(ke, 1), 0.5, (B,)).astype(U32)
    cx = tlwe.encrypt_binary(jax.random.fold_in(ke, 2), sk.lv0, bx, p)
    cy = tlwe.encrypt_binary(jax.random.fold_in(ke, 3), sk.lv0, by, p)
    pre = jnp.stack([gates.precombine("nand", cx, cy, params=p),
                     gates.precombine("and", cx, cy, params=p)])  # (2, B, n+1)
    inputs = {"lv0": sk.lv0, "lv1": sk.lv1, "bk_raw": bk_raw, "ksk_raw": ksk_raw,
              "bk_table": ck.bk, "cx": cx, "cy": cy, "pre_lanes": pre}
    worlds = {shape: World("sharding", *shape, {k: np.asarray(v) for k, v in inputs.items()})
              for shape in MESHES}

    args = {"not": (cx,), "mux": (cx, cy, cx)}  # mux: control cx, in0 cy, in1 cx
    single = {k: gates.GATES_2IN[k](ck, cx, cy, params=p, engine_name="matmul")
              for k in ("nand", "and", "or", "xor")}
    single["not"] = gates.hom_not(ck, cx, params=p, engine_name="matmul")
    single["mux"] = gates.hom_mux(ck, cx, cy, cx, params=p, engine_name="matmul")
    mesh = make_mesh(data=4, model=2)
    ck_sh = shard_cloud_key(ck, mesh)
    ksk_data = jax.device_put(ck.ksk, NamedSharding(mesh, P("data")))
    sharded = {}
    for kind in KINDS:
        a = args.get(kind, (cx, cy))
        sharded["psum", kind] = sharded_gate_fn(mesh, p, "matmul", kind=kind)(
            ck_sh.bk, ck_sh.ksk, *a)
        sharded["all_to_all", kind] = sharded_gate_fn(
            mesh, p, "matmul", kind=kind, key_switch="all_to_all")(ck_sh.bk, ksk_data, *a)
    boot = sharded_bootstrap_fn(mesh, p, "matmul", ndim=3)(
        ck_sh.bk, ck_sh.ksk, jax.device_put(pre, NamedSharding(mesh, P(None, "data"))))
    ck_tp = shard_cloud_key_tp(ck, mesh)
    tp = tp_gate_fn(mesh, p, kind="nand")(ck_tp.bk, ck_tp.ksk, cx, cy)
    fft = get_engine("fft64")
    jax.config.update("jax_enable_x64", True)  # the JAX fft64 engine computes in float64
    try:
        fft_single = np.asarray(gates.hom_nand(keys.CloudKey(fft.prepare_trgsw(bk_raw, p), ck.ksk),
                                               cx, cy, params=p, engine_name="fft64"))
    finally:
        jax.config.update("jax_enable_x64", False)
    j = {"single": {k: np.asarray(v) for k, v in single.items()},
         "sharded": {k: np.asarray(v) for k, v in sharded.items()},
         "boot": np.asarray(boot), "tp": np.asarray(tp), "fft": np.asarray(fft_single),
         "bits": (np.asarray(bx), np.asarray(by)), "lv0": np.asarray(sk.lv0)}
    return j, {shape: w.results() for shape, w in worlds.items()}


def _dec(j, out):
    return np.asarray(tlwe.decrypt_binary(jnp.asarray(out), jnp.asarray(j["lv0"])))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("ks", ["psum", "all_to_all"])
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_gates_bit_exact(run, shape, ks, kind):
    j, res = run
    got = gather(res[shape], f"{ks}_{kind}", shape[1])
    assert np.array_equal(got, j["sharded"][ks, kind])
    assert np.array_equal(got, j["single"][kind])
    x, y = j["bits"]
    want = {"nand": 1 - (x & y), "and": x & y, "or": x | y, "xor": x ^ y, "not": 1 - x,
            "mux": np.where(x == 1, x, y)}[kind]
    assert np.array_equal(_dec(j, got), want)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("form", FORMS)
def test_sharded_nand_on_every_key_form(run, shape, form):
    """K1's plain step (tensor), K3's (latency), the hybrid pair with and
    without full panels, K4's (limb) and the matmul engine's, inside each
    rank: all give JAX's words."""
    j, res = run
    got = gather(res[shape], f"form_{form}", shape[1])
    assert np.array_equal(got, j["sharded"]["psum", "nand"])
    assert np.array_equal(got, j["single"]["nand"])


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_gate_refuses_another_engines_key(run, shape):
    _, res = run
    for r in res[shape]:
        assert "prepared for 'cmux_k'" in str(r["wrong_engine"])


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_bootstrap_lead_lanes(run, shape):
    """(2, B, n+1) pre-combined lanes: the batch axis -2 split over data,
    the lane axis whole; and the same batch computed whole on every rank
    (shard_batch=False)."""
    j, res = run
    got = gather(res[shape], "boot_lanes", shape[1], axis=1)
    assert np.array_equal(got, j["boot"])
    assert np.array_equal(got, np.stack([j["single"]["nand"], j["single"]["and"]]))
    for r in res[shape]:
        assert np.array_equal(r["boot_whole"], j["boot"])


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("engine", ["matmul", "fft64"])
def test_tp_gate_bit_exact(run, shape, engine):
    """The key's 2L rows split over model, one reduction a step."""
    j, res = run
    got = gather(res[shape], f"tp_{engine}", shape[1])
    assert np.array_equal(got, j["tp"])
    assert np.array_equal(got, j["single"]["nand"])
    if engine == "fft64":
        assert np.array_equal(got, j["fft"])
    for r in res[shape]:
        assert int(r[f"tp_rows_{engine}"]) == 2 * p.l // shape[1]


@pytest.mark.parametrize("shape", MESHES)
def test_tp_gate_other_engines_raise(run, shape):
    _, res = run
    for r in res[shape]:
        assert str(r["tp_error"]) == ("engine 'cmux_k' has no tensor-parallel row-sharded "
                                      "external product (use 'matmul' or 'fft64')")
