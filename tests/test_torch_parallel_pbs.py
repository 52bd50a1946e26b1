"""The port's sharded multi-output PBS and degree-sharded product
(``rustfhe_tpu_torch.parallel``) against the JAX package's, on the cases
of ``tests/test_sharding.py::test_sharded_pbs_bit_exact`` and the degree
cases of ``tests/test_transform.py``.

The JAX package makes the keys, ciphertexts and vectors and computes the
unsharded and sharded outputs on its 8-virtual-device CPU mesh; the port
runs as gloo worlds of rank processes (``torch_ranks.py``) on the meshes
(2, 1), (1, 2) and (2, 2), the 4-rank world also on (1, 4).  Tolerance
zero: the port's words equal JAX's sharded and unsharded words.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rustfhe_tpu import keys, pbs
from rustfhe_tpu.engine import get_engine
from rustfhe_tpu.parallel import make_mesh, shard_cloud_key, sharded_pbs_fn
from rustfhe_tpu.parallel.degree_sharded import (degree_sharded_external_product_fn,
                                                 shard_transform_panels)
from rustfhe_tpu.params import PBS_TEST_PARAMS, TFHEParams

from torch_ranks import World, gather

MESHES = [(2, 1), (1, 2), (2, 2)]
SPACE, T, B = 4, 2, 16
DEGREE = TFHEParams(n=16, N=64)


def _vectors(params, batch, seed):
    """tests/test_transform.py's vectors: key rows and digits."""
    rs = np.random.RandomState(seed)
    rows = rs.randint(0, 2**32, size=(2 * params.l, 2, params.N), dtype=np.uint64).astype(np.uint32)
    digits = rs.randint(-params.half_bg, params.half_bg,
                        size=(batch, 2 * params.l, params.N)).astype(np.int32)
    return rows, digits


@pytest.fixture(scope="module")
def run():
    p = PBS_TEST_PARAMS
    ks, kc = jax.random.split(jax.random.PRNGKey(13))
    sk = keys.gen_secret_key(ks, p)
    bk_raw, ksk_raw = keys.gen_cloud_key_raw(kc, sk, p, "matmul")
    m = get_engine("matmul")
    ck = keys.CloudKey(bk=m.prepare_trgsw(bk_raw, p), ksk=m.prepare_ksk(ksk_raw, p))
    rs = np.random.RandomState(9)
    xs = rs.randint(0, SPACE, size=B)
    tables = rs.randint(0, SPACE, size=(T, SPACE)).astype(np.uint32)
    ct = pbs.encrypt_int(jax.random.PRNGKey(21), sk.lv0, jnp.asarray(xs), SPACE, p)
    deg_rows, deg_digits = _vectors(DEGREE, 4, 202)
    gen_rows, gen_digits = _vectors(DEGREE, 6, 303)
    inputs = {"pbs_lv0": sk.lv0, "pbs_lv1": sk.lv1, "pbs_bk_raw": bk_raw,
              "pbs_ksk_raw": ksk_raw, "pbs_ct": ct, "tables": tables, "space": SPACE,
              "deg_rows": deg_rows, "deg_digits": deg_digits, "gen_rows": gen_rows,
              "gen_digits": gen_digits}
    worlds = {shape: World("pbs_degree", *shape, {k: np.asarray(v) for k, v in inputs.items()})
              for shape in MESHES}

    j = {"xs": xs, "tables": tables, "lv0": np.asarray(sk.lv0)}
    j["pbs"] = np.asarray(pbs.pbs_many(ck, ct, jnp.asarray(tables), space=SPACE, params=p,
                                       engine_name="matmul"))
    mesh = make_mesh(data=4, model=2)
    ck_sh = shard_cloud_key(ck, mesh)
    j["pbs_sharded"] = np.asarray(sharded_pbs_fn(mesh, p, "matmul", space=SPACE)(
        ck_sh.bk, ck_sh.ksk, ct, jnp.asarray(tables)))
    nuss = get_engine("nuss")
    for case, rows, digits in (("deg", deg_rows, deg_digits), ("gen", gen_rows, gen_digits)):
        panels = nuss.prepare_trgsw(jnp.asarray(rows), DEGREE)
        j[case] = np.asarray(nuss.external_product_digits(panels, jnp.asarray(digits), DEGREE))
        j[case + "_panels"] = panels
    oracle = get_engine("oracle")
    j["deg_oracle"] = np.asarray(oracle.external_product_digits(
        oracle.prepare_trgsw(jnp.asarray(deg_rows), DEGREE), jnp.asarray(deg_digits), DEGREE))
    for model in (2, 4):
        mesh = make_mesh(data=8 // model, model=model)
        fn = degree_sharded_external_product_fn(mesh, DEGREE, axis="model")
        j[f"deg_sharded_{model}"] = np.asarray(fn(shard_transform_panels(
            j["deg_panels"], mesh), jnp.asarray(deg_digits)))
    mesh = make_mesh(data=4, model=2)
    fn = degree_sharded_external_product_fn(mesh, DEGREE, axis="model")
    panels = shard_transform_panels(j["gen_panels"], mesh)
    j["gen0_sharded"] = np.asarray(fn(panels, jnp.asarray(gen_digits[0])))
    j["gen2_sharded"] = np.asarray(fn(panels, jnp.asarray(gen_digits.reshape(2, 3, 6, 64))))
    return j, {shape: w.results() for shape, w in worlds.items()}


@pytest.mark.parametrize("shape", MESHES)
def test_sharded_pbs_bit_exact(run, shape):
    """Data-split multi-output PBS with the model-reduction key switch:
    JAX's sharded and unsharded (pbs_many) words, every lookup right."""
    j, res = run
    got = gather(res[shape], "pbs", shape[1])
    assert np.array_equal(got, j["pbs_sharded"])
    assert np.array_equal(got, j["pbs"])
    dec = np.asarray(pbs.decrypt_int(jnp.asarray(got), jnp.asarray(j["lv0"]), SPACE))
    for t in range(T):
        assert np.array_equal(dec[:, t], j["tables"][t][j["xs"]])


def _models(shape):
    world = shape[0] * shape[1]
    return [m for m in (1, 2, 4) if world % m == 0 and m <= world]


@pytest.mark.parametrize("shape", MESHES)
def test_degree_sharded_bit_exact(run, shape):
    """N split over model with reduce-scatters between the transform's
    stages (model 1, 2 and, in the 4-rank world, 4): JAX's sharded words,
    the unsharded nuss engine's and the oracle's."""
    j, res = run
    assert np.array_equal(j["deg"], j["deg_oracle"])
    ranks = res[shape]
    for model in _models(shape):
        got = np.concatenate([ranks[r][f"deg_{model}"] for r in range(model)], axis=-1)
        assert np.array_equal(got, j["deg"]), model
        if model > 1:
            assert np.array_equal(got, j[f"deg_sharded_{model}"]), model


@pytest.mark.parametrize("shape", MESHES)
def test_degree_sharded_rank_generality(run, shape):
    """Unbatched (2L, N) digits and two leading axes (2, 3, 2L, N)."""
    j, res = run
    ranks = res[shape]
    want = j["gen"]
    for model in _models(shape):
        got0 = np.concatenate([ranks[r][f"gen0_{model}"] for r in range(model)], axis=-1)
        got2 = np.concatenate([ranks[r][f"gen2_{model}"] for r in range(model)], axis=-1)
        assert np.array_equal(got0, want[0])
        assert np.array_equal(got2, want.reshape(2, 3, *want.shape[1:]))
        if model == 2:
            assert np.array_equal(got0, j["gen0_sharded"])
            assert np.array_equal(got2, j["gen2_sharded"])
