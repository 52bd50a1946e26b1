"""The port's ``GateSession`` (``rustfhe_tpu_torch.parallel.multihost``) on
gloo worlds of rank processes, and its two-process example.

The cases of ``tests/test_sharding.py``'s session tests and
``tests/test_ints.py::test_fheuint_mesh_sharded``: a session's own keygen
is random, so its gates, the level-fused circuit evaluator and the
``FheUint`` ops on it are held to the values they decrypt to; a session on
the JAX package's carried keys (``GateSession.from_keys``) is held to
JAX's words (tolerance zero): ``bootstrap_raw`` on a lead-lane batch, on
a batch that ``data`` does not divide and on one (n+1,) ciphertext, and a
sharded NAND.  Meshes (2, 1), (1, 2) and (2, 2).  Then two OS processes
run ``python -m rustfhe_tpu_torch.examples.multihost_gates`` as
``tests/test_multihost_procs.py`` runs the JAX example.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rustfhe_tpu import gates, keys, tlwe
from rustfhe_tpu.engine import get_engine
from rustfhe_tpu.params import TEST_PARAMS as p

from torch_ranks import REPO, World, gather

MESHES = [(2, 1), (1, 2), (2, 2)]
U32 = jnp.uint32
B = 16


@pytest.fixture(scope="module")
def run():
    ks, kc = jax.random.split(jax.random.PRNGKey(3))
    sk = keys.gen_secret_key(ks, p)
    bk_raw, ksk_raw = keys.gen_cloud_key_raw(kc, sk, p, "matmul")
    m = get_engine("matmul")
    ck = keys.CloudKey(bk=m.prepare_trgsw(bk_raw, p), ksk=m.prepare_ksk(ksk_raw, p))
    rs = np.random.RandomState(4)
    bx, by = rs.randint(0, 2, size=B), rs.randint(0, 2, size=B)
    cx = tlwe.encrypt_binary(jax.random.PRNGKey(30), sk.lv0, jnp.asarray(bx, U32), p)
    cy = tlwe.encrypt_binary(jax.random.PRNGKey(31), sk.lv0, jnp.asarray(by, U32), p)
    pre = jnp.stack([gates.precombine("nand", cx, cy, params=p),
                     gates.precombine("and", cx, cy, params=p)])  # (2, B, n+1)
    pairs = rs.randint(0, 4, size=(B, 2))
    adder_bits = np.array([[(a >> i) & 1 for i in range(2)] + [(b >> i) & 1 for i in range(2)]
                           for a, b in pairs])
    av, bv = rs.randint(0, 8, size=B).astype(np.uint64), rs.randint(0, 8, size=B).astype(np.uint64)
    inputs = {"lv0": sk.lv0, "lv1": sk.lv1, "bk_raw": bk_raw, "ksk_raw": ksk_raw, "cx": cx,
              "cy": cy, "pre_lanes": pre, "bx": bx, "by": by, "adder_bits": adder_bits,
              "av": av, "bv": bv}
    worlds = {shape: World("session", *shape, {k: np.asarray(v) for k, v in inputs.items()})
              for shape in MESHES}
    boot = gates.hom_bootstrap(ck, pre, params=p, engine_name="matmul")
    j = {"bx": bx, "by": by, "pairs": pairs, "av": av, "bv": bv,
         "lanes": np.asarray(boot),
         "one": np.asarray(gates.hom_bootstrap(ck, pre[0, 0], params=p, engine_name="matmul")),
         "nand": np.asarray(gates.hom_nand(ck, cx, cy, params=p, engine_name="matmul"))}
    return j, {shape: w.results() for shape, w in worlds.items()}


@pytest.mark.parametrize("shape", MESHES)
def test_session_gates_feed_fetch(run, shape):
    """The session's own keys: every rank's fed rows through NAND, XOR,
    MUX, NOT decrypt right, and ``fetch`` of an AND equals the unsharded
    bootstrap of the same rows on the same keys."""
    j, res = run
    x, y = j["bx"], j["by"]
    want = {"nand": 1 - (x & y), "xor": x ^ y, "mux": np.where(x == 1, x, y), "not": 1 - x}
    for kind, bits in want.items():
        assert np.array_equal(gather(res[shape], kind, shape[1]), bits), kind
    assert np.array_equal(gather(res[shape], "fetch", shape[1]),
                          gather(res[shape], "fetch_ref", shape[1]))
    for r in res[shape]:
        assert str(r["engine"]) == "matmul"
        assert int(r["global_batch"]) == 2 * shape[0] * shape[1]


@pytest.mark.parametrize("shape", MESHES)
def test_session_circuit_evaluator(run, shape):
    """evaluate_encrypted on a session: a 2-bit adder over a batch of 16
    (each level's bootstrap split over data), and a circuit of one-gate
    levels (computed whole on every rank)."""
    j, res = run
    sums = j["pairs"][:, 0] + j["pairs"][:, 1]
    want = np.stack([(sums >> i) & 1 for i in range(3)], axis=1)
    for r in res[shape]:
        assert np.array_equal(r["adder"], want)
        assert np.array_equal(r["small_levels"], [1 - ((1 ^ 0) & 1)])


@pytest.mark.parametrize("shape", MESHES)
def test_session_fheuint(run, shape):
    """FheUint on a session, unchanged: +, ^ and min_ at 3 bits."""
    j, res = run
    av, bv = j["av"], j["bv"]
    for r in res[shape]:
        assert np.array_equal(r["uint_add"], (av + bv) & np.uint64(7))
        assert np.array_equal(r["uint_xor"], av ^ bv)
        assert np.array_equal(r["uint_min"], np.minimum(av, bv))


@pytest.mark.parametrize("shape", MESHES)
def test_session_bootstrap_raw_carried_keys(run, shape):
    """bootstrap_raw on the JAX keys: the (2, B, n+1) lanes split over data
    on axis -2 and gathered back, a 3-row batch and one (n+1,) ciphertext
    computed whole: JAX's words on every rank; and the session's NAND."""
    j, res = run
    for r in res[shape]:
        assert np.array_equal(r["raw_lanes"], j["lanes"])
        assert np.array_equal(r["raw_odd"], j["lanes"][0, :3])
        assert np.array_equal(r["raw_one"], j["one"])
    assert np.array_equal(gather(res[shape], "carried_nand", shape[1]), j["nand"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_example():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rustfhe_tpu_torch.examples.multihost_gates",
         f"--coordinator=localhost:{port}", "--nprocs=2", f"--pid={pid}", "--cpu",
         "--test-params", "--batch-per-host=16"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in (0, 1)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=180)[0])
    finally:
        for proc in procs:  # the exact processes started here, never by pattern
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for pid, (proc, out) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"process {pid} failed:\n{out[-2000:]}"
        assert f"process {pid}/2: 1 local / 2 global devices" in out, out[-2000:]
        assert f"process {pid}: 16 local NANDs, correct=True" in out, out[-2000:]


def test_ranks_and_the_parallel_package_import_no_jax():
    """What a rank process loads (the rank programs, the port's parallel
    package and its example) pulls in no jax and nothing of the JAX
    package."""
    code = ("import sys; sys.path.insert(0, 'tests'); import torch_ranks, "
            "rustfhe_tpu_torch.parallel, rustfhe_tpu_torch.examples.multihost_gates; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'rustfhe_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stdout + out.stderr


def test_cuda_mesh_and_nccl_without_a_card_raise():
    """No fallback hides the device: without a card, an NCCL group, a CUDA
    session and a CUDA mesh raise (a world of one gloo process here)."""
    import torch

    from rustfhe_tpu_torch.parallel import make_mesh, multihost
    from rustfhe_tpu_torch.params import TEST_PARAMS

    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card errors cannot show")
    with pytest.raises(RuntimeError, match="is_available"):
        multihost.initialize()  # the default device is the card
    with pytest.raises(RuntimeError, match="is_available"):
        multihost.initialize(backend="nccl", device="cpu")
    multihost.initialize(device="cpu")
    try:
        with pytest.raises(RuntimeError, match="is_available"):
            make_mesh(device_type="cuda")
        with pytest.raises(RuntimeError, match="is_available"):
            multihost.GateSession(0, TEST_PARAMS)
    finally:
        multihost.shutdown()
