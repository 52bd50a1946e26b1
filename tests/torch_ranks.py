"""Rank programs for the port's multi-rank tests, and the helper that runs a
world of them.

The tests (``test_torch_parallel*.py``, ``test_torch_multihost.py``) make
their keys and ciphertexts in JAX in the test process, write them to a
directory as npz, and start one OS process per rank of a gloo world:

    python tests/torch_ranks.py DIR SUITE RANK WORLD DATA MODEL

Each rank joins the world through a file store in DIR
(``parallel.multihost.initialize``), runs SUITE on a DATA x MODEL mesh on
the CPU, and writes its own outputs to ``DIR/out<RANK>.npz``.  This module
imports neither jax nor the JAX package, so no rank does.  ``World``
starts the ranks, waits for them with a deadline, kills exactly the
processes it started if one hangs, and returns each rank's outputs;
a test starts its worlds at once and then waits for each.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]


# --------------------------------------------------------------------- #
# The test side
# --------------------------------------------------------------------- #
class World:
    """A gloo world of rank processes running ``suite`` on a ``data`` x
    ``model`` mesh (``world`` ranks, data * model by default), started at
    once; ``results`` waits for them."""

    def __init__(self, suite: str, data: int, model: int, inputs: dict,
                 world: int | None = None):
        self.what = f"{suite} ({data} x {model})"
        self.world = world or data * model
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        self._tmp = tempfile.TemporaryDirectory()
        np.savez(os.path.join(self._tmp.name, "inputs.npz"), **inputs)
        self._procs = [subprocess.Popen(
            [sys.executable, __file__, self._tmp.name, suite, str(r), str(self.world), str(data),
             str(model)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(self.world)]

    def results(self, timeout: float = 240.0) -> list[dict]:
        """Each rank's outputs (numpy arrays by name), in rank order; a rank
        that fails or outlives ``timeout`` fails the call, and every rank
        still running is killed."""
        outs = []
        deadline = time.monotonic() + timeout
        try:
            for p in self._procs:
                outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
            for r, (p, out) in enumerate(zip(self._procs, outs)):
                if p.returncode != 0:
                    raise AssertionError(f"rank {r} of {self.what} failed:\n{out[-4000:]}")
            return [dict(np.load(os.path.join(self._tmp.name, f"out{r}.npz")))
                    for r in range(self.world)]
        finally:
            for p in self._procs:  # the exact processes started here, never by pattern
                if p.poll() is None:
                    p.kill()
                    p.wait()
            self._tmp.cleanup()


def gather(results: list[dict], name: str, model: int, axis: int = 0) -> np.ndarray:
    """A ``data``-split output put back together: the blocks of the ranks
    with model coordinate 0, in data order, along ``axis``; every rank of a
    data group must hold the same block."""
    blocks = []
    for r in range(0, len(results), model):
        for q in range(r, r + model):
            if not np.array_equal(results[q][name], results[r][name]):
                raise AssertionError(f"{name}: ranks {r} and {q} of one data group differ")
        blocks.append(results[r][name])
    return np.concatenate(blocks, axis=axis)


# --------------------------------------------------------------------- #
# The rank side
# --------------------------------------------------------------------- #
def _keys(x, prefix: str, params, engine="cmux_k"):
    from rustfhe_tpu_torch import keys

    return keys.from_jax_keys(*(x[prefix + k] for k in ("lv0", "lv1", "bk_raw", "ksk_raw")),
                              params, "cpu", engine)


def suite_sharding(x: dict, mesh, mesh_of) -> dict:
    """Every gate under both key switches, the key forms, the lead-lane
    bootstrap, and the tensor-parallel gates, at TEST_PARAMS."""
    from rustfhe_tpu_torch import _u32, keys
    from rustfhe_tpu_torch.engine import FFT64Engine
    from rustfhe_tpu_torch.parallel import (shard_cloud_key, shard_cloud_key_tp,
                                            sharded_bootstrap_fn, sharded_gate_fn, tp_gate_fn)
    from rustfhe_tpu_torch.parallel.mesh import batch_sharding
    from rustfhe_tpu_torch.params import TEST_PARAMS as p

    out = {}
    _, ck = _keys(x, "", p)
    local = batch_sharding(mesh)
    cx, cy = (local(_u32.from_numpy(x[k])) for k in ("cx", "cy"))
    args = {"not": (cx,), "mux": (cx, cy, cx)}
    for ks, axis in (("psum", "model"), ("all_to_all", "data")):
        sh = shard_cloud_key(ck, mesh, axis=axis)
        for kind in ("nand", "and", "or", "xor", "not", "mux"):
            fn = sharded_gate_fn(mesh, p, "cmux_k", kind=kind, key_switch=ks)
            out[f"{ks}_{kind}"] = fn(sh.bk, sh.ksk, *args.get(kind, (cx, cy)))

    forms = {"latency": (keys.cloud_key_latency(ck), "cmux_k"),
             "hybrid": (keys.cloud_key_hybrid(ck, p), "cmux_k"),
             "hybrid_full": (keys.cloud_key_hybrid(ck, p, full_panels=True), "cmux_k"),
             "limb": (_keys(x, "", p, "limb")[1], "limb"),
             "matmul": (_keys(x, "", p, "matmul")[1], None)}  # None: the cascade's engine
    for name, (key, engine) in forms.items():
        sh = shard_cloud_key(key, mesh)
        out[f"form_{name}"] = sharded_gate_fn(mesh, p, engine)(sh.bk, sh.ksk, cx, cy)
    try:
        sharded_gate_fn(mesh, p, "limb")(ck.bk, shard_cloud_key(ck, mesh).ksk, cx, cy)
    except ValueError as e:
        out["wrong_engine"] = np.array(str(e))

    sh = shard_cloud_key(ck, mesh)
    lanes = _u32.from_numpy(x["pre_lanes"])  # (2, B, n+1): the batch axis is -2
    boot = sharded_bootstrap_fn(mesh, p, "cmux_k", ndim=3)
    out["boot_lanes"] = boot(sh.bk, sh.ksk, batch_sharding(mesh, dim=1)(lanes))
    whole = sharded_bootstrap_fn(mesh, p, "cmux_k", ndim=3, shard_batch=False)
    out["boot_whole"] = whole(sh.bk, sh.ksk, lanes)

    _, mck = keys.from_jax_keys(x["lv0"], x["lv1"], x["bk_raw"], x["ksk_raw"], p, "cpu",
                                "matmul", bk_table=x["bk_table"])
    fft = FFT64Engine()
    fck = keys.CloudKey(keys.GenericBK(fft.prepare_trgsw(_u32.from_numpy(x["bk_raw"]), p),
                                       "fft64"), mck.ksk)
    for name, key in (("matmul", mck), ("fft64", fck)):
        tp = shard_cloud_key_tp(key, mesh)
        out[f"tp_{name}"] = tp_gate_fn(mesh, p, "nand", name)(tp.bk, tp.ksk, cx, cy)
        out[f"tp_rows_{name}"] = np.array(tp.bk.table.shape[1])
    try:
        tp_gate_fn(mesh, p, "nand", "cmux_k")
    except TypeError as e:
        out["tp_error"] = np.array(str(e))
    return out


def suite_pbs_degree(x: dict, mesh, mesh_of) -> dict:
    """The sharded multi-output PBS at PBS_TEST_PARAMS, then the
    degree-sharded product on every model size the world has."""
    import torch

    from rustfhe_tpu_torch import _u32
    from rustfhe_tpu_torch.engine import get_engine
    from rustfhe_tpu_torch.parallel import shard_cloud_key, sharded_pbs_fn
    from rustfhe_tpu_torch.parallel.degree_sharded import (degree_sharded_external_product_fn,
                                                           shard_transform_panels)
    from rustfhe_tpu_torch.parallel.mesh import batch_sharding, shard
    from rustfhe_tpu_torch.params import PBS_TEST_PARAMS, TFHEParams

    out = {}
    p = PBS_TEST_PARAMS
    _, ck = _keys(x, "pbs_", p)
    sh = shard_cloud_key(ck, mesh)
    ct = batch_sharding(mesh)(_u32.from_numpy(x["pbs_ct"]))
    fn = sharded_pbs_fn(mesh, p, space=int(x["space"]))
    out["pbs"] = fn(sh.bk, sh.ksk, ct, torch.from_numpy(x["tables"]))

    q = TFHEParams(n=16, N=64)
    nuss = get_engine("nuss")
    world = torch.distributed.get_world_size()
    for model in sorted({1, 2, world} & {m for m in (1, 2, 4) if world % m == 0}):
        m = mesh_of(world // model, model)
        for case in ("deg", "gen"):
            panels = shard_transform_panels(nuss.prepare_trgsw(
                _u32.from_numpy(x[f"{case}_rows"]), q), m)
            digits = torch.from_numpy(x[f"{case}_digits"])
            fn = degree_sharded_external_product_fn(m, q)
            if case == "deg":
                out[f"deg_{model}"] = fn(panels, shard(digits, m, "model", dim=-1))
            else:
                out[f"gen0_{model}"] = fn(panels, shard(digits[0], m, "model", dim=-1))
                d2 = digits.reshape((2, 3) + digits.shape[1:])
                out[f"gen2_{model}"] = fn(panels, shard(d2, m, "model", dim=-1))
    return out


def suite_session(x: dict, mesh, mesh_of) -> dict:
    """GateSession at TEST_PARAMS: its own keygen (decrypted results), and
    a session on the carried keys (ciphertext words)."""
    from rustfhe_tpu_torch import FheUint, _u32, gates
    from rustfhe_tpu_torch.apps.circuits import Circuit, evaluate_encrypted, ripple_carry_adder
    from rustfhe_tpu_torch.parallel import multihost
    from rustfhe_tpu_torch.parallel.mesh import axis_size, batch_sharding
    from rustfhe_tpu_torch.params import TEST_PARAMS as p

    out = {}
    model = axis_size(mesh, "model")
    sess = multihost.GateSession(5, p, model=model, device="cpu")
    out["engine"] = np.array(sess.engine_name)
    out["global_batch"] = np.array(multihost.global_gate_batch_size(2))
    # every rank encrypts the whole batch from the same stream; each feeds its rows
    bx, by = x["bx"], x["by"]
    cx, cy = sess.encrypt(bx), sess.encrypt(by)
    local = batch_sharding(sess.mesh)
    gx, gy = sess.feed(sess.fetch(local(cx))), sess.feed(local(cy))
    out["nand"] = sess.decrypt_local(sess.nand(gx, gy))
    out["xor"] = sess.decrypt_local(sess.xor(gx, gy))
    out["mux"] = sess.decrypt_local(sess.mux(gx, gy, gx))
    out["not"] = sess.decrypt_local(sess.not_(gx))
    out["fetch"] = sess.fetch(sess.and_(gx, gy))
    out["fetch_ref"] = _u32.to_numpy(gates.hom_bootstrap(
        sess.ck, gates.precombine("and", gx, gy, params=p), params=p))

    circuit = ripple_carry_adder(2)
    adds = evaluate_encrypted(circuit, sess, sess.encrypt(x["adder_bits"]))
    out["adder"] = sess.decrypt(adds).numpy()
    c = Circuit(n_inputs=2)
    w = c.xor(0, 1)
    c.outputs = [c.nand(w, 0)]
    out["small_levels"] = sess.decrypt(
        evaluate_encrypted(c, sess, sess.encrypt(np.array([1, 0])))).numpy()

    av, bv = x["av"], x["bv"]
    a, b = FheUint.encrypt(sess, av, 3), FheUint.encrypt(sess, bv, 3)
    out["uint_add"], out["uint_xor"] = (a + b).decrypt(), (a ^ b).decrypt()
    out["uint_min"] = a.min_(b).decrypt()

    # the carried keys: bootstrap_raw word for word
    sk, ck = _keys(x, "", p)
    carried = multihost.GateSession.from_keys(sk, ck, p, model=model, device="cpu")
    lanes = _u32.from_numpy(x["pre_lanes"])
    out["raw_lanes"] = carried.bootstrap_raw(lanes)  # (2, B, n+1), every rank whole
    out["raw_odd"] = carried.bootstrap_raw(lanes[0, :3])  # 3 rows: computed whole
    out["raw_one"] = carried.bootstrap_raw(lanes[0, 0])  # (n+1,)
    cxc, cyc = (local(_u32.from_numpy(x[k])) for k in ("cx", "cy"))
    out["carried_nand"] = carried.nand(carried.feed(cxc), carried.feed(cyc))
    return out


def suite_dp_gates(x: dict, mesh, mesh_of) -> dict:
    """The four-card gate server's request path at TEST_PARAMS on K1's plain
    version: ``gates.gate_circuit`` over ``GateSession.bootstrap_raw`` on
    the whole batch, every gate at each batch size, with the tracer on;
    each gate call's ``bootstrap``, ``extract``, ``key_switch`` and
    ``collective`` spans in the order they closed, as JSON."""
    import json

    from rustfhe_tpu_torch import _u32, gates
    from rustfhe_tpu_torch.parallel import multihost
    from rustfhe_tpu_torch.parallel.mesh import axis_size
    from rustfhe_tpu_torch.params import TEST_PARAMS as p
    from rustfhe_tpu_torch.utils import trace

    out = {}
    sk, ck = _keys(x, "", p)
    sess = multihost.GateSession.from_keys(sk, ck, p, model=axis_size(mesh, "model"),
                                           device="cpu")
    spans = {}
    trace.enable()
    try:
        for b in x["batches"].tolist():
            cts = [_u32.from_numpy(x[f"in{j}_{b}"]) for j in range(3)]
            for op, arity in gates.GATE_INPUTS.items():
                trace.clear()
                out[f"{op}_{b}"] = gates.gate_circuit(op, cts[:arity], params=p,
                                                      boot=sess.bootstrap_raw)
                spans[f"{op}_{b}"] = [
                    [r.name, r.attrs] for r in trace.records()
                    if r.name in ("bootstrap", "extract", "key_switch", "collective")]
    finally:
        trace.enable(False)
        trace.clear()
    out["spans"] = np.array(json.dumps(spans))
    return out


SUITES = {"sharding": suite_sharding, "pbs_degree": suite_pbs_degree,
          "session": suite_session, "dp_gates": suite_dp_gates}


def _main(tmp: str, suite: str, rank: int, world: int, data: int, model: int) -> None:
    import torch

    torch.set_num_threads(1)
    from rustfhe_tpu_torch.parallel import make_mesh, multihost

    multihost.initialize(f"file://{os.path.join(tmp, 'store')}", world, rank, device="cpu")
    try:
        x = dict(np.load(os.path.join(tmp, "inputs.npz")))
        meshes = {}

        def mesh_of(d: int, m: int):
            if (d, m) not in meshes:  # every rank builds every mesh, in one order
                meshes[d, m] = make_mesh(data=d, model=m)
            return meshes[d, m]

        out = SUITES[suite](x, mesh_of(data, model), mesh_of)
        arrays = {k: (v.numpy().view(np.uint32) if v.dtype == torch.int32 else v.numpy())
                  if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in out.items()}
        np.savez(os.path.join(tmp, f"out{rank}.npz"), **arrays)
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    try:
        _main(sys.argv[1], sys.argv[2], *(int(a) for a in sys.argv[3:7]))
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
