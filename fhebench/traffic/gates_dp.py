"""Wide gate levels split over cards: each request is one of the six gates
on ``lanes`` lanes, composed as the TFHE context composes it
(``gates.gate_circuit``) with ``parallel.multihost.GateSession``'s
bootstrap on the configuration's ``mesh`` (data x model ranks, one card
each): every rank holds the whole batch, bootstraps its ``data`` block and
gathers the blocks back.

Rank 0 is the harness's process on the harness's device.  It starts ranks
1.. as OS processes (``python -m fhebench.traffic.gates_dp <json>``), each
on the card of its rank under NCCL (gloo on the CPU), joined through a
file store in a temporary directory (``multihost.initialize``).  In set-up
rank 0 broadcasts the raw key words and the encrypted pool; each peer
makes its keys from the words (``keys.from_jax_keys``, the engine rank 0
runs, admitted on its own card), and every rank opens its session
(``GateSession.from_keys``).  A request is one header line, the gate and
the pool index, written to every peer's standard input; then every rank
runs the gate on the whole batch, and the request ends synchronised once
rank 0 holds the gathered output.  The header does not go through a
collective, so a peer waits on its input, with no collective's timeout,
while rank 0 does the harness's work between requests.

A peer exits on the ``stop`` line, at the end of its input, and when its
parent process is gone.  Rank 0 stops the peers at the start of ``judge``;
it kills them when a request fails, at exit and on SIGTERM; a dead peer
fails the next collective (gloo at once, NCCL at ``multihost.TIMEOUT``).

The harness writes one device into the result line; a run of this
generator reports the cards its ranks ran on instead (``count_cards``:
the distinct devices of the world, gathered in set-up, all of rank 0's
kind or the set-up fails), through a wrapper of ``harness._run`` that
reads ``Traffic.cards`` and leaves other generators' lines as they are.

Mix parameters: those of ``gates`` (``gates``, ``lanes``, ``pool``,
``check.requests``, ``check.lanes``); the lanes recomputed word for word
are ``check.lanes / data`` drawn in each card's block, so every card's
rows are checked.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from fhebench import harness
from fhebench.reference import tfhe as ref
from fhebench.traffic import gates

PEER = ["-m", "fhebench.traffic.gates_dp"]  # the module each peer runs
STOP_S = 60.0  # how long a peer may take to leave after the stop line


class Traffic(gates.Traffic):
    probes = ({"target": "rustfhe_tpu_torch.parallel.sharded:_bootstrap_local", "kind": "gate",
               "ct": 0},)

    def __init__(self, run):
        from rustfhe_tpu_torch.parallel import multihost

        super().__init__(run)  # the bits, the encrypted pool, the schedule
        mesh = run.config["mesh"]
        self.data, self.model = int(mesh["data"]), int(mesh["model"])
        if self.lanes % self.data or run.mix["check"]["lanes"] % self.data:
            raise ValueError(f"data = {self.data} must divide lanes = {self.lanes} and "
                             f"check.lanes = {run.mix['check']['lanes']}")
        self.peers = Peers(run, self.data * self.model, self.model, self.cts.shape)
        try:
            self.peers.start()
            self.cards = count_cards(gather_devices(run.device))
            keys = run.keys
            for t in (keys.s0, keys.s1, keys.bk, keys.ksk):
                dist.broadcast(t, src=0)
            self.sess = multihost.GateSession.from_keys(run.ctx.sk, run.ctx.ck, run.params,
                                                        model=self.model, device=run.device)
            dist.broadcast(self.cts, src=0)
            harness.sync(run.device)
        except BaseException:
            self.peers.close(kill=True)
            raise

    def send(self, req):
        op, k = req
        try:
            self.peers.tell(f"{op} {k}")
            out = serve(self.sess, op, self.cts[k])
            harness.sync(self.run.device)
        except BaseException:
            self.peers.close(kill=True)
            raise
        return out

    def judge(self, run):
        self.peers.close()
        self.sess = None
        return super().judge(run)

    def _words(self, run) -> int:
        """Recompute the sampled lanes of sampled requests from the inputs:
        every first pass in one reference bootstrap, the MUXes' second pass
        in another; the lanes of a request are drawn alike in each card's
        block."""
        chk = run.mix["check"]
        picks = run.rng.choice(len(run.records), min(chk["requests"], len(run.records)),
                               replace=False)
        rp, keys = run.rp, run.keys
        block, per = self.lanes // self.data, chk["lanes"] // self.data
        pre, entries, offset = [], [], 0  # entries: (op, offset in pre, lanes, program's rows)
        for j in sorted(picks):
            op, k = run.records[j].req
            lanes = np.concatenate([d * block + np.sort(run.rng.choice(block, per, replace=False))
                                    for d in range(self.data)])
            lanes = torch.as_tensor(lanes, device=run.device)
            x, y, z = (self.cts[k][a][lanes] for a in range(3))
            if op == "mux":
                rows = [ref.precombine("and", x, z, rp), ref.precombine("andn", x, y, rp)]
            else:
                rows = [ref.precombine(op, x, y if op != "not" else None, rp)]
            pre.extend(rows)
            entries.append((op, offset, len(lanes), run.records[j].out[lanes]))
            offset += len(rows) * len(lanes)
        first = ref.gate_bootstrap(torch.cat(pre), keys, rp)
        mux = [(o, n) for op, o, n, _ in entries if op == "mux"]
        if mux:
            second = ref.gate_bootstrap(torch.cat([
                ref.precombine("or", first[o:o + n], first[o + n:o + 2 * n], rp) for o, n in mux]),
                keys, rp)
        wrong = pos = 0
        for op, o, n, got in entries:
            if op == "mux":
                want, pos = second[pos:pos + n], pos + n
            else:
                want = first[o:o + n]
            wrong += int((want != got).sum())
        return wrong


def device_info(device: torch.device) -> dict:
    """What names this rank's device: its host, its kind and, on a card,
    its index and UUID."""
    info = {"host": socket.gethostname(), "type": device.type, "kind": device.type}
    if device.type == "cuda":
        index = torch.cuda.current_device() if device.index is None else device.index
        props = torch.cuda.get_device_properties(index)
        info.update(kind=props.name, index=index, uuid=str(getattr(props, "uuid", "")))
    return info


def gather_devices(device: torch.device) -> list[dict]:
    """Every rank's ``device_info``, in rank order (a collective: every rank
    calls it once, right after it joins the world)."""
    infos = [None] * dist.get_world_size()
    dist.all_gather_object(infos, device_info(device))
    return infos


def count_cards(infos: list[dict]) -> int:
    """The distinct devices the ranks ran on (the CPU of a host is one); a
    world whose devices are not all of rank 0's kind is refused, since the
    result line names one kind."""
    kinds = {i["kind"] for i in infos}
    if kinds != {infos[0]["kind"]}:
        raise RuntimeError(f"the ranks run on devices of {len(kinds)} kinds: {sorted(kinds)}")
    return len({(i["host"], i["type"], i.get("index"), i.get("uuid")) for i in infos})


def _reporting_cards(run_fn):
    """``harness._run`` whose line gives ``device.count`` as the cards a
    multi-rank generator ran on (``run.traffic.cards``)."""
    def _run(run, *args, **kwargs):
        result = run_fn(run, *args, **kwargs)
        cards = getattr(run.traffic, "cards", None)
        if cards:
            result["device"]["count"] = cards
        return result

    _run.reports_cards = True
    return _run


if not getattr(harness._run, "reports_cards", False):
    harness._run = _reporting_cards(harness._run)


def serve(sess, op: str, cts: torch.Tensor) -> torch.Tensor:
    """One request on one rank: gate ``op`` of the pool set ``cts`` (3,
    lanes, n+1), every bootstrap through the session's."""
    from rustfhe_tpu_torch.gates import GATE_INPUTS, gate_circuit

    return gate_circuit(op, tuple(cts[:GATE_INPUTS[op]]), params=sess.params,
                        boot=sess.bootstrap_raw)


class Peers:
    """Ranks 1..world-1 of a world whose rank 0 is this process."""

    def __init__(self, run, world: int, model: int, pool_shape):
        self.run, self.world = run, world
        self.procs: list[subprocess.Popen] = []
        self.tmp = tempfile.mkdtemp(prefix="fhebench-dp-")
        self.store = os.path.join(self.tmp, "store")
        p = run.params
        self.spec = {"world": world, "model": model, "store": self.store,
                     "device": run.device.type, "engine": run.ctx.engine_name,
                     "params": {k: getattr(p, k) for k in p.__dataclass_fields__},
                     "pool_shape": list(pool_shape)}
        self._term = None  # the SIGTERM handler to put back, while ours is in place

    def start(self) -> None:
        from rustfhe_tpu_torch.parallel import multihost

        repo = str(harness.ROOT.parent)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [repo] + [q for q in os.environ.get("PYTHONPATH", "").split(os.pathsep) if q]))
        atexit.register(self.close, kill=True)
        if threading.current_thread() is threading.main_thread():
            self._term = signal.signal(signal.SIGTERM, _exit_on_term) or signal.SIG_DFL
        for r in range(1, self.world):
            self.procs.append(subprocess.Popen(
                [sys.executable, *PEER, json.dumps({**self.spec, "rank": r})], cwd=repo, env=env,
                stdin=subprocess.PIPE, stdout=2, text=True))
        print(f"# {self.run.name}: peers {[q.pid for q in self.procs]}", file=sys.stderr,
              flush=True)
        multihost.initialize(f"file://{self.store}", self.world, 0, device=self.run.device)

    def tell(self, line: str) -> None:
        for q in self.procs:
            q.stdin.write(line + "\n")
            q.stdin.flush()

    def close(self, kill: bool = False) -> None:
        """Stop the peers (kill them with ``kill``), leave the world, and
        wait for them.  Idempotent."""
        from rustfhe_tpu_torch.parallel import multihost

        atexit.unregister(self.close)
        if self._term is not None:
            signal.signal(signal.SIGTERM, self._term)
            self._term = None
        for q in self.procs:
            if kill and q.poll() is None:
                q.kill()
            with contextlib.suppress(OSError):  # a dead peer's pipe
                q.stdin.write("stop\n")
            with contextlib.suppress(OSError):
                q.stdin.close()
        # Every rank leaves the world at once: NCCL's teardown waits for the
        # other ranks.  Under NCCL a world whose peers were killed is left to
        # the process's exit, since its teardown would wait for the dead.
        if not (kill and dist.is_initialized() and dist.get_backend() == "nccl"):
            multihost.shutdown()
        deadline = time.monotonic() + STOP_S
        for q in self.procs:
            try:
                q.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                q.kill()
                q.wait()
        failed = [q.returncode for q in self.procs if q.returncode != 0]
        self.procs = []
        if os.path.isdir(self.tmp):
            for name in os.listdir(self.tmp):
                os.unlink(os.path.join(self.tmp, name))
            os.rmdir(self.tmp)
        if failed and not kill:
            raise RuntimeError(f"a peer exited with {failed}")


def _exit_on_term(signum, frame):
    raise SystemExit(128 + signum)


# --------------------------------------------------------------------- #
# A peer: rank 1.. of the world
# --------------------------------------------------------------------- #
def _watch_parent() -> None:
    """End this process when the process that started it is gone."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(0.5)
        os._exit(3)

    threading.Thread(target=watch, daemon=True).start()


def peer(spec: dict) -> None:
    _watch_parent()
    from rustfhe_tpu_torch import keys as pkeys
    from rustfhe_tpu_torch.engine import select_engine
    from rustfhe_tpu_torch.params import TFHEParams
    from rustfhe_tpu_torch.parallel import multihost

    if spec["device"] == "cpu":
        torch.set_num_threads(1)
    multihost.initialize(f"file://{spec['store']}", spec["world"], spec["rank"],
                         device=spec["device"])
    try:
        device = torch.device(spec["device"])
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())  # the rank's card
        gather_devices(device)
        p = TFHEParams(**spec["params"])
        words = [torch.empty(shape, dtype=torch.int32, device=device) for shape in (
            (p.n,), (p.N,), (p.n, 2 * p.l, 2, p.N), (p.N, p.iks_l, p.iks_t, p.n + 1))]
        for t in words:
            dist.broadcast(t, src=0)
        engine = select_engine(p, device, spec["engine"])
        sk, ck = pkeys.from_jax_keys(*(t.cpu().numpy().view(np.uint32) for t in words), p,
                                     device, engine=engine)
        del words
        sess = multihost.GateSession.from_keys(sk, ck, p, model=spec["model"], device=device)
        pool = torch.empty(spec["pool_shape"], dtype=torch.int32, device=device)
        dist.broadcast(pool, src=0)
        for line in sys.stdin:
            cmd = line.split()
            if cmd == ["stop"]:
                break
            serve(sess, cmd[0], pool[int(cmd[1])])
            harness.sync(device)
    finally:
        multihost.shutdown()
    found = harness.forbidden_modules()
    if found:
        print(f"rank {spec['rank']} imported {', '.join(found)}", file=sys.stderr)
        sys.exit(3)


if __name__ == "__main__":
    peer(json.loads(sys.argv[1]))
