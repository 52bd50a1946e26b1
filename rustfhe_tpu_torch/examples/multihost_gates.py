"""Multi-process gate evaluation.

Port of ``examples/multihost_gates.py``: one process per rank; every
process runs this module with its own ``--pid``.  It also runs as a single
process (a world of one).

  # rank 0                                          # rank k
  python3 -m rustfhe_tpu_torch.examples.multihost_gates \\
      --coordinator=host0:1234 --nprocs=4 --pid=0         ... --pid=k

Each rank drives one device: the card of rank % card count under NCCL, or
the CPU under gloo with ``--cpu``.  The session relies on:
  * keygen from the shared seed, the same on every rank: no key broadcast;
  * each rank feeds only its own rows of the gate batch and reads back
    only its own outputs;
  * gate batches split over ``data``, the key-switch table over ``model``
    with an exact float64 all_reduce.

Prints two lines per process: its rank and the ranks and devices of the
world, then its NAND count and whether every output decrypts right.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None,
                    help="host:port where process 0 listens (or a tcp:// or file:// URL)")
    ap.add_argument("--nprocs", type=int, default=None)
    ap.add_argument("--pid", type=int, default=None)
    ap.add_argument("--batch-per-host", type=int, default=64)
    ap.add_argument("--test-params", action="store_true",
                    help="small parameter set (quick CPU demo)")
    ap.add_argument("--cpu", action="store_true",
                    help="run every rank on the CPU under gloo (several ranks on one machine)")
    args = ap.parse_args()

    from rustfhe_tpu_torch import tlwe
    from rustfhe_tpu_torch.params import DEFAULT_PARAMS, TEST_PARAMS
    from rustfhe_tpu_torch.parallel import multihost

    params = TEST_PARAMS if args.test_params else DEFAULT_PARAMS
    device = "cpu" if args.cpu else "cuda"
    multihost.initialize(args.coordinator, args.nprocs, args.pid, device=device)
    try:
        rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
        sess = multihost.GateSession(42, params, device=device)
        print(f"process {rank}/{world}: 1 local / {multihost.global_gate_batch_size(1)} "
              f"global devices ({sess.device}, engine {sess.engine_name})", flush=True)

        rs = np.random.RandomState(1000 + rank)
        bx = rs.randint(0, 2, size=args.batch_per_host).astype(np.int32)
        by = rs.randint(0, 2, size=args.batch_per_host).astype(np.int32)
        gen = torch.Generator(device=sess.device)
        gen.manual_seed(7000 + rank)

        def enc(bits):
            ct = tlwe.encrypt_binary(gen, sess.sk.lv0, torch.from_numpy(bits).to(sess.device),
                                     params)
            return sess.feed(sess.fetch(ct))

        out = sess.nand(enc(bx), enc(by))
        dec = sess.decrypt_local(out)
        ok = bool(np.array_equal(dec, 1 - (bx & by)))
        print(f"process {rank}: {len(dec)} local NANDs, correct={ok}", flush=True)
        if not ok:
            raise SystemExit(f"process {rank}: wrong NAND outputs")
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()
