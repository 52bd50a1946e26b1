"""Multi-process scale-out: the gate-evaluation session over a process group.

Counterpart of ``rustfhe_tpu/parallel/multihost.py``.  The JAX package runs
one SPMD program over every host's devices; here each process is one rank
of a ``torch.distributed`` world with one device (one card under NCCL, or
the CPU under gloo), the mesh is a grid of ranks (``parallel.mesh``), and
the sharded functions are local bodies with explicit collectives
(``parallel.sharded``).

* ``initialize`` joins the world (or forms a world of one process).
* ``GateSession``: every rank derives the SAME keys from the shared seed
  on the same device type (``torch.Generator`` streams are deterministic),
  so no key is broadcast; it splits the KSK over ``model`` and exposes the
  six sharded gates.  "Host-local" is rank-local here: ``feed`` takes this
  rank's rows, ``fetch`` returns them.
* ``GateSession.bootstrap_raw`` is what ``apps.circuits.evaluate_encrypted``
  and ``ints.FheUint`` call with a whole level batch, which every rank
  holds: it bootstraps this rank's ``data`` block of the batch axis and
  gathers the blocks back over ``data``.
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

from .. import tlwe, torus
from .._device import resolve_device
from .._u32 import from_numpy, to_numpy
from ..engine import resolve_engine, select_engine
from ..keys import CloudKey, SecretKey, cloud_key_latency, gen_keys
from ..params import TFHEParams
from .mesh import axis_size, collective, group, make_mesh, shard
from .sharded import (GATE_INPUTS, key_engine, shard_cloud_key, sharded_bootstrap_fn,
                      sharded_gate_fn)

TIMEOUT = datetime.timedelta(seconds=60)  # a hung peer fails the collective, not the caller


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device="cuda") -> None:
    """Join the process group: ``num_processes`` processes rendezvous at
    ``coordinator_address`` ("host:port", where process 0 listens, or a
    ``tcp://`` or ``file://`` URL), this one as rank ``process_id``.  With
    no address, a world of this process alone.

    ``backend`` defaults to ``"nccl"`` for a CUDA ``device`` (the card of
    rank % device count is made current first) and ``"gloo"`` on the CPU;
    NCCL, or a CUDA device, on a host with no card raises.  A collective
    that waits longer than ``TIMEOUT`` fails."""
    device = resolve_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl":
        resolve_device("cuda")
    rank = process_id or 0
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if coordinator_address is None:
        if num_processes not in (None, 1):
            raise ValueError(f"{num_processes} processes need a coordinator_address")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=TIMEOUT)
        return
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator_address needs num_processes and process_id")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url, rank=process_id,
                            world_size=num_processes, timeout=TIMEOUT)


def shutdown() -> None:
    """Leave the process group (every rank calls it)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_device(device) -> torch.device:
    """The rank's device: a CUDA device without an index is the current card."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def global_gate_batch_size(per_device_batch: int) -> int:
    """The global batch across every rank (one device each)."""
    return per_device_batch * dist.get_world_size()


def make_global_mesh(model: int = 1, device_type: str | None = None):
    """The (data, model) mesh over every rank of the world."""
    return make_mesh(model=model, device_type=device_type)


class GateSession:
    """Sharded gate-evaluation session over the initialised world.

    >>> sess = GateSession(42, params)   # every rank, the same seed
    >>> x = sess.feed(local_cts)         # this rank's rows
    >>> out = sess.nand(x, y)
    >>> mine = sess.fetch(out)           # numpy uint32, this rank's rows

    ``engine_name`` defaults to the cascade's engine (``TFHE.new``'s rule;
    the JAX session's default is ``"matmul"``), admitted by its oracle
    probe on the rank's device.  ``latency_mode`` marks the key for K3
    (``keys.cloud_key_latency``).  ``device``: the CUDA card of this rank
    (the current one) unless the caller names the CPU.

    ``ck`` is the whole cloud key (as the JAX session's global arrays
    are), so that ``ints.from_pbs_int``'s unsharded PBS runs on it; the
    sharded functions read this rank's KSK rows."""

    def __init__(self, seed_or_generator, params: TFHEParams, engine_name=None,
                 model: int = 1, latency_mode: bool = False, device="cuda"):
        device = _rank_device(device)
        if isinstance(seed_or_generator, torch.Generator):
            gen = seed_or_generator
            if gen.device.type != device.type:
                raise ValueError(f"generator is on {gen.device}, session on {device}")
        else:
            gen = torch.Generator(device=device)
            gen.manual_seed(int(seed_or_generator))
        name = select_engine(params, device, engine_name)
        # Every rank draws the same keys from the same seed: no broadcast.
        sk, ck = gen_keys(gen, params, device, resolve_engine(engine_name or name))
        if latency_mode:
            ck = cloud_key_latency(ck)
        self._setup(sk, ck, params, model, device, gen)

    @classmethod
    def from_keys(cls, sk: SecretKey, ck: CloudKey, params: TFHEParams, model: int = 1,
                  device="cuda", seed: int = 0) -> "GateSession":
        """A session on keys made elsewhere (a key file, or the JAX
        package's through ``keys.from_jax_keys``), the same on every rank;
        ``seed`` starts its encryption stream."""
        device = _rank_device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        self = cls.__new__(cls)
        self._setup(sk, ck, params, model, device, gen)
        return self

    def _setup(self, sk, ck, params, model, device, gen) -> None:
        self.params = params
        self.device = device
        self.mesh = make_global_mesh(model=model, device_type=device.type)
        self.sk = sk
        self.ck: CloudKey = ck
        self.engine_name = key_engine(ck.bk)
        self._ksk_local = shard_cloud_key(ck, self.mesh).ksk
        self._fns = {kind: sharded_gate_fn(self.mesh, params, self.engine_name, kind=kind)
                     for kind in GATE_INPUTS}
        self._bootstrap_fns: dict = {}
        self.gen = gen  # the session's encryption stream, after keygen

    # ------------------------- data plumbing -------------------------- #
    def feed(self, local_cts) -> torch.Tensor:
        """This rank's rows (..., n+1), numpy uint32 or an int32 tensor, on
        the session's device.  The global batch is the ranks' rows in
        ``data`` order; ranks that differ only in ``model`` feed the same
        rows."""
        if isinstance(local_cts, torch.Tensor):
            t = local_cts.to(self.device)
        else:
            t = from_numpy(local_cts, self.device)
        if t.dtype != torch.int32 or t.shape[-1] != self.params.n + 1:
            raise ValueError(f"feed takes (..., n+1) ciphertext words, got {t.dtype} "
                             f"{tuple(t.shape)}")
        return t

    def fetch(self, local_out: torch.Tensor) -> np.ndarray:
        """This rank's output rows as numpy uint32 words."""
        return to_numpy(local_out)

    # --------------------------- gate set ----------------------------- #
    def _g(self, kind: str, *cts):
        return self._fns[kind](self.ck.bk, self._ksk_local, *cts)

    def nand(self, x, y):
        return self._g("nand", x, y)

    def and_(self, x, y):
        return self._g("and", x, y)

    def or_(self, x, y):
        return self._g("or", x, y)

    def xor(self, x, y):
        return self._g("xor", x, y)

    def not_(self, x):
        return self._g("not", x)

    def mux(self, control, in0, in1):
        return self._g("mux", control, in0, in1)

    def bootstrap_raw(self, pre: torch.Tensor) -> torch.Tensor:
        """Bootstrap a whole pre-combined batch (..., B, n+1) that every
        rank holds: this rank's ``data`` block of axis -2 (any leading
        gate-lane axes whole), then an ``all_gather`` over ``data`` returns
        the whole batch (none on a ``data`` axis of one rank).  A batch that
        ``data`` does not divide, or a single (n+1,) ciphertext, is computed
        whole on every rank."""
        ndim = pre.dim()
        data = axis_size(self.mesh, "data")
        if ndim not in self._bootstrap_fns:
            self._bootstrap_fns[ndim] = sharded_bootstrap_fn(
                self.mesh, self.params, self.engine_name, ndim=ndim)
        fn = self._bootstrap_fns[ndim]
        if ndim < 2 or pre.shape[-2] % data:
            return fn(self.ck.bk, self._ksk_local, pre)
        out = fn(self.ck.bk, self._ksk_local, shard(pre, self.mesh, "data", dim=ndim - 2))
        if data == 1:
            return out
        front = out.movedim(-2, 0).contiguous()
        full = torch.empty((data * front.shape[0],) + front.shape[1:], dtype=front.dtype,
                           device=front.device)
        g = group(self.mesh, "data")
        with collective("all_gather", g, full):
            dist.all_gather_into_tensor(full, front, group=g)
        return full.movedim(0, -2).contiguous()

    # --------------------- client-side convenience -------------------- #
    # These make a session a drop-in for the TFHE context where a ``ctx``
    # is expected (apps.circuits.evaluate_encrypted, ints.FheUint): every
    # rank draws the same encryption stream.
    def encrypt(self, bits) -> torch.Tensor:
        """Encrypt {0,1} bits under the session's secret key."""
        bits = torch.as_tensor(bits).to(device=self.device, dtype=torch.int32)
        return tlwe.encrypt_binary(self.gen, self.sk.lv0, bits, self.params)

    def trivial(self, bits) -> torch.Tensor:
        """Noiseless ciphertexts of constants."""
        bits = torch.as_tensor(bits).to(device=self.device, dtype=torch.int32)
        return tlwe.trivial(torus.binary_to_torus(bits), self.params.n)

    def decrypt(self, cts: torch.Tensor) -> torch.Tensor:
        return tlwe.decrypt_binary(cts, self.sk.lv0)

    def decrypt_local(self, local_out: torch.Tensor) -> np.ndarray:
        """Decrypt this rank's rows (test and debug convenience)."""
        return self.decrypt(local_out).cpu().numpy()
