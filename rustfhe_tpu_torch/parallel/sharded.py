"""Mesh-sharded batched gate evaluation.

Counterpart of ``rustfhe_tpu/parallel/sharded.py``.  Every function here
returns the LOCAL BODY of the JAX package's ``shard_map``: a callable that
takes this rank's shards and returns its shard, with the collectives
written out on the mesh's process groups (``parallel.mesh``).  Nothing is
compiled; each rank runs its part eagerly, on its own device, through the
port's kernels (K1, K3 or K4 in the blind rotation, P9 in the
tensor-parallel ``"matmul"`` product).

* The gate batch is split over ``data``: each rank bootstraps its own rows,
  with no communication in the blind rotation.
* The key-switch table's (i, l) rows are split over ``model``: each rank
  sums its rows' contributions in float64 and one ``all_reduce`` over the
  ``model`` group completes the switch (``_key_switch_local``), or, with
  ``key_switch="all_to_all"``, the one-hot of the batch is exchanged from
  batch-major to row-major over ``data`` (``key_switch_all_to_all``).
* ``tp_gate_fn``: the bootstrapping key's 2L gadget rows split over
  ``model``, one reduction of the external product's partial sums per
  blind-rotation step.

Only exact sums are reduced: float64 integers below 2^53 and int32 limb
sums below 2^31, never wrapped 32-bit words, so every sharded output
equals the unsharded one word for word.  The bootstrapping key is
replicated (62 MB at DEFAULT_PARAMS).

The JAX functions default to the ``"matmul"`` engine; these take the key's
own engine and default ``engine_name`` as ``TFHE.new`` does
(``engine.requested_engine``: ``RUSTFHE_ENGINE``, else the cascade's
``engine_for``), so DEFAULT_PARAMS runs K1 on every rank.  The name
is held against the key's form: the key must have been prepared by that
engine.  JAX's ``check_vma`` (a tracing checker) has no counterpart.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import trlwe
from .._u32 import wrap
from ..bootstrap import blind_rotate
from ..decomp import decompose_unsigned
from ..engine import FFT64Engine, MatmulEngine, requested_engine, resolve_engine
from ..engine.matmul import recombine
from ..engine.plain import key_switch_partial
from ..gates import GATE_INPUTS, gate_circuit
from ..keys import CloudKey, GenericBK, check_key_engine, key_engine  # noqa: F401 (re-exported)
from ..params import TFHEParams
from ..pbs import _gate_margin, _shape, rotate_extract_many
from .mesh import axis_index, axis_size, group, shard


def _finish_key_switch(ct_lv1: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """The switched lv0 ciphertexts from the reduced float64 sum (M, n+1)."""
    out = -wrap(total).reshape(ct_lv1.shape[:-1] + total.shape[-1:])
    out[..., 0] += ct_lv1[..., 0]
    return out


def _key_switch_local(ct_lv1: torch.Tensor, ksk_local: torch.Tensor, params: TFHEParams,
                      mesh: DeviceMesh, axis: str = "model") -> torch.Tensor:
    """Key switch with the KSK's (i, l) rows split over ``axis``.

    ``ksk_local``: this rank's contiguous block of the port's KSK,
    float64 (T-1, N*iks_l / size, n+1) (``shard_cloud_key``).  Each rank
    takes the digits of its rows, sums its float64 partial
    (``plain.key_switch_partial``: an integer below 2^53), and one float64
    ``all_reduce`` over ``axis`` gives the total, exact in any order; it is
    reduced mod 2^32 only then.  The axis size must divide N*iks_l, as
    JAX's assert requires (each block is whole (i, l) rows)."""
    il = params.N * params.iks_l
    size = axis_size(mesh, axis)
    if il % size or ksk_local.shape[1] * size != il:
        raise ValueError(f"{axis} = {size} must divide N*iks_l = {il} and the KSK block "
                         f"must hold {il}/{size} rows, got {tuple(ksk_local.shape)}")
    rows = ksk_local.shape[1]
    start = axis_index(mesh, axis) * rows
    digits = decompose_unsigned(ct_lv1[..., 1:], params)  # (..., N, iks_l)
    d = digits.reshape(-1, il)[:, start: start + rows]
    part = key_switch_partial(ksk_local, d, params)
    dist.all_reduce(part, group=group(mesh, axis))
    return _finish_key_switch(ct_lv1, part)


def key_switch_all_to_all(ct_lv1: torch.Tensor, ksk_local: torch.Tensor, params: TFHEParams,
                          mesh: DeviceMesh, axis: str = "data") -> torch.Tensor:
    """Key switch where each rank builds the one-hot of its own BATCH rows,
    and ``all_to_all_single`` re-shards it from batch-major to KSK-row-major
    before the local product; a ``reduce_scatter`` of the float64 partial
    sums then gives each rank the total of its own rows (JAX: psum, then
    this device's slice).

    ``ct_lv1`` (..., B_local, N+1): this rank's rows (leading axes fold
    into the batch, the same size on every rank of ``axis``);
    ``ksk_local`` (T-1, N*iks_l / size, n+1): the KSK's rows split over the
    SAME axis.  Returns this rank's switched rows."""
    il = params.N * params.iks_l
    size = axis_size(mesh, axis)
    rows = ksk_local.shape[1]
    if il % size or rows * size != il:
        raise ValueError(f"{axis} = {size} must divide N*iks_l = {il}, got a KSK block "
                         f"{tuple(ksk_local.shape)}")
    g = group(mesh, axis)
    nslots = params.iks_t - 1
    digits = decompose_unsigned(ct_lv1[..., 1:], params).reshape(-1, il)  # (b, il)
    b = digits.shape[0]
    t = torch.arange(1, params.iks_t, dtype=digits.dtype, device=digits.device)
    onehot = (digits[:, None, :] == t[None, :, None]).to(torch.int8)  # (b, T-1, il)
    # Block d of the row axis goes to rank d; the received blocks stack in
    # peer (= batch) order: (size, b, T-1, rows) = every peer's rows of mine.
    send = onehot.reshape(b, nslots, size, rows).permute(2, 0, 1, 3).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=g)
    full = recv.reshape(size * b, nslots, rows)
    part = None
    for s in range(nslots):
        term = full[:, s].to(torch.float64) @ ksk_local[s]
        part = term if part is None else part + term
    mine = torch.empty((b, part.shape[-1]), dtype=part.dtype, device=part.device)
    dist.reduce_scatter_tensor(mine, part, group=g)  # exact: integers below 2^53
    return _finish_key_switch(ct_lv1, mine)


def _bootstrap_local(pre: torch.Tensor, bk, ksk_local: torch.Tensor, params: TFHEParams,
                     ks_fn) -> torch.Tensor:
    """Full bootstrap of this rank's rows: blind rotation (any key form the
    port has), extraction, then ``ks_fn(lv1, ksk_local)``."""
    mu = torch.full((params.N,), params.mu, dtype=torch.int32, device=pre.device)
    rotated = blind_rotate(pre, bk, trlwe.trivial(mu), params)
    return ks_fn(trlwe.sample_extract(rotated, 0), ksk_local)


def _gate_local(kind: str, params: TFHEParams, boot):
    """The six gates over local shards: ``fn(bk, ksk, *cts)``, the
    unsharded composition (``gates.gate_circuit``) with ``boot(pre, bk,
    ksk)`` its bootstrap."""
    if kind not in GATE_INPUTS:
        raise ValueError(f"unknown gate {kind!r}; have {sorted(GATE_INPUTS)}")

    def gate(bk, ksk, *cts):
        return gate_circuit(kind, cts, params=params, boot=lambda pre: boot(pre, bk, ksk))

    return gate


def _keyed(eng, fn):
    """``fn(bk, ...)`` after checking that ``bk`` is ``eng``'s key."""
    def call(bk, *args):
        check_key_engine(bk, eng, "the sharded function")
        return fn(bk, *args)
    return call


def sharded_gate_fn(mesh: DeviceMesh, params: TFHEParams, engine_name=None,
                    kind: str = "nand", key_switch: str = "psum"):
    """The local body of a mesh-sharded gate: ``fn(bk, ksk_local, *cts)``
    -> this rank's outputs.

    ``cts``: this rank's rows of the gate's inputs (2; ``"not"`` 1,
    ``"mux"`` 3: control, in0, in1).  ``bk`` replicated (any key form the
    port has for ``engine_name``).  ``key_switch``: ``"psum"`` (the KSK
    split over ``model``, ``shard_cloud_key``) or ``"all_to_all"`` (the KSK
    split over ``data``, ``shard_cloud_key(..., axis="data")``; every rank
    then holds as many rows)."""
    eng = requested_engine(params, engine_name)
    if key_switch == "psum":
        def ks_fn(lv1, ksk):
            return _key_switch_local(lv1, ksk, params, mesh, "model")
    elif key_switch == "all_to_all":
        def ks_fn(lv1, ksk):
            return key_switch_all_to_all(lv1, ksk, params, mesh, "data")
    else:
        raise ValueError(f"unknown key_switch {key_switch!r}")
    gate = _gate_local(kind, params,
                       lambda pre, bk, ksk: _bootstrap_local(pre, bk, ksk, params, ks_fn))
    return _keyed(eng, gate)


def sharded_bootstrap_fn(mesh: DeviceMesh, params: TFHEParams, engine_name=None,
                         ndim: int = 2, shard_batch: bool = True):
    """The local body of a mesh-sharded bootstrap of a pre-combined batch:
    ``fn(bk, ksk_local, pre)`` with ``pre`` of rank ``ndim``, (..., B, n+1).
    With ``shard_batch`` the caller gives this rank's ``data`` rows of axis
    -2 (leading gate-lane axes whole); without it, the whole batch, which
    every rank then computes (a batch ``data`` does not divide): the local
    body is the same, the flag says what the caller passes, as JAX's
    in_specs do.  The key switch is the ``model`` reduction.
    ``GateSession.bootstrap_raw`` and the bench's ``BENCH_SHARDED`` run
    this one function."""
    eng = requested_engine(params, engine_name)

    def ks_fn(lv1, ksk):
        return _key_switch_local(lv1, ksk, params, mesh, "model")

    def boot(bk, ksk_local, pre):
        if pre.dim() != ndim:
            raise ValueError(f"pre must have rank {ndim}, got {tuple(pre.shape)}")
        return _bootstrap_local(pre, bk, ksk_local, params, ks_fn)

    return _keyed(eng, boot)


def sharded_pbs_fn(mesh: DeviceMesh, params: TFHEParams, engine_name=None, *,
                   space: int, raw: bool = False, unsafe: bool = False):
    """The local body of a mesh-sharded multi-output PBS:
    ``fn(bk, ksk_local, ct, tables)`` -> (..., t, n+1) for this rank's rows
    ``ct`` (..., n+1), ``tables`` (t, space) replicated.  The rotation is
    the unsharded ``pbs.pbs_many``'s (``pbs.rotate_extract_many``), the key
    switch the ``model`` reduction, and the (space, t) margin gate
    (``pbs._gate_margin``) applies as it does unsharded."""
    eng = requested_engine(params, engine_name)

    def run(bk, ksk_local, ct, tables):
        _gate_margin(params, space, _shape(tables)[-2], unsafe, "sharded_pbs")
        lv1 = rotate_extract_many(bk, ct, tables, space, params, raw=raw)
        return _key_switch_local(lv1, ksk_local, params, mesh, "model")

    return _keyed(eng, run)


# --------------------------------------------------------------------- #
# Tensor-parallel blind rotation: the key's 2L gadget rows over ``model``
# --------------------------------------------------------------------- #
class _TPMatmulEngine:
    """The matmul engine on this rank's block of the 2L gadget rows: its
    product (one P9 launch a step on the card) gives int32 limb sums, one
    int32 ``all_reduce`` over ``axis`` adds the blocks (exact: every sum is
    at most 2^24.6 in magnitude), and only then are the limbs recombined."""

    def __init__(self, base: MatmulEngine, mesh: DeviceMesh, axis: str):
        self._base, self._mesh, self.axis = base, mesh, axis
        self.name = base.name

    def external_product_digits(self, prepared_local: torch.Tensor, digits: torch.Tensor,
                                params: TFHEParams) -> torch.Tensor:
        rows = prepared_local.shape[0]
        start = axis_index(self._mesh, self.axis) * rows
        part = self._base.limb_sums(prepared_local, digits[..., start: start + rows, :],
                                    params).contiguous()  # a collective writes in place
        dist.all_reduce(part, group=group(self._mesh, self.axis))
        return recombine(part, self._base.limb_bits)


class _TPFFT64Engine:
    """The fft64 engine on this rank's block of the 2L rows: the float64
    convolution sums are reduced over ``axis`` before the rounding (each is
    an integer up to the FFT's error), so the rounded words are the
    unsharded ones."""

    def __init__(self, base: FFT64Engine, mesh: DeviceMesh, axis: str):
        self._base, self._mesh, self.axis = base, mesh, axis
        self.name = base.name

    def external_product_digits(self, prepared_local: torch.Tensor, digits: torch.Tensor,
                                params: TFHEParams) -> torch.Tensor:
        rows = prepared_local.shape[0]
        start = axis_index(self._mesh, self.axis) * rows
        part = self._base.conv_partial(prepared_local, digits[..., start: start + rows, :],
                                       params).contiguous()  # a collective writes in place
        dist.all_reduce(part, group=group(self._mesh, self.axis))
        return self._base.round_recombine(part)


def _tp_engine(engine, mesh: DeviceMesh, axis: str):
    """The tensor-parallel form of the engines whose rows can be split."""
    if isinstance(engine, FFT64Engine):
        return _TPFFT64Engine(engine, mesh, axis)
    if isinstance(engine, MatmulEngine):
        return _TPMatmulEngine(engine, mesh, axis)
    raise TypeError(
        f"engine {getattr(engine, 'name', engine)!r} has no tensor-parallel "
        "row-sharded external product (use 'matmul' or 'fft64')"
    )


def tp_gate_fn(mesh: DeviceMesh, params: TFHEParams, kind: str = "nand",
               engine_name="matmul"):
    """The local body of a gate with the bootstrapping key's gadget rows
    split over ``model``: ``fn(bk_local, ksk_local, *cts)``, with
    ``bk_local`` this rank's block of a generic key's rows
    (``shard_cloud_key_tp``), ``ksk_local`` its KSK rows, ``cts`` its
    ``data`` rows.  One reduction of the product's partial sums runs per
    step, and the key switch is the ``model`` reduction.  Only
    ``"matmul"`` (and ``"matmul_bf16"``) and ``"fft64"`` have this form;
    another engine raises TypeError."""
    tp = _tp_engine(resolve_engine(engine_name), mesh, "model")

    def ks_fn(lv1, ksk):
        return _key_switch_local(lv1, ksk, params, mesh, "model")

    gate = _gate_local(kind, params, lambda pre, bk, ksk: _bootstrap_local(
        pre, GenericBK(bk.table, tp), ksk, params, ks_fn))
    return _keyed(tp, gate)


def shard_cloud_key_tp(ck: CloudKey, mesh: DeviceMesh) -> CloudKey:
    """This rank's block of a generic key's 2L gadget rows (dim 1 of its
    table) and of the KSK's rows, both over ``model``."""
    if not isinstance(ck.bk, GenericBK):
        raise TypeError(f"a tensor-parallel key is a generic engine's key, got "
                        f"{type(ck.bk).__name__}")
    bk = GenericBK(shard(ck.bk.table, mesh, "model", dim=1), ck.bk.engine)
    return CloudKey(bk=bk, ksk=shard(ck.ksk, mesh, "model", dim=1))


def shard_cloud_key(ck: CloudKey, mesh: DeviceMesh, axis: str = "model") -> CloudKey:
    """The bootstrapping key whole (replicated) and this rank's block of the
    KSK's (i, l) rows over ``axis``: ``"model"`` for the reduction key
    switch, ``"data"`` for ``key_switch_all_to_all``."""
    return CloudKey(bk=ck.bk, ksk=shard(ck.ksk, mesh, axis, dim=1))
