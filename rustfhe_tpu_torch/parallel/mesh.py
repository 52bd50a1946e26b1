"""The (data, model) process mesh.

Counterpart of ``rustfhe_tpu/parallel/mesh.py``.  The JAX mesh is a grid of
devices inside one SPMD program; here it is a grid of the ranks of the
initialised ``torch.distributed`` world (one device each), as a
``DeviceMesh`` whose dims are named ``("data", "model")``:

* ``data``: the gate batch.  Gate bootstrapping is independent across
  ciphertexts, so each rank bootstraps its own rows with no communication
  in the blind rotation: the throughput axis.
* ``model``: the key-switch table's rows (and, tensor-parallel, the
  bootstrapping key's gadget rows): each rank sums its share of the
  contraction, and one reduction over the ``model`` group completes it.

The port computes on plain rank-local tensors with explicit collectives on
the mesh's groups (``group``); a "sharding" is a function from the full
array to this rank's part of it (``batch_sharding``, ``replicated``).

Every collective of ``parallel/`` runs inside a ``collective`` span
(``collective`` below) and is left out on a group of one rank, where it
would move nothing.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .._device import resolve_device
from ..utils import trace

AXES = ("data", "model")

# Each collective's bytes that cross cards, per rank, as a multiple of
# (g - 1) / g of its whole tensor over g ranks: the gathered output, the
# all-to-all's tensor, the reduce-scatter's input, and a ring all-reduce's
# tensor twice (a reduce-scatter, then an all-gather).
CROSSING = {"all_gather": 1, "all_to_all": 1, "reduce_scatter": 1, "all_reduce": 2}


def make_mesh(data: int | None = None, model: int = 1,
              device_type: str | None = None) -> DeviceMesh:
    """A (data, model) mesh over the first data * model ranks of the
    initialised world (every rank calls it).  ``data`` defaults to every
    rank: world // model.  ``device_type`` defaults to the world's: "cuda"
    under NCCL, else "cpu"; a CUDA mesh on a host with no card raises."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.multihost.initialize)")
    n = dist.get_world_size()
    if data is None:
        if n % model:
            raise ValueError(f"model = {model} does not divide the world of {n} ranks")
        data = n // model
    if data * model > n:
        raise ValueError(f"a {data} x {model} mesh needs more than the world's {n} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    resolve_device(device_type)
    ranks = torch.arange(data * model).reshape(data, model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXES)


def group(mesh: DeviceMesh, axis: str):
    """The process group of this rank's ``axis`` line of the mesh."""
    return mesh.get_group(axis)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return dist.get_world_size(group(mesh, axis))


def collective(op: str, g, tensor: torch.Tensor):
    """The ``collective`` span of one ``op`` (a key of ``CROSSING``) over
    process group ``g`` on ``tensor``, the whole tensor as ``CROSSING``
    names it: attributes ``op``, ``ranks`` (the group's size) and
    ``bytes``, the bytes that cross cards at this rank."""
    size = dist.get_world_size(g)
    nbytes = tensor.numel() * tensor.element_size()
    return trace.span("collective", op=op, ranks=size,
                      bytes=CROSSING[op] * (size - 1) * nbytes // size)


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (jax.lax.axis_index)."""
    return dist.get_rank(group(mesh, axis))


def shard(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``dim``, the axis split
    over ``axis`` in rank order (a PartitionSpec entry); the size must
    divide evenly, as shard_map requires."""
    size, idx = axis_size(mesh, axis), axis_index(mesh, axis)
    if x.shape[dim] % size:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split over "
                         f"{axis} = {size}")
    step = x.shape[dim] // size
    return x.narrow(dim, idx * step, step).contiguous()


def batch_sharding(mesh: DeviceMesh, dim: int = 0):
    """x -> this rank's ``data`` rows of the full batch ``x`` (P("data"))."""
    return lambda x: shard(x, mesh, "data", dim)


def replicated(mesh: DeviceMesh):
    """x -> x: every rank holds the whole array (P())."""
    return lambda x: x
