"""Mesh sharding and collectives for scale-out gate evaluation: the port of
``rustfhe_tpu/parallel/`` over ``torch.distributed`` (one rank per device)."""

from .mesh import batch_sharding, make_mesh, replicated
from .sharded import (
    key_switch_all_to_all,
    shard_cloud_key,
    shard_cloud_key_tp,
    sharded_bootstrap_fn,
    sharded_gate_fn,
    sharded_pbs_fn,
    tp_gate_fn,
)
from . import multihost

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated",
    "sharded_bootstrap_fn",
    "sharded_pbs_fn",
    "sharded_gate_fn",
    "shard_cloud_key",
    "shard_cloud_key_tp",
    "tp_gate_fn",
    "key_switch_all_to_all",
]
