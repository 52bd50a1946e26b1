"""Degree-axis (N-sharded) transform-domain external product.

Counterpart of ``rustfhe_tpu/parallel/degree_sharded.py``: the polynomial
DEGREE axis spans the ranks of the mesh's ``model`` axis, and the
transform-domain pipeline of ``engine/transform.py`` (the ``"nuss"``
engine) runs with a reduce-scatter between its resharding stages:

  coefficients split on N            (each rank: N/D columns)
    | local partial forward product  x_loc @ M_f[rows_loc, :]
    |-- reduce_scatter over 2N ----- frequencies split (2N/D per rank)
    | digit-limb split, per-frequency pointwise products, limb carry
    | chain: all local (the block FFT is frequency-diagonal)
    | local partial inverse product  limbs_loc @ M_i[freq_rows_loc, :]
    |-- reduce_scatter over N ------ coefficients split on N again
    | exact division by 2r (abc_combine, elementwise, local)

Every operand is an exact integer: the products are float64 sums of small
integers far below 2^53, reduced in float64 (exact in any order) and
rounded to int64 after each reduction, as the unsharded engine's are, so
the result is the ``"nuss"`` engine's word for word.

A scaling demonstration of the degree axis (for N-split ciphertexts); the
throughput path stays K1 with data parallelism.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..engine.transform import (abc_combine, dlimb_split, forward_matrix, inverse_matrix,
                                pointwise, relimb, split_mr)
from .mesh import axis_index, axis_size, collective, group, shard


def _reduce_scatter_last(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Sum ``x`` (..., K) float64 over ``axis`` and keep this rank's block
    of the last dim (K / size), the JAX ``psum_scatter(..., tiled=True)``
    on the last axis (``x`` itself on an axis of one rank)."""
    size = axis_size(mesh, axis)
    if size == 1:
        return x
    front = x.movedim(-1, 0).contiguous()  # (K, ...): rank d's block is rows d*K/size..
    out = torch.empty((front.shape[0] // size,) + front.shape[1:], dtype=x.dtype,
                      device=x.device)
    g = group(mesh, axis)
    with collective("reduce_scatter", g, front):
        dist.reduce_scatter_tensor(out, front, group=g)
    return out.movedim(0, -1)


def degree_sharded_external_product_fn(mesh: DeviceMesh, params, axis: str = "model"):
    """The local body of an external product over digit polynomials split
    on N over ``axis``: ``fn(panels_local, digits_local)`` -> int32
    (..., 2, N/D), this rank's coefficient columns, with ``digits_local``
    int (..., 2L, N/D) its columns of the digits (any number of leading
    axes) and ``panels_local`` its frequencies of the ``"nuss"`` engine's
    panels (``shard_transform_panels``)."""
    N = params.N
    m, r = split_mr(N)
    D = axis_size(mesh, axis)
    if (2 * r) % D or N % D:
        raise ValueError(f"{axis} = {D} must divide 2r = {2 * r} and N = {N}")
    sh = (2 * r).bit_length() - 1
    idx = axis_index(mesh, axis)
    mf = torch.from_numpy(forward_matrix(N)[idx * (N // D): (idx + 1) * (N // D)])
    mi = torch.from_numpy(inverse_matrix(N)[idx * (2 * N // D): (idx + 1) * (2 * N // D)])
    mats = {}

    def local(panels_local: torch.Tensor, digits_local: torch.Tensor) -> torch.Tensor:
        dev = digits_local.device
        if dev not in mats:
            mats[dev] = (mf.to(device=dev, dtype=torch.float64),
                         mi.to(device=dev, dtype=torch.float64))
        mf_rows, mi_rows = mats[dev]
        f_part = digits_local.to(torch.float64) @ mf_rows  # (..., 2L, 2N) partial sums
        f_loc = _reduce_scatter_last(f_part, mesh, axis).round().to(torch.int64)
        f0, f1 = dlimb_split(f_loc)  # (..., 2L, 2N/D)
        limbs = relimb(pointwise(f0, f1, panels_local, m))  # (..., 2, BLIMBS, 2N/D)
        w_part = limbs.to(torch.float64) @ mi_rows  # (..., 2, BLIMBS, N) partial sums
        w_loc = _reduce_scatter_last(w_part, mesh, axis).round().to(torch.int64)
        return abc_combine(w_loc, sh)

    return local


def shard_transform_panels(panels: torch.Tensor, mesh: DeviceMesh,
                           axis: str = "model") -> torch.Tensor:
    """This rank's frequencies of the per-frequency panels (2r, rows, cols)."""
    return shard(panels, mesh, axis, dim=0)
