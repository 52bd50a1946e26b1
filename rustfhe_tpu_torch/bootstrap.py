"""Gate bootstrapping: blind rotation, sample extraction, key switch.

Counterpart of ``rustfhe_tpu/bootstrap.py``.  The JAX package runs the n
CMux steps as a ``lax.scan``; here they are a Python loop of n launches of
the step kernel K1 (``engine.cmux_k.cmux_step``), with the whole batch of
gates inside each launch.  Scaling matches the reference exactly:

  b~   = b >> (32 - nbit - 1)                  (floor)
  a~_i = (a_i + 2^(32-nbit-2)) >> (32-nbit-1)   (round)
  acc  = X^{-b~} * testvec;  acc = CMux(bk_i, X^{a~_i} * acc, acc)

The shifts are logical: on int32 words an arithmetic shift would make
b~ and a~ negative for words >= 2^31.

A latency-mode key (``keys.LatencyBK``) at a flattened batch of at most
``rotate_all_k.MAX_BATCH``, at a shape K3 takes (``rotate_all_k.takes``:
Bg <= 2^7 and N >= 64), runs the whole rotation as one launch of K3
(``engine.rotate_all_k.rotate_all``), the JAX package's latency branch
(``rustfhe_tpu/bootstrap.py:66-75``).  A larger batch takes the K1 loop,
as the JAX engine's ``rotate_all_steps`` does, without its warning: the
JAX panel key costs 12.6 GiB that a large batch wastes, the port's
latency key costs nothing, and above the cap the K1 loop is the faster
path (the console's single gates and 32-lane levels stay below it).
Any other latency key, FAST_PARAMS' Bg = 2^8 among them, takes the K1
loop as well: its digits of -128 have no int8 negation.

A limb key (``keys.LimbBK``) runs the limb engine, the JAX engine
``"pallas"`` (``rustfhe_tpu/bootstrap.py:101-117``): one launch of K4 per
step, of K6 with ``merge_c`` False, or, with ``fuse_step`` False, the
rotation, difference and decomposition in torch and one launch of K5.

A generic key (``keys.GenericBK``) runs the JAX package's per-step branch
(``rustfhe_tpu/bootstrap.py:108-116``): rotation, difference and
decomposition in torch, then the engine's ``external_product_digits``
("matmul": one launch of the int8 GEMM per step).
"""

from __future__ import annotations

import torch

from . import poly, trlwe
from ._u32 import srl
from .decomp import decompose_unsigned
from .engine import cmux_k, get_engine, limb_step, rotate_all_k
from .engine.plain import key_switch_digits
from .keys import CloudKey, GenericBK, LatencyBK, LimbBK
from .trgsw import decompose_trlwe
from .params import TFHEParams


def rotation_start(ct: torch.Tensor, testvec: torch.Tensor,
                   params: TFHEParams) -> tuple[torch.Tensor, torch.Tensor]:
    """The blind rotation's inputs for lv0 TLWE ``ct (B, n+1)``: the first
    accumulator X^{-b~} * testvec, int32 (B, 2, N), and the rotations a~,
    int32 (n, B), one contiguous row per step.  ``testvec`` is one test
    vector (2, N) for every row, read in place by the rotation's gather,
    or one per row (B, 2, N)."""
    shift = 32 - params.nbit - 1
    b_tilde = srl(ct[:, 0], shift)
    a_tilde = srl(ct[:, 1:] + (1 << (shift - 1)), shift)
    neg_b = torch.remainder(-b_tilde, 2 * params.N)
    acc = poly.rotate(testvec, neg_b[:, None]).contiguous()
    return acc, a_tilde.t().contiguous()


def _limb_rotate(acc: torch.Tensor, a_steps: torch.Tensor, bk: LimbBK,
                 params: TFHEParams) -> torch.Tensor:
    if bk.fuse_step:
        step = limb_step.cmux_step_merged if bk.merge_c else limb_step.cmux_step_split
        for i in range(params.n):
            acc = step(acc, a_steps[i], bk.table[i], params)
        return acc
    for i in range(params.n):
        diff = poly.rotate(acc, a_steps[i][:, None]) - acc
        digits = decompose_trlwe(diff, params).to(torch.int8)
        acc = acc + limb_step.external_product(digits, bk.table[i], params)
    return acc


def _generic_rotate(acc: torch.Tensor, a_steps: torch.Tensor, bk: GenericBK,
                    params: TFHEParams) -> torch.Tensor:
    eng = get_engine(bk.engine)
    for i in range(params.n):
        diff = poly.rotate(acc, a_steps[i][:, None]) - acc
        acc = acc + eng.external_product_digits(bk.table[i], decompose_trlwe(diff, params), params)
    return acc


def blind_rotate(ct: torch.Tensor, bk: torch.Tensor | LatencyBK | LimbBK | GenericBK,
                 testvec: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """Rotate ``testvec (..., 2, N)`` by the encrypted phase of lv0 TLWE
    ``ct (..., n+1)``; ``bk`` is the prepared key (n, 2L, 2, 2N), or it as
    a latency key, or a limb key, or a generic engine's key.  The leading
    axes of ``testvec`` broadcast against those of ``ct``, as in
    ``rustfhe_tpu/bootstrap.py:32-37``: a (2, N) vector serves every row
    without a copy, and a vector per row (programmable bootstrapping with
    a table per row, ``pbs.py``) is flattened with the rows.  Every branch
    below starts from the one accumulator (B, 2, N) this makes.  Returns
    int32 (..., 2, N)."""
    lead = torch.broadcast_shapes(ct.shape[:-1], testvec.shape[:-2])
    ct = ct.expand(lead + ct.shape[-1:]).reshape(-1, params.n + 1)
    if testvec.dim() > 2:
        testvec = testvec.expand(lead + testvec.shape[-2:]).reshape(-1, 2, params.N)
    acc, a_steps = rotation_start(ct, testvec, params)
    if isinstance(bk, LimbBK):
        return _limb_rotate(acc, a_steps, bk, params).reshape(lead + (2, params.N))
    if isinstance(bk, GenericBK):
        return _generic_rotate(acc, a_steps, bk, params).reshape(lead + (2, params.N))
    if isinstance(bk, LatencyBK):
        if acc.shape[0] <= rotate_all_k.MAX_BATCH and rotate_all_k.takes(params):
            acc = rotate_all_k.rotate_all(acc, a_steps, bk.bk, params)
            return acc.reshape(lead + (2, params.N))
        bk = bk.bk
    for i in range(params.n):
        acc = cmux_k.cmux_step(acc, a_steps[i], bk[i], params)
    return acc.reshape(lead + (2, params.N))


def gate_bootstrapping_tlwe2tlwe(ct: torch.Tensor,
                                 bk: torch.Tensor | LatencyBK | LimbBK | GenericBK,
                                 params: TFHEParams) -> torch.Tensor:
    """lv0 TLWE -> lv1 TLWE encrypting mu * sign."""
    mu = torch.full((params.N,), params.mu, dtype=torch.int32, device=ct.device)
    rotated = blind_rotate(ct, bk, trlwe.trivial(mu), params)
    return trlwe.sample_extract(rotated, 0)


def identity_key_switch(ct_lv1: torch.Tensor, ksk: torch.Tensor,
                        params: TFHEParams) -> torch.Tensor:
    """lv1 TLWE (..., N+1) -> lv0 TLWE (..., n+1)."""
    digits = decompose_unsigned(ct_lv1[..., 1:], params)  # (..., N, iks_l)
    out = -key_switch_digits(ksk, digits, params)
    out[..., 0] += ct_lv1[..., 0]
    return out


def bootstrap(ct: torch.Tensor, ck: CloudKey, params: TFHEParams) -> torch.Tensor:
    """Full gate bootstrap: blind rotate, extract, key switch."""
    lv1 = gate_bootstrapping_tlwe2tlwe(ct, ck.bk, params)
    return identity_key_switch(lv1, ck.ksk, params)
