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
``rotate_all_k.MAX_BATCH`` runs the whole rotation as one launch of K3
(``engine.rotate_all_k.rotate_all``), the JAX package's latency branch
(``rustfhe_tpu/bootstrap.py:66-75``).  A larger batch warns once per key
and takes the K1 loop, as the JAX engine's ``rotate_all_steps`` does.

A limb key (``keys.LimbBK``) runs the limb engine, the JAX engine
``"pallas"`` (``rustfhe_tpu/bootstrap.py:101-117``): one launch of K4 per
step, of K6 with ``merge_c`` False, or, with ``fuse_step`` False, the
rotation, difference and decomposition in torch and one launch of K5.
"""

from __future__ import annotations

import warnings

import torch

from . import poly, trlwe
from ._u32 import srl
from .decomp import decompose_unsigned
from .engine import cmux_k, limb_step, rotate_all_k
from .engine.plain import key_switch_digits
from .keys import CloudKey, LatencyBK, LimbBK
from .trgsw import decompose_trlwe
from .params import TFHEParams


def rotation_start(ct: torch.Tensor, testvec: torch.Tensor,
                   params: TFHEParams) -> tuple[torch.Tensor, torch.Tensor]:
    """The blind rotation's inputs for lv0 TLWE ``ct (B, n+1)``: the first
    accumulator X^{-b~} * testvec, int32 (B, 2, N), and the rotations a~,
    int32 (n, B), one contiguous row per step."""
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


def blind_rotate(ct: torch.Tensor, bk: torch.Tensor | LatencyBK | LimbBK,
                 testvec: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """Rotate ``testvec (2, N)`` by the encrypted phase of lv0 TLWE ``ct
    (..., n+1)``; ``bk`` is the prepared key (n, 2L, 2, 2N), or it as a
    latency key, or a limb key.  Returns int32 (..., 2, N)."""
    lead = ct.shape[:-1]
    acc, a_steps = rotation_start(ct.reshape(-1, params.n + 1), testvec, params)
    if isinstance(bk, LimbBK):
        return _limb_rotate(acc, a_steps, bk, params).reshape(lead + (2, params.N))
    if isinstance(bk, LatencyBK):
        if acc.shape[0] <= rotate_all_k.MAX_BATCH:
            acc = rotate_all_k.rotate_all(acc, a_steps, bk.bk, params)
            return acc.reshape(lead + (2, params.N))
        if not bk.warned:
            bk.warned = True
            warnings.warn(
                f"latency-mode key used for a flattened batch of {acc.shape[0]} > "
                f"{rotate_all_k.MAX_BATCH}: the single-launch rotation K3 is slower "
                "than the per-step kernel K1 there, and this call takes the K1 loop; "
                "use the standard key for large batches", stacklevel=2)
        bk = bk.bk
    for i in range(params.n):
        acc = cmux_k.cmux_step(acc, a_steps[i], bk[i], params)
    return acc.reshape(lead + (2, params.N))


def gate_bootstrapping_tlwe2tlwe(ct: torch.Tensor, bk: torch.Tensor | LatencyBK | LimbBK,
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
