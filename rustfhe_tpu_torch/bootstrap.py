"""Gate bootstrapping: blind rotation, sample extraction, key switch.

Counterpart of ``rustfhe_tpu/bootstrap.py``.  The JAX package runs the n
CMux steps as a ``lax.scan``; here they are n steps of the step kernel K1
issued from one host call (``engine.cmux_k.cmux_rotate``: a C loop of
``cmux_step``'s launches, or at wide batches of the same step on the
two-level Karatsuba product), with the whole batch of gates inside each step.  Scaling matches the reference exactly:

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

A hybrid key (``keys.HybridBK``) runs the JAX package's hybrid branch
(``rustfhe_tpu/bootstrap.py:77-100``): n//2 pairs, each the even step (K1,
or with ``full_panels`` K1 on its prebuilt panel) then the odd step on its
prebuilt panel (``cmux_k.cmux_step_panel``: no panel kernel), then the
tail step when n is odd.  JAX fuses a pair into one launch; the port does
not (``cmux_k.cmux_step_panel``).  A hybrid key never takes K3.

A generic key (``keys.GenericBK``) runs the JAX package's per-step branch
(``rustfhe_tpu/bootstrap.py:108-116``): rotation, difference and
decomposition in torch, then the engine's ``external_product_digits``
("matmul": one launch of the int8 GEMM per step).  The key names its
engine, or carries an engine instance (the tensor-parallel engines of
``parallel.sharded``).
"""

from __future__ import annotations

import torch

from . import poly, trlwe
from ._u32 import srl
from .decomp import decompose_unsigned
from .engine import cmux_k, limb_step, plain, resolve_engine, rotate_all_k
from .engine.plain import key_switch_digits
from .keys import CloudKey, GenericBK, HybridBK, LatencyBK, LimbBK
from .params import TFHEParams
from .utils import trace


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
        acc = plain.cmux_step(acc, a_steps[i], params,
                              lambda d: limb_step.external_product(d, bk.table[i], params))
    return acc


def _hybrid_rotate(acc: torch.Tensor, a_steps: torch.Tensor, bk: HybridBK,
                   params: TFHEParams) -> torch.Tensor:
    step = cmux_k.cmux_step_panel if bk.full_panels else cmux_k.cmux_step
    npairs = bk.panels_odd.shape[0]
    for i in range(npairs):
        acc = step(acc, a_steps[2 * i], bk.prep_even[i], params)
        acc = cmux_k.cmux_step_panel(acc, a_steps[2 * i + 1], bk.panels_odd[i], params)
    for j in range(bk.prep_tail.shape[0]):
        acc = step(acc, a_steps[2 * npairs + j], bk.prep_tail[j], params)
    return acc


def _generic_rotate(acc: torch.Tensor, a_steps: torch.Tensor, bk: GenericBK,
                    params: TFHEParams) -> torch.Tensor:
    eng = resolve_engine(bk.engine)
    for i in range(params.n):
        acc = plain.cmux_step(acc, a_steps[i], params,
                              lambda d: eng.external_product_digits(bk.table[i], d, params),
                              dtype=torch.int32)
    return acc


def blind_rotate(ct: torch.Tensor, bk: torch.Tensor | LatencyBK | HybridBK | LimbBK | GenericBK,
                 testvec: torch.Tensor, params: TFHEParams) -> torch.Tensor:
    """Rotate ``testvec (..., 2, N)`` by the encrypted phase of lv0 TLWE
    ``ct (..., n+1)``; ``bk`` is the prepared key (n, 2L, 2, 2N), or it as
    a latency key or a hybrid key, or a limb key, or a generic engine's key.  The leading
    axes of ``testvec`` broadcast against those of ``ct``, as in
    ``rustfhe_tpu/bootstrap.py:32-37``: a (2, N) vector serves every row
    without a copy, and a vector per row (programmable bootstrapping with
    a table per row, ``pbs.py``) is flattened with the rows.  Every branch
    below starts from the one accumulator (B, 2, N) this makes.  Returns
    int32 (..., 2, N)."""
    lead = torch.broadcast_shapes(ct.shape[:-1], testvec.shape[:-2])
    rows = lead.numel()
    path, steps, calls = _rotation_path(bk, rows, params)
    with trace.span("blind_rotate", rows=rows, tv_rows=testvec.shape[:-2].numel(), path=path,
                    steps=steps, calls=calls) as span:
        ct = ct.expand(lead + ct.shape[-1:]).reshape(-1, params.n + 1)
        if testvec.dim() > 2:
            testvec = testvec.expand(lead + testvec.shape[-2:]).reshape(-1, 2, params.N)
        acc, a_steps = rotation_start(ct, testvec, params)
        if path == "limb":
            acc = _limb_rotate(acc, a_steps, bk, params)
        elif path == "generic":
            acc = _generic_rotate(acc, a_steps, bk, params)
        elif path == "hybrid":
            acc = _hybrid_rotate(acc, a_steps, bk, params)
        elif path == "k3":
            acc = rotate_all_k.rotate_all(acc, a_steps, bk.bk, params)
        else:
            bk = bk.bk if isinstance(bk, LatencyBK) else bk
            acc = cmux_k.cmux_rotate(acc, a_steps, bk, params, span)  # sets its product
    return acc.reshape(lead + (2, params.N))


def _rotation_path(bk, rows: int, params: TFHEParams) -> tuple[str, int, int]:
    """Which branch of ``blind_rotate`` a key takes at ``rows`` flattened
    rows, its steps (1 for K3's single launch) and the host calls that
    issue them (1 for K3 and for K1's ``cmux_rotate``, a step each on the
    Python loops)."""
    if isinstance(bk, LimbBK):
        return "limb", params.n, params.n
    if isinstance(bk, GenericBK):
        return "generic", params.n, params.n
    if isinstance(bk, HybridBK):
        steps = 2 * bk.panels_odd.shape[0] + bk.prep_tail.shape[0]
        return "hybrid", steps, steps
    if (isinstance(bk, LatencyBK) and rows <= rotate_all_k.MAX_BATCH
            and rotate_all_k.takes(params)):
        return "k3", 1, 1
    return "k1", params.n, 1


def gate_bootstrapping_tlwe2tlwe(ct: torch.Tensor,
                                 bk: torch.Tensor | LatencyBK | HybridBK | LimbBK | GenericBK,
                                 params: TFHEParams) -> torch.Tensor:
    """lv0 TLWE -> lv1 TLWE encrypting mu * sign."""
    mu = torch.full((params.N,), params.mu, dtype=torch.int32, device=ct.device)
    rotated = blind_rotate(ct, bk, trlwe.trivial(mu), params)
    with trace.span("extract", rows=rotated.shape[:-2].numel(), t=1):
        return trlwe.sample_extract(rotated, 0)


def identity_key_switch(ct_lv1: torch.Tensor, ksk: torch.Tensor,
                        params: TFHEParams) -> torch.Tensor:
    """lv1 TLWE (..., N+1) -> lv0 TLWE (..., n+1)."""
    with trace.span("key_switch", rows=ct_lv1.shape[:-1].numel()):
        digits = decompose_unsigned(ct_lv1[..., 1:], params)  # (..., N, iks_l)
        out = -key_switch_digits(ksk, digits, params)
        out[..., 0] += ct_lv1[..., 0]
    return out


def bootstrap(ct: torch.Tensor, ck: CloudKey, params: TFHEParams) -> torch.Tensor:
    """Full gate bootstrap: blind rotate, extract, key switch."""
    with trace.span("bootstrap", rows=ct.shape[:-1].numel()):
        lv1 = gate_bootstrapping_tlwe2tlwe(ct, ck.bk, params)
        return identity_key_switch(lv1, ck.ksk, params)
