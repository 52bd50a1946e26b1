"""Bootstrapped homomorphic gates, batched.

Counterpart of ``rustfhe_tpu/gates.py``.  Every gate is a linear
pre-combination of its inputs followed by one shared bootstrap:

  NAND: mu - (x + y)        AND: (x + y) - mu       OR:  (x + y) + mu
  XOR:  2(x + y) + 2mu      NOT: -x                 ANDN: -x + y - mu
  MUX:  and(control, in1), andn(control, in0) in one stacked bootstrap,
        then their OR (two bootstrap passes of latency, three of work)

The key's form decides the engine (``keys.key_engine``): K1-K3 on a
``"cmux_k"`` key, K4-K6 on a limb key, a generic engine's product on its
key.  ``engine_name`` (the JAX package's static argument) names the
engine the caller expects, by this package's name (a JAX engine's name is
mapped only where it comes from ``RUSTFHE_ENGINE``), and a key prepared
for another one raises.
No gate checks the noise margin, as in the JAX package (only ``pbs``
and the radix ops do).
"""

from __future__ import annotations

import torch

from ._u32 import s32
from .bootstrap import bootstrap
from .keys import CloudKey, check_key_engine
from .params import TFHEParams

# Linear pre-combination coefficients (ca, cb, c_mu): pre = ca*x + cb*y +
# c_mu*mu on the body.  "andn" is and(!x, y), the mux first-pass helper.
PRE_COEFFS = {
    "nand": (-1, -1, 1),
    "and": (1, 1, -1),
    "or": (1, 1, 1),
    "xor": (2, 2, 2),
    "not": (-1, 0, 0),
    "andn": (-1, 1, -1),
}


def precombine(op: str, x: torch.Tensor, y: torch.Tensor | None = None, *,
               params: TFHEParams) -> torch.Tensor:
    """Linear gate pre-combination of TLWE batches ``(..., n+1)``."""
    ca, cb, cm = PRE_COEFFS[op]
    pre = x * ca
    if cb:
        pre = pre + y * cb
    if cm:
        pre[..., 0] += s32(cm * params.mu)
    return pre


GATE_INPUTS = {"nand": 2, "and": 2, "or": 2, "xor": 2, "not": 1, "mux": 3}


def gate_circuit(op: str, cts, *, params: TFHEParams, boot) -> torch.Tensor:
    """Gate ``op`` (a key of ``GATE_INPUTS``) of the TLWE batches ``cts``,
    ``boot(pre)`` its bootstrap: the pre-combination, then one bootstrap;
    MUX's two ANDs as one bootstrap of the two batches stacked on a new
    leading axis, then the OR.  The gates here, the context's and the
    sharded ones (``parallel.sharded``) are this one composition."""
    if op not in GATE_INPUTS:
        raise ValueError(f"unknown gate {op!r}; have {sorted(GATE_INPUTS)}")
    if len(cts) != GATE_INPUTS[op]:
        raise TypeError(f"{op} takes {GATE_INPUTS[op]} ciphertext batches, got {len(cts)}")
    if op != "mux":
        return boot(precombine(op, *cts, params=params))
    control, in0, in1 = cts
    both = boot(torch.stack([precombine("and", control, in1, params=params),
                             precombine("andn", control, in0, params=params)]))
    return boot(precombine("or", both[0], both[1], params=params))


def _boot(ck: CloudKey, params: TFHEParams, engine_name):
    check_key_engine(ck.bk, engine_name, "the gate")
    return lambda pre: bootstrap(pre, ck, params)


def hom_bootstrap(ck: CloudKey, pre: torch.Tensor, *, params: TFHEParams,
                  engine_name=None) -> torch.Tensor:
    """Bootstrap an already pre-combined batch (the shared second half of
    every gate)."""
    return _boot(ck, params, engine_name)(pre)


def _gate(op: str):
    def gate(ck: CloudKey, x: torch.Tensor, y: torch.Tensor, *, params: TFHEParams,
             engine_name=None) -> torch.Tensor:
        return gate_circuit(op, (x, y), params=params, boot=_boot(ck, params, engine_name))

    gate.__name__ = gate.__qualname__ = f"hom_{op}"
    gate.__doc__ = f"The bootstrapped {op.upper()} of TLWE batches ``x``, ``y`` ``(..., n+1)``."
    return gate


hom_nand = _gate("nand")
hom_and = _gate("and")
hom_or = _gate("or")
hom_xor = _gate("xor")


def hom_not(ck: CloudKey, x: torch.Tensor, *, params: TFHEParams,
            engine_name=None) -> torch.Tensor:
    return gate_circuit("not", (x,), params=params, boot=_boot(ck, params, engine_name))


def hom_mux(ck: CloudKey, control: torch.Tensor, in0: torch.Tensor, in1: torch.Tensor, *,
            params: TFHEParams, engine_name=None) -> torch.Tensor:
    """(in1 & control) | (in0 & !control): two bootstrap passes of latency,
    three of work (``gate_circuit``)."""
    return gate_circuit("mux", (control, in0, in1), params=params,
                        boot=_boot(ck, params, engine_name))


GATES_2IN = {"nand": hom_nand, "and": hom_and, "or": hom_or, "xor": hom_xor}
