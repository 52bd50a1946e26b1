"""Programmable bootstrapping (PBS): arbitrary lookup tables on encrypted ints.

Counterpart of ``rustfhe_tpu/pbs.py``, held to it word for word
(``tests/test_torch_pbs.py``).  The gate bootstrap is one hard-coded
lookup: a constant-mu test vector whose blind rotation computes
sign(phase).  PBS generalises it: messages of Z_space are encoded on the
torus with one padding bit, and a staircase test vector carries an
arbitrary table, so one blind rotation evaluates ``table[x]`` and resets
the noise as a gate bootstrap does.  It runs on the gate bootstrap's own
pieces: ``bootstrap.blind_rotate`` (K1 per step on a standard key, one
launch of K3 on a latency key at up to ``rotate_all_k.MAX_BATCH`` rows),
sample extraction and the identity key switch.

Encoding (one padding bit): ``x in [0, space)`` maps to the torus value
``x / (2*space)``, so every valid phase lies in [0, 1/2) and the
rotation index stays in [0, N): the negacyclic wrap is never hit.  A
half-bucket offset ``1/(4*space)`` is added to the body before rotating,
so that each bucket's phase window is centred: the noise margin is a
half-bucket on both sides.

Outputs encode ``table[x]`` in the same space, so PBS calls chain; the
noise model of ``utils/noise.py`` applies with the decision margin 1/16
replaced by ``1/(4*space)`` (``check_pbs_space``).  At DEFAULT_PARAMS
space 4 passes (5.7 calibrated sigma) and space 8 does not (2.8);
``params.PBS_PARAMS`` (N=2048, n=714, l=4) takes space 8 at 15.5
calibrated sigma (8.1 for ``pbs_many`` at t=2) and carries the radix
integers (``radix.py``).

Batching: ``ct (..., n+1)`` with ``table (space,)`` applies one function
to the whole batch through a single (2, N) test vector; ``table (...,
space)`` (leading axes broadcastable against the batch) evaluates a
different function per row, through a test vector per row that
``blind_rotate`` flattens with the rows, at the same kernel launches.

Port notes: the torus words are int32 tensors with the uint32 bits
(``_u32``); raw tables (arbitrary torus words, e.g. -mu >= 2^31) come in
as numpy uint32 and cross through ``_u32.from_numpy``.  ``pbs`` and
``pbs_many`` take the port's ``CloudKey``, which carries its engine, in
place of the JAX function's ``engine_name``; the JAX package checks the
margin gate once per compiled program, the port on every call.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from . import tlwe, trlwe
from ._u32 import from_numpy, s32, srl, wrap
from .bootstrap import blind_rotate, identity_key_switch
from .keys import CloudKey
from .params import TFHEParams


def _check_space(space: int, params: TFHEParams) -> None:
    if space < 2 or space & (space - 1):
        raise ValueError(f"space must be a power of two >= 2, got {space}")
    if space > params.N:
        raise ValueError(
            f"space ({space}) cannot exceed N ({params.N}): each bucket needs "
            f">= 1 test-vector coefficient"
        )


def _ints(x) -> torch.Tensor:
    """Integers of any width (tensor, numpy, list, int) -> int64 tensor with
    the same low 32 bits (a uint64 above 2^63 keeps its low bits)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _shape(x) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


def words(x, device=None) -> torch.Tensor:
    """Raw torus words (int32 tensor, or numpy/list uint32 values) -> int32
    tensor with the same bits on ``device`` (the tensor's own by default)."""
    if isinstance(x, torch.Tensor):
        t = x if x.dtype == torch.int32 else wrap(x.to(torch.int64) & 0xFFFFFFFF)
        return t if device is None else t.to(device)
    return from_numpy(x, device)


def encode_int(x, space: int) -> torch.Tensor:
    """Cleartext int(s) -> torus value(s) x / (2*space), int32 words.

    Values are taken mod 2*space (the padding bit makes the usable message
    range [0, space); chainable outputs should stay in it).  Exact: 2*space
    is a power of two, so it divides 2^32.  A tensor keeps its device."""
    step = (1 << 32) // (2 * space)
    return wrap((_ints(x) & (2 * space - 1)) * step)


def decode_int(phase, space: int) -> torch.Tensor:
    """Torus phase(s) -> nearest bucket index in [0, 2*space), int32."""
    k = (2 * space).bit_length() - 1  # log2(2*space)
    half = (1 << 32) // (4 * space)
    return srl(words(phase) + s32(half), 32 - k)


def encrypt_int(gen: torch.Generator, s: torch.Tensor, x, space: int,
                params: TFHEParams) -> torch.Tensor:
    """Encrypt int(s) in [0, space) under lv0 key ``s``: (..., n+1) int32."""
    _check_space(space, params)
    return tlwe.encrypt_torus(gen, s, encode_int(x, space).to(s.device), params)


def decrypt_int(ct: torch.Tensor, s: torch.Tensor, space: int) -> torch.Tensor:
    """Decrypt to the nearest message in [0, 2*space)."""
    return decode_int(tlwe.phase(ct, s), space)


def _values(table, space: int, raw: bool, device) -> torch.Tensor:
    """A table's torus words on ``device``: raw words as given, or ints
    through ``encode_int``."""
    if raw:
        return words(table, device)
    return encode_int(table, space).to(device)


def lut_testvec(table, space: int, params: TFHEParams, raw: bool = False,
                device=None) -> torch.Tensor:
    """Table (..., space) of ints -> staircase trivial TRLWE (..., 2, N).

    Coefficient j of the test polynomial holds encode(table[j * space / N]):
    N/space repeated coefficients per bucket, so every phase inside bucket
    x's (centred) window extracts to the same value.

    ``raw=True``: table entries are raw torus words emitted as they are
    (an arbitrary output encoding, e.g. the gates' +-mu), not ints passed
    through ``encode_int``.  ``device``: where the vector goes (the
    table's own by default)."""
    _check_space(space, params)
    if _shape(table)[-1:] != (space,):
        raise ValueError(f"table last axis must be space={space}, got {_shape(table)}")
    vals = _values(table, space, raw, device)  # (..., space)
    return trlwe.trivial(vals.repeat_interleave(params.N // space, dim=-1))


def pbs(ck: CloudKey, ct: torch.Tensor, table, *, space: int, params: TFHEParams,
        raw: bool = False, unsafe: bool = False) -> torch.Tensor:
    """Programmable bootstrap: lv0 TLWE of x -> lv0 TLWE of table[x].

    ``ct (..., n+1)`` int32 encrypting x in [0, space) under the
    padding-bit encoding; ``table (space,)`` or ``(..., space)`` ints
    (taken mod 2*space), broadcastable against the batch.  ``ck`` carries
    its engine (the JAX function's ``engine_name``): K1 per step on a
    standard key, K3 on a latency key, as ``bootstrap.bootstrap``.

    The (space, params) pair is margin-gated on every call
    (``_gate_margin``: raise below 3 calibrated sigma, warn below 5);
    ``unsafe=True`` skips the gate for borderline-margin measurements.

    Cost: one gate bootstrap (the same blind rotation, sample extraction
    and key switch).  ``ct`` is not written to.
    """
    _check_space(space, params)
    _gate_margin(params, space, 1, unsafe, "pbs")
    # Half-bucket pre-offset centres each bucket's phase window (module doc).
    pre = tlwe.add_to_body(ct, (1 << 32) // (4 * space))
    testvec = lut_testvec(table, space, params, raw=raw, device=ct.device)
    rotated = blind_rotate(pre, ck.bk, testvec, params)
    lv1 = trlwe.sample_extract(rotated, 0)
    return identity_key_switch(lv1, ck.ksk, params)


def many_lut_testvec(tables, space: int, params: TFHEParams, raw: bool = False,
                     device=None) -> torch.Tensor:
    """Tables (..., t, space) -> interleaved staircase TRLWE (..., 2, N).

    Coefficient ``c = t*k + j`` holds ``encode(tables[j][bucket(t*k)])``:
    when the blind-rotation index is a multiple of t (``pbs_many``'s
    coarsened modulus switch guarantees it), extracting coefficient j
    yields table j's lookup, t lookups from one rotation (the PBSmanyLUT
    construction of Chillotti-Ligier-Orfila-Tap 2021)."""
    t = _shape(tables)[-2]
    _check_many(space, t, params)
    vals = _values(tables, space, raw, device)  # (..., t, space)
    reps = params.N // (space * t)
    vt = vals.transpose(-2, -1)  # (..., space, t)
    lead = vt.shape[:-2]
    v = vt[..., :, None, :].expand(lead + (space, reps, t)).reshape(lead + (params.N,))
    return trlwe.trivial(v)


def _check_many(space: int, t: int, params: TFHEParams) -> None:
    _check_space(space, params)
    if t < 1 or t & (t - 1):
        raise ValueError(f"t must be a power of two >= 1, got {t}")
    if space * t > params.N:
        raise ValueError(
            f"space*t ({space * t}) cannot exceed N ({params.N}): each of the "
            f"t sub-slots needs >= 1 coefficient per bucket"
        )


def rotate_extract_many(bk, ct: torch.Tensor, tables, space: int, params: TFHEParams,
                        raw: bool = False) -> torch.Tensor:
    """The rotation half of ``pbs_many`` without the key switch: coarsened
    modulus switch + interleaved-staircase blind rotation + t sample
    extractions -> lv1 TLWE batch (..., t, N+1).  ``bk`` carries its
    engine (the JAX function's ``engine`` argument)."""
    t = _shape(tables)[-2]
    _check_many(space, t, params)
    shift = 32 - params.nbit - 1
    pre = tlwe.add_to_body(ct, (1 << 32) // (4 * space))
    tau = t.bit_length() - 1
    if tau:
        # Coarse modulus switch: round every word to the 2^(shift+tau) grid
        # (wrapping), so b~ and every a~_i, and hence their signed sum mod
        # 2N, are multiples of t.  blind_rotate's own floor/round then
        # passes the grid through exactly.  The mask has the top bit set:
        # it is the int32 word with the uint32 bits.
        half = 1 << (shift + tau - 1)
        mask = ((1 << 32) - 1) ^ ((1 << (shift + tau)) - 1)
        pre = (pre + s32(half)) & s32(mask)
    testvec = many_lut_testvec(tables, space, params, raw=raw, device=ct.device)
    rotated = blind_rotate(pre, bk, testvec, params)
    return torch.stack([trlwe.sample_extract(rotated, j) for j in range(t)], dim=-2)


def pbs_many(ck: CloudKey, ct: torch.Tensor, tables, *, space: int, params: TFHEParams,
             raw: bool = False, unsafe: bool = False) -> torch.Tensor:
    """Multi-output PBS: t lookup tables on the same x for the price of one
    blind rotation (PBSmanyLUT).

    ``ct (..., n+1)`` encrypting x in [0, space); ``tables (..., t, space)``
    (t a power of two, leading axes broadcastable against the batch).
    Returns ``(..., t, n+1)``: row j encrypts ``tables[j][x]``, in the same
    space (chainable).  ``ck`` carries its engine, as for ``pbs``.

    How: the modulus switch is coarsened to multiples of t (every word is
    pre-rounded to a multiple of 2^(32-nbit-1+log2 t), so the rotation
    index is always 0 mod t) and the test vector interleaves the t tables
    (``many_lut_testvec``); extracting coefficients 0..t-1 of the one
    rotated accumulator yields all t lookups.  Noise: the modulus-switch
    drift variance grows by t^2 (``check_pbs_many``); the (space, t,
    params) triple is margin-gated on every call like ``pbs``
    (``unsafe=True`` skips the gate).
    """
    t = _shape(tables)[-2]
    _gate_margin(params, space, t, unsafe, "pbs_many")
    lv1 = rotate_extract_many(ck.bk, ct, tables, space, params, raw=raw)
    return identity_key_switch(lv1, ck.ksk, params)


def pbs_margin(params: TFHEParams, space: int, t: int = 1):
    """CalibratedMargin for a (space, t) multi-output PBS: decision
    half-width 1/(4*space), plus the coarsened modulus switch's t^2 drift
    excess (the only term it changes), stated as a per-preset calibrated
    lower bound (``utils.noise.calibrated_margin``)."""
    from .utils.noise import calibrated_margin, noise_budget

    _check_many(space, t, params)
    extra = (t * t - 1) * noise_budget(params).var_rounding
    return calibrated_margin(params, 1.0 / (4.0 * space), extra_var=extra)


def check_pbs_many(params: TFHEParams, space: int, t: int,
                   min_sigmas: float = 5.0) -> tuple[bool, str]:
    """Noise-budget verdict for ``pbs_many`` at (space, t): the calibrated
    lower-bound margin must exceed ``min_sigmas``."""
    cm = pbs_margin(params, space, t)
    msg = f"space={space}, t={t}: {cm.describe()}"
    return cm.lower_bound_sigmas >= min_sigmas, msg


def check_pbs_space(params: TFHEParams, space: int,
                    min_sigmas: float = 5.0) -> tuple[bool, str]:
    """Noise-budget verdict for PBS at ``space`` on bootstrapped inputs:
    ``utils.noise.check_params`` with the gate margin 1/16 replaced by the
    bucket half-width 1/(4*space), stated as the preset-calibrated lower
    bound (DEFAULT_PARAMS gets its anchor-3 correction and fails space 8;
    at PBS_PARAMS the uncorrected prediction is the bound)."""
    _check_space(space, params)
    cm = pbs_margin(params, space, 1)
    msg = f"space={space}: {cm.describe()}"
    return cm.lower_bound_sigmas >= min_sigmas, msg


#: Margin gate thresholds for pbs()/pbs_many(): below RAISE the decode is
#: unreliable (~0.5%+ error/lookup) and the call refuses without
#: unsafe=True; below WARN it runs but warns.
RAISE_BELOW_SIGMAS = 3.0
WARN_BELOW_SIGMAS = 5.0


def _gate_margin(params: TFHEParams, space: int, t: int, unsafe: bool,
                 what: str) -> None:
    """The margin gate, before any key is touched."""
    if unsafe:
        return
    cm = pbs_margin(params, space, t)
    lb = cm.lower_bound_sigmas
    at = f"{what} at space={space}" + (f", t={t}" if t > 1 else "")
    if lb < RAISE_BELOW_SIGMAS:
        raise ValueError(
            f"{at}: calibrated lower-bound margin {lb:.1f} sigma < "
            f"{RAISE_BELOW_SIGMAS} — lookups would decode wrong at the "
            f"~0.5%+ level on this parameter set ({cm.describe()}).  Use a "
            "PBS-tuned preset (params.PBS_PARAMS), a smaller space/t, or "
            "pass unsafe=True for borderline-margin measurements."
        )
    if lb < WARN_BELOW_SIGMAS:
        warnings.warn(
            f"{at}: calibrated lower-bound margin {lb:.1f} sigma < "
            f"{WARN_BELOW_SIGMAS} ({cm.describe()}) — occasional wrong "
            "lookups are expected at large batch",
            stacklevel=3,
        )
