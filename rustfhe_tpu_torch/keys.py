"""Key generation and the keys carried across from the JAX package.

Counterpart of ``rustfhe_tpu/keys.py`` (standard and latency keys):
  * the secret keys, lv0 (n,) and lv1 (N,) bits;
  * the raw evaluation keys, engine-independent: BK int32 (n, 2L, 2, N),
    n TRGSW encryptions of the lv0 bits under lv1, and KSK int32
    (N, iks_l, T, n+1), TLWE encryptions of (t+1) * s1_i / 2^(basebit*(l+1));
  * the prepared cloud key, for one of the two engines (``engine``): BK
    as the int32 doubled tables K1 reads (``engine.plain.prepare_trgsw``,
    62 MB at DEFAULT_PARAMS), or as the int8 doubled limb tables K4-K6
    read, marked ``LimbBK`` (``engine.plain.prepare_trgsw_limbs``, the
    same 62 MB), and the KSK as float64 slot rows
    (``engine.plain.prepare_ksk``).

The latency-mode key (``cloud_key_latency``, counterpart of
``cloud_key_panels``) marks the bootstrapping key as ``LatencyBK``, so that
``bootstrap.blind_rotate`` runs the whole rotation as one launch of K3.
A limb key has no latency form: ``cloud_key_latency`` returns it as it is,
as the JAX package does for engines without panel tables.

``from_jax_keys`` takes the numpy uint32 arrays of the JAX package's
``gen_secret_key`` / ``gen_cloud_key_raw``: raw keys are the whole
"weights carried across" step, so the two packages can be compared on one
key set.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from . import tlwe, trgsw
from ._u32 import from_numpy
from .engine import LimbEngine, resolve_engine
from .engine.plain import prepare_ksk, prepare_trgsw, prepare_trgsw_limbs
from .params import TFHEParams
from .utils.rng import binary_array


class SecretKey(NamedTuple):
    """lv0: (n,) int32 bits; lv1: (N,) int32 bits."""

    lv0: torch.Tensor
    lv1: torch.Tensor


@dataclass(eq=False)
class LatencyBK:
    """A bootstrapping key marked for the latency path: the same prepared
    tables (``bk``, int32 (n, 2L, 2, 2N)), which ``bootstrap.blind_rotate``
    hands to the single-launch rotation K3 at small batches.  The mark
    travels with the key itself, as the JAX package's panel form does, so
    code that passes ``ck.bk`` alone keeps it.  ``warned`` records that the
    above-cap warning was given for this key."""

    bk: torch.Tensor
    warned: bool = False


@dataclass(eq=False)
class LimbBK:
    """A bootstrapping key for the limb engine: the doubled limb tables
    (``table``, int8 (n, 2L, 2, 4, 2N)) and the engine's options, which
    ``bootstrap.blind_rotate`` follows: K4 per step, K6 with ``merge_c``
    False, or torch decomposition then K5 with ``fuse_step`` False.  The
    engine travels with the key, as the latency mark does."""

    table: torch.Tensor
    merge_c: bool = True
    fuse_step: bool = True


class CloudKey(NamedTuple):
    """bk: doubled TRGSW tables int32 (n, 2L, 2, 2N), or those tables as a
    ``LatencyBK``, or a ``LimbBK``; ksk: float64 (T-1, N*iks_l, n+1)."""

    bk: torch.Tensor | LatencyBK | LimbBK
    ksk: torch.Tensor


def gen_secret_key(gen: torch.Generator, params: TFHEParams, device) -> SecretKey:
    return SecretKey(
        lv0=binary_array(gen, (params.n,), device),
        lv1=binary_array(gen, (params.N,), device),
    )


def gen_bootstrapping_key_raw(gen: torch.Generator, sk: SecretKey,
                              params: TFHEParams) -> torch.Tensor:
    """Raw BK int32 (n, 2L, 2, N): TRGSW(s0_i) under s1."""
    return trgsw.encrypt_int(gen, sk.lv1, sk.lv0, params)


def gen_key_switching_key_raw(gen: torch.Generator, sk: SecretKey,
                              params: TFHEParams) -> torch.Tensor:
    """Raw KSK int32 (N, iks_l, T, n+1); slot t encrypts
    (t+1) * s1_i * 2^(32 - basebit*(l+1)) (wrapping) under lv0."""
    dev = sk.lv1.device
    t_vals = torch.arange(1, params.iks_t + 1, dtype=torch.int32, device=dev)
    shifts = torch.tensor([32 - params.iks_basebit * (l + 1) for l in range(params.iks_l)],
                          dtype=torch.int32, device=dev)
    msgs = (sk.lv1[:, None, None] * t_vals[None, None, :]) << shifts[None, :, None]
    return tlwe.encrypt_torus(gen, sk.lv0, msgs, params)


def gen_cloud_key_raw(gen: torch.Generator, sk: SecretKey, params: TFHEParams):
    """(bk_raw, ksk_raw) int32 on the device of ``sk``."""
    bk_raw = gen_bootstrapping_key_raw(gen, sk, params)
    return bk_raw, gen_key_switching_key_raw(gen, sk, params)


def prepare_cloud_key(bk_raw: torch.Tensor, ksk_raw: torch.Tensor, params: TFHEParams,
                      engine="cmux_k") -> CloudKey:
    """The raw keys prepared for ``engine`` (a name or an engine instance,
    ``engine.resolve_engine``)."""
    eng = resolve_engine(engine)
    if isinstance(eng, LimbEngine):
        bk = LimbBK(prepare_trgsw_limbs(bk_raw), eng.merge_c, eng.fuse_step)
    else:
        bk = prepare_trgsw(bk_raw)
    return CloudKey(bk=bk, ksk=prepare_ksk(ksk_raw, params))


def cloud_key_latency(ck: CloudKey) -> CloudKey:
    """The latency-mode cloud key (counterpart of ``cloud_key_panels``): the
    bootstrapping key marked ``LatencyBK``.  K3 reads the standard prepared
    tables, so no memory is added; the JAX package's panel-memory guard
    (``_guard_panel_hbm``) has nothing to guard here.  A limb key has no
    latency form and is returned unchanged, as JAX returns the keys of
    engines without panel tables."""
    if isinstance(ck.bk, (LatencyBK, LimbBK)):
        return ck
    return CloudKey(bk=LatencyBK(ck.bk), ksk=ck.ksk)


def gen_keys(gen: torch.Generator, params: TFHEParams, device,
             engine="cmux_k") -> tuple[SecretKey, CloudKey]:
    """One-call keygen on ``device``: (SecretKey, CloudKey prepared for
    ``engine``).  The random draws do not depend on the engine."""
    sk = gen_secret_key(gen, params, device)
    return sk, prepare_cloud_key(*gen_cloud_key_raw(gen, sk, params), params, engine)


def from_jax_keys(lv0, lv1, bk_raw, ksk_raw, params: TFHEParams, device,
                  engine="cmux_k") -> tuple[SecretKey, CloudKey]:
    """The JAX package's keys (numpy uint32 arrays: lv0 (n,), lv1 (N,),
    bk_raw (n, 2L, 2, N), ksk_raw (N, iks_l, T, n+1)) -> the port's keys
    on ``device``, prepared for ``engine``."""
    shapes = {
        "lv0": (params.n,),
        "lv1": (params.N,),
        "bk_raw": (params.n, 2 * params.l, 2, params.N),
        "ksk_raw": (params.N, params.iks_l, params.iks_t, params.n + 1),
    }
    arrays = {"lv0": lv0, "lv1": lv1, "bk_raw": bk_raw, "ksk_raw": ksk_raw}
    t = {}
    for name, want in shapes.items():
        arr = arrays[name]
        if tuple(arr.shape) != want:
            raise ValueError(f"{name} has shape {tuple(arr.shape)}, expected {want}")
        t[name] = from_numpy(arr, device)
    sk = SecretKey(lv0=t["lv0"], lv1=t["lv1"])
    return sk, prepare_cloud_key(t["bk_raw"], t["ksk_raw"], params, engine)
