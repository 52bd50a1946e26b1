"""Key generation and the keys carried across from the JAX package.

Counterpart of ``rustfhe_tpu/keys.py`` (standard and latency keys):
  * the secret keys, lv0 (n,) and lv1 (N,) bits;
  * the raw evaluation keys, engine-independent: BK int32 (n, 2L, 2, N),
    n TRGSW encryptions of the lv0 bits under lv1, and KSK int32
    (N, iks_l, T, n+1), TLWE encryptions of (t+1) * s1_i / 2^(basebit*(l+1));
  * the prepared cloud key, for the engine asked for (``engine``): BK
    as the int32 doubled tables K1 reads (``engine.plain.prepare_trgsw``,
    62 MB at DEFAULT_PARAMS; K1 cuts each step's table into int8 limb
    panels on the card as it runs), with, on the card, the leaf tables of
    K1's Karatsuba step beside them (``engine.cmux_k.leaf_table``, 140 MB
    at DEFAULT_PARAMS, kept with the key), or as the int8 doubled limb tables K4-K6
    read, marked ``LimbBK`` (``engine.plain.prepare_trgsw_limbs``, the
    same 62 MB), or as a generic engine's own table (``"matmul"``,
    ``"matmul_bf16"``, ``"fft64"``), marked ``GenericBK``; and the KSK as
    float64 slot rows (``engine.plain.prepare_ksk``).  The ``"nuss"``
    engine builds its tables host-side and is refused.

The latency-mode key (``cloud_key_latency``, counterpart of
``cloud_key_panels``) marks the bootstrapping key as ``LatencyBK``, so that
``bootstrap.blind_rotate`` runs the whole rotation as one launch of K3.
A limb or generic key has no latency form: ``cloud_key_latency`` returns
it as it is, as the JAX package does for engines without panel tables.

The hybrid key (``cloud_key_hybrid``, counterpart of the JAX function of
the same name) holds the odd steps' K1 key panels prebuilt
(``engine.cmux_k.key_panel``), so that ``bootstrap.blind_rotate`` runs
those steps without the panel kernel; ``full_panels`` prebuilds every
step's.  Its memory is checked against the card's before the build
(``guard_panel_memory``).

``from_jax_keys`` takes the numpy uint32 arrays of the JAX package's
``gen_secret_key`` / ``gen_cloud_key_raw``: raw keys are the whole
"weights carried across" step, so the two packages can be compared on one
key set.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from . import tlwe, trgsw
from ._u32 import from_numpy
from .engine import (GENERIC, CmuxKEngine, LimbEngine, MatmulEngine, NussTransformEngine,
                     cmux_k, resolve_engine)
from .engine.plain import prepare_ksk, prepare_trgsw, prepare_trgsw_limbs
from .params import TFHEParams
from .utils import trace
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
    code that passes ``ck.bk`` alone keeps it.  It holds no memory beyond
    the standard key's, so a batch above the cap simply takes the K1 loop."""

    bk: torch.Tensor


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


@dataclass(eq=False)
class GenericBK:
    """A bootstrapping key for a generic engine (``engine``: ``"matmul"``,
    ``"matmul_bf16"`` or ``"fft64"``, or an engine instance with their
    ``external_product_digits``, as ``parallel.sharded``'s tensor-parallel
    engines are): its ``prepare_trgsw`` table of every TRGSW (``table``,
    (n, ...)), which ``bootstrap.blind_rotate`` hands to the engine's
    external product on every step.  The engine travels with the key, as
    ``LimbBK``'s options do."""

    table: torch.Tensor
    engine: object


@dataclass(eq=False)
class HybridBK:
    """A bootstrapping key in hybrid form (``cloud_key_hybrid``): the
    rotation runs n//2 pairs of steps, then the n % 2 tail steps.

    * ``prep_even`` (n//2, ...): the even steps' doubled tables int32
      (n//2, 2L, 2, 2N), whose panels K1 builds per step, or with
      ``full_panels`` their panels int8 (n//2, *``cmux_k.panel_shape``);
    * ``panels_odd`` (n//2, *``cmux_k.panel_shape``) int8: the odd steps'
      panels, prebuilt;
    * ``prep_tail`` (n % 2, ...): the tail step as ``prep_even`` holds its
      steps.

    A step on a panel is ``cmux_k.cmux_step_panel``; a table step is K1's
    ``cmux_step``.  A hybrid key never takes K3."""

    prep_even: torch.Tensor
    panels_odd: torch.Tensor
    prep_tail: torch.Tensor
    full_panels: bool = False


class CloudKey(NamedTuple):
    """bk: doubled TRGSW tables int32 (n, 2L, 2, 2N), or those tables as a
    ``LatencyBK``, or a ``HybridBK``, or a ``LimbBK``, or a ``GenericBK``;
    ksk: float64 (T-1, N*iks_l, n+1)."""

    bk: torch.Tensor | LatencyBK | HybridBK | LimbBK | GenericBK
    ksk: torch.Tensor


def key_engine(bk) -> str:
    """The name of the engine a bootstrapping key was prepared for."""
    if isinstance(bk, (torch.Tensor, LatencyBK, HybridBK)):
        return CmuxKEngine.name
    if isinstance(bk, LimbBK):
        return LimbEngine.name
    if isinstance(bk, GenericBK):
        return resolve_engine(bk.engine).name
    raise TypeError(f"not a bootstrapping key: {type(bk).__name__}")


def check_key_engine(bk, engine, what: str) -> None:
    """Raise ValueError unless ``bk`` was prepared for ``engine`` (a name
    or an engine instance); ``None`` checks nothing.  ``what`` names the
    caller in the message."""
    if engine is None:
        return
    want = resolve_engine(engine).name
    if key_engine(bk) != want:
        raise ValueError(f"the key was prepared for {key_engine(bk)!r}, {what} for {want!r}")


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
    if isinstance(eng, NussTransformEngine):
        raise ValueError(
            "the nuss engine builds its key tables host-side in numpy, seconds per TRGSW "
            "(a 64 x 384 x 320 int8 panel stack at N=1024): it serves direct calls and the "
            "oracle probe, not a cloud key, as in the JAX package")
    if isinstance(eng, LimbEngine):
        bk = LimbBK(prepare_trgsw_limbs(bk_raw), eng.merge_c, eng.fuse_step)
    elif isinstance(eng, CmuxKEngine):
        bk = prepare_trgsw(bk_raw)
        if bk.is_cuda and cmux_k.wants_leaf_table(params):
            cmux_k.leaf_table(bk, params)  # read by the wide rotations' Karatsuba steps
    else:  # a PolyEngine: one of this package's by its name, a registered one as itself
        bk = GenericBK(eng.prepare_trgsw(bk_raw, params),
                       eng.name if isinstance(eng, GENERIC) else eng)
    return CloudKey(bk=bk, ksk=prepare_ksk(ksk_raw, params))


def gen_cloud_key(gen: torch.Generator, sk: SecretKey, params: TFHEParams,
                  engine="cmux_k") -> CloudKey:
    """The evaluation key prepared for ``engine`` (the JAX package's
    ``gen_cloud_key``): ``gen_cloud_key_raw`` then ``prepare_cloud_key``."""
    return prepare_cloud_key(*gen_cloud_key_raw(gen, sk, params), params, engine)


def cloud_key_latency(ck: CloudKey) -> CloudKey:
    """The latency-mode cloud key (counterpart of ``cloud_key_panels``): the
    bootstrapping key marked ``LatencyBK``.  K3 reads the standard prepared
    tables, so no memory is added; the JAX package's panel-memory guard
    (``_guard_panel_hbm``) has nothing to guard here.  A limb key has no
    latency form and is returned unchanged, as JAX returns the keys of
    engines without panel tables; so is a generic key."""
    with trace.span("setup.keys", engine=key_engine(ck.bk)):
        if isinstance(ck.bk, (LatencyBK, HybridBK, LimbBK, GenericBK)):
            return ck
        return CloudKey(bk=LatencyBK(ck.bk), ksk=ck.ksk)


cloud_key_panels = cloud_key_latency  # the JAX package's name


def card_memory_bytes(device) -> int | None:
    """The card's total memory in bytes (``torch.cuda.mem_get_info``), or
    None on the CPU, where no limit is known."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.mem_get_info(device)[1]


def panels_nbytes(params: TFHEParams, full_panels: bool = False) -> int:
    """The bytes of a hybrid key's prebuilt panels: the n//2 odd steps', or
    with ``full_panels`` all n steps' (11.8 MB a step at DEFAULT_PARAMS,
    32.5 MB at PBS_PARAMS)."""
    steps = params.n if full_panels else params.n // 2
    return steps * math.prod(cmux_k.panel_shape(params))


def guard_panel_memory(need: int, params: TFHEParams, what: str, limit: int | None) -> None:
    """Raise MemoryError before a panel build that cannot fit: ``need``
    bytes above 92 % of ``limit`` (the JAX ``_guard_panel_hbm``'s fit
    check).  With no limit known (None), nothing is blocked.  JAX's second
    rule, one large panel key per process, guards XLA's uncompacted device
    memory; torch's caching allocator reuses a freed key's blocks for the
    next one, so the port does not carry that rule."""
    if limit is None or need <= 0.92 * limit:
        return
    gib = 1024.0**3
    raise MemoryError(
        f"{what} needs ~{need / gib:.1f} GiB of panel tables at N={params.N}, "
        f"n={params.n}, but the device has only {limit / gib:.1f} GiB: there is no "
        "latency/panel mode at this parameter set; use the standard per-step key, or "
        "cloud_key_hybrid(full_panels=False) if the half-size table fits.")


def cloud_key_hybrid(ck: CloudKey, params: TFHEParams, engine="cmux_k",
                     full_panels: bool = False,
                     device_bytes_limit: int | None = None) -> CloudKey:
    """The hybrid cloud key (``HybridBK``): the odd steps' K1 key panels
    built once here (``cmux_k.key_panel``, one launch a step), the even
    steps' tables kept, so that a rotation launches the panel kernel on
    half its steps.  ``full_panels`` prebuilds the even and tail steps'
    panels too: no panel kernel in the rotation at all, for twice the
    memory (DEFAULT_PARAMS: 3.74 GB, full 7.49 GB; PBS_PARAMS: 11.6 GB,
    full 23.2 GB).

    ``engine`` without a pair step (``"limb"``, the generic engines) gets
    the key back unchanged, as JAX returns it, and so does a key that is
    already hybrid or not a K1 table.  A latency key's tables are taken
    as they are: a hybrid key never takes K3.  Raises MemoryError before
    any allocation when the panels cannot fit ``device_bytes_limit``
    (default: the key's card, ``card_memory_bytes``)."""
    if not isinstance(resolve_engine(engine), CmuxKEngine):
        return ck
    bk = ck.bk.bk if isinstance(ck.bk, LatencyBK) else ck.bk
    if not isinstance(bk, torch.Tensor):
        return ck
    limit = (device_bytes_limit if device_bytes_limit is not None
             else card_memory_bytes(bk.device))
    guard_panel_memory(panels_nbytes(params, full_panels), params, "cloud_key_hybrid", limit)
    npairs = bk.shape[0] // 2

    def panels(tables: torch.Tensor) -> torch.Tensor:
        out = torch.empty((tables.shape[0],) + cmux_k.panel_shape(params), dtype=torch.int8,
                          device=tables.device)
        for i in range(tables.shape[0]):
            cmux_k.key_panel(tables[i], params, out=out[i])
        return out

    even, tail = bk[0: 2 * npairs: 2], bk[2 * npairs:]
    if full_panels:
        even, tail = panels(even), panels(tail)
    hb = HybridBK(prep_even=even, panels_odd=panels(bk[1: 2 * npairs: 2]), prep_tail=tail,
                  full_panels=full_panels)
    return CloudKey(bk=hb, ksk=ck.ksk)


def gen_keys(gen: torch.Generator, params: TFHEParams, device,
             engine="cmux_k") -> tuple[SecretKey, CloudKey]:
    """One-call keygen on ``device``: (SecretKey, CloudKey prepared for
    ``engine``).  The random draws do not depend on the engine."""
    with trace.span("setup.keys", engine=getattr(engine, "name", engine)):
        sk = gen_secret_key(gen, params, device)
        return sk, gen_cloud_key(gen, sk, params, engine)


def from_jax_keys(lv0, lv1, bk_raw, ksk_raw, params: TFHEParams, device,
                  engine="cmux_k", bk_table=None) -> tuple[SecretKey, CloudKey]:
    """The JAX package's keys (numpy uint32 arrays: lv0 (n,), lv1 (N,),
    bk_raw (n, 2L, 2, N), ksk_raw (N, iks_l, T, n+1)) -> the port's keys
    on ``device``, prepared for ``engine``.  ``bk_table``: for
    ``"matmul"`` / ``"matmul_bf16"``, JAX's ``MatmulEngine.prepare_trgsw``
    table of ``bk_raw`` as numpy int8, taken as the key's table (the port's
    layout is JAX's), so both packages compute on one prepared key."""
    with trace.span("setup.keys", engine=getattr(engine, "name", engine)):
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
        if bk_table is None:
            return sk, prepare_cloud_key(t["bk_raw"], t["ksk_raw"], params, engine)
        eng = resolve_engine(engine)
        if not isinstance(eng, MatmulEngine):
            raise ValueError(f"bk_table is a matmul engine's table; the key is for {eng.name!r}")
        want = (params.n, 2 * params.l, 2, eng.num_limbs, 2 * params.N)
        table = torch.from_numpy(np.array(bk_table))
        if table.dtype != torch.int8 or tuple(table.shape) != want:
            raise ValueError(f"bk_table must be int8 {want}, got {table.dtype} "
                             f"{tuple(table.shape)}")
        ksk = prepare_ksk(t["ksk_raw"], params)
        return sk, CloudKey(GenericBK(table.to(device), eng.name), ksk)
