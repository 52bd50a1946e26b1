"""Key and ciphertext (de)serialization.

Counterpart of ``rustfhe_tpu/utils/serialization.py``, in the same npz
format, so that files cross between the two packages: a JSON header
(magic ``rustfhe_tpu``, version 1, the parameter fields) as uint8 bytes,
then raw uint32 arrays.  Keys are stored raw (``bk`` (n, 2L, 2, N), ``ksk``
(N, iks_l, T, n+1), ``lv0``/``lv1``), not in a prepared form; preparation
runs again on load, on the device and for the engine asked for, so one
file serves both engines.
"""

from __future__ import annotations

import json
import os
import time
import zipfile

import numpy as np
import torch

from .. import keys as _keys
from .._device import resolve_device
from .._u32 import from_numpy, to_numpy
from ..keys import CloudKey, SecretKey
from ..params import TFHEParams

_PARAM_FIELDS = ("n", "N", "alpha_lv0", "alpha_lv1", "bgbit", "l", "iks_basebit", "iks_l")

MAGIC = "rustfhe_tpu"
VERSION = 1


def _params_header(params: TFHEParams) -> np.ndarray:
    meta = {"magic": MAGIC, "version": VERSION,
            "params": {f: getattr(params, f) for f in _PARAM_FIELDS}}
    return np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)


def _parse_header(arr: np.ndarray) -> TFHEParams:
    meta = json.loads(bytes(arr.tobytes()).decode())
    if meta.get("magic") != MAGIC:
        raise ValueError("not a rustfhe_tpu file")
    if meta.get("version") != VERSION:
        raise ValueError(f"unsupported version {meta.get('version')}")
    return TFHEParams(**meta["params"])


def _words(x) -> np.ndarray:
    """int32 torus-word tensor, or anything numpy reads as uint32 -> uint32."""
    if isinstance(x, torch.Tensor):
        return to_numpy(x)
    return np.asarray(x).astype(np.uint32)


def save_secret_key(path: str, sk: SecretKey, params: TFHEParams) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, header=_params_header(params),
                        lv0=_words(sk.lv0), lv1=_words(sk.lv1))
    # SECRET key material: owner-only, regardless of umask.
    real = path if path.endswith(".npz") else path + ".npz"
    os.chmod(real, 0o600)


def load_secret_key(path: str, device="cuda") -> tuple[SecretKey, TFHEParams]:
    device = resolve_device(device)
    with np.load(path) as z:
        params = _parse_header(z["header"])
        sk = SecretKey(lv0=from_numpy(z["lv0"], device), lv1=from_numpy(z["lv1"], device))
    return sk, params


def save_cloud_key_raw(path: str, bk_raw, ksk_raw, params: TFHEParams) -> None:
    """Store the raw evaluation keys (uint32, independent of any engine)."""
    np.savez_compressed(path, header=_params_header(params),
                        bk=_words(bk_raw), ksk=_words(ksk_raw))


def load_cloud_key(path: str, device="cuda", engine="cmux_k") -> tuple[CloudKey, TFHEParams]:
    """Load the raw evaluation keys and prepare them on ``device`` for
    ``engine`` (a name or an engine instance)."""
    device = resolve_device(device)
    with np.load(path) as z:
        params = _parse_header(z["header"])
        ck = _keys.prepare_cloud_key(from_numpy(z["bk"], device), from_numpy(z["ksk"], device),
                                     params, engine)
    return ck, params


def cached_keys(prefix: str, seed_or_generator, params: TFHEParams, device="cuda",
                verbose: bool = False, engine="cmux_k") -> tuple[SecretKey, CloudKey]:
    """(SecretKey, CloudKey) with the raw key material cached on disk, the
    cloud key prepared for ``engine``.

    The first call generates keys (from an int seed or a ``torch.Generator``
    on ``device``) and writes ``{prefix}.sk.npz`` and ``{prefix}.ck.npz``;
    later calls with the same prefix and parameters load them and only
    prepare the key again.  A cache that holds other parameters, or that
    cannot be read, is regenerated, not misused.
    """
    device = resolve_device(device)
    sk_path, ck_path = f"{prefix}.sk.npz", f"{prefix}.ck.npz"
    if os.path.exists(sk_path) and os.path.exists(ck_path):
        try:
            t0 = time.time()
            sk, p_sk = load_secret_key(sk_path, device)
            ck, p_ck = load_cloud_key(ck_path, device, engine)
            if p_sk == params and p_ck == params:
                if verbose:
                    print(f"loaded cached keys from {prefix}.*.npz in "
                          f"{time.time() - t0:.1f}s")
                return sk, ck
            if verbose:
                print(f"key cache {prefix} holds different params; regenerating")
        except (OSError, ValueError, KeyError, TypeError, zipfile.BadZipFile) as exc:
            if verbose:
                print(f"key cache {prefix} unreadable ({exc}); regenerating")
    t0 = time.time()
    if isinstance(seed_or_generator, torch.Generator):
        gen = seed_or_generator
    else:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed_or_generator))
    sk = _keys.gen_secret_key(gen, params, device)
    bk_raw, ksk_raw = _keys.gen_cloud_key_raw(gen, sk, params)
    save_secret_key(sk_path, sk, params)
    save_cloud_key_raw(ck_path, bk_raw, ksk_raw, params)
    ck = _keys.prepare_cloud_key(bk_raw, ksk_raw, params, engine)
    if verbose:
        print(f"generated + cached keys at {prefix}.*.npz in {time.time() - t0:.1f}s")
    return sk, ck


def save_ciphertexts(path: str, cts, params: TFHEParams) -> None:
    np.savez_compressed(path, header=_params_header(params), cts=_words(cts))


def load_ciphertexts(path: str, device="cuda") -> tuple[torch.Tensor, TFHEParams]:
    device = resolve_device(device)
    with np.load(path) as z:
        params = _parse_header(z["header"])
        cts = from_numpy(z["cts"], device)
    return cts, params
