"""TLWE (scalar LWE over the torus), batched.

Counterpart of ``rustfhe_tpu/tlwe.py``: a batch of TLWE ciphertexts is one
int32 tensor ``(..., n+1)`` with the body ``b`` at index 0 and the mask
``a`` at 1..n.  Encoding: One -> +1/8, Zero -> -1/8.
"""

from __future__ import annotations

import torch

from . import torus
from ._u32 import from_numpy, s32, wrap
from .params import TFHEParams
from .utils import threefry
from .utils.rng import gaussian_torus, uniform_torus


def trivial(b: torch.Tensor, n: int) -> torch.Tensor:
    """Noiseless ciphertexts (b, 0, ..., 0)."""
    out = torch.zeros(b.shape + (n + 1,), dtype=torch.int32, device=b.device)
    out[..., 0] = b
    return out


def logic_true(n: int, device) -> torch.Tensor:
    """The noiseless ciphertext of One (+1/8), (n+1,) on ``device``."""
    return trivial(torch.tensor(torus.TORUS_ONE_EIGHTH, dtype=torch.int32, device=device), n)


def logic_false(n: int, device) -> torch.Tensor:
    """The noiseless ciphertext of Zero (-1/8), (n+1,) on ``device``."""
    return trivial(torch.tensor(torus.TORUS_MINUS_ONE_EIGHTH, dtype=torch.int32,
                                device=device), n)


def body(ct: torch.Tensor) -> torch.Tensor:
    return ct[..., 0]


def mask(ct: torch.Tensor) -> torch.Tensor:
    return ct[..., 1:]


def add_to_body(ct: torch.Tensor, word: int) -> torch.Tensor:
    """A new tensor: ``ct`` with the uint32 ``word`` added to every body
    (the JAX package's ``ct.at[..., 0].add(word)``; ``ct`` is not written)."""
    return torch.cat([ct[..., :1] + s32(word), ct[..., 1:]], dim=-1)


def neg(ct: torch.Tensor) -> torch.Tensor:
    return -ct


def mul_int(ct: torch.Tensor, k: int) -> torch.Tensor:
    """Scalar multiple k * ct, wrapping mod 2^32; any Python int k."""
    return ct * s32(k)


def _dot_key(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """<a, s> mod 2^32 for masks ``a (..., n)`` and the binary key ``s (n,)``
    (int64 sum of at most n words: exact)."""
    return wrap((a.to(torch.int64) * s.to(torch.int64)).sum(dim=-1))


def encrypt_torus(gen: torch.Generator, s: torch.Tensor, m: torch.Tensor,
                  params: TFHEParams) -> torch.Tensor:
    """Encrypt torus message(s) ``m`` (int32, any shape) under the binary
    key ``s (n,)``: b = <a, s> + e + m."""
    n = s.shape[-1]
    a = uniform_torus(gen, m.shape + (n,), s.device)
    e = gaussian_torus(gen, m.shape, params.alpha_lv0, s.device)
    b = _dot_key(a, s) + e + m
    return torch.cat([b[..., None], a], dim=-1)


def phase(ct: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """b - <a, s>."""
    return ct[..., 0] - _dot_key(ct[..., 1:], s)


def encrypt_binary(gen: torch.Generator, s: torch.Tensor, bits: torch.Tensor,
                   params: TFHEParams) -> torch.Tensor:
    return encrypt_torus(gen, s, torus.binary_to_torus(bits), params)


def decrypt_binary(ct: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torus.torus_to_binary(phase(ct, s))


def encrypt_torus_seeded(gen: torch.Generator, s: torch.Tensor, m: torch.Tensor,
                         params: TFHEParams, key=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Seeded (compressed) encryption: ``(seed (2,) int32 words, bodies)``.

    The mask is ``threefry.random_bits(seed, m.shape + (n,))``, the words
    the JAX package's ``encrypt_torus_seeded`` draws, so a ciphertext
    travels as (seed, b), (n+1)x smaller, and any party re-derives the mask
    with ``expand_seeded``, in either package.  The threefry key comes from
    ``gen`` (two words), or is given as ``key`` ((2,) words) so that the
    (seed, mask) pair of a key can be held to JAX's.  Only the MASK subkey
    ``split(key)[0]`` is published: the mask is public in a normal
    ciphertext anyway.  Publishing the key would publish its noise subkey;
    in the JAX package that recomputes every Gaussian sample e_i, and since
    m_i = +-2^29 is even, (b_i - e_i) mod 2 = <a_i mod 2, s> gives the
    binary secret key by GF(2) elimination from ~n seeded bits.  Here the
    noise comes from ``gen`` as in ``encrypt_torus``, so bodies decrypt
    right but are not JAX's words."""
    n = s.shape[-1]
    if key is None:
        key = uniform_torus(gen, (2,), s.device)
    seed = threefry.split(threefry.key_words(key, s.device))[0]
    a = threefry.random_bits(seed, m.shape + (n,))
    e = gaussian_torus(gen, m.shape, params.alpha_lv0, s.device)
    return seed, _dot_key(a, s) + e + m


def encrypt_binary_seeded(gen: torch.Generator, s: torch.Tensor, bits: torch.Tensor,
                          params: TFHEParams, key=None) -> tuple[torch.Tensor, torch.Tensor]:
    return encrypt_torus_seeded(gen, s, torus.binary_to_torus(bits), params, key)


def expand_seeded(seed, b, n: int, device=None) -> torch.Tensor:
    """(seed, bodies) -> the full TLWE batch ``(..., n+1)`` on ``device``
    (the bodies' own by default); public.  ``seed`` is the (2,) mask subkey
    that ``encrypt_torus_seeded`` published, ``b`` the int32 bodies; either
    may be numpy uint32 words (from the JAX package or a file)."""
    b = b.to(device) if isinstance(b, torch.Tensor) else from_numpy(b, device)
    a = threefry.random_bits(threefry.key_words(seed, b.device), b.shape + (n,))
    return torch.cat([b[..., None], a], dim=-1)
