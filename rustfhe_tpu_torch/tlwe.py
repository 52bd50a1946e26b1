"""TLWE (scalar LWE over the torus), batched.

Counterpart of ``rustfhe_tpu/tlwe.py``: a batch of TLWE ciphertexts is one
int32 tensor ``(..., n+1)`` with the body ``b`` at index 0 and the mask
``a`` at 1..n.  Encoding: One -> +1/8, Zero -> -1/8.

Public-key encryption (``gen_public_key``, ``encrypt_torus_public``) is
the dual-Regev form: fresh noise on every coordinate of the ciphertext,
where the JAX package adds it to the body only.
"""

from __future__ import annotations

import torch

from . import torus
from ._u32 import from_numpy, s32, wrap
from .params import TFHEParams
from .utils import threefry
from .utils.rng import binary_array, gaussian_torus, uniform_torus


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


def gen_public_key(gen: torch.Generator, s: torch.Tensor, params: TFHEParams,
                   rows: int | None = None) -> torch.Tensor:
    """LWE public key: ``rows`` encryptions of zero under ``s``, int32
    (M, n+1), M = 2(n+1) by default, as in the JAX package.  Any party
    then encrypts with ``encrypt_torus_public``.  Fewer than n+1 rows make
    the subset sums enumerable (2^M masks: match mask(ct - S_j) == 0 and
    read the body), so they raise."""
    n = s.shape[-1]
    M = rows if rows is not None else 2 * (n + 1)
    if M < n + 1:
        raise ValueError(f"public key needs rows >= n+1 = {n + 1} (got {M}): fewer "
                         "rows make the ciphertext mask enumerable")
    return encrypt_torus(gen, s, torch.zeros(M, dtype=torch.int32, device=s.device), params)


def encrypt_torus_public(gen: torch.Generator, pk: torch.Tensor, m: torch.Tensor,
                         params: TFHEParams) -> torch.Tensor:
    """Encrypt torus message(s) ``m`` (int32, any shape) under the public
    key ``pk (M, n+1)``: no secret material.  An independent binary subset
    ``r`` of the pk rows per message, then the dual-Regev form

        ct = r^T pk + (m + e_0, e_1, ..., e_n),

    fresh Gaussian noise at ``alpha_lv0`` on every coordinate.  The JAX
    package (``rustfhe_tpu/tlwe.py:105-122``) adds noise to the body only,
    which leaves the mask a noiseless subset sum of the pk masks, open to
    a lattice attack.  The mask noise adds -<e_mask, s> to the phase:
    ~(n/2) alpha_lv0^2 of variance beside the subset's (M/2) alpha_lv0^2
    and the body's alpha_lv0^2; at DEFAULT_PARAMS the predicted gate
    margin goes 9.07 sigma (secret-key inputs) -> 8.96 (JAX's public
    form) -> 8.90 (this one), ``utils/noise.noise_budget`` with the
    inputs' variance in place of ``var_fresh``.

    r^T pk is a float64 GEMM of the 0/1 subset against the signed words:
    each sum is below M * 2^31 < 2^53, so it is exact, then taken mod
    2^32.  Nothing of size (..., M, n+1) is made (26 GB at B=4096)."""
    M, width = pk.shape
    r = binary_array(gen, (m.numel(), M), pk.device).to(torch.float64)
    ct = wrap(r @ pk.to(torch.float64)).reshape(m.shape + (width,))
    ct = ct + gaussian_torus(gen, m.shape + (width,), params.alpha_lv0, pk.device)
    ct[..., 0] += m
    return ct


def encrypt_binary_public(gen: torch.Generator, pk: torch.Tensor, bits: torch.Tensor,
                          params: TFHEParams) -> torch.Tensor:
    return encrypt_torus_public(gen, pk, torus.binary_to_torus(bits), params)


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
