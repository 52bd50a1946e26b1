"""TFHE parameter sets.

Counterpart of ``rustfhe_tpu/params.py``, copied rather than imported:
importing ``rustfhe_tpu.params`` runs ``rustfhe_tpu/__init__.py``, which
imports jax, and this package never imports jax.  Every preset is equal
field by field to the JAX package's (``tests/test_torch_substrate.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


def _make_decomp_mask(l: int, bits: int) -> int:
    """Rounding mask for the signed gadget decomposition.

    Same quirk as the reference's ``Torus32::make_decomp_mask``
    (``utils/src/math.rs:542-560``): when ``32 - l*bits != 0`` the bit at
    ``32 - l*bits - 1`` is added twice, so it carries up one position
    (0x2084000 at l=3, bits=6).  The external product uses this constant.
    """
    total = 32
    u = 0
    if total - l * bits != 0:
        u = (u + (1 << (total - l * bits - 1))) & 0xFFFFFFFF
        for i in range(l, 0, -1):
            u += 1 << (total - i * bits - 1)
    else:
        for i in range(l - 1, 0, -1):
            u += 1 << (total - i * bits - 1)
    return u & 0xFFFFFFFF


def iks_round_constant(bits: int, l: int) -> int:
    """Key-switch rounding constant (reference ``tlwe.rs:50-54``)."""
    rem = 32 - l * bits
    return (1 << (rem - 1)) if rem != 0 else 0


@dataclass(frozen=True)
class TFHEParams:
    """Full TFHE gate-bootstrapping parameter set.

    Defaults are the reference's ~128-bit set: n=635, N=1024,
    alpha_lv0=2^-15, alpha_lv1=2^-25, Bg=2^6, L=3, key switch basebit=2
    with 8 levels, gate constant mu=1/8.
    """

    n: int = 635
    N: int = 1024
    alpha_lv0: float = 2.0 ** -15
    alpha_lv1: float = 2.0 ** -25
    bgbit: int = 6
    l: int = 3
    iks_basebit: int = 2
    iks_l: int = 8

    @property
    def nbit(self) -> int:
        return self.N.bit_length() - 1

    @property
    def bg(self) -> int:
        return 1 << self.bgbit

    @property
    def half_bg(self) -> int:
        return 1 << (self.bgbit - 1)

    @property
    def decomp_mask(self) -> int:
        return _make_decomp_mask(self.l, self.bgbit)

    @property
    def iks_t(self) -> int:
        return 1 << self.iks_basebit

    @property
    def iks_round(self) -> int:
        return iks_round_constant(self.iks_basebit, self.iks_l)

    @property
    def mu(self) -> int:
        """Torus32 encoding of the gate constant 1/8."""
        return 1 << 29

    @property
    def two_n(self) -> int:
        return 2 * self.N

    def __post_init__(self):
        if self.N & (self.N - 1) != 0:
            raise ValueError(f"N must be a power of two, got {self.N}")
        if self.l * self.bgbit > 32:
            raise ValueError("l * bgbit must be <= 32")
        if self.iks_l * self.iks_basebit > 32:
            raise ValueError("iks_l * iks_basebit must be <= 32")

    def replace(self, **kw) -> "TFHEParams":
        return dataclasses.replace(self, **kw)


DEFAULT_PARAMS = TFHEParams()

TEST_PARAMS = TFHEParams(
    n=16,
    N=64,
    alpha_lv0=2.0 ** -20,
    alpha_lv1=2.0 ** -28,
)

N2048_PARAMS = TFHEParams(
    N=2048,
    alpha_lv1=2.0 ** -26,
)

PBS_PARAMS = TFHEParams(
    n=714,
    N=2048,
    alpha_lv0=2.0 ** -17,
    alpha_lv1=2.0 ** -32,
    bgbit=6,
    l=4,
    iks_basebit=4,
    iks_l=4,
)

PBS_TEST_PARAMS = TFHEParams(
    n=16,
    N=256,
    alpha_lv0=2.0 ** -20,
    alpha_lv1=2.0 ** -30,
    bgbit=6,
    l=4,
    iks_basebit=4,
    iks_l=4,
)

# Experimental: 2 gadget levels of base 2^8.  Unsound at n=635/N=1024
# (decomposition rounding dominates the noise); kept for small-n circuits.
FAST_PARAMS = TFHEParams(
    bgbit=8,
    l=2,
)
