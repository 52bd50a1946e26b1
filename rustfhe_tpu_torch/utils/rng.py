"""Random sampling of torus values from an explicit ``torch.Generator``.

Counterpart of ``rustfhe_tpu/utils/rng.py``.  The caller passes the
generator, which must live on ``device``.  The bits differ from the JAX
package's threefry stream, so tests hold randomised paths to decryption,
not to the JAX words.  Gaussian noise keeps the JAX encoding path: a
float32 normal sample scaled by ``std``, then ``torus.from_double``.
"""

from __future__ import annotations

import torch

from .. import torus


def uniform_torus(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform Torus32: 32 random bits per word."""
    return torch.randint(-(1 << 31), 1 << 31, tuple(shape), dtype=torch.int32,
                         generator=gen, device=device)


def gaussian_torus(gen: torch.Generator, shape, std: float, device) -> torch.Tensor:
    """Gaussian noise on the torus, mean 0, standard deviation ``std``."""
    r = torch.randn(tuple(shape), dtype=torch.float32, generator=gen, device=device)
    return torus.from_double(r * torch.tensor(std, dtype=torch.float32))


def binary_array(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform bits in {0,1} as int32."""
    return torch.randint(0, 2, tuple(shape), dtype=torch.int32, generator=gen,
                         device=device)
