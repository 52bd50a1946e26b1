"""rustfhe_tpu_torch: the TFHE gate bootstrap in PyTorch, with CUDA kernels
for NVIDIA Hopper.

The port of ``rustfhe_tpu`` (JAX/Pallas), held to it word for word.  This
package imports torch and numpy, never jax.  The blind-rotate step, the
external product and the single-launch blind rotation of the latency mode
are hand-written CUDA kernels (``engine/cmux_k.py``,
``engine/rotate_all_k.py``, ``csrc/``), and so are their limb-form
counterparts that Bg = 2^8 selects (``engine/limb_step.py``; K1 and its
limb-form steps run on the int8 tensor cores), built with
nvcc on first use; on the CPU every function runs their plain torch
versions.  ``apps/`` holds
the ``nander`` console, its fused evaluator and the level-fused circuit
evaluator with its standard cells, on which the typed encrypted integers
``FheUint`` / ``FheInt`` (``ints.py``) run; programmable bootstrapping
(``pbs.py``, gated by the noise model of ``utils/noise.py``) carries the
radix integers ``RadixUint`` / ``RadixInt`` (``radix.py``) at
``PBS_PARAMS``; ``parallel/`` is the scale-out path over
``torch.distributed`` (sharded gates, bootstrap and PBS, ``GateSession``);
public-key encryption (``tlwe.gen_public_key``, ``TFHE.make_public_key``)
takes the dual-Regev form; ``bench.py`` is the batched HomNAND benchmark,
``examples/`` holds the JAX package's example scripts (``python3 -m
rustfhe_tpu_torch.examples.<name>``) and ``utils/timing.py`` the timers
that synchronise the card.
"""

from .params import (TFHEParams, DEFAULT_PARAMS, TEST_PARAMS, N2048_PARAMS, PBS_PARAMS,
                     PBS_TEST_PARAMS)
from .keys import SecretKey, CloudKey, gen_keys, gen_secret_key, gen_cloud_key
from .engine import get_engine, register_engine
from . import torus, tlwe, trlwe, trgsw, decomp, poly, bootstrap, gates, pbs
from . import radix
from .context import TFHE
from .ints import FheUint, FheInt
from .radix import RadixUint, RadixInt

__all__ = ["TFHEParams", "DEFAULT_PARAMS", "TEST_PARAMS", "N2048_PARAMS", "PBS_PARAMS",
           "PBS_TEST_PARAMS", "SecretKey", "CloudKey", "gen_keys", "gen_secret_key",
           "gen_cloud_key", "get_engine", "register_engine", "TFHE", "FheUint", "FheInt",
           "RadixUint", "RadixInt", "radix", "torus", "tlwe", "trlwe", "trgsw", "decomp",
           "poly", "bootstrap", "gates", "pbs"]
