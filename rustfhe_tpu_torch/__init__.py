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
``bench.py`` is the batched HomNAND benchmark and
``examples/radix_bench.py`` the PBS and radix one.
"""

from .context import TFHE
from .ints import FheInt, FheUint
from .params import DEFAULT_PARAMS, PBS_PARAMS, PBS_TEST_PARAMS, TEST_PARAMS, TFHEParams
from .radix import RadixInt, RadixUint

__all__ = ["TFHE", "TFHEParams", "DEFAULT_PARAMS", "TEST_PARAMS", "PBS_PARAMS",
           "PBS_TEST_PARAMS", "FheUint", "FheInt", "RadixUint", "RadixInt"]
