"""rustfhe_tpu_torch: the TFHE gate bootstrap in PyTorch, with CUDA kernels
for NVIDIA Hopper.

The port of ``rustfhe_tpu`` (JAX/Pallas), held to it word for word.  This
package imports torch and numpy, never jax.  The blind-rotate step, the
external product and the single-launch blind rotation of the latency mode
are hand-written CUDA kernels (``engine/cmux_k.py``,
``engine/rotate_all_k.py``, ``csrc/``), and so are their limb-form
counterparts that Bg = 2^8 selects (``engine/limb_step.py``), built with
nvcc on first use; on the CPU every function runs their plain torch
versions.  ``apps/`` holds
the ``nander`` console and its fused evaluator.
"""

from .context import TFHE
from .params import DEFAULT_PARAMS, TEST_PARAMS, TFHEParams

__all__ = ["TFHE", "TFHEParams", "DEFAULT_PARAMS", "TEST_PARAMS"]
