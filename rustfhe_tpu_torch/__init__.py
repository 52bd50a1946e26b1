"""rustfhe_tpu_torch: the TFHE gate bootstrap in PyTorch, with CUDA kernels
for NVIDIA Hopper.

The port of ``rustfhe_tpu`` (JAX/Pallas), held to it word for word.  This
package imports torch and numpy, never jax.  The blind-rotate step and the
external product are hand-written CUDA kernels (``engine/cmux_k.py``,
``csrc/cmux_k.cu``), built with nvcc on first use; on the CPU every
function runs their plain torch versions.
"""

from .context import TFHE
from .params import DEFAULT_PARAMS, TEST_PARAMS, TFHEParams

__all__ = ["TFHE", "TFHEParams", "DEFAULT_PARAMS", "TEST_PARAMS"]
