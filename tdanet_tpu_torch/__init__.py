"""tdanet_tpu_torch — the PyTorch and CUDA port of tdanet_tpu for NVIDIA
Hopper.

The JAX package ``tdanet_tpu`` is the reference this package is tested
against; this package imports neither it nor JAX. Its hand-written CUDA
kernels live in ``csrc/`` and are built by ``kernels/_build.py`` at first
use.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
