"""ldm_tf2_tpu_torch: the PyTorch/CUDA port of ldm_tf2_tpu for NVIDIA Hopper.

A package of its own beside the JAX reference: NHWC activations and
flax-mirroring parameter names, plain PyTorch for everything but the
Pallas kernels, which are hand-written CUDA kernels in ``csrc/`` built
with nvcc on first use.  Entry points run on the card unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"
