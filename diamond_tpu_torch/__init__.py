"""diamond_tpu_torch: the PyTorch + CUDA port of diamond_tpu for NVIDIA Hopper (H100).

The JAX package ``diamond_tpu`` stays the reference; this package follows its layout and
names module for module, keeps its NHWC layout and parameter shapes (so its state-dict
keys are the flax variable paths joined with "."), and runs every kernel the JAX package
wrote in Pallas as a hand-written Hopper kernel (``kernels/csrc``). It imports no jax.
"""

__version__ = "0.1.0"
