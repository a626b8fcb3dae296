"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu.

A second package beside ``ray_tpu`` (the JAX reference, which it never
imports). Modules mirror the reference's layout; each kernel the
reference wrote in Pallas for the TPU is a hand-written CUDA kernel
under ``csrc/``, launched for CUDA tensors, with a plain PyTorch
version beside it for CPU tensors. See README.md, "PyTorch/CUDA port".
"""

from ray_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
