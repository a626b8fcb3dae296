"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu.

A second package beside ``ray_tpu`` (the JAX reference, which it never
imports). Modules mirror the reference's layout; each kernel the
reference wrote in Pallas for the TPU is a hand-written CUDA kernel
under ``csrc/``, launched for CUDA tensors, with a plain PyTorch
version beside it for CPU tensors. See README.md, "PyTorch/CUDA port".

Importing the package imports no torch: a rollout worker process
(``core/worker_proc.py``) hides the card from itself before anything
imports torch. ``resolve_device`` loads ``device.py`` on first use.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from ray_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")
