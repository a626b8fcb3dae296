"""Device resolution for the port.

Every entry point of ``ray_tpu_torch`` runs on CUDA unless its caller
passes ``device="cpu"``. With no CUDA device and no explicit ``"cpu"``
it raises: the port never carries on on the CPU by itself.

Precision on the card is set, not inherited: float32 matrix products
and float32 convolutions run in full float32. PyTorch's own default
keeps matmuls in float32 but sends float32 convolutions through cuDNN
in TF32 (about three decimal digits); the JAX reference computes its
float32 models in float32, so both TF32 switches are turned off when a
CUDA device is resolved. The default vision model computes in bfloat16
anyway; the switches matter for ``model: {"dtype": "float32"}``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

ALLOW_TF32 = False


def set_precision() -> None:
    """Apply the port's float32 policy to PyTorch's global switches."""
    torch.backends.cuda.matmul.allow_tf32 = ALLOW_TF32
    torch.backends.cudnn.allow_tf32 = ALLOW_TF32


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` → the current CUDA device (raises without one);
    ``"cpu"`` → the CPU; ``"cuda"``/``"cuda:i"`` → that card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ray_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU explicitly"
        )
    set_precision()
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
