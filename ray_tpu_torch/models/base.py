"""Model interface and the layers the port's models are built from.

Counterpart of ``ray_tpu/models/base.py``. Every model is an
``nn.Module`` whose ``forward(obs)`` returns ``(logits, value,
state_out)`` in one pass, as in the reference. Non-recurrent models
return an empty state tuple.

:class:`Dense` and :class:`Conv` mirror flax's ``nn.Dense``/``nn.Conv``
with a compute ``dtype``: parameters are stored in float32 (the
optimizer updates float32), and the forward casts input, weight and
bias to ``dtype``. Their initialisers follow flax's defaults (LeCun
normal kernels, zero biases) drawn from an explicit ``torch.Generator``.
Weights use PyTorch's layouts: ``Dense.weight`` is (out, in) and
``Conv.weight`` is (out, in, kh, kw); see ``utils/jax_params.py`` for
the mapping from flax's (in, out) and HWIO.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

_ACTIVATIONS = {
    "relu": F.relu,
    "tanh": torch.tanh,
    "elu": F.elu,
    "silu": F.silu,
    "swish": F.silu,
    "sigmoid": torch.sigmoid,
    "softplus": F.softplus,
    "leaky_relu": F.leaky_relu,
    # flax's gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


def get_activation(name: Optional[str]):
    if name in (None, "linear"):
        return lambda x: x
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}") from None


def variance_scaling_(
    w: torch.Tensor, scale: float, fan_in: int, generator: torch.Generator
) -> torch.Tensor:
    """flax ``variance_scaling(scale, "fan_in", "truncated_normal")``:
    a normal truncated at two standard deviations, rescaled so the
    variance is ``scale / fan_in``."""
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(
            w, std=std, a=-2.0 * std, b=2.0 * std, generator=generator
        )


class Dense(nn.Module):
    def __init__(
        self,
        in_features: int,
        out_features: int,
        dtype: torch.dtype = torch.float32,
        kernel_scale: float = 1.0,
        generator: Optional[torch.Generator] = None,
        use_bias: bool = True,
    ):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None
        variance_scaling_(self.weight, kernel_scale, in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        bias = None if self.bias is None else self.bias.to(d)
        return F.linear(x.to(d), self.weight.to(d), bias)


class Conv(nn.Module):
    """VALID-padded 2-D convolution over NCHW inputs."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel: Tuple[int, int],
        stride: Tuple[int, int],
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.stride = tuple(stride)
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, *kernel)
        )
        self.bias = nn.Parameter(torch.zeros(out_channels))
        variance_scaling_(
            self.weight, 1.0, in_channels * kernel[0] * kernel[1], generator
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        return F.conv2d(
            x.to(d), self.weight.to(d), self.bias.to(d), self.stride
        )


class LayerNorm(nn.Module):
    """flax's ``nn.LayerNorm`` over the last axis: ``scale`` and
    ``bias``, epsilon 1e-6 (torch's default is 1e-5), and the variance
    as ``E[x²] - E[x]²`` clipped at 0, flax's fast variance."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = torch.mean(x, dim=-1, keepdim=True)
        mu2 = torch.mean(x * x, dim=-1, keepdim=True)
        var = torch.clamp_min(mu2 - mu * mu, 0.0)
        return (x - mu) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


class TorchModel(nn.Module):
    """Base class; see the module docstring for the contract.

    A recurrent model (``is_recurrent``) takes ``obs`` as (B, T, ...)
    and a state tuple of (B, ...) tensors, with optional keyword
    arguments ``resets`` ((B, T): 1 where the carried state restarts),
    ``prev_actions`` and ``prev_rewards``; it returns outputs flattened
    over (B·T,) and the state after the last step."""

    def initial_state(self, batch_size: int = 1, device=None) -> Sequence[torch.Tensor]:
        """Initial recurrent state tensors, leading dim ``batch_size``."""
        return ()

    @property
    def is_recurrent(self) -> bool:
        return False

    @property
    def supports_stored_train_state(self) -> bool:
        """Whether the learn path's (B, T) unroll may start from the
        sampler's stored chunk-start states (the LSTM: its ``resets``
        re-zero the carry at every episode boundary, so a stored state is
        right wherever the chunk continues a trajectory). A model whose
        state ``resets`` cannot re-zero per segment (GTrXL's memory)
        trains from zero state, the reference's documented
        approximation."""
        return False
