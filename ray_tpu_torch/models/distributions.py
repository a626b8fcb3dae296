"""Action distributions over model outputs.

Counterpart of ``ray_tpu/models/distributions.py``: :class:`Categorical`
(Discrete spaces), :class:`DiagGaussian` (Box spaces; the PPO family)
and :class:`SquashedGaussian` (SAC: a tanh-squashed normal mapped onto
``[low, high]``), with the reference's ``SMALL_NUMBER`` and log-std clip.
Sampling draws from an explicit ``torch.Generator`` on the inputs'
device (Gumbel-max for the categorical, the method of
``jax.random.categorical``); the two frameworks' random streams differ,
so tests inject draws instead of comparing seeds: ``sampled_action_logp``
also takes its draw itself (the categorical's uniforms, the Gaussians'
standard normals), which :meth:`ActionDistribution.draw` takes from a
generator ahead of the sample (the serving plane's graphs read their
draws from static buffers).
Not ported (``ROADMAP.md`` queue 1 item 4b): ``Deterministic``, whose
only users are DDPG and TD3.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

SMALL_NUMBER = 1e-6
MIN_LOG_NN_OUTPUT = -20.0
MAX_LOG_NN_OUTPUT = 2.0
# the reference's float32 constants: 0.5 * log(2 pi) and 0.5 * log(2 pi e)
_HALF_LOG_2PI = float(np.float32(0.5) * np.log(np.float32(2.0 * math.pi)))
_HALF_LOG_2PIE = float(np.float32(0.5) * np.log(np.float32(2.0 * math.pi * math.e)))


class ActionDistribution:
    def __init__(self, inputs: torch.Tensor):
        self.inputs = inputs

    @classmethod
    def draw(cls, shape, dtype, device, generator: Optional[torch.Generator]) -> torch.Tensor:
        """The random tensor one sample over inputs of ``shape`` and
        ``dtype`` takes from ``generator``."""
        raise NotImplementedError

    def sampled_action_logp(self, generator: Optional[torch.Generator], draw=None):
        a = self.sample(generator, draw)
        return a, self.logp(a)


class Categorical(ActionDistribution):
    """Discrete actions from logits."""

    @classmethod
    def draw(cls, shape, dtype, device, generator):
        return torch.rand(shape, generator=generator, device=device, dtype=dtype).clamp_(
            min=torch.finfo(dtype).tiny
        )

    def sample(self, generator: Optional[torch.Generator], uniform=None) -> torch.Tensor:
        """Gumbel-max over the logits; ``uniform``: the draw, or taken
        from ``generator``."""
        u = uniform
        if u is None:
            u = self.draw(self.inputs.shape, self.inputs.dtype, self.inputs.device, generator)
        return torch.argmax(self.inputs - torch.log(-torch.log(u)), dim=-1)

    def deterministic_sample(self) -> torch.Tensor:
        return torch.argmax(self.inputs, dim=-1)

    def logp(self, x: torch.Tensor) -> torch.Tensor:
        logits = F.log_softmax(self.inputs, dim=-1)
        return torch.gather(logits, -1, x.long()[..., None]).squeeze(-1)

    def entropy(self) -> torch.Tensor:
        logp = F.log_softmax(self.inputs, dim=-1)
        return -torch.sum(torch.exp(logp) * logp, dim=-1)

    def kl(self, other: "Categorical") -> torch.Tensor:
        logp = F.log_softmax(self.inputs, dim=-1)
        other_logp = F.log_softmax(other.inputs, dim=-1)
        return torch.sum(torch.exp(logp) * (logp - other_logp), dim=-1)

    @staticmethod
    def required_model_output_shape(action_space) -> int:
        return int(action_space.n)


def _normal(like: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.randn(like.shape, generator=generator, device=like.device, dtype=like.dtype)


def _normal_draw(shape, dtype, device, generator) -> torch.Tensor:
    """A Gaussian's draw over inputs of ``shape`` (mean and log-std
    concatenated): standard normals of the mean's shape."""
    shape = tuple(shape)
    return torch.randn(shape[:-1] + (shape[-1] // 2,), generator=generator, device=device,
                       dtype=dtype)


def _gaussian_logp(raw, mean, std, log_std) -> torch.Tensor:
    return (
        -0.5 * torch.sum(torch.square((raw - mean) / (std + SMALL_NUMBER)), -1)
        - _HALF_LOG_2PI * raw.shape[-1]
        - torch.sum(log_std, -1)
    )


class DiagGaussian(ActionDistribution):
    """Independent normal per dimension; inputs = concat(mean, log_std)."""

    def __init__(self, inputs: torch.Tensor):
        super().__init__(inputs)
        self.mean, self.log_std = torch.chunk(inputs, 2, dim=-1)
        self.std = torch.exp(self.log_std)

    @classmethod
    def draw(cls, shape, dtype, device, generator):
        return _normal_draw(shape, dtype, device, generator)

    def sample(self, generator: Optional[torch.Generator], normal: Optional[torch.Tensor] = None):
        eps = _normal(self.mean, generator) if normal is None else normal
        return self.mean + self.std * eps

    def sampled_action_logp(self, generator: Optional[torch.Generator],
                            normal: Optional[torch.Tensor] = None):
        a = self.sample(generator, normal)
        return a, self.logp(a)

    def deterministic_sample(self) -> torch.Tensor:
        return self.mean

    def logp(self, x: torch.Tensor) -> torch.Tensor:
        return _gaussian_logp(x, self.mean, self.std, self.log_std)

    def entropy(self) -> torch.Tensor:
        return torch.sum(self.log_std + _HALF_LOG_2PIE, -1)

    def kl(self, other: "DiagGaussian") -> torch.Tensor:
        return torch.sum(
            other.log_std
            - self.log_std
            + (torch.square(self.std) + torch.square(self.mean - other.mean))
            / (2.0 * torch.square(other.std) + SMALL_NUMBER)
            - 0.5,
            -1,
        )

    @staticmethod
    def required_model_output_shape(action_space) -> int:
        return int(np.prod(action_space.shape)) * 2


class SquashedGaussian(ActionDistribution):
    """tanh-squashed Gaussian mapped onto ``[low, high]`` (SAC), with the
    log-std clipped to [-20, 2]. ``entropy`` is the base Gaussian's (no
    closed form after the squash), as in the reference."""

    def __init__(self, inputs: torch.Tensor, low: float = -1.0, high: float = 1.0):
        super().__init__(inputs)
        self.mean, log_std = torch.chunk(inputs, 2, dim=-1)
        self.log_std = torch.clamp(log_std, MIN_LOG_NN_OUTPUT, MAX_LOG_NN_OUTPUT)
        self.std = torch.exp(self.log_std)
        self.low = low
        self.high = high

    @classmethod
    def draw(cls, shape, dtype, device, generator):
        return _normal_draw(shape, dtype, device, generator)

    def _squash(self, raw: torch.Tensor) -> torch.Tensor:
        return (torch.tanh(raw) + 1.0) / 2.0 * (self.high - self.low) + self.low

    def _unsquash(self, a: torch.Tensor) -> torch.Tensor:
        a01 = (a - self.low) / (self.high - self.low) * 2.0 - 1.0
        a01 = torch.clamp(a01, -1.0 + SMALL_NUMBER, 1.0 - SMALL_NUMBER)
        return torch.atanh(a01)

    def _logp_raw(self, raw: torch.Tensor) -> torch.Tensor:
        base = _gaussian_logp(raw, self.mean, self.std, self.log_std)
        # log det of the tanh and affine Jacobian
        correction = torch.sum(
            torch.log(1.0 - torch.square(torch.tanh(raw)) + SMALL_NUMBER)
            + float(np.log(np.float32((self.high - self.low) / 2.0))),
            dim=-1,
        )
        return base - correction

    def sample(self, generator: Optional[torch.Generator], normal: Optional[torch.Tensor] = None):
        eps = _normal(self.mean, generator) if normal is None else normal
        return self._squash(self.mean + self.std * eps)

    def sampled_action_logp(self, generator: Optional[torch.Generator],
                            normal: Optional[torch.Tensor] = None):
        """(action, its log-probability) from one draw: ``normal`` is the
        standard-normal tensor itself, or drawn from ``generator``."""
        eps = _normal(self.mean, generator) if normal is None else normal
        raw = self.mean + self.std * eps
        return self._squash(raw), self._logp_raw(raw)

    def deterministic_sample(self) -> torch.Tensor:
        return self._squash(self.mean)

    def logp(self, x: torch.Tensor) -> torch.Tensor:
        return self._logp_raw(self._unsquash(x))

    def entropy(self) -> torch.Tensor:
        return torch.sum(self.log_std + _HALF_LOG_2PIE, -1)

    @staticmethod
    def required_model_output_shape(action_space) -> int:
        return int(np.prod(action_space.shape)) * 2
