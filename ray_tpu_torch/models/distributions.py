"""Action distributions over model outputs.

Counterpart of ``ray_tpu/models/distributions.py``; this slice ports
:class:`Categorical`. Sampling draws from an explicit
``torch.Generator`` on the inputs' device (Gumbel-max, the method of
``jax.random.categorical``); the two frameworks' random streams differ,
so tests inject draws instead of comparing seeds.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


class ActionDistribution:
    def __init__(self, inputs: torch.Tensor):
        self.inputs = inputs

    def sampled_action_logp(self, generator: Optional[torch.Generator]):
        a = self.sample(generator)
        return a, self.logp(a)


class Categorical(ActionDistribution):
    """Discrete actions from logits."""

    def sample(self, generator: Optional[torch.Generator]) -> torch.Tensor:
        u = torch.rand(
            self.inputs.shape, generator=generator,
            device=self.inputs.device, dtype=self.inputs.dtype,
        ).clamp_(min=torch.finfo(self.inputs.dtype).tiny)
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
