"""Dueling Q-network for the DQN family.

Counterpart of ``ray_tpu/algorithms/dqn/dqn_model.py`` (``DQNModel``):
a trunk (the Nature CNN for image observations, an MLP otherwise), then
hidden float32 layers and the Q heads. Image trunks compute in bfloat16
(the reference's ``conv_dtype``) after casting uint8 pixels and dividing
by 255, and flatten their last map in (H, W, C) order as flax does; the
hidden layers and heads run in float32, as the reference's ``nn.Dense``
on a float32 input. With ``dueling`` the Q values are
``V + A - mean_a(A)``.

``forward(obs)`` returns ``(q_values, max_a q, ())``, the model contract
of the port, so the action path (Categorical over Q, EpsilonGreedy)
works unchanged. Layer names map onto the flax module's
(``_convs_i`` → ``conv_i``, ``_fcs_i`` → ``fc_i``, ``_adv_head``,
``_value_head``; see ``utils/jax_params.py``).

Not ported yet (ROADMAP queue 1): the C51 support heads
(``num_atoms > 1``) and NoisyNet layers (``noisy=True``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.models.base import Conv, Dense, TorchModel, get_activation
from ray_tpu_torch.models.cnn import get_filter_config


class DQNModel(TorchModel):
    def __init__(
        self,
        obs_shape: Sequence[int],
        num_outputs: int,
        hiddens: Sequence[int] = (256, 256),
        activation: str = "tanh",
        use_conv: bool = False,
        conv_filters: Optional[Tuple] = None,
        conv_activation: str = "relu",
        conv_dtype: str = "bfloat16",
        num_atoms: int = 1,
        dueling: bool = True,
        noisy: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if num_atoms > 1:
            raise NotImplementedError(
                "distributional Q (num_atoms > 1) is not ported yet "
                "(ROADMAP queue 1, off-policy left-overs)"
            )
        if noisy:
            raise NotImplementedError(
                "NoisyNet heads (noisy=True) are not ported yet "
                "(ROADMAP queue 1, off-policy left-overs)"
            )
        self.num_outputs = int(num_outputs)
        self.use_conv = use_conv
        self.dueling = dueling
        self.conv_dtype = getattr(torch, conv_dtype)
        self.act = get_activation(activation)
        self.conv_act = get_activation(conv_activation)
        if use_conv:
            filters = conv_filters or get_filter_config((84, 84, 4))
            h, w, c = obs_shape
            self.num_convs = len(filters)
            for i, (out_ch, kernel, stride) in enumerate(filters):
                setattr(self, f"conv_{i}", Conv(
                    c, out_ch, kernel, stride, self.conv_dtype, generator
                ))
                h = (h - kernel[0]) // stride[0] + 1
                w = (w - kernel[1]) // stride[1] + 1
                c = out_ch
            flat = h * w * c
        else:
            self.num_convs = 0
            flat = int(np.prod(obs_shape))
        sizes = [flat, *hiddens]
        self.num_fcs = len(hiddens)
        for i in range(self.num_fcs):
            setattr(self, f"fc_{i}", Dense(
                sizes[i], sizes[i + 1], torch.float32, generator=generator
            ))
        self.adv_head = Dense(sizes[-1], self.num_outputs, torch.float32, generator=generator)
        if dueling:
            self.value_head = Dense(sizes[-1], 1, torch.float32, generator=generator)

    def features(self, obs: torch.Tensor) -> torch.Tensor:
        if self.use_conv:
            x = obs.to(self.conv_dtype)
            if obs.dtype == torch.uint8:
                x = x / 255.0
            x = x.permute(0, 3, 1, 2)
            for i in range(self.num_convs):
                x = self.conv_act(getattr(self, f"conv_{i}")(x))
            # flatten in (H, W, C) order, as flax flattens NHWC
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).float()
        else:
            x = obs.float().reshape(obs.shape[0], -1)
        for i in range(self.num_fcs):
            x = self.act(getattr(self, f"fc_{i}")(x))
        return x

    def q_values(self, obs: torch.Tensor) -> torch.Tensor:
        """(B, num_actions) Q values."""
        feat = self.features(obs)
        adv = self.adv_head(feat)
        if not self.dueling:
            return adv
        return self.value_head(feat) + adv - adv.mean(dim=1, keepdim=True)

    def forward(self, obs: torch.Tensor):
        q = self.q_values(obs)
        return q, q.max(dim=-1).values, ()
