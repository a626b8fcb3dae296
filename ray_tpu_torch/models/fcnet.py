"""Fully-connected policy/value network.

Counterpart of ``ray_tpu/models/fcnet.py``: ``hiddens``, ``activation``
and ``vf_share_layers``, with the same layer names (``fc_i``,
``logits``, ``vf_fc_i``, ``value``) and the same initialisers.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ray_tpu_torch.models.base import Dense, TorchModel, get_activation


class FCNet(TorchModel):
    def __init__(
        self,
        obs_size: int,
        num_outputs: int,
        hiddens: Sequence[int] = (256, 256),
        activation: str = "tanh",
        vf_share_layers: bool = False,
        dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dtype = getattr(torch, dtype)
        self.act = get_activation(activation)
        self.vf_share_layers = vf_share_layers
        self.num_hiddens = len(hiddens)
        sizes = [obs_size, *hiddens]
        for i in range(len(hiddens)):
            setattr(self, f"fc_{i}", Dense(
                sizes[i], sizes[i + 1], self.dtype, generator=generator
            ))
        self.logits = Dense(
            sizes[-1], num_outputs, self.dtype, 0.01, generator
        )
        if not vf_share_layers:
            for i in range(len(hiddens)):
                setattr(self, f"vf_fc_{i}", Dense(
                    sizes[i], sizes[i + 1], self.dtype, generator=generator
                ))
        self.value = Dense(sizes[-1], 1, self.dtype, 1.0, generator)

    def forward(self, obs: torch.Tensor):
        x = obs.to(self.dtype).reshape(obs.shape[0], -1)
        h = x
        for i in range(self.num_hiddens):
            h = self.act(getattr(self, f"fc_{i}")(h))
        logits = self.logits(h)
        if self.vf_share_layers:
            vf_h = h
        else:
            vf_h = x
            for i in range(self.num_hiddens):
                vf_h = self.act(getattr(self, f"vf_fc_{i}")(vf_h))
        value = self.value(vf_h)
        return logits.float(), value.squeeze(-1).float(), ()
