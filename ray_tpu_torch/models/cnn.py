"""Convolutional vision network (the Atari "Nature CNN").

Counterpart of ``ray_tpu/models/cnn.py``. Observations arrive in the JAX
layout, (N, H, W, C) and usually uint8; they are cast to the compute
dtype *before* the division by 255 (as the reference does), then moved
to NCHW for the convolutions. Convolutions and ``post_fc`` layers run in
bfloat16 by default; the logits and value heads run in float32.

The last conv map is flattened in (H, W, C) order, as flax flattens its
NHWC maps, so ``post_fc_0``'s input features line up with the
reference's without permuting its rows.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ray_tpu_torch.models.base import Conv, Dense, TorchModel, get_activation

# (out_channels, kernel, stride) — Nature CNN for 84x84
NATURE_FILTERS = ((32, (8, 8), (4, 4)), (64, (4, 4), (2, 2)), (64, (3, 3), (1, 1)))
# for 42x42 downsampled
SMALL_FILTERS = ((16, (4, 4), (2, 2)), (32, (4, 4), (2, 2)), (256, (11, 11), (1, 1)))


def get_filter_config(shape) -> Tuple:
    """Pick a conv stack for the obs resolution."""
    if len(shape) == 3 and shape[0] == 42:
        return SMALL_FILTERS
    return NATURE_FILTERS


class VisionNet(TorchModel):
    def __init__(
        self,
        obs_shape: Sequence[int],
        num_outputs: int,
        conv_filters: Tuple = NATURE_FILTERS,
        conv_activation: str = "relu",
        post_fcnet_hiddens: Sequence[int] = (512,),
        post_fcnet_activation: str = "relu",
        vf_share_layers: bool = True,
        dtype: str = "bfloat16",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dtype = getattr(torch, dtype)
        self.act = get_activation(conv_activation)
        self.post_act = get_activation(post_fcnet_activation)
        self.vf_share_layers = vf_share_layers
        self.num_convs = len(conv_filters)
        self.num_post = len(post_fcnet_hiddens)
        h, w, c = obs_shape
        prefixes = ["conv"] if vf_share_layers else ["conv", "vf_conv"]
        for prefix in prefixes:
            hh, ww, ch = h, w, c
            for i, (out_ch, kernel, stride) in enumerate(conv_filters):
                setattr(self, f"{prefix}_{i}", Conv(
                    ch, out_ch, kernel, stride, self.dtype, generator
                ))
                hh = (hh - kernel[0]) // stride[0] + 1
                ww = (ww - kernel[1]) // stride[1] + 1
                ch = out_ch
        flat = hh * ww * ch
        sizes = [flat, *post_fcnet_hiddens]
        for i in range(self.num_post):
            setattr(self, f"post_fc_{i}", Dense(
                sizes[i], sizes[i + 1], self.dtype, generator=generator
            ))
        self.logits = Dense(
            sizes[-1], num_outputs, torch.float32, 0.01, generator
        )
        self.value = Dense(
            sizes[-1] if vf_share_layers else flat, 1, torch.float32,
            1.0, generator,
        )

    def _scaled(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs.to(self.dtype)
        if obs.dtype == torch.uint8:
            x = x / 255.0
        return x.permute(0, 3, 1, 2)

    def _convs(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        for i in range(self.num_convs):
            x = self.act(getattr(self, f"{prefix}_{i}")(x))
        # flatten in (H, W, C) order, as flax flattens NHWC
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)

    def forward(self, obs: torch.Tensor):
        x = self._convs(self._scaled(obs), "conv")
        for i in range(self.num_post):
            x = self.post_act(getattr(self, f"post_fc_{i}")(x))
        logits = self.logits(x.float())
        if self.vf_share_layers:
            value = self.value(x.float())
        else:
            y = self._convs(self._scaled(obs), "vf_conv")
            value = self.value(y.float())
        return logits, value.squeeze(-1), ()
