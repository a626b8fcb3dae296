"""Model catalog: space + config → model and action distribution.

Counterpart of ``ray_tpu/models/catalog.py`` for the models this slice
ports: ``use_transformer`` gets :class:`TransformerPolicyNet` (checked
first, as in the reference), image observations (H, W, C)
:class:`VisionNet`, flat ones :class:`FCNet`, and Discrete action spaces
:class:`Categorical`. The ``dtype`` key picks the compute dtype (None:
bfloat16 for the vision net, float32 for the MLP and the transformer),
as in the reference. Spaces are duck-typed (``shape``; ``n`` for a
discrete space).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.models import distributions as dists
from ray_tpu_torch.models.base import TorchModel
from ray_tpu_torch.models.cnn import VisionNet, get_filter_config
from ray_tpu_torch.models.fcnet import FCNet
from ray_tpu_torch.models.transformer import TransformerPolicyNet

MODEL_DEFAULTS: Dict[str, Any] = {
    "fcnet_hiddens": [256, 256],
    "fcnet_activation": "tanh",
    "conv_filters": None,
    "conv_activation": "relu",
    "post_fcnet_hiddens": [],
    "post_fcnet_activation": "relu",
    "vf_share_layers": False,
    "dtype": None,  # None → per-model default (bf16 convs, f32 mlps)
    # decoder-style transformer torso (models/transformer.py)
    "use_transformer": False,
    "transformer_num_layers": 2,
    "transformer_dim": 64,
    "transformer_num_heads": 4,
    "transformer_head_dim": None,  # None → dim // num_heads
    "transformer_ff_dim": None,  # None → 4 * dim
    "transformer_seq_len": 8,
    "partition_rules": None,
}

_UNPORTED = ("use_lstm", "use_attention", "custom_model")


def _pair(v) -> Tuple[int, int]:
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


class ModelCatalog:
    @staticmethod
    def get_action_dist(action_space, config: Optional[Dict] = None) -> Tuple[type, int]:
        """→ (dist_class, required model output size)."""
        if getattr(action_space, "n", None) is not None and tuple(
            getattr(action_space, "shape", ())
        ) == ():
            return dists.Categorical, int(action_space.n)
        raise NotImplementedError(
            f"action space {action_space} is not ported yet "
            "(this slice ports Discrete)"
        )

    @staticmethod
    def get_model(
        obs_space,
        action_space,
        num_outputs: int,
        model_config: Optional[Dict] = None,
        generator: Optional[torch.Generator] = None,
    ) -> TorchModel:
        """→ an ``nn.Module`` on the CPU, initialised from ``generator``."""
        cfg = {**MODEL_DEFAULTS, **(model_config or {})}
        for key in _UNPORTED:
            if cfg.get(key):
                raise NotImplementedError(
                    f"model option {key!r} is not ported yet"
                )
        if cfg.get("partition_rules"):
            raise NotImplementedError(
                "partition_rules (tensor-parallel placement) waits for the "
                "distributed layer, ROADMAP queue 1, item 7"
            )
        obs_shape = tuple(obs_space.shape)
        if cfg["use_transformer"]:
            return TransformerPolicyNet(
                int(np.prod(obs_shape)),
                num_outputs,
                d_model=cfg["transformer_dim"],
                num_layers=cfg["transformer_num_layers"],
                num_heads=cfg["transformer_num_heads"],
                head_dim=cfg["transformer_head_dim"],
                ff_dim=cfg["transformer_ff_dim"],
                seq_len=cfg["transformer_seq_len"],
                dtype=cfg["dtype"] or "float32",
                generator=generator,
            )
        if len(obs_shape) == 3:
            filters = cfg["conv_filters"] or get_filter_config(obs_shape)
            return VisionNet(
                obs_shape,
                num_outputs,
                conv_filters=tuple(
                    (int(c), _pair(k), _pair(s)) for c, k, s in filters
                ),
                conv_activation=cfg["conv_activation"],
                post_fcnet_hiddens=tuple(cfg["post_fcnet_hiddens"] or [512]),
                post_fcnet_activation=cfg["post_fcnet_activation"],
                vf_share_layers=True,
                dtype=cfg["dtype"] or "bfloat16",
                generator=generator,
            )
        return FCNet(
            int(np.prod(obs_shape)),
            num_outputs,
            hiddens=tuple(cfg["fcnet_hiddens"]),
            activation=cfg["fcnet_activation"],
            vf_share_layers=cfg["vf_share_layers"],
            dtype=cfg["dtype"] or "float32",
            generator=generator,
        )
