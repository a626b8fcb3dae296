"""Model catalog: space + config → model and action distribution.

Counterpart of ``ray_tpu/models/catalog.py`` for the models this slice
ports: ``use_transformer`` gets :class:`TransformerPolicyNet`, then
``use_lstm`` :class:`LSTMWrapper` and ``use_attention`` :class:`GTrXLNet`
(in the reference's order, before the image branch), image observations
(H, W, C) :class:`VisionNet`, flat ones :class:`FCNet`; Discrete action
spaces :class:`Categorical`, Box ones :class:`DiagGaussian`,
MultiDiscrete ones :class:`MultiCategorical` and MultiBinary ones
:class:`Bernoulli`. The ``dtype`` key picks the compute dtype (None:
bfloat16 for the vision net, float32 for the MLP and the transformer),
as in the reference. Spaces are duck-typed (``shape``; ``n`` and shape
() for a discrete space, ``nvec`` for a multi-discrete one, ``n`` and
shape ``(n,)`` for a multi-binary one, ``low``/``high`` for a box), so
gymnasium's and the port's alike.

Custom models and action distributions, as the reference's:
:meth:`ModelCatalog.register_custom_model` /
:meth:`~ModelCatalog.register_custom_action_dist` name them, and
``custom_model`` (a registered name or a class) / ``custom_action_dist``
(a registered name or a class) pick them. A custom model is a
:class:`~ray_tpu_torch.models.base.TorchModel` subclass built as
``cls(obs_shape=..., num_outputs=..., generator=...,
**custom_model_config)``: a torch module needs its input shape and draws
its initial weights from the policy's generator, where the reference's
flax module (``cls(num_outputs=..., **custom_model_config)``) infers
the one and takes the other at ``init``. Its ``forward(obs)`` returns
``(logits, value, state_out)`` like every model of the port. A custom
action distribution is an :class:`~ray_tpu_torch.models.distributions.
ActionDistribution` subclass with ``draw``, ``sample``,
``deterministic_sample``, ``logp``, ``entropy``, ``kl`` and
``required_model_output_shape``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.models import distributions as dists
from ray_tpu_torch.models.attention import GTrXLNet
from ray_tpu_torch.models.base import TorchModel
from ray_tpu_torch.models.cnn import VisionNet, get_filter_config
from ray_tpu_torch.models.fcnet import FCNet
from ray_tpu_torch.models.preprocessors import get_preprocessor_for_space
from ray_tpu_torch.models.rnn import LSTMWrapper
from ray_tpu_torch.models.transformer import TransformerPolicyNet

MODEL_DEFAULTS: Dict[str, Any] = {
    "fcnet_hiddens": [256, 256],
    "fcnet_activation": "tanh",
    "conv_filters": None,
    "conv_activation": "relu",
    "post_fcnet_hiddens": [],
    "post_fcnet_activation": "relu",
    "vf_share_layers": False,
    # recurrent models (models/rnn.py, models/attention.py); max_seq_len
    # is the learn path's unroll length
    "use_lstm": False,
    "max_seq_len": 20,
    "lstm_cell_size": 256,
    "lstm_use_prev_action": False,
    "lstm_use_prev_reward": False,
    "use_attention": False,
    "attention_num_transformer_units": 1,
    "attention_dim": 64,
    "attention_num_heads": 2,
    "attention_head_dim": 32,
    "attention_memory_inference": 50,
    "attention_memory_training": 50,
    "attention_position_wise_mlp_dim": 32,
    "attention_init_gru_gate_bias": 2.0,
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
    "custom_model": None,
    "custom_model_config": {},
    "custom_action_dist": None,
}

_custom_models: Dict[str, type] = {}
_custom_action_dists: Dict[str, type] = {}


def _is_box(space) -> bool:
    """A Box by its attributes: bounds and a shape, no ``n``."""
    return (
        getattr(space, "n", None) is None
        and hasattr(space, "low") and hasattr(space, "high")
        and getattr(space, "shape", None) is not None
    )


def _pair(v) -> Tuple[int, int]:
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def _resolve(registry: Dict[str, type], what: str, key) -> type:
    if isinstance(key, str):
        try:
            return registry[key]
        except KeyError:
            raise ValueError(f"no {what} registered as {key!r}; registered: "
                             f"{sorted(registry)}") from None
    return key


class ModelCatalog:
    @staticmethod
    def register_custom_model(name: str, model_cls: type) -> None:
        """Name a :class:`TorchModel` subclass for ``custom_model``."""
        _custom_models[name] = model_cls

    @staticmethod
    def register_custom_action_dist(name: str, dist_cls: type) -> None:
        """Name an action distribution class for ``custom_action_dist``."""
        _custom_action_dists[name] = dist_cls

    @staticmethod
    def get_preprocessor_for_space(obs_space):
        """The observation preprocessor of ``models/preprocessors.py``."""
        return get_preprocessor_for_space(obs_space)

    @staticmethod
    def get_action_dist(action_space, config: Optional[Dict] = None) -> Tuple[type, int]:
        """→ (dist_class, required model output size): the
        ``custom_action_dist`` when one is set, else Discrete →
        :class:`Categorical`, Box → :class:`DiagGaussian` (mean and
        log-std per dimension, the reference's default for Box),
        MultiDiscrete → :class:`MultiCategorical` over its ``nvec``,
        MultiBinary → :class:`Bernoulli`."""
        config = config or {}
        if config.get("custom_action_dist"):
            cls = _resolve(_custom_action_dists, "custom action distribution",
                           config["custom_action_dist"])
            return cls, int(cls.required_model_output_shape(action_space))
        shape = tuple(getattr(action_space, "shape", None) or ())
        if getattr(action_space, "nvec", None) is not None:
            lens = tuple(int(n) for n in np.asarray(action_space.nvec).reshape(-1))
            return dists.MultiCategorical.with_lens(lens), int(sum(lens))
        if getattr(action_space, "n", None) is not None and shape == ():
            return dists.Categorical, int(action_space.n)
        if getattr(action_space, "n", None) is not None and len(shape) >= 1:
            return dists.Bernoulli, dists.Bernoulli.required_model_output_shape(action_space)
        if _is_box(action_space):
            return dists.DiagGaussian, dists.DiagGaussian.required_model_output_shape(action_space)
        raise NotImplementedError(f"Unsupported action space: {action_space}")

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
        if cfg.get("custom_model"):
            cls = _resolve(_custom_models, "custom model", cfg["custom_model"])
            if not (isinstance(cls, type) and issubclass(cls, TorchModel)):
                raise TypeError(f"custom_model {cls!r} is not a TorchModel subclass")
            return cls(obs_shape=tuple(obs_space.shape), num_outputs=num_outputs,
                       generator=generator, **(cfg.get("custom_model_config") or {}))
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
        obs_size = int(np.prod(obs_shape))
        if cfg["use_lstm"]:
            in_size = obs_size
            if cfg["lstm_use_prev_action"]:
                in_size += int(np.prod(getattr(action_space, "shape", None) or ()))
            if cfg["lstm_use_prev_reward"]:
                in_size += 1
            return LSTMWrapper(
                in_size,
                num_outputs,
                cell_size=cfg["lstm_cell_size"],
                hiddens=tuple(cfg["fcnet_hiddens"]),
                activation=cfg["fcnet_activation"],
                use_prev_action=cfg["lstm_use_prev_action"],
                use_prev_reward=cfg["lstm_use_prev_reward"],
                generator=generator,
            )
        if cfg["use_attention"]:
            return GTrXLNet(
                obs_size,
                num_outputs,
                attention_dim=cfg["attention_dim"],
                num_transformer_units=cfg["attention_num_transformer_units"],
                num_heads=cfg["attention_num_heads"],
                head_dim=cfg["attention_head_dim"],
                memory_len=cfg["attention_memory_training"],
                position_wise_mlp_dim=cfg["attention_position_wise_mlp_dim"],
                init_gru_gate_bias=cfg["attention_init_gru_gate_bias"],
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
            obs_size,
            num_outputs,
            hiddens=tuple(cfg["fcnet_hiddens"]),
            activation=cfg["fcnet_activation"],
            vf_share_layers=cfg["vf_share_layers"],
            dtype=cfg["dtype"] or "float32",
            generator=generator,
        )
