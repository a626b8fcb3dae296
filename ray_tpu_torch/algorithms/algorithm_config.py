"""AlgorithmConfig: fluent config object → plain dict.

Counterpart of ``ray_tpu/algorithms/algorithm_config.py``, slimmed to
what the ported path reads. It takes the same config dicts and the keys
of the tuned-example yamls (``update_from_dict`` sets any key, as the
reference does). ``env_backend: "jax"`` selects the device rollout lane.
The one new key is ``device``: None runs on CUDA (and raises without
it), ``"cpu"`` runs on the CPU. ``superstep`` (``"auto"``: 8 updates
per host call on CUDA, 1 on the CPU; an int forces K), ``nan_guard``
and ``jax_fused_rollout`` keep the reference's names and defaults (see
``sharding/superstep.py``).

The replay keys of the off-policy family keep the reference's names and
defaults: ``replay_buffer_config``, ``replay_device_resident`` and
``replay_device_tree`` (``"auto"``: on; ``False`` raises, see
``execution/replay_buffer.resolve_device_resident``),
``replay_memory_cap_bytes``, ``num_steps_sampled_before_learning_starts``,
``target_network_update_freq`` and ``training_intensity``.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional


class AlgorithmConfig:
    def __init__(self, algo_class: Optional[type] = None):
        self.algo_class = algo_class

        # environment
        self.env = None
        self.env_config: Dict = {}
        self.env_backend = "actor"

        # rollouts
        self.num_workers = 0
        self.num_envs_per_worker = 1
        self.rollout_fragment_length = 200

        # training
        self.gamma = 0.99
        self.lr = 0.001
        self.lr_schedule = None
        self.train_batch_size = 4000
        self.model: Dict = {}
        self.grad_clip = None
        self.seed = None
        self.exploration_config: Dict = {}

        # off-policy replay
        self.replay_buffer_config: Dict = {}
        self.replay_device_resident = "auto"
        self.replay_device_tree = "auto"
        self.replay_memory_cap_bytes = None
        self.num_steps_sampled_before_learning_starts = 0
        self.target_network_update_freq = 0
        self.training_intensity = None

        # learner plane: K updates per host call, the in-slot non-finite
        # batch guard, and rollout + learn fused into one superstep slot
        self.superstep = "auto"
        self.nan_guard = False
        self.jax_fused_rollout = True

        # resources
        self.device = None

        # reporting
        self.metrics_num_episodes_for_smoothing = 100

    def environment(
        self,
        env=None,
        *,
        env_config: Optional[Dict] = None,
        env_backend: Optional[str] = None,
        **kwargs,
    ) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_config = env_config
        if env_backend is not None:
            self.env_backend = env_backend
        return self

    def rollouts(
        self,
        *,
        num_rollout_workers: Optional[int] = None,
        num_envs_per_worker: Optional[int] = None,
        rollout_fragment_length: Optional[int] = None,
        **kwargs,
    ) -> "AlgorithmConfig":
        if num_rollout_workers is not None:
            self.num_workers = num_rollout_workers
        if num_envs_per_worker is not None:
            self.num_envs_per_worker = num_envs_per_worker
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(
        self,
        *,
        gamma: Optional[float] = None,
        lr: Optional[float] = None,
        lr_schedule=None,
        train_batch_size: Optional[int] = None,
        model: Optional[Dict] = None,
        grad_clip: Optional[float] = None,
        replay_buffer_config: Optional[Dict] = None,
        replay_device_resident=None,
        replay_device_tree=None,
        replay_memory_cap_bytes: Optional[int] = None,
        num_steps_sampled_before_learning_starts: Optional[int] = None,
        target_network_update_freq: Optional[int] = None,
        training_intensity: Optional[float] = None,
        **kwargs,
    ) -> "AlgorithmConfig":
        """Training keys; ``replay_buffer_config`` updates the current
        dict key by key, as the reference's DQNConfig does."""
        if replay_buffer_config is not None:
            self.replay_buffer_config = {**self.replay_buffer_config, **replay_buffer_config}
        for name, value in (
            ("gamma", gamma),
            ("lr", lr),
            ("lr_schedule", lr_schedule),
            ("train_batch_size", train_batch_size),
            ("model", model),
            ("grad_clip", grad_clip),
            ("replay_device_resident", replay_device_resident),
            ("replay_device_tree", replay_device_tree),
            ("replay_memory_cap_bytes", replay_memory_cap_bytes),
            ("num_steps_sampled_before_learning_starts",
             num_steps_sampled_before_learning_starts),
            ("target_network_update_freq", target_network_update_freq),
            ("training_intensity", training_intensity),
        ):
            if value is not None:
                setattr(self, name, value)
        return self

    def resources(self, *, device=None, **kwargs) -> "AlgorithmConfig":
        if device is not None:
            self.device = device
        return self

    def debugging(self, *, seed: Optional[int] = None, **kwargs) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    def to_dict(self) -> Dict[str, Any]:
        return {
            k: copy.deepcopy(v)
            for k, v in vars(self).items()
            if k != "algo_class"
        }

    def update_from_dict(self, d: Dict) -> "AlgorithmConfig":
        for k, v in d.items():
            if k == "num_rollout_workers":
                self.num_workers = v
            elif k == "lambda":
                self.lambda_ = v
            else:
                setattr(self, k, v)
        return self

    def build(self, env=None):
        if env is not None:
            self.env = env
        if self.algo_class is None:
            raise ValueError("No algo_class bound to this config")
        return self.algo_class(config=self.to_dict())
