"""AlgorithmConfig: fluent config object → plain dict.

Counterpart of ``ray_tpu/algorithms/algorithm_config.py``, slimmed to
what the ported path reads. It takes the same config dicts and the keys
of the tuned-example yamls (``update_from_dict`` sets any key, as the
reference does). ``env_backend: "jax"`` selects the device rollout lane;
any other value (the default, ``"actor"``) the actor lane, whose keys
keep the reference's names and defaults and are read where they are
used (``observation_filter``, ``batch_mode``, ``num_cpus_per_worker``,
``horizon``, ``normalize_actions``, ``clip_actions``, ...;
``sample_async`` raises for now). ``callbacks_class`` and a non-null
``evaluation_interval`` raise in ``Algorithm`` (ROADMAP item 3c). ``sample_prefetch`` (0: off)
samples the next train batch and copies it to the card while the
learner works on this one (PPO with remote workers);
``max_requests_in_flight_per_rollout_worker`` caps its requests a
worker. ``min_time_s_per_iteration`` and
``min_sample_timesteps_per_iteration`` bound an iteration from below
(``Algorithm.train``). ``ignore_worker_failures`` and
``recreate_failed_workers`` say what a dead worker does to the
asynchronous paths (recreating raises: the elastic worker set is not
ported).
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
        # the actor lane's action squashing and episode horizon
        self.clip_actions = False
        self.normalize_actions = True
        self.horizon = None

        # rollouts
        self.num_workers = 0
        self.num_envs_per_worker = 1
        self.rollout_fragment_length = 200
        self.sample_prefetch = 0
        self.max_requests_in_flight_per_rollout_worker = 2
        self.ignore_worker_failures = False
        self.recreate_failed_workers = False

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
        self.min_time_s_per_iteration = None
        self.min_sample_timesteps_per_iteration = 0

        # not ported (``Algorithm`` raises when set): ROADMAP item 3c
        self.callbacks_class = None
        self.evaluation_interval = None

    def environment(
        self,
        env=None,
        *,
        env_config: Optional[Dict] = None,
        env_backend: Optional[str] = None,
        clip_actions: Optional[bool] = None,
        normalize_actions: Optional[bool] = None,
        horizon: Optional[int] = None,
        **kwargs,
    ) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        for name, value in (
            ("env_config", env_config),
            ("env_backend", env_backend),
            ("clip_actions", clip_actions),
            ("normalize_actions", normalize_actions),
            ("horizon", horizon),
        ):
            if value is not None:
                setattr(self, name, value)
        return self

    def rollouts(
        self,
        *,
        num_rollout_workers: Optional[int] = None,
        num_envs_per_worker: Optional[int] = None,
        rollout_fragment_length: Optional[int] = None,
        sample_prefetch: Optional[int] = None,
        max_requests_in_flight_per_rollout_worker: Optional[int] = None,
        ignore_worker_failures: Optional[bool] = None,
        recreate_failed_workers: Optional[bool] = None,
        **kwargs,
    ) -> "AlgorithmConfig":
        if num_rollout_workers is not None:
            self.num_workers = num_rollout_workers
        for name, value in (
            ("num_envs_per_worker", num_envs_per_worker),
            ("rollout_fragment_length", rollout_fragment_length),
            ("sample_prefetch", sample_prefetch),
            ("max_requests_in_flight_per_rollout_worker", max_requests_in_flight_per_rollout_worker),
            ("ignore_worker_failures", ignore_worker_failures),
            ("recreate_failed_workers", recreate_failed_workers),
        ):
            if value is not None:
                setattr(self, name, value)
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

    def reporting(
        self,
        *,
        min_time_s_per_iteration: Optional[float] = None,
        min_sample_timesteps_per_iteration: Optional[int] = None,
        metrics_num_episodes_for_smoothing: Optional[int] = None,
        **kwargs,
    ) -> "AlgorithmConfig":
        for name, value in (
            ("min_time_s_per_iteration", min_time_s_per_iteration),
            ("min_sample_timesteps_per_iteration", min_sample_timesteps_per_iteration),
            ("metrics_num_episodes_for_smoothing", metrics_num_episodes_for_smoothing),
        ):
            if value is not None:
                setattr(self, name, value)
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
