"""AlgorithmConfig: fluent config object → plain dict.

Counterpart of ``ray_tpu/algorithms/algorithm_config.py``, slimmed to
what the ported path reads. It takes the same config dicts and the keys
of the tuned-example yamls (``update_from_dict`` sets any key, as the
reference does). ``env_backend: "jax"`` selects the device rollout lane;
any other value (the default, ``"actor"``) the actor lane, whose keys
keep the reference's names and defaults and are read where they are
used (``observation_filter``, ``batch_mode``, ``num_cpus_per_worker``,
``horizon``, ``normalize_actions``, ``clip_actions``, ...).
``sample_async`` (False) gives each remote worker a sampling thread
(``AsyncSampler``), and the off-policy round takes the fragments it
asked for in the round before. ``callbacks(cls)`` sets
``callbacks_class``; ``evaluation(...)`` sets ``evaluation_interval``
(None: no evaluation workers), ``evaluation_duration`` (episodes),
``evaluation_duration_unit`` (stored and never read, as in the
reference), ``evaluation_num_workers`` and ``evaluation_config``;
``fault_tolerance(...)`` takes every knob of the reference's, with its
defaults (``resilience/``, ``autoscaler/fleet.py``): the failure budget
and the worker flags, periodic checkpoints and restore on failure
(``keep_checkpoints_num`` keeps the newest N ``checkpoint_*``
directories beside a saved one), the nan guard, the retry schedule, the
fault injector, the elastic fleet and checkpoint streaming; a knob it
does not know raises ``TypeError``. ``explore`` (True) is read by
``Algorithm.compute_single_action`` only; the sampler always explores,
as the reference's. ``sample_prefetch`` (0: off)
samples the next train batch and copies it to the card while the
learner works on this one (PPO with remote workers);
``max_requests_in_flight_per_rollout_worker`` caps its requests a
worker. ``min_time_s_per_iteration`` and
``min_sample_timesteps_per_iteration`` bound an iteration from below
(``Algorithm.train``). ``ignore_worker_failures`` and
``recreate_failed_workers`` say what a dead worker does: the
recovery manager (synchronous rounds) and the asynchronous paths drop it,
or replace it.
``multi_agent(policies, policy_mapping_fn, policies_to_train)`` keeps
the reference's keys: ``policies`` maps a policy id to a ``(cls,
obs_space, act_space, config_overrides)`` tuple (``cls`` None: the
algorithm's policy class) or to anything else (the env's spaces, no
overrides); ``policy_mapping_fn(agent_id, **kwargs)`` names an agent's
policy; ``policies_to_train`` (None: all) lists the policies that learn.
The one new key is ``device``: None runs on CUDA (and raises without
it), ``"cpu"`` runs on the CPU. ``superstep`` (``"auto"``: 8 updates
per host call on CUDA, 1 on the CPU; an int forces K), ``nan_guard``
and ``jax_fused_rollout`` keep the reference's names and defaults (see
``sharding/superstep.py``).

The replay keys of the off-policy family keep the reference's names and
defaults: ``replay_buffer_config``, ``replay_device_resident`` and
``replay_device_tree`` (``"auto"``: on; ``False``: host rings, host
trees; see ``execution/replay_buffer.resolve_device_resident``),
``replay_memory_cap_bytes`` (the spill's cap; None: 60% of the card's
memory), ``num_steps_sampled_before_learning_starts``,
``target_network_update_freq``, ``training_intensity`` and
``learn_while_rollout`` (the DQN device lane's interleaved cadence).

``offline_data(input_=, output=, output_max_file_size=,
off_policy_estimation_methods=)`` keeps the reference's keys; the dict
spells ``input_`` as ``input``, as the reference's does. On the actor
lane a callable ``input`` (``input(ioctx)`` → a reader with ``next()``:
``env/policy_server_input.PolicyServerInput``) replaces each worker's
sampler, and ``output`` (a directory) mirrors every sampled batch into
JSON shards of ``output_max_file_size`` bytes (``offline/json_writer``);
a path as ``input`` is read by the offline algorithms (MARWIL, BC, CQL,
CRR). ``environment(observation_space=, action_space=)`` gives the
policy's spaces where there is no env (an external env behind a
``PolicyServerInput``).

``telemetry(metrics_port=, trace=, device_ledger=, profile_iters=,
peak_flops=)`` fills ``telemetry_config`` (empty: off), as the
reference's: a Prometheus scrape target, span tracing with
``info/telemetry`` in every result and ``Algorithm.export_timeline``,
the device ledger under ``info/device_ledger``, a ``torch.profiler``
capture of the first N iterations, the MFU peak. A training run's fleet
view (``fleetview``), which publishes over the KV plane, raises, naming
ROADMAP.md item 7.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional


class AlgorithmConfig:
    def __init__(self, algo_class: Optional[type] = None):
        self.algo_class = algo_class

        # environment
        self.env = None
        self.env_config: Dict = {}
        self.env_backend = "actor"
        # the policy's spaces when no env gives them (external envs)
        self.observation_space = None
        self.action_space = None
        # the actor lane's action squashing and episode horizon
        self.clip_actions = False
        self.normalize_actions = True
        self.horizon = None

        # rollouts
        self.num_workers = 0
        self.num_envs_per_worker = 1
        self.rollout_fragment_length = 200
        self.sample_prefetch = 0
        self.sample_async = False
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
        self.explore = True
        self.exploration_config: Dict = {}

        # off-policy replay
        self.replay_buffer_config: Dict = {}
        self.replay_device_resident = "auto"
        self.replay_device_tree = "auto"
        self.replay_memory_cap_bytes = None
        self.num_steps_sampled_before_learning_starts = 0
        self.target_network_update_freq = 0
        self.training_intensity = None
        self.learn_while_rollout = False

        # learner plane: K updates per host call, the in-slot non-finite
        # batch guard, and rollout + learn fused into one superstep slot
        self.superstep = "auto"
        self.nan_guard = False
        self.jax_fused_rollout = True

        # multi-agent
        self.policies: Dict = {}
        self.policy_mapping_fn = None
        self.policies_to_train = None

        # resources
        self.device = None

        # reporting
        self.metrics_num_episodes_for_smoothing = 100
        self.min_time_s_per_iteration = None
        self.min_sample_timesteps_per_iteration = 0

        # callbacks, evaluation and checkpoints
        self.callbacks_class = None
        self.evaluation_interval = None
        self.evaluation_duration = 10
        self.evaluation_duration_unit = "episodes"
        self.evaluation_num_workers = 0
        self.evaluation_config: Dict = {}

        # fault tolerance: the reference's knobs and defaults
        self.max_failures = -1
        self.checkpoint_frequency = 0
        self.checkpoint_root = None
        self.keep_checkpoints_num = None
        self.restore_on_failure = False
        self.worker_health_probe_timeout_s = 10.0
        self.retry_max_attempts = 3
        self.retry_timeout_s = 60.0
        self.retry_backoff_s = 0.05
        self.retry_backoff_mult = 2.0
        self.retry_max_backoff_s = 2.0
        self.retry_jitter = 0.1
        self.fault_injection: Optional[Dict] = None
        self.elastic = False
        self.min_workers = None  # None: 1
        self.max_workers = None  # None: 2 x num_workers
        self.drain_grace_s = 15.0
        self.fleet_interval_s = 1.0
        self.fleet_idle_timeout_s = 30.0
        self.fleet_starvation_patience = 3
        self.scale_up_step = 1
        self.checkpoint_streaming = False
        self.checkpoint_stream_interval = 1

        # telemetry (telemetry/runtime.py): empty dict = off
        self.telemetry_config: Dict = {}

        # offline data: a callable or a path read instead of the sampler,
        # a directory the sampled batches are written to
        self.input_ = None
        self.output = None
        self.output_max_file_size = 64 * 1024 * 1024
        self.off_policy_estimation_methods: list = []

    def environment(
        self,
        env=None,
        *,
        env_config: Optional[Dict] = None,
        env_backend: Optional[str] = None,
        clip_actions: Optional[bool] = None,
        normalize_actions: Optional[bool] = None,
        horizon: Optional[int] = None,
        observation_space=None,
        action_space=None,
        **kwargs,
    ) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        for name, value in (
            ("observation_space", observation_space),
            ("action_space", action_space),
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
        sample_async: Optional[bool] = None,
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
            ("sample_async", sample_async),
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
        sample_async: Optional[bool] = None,
        learn_while_rollout: Optional[bool] = None,
        **kwargs,
    ) -> "AlgorithmConfig":
        """Training keys; ``replay_buffer_config`` updates the current
        dict key by key, as the reference's DQNConfig does
        (``sample_async`` here too, where ``bench_e2e.py`` sets it); any
        other keyword is set as it is, as the reference sets it
        (``superstep``, ``nan_guard``, ...)."""
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
            ("replay_memory_cap_bytes",
             None if replay_memory_cap_bytes is None else int(replay_memory_cap_bytes)),
            ("num_steps_sampled_before_learning_starts",
             num_steps_sampled_before_learning_starts),
            ("target_network_update_freq", target_network_update_freq),
            ("training_intensity", training_intensity),
            ("sample_async", sample_async),
            ("learn_while_rollout", None if learn_while_rollout is None else bool(learn_while_rollout)),
        ):
            if value is not None:
                setattr(self, name, value)
        for name, value in kwargs.items():
            setattr(self, name, value)
        return self

    def multi_agent(
        self,
        *,
        policies: Optional[Dict] = None,
        policy_mapping_fn: Optional[Callable] = None,
        policies_to_train=None,
        **kwargs,
    ) -> "AlgorithmConfig":
        if policies is not None:
            self.policies = policies
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        if policies_to_train is not None:
            self.policies_to_train = policies_to_train
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

    def exploration(self, *, explore: Optional[bool] = None,
                    exploration_config: Optional[Dict] = None) -> "AlgorithmConfig":
        """``explore`` and ``exploration_config`` (the strategy's
        ``type`` and knobs: Curiosity and RND as the reference's), as the
        reference's setter."""
        if explore is not None:
            self.explore = explore
        if exploration_config is not None:
            self.exploration_config = exploration_config
        return self

    def evaluation(
        self,
        *,
        evaluation_interval: Optional[int] = None,
        evaluation_duration: Optional[int] = None,
        evaluation_duration_unit: Optional[str] = None,
        evaluation_num_workers: Optional[int] = None,
        evaluation_config: Optional[Dict] = None,
        **kwargs,
    ) -> "AlgorithmConfig":
        for name, value in (
            ("evaluation_interval", evaluation_interval),
            ("evaluation_duration", evaluation_duration),
            ("evaluation_duration_unit", evaluation_duration_unit),
            ("evaluation_num_workers", evaluation_num_workers),
            ("evaluation_config", evaluation_config),
        ):
            if value is not None:
                setattr(self, name, value)
        return self

    def callbacks(self, callbacks_class) -> "AlgorithmConfig":
        self.callbacks_class = callbacks_class
        return self

    _FAULT_TOLERANCE_CASTS = {
        "ignore_worker_failures": bool, "recreate_failed_workers": bool, "max_failures": int,
        "checkpoint_frequency": int, "checkpoint_root": None, "keep_checkpoints_num": int,
        "restore_on_failure": bool, "nan_guard": bool, "worker_health_probe_timeout_s": float,
        "retry_max_attempts": int, "retry_timeout_s": None, "retry_backoff_s": float,
        "retry_backoff_mult": float, "retry_max_backoff_s": float, "retry_jitter": float,
        "fault_injection": None, "elastic": bool, "min_workers": int, "max_workers": int,
        "drain_grace_s": float, "fleet_interval_s": float, "fleet_idle_timeout_s": float,
        "fleet_starvation_patience": int, "scale_up_step": int, "checkpoint_streaming": bool,
        "checkpoint_stream_interval": int,
    }

    def fault_tolerance(self, **knobs) -> "AlgorithmConfig":
        """The reference's fault-tolerance knobs, each cast as the
        reference casts it (None leaves a knob as it is):
        ``recreate_failed_workers`` / ``ignore_worker_failures`` (a dead
        worker is replaced, or dropped), ``max_failures`` (the recovery
        budget; < 0: none), ``checkpoint_frequency`` + ``checkpoint_root``
        + ``keep_checkpoints_num`` + ``restore_on_failure`` (periodic
        checkpoints as the restore target of a main-process failure),
        ``nan_guard``, ``worker_health_probe_timeout_s``, ``retry_*`` (the
        ``RetryPolicy``), ``fault_injection`` (the chaos spec),
        ``elastic`` + ``min_workers`` / ``max_workers`` / ``drain_grace_s``
        / ``fleet_interval_s`` / ``fleet_idle_timeout_s`` /
        ``fleet_starvation_patience`` / ``scale_up_step`` (the
        ``FleetController``), ``checkpoint_streaming`` +
        ``checkpoint_stream_interval`` (the ``CheckpointStreamer``). A
        knob the reference does not have raises ``TypeError``."""
        unknown = sorted(k for k in knobs if k not in self._FAULT_TOLERANCE_CASTS)
        if unknown:
            raise TypeError(f"fault_tolerance() got unknown knobs {unknown}")
        for name, value in knobs.items():
            if value is not None:
                cast = self._FAULT_TOLERANCE_CASTS[name]
                setattr(self, name, cast(value) if cast is not None else value)
        return self

    def telemetry(
        self,
        *,
        metrics_port: Optional[int] = None,
        trace: Optional[bool] = None,
        device_ledger=None,
        profile_iters: Optional[int] = None,
        peak_flops: Optional[float] = None,
        peak_hbm_bytes_per_s: Optional[float] = None,
        **kwargs,
    ) -> "AlgorithmConfig":
        """Run-telemetry activation, the reference's knobs.

        ``metrics_port``: start a Prometheus ``MetricsServer`` on this
        port when the algorithm is built (0 = a free port; read it back
        from ``algo._telemetry.metrics_port``). ``trace``: span tracing
        end to end (remote submissions carry the trace context, every
        ``train()`` result gains ``info/telemetry``,
        ``Algorithm.export_timeline(path)`` writes the chrome trace).
        ``device_ledger``: the program ledger under
        ``info/device_ledger``, on whenever telemetry is; ``"light"``
        skips the FLOP and byte count, ``False`` disables.
        ``profile_iters``: a ``torch.profiler`` capture of the first N
        iterations into ``<logdir>/torch_profile`` (numerics untouched).
        ``peak_flops`` / ``peak_hbm_bytes_per_s``: the peaks MFU and
        bandwidth divide by, over the device-name table."""
        if "fleetview" in kwargs:
            raise NotImplementedError(
                "telemetry(fleetview=...): a training run's fleet view publishes "
                "through a HostExporter over the KV plane, which is not ported yet: "
                "ROADMAP.md queue 1 item 7 (telemetry/fleetview.FleetAggregator "
                "works without it)"
            )
        if kwargs:
            raise TypeError(f"telemetry() got unknown knobs {sorted(kwargs)}")
        tc = dict(self.telemetry_config)
        for name, value, cast in (
            ("metrics_port", metrics_port, int),
            ("trace", trace, bool),
            ("device_ledger", device_ledger, None),
            ("profile_iters", profile_iters, int),
            ("peak_flops", peak_flops, float),
            ("peak_hbm_bytes_per_s", peak_hbm_bytes_per_s, float),
        ):
            if value is not None:
                tc[name] = cast(value) if cast is not None else value
        self.telemetry_config = tc
        return self

    def offline_data(
        self,
        *,
        input_=None,
        output: Optional[str] = None,
        output_max_file_size: Optional[int] = None,
        off_policy_estimation_methods=None,
        **kwargs,
    ) -> "AlgorithmConfig":
        for name, value in (
            ("input_", input_),
            ("output", output),
            ("output_max_file_size", output_max_file_size),
            ("off_policy_estimation_methods", off_policy_estimation_methods),
        ):
            if value is not None:
                setattr(self, name, value)
        return self

    def to_dict(self) -> Dict[str, Any]:
        out = {k: copy.deepcopy(v) for k, v in vars(self).items()
               if k not in ("algo_class", "input_")}
        # a path, a callable or a reader object: passed as it is
        out["input"] = self.input_
        return out

    def update_from_dict(self, d: Dict) -> "AlgorithmConfig":
        for k, v in d.items():
            if k == "num_rollout_workers":
                self.num_workers = v
            elif k == "input":
                self.input_ = v
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
