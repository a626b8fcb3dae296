"""Algorithm: owns the env, the policy and the training loop.

Counterpart of ``ray_tpu/algorithms/algorithm.py``. On the device lane
(``env_backend: "jax"``) it holds one env and one policy. On the actor
lane (any other ``env_backend``, for an algorithm whose training step
has one: ``_actor_lane``) it builds a ``WorkerSet``: a local worker whose
policy is the learner (``self.policy``, on the algorithm's device) and
``num_workers`` remote rollout workers on the CPU; episode metrics come
from every worker's ``get_metrics`` and ``stop()`` ends the workers'
processes. ``train()`` runs ``training_step`` until the iteration has
lasted ``min_time_s_per_iteration`` seconds and sampled
``min_sample_timesteps_per_iteration`` env steps (by default one step;
IMPALA's asynchronous step returns whatever is ready, and its config
asks for 1 s) and returns a result dict with the reference's keys
(``episode_reward_mean``, ``episodes_this_iter``,
``num_env_steps_sampled``, ``timesteps_total``, ``training_iteration``,
``info/learner/default_policy``, ...).

The ``Algorithm``'s own surface, as the reference's
(``ray_tpu/algorithms/algorithm.py``):

- **Callbacks.** ``callbacks_class`` is built here, and its
  ``on_train_result(algorithm=, result=)`` runs at the end of every
  ``train()`` on both lanes; each rollout worker builds its own for the
  episode hooks (the device lane has none, as the reference's).
- **Evaluation.** With ``evaluation_interval`` set, an evaluation
  ``WorkerSet`` (``evaluation_worker_config``; ``evaluation_num_workers``
  remote workers) is built beside the training one; ``evaluate()`` sends
  it the learner's weights and filters and samples until it has
  ``evaluation_duration`` episodes; ``train()`` puts the summary under
  ``results["evaluation"]`` on every ``evaluation_interval``-th
  iteration. A device-lane run builds the same set, whatever
  ``env_backend`` says (the reference's rule): its workers drive the
  tensor env through ``TensorVectorEnvAdapter`` and get the learner's
  weights (the lane has no filter).
- **Acting.** ``compute_single_action`` applies the local worker's
  preprocessor and filter (``update=False``) and takes ``explore`` from
  the config when not given.
- **State.** ``__getstate__`` is the reference's layout, ``{"worker":
  {"policy_states", "filters"}, "counters", "episodes_total"}`` (host
  objects only; the off-policy family adds its replay buffer);
  ``__setstate__`` loads it and sends the restored weights to the remote
  workers. Both hold :meth:`_state_lock` (IMPALA's learner thread's
  step lock).
- **Checkpoints** (``tune/trainable.Trainable``: ``save``, ``restore``,
  ``logdir``). ``save_checkpoint`` writes ``algorithm_state.pkl``, then
  ``algorithm_config.pkl`` (the config without ``device`` and the
  ``_``-keys, through ``core/serialization.dumps``), then
  ``rllib_checkpoint.json`` last, each atomically, one directory fsync,
  then prunes the ``checkpoint_*`` siblings to ``keep_checkpoints_num``.
  ``from_checkpoint(path, device=None)`` rebuilds the algorithm from
  the directory alone (the class from the metadata through
  ``algorithms/registry.py``) and restores it, ``.tune_metadata``'s
  iteration included. ``export_policy_model`` writes a policy's
  ``policy_state.pkl``.

Without an ``env``, an actor-lane algorithm builds its policies on the
config's ``observation_space`` and ``action_space`` and its workers
sample nothing themselves: the external-env setup, whose ``input`` is a
``PolicyServerInput``. The device lane refuses ``input`` and ``output``,
which it would never read (the reference's ignores them).

A joint collector (``_joint_collector``: MADDPG, QMIX) builds neither:
it makes its one multi-agent env and steps it itself, as the reference's
does after building its base with ``env=None``.

Fault tolerance (``AlgorithmConfig.fault_tolerance``; the resilience
layer, ``resilience/``), as the reference wires it into every step:

- ``train()`` hands a failed ``training_step`` to the
  ``RecoveryManager`` (``self._recovery``), which recreates dead workers
  or restores the newest periodic checkpoint or stream snapshot, and
  then calls :meth:`on_recovery`; a failure it does not absorb raises.
- Between training-step rounds ``train()`` runs the elastic fleet's
  ``reconcile()`` (``elastic``: a ``FleetController`` over the remote
  workers, whose drains and joins reach :meth:`on_fleet_change`) and the
  checkpoint streamer's ``offer()`` (``checkpoint_streaming``); at the
  end of each iteration, ``maybe_checkpoint()`` (``checkpoint_frequency``).
- ``info/recovery`` holds the manager's counts, with ``fleet`` and
  ``stream`` when those run; ``stop()`` joins the fleet's thread and the
  streamer before it ends the workers.
- ``self._fault_injector`` (the config's fault spec) is the main
  process's learn choke points' injector (``train_ops.train_one_step``, PPO's
  prefetch ``deliver``).

Telemetry (``AlgorithmConfig.telemetry``; ``telemetry/``), as the
reference wires it:

- the runtime starts (``init_from_config``) before the ``WorkerSet``
  exists, so the first remote submission already carries a trace
  context; ``self._telemetry`` is it (None: off);
- each ``train()`` runs under a ``train:iteration`` span, the root of
  the iteration's driver and worker spans;
- every result gets the throughput gauges; with tracing on,
  ``info/telemetry`` (the iteration roll-up with ``overlap_fraction``,
  ``window_iterations_ago``, throughput, h2d/d2h bytes, ``superstep``);
  with the ledger on, ``info/device_ledger``;
- ``profile_iters`` wraps the first N iterations in a
  ``torch.profiler`` capture written to ``<logdir>/torch_profile``;
- :meth:`export_timeline` writes the chrome trace.

Multi-agent (``config["policies"]``, an algorithm whose actor lane
learns a policy map: ``_multi_agent``, PPO and the replay family): the
worker set's policy map holds one policy per id, built from the
reference's specs (:func:`build_policy_specs`); ``get_policy(pid)``
returns it, ``info/learner/<pid>`` holds its stats and
``policy_reward_mean`` each policy's mean episode reward. Where the
reference has no multi-agent path, the port refuses ``policies`` as the
reference does: the device lane is single-policy, and IMPALA and APPO
learn the default policy alone (:func:`refuse_policy_map`).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import pickle
import shutil
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch import core as ray_core
from ray_tpu_torch import telemetry as telemetry_lib
from ray_tpu_torch.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.autoscaler.fleet import FleetController
from ray_tpu_torch.core import serialization
from ray_tpu_torch.data.sample_batch import DEFAULT_POLICY_ID
from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.env.registry import get_env_creator
from ray_tpu_torch.evaluation.metrics import summarize_episodes
from ray_tpu_torch.evaluation.rollout_worker import refuse_local_async, refuse_local_input_reader
from ray_tpu_torch.evaluation.worker_set import WorkerSet, evaluation_worker_config
from ray_tpu_torch.resilience import faults
from ray_tpu_torch.resilience.recovery import RecoveryManager
from ray_tpu_torch.resilience.streamer import CheckpointStreamer
from ray_tpu_torch.sharding.superstep import resolve_superstep
from ray_tpu_torch.tune.trainable import Trainable
from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.atomic_io import atomic_write, fsync_dir

NUM_ENV_STEPS_SAMPLED = "num_env_steps_sampled"
NUM_AGENT_STEPS_SAMPLED = "num_agent_steps_sampled"
NUM_ENV_STEPS_TRAINED = "num_env_steps_trained"
NUM_AGENT_STEPS_TRAINED = "num_agent_steps_trained"


STATE_FILE = "algorithm_state.pkl"
CONFIG_FILE = "algorithm_config.pkl"
META_FILE = "rllib_checkpoint.json"


def build_policy_specs(config: Dict, policy_cls, env_creator) -> Optional[Dict]:
    """``{pid: (cls, obs_space, act_space, overrides)}`` from
    ``config["policies"]`` (None when it is empty), as the reference
    builds them: a tuple's ``cls`` None is ``policy_cls``; any other
    spec takes its spaces from a probe env."""
    if not config.get("policies"):
        return None
    specs = {}
    for pid, spec in config["policies"].items():
        if isinstance(spec, (tuple, list)):
            cls, obs_space, act_space, overrides = spec
            specs[pid] = (cls or policy_cls, obs_space, act_space, overrides or {})
        else:
            probe = env_creator(config.get("env_config") or {})
            specs[pid] = (policy_cls, probe.observation_space, probe.action_space, {})
    return specs


def refuse_policy_map(name: str, policies: Dict, actor_lane: bool) -> None:
    """``policies`` where the reference has no multi-agent path. The
    device lane is single-policy, in the reference's words
    (``ray_tpu/algorithms/dqn/dqn.py:820``). IMPALA and APPO look up the
    default policy, so a map without one fails as the reference's build
    does (``KeyError: 'default_policy'``). A map that holds it is the
    port's own refusal: the reference's IMPALA builds and trains the
    default policy alone, dropping the others' samples without a word,
    and its APPO fails on the ``MultiAgentBatch``."""
    if not actor_lane:
        raise ValueError("env_backend='jax' is single-policy")
    if DEFAULT_POLICY_ID not in policies:
        raise KeyError(DEFAULT_POLICY_ID)
    raise ValueError(
        f"{name} learns {DEFAULT_POLICY_ID!r} alone: the port refuses a policy map "
        f"{sorted(policies)} whose other policies would stay untrained (the reference "
        "trains the default policy alone without saying so)"
    )


def refuse_device_lane(algo) -> None:
    """The algorithms whose training step samples through rollout workers
    have no device lane (``env_backend: "jax"``), as the reference's
    step samples through its worker set whatever the backend."""
    if algo.workers is None:
        raise NotImplementedError(
            f"{type(algo).__name__} runs on the actor lane: env_backend='jax' builds no "
            "rollout workers for its training step"
        )


class Algorithm(Trainable):
    _default_policy_class = None
    # whether training_step has an actor-lane path (PPO); the others
    # keep the device lane's construction and raise in training_step
    _actor_lane = False
    # whether the actor lane learns a policy map (config["policies"])
    _multi_agent = False
    # whether the algorithm steps its own multi-agent env (MADDPG, QMIX):
    # no worker set, no policy (:meth:`_setup_joint_collector`)
    _joint_collector = False
    # whether every learn of the local worker's policies holds the
    # worker's act lock (a callable input on the local worker needs it)
    _learns_under_act_lock = False

    @classmethod
    def get_default_config(cls) -> AlgorithmConfig:
        return AlgorithmConfig(cls)

    def __init__(self, config=None, env=None):
        super().__init__()
        if isinstance(config, AlgorithmConfig):
            config = config.to_dict()
        config = dict(config or {})
        if env is not None:
            config["env"] = env
        if "lambda_" in config:  # the config object's spelling
            config["lambda"] = config.pop("lambda_")
        self.config = {**self.get_default_config().to_dict(), **config}
        self.device = resolve_device(self.config.get("device"))
        self._counters: Dict[str, int] = collections.defaultdict(int)
        self._episode_history: List = []
        self._episodes_total = 0
        self._extra_metric_sources: List[Callable[[], List]] = []
        self._timers: Dict[str, float] = collections.defaultdict(float)
        self._rollout_engine = None
        self.workers = None
        self.evaluation_workers = None
        cb_cls = self.config.get("callbacks_class")
        self.callbacks = cb_cls() if cb_cls else None
        # id(remote worker) -> its pending get_metrics ref (_remote_episodes)
        self._metrics_refs: Dict[int, Any] = {}
        # the resilience layer: the main process's fault injector (None unless a
        # spec arms it) and the recovery manager train() consults
        self._fault_injector = faults.from_config(self.config)
        self._recovery = RecoveryManager(self)
        self._fleet = None
        self._ckpt_streamer = None
        # telemetry: on before any worker exists, so the first remote
        # submission already carries a trace context (None: off)
        self._telemetry = telemetry_lib.init_from_config(self.config)
        # iteration start stamps, for export_timeline(last_n=...)
        self._iteration_marks: collections.deque = collections.deque(maxlen=1024)
        tc = self.config.get("telemetry_config") or {}
        self._profile_iters = int(tc.get("profile_iters", 0) or 0)
        self._profiler = None

        env_spec = self.config.get("env")
        if self._joint_collector:
            self._setup_joint_collector(env_spec)
            return
        policy_cls = self._default_policy_class
        actor_lane = self._actor_lane and self.config.get("env_backend") != "jax"
        spaces = (self.config.get("observation_space") is not None
                  and self.config.get("action_space") is not None)
        if env_spec is None and not (actor_lane and spaces):
            raise ValueError(
                "config has no 'env' (an actor-lane algorithm without one takes "
                "observation_space and action_space, as for an external env)"
            )
        if self.config.get("policies") and not (actor_lane and self._multi_agent):
            refuse_policy_map(type(self).__name__, self.config["policies"], actor_lane)
        if actor_lane:
            refuse_local_async(self.config)
            refuse_local_input_reader(self.config, self._learns_under_act_lock)
            env_creator = get_env_creator(env_spec) if env_spec is not None else None
            specs = dict(
                env_creator=env_creator, policy_cls=policy_cls, device=self.device,
                policy_specs=build_policy_specs(self.config, policy_cls, env_creator),
                policy_mapping_fn=self.config.get("policy_mapping_fn"),
            )
            self.workers = WorkerSet(
                config=self.config, num_workers=int(self.config.get("num_workers", 0)), **specs,
            )
            local = self.workers.local_worker()
            self.env = local.env
            # the learner of a single-policy run (None in a multi-agent
            # run without a default policy: get_policy(pid) names one)
            self.policy = local.policy_map.get(DEFAULT_POLICY_ID)
            if self.config.get("evaluation_interval"):
                self.evaluation_workers = WorkerSet(
                    config=evaluation_worker_config(self.config),
                    num_workers=int(self.config.get("evaluation_num_workers", 0)), **specs,
                )
            self._setup_resilience()
            return
        for key in ("input", "output"):
            if self.config.get(key) not in (None, "sampler"):
                raise ValueError(
                    f"{key!r} on the device lane (env_backend='jax'): the lane's rollouts never "
                    "pass through a rollout worker, so nothing would read or write it (the "
                    "reference's device lane ignores it); use the actor lane"
                )
        env_creator = get_env_creator(env_spec)
        self.env = env_creator(dict(self.config.get("env_config") or {}))
        self.policy = policy_cls(
            self.env.observation_space, self.env.action_space,
            self.config, device=self.device,
        )
        if self.config.get("evaluation_interval"):
            self.evaluation_workers = WorkerSet(
                config=evaluation_worker_config(self.config),
                num_workers=int(self.config.get("evaluation_num_workers", 0)),
                env_creator=env_creator, policy_cls=policy_cls, device=self.device,
            )
        self._setup_resilience()

    def _setup_joint_collector(self, env_spec) -> None:
        """A joint collector's construction (MADDPG, QMIX): the algorithm
        steps one multi-agent env itself, as the reference's builds its
        base with ``env=None``; no worker set and no policy. The device
        lane has no tensor env for it."""
        if env_spec is None:
            raise ValueError("config has no 'env'")
        if self.config.get("env_backend") == "jax":
            raise NotImplementedError(
                f"{type(self).__name__} steps its multi-agent env on the host with its own joint "
                "collector, as the reference's: env_backend='jax' has no tensor env for it"
            )
        self.env = get_env_creator(env_spec)(dict(self.config.get("env_config") or {}))
        self.policy = None
        self._setup_resilience()

    def _setup_resilience(self) -> None:
        """The elastic fleet (``elastic`` with remote workers; its monitor
        thread is this algorithm's, stopped in :meth:`stop`) and the
        checkpoint streamer (``checkpoint_streaming``, under
        ``<checkpoint_root>/stream``, default root ``<logdir>/resilience``)."""
        cfg = self.config
        if cfg.get("elastic"):
            if self.workers is None:
                raise ValueError(
                    "elastic on the device lane (env_backend='jax'): the lane has no rollout "
                    "fleet to scale; use the actor lane"
                )
            if self.workers.num_remote_workers() > 0:
                self._fleet = FleetController(self, self.workers, cfg)
                self._extra_metric_sources.append(self._fleet.take_drained_metrics)
        if cfg.get("checkpoint_streaming"):
            root = cfg.get("checkpoint_root") or os.path.join(self.logdir, "resilience")
            self._ckpt_streamer = CheckpointStreamer(
                self, CheckpointStreamer.stream_root(root),
                every=int(cfg.get("checkpoint_stream_interval", 1) or 1),
            )

    def get_policy(self, policy_id: str = DEFAULT_POLICY_ID):
        """The policy of that id; ``KeyError`` when there is none."""
        policies = self._policy_map()
        if policy_id not in policies:
            raise KeyError(f"no policy {policy_id!r}; policies: {sorted(policies)}")
        return policies[policy_id]

    def _policy_map(self) -> Dict:
        if self.workers is not None:
            return self.workers.local_worker().policy_map
        return {DEFAULT_POLICY_ID: self.policy}

    def _resolve_superstep_k(self) -> int:
        """K of the superstep for this run (``resolve_superstep``, cached)."""
        k = self.__dict__.get("_superstep_k")
        if k is None:
            k = self._superstep_k = resolve_superstep(self.config, self.device)
        return k

    def training_step(self) -> Dict:
        raise NotImplementedError

    def train(self) -> Dict[str, Any]:
        tm = telemetry_lib.metrics
        t0 = time.perf_counter()
        w0 = time.time()
        self._iteration_marks.append(w0)
        before = {
            "learn": tm.learn_steps_total(),
            "superstep": tm.counter_total(tm.SUPERSTEP_UPDATES_TOTAL),
            "h2d": tm.h2d_bytes_by_path(),
            "d2h": tm.d2h_bytes_by_path(),
        }
        min_t = self.config.get("min_time_s_per_iteration")
        min_ts = self.config.get("min_sample_timesteps_per_iteration") or 0
        ts_before = self._counters[NUM_ENV_STEPS_SAMPLED]
        train_info: Dict = {}
        self._recovery.begin_iteration()
        self._maybe_start_profile()
        # the driver-side root every submission of this iteration
        # parents under
        with tracing.start_span("train:iteration", iteration=self._iteration + 1):
            while True:
                try:
                    info = self.training_step()
                except Exception as e:
                    # a dead worker: recreate or go on without it; a
                    # restartable failure: restore; else (or past the
                    # max_failures budget) it propagates
                    if not self._recovery.handle_failure(e):
                        raise
                    continue
                if info:
                    train_info = info
                # between rounds: the only point where the fleet may change
                # shape, and the superstep boundary the stream captures at
                if self._fleet is not None:
                    self._fleet.reconcile()
                if self._ckpt_streamer is not None:
                    self._ckpt_streamer.offer()
                done_t = min_t is None or time.perf_counter() - t0 >= min_t
                if done_t and self._counters[NUM_ENV_STEPS_SAMPLED] - ts_before >= min_ts:
                    break
            # inside the span: its recovery:checkpoint span lands in
            # this iteration's window
            self._recovery.maybe_checkpoint()
        w1 = time.time()
        self._maybe_stop_profile()
        self._iteration += 1
        results: Dict[str, Any] = {
            "info": {"learner": train_info, **self._counters},
        }
        recovery = self._recovery.stats()
        if self._fleet is not None:
            recovery["fleet"] = self._fleet.stats()
        if self._ckpt_streamer is not None:
            recovery["stream"] = self._ckpt_streamer.stats()
        results["info"]["recovery"] = recovery
        self._telemetry_results(results, before, ts_before, w0, w1)
        results.update(self._collect_rollout_metrics())
        learn_timers = {pid: dict(p.last_learn_timers) for pid, p in self._policy_map().items()
                        if getattr(p, "last_learn_timers", None)}
        if learn_timers:
            results["info"]["timers"] = learn_timers
        if self._timers:
            results["timers"] = dict(self._timers)
        results[NUM_ENV_STEPS_TRAINED] = self._counters[NUM_ENV_STEPS_TRAINED]
        results[NUM_ENV_STEPS_SAMPLED] = self._counters[NUM_ENV_STEPS_SAMPLED]
        results["timesteps_total"] = self._timesteps_total = self._counters[NUM_ENV_STEPS_SAMPLED]
        results["training_iteration"] = self._iteration
        if self.evaluation_workers is not None and self._iteration % int(
            self.config["evaluation_interval"]
        ) == 0:
            results["evaluation"] = self.evaluate()
        if self.callbacks is not None:
            self.callbacks.on_train_result(algorithm=self, result=results)
        dur = time.perf_counter() - t0
        self._time_total += dur
        results["time_this_iter_s"] = dur
        results["time_total_s"] = self._time_total
        return results

    # -- telemetry ------------------------------------------------------------

    def _telemetry_results(self, results: Dict, before: Dict, ts_before: int,
                           w0: float, w1: float) -> None:
        """The iteration's telemetry into ``results["info"]``: the
        throughput gauges always; ``device_ledger`` while the ledger
        runs; ``telemetry`` (the span roll-up of ``[w0, w1]`` and the
        counters' deltas) while tracing runs. The roll-up prefers this
        iteration's window and falls back to the previous, settled one
        when this window holds no sampling span yet (the pipelined path's
        sampling still in flight): ``window_iterations_ago`` says which.
        Spans first seen now that ended before a window opened are
        credited to it (``late``)."""
        tm = telemetry_lib.metrics
        env_steps = float(max(0, self._counters[NUM_ENV_STEPS_SAMPLED] - ts_before))
        learn_delta = tm.learn_steps_total() - before["learn"]
        throughput = tm.record_iteration_throughput(
            env_steps=env_steps, learn_steps=learn_delta, wall_s=w1 - w0
        )
        runtime_vals = tm.sample_runtime_gauges()
        if telemetry_lib.device.enabled():
            results["info"]["device_ledger"] = telemetry_lib.device.snapshot()
        if not tracing.is_enabled():
            self._prev_iter_window = (w0, w1)
            return
        spans = tracing.get_spans()
        seen = getattr(self, "_rollup_seen_span_ids", frozenset())
        fresh = [s for s in spans if s.get("span_id") not in seen]
        self._rollup_seen_span_ids = frozenset(s.get("span_id") for s in spans)
        first = getattr(self, "_first_window_start", None)
        if first is None:
            self._first_window_start = first = w0

        def late_for(window_start):
            return [s for s in fresh
                    if (s.get("end") or s.get("start")) is not None
                    and first <= (s.get("end") or s.get("start")) <= window_start]

        rollup = telemetry_lib.iteration_rollup(spans, w0, w1, late=late_for(w0))
        lag = 0
        prev = getattr(self, "_prev_iter_window", None)
        if rollup["sample_s"] == 0.0 and prev is not None:
            settled = telemetry_lib.iteration_rollup(spans, *prev, late=late_for(prev[0]))
            if settled["sample_s"] > 0.0:
                rollup, lag = settled, 1
        rollup["window_iterations_ago"] = lag
        tm.gauge(tm.OVERLAP_FRACTION, "rollout/learn overlap fraction (last iter)").set(
            rollup["overlap_fraction"]
        )

        def delta(after, was):
            return {p: after.get(p, 0.0) - was.get(p, 0.0) for p in set(after) | set(was)}

        h2d = delta(tm.h2d_bytes_by_path(), before["h2d"])
        d2h = delta(tm.d2h_bytes_by_path(), before["d2h"])
        superstep_delta = tm.counter_total(tm.SUPERSTEP_UPDATES_TOTAL) - before["superstep"]
        backend = "jax" if self.workers is None else self.config.get("env_backend", "actor")
        results["info"]["telemetry"] = {
            **rollup,
            **throughput,
            **runtime_vals,
            "h2d_bytes": {**h2d, "total": sum(h2d.values())},
            "rollout_lane": {
                "backend": backend,
                "env_steps": env_steps,
                "h2d_bytes": (h2d.get("rollout", 0.0) if backend == "jax"
                              else h2d.get("feeder", 0.0) + h2d.get("learn", 0.0)),
            },
            "replay": {
                "tree": self._replay_tree_plane(),
                "sample_h2d_bytes": h2d.get("replay_sample", 0.0),
                "rng_h2d_bytes": h2d.get("replay_rng", 0.0),
                "d2h_bytes": d2h.get("replay_priorities", 0.0),
            },
            "superstep": {
                "updates": superstep_delta,
                "learn_steps": learn_delta,
                "fused_fraction": superstep_delta / learn_delta if learn_delta else 0.0,
            },
        }
        self._prev_iter_window = (w0, w1)

    def _replay_tree_plane(self) -> str:
        """Which sum-tree implementation served this run's prioritized
        draws: ``"device"`` | ``"host"`` (one plane), ``"mixed"``, or
        ``"none"`` (no prioritized buffer)."""
        planes = set()
        for shard in getattr(self, "replay_shards", None) or ():
            plane = getattr(shard, "tree_plane", None)
            if plane:
                planes.add(plane)
        buf = getattr(self, "local_replay_buffer", None)
        for b in (getattr(buf, "buffers", None) or {}).values():
            plane = getattr(b, "tree_plane", None)
            if plane:
                planes.add(plane)
        if not planes:
            return "none"
        return planes.pop() if len(planes) == 1 else "mixed"

    def _maybe_start_profile(self) -> None:
        """Begin the ``telemetry(profile_iters=N)`` capture at the first
        iteration: ``torch.profiler`` over the CPU and (on the card) CUDA
        activities. It only observes, so the run computes the same."""
        if self._profile_iters <= 0 or self._profiler is not None:
            return
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._profiler = torch.profiler.profile(activities=activities)
        self._profiler.__enter__()

    def _maybe_stop_profile(self) -> None:
        """After the N-th profiled iteration: stop the capture and write
        its chrome trace to ``<logdir>/torch_profile/trace.json``."""
        if self._profiler is None:
            return
        self._profile_iters -= 1
        if self._profile_iters > 0:
            return
        prof, self._profiler = self._profiler, None
        prof.__exit__(None, None, None)
        path = os.path.join(self.logdir, "torch_profile")
        os.makedirs(path, exist_ok=True)
        prof.export_chrome_trace(os.path.join(path, "trace.json"))

    def export_timeline(self, path: str, last_n: Optional[int] = None) -> str:
        """Write the chrome://tracing JSON of the recorded spans (driver
        threads, worker processes, the device ledger's ``device:`` lanes;
        tracing on with ``trace=True`` or ``RAY_TPU_TRACE=1``).
        ``last_n`` keeps the last N train iterations, bounded by the span
        buffer (``RAY_TPU_TRACE_BUFFER``)."""
        since = None
        marks = self._iteration_marks
        if last_n and marks:
            since = marks[-min(int(last_n), len(marks))]
        return tracing.export_chrome_trace(path, since=since)

    # -- the resilience hooks ---------------------------------------------

    def on_recovery(self, kind: str) -> None:
        """The recovery manager just absorbed a failure of ``kind``
        (``"workers"`` or ``"restore"``): a subclass rebuilds what the
        failure broke (PPO: the prefetch pipeline; IMPALA: the learner
        thread)."""

    def on_fleet_change(self, added: List, removed: List) -> None:
        """The fleet controller changed the fleet: ``added`` joined (weights
        and filters synced), ``removed`` drained out. A subclass wires the
        joiners into its own sampling machinery (PPO's prefetch pipeline,
        IMPALA's rotation); the synchronous rounds read
        ``workers.remote_workers()`` each time and need nothing."""

    def _metrics_may_lag(self) -> bool:
        """Whether the workers' episode metrics are taken without waiting
        (the asynchronous paths, whose workers always have sample
        requests queued)."""
        return False

    def _remote_episodes(self) -> List:
        """The remote workers' finished episodes. A worker runs its calls
        in order, so a ``get_metrics`` call waits behind the sample
        requests queued before it: the synchronous round has none left
        and waits for the answers; an asynchronous path
        (:meth:`_metrics_may_lag`) takes the answers that are in and
        leaves the others for the next iteration, instead of stopping
        the main thread behind the workers' queues. On the synchronous
        round a dead worker's metrics raise, as its samples did; an
        asynchronous path skips them, since its sampling drops and
        reports a dead worker (IMPALA's ``_handle_dead_workers``)."""
        pending = self._metrics_refs
        live = {id(w): w for w in self.workers.remote_workers()}
        for wid in [k for k in pending if k not in live]:
            del pending[wid]
        for wid, w in live.items():
            if wid not in pending:
                pending[wid] = w.get_metrics.remote()
        refs = list(pending.values())
        if refs:
            ray_core.wait(refs, num_returns=len(refs), timeout=0 if self._metrics_may_lag() else None)
        episodes = []
        for wid, ref in list(pending.items()):
            done, _ = ray_core.wait([ref], timeout=0)
            if not done:
                continue
            del pending[wid]
            try:
                episodes.extend(ray_core.get(ref))
            except (ray_core.RayActorError, ray_core.WorkerCrashedError):
                if not self._metrics_may_lag():
                    raise
        return episodes

    def _collect_rollout_metrics(self) -> Dict:
        episodes = []
        if self.workers is not None:
            episodes.extend(self._remote_episodes())
            episodes.extend(self.workers.local_worker().get_metrics())
        for src in self._extra_metric_sources:
            episodes.extend(src())
        self._episode_history.extend(episodes)
        window = self.config.get("metrics_num_episodes_for_smoothing", 100)
        self._episode_history = self._episode_history[-window:]
        summary = summarize_episodes(self._episode_history)
        summary["episodes_this_iter"] = len(episodes)
        self._episodes_total += len(episodes)
        summary["episodes_total"] = self._episodes_total
        return summary

    # -- evaluation and acting ------------------------------------------------

    def evaluate(self) -> Dict:
        """The learner's weights and filters to every evaluation worker,
        then sample rounds (on the remote evaluation workers, or the
        evaluation set's local worker without them) until
        ``evaluation_duration`` episodes have finished; their summary."""
        if self.evaluation_workers is None:
            raise ValueError("evaluate() needs evaluation workers: set evaluation_interval")
        if self.workers is not None:
            local = self.workers.local_worker()
            with self._state_lock():
                weights = local.get_weights()
            filters = local.get_filters()
        else:  # the device lane: one policy, no filter
            weights, filters = {DEFAULT_POLICY_ID: self.policy.get_weights()}, {}
        lw = self.evaluation_workers.local_worker()
        lw.set_weights(weights)
        lw.sync_filters(filters)
        remote = self.evaluation_workers.remote_workers()
        if remote:
            ref = ray_core.put(weights)
            ray_core.get([w.set_weights.remote(ref) for w in remote]
                         + [w.sync_filters.remote(filters) for w in remote])
        duration = self.config.get("evaluation_duration", 10)
        episodes: List = []
        while len(episodes) < duration:
            if remote:
                ray_core.get([w.sample.remote() for w in remote])
                for eps in ray_core.get([w.get_metrics.remote() for w in remote]):
                    episodes.extend(eps)
            else:
                lw.sample()
                episodes.extend(lw.get_metrics())
        return summarize_episodes(episodes)

    def compute_single_action(self, observation, state=None, policy_id: str = DEFAULT_POLICY_ID,
                              explore: Optional[bool] = None, **kwargs):
        """One observation's action (``(action, state_out, {})`` when a
        ``state`` is given), through the local worker's preprocessor and
        filter (not updating its statistics); ``explore`` defaults to the
        config's."""
        policy = self.get_policy(policy_id)
        if self.workers is not None:
            worker = self.workers.local_worker()
            if worker.preprocessor is not None:
                observation = worker.preprocessor.transform(observation)
            filt = worker.filters.get(policy_id)
            if filt is not None:
                observation = filt(observation, update=False)
        explore = self.config.get("explore", True) if explore is None else explore
        action, state_out, _ = policy.compute_single_action(observation, state, explore=explore)
        if state:
            return action, state_out, {}
        return action

    # -- checkpoint state ----------------------------------------------------

    def _state_lock(self):
        """What a read or write of the policies' state holds: nothing
        here; IMPALA's learner thread's step lock."""
        return contextlib.nullcontext()

    def __getstate__(self) -> Dict:
        """The reference's layout: the local worker's ``save()`` (every
        policy's state and filter; the device lane's one policy and no
        filter), the counters and the episode total. Host objects only."""
        with self._state_lock():
            if self.workers is not None:
                worker = self.workers.local_worker().save()
            else:
                worker = {"policy_states": {DEFAULT_POLICY_ID: self.policy.get_state()},
                          "filters": {}}
        return {
            "worker": worker,
            "counters": dict(self._counters),
            "episodes_total": self._episodes_total,
        }

    def __setstate__(self, state: Dict) -> None:
        """Load a state of that layout, then send the restored weights to
        the remote workers (their filters follow at the next
        ``sync_filters``, as in the reference)."""
        with self._state_lock():
            if self.workers is not None:
                self.workers.local_worker().restore(state["worker"])
            else:
                for pid, s in state["worker"].get("policy_states", {}).items():
                    self.get_policy(pid).set_state(s)
            self._counters = collections.defaultdict(int, state.get("counters", {}))
            self._episodes_total = state.get("episodes_total", 0)
            if self.workers is not None:
                self.workers.sync_weights()

    # -- checkpoints -----------------------------------------------------------

    def save_checkpoint(self, checkpoint_dir: str) -> str:
        """The state, the config, then the metadata that marks the
        checkpoint complete, each written atomically; one directory
        fsync; then the pruning of older ``checkpoint_*`` siblings."""
        state = self.__getstate__()
        atomic_write(os.path.join(checkpoint_dir, STATE_FILE),
                     lambda f: pickle.dump(state, f), sync_dir=False)
        blob = serialization.dumps({k: v for k, v in self.config.items()
                                    if not k.startswith("_") and k != "device"})
        atomic_write(os.path.join(checkpoint_dir, CONFIG_FILE), lambda f: f.write(blob),
                     sync_dir=False)
        meta = {
            "type": "Algorithm",
            "algorithm_class": type(self).__name__,
            # the class's own registry name: a subclass (APPO, SAC) does
            # not take its base's
            "algorithm_name": type(self).__dict__.get("_registry_name") or type(self).__name__,
        }
        atomic_write(os.path.join(checkpoint_dir, META_FILE),
                     lambda f: f.write(json.dumps(meta).encode()), sync_dir=False)
        fsync_dir(checkpoint_dir)
        self._prune_old_checkpoints(checkpoint_dir)
        return checkpoint_dir

    def _prune_old_checkpoints(self, checkpoint_dir: str) -> None:
        """The ``checkpoint_*`` directories beside this one, down to the
        newest ``keep_checkpoints_num`` (zero-padded names sort by age);
        the one just written always stays; None or 0 keeps all."""
        keep = self.config.get("keep_checkpoints_num")
        if not keep or keep < 1:
            return
        current = os.path.abspath(checkpoint_dir)
        parent = os.path.dirname(current)
        try:
            siblings = sorted(
                os.path.join(parent, d) for d in os.listdir(parent)
                if d.startswith("checkpoint_") and os.path.isdir(os.path.join(parent, d))
            )
        except OSError:
            return
        victims = [d for d in siblings if d != current][: max(0, len(siblings) - int(keep))]
        for d in victims:
            shutil.rmtree(d, ignore_errors=True)
        if victims:
            fsync_dir(parent)

    def load_checkpoint(self, checkpoint_path: str) -> None:
        if os.path.isdir(checkpoint_path):
            checkpoint_path = os.path.join(checkpoint_path, STATE_FILE)
        with open(checkpoint_path, "rb") as f:
            state = pickle.load(f)
        self.__setstate__(state)

    @classmethod
    def from_checkpoint(cls, checkpoint_path: str, *, device=None) -> "Algorithm":
        """An algorithm rebuilt from a checkpoint directory alone: the
        class from its metadata (when called on ``Algorithm`` itself),
        the stored config, on ``device`` (None: CUDA), then ``restore``."""
        algo_cls = cls
        if cls is Algorithm:
            meta_path = os.path.join(checkpoint_path, META_FILE)
            if not os.path.exists(meta_path):
                raise ValueError(
                    f"{checkpoint_path!r} has no {META_FILE}; call from_checkpoint on the "
                    "concrete class or save the checkpoint again"
                )
            with open(meta_path) as f:
                meta = json.load(f)
            from ray_tpu_torch.algorithms.registry import get_algorithm_class

            algo_cls = get_algorithm_class(meta["algorithm_name"])
        with open(os.path.join(checkpoint_path, CONFIG_FILE), "rb") as f:
            config = serialization.loads(f.read())
        algo = algo_cls(config={**config, "device": device})
        algo.restore(checkpoint_path)
        return algo

    def export_policy_model(self, export_dir: str, policy_id: str = DEFAULT_POLICY_ID) -> None:
        self.get_policy(policy_id).export_checkpoint(export_dir)

    def stop(self) -> None:
        """Join the fleet's monitor thread and the streamer (which writes
        its pending snapshot first), then stop the workers (the
        evaluation workers too) and end the remote workers' processes; a
        joint collector closes its env."""
        if self._joint_collector and getattr(getattr(self, "env", None), "close", None):
            self.env.close()
        if getattr(self, "_profiler", None) is not None:
            self._profile_iters = 1
            self._maybe_stop_profile()
        if getattr(self, "_fleet", None) is not None:
            self._fleet.stop()
        if getattr(self, "_ckpt_streamer", None) is not None:
            self._ckpt_streamer.stop()
        if self.workers is not None:
            self.workers.stop()
        if self.evaluation_workers is not None:
            self.evaluation_workers.stop()
