"""PPO: config, policy (loss and KL adaptation), and algorithm.

Counterpart of ``ray_tpu/algorithms/ppo/ppo.py``. The learner runs the
clipped-surrogate / clipped-value / entropy loss in the ``num_sgd_iter``
x minibatches nest of :class:`TorchPolicy`. ``PPO.training_step`` runs
on the device lane (``env_backend: jax`` in the reference's configs,
which here means "on the device"): K superstep slots of [roll out N x T
steps on the card, GAE there, the SGD nest on the device-resident
batch], one CUDA graph replayed K times (``config.superstep``). Any
other ``env_backend`` runs the actor lane, the reference's default
(``ray_tpu/algorithms/ppo/ppo.py:214-250``): rollout workers sample on
the CPU (GAE on the host, in each worker's postprocessing) and ship
pixel fragments as frame pools, and the learner on the card rebuilds
the stacks with the row-gather kernel in its ``learn_on_batch``.
With ``sample_prefetch > 0`` and remote workers, the actor lane samples
the next train batch and copies it to the card while the learner works
on this one (``_training_step_prefetch``); with ``superstep`` K > 1 a
step learns K prefetched batches in one graphed superstep, each trimmed
on the prefetch thread to the fixed-row contract, and a frame-pool
batch (per-batch pool sizes) demotes the run to K = 1, as the
reference's.

Multi-agent PPO (``config.multi_agent(...)``) runs the actor lane's
synchronous step on a ``MultiAgentBatch``: the advantages standardized
per policy batch, one learn call per policy of the local worker's map
(each adapting its own KL coefficient on its own stats), and every
policy's weights to the workers in one ``put``. ``sample_prefetch``
stays on the synchronous path there, as the reference demotes it. The
counters are the reference's: both sampled counters add the train
batch's env steps.
"""

from __future__ import annotations

import queue
import time
from typing import Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.algorithms.algorithm import (
    NUM_AGENT_STEPS_SAMPLED,
    NUM_AGENT_STEPS_TRAINED,
    NUM_ENV_STEPS_SAMPLED,
    NUM_ENV_STEPS_TRAINED,
    Algorithm,
)
from ray_tpu_torch.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.data.sample_batch import (
    DEFAULT_POLICY_ID,
    MultiAgentBatch,
    SampleBatch,
    concat_samples,
)
from ray_tpu_torch.core.object_store import RayActorError
from ray_tpu_torch.evaluation.postprocessing import compute_gae_for_sample_batch
from ray_tpu_torch.execution.device_feed import DeviceFeeder
from ray_tpu_torch.execution.rollout_ops import SamplePrefetcher, synchronous_parallel_sample
from ray_tpu_torch.execution.train_ops import batch_is_finite, note_skipped_batch, train_one_step
from ray_tpu_torch.ops.framestack import FRAMES
from ray_tpu_torch.policy.torch_policy import CHUNK, TorchPolicy


class PPOConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or PPO)
        self.lr = 5e-5
        self.train_batch_size = 4000
        self.sgd_minibatch_size = 128
        self.num_sgd_iter = 30
        self.lambda_ = 1.0
        self.use_gae = True
        self.use_critic = True
        self.kl_coeff = 0.2
        self.kl_target = 0.01
        self.vf_loss_coeff = 1.0
        self.entropy_coeff = 0.0
        self.entropy_coeff_schedule = None
        self.clip_param = 0.3
        self.vf_clip_param = 10.0
        self.shuffle_sequences = True

    def training(
        self,
        *,
        lambda_: Optional[float] = None,
        kl_coeff: Optional[float] = None,
        kl_target: Optional[float] = None,
        sgd_minibatch_size: Optional[int] = None,
        num_sgd_iter: Optional[int] = None,
        vf_loss_coeff: Optional[float] = None,
        entropy_coeff: Optional[float] = None,
        entropy_coeff_schedule=None,
        clip_param: Optional[float] = None,
        vf_clip_param: Optional[float] = None,
        **kwargs,
    ) -> "PPOConfig":
        super().training(**kwargs)
        for name, value in (
            ("lambda_", lambda_),
            ("kl_coeff", kl_coeff),
            ("kl_target", kl_target),
            ("sgd_minibatch_size", sgd_minibatch_size),
            ("num_sgd_iter", num_sgd_iter),
            ("vf_loss_coeff", vf_loss_coeff),
            ("entropy_coeff", entropy_coeff),
            ("entropy_coeff_schedule", entropy_coeff_schedule),
            ("clip_param", clip_param),
            ("vf_clip_param", vf_clip_param),
        ):
            if value is not None:
                setattr(self, name, value)
        return self

    def to_dict(self) -> Dict:
        d = super().to_dict()
        d["lambda"] = d.pop("lambda_", 1.0)
        return d


def explained_variance(y: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    y_var = torch.var(y, unbiased=False)
    diff_var = torch.var(y - pred, unbiased=False)
    return torch.clamp_min(1.0 - diff_var / (y_var + 1e-8), -1.0)


class PPOTorchPolicy(TorchPolicy):
    """Clipped-surrogate PPO loss, with the KL coefficient adapted on
    the host between learn calls."""

    _ship_next_obs = False

    def _init_coeffs(self):
        self.coeff_values["kl_coeff"] = float(self.config.get("kl_coeff", 0.2))

    def loss(self, batch, coeffs):
        cfg = self.config
        clip_param = cfg.get("clip_param", 0.3)
        vf_clip = cfg.get("vf_clip_param", 10.0)
        vf_coeff = cfg.get("vf_loss_coeff", 1.0)

        dist_inputs, value, _ = self.model_forward_train(batch)
        dist = self.dist_class(dist_inputs)
        prev_dist = self.dist_class(batch[SampleBatch.ACTION_DIST_INPUTS])

        logp = dist.logp(batch[SampleBatch.ACTIONS])
        logp_ratio = torch.exp(logp - batch[SampleBatch.ACTION_LOGP])
        advantages = batch[SampleBatch.ADVANTAGES]
        surrogate = torch.minimum(
            advantages * logp_ratio,
            advantages
            * torch.clamp(logp_ratio, 1.0 - clip_param, 1.0 + clip_param),
        )
        action_kl = prev_dist.kl(dist)
        entropy = dist.entropy()

        value_targets = batch[SampleBatch.VALUE_TARGETS]
        vf_loss = torch.square(value - value_targets)
        vf_loss_clipped = torch.clamp(vf_loss, 0.0, vf_clip)

        total = torch.mean(
            -surrogate
            + coeffs["kl_coeff"] * action_kl
            + vf_coeff * vf_loss_clipped
            - coeffs["entropy_coeff"] * entropy
        )
        with torch.no_grad():
            stats = {
                "policy_loss": torch.mean(-surrogate),
                "vf_loss": torch.mean(vf_loss_clipped),
                "kl": torch.mean(action_kl),
                "entropy": torch.mean(entropy),
                "vf_explained_var": explained_variance(value_targets, value),
            }
        return total, stats

    def after_learn_on_batch(self, stats: Dict[str, float]) -> Dict:
        """Adaptive KL coefficient."""
        kl = stats.get("kl", 0.0)
        target = self.config.get("kl_target", 0.01)
        if self.coeff_values["kl_coeff"] > 0.0:
            if kl > 2.0 * target:
                self.coeff_values["kl_coeff"] *= 1.5
            elif kl < 0.5 * target:
                self.coeff_values["kl_coeff"] *= 0.5
        return {"cur_kl_coeff": self.coeff_values["kl_coeff"]}

    def postprocess_trajectory(self, sample_batch, other_agent_batches=None, episode=None):
        """GAE on the host (the actor lane), bootstrapped with
        :meth:`value_batch`."""
        return compute_gae_for_sample_batch(self, sample_batch, other_agent_batches, episode)


def _standardize_advantages(b) -> None:
    """Advantages standardized over the whole train batch (over each
    policy batch of a ``MultiAgentBatch``)."""
    for pb in b.policy_batches.values() if isinstance(b, MultiAgentBatch) else [b]:
        adv = np.asarray(pb[SampleBatch.ADVANTAGES], np.float32)
        pb[SampleBatch.ADVANTAGES] = ((adv - adv.mean()) / max(1e-4, adv.std())).astype(np.float32)


class PPO(Algorithm):
    _default_policy_class = PPOTorchPolicy
    _actor_lane = True
    _multi_agent = True
    _learns_under_act_lock = True  # train_one_step: the worker's learn_on_batch

    @classmethod
    def get_default_config(cls) -> PPOConfig:
        return PPOConfig(cls)

    def _engine(self):
        """The device rollout engine, built on first use: N =
        num_envs_per_worker x max(1, num_workers) env slots, T =
        rollout_fragment_length; one rollout is one train batch, so the
        lane needs ``train_batch_size == N * T``."""
        if self._rollout_engine is None:
            from ray_tpu_torch.execution.device_rollout import DeviceRolloutEngine

            cfg = self.config
            n = int(cfg.get("num_envs_per_worker", 1)) * max(
                1, int(cfg.get("num_workers", 0))
            )
            t = int(cfg.get("rollout_fragment_length", 200))
            if n * t != int(cfg["train_batch_size"]):
                raise ValueError(
                    "the device lane needs train_batch_size == "
                    "num_envs_per_worker * max(1, num_workers) * "
                    f"rollout_fragment_length, got {n * t} != "
                    f"{cfg['train_batch_size']}"
                )
            self._rollout_engine = DeviceRolloutEngine(
                self.get_policy(), self.env, n, t, seed=cfg.get("seed"),
            )
            self._extra_metric_sources.append(self._rollout_engine.get_metrics)
        return self._rollout_engine

    def training_step(self) -> Dict:
        """K x [rollout(T) + GAE + the num_sgd_iter-epoch nest] on the
        device lane (the reference's ``_training_step_jax_rollout``): one
        ``learn_rollout_superstep`` call with ``jax_fused_rollout`` (the
        default), else K eager rollout-then-learn rounds. The KL
        coefficient adapts on the drained per-update stats, in order."""
        if self.config.get("env_backend") != "jax":
            return self._training_step_actor_lane()
        eng = self._engine()
        policy = self.get_policy()
        bsize = eng.batch_size
        K = self._resolve_superstep_k()
        if self.config.get("jax_fused_rollout", True):
            infos, carry, metrics, skipped = policy.learn_rollout_superstep(
                K, bsize, eng.superstep_feed(), k_max=K
            )
            eng.advance(carry, metrics)
            for info_i in infos:
                info_i.update(policy.after_learn_on_batch(info_i))
            info = infos[-1]
            if any(skipped):
                note_skipped_batch(self, sum(skipped))
        else:
            for _ in range(K):
                batch, bsize = eng.rollout()
                info = policy.learn_on_device_batch(eng.learn_batch(batch), bsize)
        info["cur_lr"] = policy.coeff_values.get("lr")
        for key in (
            NUM_ENV_STEPS_SAMPLED, NUM_AGENT_STEPS_SAMPLED,
            NUM_ENV_STEPS_TRAINED, NUM_AGENT_STEPS_TRAINED,
        ):
            self._counters[key] += K * bsize
        policy.global_timestep = self._counters[NUM_ENV_STEPS_SAMPLED]
        return {DEFAULT_POLICY_ID: info}

    def _training_step_actor_lane(self) -> Dict:
        """The reference's ``training_step`` off the device lane: a
        synchronous sample round to ``train_batch_size`` env steps, the
        advantages standardized over the batch, one ``learn_on_batch`` on
        the local worker, then the new weights and the timestep to every
        worker (and the filters, when one is set). The parts' seconds go
        to ``self._timers`` (``sample_s``, ``concat_s``,
        ``learn_on_batch_s``, ``sync_weights_s``)."""
        if self._use_sample_prefetch():
            return self._training_step_prefetch()
        t0 = time.perf_counter()
        batches = synchronous_parallel_sample(
            worker_set=self.workers, max_env_steps=self.config["train_batch_size"], concat=False,
        )
        t1 = time.perf_counter()
        train_batch = concat_samples(batches)
        self._timers["sample_s"] = t1 - t0
        self._timers["concat_s"] = time.perf_counter() - t1
        self._counters[NUM_ENV_STEPS_SAMPLED] += train_batch.env_steps()
        self._counters[NUM_AGENT_STEPS_SAMPLED] += train_batch.env_steps()
        _standardize_advantages(train_batch)
        train_info = train_one_step(self, train_batch)
        t2 = time.perf_counter()
        self.workers.sync_weights(global_vars={"timestep": self._counters[NUM_ENV_STEPS_SAMPLED]})
        if self.config.get("observation_filter") not in (None, "NoFilter"):
            self.workers.sync_filters()
        self._timers["sync_weights_s"] = time.perf_counter() - t2
        return train_info

    # -- the prefetch path (config.sample_prefetch) ------------------------

    def _use_sample_prefetch(self) -> bool:
        """Prefetch needs remote workers and one policy; otherwise the
        round is synchronous, as in the reference."""
        return (int(self.config.get("sample_prefetch") or 0) > 0
                and self.workers.num_remote_workers() > 0
                and not self.config.get("policies"))

    def _metrics_may_lag(self) -> bool:
        return self._use_sample_prefetch()

    def _build_sample_pipeline(self) -> None:
        """A :class:`SamplePrefetcher` whose ``deliver`` (on its thread)
        standardizes the advantages, skips a non-finite batch under
        ``nan_guard``, prepares the host tree (under a superstep K > 1,
        trimmed to the largest multiple of the unroll length at or under
        ``train_batch_size``, or demoting the run to K = 1 if it is a
        frame pool) and puts it on a :class:`DeviceFeeder` of
        ``max(sample_prefetch, K)`` batches, which copies it to the card
        on its own stream."""
        policy = self.get_policy()
        depth = max(1, int(self.config["sample_prefetch"]), self._resolve_superstep_k())
        feeder = DeviceFeeder(policy.device, capacity=depth)
        T = max(1, policy._unroll_T)
        fixed_rows = (int(self.config["train_batch_size"]) // T) * T

        def deliver(batch):
            _standardize_advantages(batch)
            # the prefetch path's learn choke point (train_one_step's twin)
            if self._fault_injector is not None:
                self._fault_injector.on_learn(batch)
            if self.config.get("nan_guard") and not batch_is_finite(batch):
                note_skipped_batch(self)
                return
            tree, bsize = policy.prepare_batch(batch)
            if self._superstep_k > 1 and fixed_rows > 0:
                if FRAMES in tree:
                    self._superstep_k = 1
                elif bsize > fixed_rows:
                    tree = {c: v[: fixed_rows // T] if c.startswith(CHUNK) else v[:fixed_rows]
                            for c, v in tree.items()}
                    bsize = fixed_rows
            feeder.put(tree, (bsize, batch.env_steps(), batch.count))

        self._prefetch_feeder = feeder
        self._sample_pipeline = SamplePrefetcher(
            self.workers,
            target_steps=int(self.config["train_batch_size"]),
            deliver=deliver,
            max_in_flight=int(self.config.get("max_requests_in_flight_per_rollout_worker", 2)),
        )
        if self._fleet is not None:
            self._fleet.register_manager(self._sample_pipeline.manager)

    def _next_prefetched(self):
        """The next prefetched device batch, handling dead workers while
        it waits."""
        pipe = self._sample_pipeline
        while True:
            if not pipe.healthy():
                raise pipe.error or RuntimeError("the sample pipeline thread died")
            self._recover_pipeline_workers(pipe)
            try:
                return self._prefetch_feeder.get(timeout=1.0)
            except queue.Empty:
                continue

    def _training_step_prefetch(self) -> Dict:
        """One learn on the next prefetched batch (the reference's
        ``_training_step_prefetch``): wait for it (``prefetch_wait_s``:
        ~0 when the pipeline keeps up), the nest on the card
        (``learn_s``), then the weights and the timestep to every worker
        (``sync_weights_s``). Its first batch is the synchronous path's
        first batch, learned on the same permutations: the same stats,
        bitwise. Under a superstep K > 1 the step takes K prefetched
        batches and learns them by one ``learn_superstep`` (the
        coefficients read once), then applies the KL reaction to each
        update's stats in order; K batches of unequal sizes, or frame
        pools, learn one at a time."""
        if getattr(self, "_sample_pipeline", None) is None:
            self._build_sample_pipeline()
        pipe = self._sample_pipeline
        t0 = time.perf_counter()
        batches = [self._next_prefetched()]
        K = self._resolve_superstep_k()
        while K > 1 and len(batches) < K:
            batches.append(self._next_prefetched())
        t1 = time.perf_counter()
        policy = self.get_policy()
        sizes = {bsize for _, (bsize, _, _) in batches}
        if K > 1 and len(sizes) == 1 and not any(FRAMES in dev for dev, _ in batches):
            stacked = {c: torch.stack([dev[c] for dev, _ in batches]) for c in batches[0][0]}
            infos, _, skipped = policy.learn_superstep(K, sizes.pop(), stacked=stacked, k_max=K)
            for info_i in infos:
                info_i.update(policy.after_learn_on_batch(info_i))
            info = infos[-1]
            if any(skipped):
                note_skipped_batch(self, sum(skipped))
            self._counters["num_prefetch_supersteps"] += 1
        else:
            for dev, (bsize, _, _) in batches:
                info = policy.learn_on_device_batch(dev, bsize)
        t2 = time.perf_counter()
        for _, (_, env_steps, rows) in batches:
            self._counters[NUM_ENV_STEPS_SAMPLED] += env_steps
            self._counters[NUM_AGENT_STEPS_SAMPLED] += env_steps
            self._counters[NUM_ENV_STEPS_TRAINED] += env_steps
            self._counters[NUM_AGENT_STEPS_TRAINED] += rows
        self.workers.sync_weights(global_vars={"timestep": self._counters[NUM_ENV_STEPS_SAMPLED]})
        if self.config.get("observation_filter") not in (None, "NoFilter"):
            self.workers.sync_filters()
        self._timers.update(prefetch_wait_s=t1 - t0, learn_s=t2 - t1,
                            sync_weights_s=time.perf_counter() - t2)
        self._recover_pipeline_workers(pipe)
        return {DEFAULT_POLICY_ID: info, "sample_pipeline": pipe.stats()}

    def _recover_pipeline_workers(self, pipe) -> None:
        """Workers the pipeline saw die: ``recreate_failed_workers``
        replaces them (no ping probe: the pipeline's request manager saw
        the deaths) and the replacements join the pipeline;
        ``ignore_worker_failures`` drops them from the worker set; else
        raise."""
        dead = pipe.take_dead_workers()
        if not dead:
            return
        self._counters["num_dead_rollout_workers"] += len(dead)
        if self.config.get("recreate_failed_workers"):
            pipe.add_workers(self.workers.replace_failed_workers(dead))
        elif self.config.get("ignore_worker_failures"):
            self.workers.remove_workers(dead)
        else:
            raise RayActorError(f"{len(dead)} rollout worker(s) died in the sample pipeline")

    def on_fleet_change(self, added, removed) -> None:
        """Joiners (weights and filters synced already) enter the prefetch
        pipeline's rotation; the fleet controller took the drained ones
        out of its request manager."""
        super().on_fleet_change(added, removed)
        pipe = getattr(self, "_sample_pipeline", None)
        if pipe is not None and added:
            pipe.add_workers(added)

    def sampler_queue_depths(self) -> Dict[str, int]:
        feeder = getattr(self, "_prefetch_feeder", None)
        return {"feeder_out": feeder.qsize()} if feeder is not None else {}

    def on_recovery(self, kind: str) -> None:
        """A restore invalidates the prefetch pipeline (its thread may be
        dead: a crash in ``deliver`` is how the restore came about, and
        its queued batches are the old policy's): tear it down; the next
        step builds it again."""
        super().on_recovery(kind)
        if kind == "restore":
            self._teardown_pipeline()

    def _teardown_pipeline(self) -> None:
        # the flag first: a deliver blocked on the feeder's back-pressure
        # wakes when the feeder stops, and must find the flag set
        pipe = getattr(self, "_sample_pipeline", None)
        feeder = getattr(self, "_prefetch_feeder", None)
        if pipe is not None:
            pipe.request_stop()
        if feeder is not None:
            feeder.stop()
            self._prefetch_feeder = None
        if pipe is not None:
            pipe.stop()
            self._sample_pipeline = None

    def stop(self) -> None:
        self._teardown_pipeline()
        super().stop()
