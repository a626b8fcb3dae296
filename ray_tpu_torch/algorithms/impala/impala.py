"""IMPALA: the V-trace actor-learner.

Counterpart of ``ray_tpu/algorithms/impala/impala.py``. Rollout workers
emit fixed unrolls of T = ``rollout_fragment_length`` steps that may
span an episode reset (``_fixed_unrolls``; the done rows inside a
fragment reset the V-trace discounts), pixel unrolls shipped as frame
pools whose bootstrap stack is the one after the last row. The main thread
keeps every worker at its in-flight cap (``AsyncRequestsManager``),
gathers fragments into train batches and feeds the
:class:`LearnerThread`, which copies each batch to the card (a pinned
side-stream copy) and runs one forward over the (B, T + 1) steps, the
V-trace scan and the loss; the frame pool is rebuilt into stacks by the
row-gather kernel (``build_stacks``). The thread publishes its weights,
and the main thread sends them back to the worker that produced each batch
without touching the device.

With ``superstep`` K > 1 (``"auto"``: 8 on the card) the learner thread
fuses up to K queued flat batches into one graphed superstep
(``execution/learner_thread.py``); APPO's main-thread target refresh
counts each of the K updates, since each puts its own stats out.

``num_aggregation_workers > 0`` routes each harvested fragment's ref,
round-robin, to an :class:`AggregatorWorker` actor, which concatenates
fragments to ``train_batch_size`` in its own process and answers None
until then; the main thread adds what comes back to the learner thread.
A crashed worker's errored ref drops that worker, as the reference's.

The port refuses ``env_backend: "jax"`` (the reference's IMPALA has no
device lane: it ignores the key and samples on its actor lane; the port
does not ignore a knob).

Fault tolerance: a dead worker leaves the rotation and, with
``recreate_failed_workers``, its replacement joins it (as do the
workers that the recovery manager's probe recreates, in
``on_recovery("workers")``); the elastic
fleet's joiners join it too (``on_fleet_change``), and the fleet reads
the rotation's in-flight counts and the learner's inqueue depth. A dead
learner thread (``crash_learner_thread``, or a bug) raises from
``training_step``; with ``restore_on_failure`` the recovery manager
restores the newest checkpoint or stream snapshot and ``on_recovery``
starts a new learner thread around the restored policy, whose feeder is
its own (the old thread released its pinned buffers and copy stream
when it ended) and whose fault injector is disarmed (the reference's
rebuilt thread reads the spec again and dies at the same step).
"""

from __future__ import annotations

import collections
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
from ray_tpu_torch.core import api
from ray_tpu_torch.core.object_store import RayActorError, RayTaskError, WorkerCrashedError
from ray_tpu_torch.data.sample_batch import DEFAULT_POLICY_ID, SampleBatch, concat_samples
from ray_tpu_torch.execution.learner_thread import LearnerThread
from ray_tpu_torch.execution.parallel_requests import AsyncRequestsManager
from ray_tpu_torch.ops.framestack import FRAME_IDX, FRAMES, build_stacks, decompose_segmented_obs
from ray_tpu_torch.ops.vtrace import vtrace_from_logits
from ray_tpu_torch.policy.torch_policy import TorchPolicy


class IMPALAConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or IMPALA)
        self.lr = 0.0005
        self.rollout_fragment_length = 50
        self.train_batch_size = 500
        self.num_workers = 2
        self.vtrace = True
        self.vtrace_clip_rho_threshold = 1.0
        self.vtrace_clip_pg_rho_threshold = 1.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.entropy_coeff_schedule = None
        self.grad_clip = 40.0
        self.broadcast_interval = 1
        self.learner_queue_size = 16
        self.max_sample_requests_in_flight_per_worker = 2
        self.min_time_s_per_iteration = 1
        self.num_aggregation_workers = 0

    def training(
        self,
        *,
        vtrace: Optional[bool] = None,
        vtrace_clip_rho_threshold: Optional[float] = None,
        vtrace_clip_pg_rho_threshold: Optional[float] = None,
        vf_loss_coeff: Optional[float] = None,
        entropy_coeff: Optional[float] = None,
        entropy_coeff_schedule=None,
        broadcast_interval: Optional[int] = None,
        learner_queue_size: Optional[int] = None,
        max_sample_requests_in_flight_per_worker: Optional[int] = None,
        **kwargs,
    ) -> "IMPALAConfig":
        super().training(**kwargs)
        for name, value in (
            ("vtrace", vtrace),
            ("vtrace_clip_rho_threshold", vtrace_clip_rho_threshold),
            ("vtrace_clip_pg_rho_threshold", vtrace_clip_pg_rho_threshold),
            ("vf_loss_coeff", vf_loss_coeff),
            ("entropy_coeff", entropy_coeff),
            ("entropy_coeff_schedule", entropy_coeff_schedule),
            ("broadcast_interval", broadcast_interval),
            ("learner_queue_size", learner_queue_size),
            ("max_sample_requests_in_flight_per_worker", max_sample_requests_in_flight_per_worker),
        ):
            if value is not None:
                setattr(self, name, value)
        return self

    def aggregation(self, *, num_aggregation_workers: Optional[int] = None, **kwargs) -> "IMPALAConfig":
        if num_aggregation_workers is not None:
            self.num_aggregation_workers = num_aggregation_workers
        return self


class ImpalaTorchPolicy(TorchPolicy):
    """The V-trace policy-gradient loss over fixed (B, T) unrolls. The
    nest's unit is an unroll: one epoch (``num_sgd_iter`` 1 unless set)
    of minibatches of ``train_batch_size // T`` unrolls."""

    def __init__(self, observation_space, action_space, config, device=None):
        config = dict(config)
        T = int(config.get("rollout_fragment_length", 50))
        config.setdefault("num_sgd_iter", 1)
        config["sgd_minibatch_size"] = max(1, int(config.get("train_batch_size", 500)) // T)
        super().__init__(observation_space, action_space, config, device=device)
        self.unroll_len = T
        # train rows are whole T-step fragments (the train tree's), and
        # _forward_unrolls runs a recurrent model over them: the base
        # class's chopping of flat rows into unrolls does not apply
        self._unroll_T = 1

    # -- the train tree on the host ------------------------------------

    def _batch_to_train_tree(self, samples) -> Dict[str, np.ndarray]:
        """Flat rows as (num_unrolls, T, ...) columns plus the bootstrap
        obs; a frame-pool batch keeps its pool, with a (B, T + 1) index
        column whose last entry, ``idx[-1] + 1``, is the bootstrap stack."""
        T = self.unroll_len
        num = samples.count // T
        n = num * T

        def shape_col(v):
            v = np.asarray(v)[:n]
            return v.reshape((num, T) + v.shape[1:])

        truncs = samples.get(SampleBatch.TRUNCATEDS, np.zeros(samples.count, np.float32))
        out = {
            SampleBatch.ACTIONS: shape_col(samples[SampleBatch.ACTIONS]),
            SampleBatch.REWARDS: shape_col(samples[SampleBatch.REWARDS]).astype(np.float32),
            SampleBatch.TERMINATEDS: shape_col(samples[SampleBatch.TERMINATEDS]).astype(np.float32),
            # an episode boundary of either kind resets the V-trace discount
            "dones": (
                shape_col(samples[SampleBatch.TERMINATEDS]).astype(np.float32)
                + shape_col(truncs).astype(np.float32)
            ).clip(max=1.0),
            SampleBatch.ACTION_LOGP: shape_col(samples[SampleBatch.ACTION_LOGP]).astype(np.float32),
        }
        if FRAMES in samples:
            idx = np.asarray(samples[FRAME_IDX], np.int32)[:n].reshape(num, T)
            out[FRAMES] = np.asarray(samples[FRAMES])
            out[FRAME_IDX] = np.concatenate([idx, idx[:, -1:] + 1], axis=1)
            return out
        out[SampleBatch.OBS] = shape_col(samples[SampleBatch.OBS])
        out["bootstrap_obs"] = shape_col(samples[SampleBatch.NEXT_OBS])[:, -1]
        return self._maybe_dedup_unroll_framestack(out)

    def _maybe_dedup_unroll_framestack(self, out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """The unroll-shaped framestack dedup: an unroll and its
        bootstrap obs are a sliding window of T + k frames, broken only
        at the resets that the ``dones`` column marks, so the copy to
        the card drops from (B, T + 1) stacks to about T + k frames an
        unroll; the (B, T + 1) index column rebuilds OBS and
        ``bootstrap_obs`` there (:meth:`_rebuild_obs_from_frames`)."""
        obs = out[SampleBatch.OBS]
        if (
            not self.config.get("dedup_framestack", True)
            or obs.ndim != 5
            or not 2 <= obs.shape[-1] <= 8
            or obs.nbytes < self.config.get("dedup_framestack_min_bytes", 1 << 20)
        ):
            return out
        B, T = obs.shape[:2]
        ext = np.concatenate([obs, out["bootstrap_obs"][:, None]], axis=1).reshape(
            (B * (T + 1),) + obs.shape[2:]
        )
        seg = np.zeros(B * (T + 1), bool)
        seg[:: T + 1] = True  # each unroll starts a window
        # the obs after a done row is a reset obs (a new window); the
        # bootstrap pseudo-row always slides (a terminal next obs does)
        seg.reshape(B, T + 1)[:, 1:T] |= out["dones"][:, : T - 1] > 0
        dec = decompose_segmented_obs(ext, seg)
        if dec is None:
            return out
        stream, idx = dec
        out = dict(out)
        del out[SampleBatch.OBS], out["bootstrap_obs"]
        out[FRAMES] = stream
        out[FRAME_IDX] = idx.reshape(B, T + 1)
        return out

    # -- on the device -------------------------------------------------------

    def _rebuild_obs_from_frames(self, frames, batch, stack_k):
        idx = batch.pop(FRAME_IDX)
        B, T1 = idx.shape
        stacks = build_stacks(frames, idx.reshape(-1), stack_k)
        stacks = stacks.reshape((B, T1) + stacks.shape[1:])
        batch[SampleBatch.OBS] = stacks[:, :-1]
        batch["bootstrap_obs"] = stacks[:, -1]
        return batch

    def _forward_unrolls(self, batch, params=None):
        """One forward over the T + 1 steps of each unroll (the bootstrap
        obs last), with the policy's parameters or ``params`` (a list in
        :attr:`param_names` order): (dist inputs over the B·T real steps,
        values (B, T), bootstrap values (B,)). A recurrent model runs the
        T + 1 steps as one unroll from a zero state at the fragment's
        start, with ``resets = [1, dones]``: an episode that ends inside
        the fragment (terminated or truncated) restarts the state at the
        next step, as the rollout did."""
        obs = batch[SampleBatch.OBS]
        B, T = obs.shape[0], obs.shape[1]
        obs_ext = torch.cat([obs, batch["bootstrap_obs"][:, None]], dim=1)
        if self.model.is_recurrent:
            dones = batch["dones"].float()
            args = (obs_ext, self.model.initial_state(B, obs.device))
            kwargs = {"resets": torch.cat([torch.ones_like(dones[:, :1]), dones], dim=1)}
        else:
            args, kwargs = (obs_ext.reshape((B * (T + 1),) + tuple(obs.shape[2:])),), {}
        if params is None:
            dist_all, val_all, _ = self.model_forward(*args, **kwargs)
        else:
            dist_all, val_all, _ = self.functional_forward(params, *args, **kwargs)
        dist_all = dist_all.reshape((B, T + 1) + tuple(dist_all.shape[1:]))
        val_all = val_all.reshape(B, T + 1)
        dist_inputs = dist_all[:, :T].reshape((B * T,) + tuple(dist_all.shape[2:]))
        return dist_inputs, val_all[:, :T], val_all[:, -1]

    def _vtrace(self, batch, target_logp, values, bootstrap_value):
        cfg = self.config
        B, T = values.shape
        return vtrace_from_logits(
            behaviour_action_log_probs=batch[SampleBatch.ACTION_LOGP],
            target_action_log_probs=target_logp.reshape(B, T),
            discounts=cfg.get("gamma", 0.99) * (1.0 - batch["dones"]),
            rewards=batch[SampleBatch.REWARDS],
            values=values,
            bootstrap_value=bootstrap_value,
            clip_rho_threshold=cfg.get("vtrace_clip_rho_threshold", 1.0),
            clip_pg_rho_threshold=cfg.get("vtrace_clip_pg_rho_threshold", 1.0),
        )

    def loss(self, batch, coeffs):
        B, T = batch[SampleBatch.OBS].shape[:2]
        dist_inputs, values, bootstrap_value = self._forward_unrolls(batch)
        dist = self.dist_class(dist_inputs)
        actions = batch[SampleBatch.ACTIONS]
        target_logp = dist.logp(actions.reshape((B * T,) + tuple(actions.shape[2:])))
        entropy = dist.entropy()
        vtr = self._vtrace(batch, target_logp, values, bootstrap_value)
        pi_loss = -torch.mean(vtr.pg_advantages * target_logp.reshape(B, T))
        vf_loss = 0.5 * torch.mean(torch.square(vtr.vs - values))
        entropy_mean = torch.mean(entropy)
        total = (
            pi_loss
            + self.config.get("vf_loss_coeff", 0.5) * vf_loss
            - coeffs["entropy_coeff"] * entropy_mean
        )
        with torch.no_grad():
            stats = {
                "policy_loss": pi_loss,
                "vf_loss": vf_loss,
                "entropy": entropy_mean,
                "vtrace_mean_rho_clip": torch.mean(torch.exp(torch.clamp(
                    target_logp.reshape(B, T) - batch[SampleBatch.ACTION_LOGP], -10, 10))),
            }
        return total, stats


class AggregatorWorker:
    """Concatenates rollout fragments to whole train batches in its own
    process (the reference's ``impala.py:354-379``): :meth:`aggregate`
    answers None until ``target_size`` env steps have come, then the
    concatenated batch."""

    def __init__(self, target_size: int):
        self.target_size = int(target_size)
        self._buf: list = []
        self._steps = 0

    def aggregate(self, batch):
        self._buf.append(batch)
        self._steps += batch.env_steps()
        if self._steps < self.target_size:
            return None
        out = concat_samples(self._buf)
        self._buf, self._steps = [], 0
        return out


class IMPALA(Algorithm):
    _default_policy_class = ImpalaTorchPolicy
    _actor_lane = True

    @classmethod
    def get_default_config(cls) -> IMPALAConfig:
        return IMPALAConfig(cls)

    def __init__(self, config=None, env=None):
        if isinstance(config, AlgorithmConfig):
            config = config.to_dict()
        config = {**(config or {}), "_fixed_unrolls": True}
        merged = {**self.get_default_config().to_dict(), **config}
        # refused before any worker process starts
        if merged.get("env_backend") == "jax":
            raise ValueError(
                f"the port refuses env_backend='jax' under {type(self).__name__}: the "
                "reference's IMPALA has no device lane and ignores the key (it samples on "
                "its actor lane); leave env_backend at 'actor'")
        super().__init__(config, env)
        cfg = self.config
        # the thread publishes host weights every broadcast_interval of
        # its steps; the main thread broadcasts them without touching the card
        self._learner_thread = self._new_learner_thread()
        self._frag_buf: list = []
        self._frag_steps = 0
        self._train_ready: list = []  # train batches waiting for queue room
        self._worker_weight_ver: Dict = {}  # id(worker) -> version it has
        self._weights_ref = None
        self._weights_ref_ver = -1
        self.main_spans: collections.deque = collections.deque(maxlen=4096)
        # (with no remote worker the local worker's batches are whole
        # already, and the reference's aggregators sit idle: none is made)
        self._aggregators = [
            api.remote(AggregatorWorker).remote(int(cfg["train_batch_size"]))
            for _ in range(int(cfg.get("num_aggregation_workers") or 0))
        ] if self.workers.remote_workers() else []
        self._agg_rr = 0
        self._agg_in_flight: list = []
        self.num_aggregated_batches = 0
        # refs mode when the aggregators take the fragments' refs
        self._sample_manager = AsyncRequestsManager(
            self.workers.remote_workers(),
            max_remote_requests_in_flight_per_worker=int(
                cfg.get("max_sample_requests_in_flight_per_worker", 2)),
            return_object_refs=bool(self._aggregators),
            retry_policy=self.workers.retry_policy,
        )
        # the elastic fleet drains workers out of this rotation and reads
        # its in-flight counts for idleness
        if self._fleet is not None:
            self._fleet.register_manager(self._sample_manager)

    def _new_learner_thread(self, disarmed: bool = False) -> LearnerThread:
        """The learner thread, started; ``disarmed``: without the config's
        fault injector (a rebuilt thread does not die its predecessor's
        death, as replacement workers get an empty spec)."""
        cfg = self.config
        lt = LearnerThread(
            self.get_policy(),
            inqueue_size=int(cfg.get("learner_queue_size", 16)),
            publish_weights_every=max(1, int(cfg.get("broadcast_interval", 1))),
        )
        if disarmed:
            lt._fault_injector = None
        lt.start()
        return lt

    def _metrics_may_lag(self) -> bool:
        return True

    def _state_lock(self):
        """The learner thread's step lock: the port's Adam writes the
        parameters in place, so a state read or write between two of its
        steps cannot see one half-applied (a deliberate difference: the
        reference's arrays are immutable and it takes no lock)."""
        return self._learner_thread.lock

    def __setstate__(self, state):
        """The reference's restore, then the restored weights published
        as the learner thread's newest version, which the remote workers
        already have (``sync_weights``): a later broadcast never sends
        them the weights of before the restore."""
        super().__setstate__(state)
        with self._learner_thread.lock:
            ver = self._learner_thread.publish()
        for w in self.workers.remote_workers():
            self._worker_weight_ver[id(w)] = ver

    def on_fleet_change(self, added, removed) -> None:
        """Joiners enter the rotation at once; the fleet controller took
        the drained ones out of it, and their weight versions go."""
        super().on_fleet_change(added, removed)
        if added:
            self._sample_manager.add_workers(added)
        for w in removed:
            self._worker_weight_ver.pop(id(w), None)

    def on_recovery(self, kind: str) -> None:
        """After the recovery manager's worker probe, the rotation becomes
        the worker set: the recreated workers join it and the dropped ones
        leave. After a restore the old learner thread is dead (usually why
        the restore ran) or stale: stop it and start a new one around the
        restored policy. The new thread's weight versions start again, and
        every worker has the restored weights (the restore synced them),
        so the version book starts empty."""
        super().on_recovery(kind)
        if kind == "workers":
            mgr = self._sample_manager
            live = self.workers.remote_workers()
            mgr.remove_workers([w for w in mgr.workers() if w not in live], drop_in_flight=True)
            mgr.add_workers(live)
            return
        if kind != "restore":
            return
        old = self._learner_thread
        if old.is_alive():
            old.stop()
        self._learner_thread = self._new_learner_thread(disarmed=True)
        self._worker_weight_ver = {}

    def sampler_queue_depths(self) -> Dict[str, int]:
        return {"learner_in": self._learner_thread.inqueue.qsize()}

    def _feed_ready(self, lt: LearnerThread) -> None:
        """Queue the waiting train batches while the learner has room."""
        while self._train_ready:
            if not lt.add_batch(self._train_ready[0], block=False):
                return
            self._train_ready.pop(0)

    def training_step(self) -> Dict:
        """Top the workers up, harvest what is done, gather fragments
        into train batches for the learner thread, send each producing
        worker the newest published weights, and drain the learner's
        results. Timers (seconds summed over the run): ``harvest_s``
        (the wait for fragments and their unpickling), ``concat_s``,
        ``broadcast_s``; :attr:`main_spans` keeps the (start, end) of
        this step's host work outside the harvest's wait."""
        t_step = time.perf_counter()
        lt = self._learner_thread
        if not lt.is_alive():
            raise lt.error or RuntimeError("the learner thread died")
        target = int(self.config["train_batch_size"])
        if not self.workers.remote_workers():
            # num_workers 0: the local worker samples on the learner's own
            # policy, between two of the thread's steps
            collected, steps = [], 0
            while steps < target:
                with lt.lock:
                    b = self.workers.local_worker().sample()
                collected.append(b)
                steps += b.env_steps()
            batch = concat_samples(collected)
            self._counters[NUM_ENV_STEPS_SAMPLED] += batch.env_steps()
            self._counters[NUM_AGENT_STEPS_SAMPLED] += batch.env_steps()
            lt.add_batch(batch)
        else:
            self._feed_ready(lt)
            mgr = self._sample_manager
            # back-pressure: stop asking for fragments that would only
            # wait in the main process
            backlogged = len(self._train_ready) >= 4
            if not backlogged:
                mgr.submit_available()
            t0 = time.perf_counter()
            if mgr.in_flight():
                ready = mgr.get_ready(timeout=2.0)
            else:
                time.sleep(0.05)
                ready = {}
            t1 = time.perf_counter()
            self.main_spans.append((t_step, t0))
            self._timers["harvest_s"] += t1 - t0
            t_step = t1  # the host work after the harvest
            for w, items in ready.items():
                for batch in items:
                    if self._aggregators:
                        if not self._route_to_aggregator(mgr, w, batch):
                            continue
                        self._maybe_broadcast(w)
                        if not backlogged:
                            mgr.submit(worker=w)
                        continue
                    self._counters[NUM_ENV_STEPS_SAMPLED] += batch.env_steps()
                    self._counters[NUM_AGENT_STEPS_SAMPLED] += batch.env_steps()
                    self._frag_buf.append(batch)
                    self._frag_steps += batch.env_steps()
                    if self._frag_steps >= target:
                        tc = time.perf_counter()
                        self._train_ready.append(concat_samples(self._frag_buf))
                        self._timers["concat_s"] += time.perf_counter() - tc
                        self._frag_buf, self._frag_steps = [], 0
                    self._maybe_broadcast(w)
                    if not backlogged:
                        mgr.submit(worker=w)
            self._handle_dead_workers(mgr)
            self._feed_ready(lt)
        if self._agg_in_flight:
            self._collect_aggregated(lt)

        self.main_spans.append((t_step, time.perf_counter()))
        learner_info = {}
        while True:
            try:
                steps, info = lt.outqueue.get_nowait()
            except queue.Empty:
                break
            self._counters[NUM_ENV_STEPS_TRAINED] += steps
            self._counters[NUM_AGENT_STEPS_TRAINED] += steps
            learner_info = info
        return {
            DEFAULT_POLICY_ID: learner_info or lt.learner_info,
            "learner_queue": lt.stats(),
            "sample_manager": self._sample_manager.stats(),
        }

    def _route_to_aggregator(self, mgr: AsyncRequestsManager, w, ref) -> bool:
        """A harvested fragment's ref to the next aggregator, round-robin.
        The call ships the fragment at once (the ref is dropped after
        it); a crashed worker's errored ref raises here and drops that
        worker, as a harvest in values mode does. False for a dead one."""
        agg = self._aggregators[self._agg_rr % len(self._aggregators)]
        self._agg_rr += 1
        try:
            self._agg_in_flight.append(agg.aggregate.remote(ref))
        except (RayActorError, WorkerCrashedError, RayTaskError):
            mgr.report_dead(w)
            return False
        return True

    def _collect_aggregated(self, lt: LearnerThread) -> None:
        """The aggregators' answers that are in: each whole train batch
        counts as sampled and goes to the learner thread."""
        ready, _ = api.wait(self._agg_in_flight, num_returns=len(self._agg_in_flight), timeout=0)
        for ref in ready:
            self._agg_in_flight.remove(ref)
            batch = api.get(ref)
            if batch is None:
                continue
            self.num_aggregated_batches += 1
            self._counters[NUM_ENV_STEPS_SAMPLED] += batch.env_steps()
            self._counters[NUM_AGENT_STEPS_SAMPLED] += batch.env_steps()
            self._train_ready.append(batch)
        self._feed_ready(lt)

    def _handle_dead_workers(self, mgr: AsyncRequestsManager) -> None:
        """A dead worker leaves the rotation and the worker set; with
        ``recreate_failed_workers`` its replacement joins both. The loop
        never stops for it."""
        dead = mgr.take_dead_workers()
        if not dead:
            return
        self._counters["num_dead_rollout_workers"] += len(dead)
        if self.config.get("recreate_failed_workers"):
            mgr.add_workers(self.workers.replace_failed_workers(dead))
        else:
            self.workers.remove_workers(dead)

    def _maybe_broadcast(self, w) -> None:
        """Send worker ``w`` the learner thread's newest published
        weights if it has not had that version: one ``put`` a version,
        whose segment goes when the next version replaces it and the
        calls that read it have been answered."""
        pub = self._learner_thread.published_weights()
        if pub is None:
            return
        ver, host_w = pub
        if self._worker_weight_ver.get(id(w), 0) >= ver:
            return
        t0 = time.perf_counter()
        if self._weights_ref_ver != ver:
            self._weights_ref = api.put({DEFAULT_POLICY_ID: host_w})
            self._weights_ref_ver = ver
        w.set_weights.remote(self._weights_ref, {"timestep": self._counters[NUM_ENV_STEPS_SAMPLED]})
        self._worker_weight_ver[id(w)] = ver
        self._timers["broadcast_s"] += time.perf_counter() - t0

    def stop(self) -> None:
        lt = getattr(self, "_learner_thread", None)
        if lt is not None:
            lt.stop()
        self._weights_ref = None
        self._agg_in_flight = []
        for a in getattr(self, "_aggregators", []):
            api.kill(a)
        self._aggregators = []
        super().stop()
