"""Ape-X DQN: distributed prioritized replay over device shards.

Counterpart of ``ray_tpu/algorithms/apex_dqn/apex_dqn.py``, on its
device plane (``replay_device_resident`` on, the port's only plane):
rollout workers, each exploring at its rung of the per-worker epsilon
ladder (``per_worker_exploration``: ``dqn._epsilon_exploration_config``),
feed ``num_replay_buffer_shards`` :class:`DevicePrioritizedReplayBuffer`
rings of ``capacity // num_replay_buffer_shards`` rows on the learner's
device, seeded ``seed + 100 + i``, as the reference's shards are.

A round (:meth:`ApexDQN.training_step`, the reference's ``:272-408``):

- every remote worker is kept at ``max_sample_requests_in_flight_per_worker``
  sample requests; ``core.wait(num_returns=1, timeout=1.0)`` takes the
  fragments that are done;
- each fragment is routed (:meth:`ApexDQN._route_to_replay`): frame
  pools back to stacks, the n-step fold, its replay columns to the
  device once, and the insert into the next shard, round-robin (one
  row-scatter launch a column and one for the tree's leaves), at the
  shard's max priority or, with ``worker_side_prioritization``, at the
  rows' TD errors computed on the uploaded columns;
- a worker gets the learner's weights after every ``broadcast_interval``
  of its fragments;
- once ``num_steps_sampled_before_learning_starts`` env steps are in,
  every shard holding a batch gets one learn pass
  (:meth:`ApexDQN._learn_from_device_shards`): under a superstep K > 1
  (``"auto"``: 8 on the card) one ``superstep_train_replay`` of K
  prioritized updates (each slot's prefix descent and row gathers in
  the graph, the priorities refreshed in update order), else one draw
  (prefix-descent kernel, row gathers), one learn call and the |TD|
  refresh; the target network syncs every ``target_network_update_freq``
  trained steps, checked after each shard.

With no remote worker the local worker samples a fragment a round and
the weights go out by ``sync_weights``, as the reference's degenerate
mode.

Refused: ``replay_device_resident=False`` (the reference's object plane
of ``ReplayActor`` shards over host rings) raises in
``resolve_device_resident``, and the registry's ``APEX_DDPG``, both
naming ``ROADMAP.md`` queue 1 item 4b.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional

from ray_tpu_torch import core
from ray_tpu_torch.algorithms.algorithm import (
    NUM_ENV_STEPS_SAMPLED,
    NUM_ENV_STEPS_TRAINED,
    Algorithm,
)
from ray_tpu_torch.algorithms.dqn.dqn import DQN, DQNConfig, adjust_nstep
from ray_tpu_torch.core.object_store import RayActorError, WorkerCrashedError
from ray_tpu_torch.data.sample_batch import DEFAULT_POLICY_ID, MultiAgentBatch, SampleBatch
from ray_tpu_torch.execution.replay_buffer import (
    DevicePrioritizedReplayBuffer,
    DeviceTrainBatch,
    resolve_device_resident,
    resolve_device_tree,
)
from ray_tpu_torch.execution.train_ops import superstep_train_replay
from ray_tpu_torch.ops.framestack import FRAMES, materialize_fragment


class ApexDQNConfig(DQNConfig):
    """The reference's ``ApexDQNConfig`` defaults (``apex_dqn.py:91-128``)."""

    def __init__(self, algo_class=None):
        super().__init__(algo_class or ApexDQN)
        self.num_workers = 4
        self.num_replay_buffer_shards = 2
        self.per_worker_exploration = True
        self.worker_side_prioritization = False
        self.n_step = 3
        self.train_batch_size = 512
        self.rollout_fragment_length = 50
        self.target_network_update_freq = 2500
        self.num_steps_sampled_before_learning_starts = 1000
        self.max_sample_requests_in_flight_per_worker = 2
        self.broadcast_interval = 1
        self.replay_buffer_config = {
            "capacity": 100000,
            "prioritized_replay": True,
            "prioritized_replay_alpha": 0.6,
            "prioritized_replay_beta": 0.4,
        }

    def training(
        self,
        *,
        num_replay_buffer_shards: Optional[int] = None,
        per_worker_exploration: Optional[bool] = None,
        **kwargs,
    ) -> "ApexDQNConfig":
        super().training(**kwargs)
        if num_replay_buffer_shards is not None:
            self.num_replay_buffer_shards = num_replay_buffer_shards
        if per_worker_exploration is not None:
            self.per_worker_exploration = per_worker_exploration
        return self


class ApexDQN(DQN):
    _learns_under_act_lock = False  # the shards' updates run outside it
    @classmethod
    def get_default_config(cls) -> ApexDQNConfig:
        return ApexDQNConfig(cls)

    def __init__(self, config=None, env=None):
        super().__init__(config, env)
        cfg = self.config
        if cfg.get("policies"):
            raise ValueError("Ape-X learns the default policy alone (the reference's "
                             "shards hold its batches only)")
        resolve_device_resident(cfg)
        resolve_device_tree(cfg)
        rb = cfg.get("replay_buffer_config") or {}
        n_shards = max(1, int(cfg.get("num_replay_buffer_shards", 2)))
        per_shard = max(1, int(rb.get("capacity", 100000)) // n_shards)
        seed = cfg.get("seed")
        self._replay_beta = rb.get("prioritized_replay_beta", 0.4)
        # the shards replace DQN's one buffer, as the reference's
        self.local_replay_buffer = None
        self.replay_shards: List[DevicePrioritizedReplayBuffer] = [
            DevicePrioritizedReplayBuffer(
                per_shard,
                rb.get("prioritized_replay_alpha", 0.6),
                None if seed is None else seed + 100 + i,
                device=self.device,
                memory_cap_bytes=cfg.get("replay_memory_cap_bytes"),
                label=f"apex_shard_{i}",
            )
            for i in range(n_shards)
        ]
        self._sample_in_flight: Dict = {}  # ref -> worker
        self._shard_rr = 0
        self._batches_since_broadcast: Dict[int, int] = {}

    # -- routing -----------------------------------------------------------

    def _route_to_replay(self, batch: SampleBatch) -> None:
        """A fragment into the next shard, round-robin: frame pools back
        to stacks, the n-step fold, its replay columns to the device once
        (the same tensors feed the TD errors of
        ``worker_side_prioritization``), then the insert at those
        priorities or at the shard's max."""
        cfg = self.config
        policy = self.get_policy()
        if FRAMES in batch:
            k = int(policy.observation_space.shape[-1])
            batch = SampleBatch(materialize_fragment(dict(batch), k))
        n_step = int(cfg.get("n_step", 1))
        if n_step > 1:
            adjust_nstep(n_step, cfg["gamma"], batch)
        shard = self.replay_shards[self._shard_rr % len(self.replay_shards)]
        self._shard_rr += 1
        tree = {c: shard._to_device(v) for c, v in policy.replay_columns(batch).items()}
        prios = None
        if cfg.get("worker_side_prioritization"):
            n = int(next(iter(tree.values())).shape[0])
            prios = policy.compute_td_error(DeviceTrainBatch(tree, n)) + 1e-6
        shard.add_device_tree(tree, priorities=prios)

    # -- the round -----------------------------------------------------------

    def training_step(self) -> Dict:
        """Sample requests topped up, the done fragments routed and the
        producing workers' weights refreshed, then a learn pass over the
        shards. ``self._timers`` adds up ``sample_s`` (the wait),
        ``insert_s`` (routing), ``update_s`` (learning) and
        ``broadcast_s``."""
        cfg = self.config
        workers = self.workers.remote_workers()
        policy = self.get_policy()
        timers = self._timers
        train_info: Dict = {}
        t0 = time.perf_counter()
        if workers:
            cap = int(cfg.get("max_sample_requests_in_flight_per_worker", 2))
            counts = collections.Counter(id(w) for w in self._sample_in_flight.values())
            for w in workers:
                for _ in range(cap - counts[id(w)]):
                    self._sample_in_flight[w.sample.remote()] = w
            ready, _ = core.wait(list(self._sample_in_flight), num_returns=1, timeout=1.0)
            timers["sample_s"] += time.perf_counter() - t0
            weights_ref = None
            for ref in ready:
                w = self._sample_in_flight.pop(ref)
                try:
                    batch = core.get(ref)
                except (RayActorError, WorkerCrashedError):
                    continue
                t1 = time.perf_counter()
                self._counters[NUM_ENV_STEPS_SAMPLED] += batch.env_steps()
                if isinstance(batch, MultiAgentBatch):
                    batch = batch.policy_batches[DEFAULT_POLICY_ID]
                self._route_to_replay(batch)
                t2 = time.perf_counter()
                timers["insert_s"] += t2 - t1
                k = id(w)
                self._batches_since_broadcast[k] = self._batches_since_broadcast.get(k, 0) + 1
                if self._batches_since_broadcast[k] >= int(cfg.get("broadcast_interval", 1)):
                    if weights_ref is None:
                        weights_ref = core.put(self.workers.local_worker().get_weights())
                    w.set_weights.remote(
                        weights_ref, {"timestep": self._counters[NUM_ENV_STEPS_SAMPLED]})
                    self._batches_since_broadcast[k] = 0
                timers["broadcast_s"] += time.perf_counter() - t2
        else:
            batch = self.workers.local_worker().sample()
            t1 = time.perf_counter()
            timers["sample_s"] += t1 - t0
            self._counters[NUM_ENV_STEPS_SAMPLED] += batch.env_steps()
            if isinstance(batch, MultiAgentBatch):
                batch = batch.policy_batches[DEFAULT_POLICY_ID]
            self._route_to_replay(batch)
            timers["insert_s"] += time.perf_counter() - t1

        if self._counters[NUM_ENV_STEPS_SAMPLED] >= cfg.get(
            "num_steps_sampled_before_learning_starts", 0
        ):
            t1 = time.perf_counter()
            info = self._learn_from_device_shards(policy)
            timers["update_s"] += time.perf_counter() - t1
            if info:
                train_info = info
        if not workers:
            self.workers.sync_weights(
                global_vars={"timestep": self._counters[NUM_ENV_STEPS_SAMPLED]})
        policy.global_timestep = self._counters[NUM_ENV_STEPS_SAMPLED]
        return train_info

    def _maybe_update_target(self, policy) -> None:
        if (self._counters[NUM_ENV_STEPS_TRAINED] - self._last_target_update
                >= self.config.get("target_network_update_freq", 2500)):
            policy.update_target()
            self._last_target_update = self._counters[NUM_ENV_STEPS_TRAINED]
            self._counters["num_target_updates"] += 1

    def _learn_from_device_shards(self, policy) -> Dict:
        """One learn pass a shard holding a batch: K prioritized updates
        as one ``superstep_train_replay`` under a superstep K > 1, else
        one sample, learn and |TD| refresh; the target check after each
        shard."""
        bs = int(self.config["train_batch_size"])
        K = self._resolve_superstep_k()
        train_info: Dict = {}
        for shard in self.replay_shards:
            if len(shard) < bs:
                continue
            if K > 1:
                info = superstep_train_replay(self, policy, shard, K, K, bs, prioritized=True,
                                              beta=self._replay_beta)
                self._counters[NUM_ENV_STEPS_TRAINED] += K * bs
            else:
                batch = shard.sample(bs, beta=self._replay_beta)
                info = policy.learn_on_device_batch(dict(batch.tree), batch.count)
                self._counters[NUM_ENV_STEPS_TRAINED] += batch.count
                shard.update_priorities(batch.indices, policy.compute_td_error(batch) + 1e-6)
            train_info[DEFAULT_POLICY_ID] = info
            self._maybe_update_target(policy)
        return train_info

    # -- lifetime and state ----------------------------------------------------

    def stop(self) -> None:
        # the fragments still on their way were sampled for this run alone
        self._sample_in_flight = {}
        super().stop()

    def __getstate__(self) -> Dict:
        state = Algorithm.__getstate__(self)
        state["replay_shards"] = [s.get_state() for s in self.replay_shards]
        state["shard_rr"] = self._shard_rr
        state["last_target_update"] = self._last_target_update
        return state

    def __setstate__(self, state: Dict) -> None:
        Algorithm.__setstate__(self, state)
        self._sample_in_flight = {}
        for shard, s in zip(self.replay_shards, state.get("replay_shards", [])):
            shard.set_state(s)
        self._shard_rr = int(state.get("shard_rr", 0))
        self._last_target_update = state.get("last_target_update", 0)

