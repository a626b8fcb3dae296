"""The actor lane's rollout loop: ``SyncSampler``.

Counterpart of ``ray_tpu/evaluation/sampler.py:88-368``. The loop is
batched across a vector env: one ``policy.compute_actions`` call per
step covers every sub-env (on the CPU in a remote worker, on the card in
the local worker of a ``num_workers: 0`` run); actions fan back out to
the envs, and one collector per env slot assembles fixed-length
fragments (``truncate_episodes``) or whole episodes
(``complete_episodes``). A fragment leaves the slot with its
``UNROLL_ID``, is postprocessed (the exploration's, then the policy's:
GAE for PPO) and compressed for shipping (``compress_for_shipping``:
the frame pool of a stacked pixel fragment).

The terminal observation follows the vector env's contract
(``env/vector_env.py``): a done row keeps the final observation as its
NEXT_OBS, and the reset observation becomes the slot's next OBS.

``flush_on_episode_end=False`` gives the fixed unrolls of the IMPALA
family (the rollout worker sets it from the config's ``_fixed_unrolls``):
a slot's fragment is exactly ``rollout_fragment_length`` steps and may
span an episode reset, whose done row marks it inside the fragment.

Continuous actions: with ``normalize_actions`` (the default) the env
gets ``unsquash_action`` of the policy's action (clipped to [-1, 1],
then mapped onto the Box's bounds); with ``clip_actions`` instead, the
action clipped to the bounds. The batch keeps the policy's own actions.
``episode_horizon`` ends an episode at that many steps, in the
reference's order: the row is recorded first, as the env returned it,
so the cut row keeps its ``TRUNCATEDS`` (False unless the env truncated
too) and only the slot ends its episode and resets.

Views: a policy that declares ``PREV_ACTIONS`` or ``PREV_REWARDS``
(``use_prev_action`` / ``use_prev_reward`` in its model config) gets
them as the sampler's prev-1 shortcuts, in the row and as
``prev_action_batch`` / ``prev_reward_batch`` of ``compute_actions``,
zero at an episode's start; every other view it declares with a
``data_col`` comes from the ``ViewCollector``
(``evaluation/view_collector.py``), for compute time as keyword
arguments and for training as row columns.

Callbacks (``algorithms/callbacks.py``), at the reference's sites:
``on_episode_start`` for every slot at construction (before the first
reset) and for a slot's new episode before its reset;
``on_episode_step`` after each row, with the episode's ``last_info``
set to the env's info; ``on_episode_end`` before the slot's flush; and
``on_sample_end`` on the concatenated batch. An episode's
``custom_metrics`` go into its ``RolloutMetrics``. A raising callback
fails the sample, as in the reference.

Recurrent policies: each env slot carries its state. A step's
``compute_actions`` gets the slots' states stacked, each row records the
state it was acted from as ``state_in_k`` (a copy of its own, sharing no
memory with the policy's output), the slot's state advances to the
step's ``state_out`` and restarts from the initial state when the
episode ends; a flushed fragment carries the state after its last step
as ``batch.last_state_out``, which GAE's bootstrap reads
(``postprocessing.py``).

:class:`AsyncSampler` (``sample_async``) runs a ``SyncSampler`` on a
daemon thread that queues up to ``queue_size`` fragments; ``sample()``
pops one. The reference calls its weight swaps atomic because its
arrays are immutable; here ``set_weights`` copies into the module in
place, so the thread acts and postprocesses under the sampler's
:attr:`AsyncSampler.lock`, which a weight or global-vars write takes
too: every step's forward reads one whole weight set. Once the thread
runs, it alone draws from the policy's generator.

``timers`` adds up the seconds of the loop's parts (``act_s``: the
policy's ``compute_actions``; ``env_s``: the vector env's step;
``postprocess_s``: postprocessing and compression) and ``steps``, the
env steps they cover.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ray_tpu_torch.data.sample_batch import SampleBatch, concat_samples
from ray_tpu_torch.evaluation.episode import EpisodeRecord
from ray_tpu_torch.evaluation.metrics import RolloutMetrics
from ray_tpu_torch.evaluation.view_collector import ViewCollector
from ray_tpu_torch.util import tracing


class _EnvSlotCollector:
    """One env slot's rows until its fragment is flushed."""

    def __init__(self):
        self.columns: Dict[str, List] = {}
        self.count = 0

    def add(self, row: Dict):
        for k, v in row.items():
            self.columns.setdefault(k, []).append(v)
        self.count += 1

    def flush(self) -> SampleBatch:
        batch = SampleBatch({k: np.stack(v) for k, v in self.columns.items()})
        self.columns = {}
        self.count = 0
        return batch


def _bounded_box(space) -> bool:
    """A Box (duck-typed: bounds, no ``n``) with finite lower bounds."""
    low = getattr(space, "low", None)
    return getattr(space, "n", None) is None and low is not None and bool(np.all(np.isfinite(low)))


def unsquash_action(action, space):
    """A [-1, 1]-normalised action mapped onto a Box's bounds (the
    reference's ``unsquash_action``); any other space passes it as is."""
    if _bounded_box(space):
        a = np.clip(action, -1.0, 1.0)
        return space.low + (a + 1.0) * (space.high - space.low) / 2.0
    return action


def clip_action(action, space):
    """An action clipped to a Box's bounds (the reference's ``clip_action``)."""
    if getattr(space, "n", None) is None and getattr(space, "low", None) is not None:
        return np.clip(action, space.low, space.high)
    return action


def transform_obs(preprocessor, obs_filter, obs):
    """Preprocessor (one-hot, flatten), then the observation filter."""
    if preprocessor is not None:
        obs = preprocessor.transform(obs)
    if obs_filter is not None:
        obs = obs_filter(obs)
    return np.asarray(obs)


def postprocess_batch(policy, batch):
    """The exploration's postprocessing first, then the policy's own."""
    expl = getattr(policy, "exploration", None)
    if expl is not None:
        batch = expl.postprocess_trajectory(policy, batch)
    return policy.postprocess_trajectory(batch)


class SyncSampler:
    def __init__(
        self,
        *,
        vector_env,
        policy,
        preprocessor=None,
        obs_filter=None,
        rollout_fragment_length: int = 200,
        batch_mode: str = "truncate_episodes",
        episode_horizon: Optional[int] = None,
        clip_actions: bool = False,
        normalize_actions: bool = True,
        callbacks=None,
        flush_on_episode_end: bool = True,
    ):
        if not flush_on_episode_end and batch_mode != "truncate_episodes":
            raise ValueError("fixed unrolls (flush_on_episode_end=False) need "
                             "batch_mode='truncate_episodes'")
        self.env = vector_env
        self.policy = policy
        self.preprocessor = preprocessor
        self.obs_filter = obs_filter
        self.frag_len = rollout_fragment_length
        self.batch_mode = batch_mode
        self.horizon = episode_horizon
        self.clip_actions = clip_actions
        self.normalize_actions = normalize_actions
        self.callbacks = callbacks
        self.flush_on_episode_end = flush_on_episode_end

        n = self.env.num_envs
        self.collectors = [_EnvSlotCollector() for _ in range(n)]
        self.episodes = [EpisodeRecord() for _ in range(n)]
        if self.callbacks is not None:
            for i in range(n):
                self._cb("on_episode_start", i)
        self.metrics_queue: List[RolloutMetrics] = []
        self._metrics_lock = threading.Lock()
        # held around each read of the policy's parameters (the act step,
        # postprocessing); AsyncSampler makes it a real lock
        self.act_lock = contextlib.nullcontext()
        self.unroll_id = 0
        self.timers = {"act_s": 0.0, "env_s": 0.0, "postprocess_s": 0.0, "steps": 0}

        raw_obs, _ = self.env.vector_reset()
        self.cur_obs = [self._transform(o) for o in raw_obs]
        init_state = self.policy.get_initial_state()
        self._has_state = bool(init_state)
        self.states = [[s.copy() for s in init_state] for _ in range(n)]
        # the prev-1 shortcut columns, when the policy declares them
        vr = getattr(self.policy, "view_requirements", None) or {}
        self._want_prev_actions = SampleBatch.PREV_ACTIONS in vr
        self._want_prev_rewards = SampleBatch.PREV_REWARDS in vr
        self._prev_actions = [None] * n
        self._prev_rewards = [np.float32(0.0)] * n
        self._views = ViewCollector(vr, n)

    def _transform(self, obs):
        return transform_obs(self.preprocessor, self.obs_filter, obs)

    def _cb(self, hook: str, env_index: int) -> None:
        """One episode hook of the user's callbacks for slot ``env_index``."""
        getattr(self.callbacks, hook)(
            worker=None, base_env=self.env, policies={"default_policy": self.policy},
            episode=self.episodes[env_index], env_index=env_index,
        )

    # -- main loop -------------------------------------------------------

    def sample(self) -> SampleBatch:
        # on a remote worker this parents under the call's
        # "actor:RolloutWorker.sample" span (core/worker_proc.py)
        with tracing.start_span("sampler:collect"):
            return self._sample()

    def _sample(self) -> SampleBatch:
        n = self.env.num_envs
        out: List[SampleBatch] = []
        if self.batch_mode == "truncate_episodes":
            for _ in range(self.frag_len):
                self._step_once(out)
            for i in range(n):
                self._flush_slot(i, out)
        else:  # complete_episodes
            target = self.frag_len * n
            steps = 0
            while steps < target or any(c.count > 0 for c in self.collectors):
                self._step_once(out)
                steps += n
                if steps >= target and not any(c.count > 0 for c in self.collectors):
                    break
        batches = [b for b in out if b.count > 0]
        result = concat_samples(batches) if batches else SampleBatch()
        if self.callbacks is not None:
            self.callbacks.on_sample_end(worker=None, samples=result)
        return result

    def _step_once(self, out: List[SampleBatch]) -> None:
        n = self.env.num_envs
        t0 = time.perf_counter()
        state_batches = None
        if self._has_state:
            state_batches = [np.stack([st[k] for st in self.states])
                             for k in range(len(self.states[0]))]
        with self.act_lock:
            actions, state_out, extras = self.policy.compute_actions(
                np.stack(self.cur_obs), state_batches, explore=True, **self._compute_views()
            )
        t1 = time.perf_counter()
        space = self.env.action_space
        if self.normalize_actions:
            env_actions = [unsquash_action(a, space) for a in actions]
        elif self.clip_actions:
            env_actions = [clip_action(a, space) for a in actions]
        else:
            env_actions = list(actions)
        next_obs, rewards, terms, truncs, infos = self.env.vector_step(env_actions)
        self.timers["act_s"] += t1 - t0
        self.timers["env_s"] += time.perf_counter() - t1
        self.timers["steps"] += n
        for i in range(n):
            t_obs = self._transform(next_obs[i])
            row = {
                SampleBatch.OBS: self.cur_obs[i],
                SampleBatch.NEXT_OBS: t_obs,
                SampleBatch.ACTIONS: np.asarray(actions[i]),
                SampleBatch.REWARDS: np.float32(rewards[i]),
                SampleBatch.TERMINATEDS: np.bool_(terms[i]),
                SampleBatch.TRUNCATEDS: np.bool_(truncs[i]),
                SampleBatch.EPS_ID: np.int64(self.episodes[i].episode_id),
                SampleBatch.AGENT_INDEX: np.int64(i),
                SampleBatch.T: np.int64(self.episodes[i].length),
            }
            for k, v in extras.items():
                row[k] = np.asarray(v[i])
            if self._has_state:
                for k, st in enumerate(self.states[i]):
                    row[f"state_in_{k}"] = st
                self.states[i] = [np.array(s[i]) for s in state_out]
            if self._want_prev_actions:
                row[SampleBatch.PREV_ACTIONS] = (
                    np.zeros_like(np.asarray(actions[i]))
                    if self._prev_actions[i] is None
                    else self._prev_actions[i]
                )
                self._prev_actions[i] = np.asarray(actions[i])
            if self._want_prev_rewards:
                row[SampleBatch.PREV_REWARDS] = self._prev_rewards[i]
                self._prev_rewards[i] = np.float32(rewards[i])
            if self._views.active:
                self._views.annotate_row(i, row)
            self.collectors[i].add(row)
            self.episodes[i].add(float(rewards[i]))
            if self.callbacks is not None:
                self.episodes[i].last_info = infos[i] or {}
                self._cb("on_episode_step", i)

            ep_done = terms[i] or truncs[i]
            if self.horizon and self.episodes[i].length >= self.horizon:
                # after the row: the row keeps the env's TRUNCATEDS
                ep_done = True
            if ep_done:
                self._prev_actions[i] = None
                self._prev_rewards[i] = np.float32(0.0)
                if self._views.active:
                    self._views.reset_env(i)
                if self.callbacks is not None:
                    self._cb("on_episode_end", i)
                if self.flush_on_episode_end:
                    self._flush_slot(i, out)
                ep = self.episodes[i]
                with self._metrics_lock:
                    self.metrics_queue.append(RolloutMetrics(
                        ep.length, ep.total_reward, custom_metrics=dict(ep.custom_metrics)
                    ))
                self.episodes[i] = EpisodeRecord()
                if self.callbacks is not None:
                    self._cb("on_episode_start", i)
                raw, _ = self.env.reset_at(i)
                self.cur_obs[i] = self._transform(raw)
                if self._has_state:
                    self.states[i] = [s.copy() for s in self.policy.get_initial_state()]
            else:
                self.cur_obs[i] = t_obs

    def _compute_views(self) -> Dict[str, np.ndarray]:
        """This step's view arguments of ``compute_actions``: the prev-1
        shortcuts (zeros at an episode's start) and the collector's
        compute-time views, stacked over the env slots."""
        out = {}
        if self._want_prev_actions:
            shape = self.env.action_space.shape
            zero = np.zeros(shape or (), np.float32 if shape else np.int64)
            out["prev_action_batch"] = np.stack(
                [zero if a is None else a for a in self._prev_actions]
            )
        if self._want_prev_rewards:
            out["prev_reward_batch"] = np.asarray(self._prev_rewards, np.float32)
        if self._views.active:
            per_env = [
                self._views.compute_action_views(i, {SampleBatch.OBS: self.cur_obs[i]})
                for i in range(self.env.num_envs)
            ]
            for k in per_env[0]:
                out[k] = np.stack([pe[k] for pe in per_env])
        return out

    def _flush_slot(self, i: int, out: List[SampleBatch]) -> None:
        if self.collectors[i].count == 0:
            return
        t0 = time.perf_counter()
        batch = self.collectors[i].flush()
        batch[SampleBatch.UNROLL_ID] = np.full(batch.count, self.unroll_id, np.int64)
        self.unroll_id += 1
        if self._has_state:
            # the state after the fragment's last step, for GAE's bootstrap
            # (no per-row state_out column)
            batch.last_state_out = [np.asarray(s) for s in self.states[i]]
        with self.act_lock, tracing.start_span("sampler:postprocess", env_index=i,
                                               rows=batch.count):
            batch = postprocess_batch(self.policy, batch)
        # shrink the fragment before it leaves the worker (the frame
        # pool; policies opt in through compress_for_shipping)
        compress = getattr(self.policy, "compress_for_shipping", None)
        if compress is not None:
            batch = compress(batch)
        out.append(batch)
        self.timers["postprocess_s"] += time.perf_counter() - t0

    def get_metrics(self) -> List[RolloutMetrics]:
        with self._metrics_lock:
            out, self.metrics_queue = self.metrics_queue, []
        return out


class AsyncSampler:
    """A ``SyncSampler`` on a daemon thread (the reference's
    ``sampler.py:371-426``): it samples without pause and queues up to
    ``queue_size`` fragments; :meth:`sample` pops the next one. An error
    in the thread comes back on the next :meth:`sample`; :meth:`stop`
    ends and joins the thread. :attr:`lock` is the act step's
    (``SyncSampler.act_lock``): hold it to write the policy's weights."""

    def __init__(self, *, queue_size: int = 8, **sync_kwargs):
        self._sync = SyncSampler(**sync_kwargs)
        self.policy = self._sync.policy
        self.lock = threading.Lock()
        self._sync.act_lock = self.lock
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True, name="async_sampler")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                batch = self._sync.sample()
            except Exception as e:  # surfaced by the next sample()
                self._error = e
                return
            while not self._stop.is_set():
                try:
                    self._queue.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def sample(self) -> SampleBatch:
        while True:
            if self._error is not None:
                raise self._error
            try:
                return self._queue.get(timeout=1.0)
            except queue.Empty:
                if not self._thread.is_alive() and self._error is None:
                    raise RuntimeError("the async sampler thread died")

    def get_metrics(self) -> List[RolloutMetrics]:
        return self._sync.get_metrics()

    def stop(self, join_timeout: float = 5.0) -> None:
        self._stop.set()
        if self._thread.is_alive() and threading.current_thread() is not self._thread:
            self._thread.join(timeout=join_timeout)
