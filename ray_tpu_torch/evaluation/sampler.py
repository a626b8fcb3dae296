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

Not ported (``ROADMAP.md`` queue 1 item 3): ``AsyncSampler``, the
``ViewCollector`` of extra view requirements (shifted columns such as
``prev_actions``), recurrent state and callbacks. A policy that asks for
the first three raises here; callbacks raise in ``Algorithm``.

``timers`` adds up the seconds of the loop's parts (``act_s``: the
policy's ``compute_actions``; ``env_s``: the vector env's step;
``postprocess_s``: postprocessing and compression) and ``steps``, the
env steps they cover.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from ray_tpu_torch.data.sample_batch import SampleBatch, concat_samples
from ray_tpu_torch.evaluation.episode import EpisodeRecord
from ray_tpu_torch.evaluation.metrics import RolloutMetrics

# the columns every policy's sampler collects (the reference's default
# view requirements); anything more needs the ViewCollector
DEFAULT_VIEWS = frozenset((
    SampleBatch.OBS, SampleBatch.ACTIONS, SampleBatch.REWARDS,
    SampleBatch.TERMINATEDS, SampleBatch.TRUNCATEDS, SampleBatch.EPS_ID,
))
_SHIFTED_VIEW_KEYS = ("use_prev_action", "use_prev_reward",
                      "lstm_use_prev_action", "lstm_use_prev_reward")


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


def check_ported_views(policy) -> None:
    """Raise for a policy whose sampling needs what is not ported."""
    extra = set(getattr(policy, "view_requirements", None) or ()) - DEFAULT_VIEWS
    mc = getattr(policy, "model_config", None) or {}
    extra |= {k for k in _SHIFTED_VIEW_KEYS if mc.get(k)}
    if extra:
        raise NotImplementedError(
            f"view requirements beyond the defaults ({sorted(extra)}) need the "
            "ViewCollector, which is not ported yet: ROADMAP.md queue 1 item 3"
        )
    if policy.get_initial_state():
        raise NotImplementedError(
            "recurrent policies on the actor lane are not ported yet: ROADMAP.md "
            "queue 1 item 8.7"
        )


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
        flush_on_episode_end: bool = True,
    ):
        check_ported_views(policy)
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
        self.flush_on_episode_end = flush_on_episode_end

        n = self.env.num_envs
        self.collectors = [_EnvSlotCollector() for _ in range(n)]
        self.episodes = [EpisodeRecord() for _ in range(n)]
        self.metrics_queue: List[RolloutMetrics] = []
        self.unroll_id = 0
        self.timers = {"act_s": 0.0, "env_s": 0.0, "postprocess_s": 0.0, "steps": 0}

        raw_obs, _ = self.env.vector_reset()
        self.cur_obs = [self._transform(o) for o in raw_obs]

    def _transform(self, obs):
        return transform_obs(self.preprocessor, self.obs_filter, obs)

    # -- main loop -------------------------------------------------------

    def sample(self) -> SampleBatch:
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
        return concat_samples(batches) if batches else SampleBatch()

    def _step_once(self, out: List[SampleBatch]) -> None:
        n = self.env.num_envs
        t0 = time.perf_counter()
        actions, _, extras = self.policy.compute_actions(np.stack(self.cur_obs), None, explore=True)
        t1 = time.perf_counter()
        space = self.env.action_space
        if self.normalize_actions:
            env_actions = [unsquash_action(a, space) for a in actions]
        elif self.clip_actions:
            env_actions = [clip_action(a, space) for a in actions]
        else:
            env_actions = list(actions)
        next_obs, rewards, terms, truncs, _ = self.env.vector_step(env_actions)
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
            self.collectors[i].add(row)
            self.episodes[i].add(float(rewards[i]))

            ep_done = terms[i] or truncs[i]
            if self.horizon and self.episodes[i].length >= self.horizon:
                # after the row: the row keeps the env's TRUNCATEDS
                ep_done = True
            if ep_done:
                if self.flush_on_episode_end:
                    self._flush_slot(i, out)
                self.metrics_queue.append(
                    RolloutMetrics(self.episodes[i].length, self.episodes[i].total_reward)
                )
                self.episodes[i] = EpisodeRecord()
                raw, _ = self.env.reset_at(i)
                self.cur_obs[i] = self._transform(raw)
            else:
                self.cur_obs[i] = t_obs

    def _flush_slot(self, i: int, out: List[SampleBatch]) -> None:
        if self.collectors[i].count == 0:
            return
        t0 = time.perf_counter()
        batch = self.collectors[i].flush()
        batch[SampleBatch.UNROLL_ID] = np.full(batch.count, self.unroll_id, np.int64)
        self.unroll_id += 1
        batch = postprocess_batch(self.policy, batch)
        # shrink the fragment before it leaves the worker (the frame
        # pool; policies opt in through compress_for_shipping)
        compress = getattr(self.policy, "compress_for_shipping", None)
        if compress is not None:
            batch = compress(batch)
        out.append(batch)
        self.timers["postprocess_s"] += time.perf_counter() - t0

    def get_metrics(self) -> List[RolloutMetrics]:
        out, self.metrics_queue = self.metrics_queue, []
        return out
