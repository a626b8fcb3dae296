"""The multi-agent synchronous sampler.

Copy of ``ray_tpu/evaluation/multi_agent_sampler.py``: one
``MultiAgentEnv``, each agent's trajectory routed to its policy by
``policy_mapping_fn``, the fragment emitted as a ``MultiAgentBatch``
keyed by policy id.

Each env step groups the agents by policy, so a policy makes one
batched ``compute_actions`` call over its agents. The mapping fn is
asked once per agent and episode; a new fn (``set_policy_mapping_fn``)
takes effect at the next episode. An agent's rows leave its collector
when the agent is done and at the fragment's end, through its policy's
exploration and ``postprocess_trajectory`` (PPO: GAE on the host). The
episode resets when ``__all__`` is done or no agent is left, and its
``RolloutMetrics`` carry the ``(agent id, policy id)`` rewards and the
length in env steps (``episode.length // num_agents``).

What the reference's sampler does not do, this one does not either:
recurrent state (a recurrent policy raises), views beyond
the default columns, ``batch_mode``, ``horizon``,
``clip_actions`` and frame pools. ``normalize_actions`` keeps its default
(True). ``AGENT_INDEX`` is ``hash(agent_id) % 2**31``: stable for
integer ids, per process for string ids.

``timers`` adds up the seconds of the loop's parts as
``SyncSampler.timers`` does (``act_s``, ``env_s``, ``postprocess_s``)
and ``steps``, the env steps they cover.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import numpy as np

from ray_tpu_torch.data.sample_batch import MultiAgentBatch, SampleBatch, concat_samples
from ray_tpu_torch.evaluation.episode import EpisodeRecord
from ray_tpu_torch.evaluation.metrics import RolloutMetrics
from ray_tpu_torch.evaluation.sampler import (
    _EnvSlotCollector,
    postprocess_batch,
    transform_obs,
    unsquash_action,
)


class MultiAgentSyncSampler:
    def __init__(
        self,
        *,
        env,
        policy_map: Dict,
        policy_mapping_fn: Callable,
        preprocessors: Dict,
        obs_filters: Dict,
        rollout_fragment_length: int = 200,
        batch_mode: str = "truncate_episodes",
        normalize_actions: bool = True,
    ):
        recurrent = sorted(pid for pid, p in policy_map.items() if p.is_recurrent)
        if recurrent:
            raise NotImplementedError(
                f"recurrent policies {recurrent} under the multi-agent sampler: it carries no "
                "recurrent state, as the reference's carries none"
            )
        self.env = env
        self.policy_map = policy_map
        self.policy_mapping_fn = policy_mapping_fn
        self.preprocessors = preprocessors
        self.obs_filters = obs_filters
        self.frag_len = rollout_fragment_length
        self.batch_mode = batch_mode
        self.normalize_actions = normalize_actions

        self.collectors: Dict = {}  # agent id -> _EnvSlotCollector
        self.agent_policy: Dict = {}
        self.metrics_queue: List[RolloutMetrics] = []
        self.timers = {"act_s": 0.0, "env_s": 0.0, "postprocess_s": 0.0, "steps": 0}
        self.episode = EpisodeRecord()
        self._reset_env()

    def _transform(self, pid, obs):
        return transform_obs(self.preprocessors.get(pid), self.obs_filters.get(pid), obs)

    def _reset_env(self):
        raw_obs, _ = self.env.reset()
        # the mapping fn is asked again each episode
        self.agent_policy = {}
        self.cur_obs = {aid: self._transform(self._pid(aid), o) for aid, o in raw_obs.items()}
        self.episode = EpisodeRecord()

    def _pid(self, aid):
        if aid not in self.agent_policy:
            self.agent_policy[aid] = self.policy_mapping_fn(aid)
        return self.agent_policy[aid]

    def sample(self) -> MultiAgentBatch:
        out: Dict[str, List[SampleBatch]] = {}
        env_steps = 0
        while env_steps < self.frag_len:
            env_steps += 1
            self._step_once(out)
        for aid in list(self.collectors):  # the fragment's end
            self._flush_agent(aid, out, done=False)
        policy_batches = {pid: concat_samples(bs) for pid, bs in out.items() if bs}
        return MultiAgentBatch(policy_batches, env_steps)

    def _step_once(self, out):
        # the agents grouped by policy: one batched forward per policy
        by_policy: Dict[str, List] = {}
        for aid in self.cur_obs:
            by_policy.setdefault(self._pid(aid), []).append(aid)

        t0 = time.perf_counter()
        actions: Dict = {}
        extras_by_agent: Dict = {}
        for pid, aids in by_policy.items():
            obs_batch = np.stack([self.cur_obs[a] for a in aids])
            acts, _, extras = self.policy_map[pid].compute_actions(obs_batch)
            for j, aid in enumerate(aids):
                actions[aid] = acts[j]
                extras_by_agent[aid] = {k: np.asarray(v[j]) for k, v in extras.items()}
        t1 = time.perf_counter()

        env_actions = {
            aid: (unsquash_action(a, self.policy_map[self._pid(aid)].action_space)
                  if self.normalize_actions else a)
            for aid, a in actions.items()
        }
        next_obs, rewards, terms, truncs, _ = self.env.step(env_actions)
        self.timers["act_s"] += t1 - t0
        self.timers["env_s"] += time.perf_counter() - t1
        self.timers["steps"] += 1
        all_done = terms.get("__all__", False) or truncs.get("__all__", False)

        for aid in actions:
            pid = self._pid(aid)
            term = bool(terms.get(aid, False))
            trunc = bool(truncs.get(aid, False))
            has_next = aid in next_obs
            t_obs = self._transform(pid, next_obs[aid]) if has_next else self.cur_obs[aid]
            coll = self.collectors.setdefault(aid, _EnvSlotCollector())
            coll.add({
                SampleBatch.OBS: self.cur_obs[aid],
                SampleBatch.NEXT_OBS: t_obs,
                SampleBatch.ACTIONS: np.asarray(actions[aid]),
                SampleBatch.REWARDS: np.float32(rewards.get(aid, 0.0)),
                SampleBatch.TERMINATEDS: np.bool_(term or all_done),
                SampleBatch.TRUNCATEDS: np.bool_(trunc),
                SampleBatch.EPS_ID: np.int64(self.episode.episode_id),
                SampleBatch.AGENT_INDEX: np.int64(hash(aid) % (2**31)),
                **extras_by_agent[aid],
            })
            self.episode.add(float(rewards.get(aid, 0.0)), aid)
            if term or trunc or all_done:
                self._flush_agent(aid, out, done=True)
                self.cur_obs.pop(aid, None)
            elif has_next:
                self.cur_obs[aid] = t_obs

        for aid, o in next_obs.items():
            if (aid not in self.cur_obs and not (terms.get(aid, False) or truncs.get(aid, False))
                    and not all_done):
                self.cur_obs[aid] = self._transform(self._pid(aid), o)

        if all_done or not self.cur_obs:
            self.metrics_queue.append(RolloutMetrics(
                self.episode.length // max(1, len(self.agent_policy)),
                self.episode.total_reward,
                {(aid, self._pid(aid)): r for aid, r in self.episode.agent_rewards.items()},
            ))
            self._reset_env()

    def _flush_agent(self, aid, out, done: bool):
        coll = self.collectors.get(aid)
        if coll is None or coll.count == 0:
            return
        t0 = time.perf_counter()
        pid = self._pid(aid)
        batch = postprocess_batch(self.policy_map[pid], coll.flush())
        out.setdefault(pid, []).append(batch)
        if done:
            self.collectors.pop(aid, None)
        self.timers["postprocess_s"] += time.perf_counter() - t0

    def get_metrics(self) -> List[RolloutMetrics]:
        out, self.metrics_queue = self.metrics_queue, []
        return out
