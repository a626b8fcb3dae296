"""Trajectory views of the port against the reference's, on the CPU.

Contracts, all bitwise (host numpy code on the same inputs):

- ``SyncSampler`` with views: one scripted view policy, written once and
  built on each package's ``Policy`` and ``ViewRequirement``, declares
  a ``"-2:0"`` obs window (compute and train time), a train-only action
  at shift -2, and the prev-1 shortcuts ``prev_actions`` and
  ``prev_rewards``. Both samplers drive it over two envs whose episodes
  have different lengths (actions from a seeded stream): every column
  of every fragment, and every compute-time argument the policy was
  handed, agree;
- the reference's five oracles (``tests/test_trajectory_view.py``)
  mirrored on the port: zero-fill and order of a window, a single
  negative shift, compute-time views equal train-time views, no view
  crossing an episode boundary, and no collector work for a policy
  without custom views;
- ``PPOTorchPolicy`` with ``use_prev_action`` and ``use_prev_reward`` on
  the port's ``CartPole-v1``: ``prev_actions`` and ``prev_rewards`` are
  the actions and rewards shifted by one within each episode, zero at
  each episode's start; a recurrent policy still raises under the
  multi-agent sampler, whose reference carries no state.
"""

from __future__ import annotations

import random

import gymnasium as gym
import numpy as np
import pytest

from ray_tpu.env.vector_env import VectorEnv as RefVectorEnv
from ray_tpu.evaluation.sampler import SyncSampler as RefSyncSampler
from ray_tpu.policy.policy import Policy as RefPolicy
from ray_tpu.policy.policy import ViewRequirement as RefViewRequirement
from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig
from ray_tpu_torch.data.sample_batch import SampleBatch
from ray_tpu_torch.env.vector_env import VectorEnv
from ray_tpu_torch.evaluation.multi_agent_sampler import MultiAgentSyncSampler
from ray_tpu_torch.evaluation.sampler import SyncSampler
from ray_tpu_torch.evaluation.view_collector import ViewCollector, derived_requirements
from ray_tpu_torch.policy.policy import Policy, ViewRequirement

# -- the scripted view policy, in both packages ---------------------------------


class _StepEnv(gym.Env):
    """obs = [episode-local t, episode number]; reward 0.25 t + action;
    episodes of 4, 6 and 3 steps in turn."""

    observation_space = gym.spaces.Box(-1e9, 1e9, (2,), np.float32)
    action_space = gym.spaces.Discrete(2)
    LENGTHS = (4, 6, 3)

    def __init__(self, offset=0):
        self.episode = offset - 1

    def _obs(self):
        return np.array([self.t, self.episode], np.float32)

    def reset(self, *, seed=None, options=None):
        self.t = 0
        self.episode += 1
        return self._obs(), {}

    def step(self, action):
        reward = 0.25 * self.t + float(action)
        self.t += 1
        done = self.t >= self.LENGTHS[self.episode % len(self.LENGTHS)]
        return self._obs(), reward, done, False, {}


def _view_policy(base, view_requirement):
    class ViewPolicy(base):
        def __init__(self, obs_space, act_space):
            super().__init__(obs_space, act_space, {})
            vr = self.view_requirements
            vr["obs_3"] = view_requirement(data_col=SampleBatch.OBS, shift="-2:0", space=obs_space)
            vr["action_m2"] = view_requirement(data_col=SampleBatch.ACTIONS, shift=-2,
                                               used_for_compute_actions=False, space=act_space)
            vr[SampleBatch.PREV_ACTIONS] = view_requirement(data_col=SampleBatch.ACTIONS, shift=-1,
                                                            space=act_space)
            vr[SampleBatch.PREV_REWARDS] = view_requirement(data_col=SampleBatch.REWARDS, shift=-1)
            self._rng = np.random.default_rng(7)
            self.seen = []

        def compute_actions(self, obs_batch, state_batches=None, prev_action_batch=None,
                            prev_reward_batch=None, explore=True, **kwargs):
            self.seen.append({"obs": np.asarray(obs_batch), "prev_action_batch": prev_action_batch,
                              "prev_reward_batch": prev_reward_batch, **kwargs})
            n = len(obs_batch)
            return self._rng.integers(0, 2, n), [], {
                "vf_preds": np.asarray(obs_batch)[:, 0].astype(np.float32)}

    return ViewPolicy


def _assert_same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b), what


def _sample_views(package, frags=3):
    if package == "port":
        vec, sampler_cls, policy_cls = VectorEnv, SyncSampler, _view_policy(Policy, ViewRequirement)
    else:
        vec, sampler_cls = RefVectorEnv, RefSyncSampler
        policy_cls = _view_policy(RefPolicy, RefViewRequirement)
    random.seed(0)  # episode ids
    envs = vec.vectorize_gym_envs(lambda i: _StepEnv(offset=i), 2)
    policy = policy_cls(_StepEnv.observation_space, _StepEnv.action_space)
    sampler = sampler_cls(vector_env=envs, policy=policy, rollout_fragment_length=7)
    return [sampler.sample() for _ in range(frags)], policy.seen


def test_sync_sampler_views_match_reference():
    port, port_seen = _sample_views("port")
    ref, ref_seen = _sample_views("reference")
    for p, r in zip(port, ref):
        assert set(p) == set(r), (sorted(p), sorted(r))
        for k in r:
            _assert_same(p[k], r[k], k)
        assert {"obs_3", "action_m2", "prev_actions", "prev_rewards"} <= set(p)
    assert len(port_seen) == len(ref_seen) == 21
    for ps, rs in zip(port_seen, ref_seen):
        assert set(ps) == set(rs) == {"obs", "prev_action_batch", "prev_reward_batch", "obs_3"}
        for k in rs:
            _assert_same(ps[k], rs[k], k)
    # episodes of several lengths ended inside the fragments
    assert sum(int(b["dones"].sum()) for b in port) >= 6


def test_view_collector_matches_reference_row_by_row():
    """Both packages' collectors fed the same rows: the same compute
    views and train columns, through an episode reset."""
    from ray_tpu.evaluation.view_collector import ViewCollector as RefViewCollector

    rng = np.random.default_rng(3)
    space = gym.spaces.Box(-1, 1, (3,), np.float32)
    views = {  # key: (shift, data_col, space, used_for_compute_actions)
        "obs_w": ("-3:-1", SampleBatch.OBS, space, True),
        "rew_m2": (-2, SampleBatch.REWARDS, None, False),
        "obs_now": ("-1:0", SampleBatch.OBS, space, True),
    }
    pc = ViewCollector({k: ViewRequirement(data_col=c, shift=s, space=sp, used_for_compute_actions=u)
                        for k, (s, c, sp, u) in views.items()}, 2)
    rc = RefViewCollector({k: RefViewRequirement(data_col=c, shift=s, space=sp,
                                                 used_for_compute_actions=u)
                           for k, (s, c, sp, u) in views.items()}, 2)
    assert pc.lookback == rc.lookback == 3 and pc.active and rc.active
    for step in range(12):
        for env_i in range(2):
            obs = rng.standard_normal(3).astype(np.float32)
            cp = pc.compute_action_views(env_i, {SampleBatch.OBS: obs})
            cr = rc.compute_action_views(env_i, {SampleBatch.OBS: obs})
            assert set(cp) == set(cr)
            for k in cr:
                _assert_same(cp[k], cr[k], f"compute {k}")
            row = {SampleBatch.OBS: obs, SampleBatch.REWARDS: np.float32(rng.standard_normal())}
            rp, rr = dict(row), dict(row)
            pc.annotate_row(env_i, rp)
            rc.annotate_row(env_i, rr)
            for k in rr:
                _assert_same(rp[k], rr[k], f"train {k}")
            if step == 5 and env_i == 1:
                pc.reset_env(env_i)
                rc.reset_env(env_i)


# -- the reference's oracles, on the port ---------------------------------------


class _CountEnv(gym.Env):
    """obs = [episode-local t]; an episode ends after 5 steps."""

    observation_space = gym.spaces.Box(-1e9, 1e9, (1,), np.float32)
    action_space = gym.spaces.Discrete(2)

    def reset(self, *, seed=None, options=None):
        self.t = 0
        return np.array([0.0], np.float32), {}

    def step(self, action):
        self.t += 1
        return np.array([float(self.t)], np.float32), 1.0, self.t >= 5, False, {}


class _OracleViewPolicy(Policy):
    """A 3-step obs window used at compute and train time, and a
    train-only action from 2 steps back."""

    def __init__(self, observation_space, action_space, config=None):
        super().__init__(observation_space, action_space, config or {})
        self.view_requirements["obs_3"] = ViewRequirement(
            data_col=SampleBatch.OBS, shift="-2:0", space=observation_space)
        self.view_requirements["action_m2"] = ViewRequirement(
            data_col=SampleBatch.ACTIONS, shift=-2, used_for_compute_actions=False,
            space=action_space)
        self.seen_compute_views = []

    def compute_actions(self, obs_batch, state_batches=None, explore=True, **kwargs):
        assert "obs_3" in kwargs, sorted(kwargs)
        assert "action_m2" not in kwargs  # a train-only view
        self.seen_compute_views.append(np.asarray(kwargs["obs_3"]))
        return np.zeros(len(obs_batch), np.int64), [], {}


def _sample_once(frag=12):
    env = VectorEnv.vectorize_gym_envs(lambda i: _CountEnv(), 1)
    policy = _OracleViewPolicy(_CountEnv.observation_space, _CountEnv.action_space)
    return policy, SyncSampler(vector_env=env, policy=policy, rollout_fragment_length=frag).sample()


def test_window_view_zero_filled_and_ordered():
    policy, batch = _sample_once()
    obs3, obs, t = batch["obs_3"], batch[SampleBatch.OBS], batch[SampleBatch.T]
    assert obs3.shape == (batch.count, 3, 1)
    for r in range(batch.count):
        assert obs3[r, 2] == obs[r]  # shift 0: the current obs
        assert obs3[r, 1] == pytest.approx(0.0 if t[r] < 1 else obs[r] - 1)
        assert obs3[r, 0] == pytest.approx(0.0 if t[r] < 2 else obs[r] - 2)


def test_single_negative_shift_column():
    policy, batch = _sample_once()
    am2, actions, t = batch["action_m2"], batch[SampleBatch.ACTIONS], batch[SampleBatch.T]
    for r in range(batch.count):
        assert am2[r] == (0 if t[r] < 2 else actions[r - 2])


def test_compute_action_views_match_train_views():
    policy, batch = _sample_once()
    seen = np.concatenate(policy.seen_compute_views)[: batch.count]
    assert np.array_equal(seen, batch["obs_3"])


def test_views_do_not_cross_episode_boundary():
    policy, batch = _sample_once(frag=12)
    t, obs3 = batch[SampleBatch.T], batch["obs_3"]
    starts = [r for r in range(batch.count) if t[r] == 0]
    assert len(starts) >= 2  # 12 steps over 5-step episodes
    for r in starts:
        assert obs3[r, 0] == 0.0 and obs3[r, 1] == 0.0


def test_policies_without_custom_views_pay_nothing():
    base = Policy(_CountEnv.observation_space, _CountEnv.action_space, {})
    assert not ViewCollector(base.view_requirements, 2).active
    assert derived_requirements(base.view_requirements) == {}


# -- PPO's prev-1 views ---------------------------------------------------------


def test_ppo_prev_action_and_reward_views_on_cartpole():
    cfg = (PPOConfig().environment("CartPole-v1")
           .rollouts(num_rollout_workers=0, num_envs_per_worker=2, rollout_fragment_length=40)
           .training(model={"fcnet_hiddens": [16], "use_prev_action": True, "use_prev_reward": True})
           .debugging(seed=1).resources(device="cpu"))
    algo = cfg.build()
    try:
        policy = algo.get_policy()
        assert {SampleBatch.PREV_ACTIONS, SampleBatch.PREV_REWARDS} <= set(policy.view_requirements)
        batch = algo.workers.local_worker().sample()
        eps = batch[SampleBatch.EPS_ID]
        assert len(np.unique(eps)) >= 3  # episode starts inside the batch
        acts, rews = batch[SampleBatch.ACTIONS], batch[SampleBatch.REWARDS]
        pa, pr = batch[SampleBatch.PREV_ACTIONS], batch[SampleBatch.PREV_REWARDS]
        assert pa.dtype == acts.dtype and pr.dtype == np.float32
        for r in range(batch.count):
            start = batch[SampleBatch.T][r] == 0
            assert pa[r] == (0 if start else acts[r - 1])
            assert pr[r] == (0.0 if start else rews[r - 1])
            if not start:
                assert eps[r] == eps[r - 1]
        assert np.isfinite(algo.train()["info"]["learner"]["default_policy"]["total_loss"])
    finally:
        algo.stop()


class _Recurrent(Policy):
    def get_initial_state(self):
        return [np.zeros(4, np.float32)]


def test_recurrent_policy_still_raises():
    policy = _Recurrent(_CountEnv.observation_space, _CountEnv.action_space, {})
    with pytest.raises(NotImplementedError, match="carries no recurrent state"):
        MultiAgentSyncSampler(env=None, policy_map={"p": policy}, policy_mapping_fn=lambda a: "p",
                              preprocessors={}, obs_filters={})
