"""Multi-agent PPO of the port against the reference's, on the CPU.

Contracts:

- bitwise: the port's ``CartPole-v1`` (``env/cartpole.py``) against
  gymnasium's over several seeds, through termination and to the
  500-step truncation, and its spaces;
- bitwise: ``MultiAgentBatch`` (``concat_samples`` mixed with a
  SampleBatch, ``timeslices``, ``env_steps``, ``agent_steps``,
  ``size_bytes``, ``wrap_as_needed``, ``copy``);
- bitwise: ``MultiAgentSyncSampler`` against the reference's, every
  column of every policy batch, env steps, the episodes' metrics
  (reward, length, agent rewards) and ``policy_reward_mean``, for 4
  agents on one shared policy, 2 agents on two policies and 3 agents on
  two policies. Both samplers drive one scripted policy per id (actions
  from a seeded stream, values a fixed function of the obs, each
  package's own GAE) over sub-envs seeded before the sampler's first
  reset: the reference's ``reset()`` passes no seed on, as here;
- float32 tolerance: one multi-agent ``PPO.training_step`` of two
  policies (``p1`` with its own lr) on the batch the reference sampled,
  the reference's weights carried over (``from_jax_policy_weights``)
  and its permutations injected: each policy's stats within 1e-5
  relative (1e-7 absolute) and its parameters within 1.5e-5 absolute
  plus 1e-5 relative (``ROADMAP.md`` queue 3: Adam turns float32 noise
  near a zero gradient into a visible part of a step); the counters
  equal the reference's;
- end to end (``device="cpu"``): the reference's three multi-agent tests
  mirrored, one run with a remote worker (its weights equal the
  learner's bitwise after each sync, ``sample_prefetch`` stays
  synchronous, ``stop()`` leaves no process), ``policies_to_train``,
  ``set_policy_mapping_fn`` and ``add_policy`` at the next episode,
  ``get_policy`` by id,
  and the refusals where the reference has no multi-agent path.
"""

from __future__ import annotations

import itertools
import random

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

from ray_tpu.algorithms.ppo.ppo import PPOConfig as RefPPOConfig
from ray_tpu.data.sample_batch import MultiAgentBatch as RefMultiAgentBatch
from ray_tpu.data.sample_batch import SampleBatch as RefSampleBatch
from ray_tpu.data.sample_batch import concat_samples as ref_concat
from ray_tpu.env import registry as ref_registry
from ray_tpu.env.multi_agent_env import make_multi_agent as ref_make_multi_agent
from ray_tpu.evaluation import metrics as ref_metrics
from ray_tpu.evaluation import postprocessing as ref_post
from ray_tpu.evaluation.multi_agent_sampler import MultiAgentSyncSampler as RefMASampler
from ray_tpu_torch import core
from ray_tpu_torch.algorithms.appo.appo import APPOConfig
from ray_tpu_torch.algorithms.dqn.dqn import DQNConfig
from ray_tpu_torch.algorithms.impala.impala import IMPALAConfig
from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig
from ray_tpu_torch.algorithms.sac.sac import SACConfig
from ray_tpu_torch.data.sample_batch import DEFAULT_POLICY_ID, MultiAgentBatch, SampleBatch
from ray_tpu_torch.data.sample_batch import concat_samples
from ray_tpu_torch.env import registry
from ray_tpu_torch.env.cartpole import CartPoleEnv
from ray_tpu_torch.env.multi_agent_env import MultiAgentEnv, make_multi_agent
from ray_tpu_torch.env.spaces import Box, Discrete
from ray_tpu_torch.evaluation import metrics
from ray_tpu_torch.evaluation import postprocessing as post
from ray_tpu_torch.evaluation.multi_agent_sampler import MultiAgentSyncSampler
from ray_tpu_torch.utils.jax_params import flax_to_state_dict, from_jax_policy_weights

OBS_SP, ACT_SP = Box(-np.inf, np.inf, (4,), np.float64), Discrete(2)
GYM_OBS_SP, GYM_ACT_SP = gym.spaces.Box(-np.inf, np.inf, (4,), np.float64), gym.spaces.Discrete(2)


def _assert_same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b), what


def _assert_batches_equal(port, ref):
    assert set(port) == set(ref), (sorted(port), sorted(ref))
    for k in ref:
        _assert_same(port[k], ref[k], k)


# -- CartPole-v1 -----------------------------------------------------------------


def _balance(obs):
    x, x_dot, theta, theta_dot = obs
    return int(theta + 0.5 * theta_dot + 0.01 * x + 0.1 * x_dot > 0)


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_cartpole_matches_gymnasium_bitwise(seed):
    port, ref = CartPoleEnv(), gym.make("CartPole-v1")
    assert port.observation_space.shape == ref.observation_space.shape == (4,)
    assert port.observation_space.dtype == ref.observation_space.dtype
    _assert_same(port.observation_space.low, ref.observation_space.low, "low")
    _assert_same(port.observation_space.high, ref.observation_space.high, "high")
    assert port.action_space.n == ref.action_space.n == 2
    rng = np.random.default_rng(seed)
    ends = []
    for episode in range(4):
        p, r = port.reset(seed=seed if episode == 0 else None), ref.reset(
            seed=seed if episode == 0 else None)
        _assert_same(p[0], r[0], "reset obs")
        obs = p[0]
        for t in range(600):
            # random actions end in termination, the balancing ones at 500
            a = int(rng.integers(0, 2)) if episode % 2 == 0 else _balance(obs)
            ps, rs = port.step(np.int64(a)), ref.step(np.int64(a))
            _assert_same(ps[0], rs[0], f"obs at {t}")
            assert ps[1:4] == rs[1:4] and type(ps[1]) is type(rs[1]), (t, ps[1:4], rs[1:4])
            obs = ps[0]
            if ps[2] or ps[3]:
                ends.append((t + 1, ps[2], ps[3]))
                break
    assert [e[1] for e in ends] == [True, False, True, False]
    assert all(e == (500, False, True) for e in ends[1::2])


def test_cartpole_resolves_to_the_port_env():
    env = registry.get_env_creator("CartPole-v1")({})
    assert isinstance(env, CartPoleEnv)
    ma = make_multi_agent("CartPole-v1")({"num_agents": 3})
    assert isinstance(ma, MultiAgentEnv) and all(isinstance(e, CartPoleEnv) for e in ma.envs)
    obs, _ = ma.reset(seed=5)
    ref_obs, _ = ref_make_multi_agent("CartPole-v1")({"num_agents": 3}).reset(seed=5)
    for aid in range(3):
        _assert_same(obs[aid], ref_obs[aid], aid)


# -- MultiAgentBatch -------------------------------------------------------------


def _columns(rng, n, eps):
    return {
        "obs": rng.standard_normal((n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n),
        "rewards": rng.standard_normal(n).astype(np.float32),
        "eps_id": np.full(n, eps, np.int64),
    }


def test_multi_agent_batch_matches_reference():
    rng = np.random.default_rng(0)
    cols = [{"a": _columns(rng, 9, 1), "b": _columns(rng, 4, 2)},
            {"a": _columns(rng, 5, 3), "c": _columns(rng, 7, 4)}]
    single = _columns(rng, 6, 5)
    pb = [MultiAgentBatch({k: SampleBatch(dict(v)) for k, v in c.items()}, 10) for c in cols]
    rb = [RefMultiAgentBatch({k: RefSampleBatch(dict(v)) for k, v in c.items()}, 10) for c in cols]
    pb.append(SampleBatch(dict(single)))
    rb.append(RefSampleBatch(dict(single)))
    p, r = concat_samples(pb), ref_concat(rb)
    assert isinstance(p, MultiAgentBatch) and isinstance(r, RefMultiAgentBatch)
    assert p.env_steps() == r.env_steps() == p.count == 26
    assert p.agent_steps() == r.agent_steps() == 31
    assert p.size_bytes() == r.size_bytes()
    assert list(p.policy_batches) == list(r.policy_batches) == ["a", "b", "c", DEFAULT_POLICY_ID]
    for pid in r.policy_batches:
        _assert_batches_equal(p.policy_batches[pid], r.policy_batches[pid])
    ps, rs = p.timeslices(4), r.timeslices(4)
    assert len(ps) == len(rs) == 1
    for a, b in zip(ps, rs):
        assert a.count == b.count == 4
        for pid in b.policy_batches:
            _assert_batches_equal(a.policy_batches[pid], b.policy_batches[pid])
    one = SampleBatch(dict(single))
    assert MultiAgentBatch.wrap_as_needed({DEFAULT_POLICY_ID: one}, 6) is one
    assert RefMultiAgentBatch.wrap_as_needed({DEFAULT_POLICY_ID: RefSampleBatch(dict(single))}, 6
                                             ).count == 6
    two = MultiAgentBatch.wrap_as_needed({"a": one, "b": one}, 6)
    assert isinstance(two, MultiAgentBatch) and two.agent_steps() == 12
    dup = p.copy()
    dup.policy_batches["a"]["rewards"][0] += 1.0
    assert p.policy_batches["a"]["rewards"][0] != dup.policy_batches["a"]["rewards"][0]
    assert one.as_multi_agent().policy_batches[DEFAULT_POLICY_ID] is one


# -- MultiAgentSyncSampler -------------------------------------------------------


class ScriptedPolicy:
    """One policy both packages' samplers can drive: actions from a
    seeded stream, values a fixed function of the obs, and the given
    package's GAE."""

    is_recurrent = False

    def __init__(self, gae, action_space, seed):
        self.config = {"gamma": 0.99, "lambda": 0.95}
        self.action_space = action_space
        self._rng = np.random.default_rng(seed)
        self._gae = gae

    def get_initial_state(self):
        return []

    @staticmethod
    def _values(obs):
        return (np.asarray(obs).sum(axis=1) * 0.1).astype(np.float32)

    def compute_actions(self, obs, state_batches=None, explore=True, **kwargs):
        n = len(obs)
        return self._rng.integers(0, 2, n), [], {
            "vf_preds": self._values(obs), "action_logp": np.full(n, -0.6931, np.float32)}

    def value_batch(self, obs, state=None):
        return self._values(obs)

    def postprocess_trajectory(self, batch, other_agent_batches=None, episode=None):
        return self._gae(self, batch)


def _seeded_creator(package, base):
    """Sub-envs seeded from ``base`` on: the sampler's unseeded resets
    go on from these streams."""
    seeds = itertools.count(base)

    def make(cfg):
        env = CartPoleEnv() if package == "port" else gym.make("CartPole-v1")
        env.reset(seed=next(seeds))
        return env

    return make


MAPPINGS = {
    "shared4": (4, lambda aid, **kw: "shared"),
    "split2": (2, lambda aid, **kw: f"p{aid % 2}"),
    "split3": (3, lambda aid, **kw: f"p{aid % 2}"),
}


def _ma_samples(package, case, frags=4, frag_len=48):
    num, mapping = MAPPINGS[case]
    if package == "port":
        make_ma, sampler_cls, gae, space = make_multi_agent, MultiAgentSyncSampler, post, ACT_SP
    else:
        make_ma, sampler_cls, gae, space = ref_make_multi_agent, RefMASampler, ref_post, GYM_ACT_SP
    env = make_ma(_seeded_creator(package, 100))({"num_agents": num})
    pids = sorted({mapping(a) for a in range(num)})
    policies = {pid: ScriptedPolicy(gae.compute_gae_for_sample_batch, space, seed=i)
                for i, pid in enumerate(pids)}
    random.seed(0)  # episode ids
    sampler = sampler_cls(env=env, policy_map=policies, policy_mapping_fn=mapping,
                          preprocessors={}, obs_filters={}, rollout_fragment_length=frag_len)
    return [sampler.sample() for _ in range(frags)], sampler.get_metrics()


@pytest.mark.parametrize("case", list(MAPPINGS))
def test_multi_agent_sampler_matches_reference(case):
    port, port_eps = _ma_samples("port", case)
    ref, ref_eps = _ma_samples("reference", case)
    for p, r in zip(port, ref):
        assert p.env_steps() == r.env_steps() == 48
        assert p.agent_steps() == r.agent_steps()
        assert list(p.policy_batches) == list(r.policy_batches)
        for pid in r.policy_batches:
            _assert_batches_equal(p.policy_batches[pid], r.policy_batches[pid])
    assert len(port_eps) == len(ref_eps) >= 3
    for a, b in zip(port_eps, ref_eps):
        assert (a.episode_length, a.episode_reward, a.agent_rewards) == (
            b.episode_length, b.episode_reward, b.agent_rewards)
    ps, rs = metrics.summarize_episodes(port_eps), ref_metrics.summarize_episodes(ref_eps)
    assert ps["policy_reward_mean"] == rs["policy_reward_mean"]
    assert set(ps["policy_reward_mean"]) == {MAPPINGS[case][1](a) for a in range(MAPPINGS[case][0])}
    # the agents of one episode finish at different steps
    assert any(len(set(e.agent_rewards.values())) > 1 for e in port_eps)


# -- learning parity -------------------------------------------------------------

LEARN = {"train_batch_size": 128, "sgd_minibatch_size": 32, "num_sgd_iter": 2, "lr": 5e-4,
         "entropy_coeff": 0.01, "grad_clip": 40.0, "model": {"fcnet_hiddens": [32, 32],
                                                           "dtype": "float32"}}


def _reference_perms(key, n, iters):
    """The permutations ``JaxPolicy``'s nest draws on shard 0 from the
    policy key ``key`` (as ``tests/test_torch_ppo.py`` derives them)."""
    _, rng = jax.random.split(key)
    rng = jax.random.fold_in(rng, 0)
    return np.stack([np.asarray(jax.random.permutation(jax.random.split(r)[0], n))
                     for r in jax.random.split(rng, iters)])


def _register():
    registry.register_env(
        "multi_cartpole", lambda cfg: make_multi_agent("CartPole-v1")({"num_agents": 2}))
    ref_registry.register_env(
        "multi_cartpole", lambda cfg: ref_make_multi_agent("CartPole-v1")({"num_agents": 2}))


def test_two_policy_training_step_matches_reference(monkeypatch):
    import ray_tpu.algorithms.ppo.ppo as jppo
    import ray_tpu_torch.algorithms.ppo.ppo as tppo

    # the reference's sub-envs seeded, so that its sample is the same
    # on every run
    ref_registry.register_env("multi_cartpole_seeded", lambda cfg: ref_make_multi_agent(
        _seeded_creator("reference", 200))({"num_agents": 2}))
    _register()
    mapping = lambda aid, **kw: f"p{aid % 2}"  # noqa: E731
    ref = (RefPPOConfig().environment("multi_cartpole_seeded")
           .rollouts(num_rollout_workers=0, rollout_fragment_length=32).training(**LEARN)
           .multi_agent(policies={"p0": (None, GYM_OBS_SP, GYM_ACT_SP, {}),
                                  "p1": (None, GYM_OBS_SP, GYM_ACT_SP, {"lr": 1e-4})},
                        policy_mapping_fn=mapping)
           .debugging(seed=2).resources(learner_devices=1).build())
    port = (PPOConfig().environment("multi_cartpole")
            .rollouts(num_rollout_workers=0, rollout_fragment_length=32).training(**LEARN)
            .multi_agent(policies={"p0": (None, OBS_SP, ACT_SP, {}),
                                   "p1": (None, OBS_SP, ACT_SP, {"lr": 1e-4})},
                         policy_mapping_fn=mapping)
            .debugging(seed=2).resources(device="cpu").build())
    try:
        ref_map = ref.workers.local_worker().policy_map
        port_map = port.workers.local_worker().policy_map
        from_jax_policy_weights(ref.workers.local_worker().get_weights(), port_map)
        sampled = []
        real_sample = jppo.synchronous_parallel_sample

        def record(**kw):
            batch = real_sample(**kw)
            sampled.append(batch.copy())
            return batch

        monkeypatch.setattr(jppo, "synchronous_parallel_sample", record)
        keys = {}
        for pid, rp in ref_map.items():
            def learn(*args, pid=pid, rp=rp, real=rp.learn_on_device_batch, **kw):
                keys[pid] = rp._rng  # after sampling, which draws from it too
                return real(*args, **kw)

            monkeypatch.setattr(rp, "learn_on_device_batch", learn)
        ref_info = ref.training_step()
        (batch,) = sampled
        assert set(batch.policy_batches) == {"p0", "p1"}
        perms = {pid: _reference_perms(keys[pid], b.count, 2) for pid, b in batch.policy_batches.items()}
        port_batch = MultiAgentBatch(
            {pid: SampleBatch(dict(b)) for pid, b in batch.policy_batches.items()}, batch.count)
        monkeypatch.setattr(tppo, "synchronous_parallel_sample", lambda **kw: [port_batch])
        for pid, policy in port_map.items():
            monkeypatch.setattr(policy, "draw_permutations",
                                lambda n, pid=pid: torch.as_tensor(perms[pid]))
        info = port.training_step()

        assert set(info) == set(ref_info) == {"p0", "p1"}
        for pid in ("p0", "p1"):
            assert set(info[pid]) == set(ref_info[pid])
            for k, v in ref_info[pid].items():
                np.testing.assert_allclose(info[pid][k], v, rtol=1e-5, atol=1e-7, err_msg=f"{pid} {k}")
            ref_params = flax_to_state_dict(ref_map[pid].get_weights())
            got = port_map[pid].get_weights()
            assert set(got) == set(ref_params)
            for name, r in ref_params.items():
                np.testing.assert_allclose(got[name], r, rtol=1e-5, atol=1.5e-5, err_msg=f"{pid} {name}")
        assert info["p1"]["cur_lr"] == pytest.approx(1e-4) and info["p0"]["cur_lr"] == pytest.approx(5e-4)
        keys4 = ("num_env_steps_sampled", "num_agent_steps_sampled", "num_env_steps_trained",
                 "num_agent_steps_trained")
        assert {k: port._counters[k] for k in keys4} == {k: ref._counters[k] for k in keys4}
        # the reference's quirk: agent steps sampled count env steps
        assert port._counters["num_agent_steps_sampled"] == batch.env_steps() == 128
        assert port._counters["num_agent_steps_trained"] == batch.agent_steps()
    finally:
        port.stop()
        ref.cleanup()


# -- end to end ------------------------------------------------------------------


def _base_cfg(**rollouts):
    _register()
    return (PPOConfig().environment("multi_cartpole")
            .rollouts(**{"num_rollout_workers": 0, "rollout_fragment_length": 64, **rollouts})
            .training(train_batch_size=256, sgd_minibatch_size=64, num_sgd_iter=2, lr=3e-4)
            .debugging(seed=0).resources(device="cpu"))


def _independent(cfg, **kw):
    return cfg.multi_agent(
        policies={"p0": (None, OBS_SP, ACT_SP, {}), "p1": (None, OBS_SP, ACT_SP, {"lr": 1e-4})},
        policy_mapping_fn=lambda aid, **kw: f"p{aid % 2}", **kw)


def test_shared_policy_multi_agent():
    algo = _base_cfg().multi_agent(policies={"shared": (None, OBS_SP, ACT_SP, {})},
                                   policy_mapping_fn=lambda aid, **kw: "shared").build()
    try:
        result = algo.train()
        learner = result["info"]["learner"]
        assert "shared" in learner and np.isfinite(learner["shared"]["total_loss"])
        assert set(result["policy_reward_mean"]) == {"shared"}
        assert result["num_env_steps_sampled"] == 256
        assert result["info"]["num_agent_steps_sampled"] == 256  # the reference's count
        assert result["info"]["num_agent_steps_trained"] > 256
        assert set(result["info"]["timers"]) == {"shared"}
        assert algo.get_policy("shared") is algo.workers.local_worker().policy_map["shared"]
        with pytest.raises(KeyError, match="no policy 'default_policy'"):
            algo.get_policy()
    finally:
        algo.stop()


def test_independent_policies_multi_agent():
    algo = _independent(_base_cfg()).build()
    try:
        result = algo.train()
        learner = result["info"]["learner"]
        assert "p0" in learner and "p1" in learner
        assert learner["p1"]["cur_lr"] == pytest.approx(1e-4)
        assert learner["p0"]["cur_lr"] == pytest.approx(3e-4)
        assert set(result["policy_reward_mean"]) == {"p0", "p1"}
        state = algo.__getstate__()
        assert set(state["worker"]["policy_states"]) == {"p0", "p1"}
        other = _independent(_base_cfg()).debugging(seed=5).build()
        other.__setstate__(state)
        for pid in ("p0", "p1"):
            for name, w in algo.get_policy(pid).get_weights().items():
                _assert_same(other.get_policy(pid).get_weights()[name], w, name)
        other.stop()
    finally:
        algo.stop()


def test_multi_agent_batch_structure():
    algo = _base_cfg().multi_agent(policies={"shared": (None, OBS_SP, ACT_SP, {})},
                                   policy_mapping_fn=lambda aid, **kw: "shared").build()
    try:
        batch = algo.workers.local_worker().sample()
        assert isinstance(batch, MultiAgentBatch)
        sb = batch.policy_batches["shared"]
        # both agents' steps go to the shared policy (an agent's episode
        # can end before the other's)
        assert sb.count > 64 and "advantages" in sb
        assert set(np.unique(sb["agent_index"])) == {0, 1}
    finally:
        algo.stop()


def test_policies_to_train_leaves_the_others_unchanged():
    algo = _independent(_base_cfg(), policies_to_train=["p0"]).build()
    try:
        before = {pid: {n: w.copy() for n, w in algo.get_policy(pid).get_weights().items()}
                  for pid in ("p0", "p1")}
        result = algo.train()
        assert set(result["info"]["learner"]) == {"p0"}
        for name, w in algo.get_policy("p1").get_weights().items():
            _assert_same(w, before["p1"][name], name)
        assert any(not np.array_equal(w, before["p0"][n])
                   for n, w in algo.get_policy("p0").get_weights().items())
    finally:
        algo.stop()


def test_set_policy_mapping_fn_takes_effect_at_the_next_episode():
    algo = _independent(_base_cfg()).rollouts(rollout_fragment_length=6).build()
    try:
        worker = algo.workers.local_worker()
        first = worker.sample()
        assert set(first.policy_batches) == {"p0", "p1"}
        assert worker.sampler.cur_obs and worker.sampler.episode.length > 0  # an episode is on
        running = worker.sampler.episode.episode_id
        worker.set_policy_mapping_fn(lambda aid, **kw: "p1")
        seen = {"p0": set(), "p1": set()}
        for _ in range(12):
            for pid, pb in worker.sample().policy_batches.items():
                seen[pid] |= set(pb["eps_id"].tolist())
        # the running episode keeps agent 0 on p0; every later one is p1's
        assert seen["p0"] == {running}
        assert len(seen["p1"] - {running}) >= 2
    finally:
        algo.stop()


def test_add_policy_joins_the_map_at_the_next_episode():
    from ray_tpu_torch.algorithms.ppo.ppo import PPOTorchPolicy

    algo = _independent(_base_cfg()).rollouts(rollout_fragment_length=8).build()
    try:
        worker = algo.workers.local_worker()
        worker.sample()
        weights = algo.get_policy("p0").get_weights()
        worker.add_policy("p2", PPOTorchPolicy, OBS_SP, ACT_SP, {"lr": 1e-3}, weights=weights)
        worker.set_policy_mapping_fn(lambda aid, **kw: "p2")
        assert algo.get_policy("p2").config["lr"] == 1e-3
        for name, w in algo.get_policy("p2").get_weights().items():
            _assert_same(w, weights[name], name)
        seen = set()
        for _ in range(10):
            seen |= set(worker.sample().policy_batches)
        assert "p2" in seen
        assert set(algo.train()["info"]["learner"]) <= {"p0", "p1", "p2"}
    finally:
        algo.stop()


@pytest.fixture(scope="module")
def runtime():
    core.shutdown()
    core.init(num_cpus=1)
    yield
    core.shutdown()


def test_remote_worker_weights_and_prefetch_stay_synchronous(runtime):
    algo = _independent(_base_cfg(num_rollout_workers=1, sample_prefetch=1)).build()
    try:
        procs = [w._worker.process for w in algo.workers.remote_workers()]
        assert not algo._use_sample_prefetch()
        results = [algo.train() for _ in range(2)]
        assert [r["timesteps_total"] for r in results] == [256, 512]
        assert getattr(algo, "_sample_pipeline", None) is None
        assert set(results[-1]["info"]["learner"]) == {"p0", "p1"}
        learner = algo.workers.local_worker().get_weights()
        (remote,) = core.get([w.get_weights.remote() for w in algo.workers.remote_workers()])
        assert set(remote) == set(learner) == {"p0", "p1"}
        for pid in learner:
            for name, w in learner[pid].items():
                _assert_same(remote[pid][name], w, f"{pid} {name}")
        assert set(results[-1]["policy_reward_mean"]) == {"p0", "p1"}
    finally:
        algo.stop()
    assert all(not p.is_alive() and p.exitcode is not None for p in procs)
    assert algo.workers.num_remote_workers() == 0


@pytest.mark.parametrize("config_cls", [IMPALAConfig, APPOConfig, DQNConfig, SACConfig])
def test_multi_agent_off_the_ppo_path_raises(config_cls):
    """Where the reference has no multi-agent path, the port refuses
    ``policies`` as the reference does. IMPALA and APPO look up the
    default policy: a map without one fails to build in both packages
    (``KeyError: 'default_policy'``). A map with one is the port's own
    refusal: the reference's IMPALA builds and trains the default policy
    alone, shown here. The replay family learns a policy map on the actor lane
    (``tests/test_torch_multi_agent_replay.py``); its device lane is
    single-policy, as the reference's."""
    _register()
    if config_cls in (DQNConfig, SACConfig):
        cfg = config_cls().environment("multi_cartpole", env_backend="jax").resources(device="cpu")
        cfg.multi_agent(policies={"p0": (None, OBS_SP, ACT_SP, {})},
                        policy_mapping_fn=lambda aid, **kw: "p0")
        with pytest.raises(ValueError, match="env_backend='jax' is single-policy"):
            cfg.build()
        return
    from ray_tpu.algorithms.appo.appo import APPOConfig as RefAPPOConfig
    from ray_tpu.algorithms.impala.impala import IMPALAConfig as RefIMPALAConfig

    ref_cls = RefIMPALAConfig if config_cls is IMPALAConfig else RefAPPOConfig
    ref = ref_cls().environment("multi_cartpole").rollouts(num_rollout_workers=0)
    ref.multi_agent(policies={"p0": (None, GYM_OBS_SP, GYM_ACT_SP, {})},
                    policy_mapping_fn=lambda aid, *a, **kw: "p0")
    with pytest.raises(KeyError, match=DEFAULT_POLICY_ID):
        ref.build()
    cfg = config_cls().environment("multi_cartpole").resources(device="cpu")
    cfg.multi_agent(policies={"p0": (None, OBS_SP, ACT_SP, {})},
                    policy_mapping_fn=lambda aid, **kw: "p0")
    with pytest.raises(KeyError, match=DEFAULT_POLICY_ID):
        cfg.build()
    cfg.multi_agent(policies={DEFAULT_POLICY_ID: (None, OBS_SP, ACT_SP, {}),
                              "p1": (None, OBS_SP, ACT_SP, {})},
                    policy_mapping_fn=lambda aid, **kw: "p1")
    with pytest.raises(ValueError, match="the port refuses a policy map"):
        cfg.build()
    if config_cls is IMPALAConfig:
        ref.multi_agent(policies={DEFAULT_POLICY_ID: (None, GYM_OBS_SP, GYM_ACT_SP, {}),
                                  "p1": (None, GYM_OBS_SP, GYM_ACT_SP, {})},
                        policy_mapping_fn=lambda aid, *a, **kw: "p1")
        algo = ref.build()
        try:
            learner = algo.train()["info"]["learner"]
        finally:
            algo.stop()
        assert DEFAULT_POLICY_ID in learner and "p1" not in learner


def test_multi_agent_on_the_device_lane_raises():
    cfg = PPOConfig().environment("CartPoleJax-v0", env_backend="jax").resources(device="cpu")
    cfg.multi_agent(policies={"p0": (None, OBS_SP, ACT_SP, {})},
                    policy_mapping_fn=lambda aid, **kw: "p0")
    with pytest.raises(ValueError, match="env_backend='jax' is single-policy"):
        cfg.build()


def test_policies_need_a_multi_agent_env():
    cfg = PPOConfig().environment("CartPole-v1").resources(device="cpu")
    cfg.multi_agent(policies={"p0": None}, policy_mapping_fn=lambda aid, **kw: "p0")
    with pytest.raises(ValueError, match="need a MultiAgentEnv"):
        cfg.build()
