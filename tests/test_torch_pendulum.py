"""Continuous actions on the actor lane: the port's Pendulum-v1, the
sampler's action squashing and horizon, the refused config surface, and
PPO with a DiagGaussian, against the reference on the CPU.

Contracts:

- bitwise: ``env/pendulum.py`` against gymnasium's ``Pendulum-v1``
  (``gym.make``, so under ``TimeLimit(200)``) over 5 seeded episodes to
  the truncation, observations, rewards (type included), terminated and
  truncated flags, and the reset stream after a reset without a seed;
- bitwise: ``unsquash_action`` and ``clip_action`` against the
  reference's, on the port's Box and on gymnasium's;
- bitwise: ``SyncSampler`` on Pendulum-v1 under one scripted policy that
  both samplers drive, with ``horizon`` (the cut row keeps the env's
  ``TRUNCATEDS``, as the reference leaves it) and each of the action
  settings (``normalize_actions``, ``clip_actions``, neither): every
  column and the episodes;
- ``callbacks_class`` and ``evaluation_interval``, refused until the
  ``Algorithm``'s surface was ported, act on the actor lane (the
  callbacks' ``on_train_result`` mutates the result; the result carries
  ``evaluation``), and on the device lane too (its evaluation workers
  drive the tensor env through ``TensorVectorEnvAdapter``);
- one PPO ``learn_on_batch`` with Box actions (DiagGaussian logp, KL and
  entropy in the loss) against the reference's from the same weights
  and permutations: stats 1e-5 relative, parameters 1.5e-5 absolute plus
  1e-5 relative (the PPO learn's tolerance);
- ``pendulum-ppo.yaml`` on the actor lane for one iteration on the CPU:
  float32 actions of the policy's own in the batch, finite stats.
"""

from __future__ import annotations

import pathlib
import random

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

from ray_tpu.algorithms.ppo.ppo import PPOJaxPolicy
from ray_tpu.env import registry as ref_registry
from ray_tpu.env.vector_env import VectorEnv as RefVectorEnv
from ray_tpu.evaluation import sampler as ref_sampler
from ray_tpu.sharding import get_mesh
from ray_tpu_torch.algorithms.callbacks import DefaultCallbacks
from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig, PPOTorchPolicy
from ray_tpu_torch.env import registry
from ray_tpu_torch.env.pendulum import PendulumEnv
from ray_tpu_torch.env.spaces import Box
from ray_tpu_torch.env.vector_env import VectorEnv
from ray_tpu_torch.evaluation import sampler
from ray_tpu_torch.models import distributions as tdists
from ray_tpu_torch.utils.jax_params import flax_to_state_dict, from_jax_params
from ray_tpu_torch.utils.tuned_example import build_tuned_example

REPO = pathlib.Path(__file__).resolve().parents[1]


# -- the env -----------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_pendulum_matches_gymnasium_bitwise(seed):
    ref, port = gym.make("Pendulum-v1"), registry.get_env_creator("Pendulum-v1")({})
    assert isinstance(port, PendulumEnv)
    ro, _ = ref.reset(seed=seed)
    po, _ = port.reset(seed=seed)
    assert po.dtype == ro.dtype == np.float32 and po.tobytes() == ro.tobytes()
    rng = np.random.default_rng(seed)
    for t in range(200):
        # float32 actions as the sampler sends them, some past the torque limit
        a = rng.uniform(-3.0, 3.0, (1,)).astype(np.float32)
        r, p = ref.step(a), port.step(a)
        assert p[0].tobytes() == r[0].tobytes(), t
        assert type(p[1]) is type(r[1]) and p[1] == r[1], (t, p[1], r[1])
        assert (p[2], p[3]) == (r[2], r[3]) == (False, t == 199), t
    ro, _ = ref.reset()  # no seed: the stream goes on
    po, _ = port.reset()
    assert po.tobytes() == ro.tobytes()


def test_pendulum_spaces_and_float64_actions():
    port = PendulumEnv()
    ref = gym.make("Pendulum-v1").unwrapped
    for name in ("observation_space", "action_space"):
        p, r = getattr(port, name), getattr(ref, name)
        assert p.shape == r.shape and p.dtype == r.dtype
        assert p.low.tobytes() == r.low.tobytes() and p.high.tobytes() == r.high.tobytes()
    # a float64 action keeps float64 arithmetic in both
    port.reset(seed=9)
    ref.reset(seed=9)
    a = np.array([1.2345678901234], np.float64)
    assert port.step(a)[1] == ref.step(a)[1]
    assert registry.get_env_creator("Pendulum-v1") is PendulumEnv


# -- action squashing --------------------------------------------------------------


@pytest.mark.parametrize("fn", ["unsquash_action", "clip_action"])
def test_unsquash_and_clip_match_reference(fn):
    rng = np.random.default_rng(1)
    spaces = [
        (Box(-2.0, 2.0, (1,)), gym.spaces.Box(-2.0, 2.0, (1,), np.float32)),
        (Box(np.array([-1, 0, -5], np.float32), np.array([1, 3, 5], np.float32)),
         gym.spaces.Box(np.array([-1, 0, -5], np.float32), np.array([1, 3, 5], np.float32))),
    ]
    for port_space, ref_space in spaces:
        for scale in (0.5, 3.0):
            a = (rng.standard_normal(port_space.shape) * scale).astype(np.float32)
            want = getattr(ref_sampler, fn)(a, ref_space)
            for space in (port_space, ref_space):
                got = getattr(sampler, fn)(a, space)
                assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    # unbounded and discrete spaces pass the action through
    assert sampler.unsquash_action(np.float32(7.0), Box(-np.inf, np.inf, (1,))) == 7.0
    assert sampler.unsquash_action(3, gym.spaces.Discrete(5)) == 3


class ScriptedContinuous:
    """One policy both samplers can drive: actions from a seeded stream,
    past [-1, 1] so that the squashing shows."""

    is_recurrent = False

    def __init__(self):
        self.config = {}
        self._rng = np.random.default_rng(5)

    def get_initial_state(self):
        return []

    def compute_actions(self, obs, state_batches=None, explore=True, **kwargs):
        n = len(obs)
        actions = self._rng.uniform(-1.6, 1.6, (n, 1)).astype(np.float32)
        return actions, [], {"action_logp": np.full(n, -0.5, np.float32)}

    def postprocess_trajectory(self, batch, other_agent_batches=None, episode=None):
        return batch


def _pendulum_samples(package, **kwargs):
    if package == "port":
        make, vec, cls = registry.get_env_creator("Pendulum-v1"), VectorEnv, sampler.SyncSampler
    else:
        make, vec, cls = ref_registry.get_env_creator("Pendulum-v1"), RefVectorEnv, ref_sampler.SyncSampler
    random.seed(0)  # episode ids
    envs = vec.vectorize_gym_envs(lambda i: make({}), 2, seed=4)
    s = cls(vector_env=envs, policy=ScriptedContinuous(), rollout_fragment_length=20, **kwargs)
    return [s.sample() for _ in range(2)], [(m.episode_length, m.episode_reward) for m in s.get_metrics()]


@pytest.mark.parametrize("actions", [
    {}, {"normalize_actions": False, "clip_actions": True},
    {"normalize_actions": False, "clip_actions": False},
])
def test_horizon_and_squashing_match_reference_sampler(actions):
    port, port_eps = _pendulum_samples("port", episode_horizon=7, **actions)
    ref, ref_eps = _pendulum_samples("reference", episode_horizon=7, **actions)
    assert port_eps == ref_eps and len(port_eps) == 10
    assert all(length == 7 for length, _ in port_eps)
    for p, r in zip(port, ref):
        assert set(p) == set(r)
        for k in r:
            a, b = np.asarray(p[k]), np.asarray(r[k])
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), k
        # the cut row keeps the env's flags: Pendulum never truncates at 7
        assert not p["truncateds"].any() and not p["dones"].any()
        assert np.abs(p["actions"]).max() > 1.0  # the batch keeps the policy's actions


def test_rollout_worker_passes_horizon():
    from ray_tpu_torch.evaluation.rollout_worker import RolloutWorker

    w = RolloutWorker(
        env_creator=registry.get_env_creator("Pendulum-v1"), policy_cls=PPOTorchPolicy,
        config={"horizon": 5, "rollout_fragment_length": 12, "seed": 0,
                "model": {"fcnet_hiddens": [8]}, "clip_actions": True,
                "normalize_actions": False},
        device="cpu",
    )
    assert (w.sampler.horizon, w.sampler.clip_actions, w.sampler.normalize_actions) == (5, True, False)
    w.sample()
    assert [m.episode_length for m in w.get_metrics()] == [5, 5]


# -- the once refused surface -------------------------------------------------------


class _TrainResults(DefaultCallbacks):
    def on_train_result(self, *, result=None, **kwargs):
        result["seen_by_callbacks"] = result["training_iteration"]


@pytest.mark.parametrize("key,value", [("callbacks_class", _TrainResults), ("evaluation_interval", 1)])
@pytest.mark.parametrize("lane", ["actor", "jax"])
def test_callbacks_and_evaluation_interval_raise(key, value, lane):
    env = "Pendulum-v1" if lane == "actor" else "CartPoleJax-v0"
    cfg = (PPOConfig().environment(env, env_backend=lane)
           .rollouts(num_rollout_workers=0, rollout_fragment_length=16)
           .training(train_batch_size=16, sgd_minibatch_size=8, num_sgd_iter=1,
                     model={"fcnet_hiddens": [8]})
           .evaluation(evaluation_duration=1).resources(device="cpu"))
    setattr(cfg, key, value)
    algo = cfg.build()
    try:
        result = algo.train()
    finally:
        algo.stop()
    if key == "callbacks_class":
        assert result["seen_by_callbacks"] == 1
    else:
        assert result["evaluation"]["episodes_this_iter"] >= 1
        if lane == "actor":
            assert result["evaluation"]["episode_len_mean"] == 200  # Pendulum's truncation


def test_refused_surface_defaults_pass():
    cfg = PPOConfig()
    assert cfg.callbacks_class is None and cfg.evaluation_interval is None
    assert (cfg.evaluation_duration, cfg.evaluation_duration_unit, cfg.evaluation_num_workers) == (
        10, "episodes", 0)
    d = cfg.to_dict()
    assert (d["horizon"], d["normalize_actions"], d["clip_actions"]) == (None, True, False)


# -- PPO with a DiagGaussian ---------------------------------------------------------

B, MB, ITERS, OBS, ACT = 32, 8, 2, 3, 2
PPO_CONFIG = {
    "train_batch_size": B, "sgd_minibatch_size": MB, "num_sgd_iter": ITERS, "lr": 3e-4,
    "kl_coeff": 0.2, "entropy_coeff": 0.01, "grad_clip": 40.0, "seed": 3,
    "model": {"fcnet_hiddens": [16, 16]},
}


def _ppo_batch(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.standard_normal((B, OBS)).astype(np.float32),
        "actions": (rng.standard_normal((B, ACT)) * 0.7).astype(np.float32),
        "action_logp": rng.uniform(-3, -1, B).astype(np.float32),
        "action_dist_inputs": (rng.standard_normal((B, 2 * ACT)) * 0.3).astype(np.float32),
        "advantages": rng.standard_normal(B).astype(np.float32),
        "value_targets": rng.standard_normal(B).astype(np.float32),
    }


def _reference_perms(key):
    _, rng = jax.random.split(key)
    rng = jax.random.fold_in(rng, 0)
    return np.stack([
        np.asarray(jax.random.permutation(jax.random.split(r)[0], B))
        for r in jax.random.split(rng, ITERS)
    ])


def test_ppo_diag_gaussian_learn_matches_reference():
    ref = PPOJaxPolicy(
        gym.spaces.Box(-8, 8, (OBS,), np.float32), gym.spaces.Box(-2, 2, (ACT,), np.float32),
        {**PPO_CONFIG, "_mesh": get_mesh(devices=jax.devices()[:1])},
    )
    port = PPOTorchPolicy(Box(-8, 8, (OBS,)), Box(-2, 2, (ACT,)), PPO_CONFIG, device="cpu")
    assert port.dist_class is tdists.DiagGaussian and port.num_outputs == 2 * ACT
    from_jax_params(jax.device_get(ref.params), port.model)
    perms = _reference_perms(ref._rng)
    batch = _ppo_batch()
    ref_stats = ref.learn_on_batch(batch)
    stats = port.learn_on_batch(batch, perms=torch.as_tensor(perms))
    assert set(stats) == set(ref_stats)
    for k, v in ref_stats.items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    got = port.get_weights()
    for name, r in flax_to_state_dict(jax.device_get(ref.params)).items():
        np.testing.assert_allclose(got[name], r, rtol=1e-5, atol=1.5e-5, err_msg=name)


def test_pendulum_ppo_yaml_iteration_on_the_cpu():
    algo, stop = build_tuned_example(
        REPO / "tuned_examples" / "ppo" / "pendulum-ppo.yaml", device="cpu",
        train_batch_size=256, rollout_fragment_length=32, num_sgd_iter=2, sgd_minibatch_size=64,
    )
    try:
        assert stop == {"episode_reward_mean": -400, "timesteps_total": 400000}
        policy = algo.get_policy()
        assert policy.dist_class is tdists.DiagGaussian
        result = algo.train()
        assert result["num_env_steps_sampled"] == 256
        learner = result["info"]["learner"]["default_policy"]
        assert all(np.isfinite(v) for v in learner.values())
        batch = algo.workers.local_worker().sample()
        assert batch["actions"].dtype == np.float32 and batch["actions"].shape == (256, 1)
    finally:
        algo.stop()
