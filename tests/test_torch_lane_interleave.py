"""The device lane's rest on the CPU: ``learn_while_rollout``, tensor
envs on the actor lane (``TensorVectorEnvAdapter``) and evaluation for a
device-lane run.

- ``learn_while_rollout`` on DQN's device lane, with a K = 2 superstep
  (the fill runs while the superstep's slots run): the sampled and
  trained counters equal the serial cadence's round by round; two
  fixed-seed runs are bitwise equal (parameters, trees, generators);
  the first interleaved round's draws are made before its fill's rows
  are in (the ring's count at the draw is the round's start count) and
  the fill acted with the weights from before the round's updates (it
  acts through the acting copy, which equals the parameters the round
  started from as the fill begins and after the round); on host
  rings and on host trees the interleaved run equals the device-ring
  run's, bitwise. At K = 1 (the reference's CPU cadence, whose
  superstep does not run on JAX 0.9) the counters and the rounds the
  cadence engages in equal the reference's interleaved run of the same
  config on its host tree, round by round (its draws follow priorities
  from its own initial weights; ``tests/test_torch_dqn.py`` holds the
  first draw).
- The adapter's trajectories are the device lane's at the same seed,
  bitwise (observations, rewards, terminated and truncated flags, the
  reset observations), on CartPole and PongLite with episodes ending
  mid-fragment, under the lane's own actions; a ``RolloutWorker`` over
  a tensor env samples through the adapter from the lane's first reset.
- A device-lane PPO run with one remote evaluation worker returns
  ``evaluation`` results from the adapter.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ray_tpu.algorithms.dqn.dqn import DQNConfig as JDQNConfig
from ray_tpu_torch import core
from ray_tpu_torch.algorithms.dqn.dqn import DQNConfig
from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig, PPOTorchPolicy
from ray_tpu_torch.env.control_tensor import CartPoleTensor
from ray_tpu_torch.env.pong_lite_tensor import PongLiteTensor
from ray_tpu_torch.env.registry import get_env_creator
from ray_tpu_torch.env.tensor_env import TensorVectorEnvAdapter
from ray_tpu_torch.evaluation.rollout_worker import RolloutWorker
from ray_tpu_torch.execution.device_rollout import DeviceRolloutEngine

ROUNDS = 8


@pytest.fixture(scope="module", autouse=True)
def runtime():
    yield
    if core.is_initialized():
        core.shutdown()


def _lane_cfg(cls, interleave, **over):
    cfg = (cls().environment("CartPoleJax-v0", env_backend="jax")
           .rollouts(num_envs_per_worker=4, rollout_fragment_length=8)
           .training(train_batch_size=32, num_steps_sampled_before_learning_starts=64,
                     replay_buffer_config={"prioritized_replay": True, "capacity": 2000},
                     learn_while_rollout=interleave, training_intensity=4.0,
                     target_network_update_freq=256, model={"fcnet_hiddens": [16, 16]})
           .debugging(seed=0))
    cfg.update_from_dict(over)
    return cfg


def _run(interleave, superstep=2, **over):
    algo = _lane_cfg(DQNConfig, interleave, superstep=superstep, **over).resources(device="cpu").build()
    counters = []
    for _ in range(ROUNDS):
        algo.train()
        counters.append((algo._counters["num_env_steps_sampled"],
                         algo._counters["num_env_steps_trained"],
                         algo._counters["num_target_updates"]))
    return algo, counters


def test_interleave_counters_determinism_and_staleness(monkeypatch):
    serial, c0 = _run(False)
    assert c0[-1][1] > 0
    a, c1 = _run(True)
    assert c1 == c0
    b, c2 = _run(True)
    assert c2 == c1
    for x, y in zip(a.get_policy().params, b.get_policy().params):
        assert torch.equal(x, y)
    ba, bb = (algo.local_replay_buffer.buffers["default_policy"] for algo in (a, b))
    assert torch.equal(ba._dtree.sum_value, bb._dtree.sum_value)
    assert ba._rng.bit_generator.state == bb._rng.bit_generator.state
    assert not all(torch.equal(x, y) for x, y in zip(a.get_policy().params,
                                                      serial.get_policy().params))
    # the first interleaved round: draws before the fill's rows, acting on the old weights
    c = _lane_cfg(DQNConfig, True, superstep=2).resources(device="cpu").build()
    buf = None
    while not c._interleave_ready():
        c.train()
        buf = c.local_replay_buffer.buffers["default_policy"]
    start, seen = buf.num_added, []
    params_before = [p.detach().clone() for p in c.get_policy().params]
    feed = buf.superstep_feed

    def recorded(*args, **kw):
        seen.append(buf.num_added)
        return feed(*args, **kw)

    eng, acted = c._rollout_engine, []
    rollout = eng.rollout

    def watched(*args, **kw):  # the model the fill acts through, as the fill begins
        model = c.get_policy().model
        acted.append(model is c._acting_model and all(
            torch.equal(x, y) for x, y in zip(model.parameters(), params_before)))
        return rollout(*args, **kw)

    monkeypatch.setattr(buf, "superstep_feed", recorded)
    monkeypatch.setattr(eng, "rollout", watched)
    c.training_step()
    assert seen == [start, start] and buf.num_added == start + 32  # 4 updates: 2 supersteps
    assert acted == [True]
    assert all(torch.equal(x, y) for x, y in zip(c._acting_model.parameters(), params_before))
    assert not all(torch.equal(x, y) for x, y in zip(c.get_policy().params, params_before))


@pytest.mark.parametrize("over", [{"replay_device_resident": False}, {"replay_device_tree": False}])
def test_interleave_on_host_rings_and_trees_equals_device_rings(over):
    a, ca = _run(True)
    b, cb = _run(True, **over)
    assert ca == cb
    for x, y in zip(a.get_policy().params, b.get_policy().params):
        assert torch.equal(x, y)


def test_interleave_counters_match_reference_at_k1():
    cfg = _lane_cfg(JDQNConfig, True, replay_device_resident=True, replay_device_tree=False)
    ref = cfg.resources(learner_devices=1).build()
    ready = []
    try:
        ref_counters = []
        for i in range(ROUNDS):
            ref.train()
            ready.append(ref._interleave_ready())
            ref_counters.append((ref._counters["num_env_steps_sampled"],
                                 ref._counters["num_env_steps_trained"],
                                 ref._counters.get("num_target_updates", 0)))
    finally:
        ref.cleanup()
    port = _lane_cfg(DQNConfig, True, superstep=1).resources(device="cpu").build()
    counters = []
    for i in range(ROUNDS):
        port.train()
        assert port._interleave_ready() == ready[i], i
        counters.append((port._counters["num_env_steps_sampled"],
                         port._counters["num_env_steps_trained"],
                         port._counters["num_target_updates"]))
    assert counters == ref_counters and counters[-1][1] > 0 and sum(ready) >= ROUNDS - 3


# -- tensor envs on the actor lane -------------------------------------------------------


@pytest.mark.parametrize("env_name", ["cartpole", "ponglite"])
def test_adapter_trajectories_equal_the_device_lane(env_name):
    if env_name == "cartpole":
        env, model = CartPoleTensor({"max_steps": 3}), {"fcnet_hiddens": [8]}
    else:
        env = PongLiteTensor({"max_steps": 3, "rallies": 21})
        model = {"conv_filters": [[4, [8, 8], [4, 4]], [4, [4, 4], [2, 2]]],
                 "post_fcnet_hiddens": [8], "dtype": "float32"}
    n, t = 4, 7
    policy = PPOTorchPolicy(env.observation_space, env.action_space,
                            {"seed": 0, "model": model}, device="cpu")
    batch, _ = DeviceRolloutEngine(policy, env, n, t, seed=5, postprocess="none").rollout()
    shape = tuple(env.observation_space.shape)
    obs = batch["obs"].reshape((n, t) + shape).numpy()
    new_obs = batch["new_obs"].reshape((n, t) + shape).numpy()
    actions = batch["actions"].reshape(n, t).numpy()
    cols = {k: batch[k].reshape(n, t).numpy() for k in ("rewards", "dones", "truncateds")}
    ad = TensorVectorEnvAdapter(env, n, seed=5)
    first, _ = ad.vector_reset()
    assert all(np.array_equal(first[i], obs[i, 0]) for i in range(n))
    resets = 0
    for s in range(t):
        o, rew, term, trunc, _ = ad.vector_step([actions[i, s] for i in range(n)])
        for i in range(n):
            assert o[i].tobytes() == new_obs[i, s].tobytes(), (s, i)
            assert (rew[i], term[i], trunc[i]) == (
                float(cols["rewards"][i, s]), bool(cols["dones"][i, s]),
                bool(cols["truncateds"][i, s]))
            nxt = o[i]
            if term[i] or trunc[i]:
                nxt, _ = ad.reset_at(i)
                resets += 1
            if s + 1 < t:
                assert nxt.tobytes() == obs[i, s + 1].tobytes(), (s, i)
    assert resets >= n * 2


def test_rollout_worker_samples_a_tensor_env_through_the_adapter():
    env = get_env_creator("CartPoleJax-v0")({})
    worker = RolloutWorker(
        env_creator=get_env_creator("CartPoleJax-v0"), policy_cls=PPOTorchPolicy,
        config={"num_envs_per_worker": 3, "rollout_fragment_length": 10, "seed": 4,
                "model": {"fcnet_hiddens": [8]}},
        device="cpu",
    )
    assert isinstance(worker.vector_env, TensorVectorEnvAdapter)
    batch = worker.sample()
    policy = PPOTorchPolicy(env.observation_space, env.action_space, {"seed": 0}, device="cpu")
    lane = DeviceRolloutEngine(policy, env, 3, 1, seed=4, postprocess="none")
    first = batch["obs"][batch["t"] == 0][:1]
    assert batch.count == 30 and first.tobytes() == lane.carry["obs"][:1].numpy().tobytes()
    worker.stop()


def test_device_lane_evaluation_with_a_remote_worker():
    algo = (PPOConfig().environment("CartPoleJax-v0", env_backend="jax")
            .rollouts(num_envs_per_worker=4, rollout_fragment_length=16)
            .training(train_batch_size=64, sgd_minibatch_size=32, num_sgd_iter=1,
                      model={"fcnet_hiddens": [16]})
            .evaluation(evaluation_interval=2, evaluation_duration=4, evaluation_num_workers=1)
            .resources(device="cpu").build())
    try:
        results = [algo.train() for _ in range(2)]
        assert len(algo.evaluation_workers.remote_workers()) == 1
    finally:
        algo.stop()
    assert "evaluation" not in results[0]
    ev = results[1]["evaluation"]
    assert ev["episodes_this_iter"] >= 4 and np.isfinite(ev["episode_reward_mean"])
