"""External envs of the port against the reference's, on the CPU.

Contracts:

- ``convert_to_base_env`` over CartPole-v1 (two sub-envs, seeded; the
  port's own CartPole, bitwise gymnasium's) polls and sends bitwise as
  the reference's over gymnasium's: observations, rewards, flags, the
  auto-reset and the terminal observation under ``__terminal_obs__``,
  through several episode ends; the poll/send turn is enforced; a
  multi-agent env resets on ``__all__`` with each agent's terminal
  observation;
- ``SyntheticFast-v0`` steps bitwise as the reference's;
- across packages: the reference's ``PolicyClient`` drives the port's
  ``PolicyServerInput`` and the port's client drives the reference's
  server through the same client script (two CartPole-v1 episodes, one
  terminated and one truncated, plus one with training disabled), the
  two PPO policies carrying the same weights and acting greedily. The
  episode batches agree column for column: observations, actions
  (the port's categorical samples are int64, JAX's int32: the values
  agree), rewards, flags and ``eps_id`` bitwise, the forward's outputs
  (``action_logp``, ``action_dist_inputs``, ``vf_preds``) and GAE's
  columns within 1e-5 relative plus 1e-5 absolute (float32 forwards in
  two frameworks); the episode metrics equal; server errors reach the
  client;
- PPO with no env and a ``PolicyServerInput`` as input trains from a
  client thread (``num_workers: 0``), and ``stop()`` shuts the server;
- the server's lock is the worker's act lock: ``learn_on_batch`` and
  ``set_weights`` hold it, END_EPISODE's postprocessing runs under it,
  and a GET_ACTION waits while another thread holds it; DQN's replay
  updates hold it on the same setup; IMPALA, whose learner thread does
  not, refuses the reader on its only worker.

The slow test runs the reference's external-env PPO to its bar of 80.
"""

from __future__ import annotations

import socket
import threading
import time
import types

import gymnasium as gym
import jax
import numpy as np
import pytest

from ray_tpu.algorithms.ppo.ppo import PPOConfig as JPPOConfig
from ray_tpu.algorithms.ppo.ppo import PPOJaxPolicy
from ray_tpu.env.base_env import convert_to_base_env as j_convert_to_base_env
from ray_tpu.env.policy_client import PolicyClient as JPolicyClient
from ray_tpu.env.policy_server_input import PolicyServerInput as JPolicyServerInput
from ray_tpu.env.synthetic_env import SyntheticEnv as JSyntheticEnv
from ray_tpu.env.vector_env import VectorEnv as JVectorEnv
from ray_tpu.sharding import get_mesh
from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig, PPOTorchPolicy
from ray_tpu_torch.env.base_env import BaseEnv, convert_to_base_env
from ray_tpu_torch.env.cartpole import CartPoleEnv
from ray_tpu_torch.env.multi_agent_env import make_multi_agent
from ray_tpu_torch.env.policy_client import PolicyClient
from ray_tpu_torch.env.policy_server_input import PolicyServerInput
from ray_tpu_torch.env.registry import get_env_creator
from ray_tpu_torch.env.spaces import Box, Discrete
from ray_tpu_torch.env.vector_env import VectorEnv
from ray_tpu_torch.utils.jax_params import from_jax_params


def _flat(poll):
    """A poll's five dicts as a comparable nested structure of bytes."""
    def enc(v):
        if isinstance(v, dict):
            return {k: enc(x) for k, x in sorted(v.items(), key=lambda kv: str(kv[0]))}
        if isinstance(v, np.ndarray):
            return (v.dtype.str, v.shape, v.tobytes())
        return (type(v).__name__, v)
    return enc(dict(enumerate(poll)))


def test_base_env_matches_reference():
    ref = j_convert_to_base_env(JVectorEnv.vectorize_gym_envs(
        lambda i: gym.make("CartPole-v1"), 2, seed=7))
    port = convert_to_base_env(VectorEnv.vectorize_gym_envs(lambda i: CartPoleEnv(), 2, seed=7))
    assert isinstance(port, BaseEnv) and convert_to_base_env(port) is port
    rng = np.random.default_rng(0)
    ends = 0
    for _ in range(120):
        got, want = port.poll(), ref.poll()
        assert _flat(got) == _flat(want)
        ends += sum("__terminal_obs__" in got[4][i]["agent0"] for i in got[4])
        acts = rng.integers(0, 2, 2)
        action_dict = {i: {"agent0": int(acts[i])} for i in range(2)}
        port.send_actions(action_dict)
        ref.send_actions(action_dict)
    assert ends >= 4  # several auto-resets compared
    port.poll()
    with pytest.raises(RuntimeError, match="twice"):
        port.poll()
    port.send_actions({0: {"agent0": 0}, 1: {"agent0": 1}})
    with pytest.raises(RuntimeError, match="without a poll"):
        port.send_actions({0: {"agent0": 0}, 1: {"agent0": 1}})
    assert port.try_reset(1)["agent0"].shape == (4,)
    with pytest.raises(ValueError, match="make_env"):
        convert_to_base_env(CartPoleEnv(), num_envs=2)


def test_multi_agent_base_env_resets_on_all():
    env = make_multi_agent("CartPole-v1")({"num_agents": 2})
    env.reset(seed=3)
    base = convert_to_base_env(env)
    seen_end = False
    for _ in range(200):
        obs, rewards, terms, truncs, infos = base.poll()
        if any("__terminal_obs__" in (infos[0].get(a) or {}) for a in (0, 1)):
            seen_end = True
            assert set(obs[0]) == {0, 1}  # the reset's first observations
            assert all(infos[0][a]["__terminal_obs__"].shape == (4,) for a in infos[0])
        base.send_actions({0: {a: 1 for a in obs[0]}})
    assert seen_end


def test_synthetic_env_matches_reference():
    cfg = {"obs_dim": 5, "num_actions": 3, "episode_len": 7, "pool": 11, "seed": 4}
    port, ref = get_env_creator("SyntheticFast-v0")(cfg), JSyntheticEnv(cfg)
    assert port.observation_space.shape == (5,) and port.action_space.n == 3
    for a, b in zip(port.reset(), ref.reset()):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes() or a == b
    for t in range(20):
        got, want = port.step(t % 3), ref.step(t % 3)
        assert got[0].tobytes() == want[0].tobytes() and got[1:4] == want[1:4]
        if got[3]:
            port.reset()
            ref.reset()


# -- the policy server across packages ------------------------------------------------------

MODEL = {"fcnet_hiddens": [16, 16], "dtype": "float32"}


def _greedy(policy):
    """Serve the policy's mode: the server asks for ``explore`` per
    episode; both frameworks' argmax of the same weights then agree."""
    act = policy.compute_single_action
    policy.compute_single_action = lambda obs, state=None, explore=True, **kw: act(
        obs, state, explore=False, **kw)
    return policy


def _policies():
    ref_cfg = {**JPPOConfig().to_dict(), "model": MODEL, "seed": 5}
    ref_cfg.pop("env", None)
    ref = PPOJaxPolicy(gym.spaces.Box(-np.inf, np.inf, (4,), np.float32), gym.spaces.Discrete(2),
                       {**ref_cfg, "_mesh": get_mesh(devices=jax.devices()[:1])})
    cfg = {**PPOConfig().to_dict(), "model": MODEL, "seed": 5}
    cfg.pop("env", None)
    port = PPOTorchPolicy(Box(-np.inf, np.inf, (4,)), Discrete(2), cfg, device="cpu")
    from_jax_params(jax.device_get(ref.params), port.model)
    return _greedy(ref), _greedy(port)


def _ioctx(policy):
    return types.SimpleNamespace(worker=types.SimpleNamespace(
        policy_map={"default_policy": policy}, preprocessor=None, filters={}))


def _client_script(client):
    """Two training episodes of the port's CartPole-v1 (seeded): one to
    its termination, one cut at 5 steps as a truncation; then one
    episode with training disabled, and an unknown episode id."""
    env = CartPoleEnv()
    for k, seed in enumerate((11, 12)):
        obs, _ = env.reset(seed=seed)
        eid = client.start_episode(episode_id=f"episode-{k}")
        for t in range(500):
            action = client.get_action(eid, obs)
            obs, reward, term, trunc, _ = env.step(int(action))
            client.log_returns(eid, reward)
            if term or (k == 1 and t == 4):
                break
        client.end_episode(eid, obs, truncated=not term)
    obs, _ = env.reset(seed=13)
    eid = client.start_episode(episode_id="eval", training_enabled=False)
    client.get_action(eid, obs)
    client.log_returns(eid, 1.0)
    client.end_episode(eid, obs)
    with pytest.raises(RuntimeError, match="unknown episode"):
        client.get_action("nobody", obs)


def _serve(server_cls, client_cls, policy):
    server = server_cls(_ioctx(policy), "127.0.0.1", 0)
    try:
        _client_script(client_cls(f"127.0.0.1:{server.port}", timeout=30))
        batches = [server.next() for _ in range(2)]
        metrics = [(m.episode_length, m.episode_reward) for m in server.get_metrics()]
        assert server._batches.empty()
    finally:
        server.shutdown()
    return batches, metrics


def test_clients_and_servers_across_packages():
    ref_policy, port_policy = _policies()
    port_batches, port_metrics = _serve(PolicyServerInput, JPolicyClient, port_policy)
    ref_batches, ref_metrics = _serve(JPolicyServerInput, PolicyClient, ref_policy)
    assert port_metrics == ref_metrics and len(port_metrics) == 3
    assert port_metrics[1][0] == 5
    for got, want in zip(port_batches, ref_batches):
        assert set(got.keys()) == set(want.keys())
        for k in want.keys():
            g, w = np.asarray(got[k]), np.asarray(want[k])
            if k == "actions":  # torch samples int64, JAX int32: the values agree
                assert (g.dtype, w.dtype) == (np.int64, np.int32)
                g = g.astype(np.int32)
            assert g.dtype == w.dtype and g.shape == w.shape, k
            if k in ("action_logp", "action_dist_inputs", "vf_preds", "advantages",
                     "value_targets"):
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=k)
            else:
                assert g.tobytes() == w.tobytes(), k
    assert bool(port_batches[0]["dones"][-1]) and not bool(port_batches[1]["dones"][-1])
    assert bool(port_batches[1]["truncateds"][-1])


def _drive(address, stop, episodes):
    env = CartPoleEnv()
    client = PolicyClient(address, timeout=30)
    seed = 0
    while not stop.is_set() and seed < episodes:
        obs, _ = env.reset(seed=seed)
        seed += 1
        eid = client.start_episode()
        done = trunc = False
        try:
            while not done:
                obs, reward, term, trunc, _ = env.step(int(client.get_action(eid, obs)))
                client.log_returns(eid, reward)
                done = term or trunc
            client.end_episode(eid, obs, truncated=trunc)
        except (RuntimeError, OSError):
            if not stop.is_set():
                raise
            return


def _external_ppo(**training):
    return (PPOConfig()
            .environment(None, observation_space=Box(-np.inf, np.inf, (4,)),
                         action_space=Discrete(2))
            .rollouts(num_rollout_workers=0)
            .training(**training)
            .offline_data(input_=lambda ioctx: PolicyServerInput(ioctx, "127.0.0.1", 0))
            .debugging(seed=0).resources(device="cpu").build())


def test_external_env_ppo_trains_through_the_server():
    algo = _external_ppo(train_batch_size=128, sgd_minibatch_size=64, num_sgd_iter=2,
                         model={"fcnet_hiddens": [16]})
    worker = algo.workers.local_worker()
    assert worker.sampler is None and algo.env is None
    stop = threading.Event()
    client_thread = threading.Thread(target=_drive, daemon=True,
                              args=(f"127.0.0.1:{worker.input_reader.port}", stop, 10_000))
    client_thread.start()
    try:
        r = algo.train()
        assert r["timesteps_total"] >= 128 and r["episodes_this_iter"] >= 1
        assert np.isfinite(r["info"]["learner"]["default_policy"]["total_loss"])
    finally:
        stop.set()
        algo.stop()
    client_thread.join(timeout=30)
    assert not client_thread.is_alive()
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", worker.input_reader.port), timeout=2).close()
    with pytest.raises(ValueError, match="observation_space and action_space"):
        PPOConfig().resources(device="cpu").build()


def _held_elsewhere(lock) -> bool:
    """Whether ``lock`` is held: another thread cannot take it."""
    got = []
    t = threading.Thread(target=lambda: got.append(lock.acquire(blocking=False)))
    t.start()
    t.join()
    if got[0]:
        lock.release()
    return not got[0]


def test_server_and_learner_share_the_workers_act_lock(monkeypatch):
    import ray_tpu_torch.env.policy_server_input as psi

    algo = _external_ppo(train_batch_size=64, sgd_minibatch_size=32, num_sgd_iter=1,
                         model={"fcnet_hiddens": [8]})
    worker = algo.workers.local_worker()
    server, policy = worker.input_reader, worker.policy_map["default_policy"]
    assert worker.act_lock() is server.lock
    seen = {}

    def under_lock(name, fn):
        def wrapped(*a, **kw):
            seen[name] = _held_elsewhere(server.lock)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(policy, "learn_on_batch", under_lock("learn", policy.learn_on_batch))
    monkeypatch.setattr(policy, "set_weights", under_lock("set_weights", policy.set_weights))
    monkeypatch.setattr(psi, "postprocess_batch", under_lock("postprocess", psi.postprocess_batch))
    client = PolicyClient(f"127.0.0.1:{server.port}", timeout=30)
    try:
        eid = client.start_episode()
        answered = []
        with worker.act_lock():
            t = threading.Thread(target=lambda: answered.append(
                client.get_action(eid, np.zeros(4, np.float32))))
            t.start()
            t.join(timeout=0.5)
            assert t.is_alive() and not answered  # the action waits for the lock
        t.join(timeout=30)
        assert len(answered) == 1
        client.end_episode(eid, np.zeros(4, np.float32))
        stop = threading.Event()
        driver = threading.Thread(target=_drive, daemon=True,
                                  args=(f"127.0.0.1:{server.port}", stop, 10_000))
        driver.start()
        algo.train()
        worker.set_weights(worker.get_weights())
    finally:
        stop.set()
        algo.stop()
    driver.join(timeout=30)
    assert seen == {"learn": True, "set_weights": True, "postprocess": True}


def test_external_env_dqn_updates_under_the_act_lock():
    from ray_tpu_torch.algorithms.dqn.dqn import DQNConfig

    algo = (DQNConfig()
            .environment(None, observation_space=Box(-np.inf, np.inf, (4,)),
                         action_space=Discrete(2))
            .rollouts(num_rollout_workers=0)
            .training(train_batch_size=16, num_steps_sampled_before_learning_starts=16,
                      model={"fcnet_hiddens": [8]})
            .offline_data(input_=lambda ioctx: PolicyServerInput(ioctx, "127.0.0.1", 0))
            .debugging(seed=0).resources(device="cpu").build())
    server = algo.workers.local_worker().input_reader
    held = []
    phase = algo._replay_update_phase

    def update_phase(sampled):
        held.append(_held_elsewhere(server.lock))
        return phase(sampled)

    algo._replay_update_phase = update_phase
    stop = threading.Event()
    driver = threading.Thread(target=_drive, daemon=True,
                              args=(f"127.0.0.1:{server.port}", stop, 10_000))
    driver.start()
    try:
        infos = [algo.train()["info"]["learner"] for _ in range(2)]
    finally:
        stop.set()
        algo.stop()
    driver.join(timeout=30)
    assert held == [True, True]
    assert np.isfinite(infos[-1]["default_policy"]["mean_q"])


def test_callable_input_refused_where_the_learn_skips_the_act_lock():
    from ray_tpu_torch.algorithms.impala.impala import IMPALAConfig

    def reader(ioctx):
        raise AssertionError("no reader is built for a refused config")

    with pytest.raises(ValueError, match="act lock"):
        (IMPALAConfig()
         .environment(None, observation_space=Box(-np.inf, np.inf, (4,)), action_space=Discrete(2))
         .rollouts(num_rollout_workers=0).offline_data(input_=reader)
         .resources(device="cpu").build())


@pytest.mark.slow
def test_external_env_cartpole_learns_through_server():
    """The reference's external-env run: PPO through the server to a
    mean episode reward of 80."""
    algo = _external_ppo(train_batch_size=512, sgd_minibatch_size=128, num_sgd_iter=6, lr=1e-3,
                         entropy_coeff=0.01, clip_param=0.2, kl_coeff=0.0,
                         model={"fcnet_hiddens": [64, 64]})
    port = algo.workers.local_worker().input_reader.port
    stop = threading.Event()
    threading.Thread(target=_drive, args=(f"127.0.0.1:{port}", stop, 10 ** 9), daemon=True).start()
    try:
        best = -np.inf
        deadline = time.time() + 300
        while time.time() < deadline and best < 80.0:
            r = algo.train().get("episode_reward_mean", np.nan)
            if np.isfinite(r):
                best = max(best, r)
        assert best >= 80.0, f"external-env PPO failed to learn: {best}"
    finally:
        stop.set()
        algo.stop()
