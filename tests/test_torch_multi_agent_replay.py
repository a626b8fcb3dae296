"""The replay family over a policy map on the port's actor lane, against
the JAX package, on the CPU.

- ``MultiAgentReplayBuffer.add`` of a ``MultiAgentBatch``: one ring per
  policy, each policy's replay columns, bitwise the reference's rings
  after the same inserts;
- one round (three ``training_step`` calls: inserts, the first replay
  updates, the target sync of every policy) of two-policy DQN and of
  two-policy SAC on the reference's sampled batches, with the
  reference's permutations and normals injected: every policy's ring
  bitwise, counters equal, parameters within 1.5e-5 (the repo's Adam
  tolerance) and stats within 1e-5;
- two-policy DQN, prioritized, and two-policy SAC ``train()`` with the
  port's own sampler: both rings fill, both policies learn, both targets
  sync, priorities refresh per policy;
- every "item N" label in ``ray_tpu_torch/`` is one that ``ROADMAP.md``
  defines.
"""

from __future__ import annotations

import pathlib
import re

import gymnasium as gym
import jax
import numpy as np
import torch

from ray_tpu.algorithms.dqn import dqn as jdqn
from ray_tpu.algorithms.dqn.dqn import DQNConfig as JDQNConfig
from ray_tpu.algorithms.sac.sac import SACConfig as JSACConfig
from ray_tpu.data.sample_batch import MultiAgentBatch as JMultiAgentBatch
from ray_tpu.data.sample_batch import SampleBatch as JSampleBatch
from ray_tpu.env import registry as ref_registry
from ray_tpu.env.multi_agent_env import make_multi_agent as ref_make_multi_agent
from ray_tpu.execution.replay_buffer import MultiAgentReplayBuffer as JMultiAgentReplayBuffer
from ray_tpu_torch.algorithms.dqn import dqn as tdqn
from ray_tpu_torch.algorithms.dqn.dqn import DQNConfig
from ray_tpu_torch.algorithms.sac.sac import SACConfig
from ray_tpu_torch.data.sample_batch import MultiAgentBatch, SampleBatch
from ray_tpu_torch.env import registry
from ray_tpu_torch.env.multi_agent_env import make_multi_agent
from ray_tpu_torch.env.spaces import Box, Discrete
from ray_tpu_torch.execution.replay_buffer import MultiAgentReplayBuffer
from ray_tpu_torch.utils.jax_params import flax_to_state_dict, from_jax_params, from_jax_sac_state

REPO = pathlib.Path(__file__).resolve().parents[1]
CP_OBS, CP_ACT = Box(-np.inf, np.inf, (4,), np.float64), Discrete(2)
GYM_CP_OBS, GYM_CP_ACT = gym.spaces.Box(-np.inf, np.inf, (4,), np.float64), gym.spaces.Discrete(2)
PD_OBS, PD_ACT = Box(-8.0, 8.0, (3,), np.float32), Box(-2.0, 2.0, (1,), np.float32)
GYM_PD_OBS = gym.spaces.Box(-8.0, 8.0, (3,), np.float32)
GYM_PD_ACT = gym.spaces.Box(-2.0, 2.0, (1,), np.float32)


def _mapping(aid, *args, **kwargs):
    return f"p{aid % 2}"


def _register():
    for name, base in (("ma_cartpole_replay", "CartPole-v1"), ("ma_pendulum_replay", "Pendulum-v1")):
        registry.register_env(name, lambda cfg, b=base: make_multi_agent(b)({"num_agents": 2}))
        ref_registry.register_env(name, lambda cfg, b=base: ref_make_multi_agent(b)({"num_agents": 2}))


def _host(cols):
    return {k: np.asarray(v) for k, v in cols.items() if isinstance(v, np.ndarray) and v.dtype != object}


def _port_batch(ref_batch):
    return MultiAgentBatch({pid: SampleBatch(_host(b)) for pid, b in ref_batch.policy_batches.items()},
                           ref_batch.env_steps())


def _assert_rings_equal(port_buf, ref_buf, pids):
    assert set(port_buf.buffers) == set(ref_buf.buffers) == set(pids)
    for pid in pids:
        ps, rs = port_buf.buffers[pid].get_state(), ref_buf.buffers[pid].get_state()
        assert (ps["idx"], ps["size"]) == (rs["idx"], rs["size"]), pid
        assert set(ps["cols"]) == set(rs["cols"]), pid
        for k, v in rs["cols"].items():
            v = np.asarray(v)
            assert ps["cols"][k].dtype == v.dtype and ps["cols"][k].tobytes() == v.tobytes(), (pid, k)


def test_multi_agent_add_fills_one_ring_per_policy():
    rng = np.random.default_rng(0)

    def cols(n):
        return {"obs": rng.standard_normal((n, 4)).astype(np.float32),
                "actions": rng.integers(0, 2, n), "rewards": rng.standard_normal(n).astype(np.float32),
                "t": np.arange(n)}

    batches = [{"p0": cols(5), "p1": cols(3)}, {"p1": cols(7), "p0": cols(2)}]
    columns = {"p0": lambda sb: {"obs": np.asarray(sb["obs"]), "actions": np.asarray(sb["actions"])},
               "p1": lambda sb: {"obs": np.asarray(sb["obs"]), "rewards": np.asarray(sb["rewards"])}}
    port = MultiAgentReplayBuffer(8, seed=3, device="cpu",
                                  replay_columns_fn=lambda pid, sb: columns[pid](sb))
    ref = JMultiAgentReplayBuffer(8, seed=3, device_resident=True,
                                  replay_columns_fn=lambda pid, sb: columns[pid](sb))
    for b in batches:
        port.add(MultiAgentBatch({pid: SampleBatch(dict(c)) for pid, c in b.items()}, 8))
        ref.add(JMultiAgentBatch({pid: JSampleBatch(dict(c)) for pid, c in b.items()}, 8))
    _assert_rings_equal(port, ref, ("p0", "p1"))
    assert len(port.buffers["p0"]) == 7 and len(port.buffers["p1"]) == 8  # p1's ring wrapped
    assert set(port.sample(7)) == {"p0", "p1"} and set(port.sample(8)) == {"p1"}


# -- one round against the reference ----------------------------------------------------

DQN_COMMON = {"train_batch_size": 8, "lr": 5e-4, "model": {"fcnet_hiddens": [16, 16]}}


def _reference_perm(key, batch_size):
    _, rng = jax.random.split(key)
    (r,) = jax.random.split(jax.random.fold_in(rng, 0), 1)
    return torch.as_tensor(np.asarray(jax.random.permutation(jax.random.split(r)[0], batch_size)))[None]


def _record(monkeypatch, module, policies):
    """The reference's sampled batches, and each policy's key before each
    of its learn calls."""
    sampled, keys = [], {pid: [] for pid in policies}
    real_sample = module.synchronous_parallel_sample

    def record(**kw):
        batch = real_sample(**kw)
        sampled.append(batch)
        return batch

    monkeypatch.setattr(module, "synchronous_parallel_sample", record)
    for pid, policy in policies.items():
        real_learn = policy.learn_on_device_batch

        def learn(*args, _p=policy, _real=real_learn, _pid=pid, **kw):
            keys[_pid].append(_p._rng)
            return _real(*args, **kw)

        monkeypatch.setattr(policy, "learn_on_device_batch", learn)
    return sampled, keys


def _feed(monkeypatch, sampled):
    feed = iter(sampled)
    monkeypatch.setattr(tdqn, "synchronous_parallel_sample", lambda **kw: _port_batch(next(feed)))


def _assert_learners_close(port_info, ref_info, pids):
    for p, r in zip(port_info, ref_info):
        assert set(p) == set(r)
        for pid in pids:
            if pid in r:
                for k, v in r[pid].items():
                    np.testing.assert_allclose(p[pid][k], v, rtol=1e-5, atol=1e-5, err_msg=(pid, k))


def test_two_policy_dqn_round_matches_reference(monkeypatch):
    _register()
    pids = ("p0", "p1")
    jcfg = (JDQNConfig().environment("ma_cartpole_replay")
            .rollouts(num_rollout_workers=0, rollout_fragment_length=4)
            .training(replay_device_resident=True, **DQN_COMMON)
            .debugging(seed=3).resources(learner_devices=1))
    jcfg.num_steps_sampled_before_learning_starts = 8
    jcfg.target_network_update_freq = 16
    jcfg.replay_buffer_config.update({"capacity": 64})
    jcfg.multi_agent(policies={pid: (None, GYM_CP_OBS, GYM_CP_ACT, {}) for pid in pids},
                     policy_mapping_fn=_mapping)
    ref = jcfg.build()
    cfg = (DQNConfig().environment("ma_cartpole_replay")
           .rollouts(num_rollout_workers=0, rollout_fragment_length=4)
           .training(num_steps_sampled_before_learning_starts=8, target_network_update_freq=16,
                     replay_buffer_config={"capacity": 64}, **DQN_COMMON)
           .debugging(seed=3).resources(device="cpu"))
    cfg.multi_agent(policies={pid: (None, CP_OBS, CP_ACT, {}) for pid in pids},
                    policy_mapping_fn=_mapping)
    port = cfg.build()
    try:
        rps = {pid: ref.get_policy(pid) for pid in pids}
        pps = {pid: port.get_policy(pid) for pid in pids}
        for pid in pids:
            from_jax_params(jax.device_get(rps[pid].params), pps[pid].model)
            pps[pid].update_target()
        sampled, keys = _record(monkeypatch, jdqn, rps)
        ref_info = [ref.training_step() for _ in range(4)]
        _feed(monkeypatch, sampled)
        for pid in pids:
            perms = iter(keys[pid])
            monkeypatch.setattr(pps[pid], "draw_permutations",
                                lambda bs, _k=perms: _reference_perm(next(_k), bs))
        port_info = [port.training_step() for _ in range(4)]
        assert all(len(keys[pid]) >= 1 for pid in pids)
        for key in ("num_env_steps_sampled", "num_env_steps_trained", "num_target_updates"):
            assert port._counters[key] == ref._counters[key], key
        assert port._counters["num_target_updates"] >= 1
        _assert_rings_equal(port.local_replay_buffer, ref.local_replay_buffer, pids)
        _assert_learners_close(port_info, ref_info, pids)
        for pid in pids:
            got = pps[pid].get_weights()
            for name, r in flax_to_state_dict(jax.device_get(rps[pid].params)).items():
                np.testing.assert_allclose(got[name], r, rtol=1e-5, atol=1.5e-5, err_msg=(pid, name))
            target = flax_to_state_dict(jax.device_get(rps[pid].aux_state["target_params"]))
            for name, t in zip(pps[pid].param_names, pps[pid].aux_state["target_params"]):
                np.testing.assert_allclose(t.numpy(), target[name], rtol=1e-5, atol=1.5e-5)
    finally:
        ref.cleanup()
        port.stop()


SAC_HIDDEN = {"policy_model_config": {"fcnet_hiddens": [16, 16]},
              "q_model_config": {"fcnet_hiddens": [16, 16]}}


def _sac_normals(key, n):
    _, rng = jax.random.split(key)
    rng_t, rng_a = jax.random.split(jax.random.fold_in(rng, 0))
    return tuple(torch.as_tensor(np.array(jax.random.normal(r, (n, 1)))) for r in (rng_t, rng_a))


def test_two_policy_sac_round_matches_reference(monkeypatch):
    import ray_tpu.algorithms.sac.sac as jsac  # noqa: F401  (its round is jdqn's)

    _register()
    pids = ("p0", "p1")
    common = dict(train_batch_size=8, **SAC_HIDDEN)
    jcfg = (JSACConfig().environment("ma_pendulum_replay")
            .rollouts(num_rollout_workers=0, rollout_fragment_length=4)
            .training(replay_device_resident=True, **common)
            .debugging(seed=2).resources(learner_devices=1))
    jcfg.num_steps_sampled_before_learning_starts = 8
    jcfg.multi_agent(policies={pid: (None, GYM_PD_OBS, GYM_PD_ACT, {}) for pid in pids},
                     policy_mapping_fn=_mapping)
    ref = jcfg.build()
    cfg = (SACConfig().environment("ma_pendulum_replay")
           .rollouts(num_rollout_workers=0, rollout_fragment_length=4)
           .training(num_steps_sampled_before_learning_starts=8, **common)
           .debugging(seed=2).resources(device="cpu"))
    cfg.multi_agent(policies={pid: (None, PD_OBS, PD_ACT, {}) for pid in pids},
                    policy_mapping_fn=_mapping)
    port = cfg.build()
    try:
        rps = {pid: ref.get_policy(pid) for pid in pids}
        pps = {pid: port.get_policy(pid) for pid in pids}
        for pid in pids:
            from_jax_sac_state(pps[pid], jax.device_get(rps[pid].params),
                               jax.device_get(rps[pid].aux_state), jax.device_get(rps[pid].opt_state))
        sampled, keys = _record(monkeypatch, jdqn, rps)
        ref_info = [ref.training_step() for _ in range(4)]
        _feed(monkeypatch, sampled)
        for pid in pids:
            ks = iter(keys[pid])
            monkeypatch.setattr(pps[pid], "_draw_normals", lambda n, _k=ks: _sac_normals(next(_k), n))
        port_info = [port.training_step() for _ in range(4)]
        assert all(len(keys[pid]) >= 1 for pid in pids)
        for key in ("num_env_steps_sampled", "num_env_steps_trained"):
            assert port._counters[key] == ref._counters[key], key
        _assert_rings_equal(port.local_replay_buffer, ref.local_replay_buffer, pids)
        _assert_learners_close(port_info, ref_info, pids)
        for pid in pids:
            got = pps[pid].get_weights()
            for group in ("actor", "critic"):
                for name, r in flax_to_state_dict(jax.device_get(rps[pid].params[group])).items():
                    np.testing.assert_allclose(got[f"{group}.{name}"], r, rtol=1e-5, atol=1.5e-5,
                                               err_msg=(pid, name))
    finally:
        ref.cleanup()
        port.stop()


# -- the port's own rounds -------------------------------------------------------------


def _two_policy(config_cls, env, obs, act, **training):
    cfg = (config_cls().environment(env).rollouts(num_rollout_workers=0, rollout_fragment_length=8)
           .training(**training).debugging(seed=1).resources(device="cpu"))
    cfg.multi_agent(policies={pid: (None, obs, act, {}) for pid in ("p0", "p1")},
                    policy_mapping_fn=_mapping)
    return cfg.build()


def test_two_policy_dqn_prioritized_trains():
    _register()
    algo = _two_policy(DQNConfig, "ma_cartpole_replay", CP_OBS, CP_ACT,
                       num_steps_sampled_before_learning_starts=16, target_network_update_freq=32,
                       replay_buffer_config={"capacity": 256, "prioritized_replay": True},
                       n_step=2, **DQN_COMMON)
    try:
        before = {pid: {n: v.copy() for n, v in algo.get_policy(pid).get_weights().items()}
                  for pid in ("p0", "p1")}
        results = [algo.train() for _ in range(6)]
        bufs = algo.local_replay_buffer.buffers
        # each agent's steps go to its policy's ring (an agent whose
        # episode ended adds none until its env resets)
        assert set(bufs) == {"p0", "p1"} and all(24 <= len(b) <= 48 for b in bufs.values())
        assert all("n_steps" in b._store for b in bufs.values())
        assert set(results[-1]["info"]["learner"]) == {"p0", "p1"}
        assert algo._counters["num_target_updates"] >= 1
        for pid in ("p0", "p1"):
            after = algo.get_policy(pid).get_weights()
            assert any(not np.array_equal(after[n], before[pid][n]) for n in after), pid
            # the refreshed priorities left the max priority's uniform start
            leaves = bufs[pid]._dtree.leaf_values(len(bufs[pid]))
            assert len(np.unique(leaves)) > 1, pid
            assert algo.get_policy(pid).aux_state["target_params"][0].data_ptr() != \
                algo.get_policy(pid).params[0].data_ptr()
    finally:
        algo.stop()


def test_two_policy_sac_trains():
    _register()
    algo = _two_policy(SACConfig, "ma_pendulum_replay", PD_OBS, PD_ACT,
                       num_steps_sampled_before_learning_starts=16, train_batch_size=8, **SAC_HIDDEN)
    try:
        results = [algo.train() for _ in range(4)]
        assert set(results[-1]["info"]["learner"]) == {"p0", "p1"}
        assert all(len(b) == 32 for b in algo.local_replay_buffer.buffers.values())
        assert all(np.isfinite(list(i.values())).all() for i in results[-1]["info"]["learner"].values())
    finally:
        algo.stop()


# -- the refusals' labels ----------------------------------------------------------------

_LABEL = re.compile(r"\bitems?\s+(\d+[a-z]?(?:\.\d+)?)")


def _roadmap_labels():
    """The labels ``ROADMAP.md`` defines: each queue 1 entry's
    ``[item X]`` or ``[items X-Y]`` heading, the sub-items it names in
    bold (``**item X**``) and the labels of its done table."""
    text = (REPO / "ROADMAP.md").read_text()
    labels = set()
    for lo, hi in re.findall(r"\[items? (\d+(?:\.\d+)?)(?:-(\d+(?:\.\d+)?))?\]", text):
        labels.add(lo)
        if hi:
            major, a = lo.split(".")
            labels.update(f"{major}.{i}" for i in range(int(a), int(hi.split(".")[1]) + 1))
    labels.update(re.findall(r"\*\*\[?item (\d+[a-z]?(?:\.\d+)?)\]?\*\*", text))
    labels.update(re.findall(r"\| (?:item|items) (\d+[a-z]?(?:\.\d+)?)", text))
    return labels


def test_every_item_label_in_the_port_is_defined():
    labels = _roadmap_labels()
    assert {"1", "3d", "4b", "5", "9", "6.2", "6.3", "8.3"} <= labels
    used = {}
    for path in sorted((REPO / "ray_tpu_torch").rglob("*.py")):
        for label in _LABEL.findall(path.read_text()):
            used.setdefault(label, []).append(path.relative_to(REPO).as_posix())
    missing = {label: where for label, where in used.items() if label not in labels}
    assert not missing, missing
    assert "3b.2" not in used
