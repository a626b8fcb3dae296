"""Ape-X DQN on the port, against the reference, on the CPU.

- The per-worker epsilon ladder ``eps_i = 0.4 ** (1 + 7 (i - 1) / (n -
  1))`` for n in {1, 3, 8}: the port's fold of the exploration config
  equals the reference's, bitwise, and a worker's policy explores at its
  rung.
- Ape-X's rounds at ``num_workers: 0`` against the reference's device
  plane (``replay_device_resident=True``: on the CPU its shards keep
  their rows as device arrays beside host sum trees, which the port's
  f64 descent matches bitwise), on the fragments the reference sampled
  and its learn calls' permutations, over six ``training_step`` calls:
  the shards' seeds (``seed + 100 + i``), the round-robin routing, the
  n-step-folded rows each shard holds, the draws, the counters and the
  target-update count bitwise; the priorities and the first learn call
  (its stats and the parameters after it) within the learn tests'
  1.5e-5.
- ``worker_side_prioritization``: a fragment's rows enter at their own
  powered |TD| errors.
- The registry builds "APEX"; ``cartpole-apex.yaml`` builds and trains
  through ``build_tuned_example`` (two remote workers instead of the
  yaml's three, to keep the test's processes few), each worker at its
  rung of the ladder; a checkpoint round-trips the shards; the registry
  resolves ``APEX_DDPG``, ``replay_device_resident=False`` builds the
  object plane of ``ReplayActor`` processes (``tests/test_torch_apex_host.py``
  holds both against the reference), whose actors ``stop`` ends.
"""

from __future__ import annotations

import pathlib
import time

import jax
import numpy as np
import pytest
import torch

from ray_tpu.algorithms.apex_dqn import ApexDQNConfig as JApexDQNConfig
from ray_tpu.algorithms.dqn.dqn import _epsilon_exploration_config as j_epsilon_config
from ray_tpu_torch.algorithms.apex_dqn.apex_dqn import ApexDQNConfig
from ray_tpu_torch.algorithms.dqn.dqn import DQNTorchPolicy, _epsilon_exploration_config
from ray_tpu_torch.algorithms.registry import get_algorithm_class
from ray_tpu_torch.data.sample_batch import SampleBatch
from ray_tpu_torch.env.spaces import Box, Discrete
from ray_tpu_torch.execution.replay_buffer import powered_priorities
from ray_tpu_torch.utils.jax_params import flax_to_state_dict, from_jax_params
from ray_tpu_torch.utils.tuned_example import build_tuned_example

REPO = pathlib.Path(__file__).resolve().parents[1]
APEX_YAML = REPO / "tuned_examples" / "apex_dqn" / "cartpole-apex.yaml"
FLAT = {"initial_epsilon": 1.0, "final_epsilon": 0.02, "epsilon_timesteps": 10000}


def _ladder(i, n):
    return 0.4 ** (1.0 + 7.0 * (i - 1) / max(1, n - 1))


@pytest.mark.parametrize("n", [1, 3, 8])
def test_epsilon_ladder_matches_reference(n):
    for i in range(n + 1):
        cfg = {**FLAT, "per_worker_exploration": True, "worker_index": i, "num_workers": n}
        got = _epsilon_exploration_config(cfg)
        assert got == j_epsilon_config(cfg), i
        if i:
            assert got["initial_epsilon"] == got["final_epsilon"] == _ladder(i, n)
        else:
            assert got == FLAT  # the local worker keeps the schedule
    policy = DQNTorchPolicy(Box(-1.0, 1.0, (4,), np.float32), Discrete(2),
                            {**FLAT, "per_worker_exploration": True, "worker_index": n,
                             "num_workers": n, "model": {"fcnet_hiddens": [8]}}, device="cpu")
    coeffs = {}
    for t in (0, 5000, 50000):
        policy.exploration.update_coeffs(coeffs, t)
        assert coeffs["epsilon"] == pytest.approx(_ladder(n, n), rel=1e-6), t


# -- rounds against the reference -----------------------------------------------------

COMMON = {"train_batch_size": 16, "lr": 5e-4, "model": {"fcnet_hiddens": [16, 16]}}
STEPS = 6


def _reference():
    cfg = (JApexDQNConfig().environment("CartPole-v1")
           .rollouts(num_rollout_workers=0, rollout_fragment_length=8)
           .training(replay_device_resident=True, **COMMON)
           .debugging(seed=3).resources(learner_devices=1))
    cfg.num_steps_sampled_before_learning_starts = 16
    cfg.target_network_update_freq = 32
    cfg.replay_buffer_config.update({"capacity": 64})
    return cfg.build()


def _port():
    return (ApexDQNConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, rollout_fragment_length=8)
            .training(num_steps_sampled_before_learning_starts=16, target_network_update_freq=32,
                      replay_buffer_config={"capacity": 64}, **COMMON)
            .debugging(seed=3).resources(device="cpu").build())


def _record_draws(shards, into):
    for i, shard in enumerate(shards):
        sample = shard.sample

        def recorded(*args, _i=i, _sample=sample, **kwargs):
            b = _sample(*args, **kwargs)
            idx = b.indices.cpu() if isinstance(b.indices, torch.Tensor) else b.indices
            into.append((_i, np.asarray(idx)))
            return b

        shard.sample = recorded


def _reference_perm(keys):
    def perm(batch_size):
        _, rng = jax.random.split(next(keys))
        (r,) = jax.random.split(jax.random.fold_in(rng, 0), 1)
        return torch.as_tensor(np.asarray(jax.random.permutation(jax.random.split(r)[0],
                                                                 batch_size)))[None]
    return perm


def test_apex_rounds_match_reference(monkeypatch):
    ref = _reference()
    try:
        rp = ref.get_policy()
        assert ref._apex_device and len(ref.replay_shards) == 2
        assert all(s.tree_plane == "host" for s in ref.replay_shards)
        init = jax.device_get(rp.params)
        sampled, keys, ref_draws = [], [], []
        local = ref.workers.local_worker()
        real_sample = local.sample

        def record():
            batch = real_sample()
            sampled.append({k: np.array(v) for k, v in batch.items()
                            if isinstance(v, np.ndarray) and v.dtype != object})
            return batch

        monkeypatch.setattr(local, "sample", record)
        real_learn = rp.learn_on_device_batch

        def learn(*args, **kw):
            keys.append(rp._rng)
            return real_learn(*args, **kw)

        monkeypatch.setattr(rp, "learn_on_device_batch", learn)
        _record_draws(ref.replay_shards, ref_draws)
        ref_out, ref_counters, first_ref_params = [], [], None
        for _ in range(STEPS):
            ref_out.append(ref.training_step())
            ref_counters.append(dict(ref._counters))
            if first_ref_params is None and keys:
                first_ref_params = flax_to_state_dict(jax.device_get(rp.params))
        ref_shards = [s.get_state() for s in ref.replay_shards]
    finally:
        ref.cleanup()

    port = _port()
    try:
        pp = port.get_policy()
        from_jax_params(init, pp.model)
        pp.update_target()
        assert [s._rng.bit_generator.state == np.random.default_rng(103 + i).bit_generator.state
                for i, s in enumerate(port.replay_shards)] == [True, True]
        feed = iter(sampled)
        monkeypatch.setattr(port.workers.local_worker(), "sample",
                            lambda: SampleBatch({k: v.copy() for k, v in next(feed).items()}))
        monkeypatch.setattr(pp, "draw_permutations", _reference_perm(iter(keys)))
        port_draws, first_learn = [], None
        _record_draws(port.replay_shards, port_draws)
        for step in range(STEPS):
            out = port.training_step()
            for key in ("num_env_steps_sampled", "num_env_steps_trained", "num_target_updates"):
                assert port._counters[key] == ref_counters[step].get(key, 0), (step, key)
            if first_learn is None and out:
                first_learn = step
                got = pp.get_weights()
                for name, want in first_ref_params.items():
                    np.testing.assert_allclose(got[name], want, rtol=1e-5, atol=1.5e-5,
                                               err_msg=name)
                for k, v in ref_out[step]["default_policy"].items():
                    np.testing.assert_allclose(out["default_policy"][k], v, rtol=1e-5,
                                               atol=1.5e-5, err_msg=k)
        assert first_learn == 2  # 24 rows: the first shard holds a batch first
        assert port._counters["num_target_updates"] >= 1 and len(keys) >= 4
        assert [i for i, _ in port_draws] == [i for i, _ in ref_draws]
        for (_, a), (_, b) in zip(port_draws, ref_draws):
            np.testing.assert_array_equal(a, b)
        for shard, want in zip(port.replay_shards, ref_shards):
            got = shard.get_state()
            assert (got["idx"], got["size"], got["num_added"]) == (
                want["idx"], want["size"], want["num_added"])
            assert set(got["cols"]) == set(want["cols"]) and "n_steps" in got["cols"]
            for k, v in want["cols"].items():
                v = np.asarray(v)
                assert got["cols"][k].dtype == v.dtype and np.array_equal(got["cols"][k], v), k
            np.testing.assert_allclose(got["priorities"]["leaf_values"],
                                       want["priorities"]["leaf_values"], rtol=1e-5, atol=1e-7)
            assert got["priorities"]["max_priority"] == pytest.approx(
                want["priorities"]["max_priority"], rel=1e-5)
    finally:
        port.stop()


def test_worker_side_prioritization_inserts_at_td_errors():
    algo = (ApexDQNConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, rollout_fragment_length=8)
            .training(num_steps_sampled_before_learning_starts=10 ** 6, **COMMON)
            .debugging(seed=1).resources(device="cpu").build())
    algo.config["worker_side_prioritization"] = True
    try:
        algo.training_step()
        shard = algo.replay_shards[0]
        batch = shard.gather(np.arange(8))
        want, _ = powered_priorities(algo.get_policy().compute_td_error(batch) + 1e-6, 0.6)
        got = shard.get_state()["priorities"]["leaf_values"]
        np.testing.assert_array_equal(got, want)
        assert len(algo.replay_shards[1]) == 0
    finally:
        algo.stop()


# -- the entry points ------------------------------------------------------------------


def test_tuned_example_trains_with_the_ladder_and_round_trips():
    assert get_algorithm_class("APEX").__name__ == "ApexDQN"
    algo, stop = build_tuned_example(APEX_YAML, device="cpu", num_workers=2)
    try:
        assert stop == {"episode_reward_mean": 150, "timesteps_total": 250000}
        cfg = algo.config
        assert (cfg["n_step"], cfg["train_batch_size"], cfg["rollout_fragment_length"],
                cfg["target_network_update_freq"]) == (3, 64, 16, 500)
        assert [s.capacity for s in algo.replay_shards] == [25000, 25000]
        assert [s._dtree.capacity for s in algo.replay_shards] == [32768, 32768]
        rungs = algo.workers.foreach_worker(
            lambda w: w.policy().exploration.config.get("final_epsilon"))
        assert rungs == [0.02, _ladder(1, 2), _ladder(2, 2)]
        deadline = time.time() + 90
        while algo._counters["num_target_updates"] < 1 and time.time() < deadline:
            r = algo.train()
        assert algo._counters["num_target_updates"] >= 1
        assert r["num_env_steps_trained"] >= 500 and r["timesteps_total"] >= 1000
        assert all(np.isfinite(v) for v in r["info"]["learner"]["default_policy"].values())
        assert abs(len(algo.replay_shards[0]) - len(algo.replay_shards[1])) <= 16
        state = algo.__getstate__()
        algo.__setstate__(state)
        assert algo._sample_in_flight == {}
        for shard, s in zip(algo.replay_shards, state["replay_shards"]):
            got = shard.get_state()
            assert got["size"] == s["size"]
            assert np.array_equal(got["priorities"]["leaf_values"],
                                  s["priorities"]["leaf_values"])
        algo.train()  # goes on after the restore
    finally:
        algo.stop()


def test_what_stays_out_raises():
    """What item 4b refused builds now: the registry's ``APEX_DDPG`` and
    the object plane, whose replay actors ``stop`` ends."""
    assert get_algorithm_class("APEX_DDPG").__name__ == "ApexDDPG"
    algo = (ApexDQNConfig().environment("CartPole-v1").rollouts(num_rollout_workers=0)
            .training(replay_device_resident=False, num_replay_buffer_shards=1)
            .resources(device="cpu").build())
    try:
        assert not algo._apex_device and len(algo.replay_actors) == 1 and algo.replay_shards == []
    finally:
        algo.stop()
    assert algo.replay_actors == []
