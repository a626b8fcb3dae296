"""The port's checkpoints: save, restore, ``from_checkpoint``, pruning,
``export_policy_model``, and a reference checkpoint loaded into the port.

Contracts:

- bitwise: ``save`` → ``Algorithm.from_checkpoint`` restores every
  policy's state (weights, Adam moments and count, coefficients,
  timestep, grad updates, exploration state; SAC's three optimizers and
  target; DQN's target), the filters, the counters, the episode total,
  the iteration and DQN's replay rings and sum-tree leaves, for PPO on
  the actor lane (one remote worker, ``MeanStdFilter``) and the device
  lane, DQN with prioritized replay on the device lane, SAC, IMPALA with
  its learner thread running and multi-agent PPO (whose lambda
  ``policy_mapping_fn`` survives the config blob);
- two faults of the port, repaired: a restore brings back the filters'
  statistics, and the remote worker's weights equal the learner's right
  after it;
- durability: a save that fails mid-write leaves the previous checkpoint
  loadable; ``rllib_checkpoint.json`` is written last, then the
  directory is synced; ``keep_checkpoints_num`` keeps the newest
  siblings; ``from_checkpoint`` without the metadata raises;
- ``export_policy_model``'s ``policy_state.pkl`` loads into a fresh
  policy bitwise;
- cross-package: the reference's PPO (``tests/test_ppo.py``'s
  ``small_config``, one learner shard) trains one iteration and saves;
  its unpickled ``algorithm_state.pkl`` goes into a port PPO through
  ``from_jax_algorithm_state``: weights (after layout) and Adam moments
  bitwise, counters equal, greedy actions equal on 64 seeded
  observations with logits within 1e-5 relative, and one further
  ``learn_on_batch`` on the same batch with the reference's
  permutations within 1.5e-5 absolute plus 1e-5 relative in parameters
  (the PPO learn's tolerance) and 1e-5 relative in stats.
"""

from __future__ import annotations

import json
import os
import pickle
import time

import jax
import numpy as np
import pytest
import torch

from ray_tpu.algorithms.ppo import PPOConfig as RefPPOConfig
from ray_tpu_torch import core
from ray_tpu_torch.algorithms import algorithm as algorithm_mod
from ray_tpu_torch.algorithms.algorithm import Algorithm
from ray_tpu_torch.algorithms.dqn.dqn import DQNConfig
from ray_tpu_torch.algorithms.impala.impala import IMPALAConfig
from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig, PPOTorchPolicy
from ray_tpu_torch.algorithms.sac.sac import SACConfig
from ray_tpu_torch.env.multi_agent_env import make_multi_agent
from ray_tpu_torch.env.spaces import Box, Discrete
from ray_tpu_torch.utils.filter import Filter, MeanStdFilter
from ray_tpu_torch.utils.jax_params import (
    flax_to_state_dict,
    from_jax_adam_state,
    from_jax_algorithm_state,
)


@pytest.fixture(scope="module")
def runtime():
    core.shutdown()
    core.init(num_cpus=1)
    yield
    core.shutdown()


def _assert_same(a, b, path="state"):
    """Bitwise equality of two state trees (dicts, sequences, arrays,
    filters, scalars)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), f"{path}: {sorted(a)} != {sorted(b)}"
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), f"{path}: {a.dtype}{a.shape} != {b.dtype}{b.shape}"
        assert a.tobytes() == b.tobytes(), f"{path}: values differ"
    elif isinstance(a, MeanStdFilter):
        assert isinstance(b, MeanStdFilter), path
        assert (a.shape, a.demean, a.destd, a.clip) == (b.shape, b.demean, b.destd, b.clip), path
        for name in ("rs", "buffer"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.num == y.num, f"{path}/{name}.num"
            _assert_same(x.mean_, y.mean_, f"{path}/{name}.mean_")
            _assert_same(x.s, y.s, f"{path}/{name}.s")
    elif isinstance(a, Filter):
        assert type(a) is type(b), path
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), f"{path}: {a!r} != {b!r}"


def _saved_state(path):
    with open(os.path.join(path, "algorithm_state.pkl"), "rb") as f:
        return pickle.load(f)


# -- the algorithms, small -----------------------------------------------------------

PONG_CNN = {"conv_filters": [[4, [8, 8], [4, 4]], [8, [4, 4], [2, 2]]], "post_fcnet_hiddens": [16]}
SAC_HIDDEN = {"policy_model_config": {"fcnet_hiddens": [16, 16]},
              "q_model_config": {"fcnet_hiddens": [16, 16]}}
MA_SPACES = (Box(-np.inf, np.inf, (4,), np.float32), Discrete(2))


def _config(case):
    small = dict(train_batch_size=64, sgd_minibatch_size=32, num_sgd_iter=2,
                 model={"fcnet_hiddens": [16]})
    if case == "ppo_actor":
        cfg = (PPOConfig().environment("CartPole-v1")
               .rollouts(num_rollout_workers=1, rollout_fragment_length=32).training(**small))
        cfg.observation_filter = "MeanStdFilter"
    elif case == "ppo_device":
        cfg = (PPOConfig().environment("CartPoleJax-v0", env_backend="jax")
               .rollouts(num_envs_per_worker=4, rollout_fragment_length=16).training(**small))
    elif case == "dqn_device":
        cfg = (DQNConfig()
               .environment("PongLiteJax-v0", env_config={"max_steps": 20, "rallies": 2},
                            env_backend="jax")
               .rollouts(num_envs_per_worker=2, rollout_fragment_length=4)
               .training(replay_buffer_config={"capacity": 64, "prioritized_replay": True},
                         model=PONG_CNN, train_batch_size=8,
                         num_steps_sampled_before_learning_starts=16,
                         target_network_update_freq=16))
    elif case == "sac":
        cfg = SACConfig().environment("Pendulum-v1")
        cfg.update_from_dict({**SAC_HIDDEN, "train_batch_size": 16,
                              "num_steps_sampled_before_learning_starts": 32,
                              "min_sample_timesteps_per_iteration": 24})
    elif case == "impala":
        cfg = IMPALAConfig().environment("CartPole-v1")
        cfg.update_from_dict({"num_workers": 0, "rollout_fragment_length": 16,
                              "train_batch_size": 32, "model": {"fcnet_hiddens": [16]},
                              "min_time_s_per_iteration": 0})
    elif case == "ma_ppo":
        # _ma_cartpole's shape: 4 agents on one shared 128x128 policy
        cfg = (PPOConfig()
               .environment(lambda c: make_multi_agent("CartPole-v1")({"num_agents": 4}))
               .rollouts(num_rollout_workers=0, rollout_fragment_length=16)
               .training(train_batch_size=64, sgd_minibatch_size=32, num_sgd_iter=1,
                         model={"fcnet_hiddens": [128, 128]})
               .multi_agent(policies={"shared": (None, *MA_SPACES, {})},
                            policy_mapping_fn=lambda aid, **kw: "shared"))
    return cfg.debugging(seed=3).resources(device="cpu")


def _train(case, algo):
    if case == "impala":
        # the learner thread has learned at least one batch
        deadline = time.time() + 60
        while algo._counters["num_env_steps_trained"] == 0 and time.time() < deadline:
            algo.train()
        assert algo._counters["num_env_steps_trained"] > 0
        return
    for _ in range({"dqn_device": 4, "sac": 3}.get(case, 2)):
        algo.train()


CASES = ["ppo_actor", "ppo_device", "dqn_device", "sac", "impala", "ma_ppo"]


@pytest.mark.parametrize("case", CASES)
def test_save_from_checkpoint_round_trip(case, tmp_path, runtime):
    algo = _config(case).build()
    try:
        _train(case, algo)
        live = None if case == "impala" else algo.__getstate__()
        path = algo.save(str(tmp_path / "checkpoint_000002"))
        assert set(os.listdir(path)) == {"algorithm_state.pkl", "algorithm_config.pkl",
                                         "rllib_checkpoint.json", ".tune_metadata"}
        saved = _saved_state(path)
        assert set(saved) >= {"worker", "counters", "episodes_total"}
        assert set(saved["worker"]) == {"policy_states", "filters"}
        if live is not None:
            _assert_same(live, saved)
        restored = Algorithm.from_checkpoint(path, device="cpu")
        try:
            assert type(restored) is type(algo)
            assert restored.get_policy(*(["shared"] if case == "ma_ppo" else [])).device.type == "cpu"
            _assert_same(saved, restored.__getstate__())
            assert restored.iteration == algo.iteration >= 1
            assert restored._episodes_total == algo._episodes_total
            for pid, ps in saved["worker"]["policy_states"].items():
                assert set(ps) >= {"weights", "opt_state", "coeff_values", "global_timestep",
                                   "num_grad_updates", "exploration_state"}, pid
                assert ps["num_grad_updates"] > 0 or case == "impala", pid
            if case == "dqn_device":
                rb = saved["replay_buffer"]["default_policy"]
                assert rb["size"] > 0 and len(rb["priorities"]["leaf_values"]) == rb["size"]
            if case == "ppo_actor":
                assert saved["worker"]["filters"]["default_policy"].rs.num > 0
            if case == "ma_ppo":
                assert restored.workers.local_worker().policy_mapping_fn(2) == "shared"
                assert np.isfinite(restored.train()["info"]["learner"]["shared"]["total_loss"])
        finally:
            restored.stop()
    finally:
        algo.stop()


def test_restore_brings_filters_and_remote_weights(tmp_path, runtime):
    """Two repaired faults: the state carried no filters,
    and the remote workers kept acting on their old weights after a
    restore until the next round."""
    algo = _config("ppo_actor").build()
    fresh = _config("ppo_actor").build()
    try:
        algo.train()
        path = algo.save(str(tmp_path / "ckpt"))
        saved = _saved_state(path)
        fresh.restore(path)
        local = fresh.workers.local_worker()
        _assert_same(saved["worker"]["filters"], local.get_filters())
        assert local.filters["default_policy"].rs.num == algo.workers.local_worker(
        ).filters["default_policy"].rs.num > 0
        learner = local.get_weights()
        (remote,) = core.get([w.get_weights.remote() for w in fresh.workers.remote_workers()])
        _assert_same(learner, remote)
        _assert_same(saved["worker"]["policy_states"]["default_policy"]["weights"],
                     learner["default_policy"])
        assert fresh.iteration == 1
    finally:
        algo.stop()
        fresh.stop()


# -- durability ----------------------------------------------------------------------


def _device_ppo():
    return _config("ppo_device").build()


def test_failed_save_leaves_the_previous_checkpoint(tmp_path, monkeypatch):
    algo = _device_ppo()
    try:
        algo.train()
        path = algo.save(str(tmp_path / "checkpoint_000001"))
        first = _saved_state(path)
        algo.train()
        real_dump = pickle.dump

        def failing_dump(obj, f, *args, **kwargs):
            f.write(b"half a state")
            raise RuntimeError("disk went away")

        monkeypatch.setattr(pickle, "dump", failing_dump)
        with pytest.raises(RuntimeError, match="disk went away"):
            algo.save(path)
        monkeypatch.setattr(pickle, "dump", real_dump)
        assert sorted(os.listdir(path)) == sorted(
            ["algorithm_state.pkl", "algorithm_config.pkl", "rllib_checkpoint.json", ".tune_metadata"])
        restored = Algorithm.from_checkpoint(path, device="cpu")
        _assert_same(first, restored.__getstate__())
        assert restored.iteration == 1
    finally:
        algo.stop()


def test_metadata_is_written_last_then_the_directory_synced(tmp_path, monkeypatch):
    order = []
    real_write, real_sync = algorithm_mod.atomic_write, algorithm_mod.fsync_dir

    def write(path, fn, **kwargs):
        order.append(("write", os.path.basename(path), kwargs.get("sync_dir", True)))
        return real_write(path, fn, **kwargs)

    def sync(path):
        order.append(("fsync_dir", os.path.basename(path)))
        return real_sync(path)

    monkeypatch.setattr(algorithm_mod, "atomic_write", write)
    monkeypatch.setattr(algorithm_mod, "fsync_dir", sync)
    algo = _device_ppo()
    algo.save_checkpoint(str(tmp_path))
    assert order == [("write", "algorithm_state.pkl", False), ("write", "algorithm_config.pkl", False),
                     ("write", "rllib_checkpoint.json", False), ("fsync_dir", tmp_path.name)]
    meta = json.loads((tmp_path / "rllib_checkpoint.json").read_text())
    assert meta == {"type": "Algorithm", "algorithm_class": "PPO", "algorithm_name": "PPO"}


def test_keep_checkpoints_num_keeps_the_newest(tmp_path):
    cfg = _config("ppo_device").fault_tolerance(keep_checkpoints_num=2)
    algo = cfg.build()
    algo._logdir = str(tmp_path)
    (tmp_path / "other").mkdir()
    for _ in range(4):
        algo.train()
        algo.save()
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_000003", "checkpoint_000004", "other"]
    # the other knobs are ported (tests/test_torch_resilience.py); one the
    # reference does not have raises
    assert PPOConfig().fault_tolerance(checkpoint_frequency=5).to_dict()["checkpoint_frequency"] == 5
    with pytest.raises(TypeError, match="unknown knobs"):
        PPOConfig().fault_tolerance(checkpoint_every=5)


def test_from_checkpoint_needs_the_metadata(tmp_path):
    algo = _device_ppo()
    path = algo.save(str(tmp_path / "ckpt"))
    os.remove(os.path.join(path, "rllib_checkpoint.json"))
    with pytest.raises(ValueError, match="rllib_checkpoint.json"):
        Algorithm.from_checkpoint(path, device="cpu")
    # the concrete class needs no metadata
    from ray_tpu_torch.algorithms.ppo.ppo import PPO

    _assert_same(algo.__getstate__(), PPO.from_checkpoint(path, device="cpu").__getstate__())


def test_config_blob_leaves_out_live_keys(tmp_path):
    algo = _device_ppo()
    path = algo.save(str(tmp_path / "ckpt"))
    with open(os.path.join(path, "algorithm_config.pkl"), "rb") as f:
        blob = pickle.load(f)
    assert "device" not in blob and not any(k.startswith("_") for k in blob)
    assert blob["env"] == "CartPoleJax-v0" and blob["seed"] == 3


def test_export_policy_model_loads_into_a_fresh_policy(tmp_path):
    algo = _device_ppo()
    algo.train()
    algo.export_policy_model(str(tmp_path / "export"))
    with open(tmp_path / "export" / "policy_state.pkl", "rb") as f:
        state = pickle.load(f)
    policy = algo.get_policy()
    fresh = PPOTorchPolicy(policy.observation_space, policy.action_space,
                           {**algo.config, "seed": 11}, device="cpu")
    fresh.set_state(state)
    _assert_same(policy.get_state(), fresh.get_state())


# -- a reference checkpoint in the port ------------------------------------------------

REF_B, REF_MB, REF_ITERS = 512, 128, 4


def _reference_perms(key, n, iters):
    """The permutations ``JaxPolicy``'s nest draws on shard 0 from the
    policy key ``key`` (as ``tests/test_torch_ppo.py`` derives them)."""
    _, rng = jax.random.split(key)
    rng = jax.random.fold_in(rng, 0)
    return np.stack([np.asarray(jax.random.permutation(jax.random.split(r)[0], n))
                     for r in jax.random.split(rng, iters)])


def test_reference_checkpoint_loads_into_the_port(tmp_path):
    # tests/test_ppo.py's small_config, on one learner shard
    ref = (RefPPOConfig().environment("CartPole-v1")
           .rollouts(num_rollout_workers=0, rollout_fragment_length=128)
           .training(train_batch_size=REF_B, sgd_minibatch_size=REF_MB, num_sgd_iter=REF_ITERS,
                     lr=3e-4)
           .debugging(seed=1).resources(learner_devices=1).build())
    port = (PPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, rollout_fragment_length=128)
            .training(train_batch_size=REF_B, sgd_minibatch_size=REF_MB, num_sgd_iter=REF_ITERS,
                      lr=3e-4)
            .debugging(seed=1).resources(device="cpu").build())
    try:
        ref.train()
        path = ref.save(str(tmp_path / "ref_ckpt"))
        state = _saved_state(path)
        from_jax_algorithm_state(port, state)

        ps = state["worker"]["policy_states"]["default_policy"]
        pol, rpol = port.get_policy(), ref.get_policy()
        _assert_same(flax_to_state_dict(ps["weights"]), pol.get_weights())
        count, mu, nu = from_jax_adam_state(ps["opt_state"])
        own = pol.get_state()["opt_state"]
        assert own["count"] == count == REF_ITERS * (REF_B // REF_MB)
        for name in pol.param_names:
            _assert_same(np.asarray(mu[name]), own["mu"][name], f"mu {name}")
            _assert_same(np.asarray(nu[name]), own["nu"][name], f"nu {name}")
        assert dict(port._counters) == {k: int(v) for k, v in state["counters"].items()}
        assert port._counters["num_env_steps_sampled"] == REF_B
        assert pol.num_grad_updates == ps["num_grad_updates"] > 0
        assert pol.coeff_values["kl_coeff"] == ps["coeff_values"]["kl_coeff"]

        obs = np.random.default_rng(0).uniform(-0.2, 0.2, (64, 4)).astype(np.float32)
        for o in obs:
            assert int(port.compute_single_action(o, explore=False)) == int(
                ref.compute_single_action(o, explore=False))
            got = pol.compute_single_action(o, explore=False)[2]["action_dist_inputs"]
            want = np.asarray(rpol.compute_single_action(o, explore=False)[2]["action_dist_inputs"])
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)

        # one further learn on the same batch, the reference's draws injected
        rng = np.random.default_rng(5)
        batch = {
            "obs": rng.uniform(-0.2, 0.2, (REF_B, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, REF_B).astype(np.int64),
            "action_logp": np.full(REF_B, -0.6931, np.float32),
            "action_dist_inputs": rng.standard_normal((REF_B, 2)).astype(np.float32) * 0.1,
            "advantages": rng.standard_normal(REF_B).astype(np.float32),
            "value_targets": rng.standard_normal(REF_B).astype(np.float32),
            "vf_preds": rng.standard_normal(REF_B).astype(np.float32),
        }
        from ray_tpu.data.sample_batch import SampleBatch as RefSampleBatch
        from ray_tpu_torch.data.sample_batch import SampleBatch

        perms = _reference_perms(rpol._rng, REF_B, REF_ITERS)
        ref_stats = rpol.learn_on_batch(RefSampleBatch(dict(batch)))
        stats = pol.learn_on_batch(SampleBatch(dict(batch)), perms=torch.as_tensor(perms))
        assert set(stats) == set(ref_stats)
        for k, v in ref_stats.items():
            np.testing.assert_allclose(stats[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
        want = flax_to_state_dict(rpol.get_weights())
        got = pol.get_weights()
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, rtol=1e-5, atol=1.5e-5, err_msg=name)
    finally:
        port.stop()
        ref.cleanup()
