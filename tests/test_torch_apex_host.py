"""Ape-X's object plane and Ape-X DDPG on the port, against the
reference, on the CPU.

- ``ReplayActor``: the reference's round trip (``tests/test_apex.py``) on
  the port's actor, whose draws equal a reference
  ``PrioritizedReplayBuffer`` fed the same calls, bitwise.
- The object plane (``replay_device_resident=False``) against the
  reference's, one ``ReplayActor`` each, at ``num_workers: 0`` on the
  fragments the reference sampled and its learn calls' permutations
  (``tests/test_torch_apex.py``'s injection): over six rounds the
  counters, the routed rows and every drawn batch's rows and indices are
  bitwise the reference's; the first learn call's stats and parameters
  are within 1.5e-5 absolute plus 1e-5 relative (the learn tests'
  tolerance), and the IS weights, which later learns' priorities feed,
  within 1e-5 relative. On both sides the round's wait for the replay
  actor's batch runs without its 1 s timeout (:func:`_untimed`), so
  every round from the first learn on learns the batch its request
  drew, however loaded the host is.
- ``ApexDDPGConfig``'s dict equals the reference's on their shared keys;
  the registry resolves ``APEX_DDPG``; the reference's Ape-X DDPG state
  (policy trees, targets, step, Adam states, shard rows and priorities,
  counters; the shards' generators, which a state does not carry, set
  alike) goes across with ``from_jax_apex_state``, and one more round on
  the same fragment learns within 1.5e-5 (parameters, targets, stats),
  its shard's rows bitwise and its priorities within 1e-5 relative.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import ray_tpu as jray
from ray_tpu.algorithms.apex_dqn import ApexDDPGConfig as JApexDDPGConfig
from ray_tpu.algorithms.apex_dqn import ApexDQNConfig as JApexDQNConfig
from ray_tpu.execution.replay_buffer import PrioritizedReplayBuffer as JPrioritizedReplayBuffer
from ray_tpu.data.sample_batch import SampleBatch as JSampleBatch
from ray_tpu_torch import core
from ray_tpu_torch.algorithms.apex_dqn.apex_dqn import ApexDDPGConfig, ApexDQNConfig, ReplayActor
from ray_tpu_torch.algorithms.registry import get_algorithm_class
from ray_tpu_torch.data.sample_batch import SampleBatch
from ray_tpu_torch.utils.jax_params import flax_to_state_dict, from_jax_apex_state, from_jax_params


@pytest.fixture(scope="module", autouse=True)
def runtimes():
    yield
    if core.is_initialized():
        core.shutdown()
    if jray.is_initialized():
        jray.shutdown()


def _batch(n=8, seed=0):
    rng = np.random.default_rng(seed)
    return {
        SampleBatch.OBS: rng.standard_normal((n, 4)).astype(np.float32),
        SampleBatch.NEXT_OBS: rng.standard_normal((n, 4)).astype(np.float32),
        SampleBatch.ACTIONS: rng.integers(0, 2, n),
        SampleBatch.REWARDS: rng.random(n).astype(np.float32),
        SampleBatch.TERMINATEDS: np.zeros(n, bool),
    }


def test_replay_actor_roundtrip():
    core.init(num_cpus=2)
    actor = ReplayActor.remote(256, 0.6, 0.4, 0)
    ref = JPrioritizedReplayBuffer(256, 0.6, seed=0)
    try:
        assert core.get(actor.add.remote(SampleBatch(_batch(16)), np.full(16, 2.0))) == 16
        ref.add_with_priorities(JSampleBatch(_batch(16)), np.full(16, 2.0))
        assert core.get(actor.sample.remote(64)) is None  # not enough yet
        for i in range(5):
            core.get(actor.add.remote(SampleBatch(_batch(16, i + 1)), None))
            ref.add(JSampleBatch(_batch(16, i + 1)))
        sample = core.get(actor.sample.remote(64))
        want = ref.sample(64, beta=0.4)
        assert sample.count == 64 and {"weights", "batch_indexes"} <= set(sample)
        for k in want:
            assert np.asarray(sample[k]).tobytes() == np.asarray(want[k]).tobytes(), k
        core.get(actor.update_priorities.remote(sample["batch_indexes"], np.full(64, 0.5)))
        ref.update_priorities(want["batch_indexes"], np.full(64, 0.5))
        assert core.get(actor.size.remote()) == 96
        assert core.get(actor.stats.remote()) == ref.stats()
        again, want = core.get(actor.sample.remote(32)), ref.sample(32, beta=0.4)
        for k in ("batch_indexes", "weights"):  # drawn from the updated priorities
            assert np.asarray(again[k]).tobytes() == np.asarray(want[k]).tobytes(), k
    finally:
        core.kill(actor)


# -- the object plane against the reference's -----------------------------------------

COMMON = {"train_batch_size": 16, "lr": 5e-4, "model": {"fcnet_hiddens": [16, 16]}}
ROUNDS = 6


def _untimed(wait):
    """``wait`` with no timeout: the round blocks until its replay
    actor's batch is in, where the 1 s timeout could let a slow answer
    slip into the next round on one side only."""

    def untimed(refs, num_returns=1, timeout=None):
        return wait(refs, num_returns=num_returns, timeout=None)

    return untimed


def _reference():
    jray.init(ignore_reinit_error=True)
    cfg = (JApexDQNConfig().environment("CartPole-v1")
           .rollouts(num_rollout_workers=0, rollout_fragment_length=8)
           .training(replay_device_resident=False, num_replay_buffer_shards=1, **COMMON)
           .debugging(seed=3).resources(learner_devices=1))
    cfg.num_steps_sampled_before_learning_starts = 16
    cfg.target_network_update_freq = 32
    cfg.replay_buffer_config.update({"capacity": 64})
    return cfg.build()


def _port():
    return (ApexDQNConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, rollout_fragment_length=8)
            .training(num_steps_sampled_before_learning_starts=16, target_network_update_freq=32,
                      replay_buffer_config={"capacity": 64}, replay_device_resident=False,
                      num_replay_buffer_shards=1, **COMMON)
            .debugging(seed=3).resources(device="cpu").build())


def _reference_perm(keys):
    def perm(batch_size):
        _, rng = jax.random.split(next(keys))
        (r,) = jax.random.split(jax.random.fold_in(rng, 0), 1)
        return torch.as_tensor(np.asarray(jax.random.permutation(jax.random.split(r)[0],
                                                                 batch_size)))[None]
    return perm


def _recording(policy, into, monkeypatch):
    learn = policy.learn_on_batch

    def recorded(batch, *a, **kw):
        into.append({k: np.array(v) for k, v in batch.items()
                     if isinstance(v, np.ndarray) and v.dtype != object})
        return learn(batch, *a, **kw)

    monkeypatch.setattr(policy, "learn_on_batch", recorded)


def test_object_plane_rounds_match_reference(monkeypatch):
    monkeypatch.setattr(jray, "wait", _untimed(jray.wait))
    monkeypatch.setattr(core, "wait", _untimed(core.wait))
    ref = _reference()
    try:
        rp = ref.get_policy()
        assert not ref._apex_device and len(ref.replay_actors) == 1
        init = jax.device_get(rp.params)
        sampled, keys, ref_batches = [], [], []
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
        _recording(rp, ref_batches, monkeypatch)
        ref_out, ref_counters, first_ref_params = [], [], None
        for _ in range(ROUNDS):
            ref_out.append(ref.training_step())
            ref_counters.append(dict(ref._counters))
            if first_ref_params is None and keys:
                first_ref_params = flax_to_state_dict(jax.device_get(rp.params))
        ref_stats = jray.get(ref.replay_actors[0].stats.remote())
    finally:
        ref.cleanup()

    port = _port()
    try:
        pp = port.get_policy()
        assert not port._apex_device and len(port.replay_actors) == 1 and port.replay_shards == []
        from_jax_params(init, pp.model)
        pp.update_target()
        feed = iter(sampled)
        monkeypatch.setattr(port.workers.local_worker(), "sample",
                            lambda: SampleBatch({k: v.copy() for k, v in next(feed).items()}))
        monkeypatch.setattr(pp, "draw_permutations", _reference_perm(iter(keys)))
        port_batches, first_learn = [], None
        _recording(pp, port_batches, monkeypatch)
        for step in range(ROUNDS):
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
        assert first_learn == 1 and len(port_batches) == len(ref_batches) == ROUNDS - 1
        assert port._counters["num_target_updates"] >= 1
        for got, want in zip(port_batches, ref_batches):
            assert set(got) == set(want)
            for k, v in want.items():
                if k == "weights":  # from priorities that the learns' TD errors wrote
                    np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6)
                else:
                    assert got[k].tobytes() == v.tobytes(), k
        assert core.get(port.replay_actors[0].stats.remote()) == ref_stats
        assert port._timers["replay_wait_s"] > 0
    finally:
        port.stop()


# -- Ape-X DDPG ------------------------------------------------------------------------


def test_apex_ddpg_config_matches_reference():
    assert get_algorithm_class("APEX_DDPG").__name__ == "ApexDDPG"
    port, ref = ApexDDPGConfig().to_dict(), JApexDDPGConfig().to_dict()
    shared = set(port) & set(ref)
    assert {"actor_hiddens", "critic_hiddens", "tau", "exploration_config", "twin_q",
            "num_replay_buffer_shards", "per_worker_exploration", "n_step"} <= shared
    assert {k: port[k] for k in shared} == {k: ref[k] for k in shared}
    assert (port["n_step"], port["per_worker_exploration"], port["train_batch_size"]) == (3, False, 256)


def _ddpg(cls, **over):
    cfg = (cls().environment("Pendulum-v1")
           .rollouts(num_rollout_workers=0, rollout_fragment_length=8)
           .training(train_batch_size=16, num_steps_sampled_before_learning_starts=16,
                     num_replay_buffer_shards=1, target_network_update_freq=10**9,
                     actor_hiddens=[16], critic_hiddens=[16], **over)
           .debugging(seed=2))
    cfg.replay_buffer_config = {**cfg.replay_buffer_config, "capacity": 64}
    return cfg


def test_apex_ddpg_learn_from_reference_state(monkeypatch):
    ref = _ddpg(JApexDDPGConfig, replay_device_resident=True).resources(learner_devices=1).build()
    try:
        local = ref.workers.local_worker()
        real_sample = local.sample
        sampled = []

        def record():
            batch = real_sample()
            sampled.append({k: np.array(v) for k, v in batch.items()
                            if isinstance(v, np.ndarray) and v.dtype != object})
            return batch

        monkeypatch.setattr(local, "sample", record)
        for _ in range(3):
            ref.training_step()
        rp = ref.get_policy()
        state = jax.device_get(rp.get_state())
        shards = [s.get_state() for s in ref.replay_shards]
        rngs = [s._rng.bit_generator.state for s in ref.replay_shards]
        counters = dict(ref._counters)
        out_ref = ref.training_step()
        ref_params = {g: flax_to_state_dict(jax.device_get(rp.params[g])) for g in ("actor", "critic")}
        ref_target = flax_to_state_dict(jax.device_get(rp.aux_state["target_critic"]))
        ref_shard = ref.replay_shards[0].get_state()
    finally:
        ref.cleanup()
    port = _ddpg(ApexDDPGConfig).resources(device="cpu").build()
    try:
        pp = port.get_policy()
        assert type(pp).__name__ == "DDPGTorchPolicy" and port._apex_device
        from_jax_apex_state(port, state, shards, counters)
        for shard, rng in zip(port.replay_shards, rngs):  # a state carries no generator
            shard._rng.bit_generator.state = rng
        monkeypatch.setattr(port.workers.local_worker(), "sample",
                            lambda: SampleBatch({k: v.copy() for k, v in sampled[-1].items()}))
        out = port.training_step()
        assert port._counters["num_env_steps_trained"] == 48
        for k, v in out_ref["default_policy"].items():
            np.testing.assert_allclose(out["default_policy"][k], v, rtol=1e-5, atol=1.5e-5, err_msg=k)
        got = pp.get_weights()
        for g, params in ref_params.items():
            for k, v in params.items():
                np.testing.assert_allclose(got[f"{g}.{k}"], v, rtol=1e-5, atol=1.5e-5, err_msg=k)
        target = dict(zip(pp.critic_names, pp.aux_state["target_critic"]))
        for k, v in ref_target.items():
            np.testing.assert_allclose(target[k].numpy(), v, rtol=1e-5, atol=1.5e-5, err_msg=k)
        got_shard = port.replay_shards[0].get_state()
        assert (got_shard["idx"], got_shard["size"]) == (ref_shard["idx"], ref_shard["size"])
        for k, v in ref_shard["cols"].items():
            assert np.asarray(got_shard["cols"][k]).tobytes() == np.asarray(v).tobytes(), k
        np.testing.assert_allclose(got_shard["priorities"]["leaf_values"],
                                   ref_shard["priorities"]["leaf_values"], rtol=1e-5, atol=1e-7)
    finally:
        port.stop()
