"""MARWIL, BC, CQL and CRR of the port against the reference's, on the CPU.

Contracts:

- MARWIL's postprocessing: discounted returns of a terminated episode
  bitwise the reference's; of a truncated one (bootstrapped with V(last
  obs), one float32 forward in each framework) within 2 float32 ulp of
  the return's magnitude;
- one MARWIL learn (and one BC learn) from the reference's weights and
  Adam state, with the reference's permutations: stats within 1.5e-5
  relative plus 1e-6 absolute, parameters and Adam moments within
  1.5e-5 (the PPO learn's tolerance: float32 sums in other orders);
  the squared-advantage normaliser after three learns within 1e-6
  relative, at a rate of 0.1 so that each learn moves it;
- ``beta = 0`` is BC: the same learn bitwise;
- the reference's ``test_marwil_no_cross_episode_return_leak``;
- one CQL update inside the BC warmup and one after it, and one CRR
  update with ``weight_type`` "bin" and one with "exp", each from the
  reference's state (``from_jax_cql_state`` / ``from_jax_crr_state``)
  with the reference's draws injected: parameters, targets and Adam
  moments within 1.5e-5 absolute plus 1e-5 relative, stats (CQL's
  ``cql_penalty`` and ``in_bc_warmup`` among them) within 1.5e-5
  relative plus 1e-5 absolute. Observations are at half scale, so no
  squashed sample sits near the tanh's flat ends, where the two
  frameworks' float32 tanh part (``tests/test_torch_sac.py``);
- CRR's hard target sync comes at ``target_update_grad_intervals``;
- CQL and CRR train from offline shards that SAC wrote with learning
  held off (the reference's ``test_cql_offline_step`` and
  ``test_crr_offline_step``), and the registry resolves all four names.

The slow test trains BC on CartPole-v1 from PPO's shards to the
reference's bar of 120.
"""

from __future__ import annotations

import time

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.algorithms.cql.cql import CQLConfig as JCQLConfig
from ray_tpu.algorithms.cql.cql import CQLJaxPolicy
from ray_tpu.algorithms.crr.crr import CRRConfig as JCRRConfig
from ray_tpu.algorithms.crr.crr import CRRJaxPolicy
from ray_tpu.algorithms.marwil.marwil import MARWILConfig as JMARWILConfig
from ray_tpu.algorithms.marwil.marwil import MARWILJaxPolicy
from ray_tpu.data.sample_batch import SampleBatch as JSampleBatch
from ray_tpu.sharding import get_mesh
from ray_tpu_torch.algorithms.cql.cql import CQL_STATS, CQLConfig, CQLTorchPolicy
from ray_tpu_torch.algorithms.crr.crr import CRR_STATS, CRRConfig, CRRTorchPolicy
from ray_tpu_torch.algorithms.marwil.marwil import (
    BC,
    MARWIL,
    BCConfig,
    MARWILConfig,
    MARWILTorchPolicy,
)
from ray_tpu_torch.algorithms.registry import get_algorithm_class
from ray_tpu_torch.algorithms.sac.sac import SACConfig
from ray_tpu_torch.data.sample_batch import SampleBatch, concat_samples
from ray_tpu_torch.env.spaces import Box, Discrete
from ray_tpu_torch.offline import JsonReader, JsonWriter
from ray_tpu_torch.utils.jax_params import (
    flax_to_state_dict,
    from_jax_adam_state,
    from_jax_cql_state,
    from_jax_crr_state,
    from_jax_marwil_state,
)

ULP = float(np.finfo(np.float32).eps)


def _one_shard():
    return get_mesh(devices=jax.devices()[:1])


# -- MARWIL and BC -----------------------------------------------------------------------

B, OBS = 32, 4
MARWIL_CFG = {"model": {"fcnet_hiddens": [16, 16], "dtype": "float32"}, "seed": 1,
              "train_batch_size": B, "lr": 1e-3, "gamma": 0.95,
              "moving_average_sqd_adv_norm_update_rate": 0.1,
              "moving_average_sqd_adv_norm_start": 4.0}


def _marwil_pair(**over):
    cfg = {**JMARWILConfig().to_dict(), **MARWIL_CFG, **over}
    cfg.pop("env", None)
    ref = MARWILJaxPolicy(gym.spaces.Box(-10, 10, (OBS,), np.float32), gym.spaces.Discrete(2),
                          {**cfg, "_mesh": _one_shard()})
    port = MARWILTorchPolicy(Box(-10, 10, (OBS,)), Discrete(2), cfg, device="cpu")
    from_jax_marwil_state(port, jax.device_get(ref.params), jax.device_get(ref.opt_state),
                          ref.coeff_values)
    return ref, port


def _episode(rng, n, terminated, eps_id):
    return {
        "obs": rng.standard_normal((n, OBS)).astype(np.float32),
        "new_obs": rng.standard_normal((n, OBS)).astype(np.float32),
        "actions": rng.integers(0, 2, n).astype(np.int64),
        "rewards": rng.random(n).astype(np.float32),
        "dones": np.arange(n) == n - 1 if terminated else np.zeros(n, bool),
        "truncateds": np.zeros(n, bool) if terminated else np.arange(n) == n - 1,
        "action_logp": rng.uniform(-0.9, -0.5, n).astype(np.float32),
        "eps_id": np.full(n, eps_id, np.int64),
    }


def _train_batch(port, seed=0):
    """Two postprocessed episodes (one terminated, one truncated) of B
    rows in all, through the port's postprocessing."""
    rng = np.random.default_rng(seed)
    eps = [_episode(rng, 12, True, 0), _episode(rng, B - 12, False, 1)]
    return concat_samples([port.postprocess_trajectory(SampleBatch(dict(e))) for e in eps])


def _reference_perms(key, n, iters=1):
    """The permutations ``JaxPolicy``'s nest draws on shard 0 from the
    policy key ``key`` (as ``tests/test_torch_ppo.py`` derives them)."""
    _, rng = jax.random.split(key)
    rng = jax.random.fold_in(rng, 0)
    return torch.as_tensor(np.stack([
        np.asarray(jax.random.permutation(jax.random.split(r)[0], n))
        for r in jax.random.split(rng, iters)
    ]))


def test_marwil_postprocessing_matches_reference():
    ref, port = _marwil_pair()
    rng = np.random.default_rng(3)
    for terminated in (True, False):
        ep = _episode(rng, 9, terminated, 5)
        got = port.postprocess_trajectory(SampleBatch(dict(ep)))
        want = ref.postprocess_trajectory(JSampleBatch(dict(ep)))
        adv, ref_adv = got["advantages"], np.asarray(want["advantages"])
        assert adv.dtype == ref_adv.dtype == np.float32
        if terminated:
            assert adv.tobytes() == ref_adv.tobytes()
        else:
            # V(last obs) is one float32 forward in each framework
            np.testing.assert_allclose(adv, ref_adv, rtol=0, atol=2 * ULP * np.abs(ref_adv).max())
        np.testing.assert_array_equal(got["value_targets"], np.asarray(want["value_targets"]))


def _assert_marwil_state_close(port, ref):
    want = flax_to_state_dict(jax.device_get(ref.params))
    got = port.get_state()
    count, mu, nu = from_jax_adam_state(jax.device_get(ref.opt_state))
    assert got["opt_state"]["count"] == count
    for k, v in want.items():
        np.testing.assert_allclose(got["weights"][k], v, rtol=1e-5, atol=1.5e-5, err_msg=k)
        np.testing.assert_allclose(got["opt_state"]["mu"][k], mu[k], rtol=1e-5, atol=1.5e-5,
                                   err_msg=k)
        np.testing.assert_allclose(got["opt_state"]["nu"][k], nu[k], rtol=1e-5, atol=1e-9,
                                   err_msg=k)


@pytest.mark.parametrize("beta", [1.0, 0.0])
def test_marwil_learn_matches_reference(beta):
    """Three learns (each with the reference's permutation); the
    normaliser moves with MARWIL's and stays with BC's."""
    ref, port = _marwil_pair(beta=beta, vf_coeff=1.0 if beta else 0.0)
    for seed in range(3):
        batch = _train_batch(port, seed)
        perms = _reference_perms(ref._rng, B)
        want = ref.learn_on_batch(JSampleBatch(dict(batch)))
        got = port.learn_on_batch(batch, perms=perms)
        assert set(got) == set(want), set(got) ^ set(want)
        for k, v in want.items():
            assert abs(got[k] - v) <= 1.5e-5 * abs(v) + 1e-6, (k, got[k], v)
    _assert_marwil_state_close(port, ref)
    norm, ref_norm = port.coeff_values["ma_sqd_adv_norm"], ref.coeff_values["ma_sqd_adv_norm"]
    assert norm == pytest.approx(ref_norm, rel=1e-6)
    assert (norm != 4.0) == bool(beta)


def test_beta_zero_is_bc():
    marwil_cfg = {**MARWILConfig().to_dict(), **MARWIL_CFG, "beta": 0.0, "vf_coeff": 0.0}
    bc_cfg = {**BCConfig().to_dict(), **MARWIL_CFG}
    port = MARWILTorchPolicy(Box(-10, 10, (OBS,)), Discrete(2), marwil_cfg, device="cpu")
    bc = MARWILTorchPolicy(Box(-10, 10, (OBS,)), Discrete(2), bc_cfg, device="cpu")
    batch = _train_batch(port)
    assert port.learn_on_batch(batch) == bc.learn_on_batch(batch)
    for k, v in port.get_weights().items():
        assert v.tobytes() == bc.get_weights()[k].tobytes(), k
    assert (BCConfig().beta, BCConfig().vf_coeff) == (0.0, 0.0)
    for name, cls in (("MARWIL", MARWIL), ("BC", BC)):
        assert get_algorithm_class(name) is cls
    assert get_algorithm_class("CQL").__name__ == "CQL"
    assert get_algorithm_class("CRR").__name__ == "CRR"


def test_marwil_no_cross_episode_return_leak(tmp_path):
    """A written line holding two episodes: discounted returns must not
    cross the boundary (the reference's test)."""
    def ep(reward, eps_id):
        return SampleBatch({
            "obs": np.zeros((3, 4), np.float32), "new_obs": np.zeros((3, 4), np.float32),
            "actions": np.zeros(3, np.int64), "rewards": np.asarray(reward, np.float32),
            "dones": np.array([False, False, True]), "truncateds": np.zeros(3, bool),
            "action_logp": np.full(3, -0.7, np.float32), "eps_id": np.full(3, eps_id, np.int64),
        })

    w = JsonWriter(str(tmp_path))
    w.write(concat_samples([ep([0.0, 0.0, 1.0], 0), ep([100.0] * 3, 1)]))
    w.close()
    marwil = (MARWILConfig().environment("CartPole-v1").rollouts(num_rollout_workers=0)
              .training(train_batch_size=6)
              .offline_data(input_=str(tmp_path), off_policy_estimation_methods=[])
              .resources(device="cpu").build())
    batch = marwil._next_offline_batch()
    adv = batch["advantages"][batch["eps_id"] == 0]
    assert np.all(np.abs(adv) <= 1.0 + 1e-5), adv
    marwil.stop()


def test_marwil_trains_and_reports_estimates(tmp_path):
    """PPO writes CartPole-v1 shards; MARWIL and BC train from them, the
    estimators report finite values (the reference's slow test at a small
    size)."""
    from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig

    out_dir = str(tmp_path / "data")
    ppo = (PPOConfig().environment("CartPole-v1")
           .rollouts(num_rollout_workers=0, rollout_fragment_length=128)
           .training(train_batch_size=256, sgd_minibatch_size=128, num_sgd_iter=1,
                     model={"fcnet_hiddens": [16]})
           .offline_data(output=out_dir).debugging(seed=0).resources(device="cpu").build())
    ppo.train()
    ppo.stop()
    for config in (MARWILConfig(), BCConfig()):
        algo = (config.environment("CartPole-v1").rollouts(num_rollout_workers=0)
                .training(train_batch_size=128, model={"fcnet_hiddens": [16]})
                .offline_data(input_=out_dir).debugging(seed=0).resources(device="cpu").build())
        info = algo.train()["info"]["learner"]["default_policy"]
        assert np.isfinite(info["policy_loss"])
        assert ("moving_average_sqd_adv_norm" in info) == (type(algo) is MARWIL)
        est = {k: v for k, v in info.items() if k.startswith("off_policy_estimation/")}
        assert set(est) == {"off_policy_estimation/ImportanceSampling",
                            "off_policy_estimation/WeightedImportanceSampling"}
        assert all(np.isfinite(v["v_behavior"]) and np.isfinite(v["v_target"])
                   for v in est.values())
        algo.stop()


# -- CQL and CRR -------------------------------------------------------------------------

SB, SOBS, ACT, LOW, HIGH = 16, 3, 2, -2.0, 2.0
HIDDEN = {"policy_model_config": {"fcnet_hiddens": [24, 24]},
          "q_model_config": {"fcnet_hiddens": [24, 24]}}


def _sac_batch(rng, n=SB):
    return {
        "obs": (0.5 * rng.standard_normal((n, SOBS))).astype(np.float32),
        "new_obs": (0.5 * rng.standard_normal((n, SOBS))).astype(np.float32),
        "actions": rng.uniform(0.9 * LOW, 0.9 * HIGH, (n, ACT)).astype(np.float32),
        "rewards": rng.standard_normal(n).astype(np.float32),
        "dones": rng.random(n) < 0.25,
    }


def _offline_pair(ref_cls, port_cls, config_cls, carry, warm, **over):
    """A reference policy ``warm`` updates in and a port policy carrying
    its state."""
    cfg = {**config_cls().to_dict(), **HIDDEN, "seed": 3, "train_batch_size": SB, "gamma": 0.97,
           "initial_alpha": 0.7, "tau": 0.05, **over}
    cfg.pop("env", None)
    obs_space, act_space = (gym.spaces.Box(-1, 1, (SOBS,), np.float32),
                            gym.spaces.Box(LOW, HIGH, (ACT,), np.float32))
    ref = ref_cls(obs_space, act_space, {**cfg, "_mesh": _one_shard()})
    rng = np.random.default_rng(0)
    for _ in range(warm):
        ref.learn_on_batch(JSampleBatch(_sac_batch(rng)))
    port = port_cls(Box(-1, 1, (SOBS,)), Box(LOW, HIGH, (ACT,)), cfg, device="cpu")
    carry(port, jax.device_get(ref.params), jax.device_get(ref.aux_state),
          jax.device_get(ref.opt_state))
    return ref, port, rng


def _normals(key, n):
    return torch.as_tensor(np.asarray(jax.random.normal(key, (n, SB, ACT), jnp.float32)))


def _cql_draws(key, num_actions):
    """The draws of ``CQLJaxPolicy``'s update on shard 0 from the policy
    key: split once by the learn call, the shard index folded in, split
    into the next action's, the policy action's, the uniform actions',
    the current and the next states' keys; each repeated sample its own
    key of a split."""
    _, rng = jax.random.split(key)
    rng_t, rng_a, rng_r, rng_c, rng_n = jax.random.split(jax.random.fold_in(rng, 0), 5)
    one = lambda k: torch.as_tensor(np.asarray(jax.random.normal(k, (SB, ACT), jnp.float32)))  # noqa: E731
    rep = lambda k: torch.stack([one(r) for r in jax.random.split(k, num_actions)])  # noqa: E731
    rand = jax.random.uniform(rng_r, (SB * num_actions, ACT), minval=LOW, maxval=HIGH)
    return one(rng_t), one(rng_a), torch.as_tensor(np.asarray(rand)), rep(rng_c), rep(rng_n)


def _crr_draws(key, n_sample):
    _, rng = jax.random.split(key)
    rng_t, rng_adv = jax.random.split(jax.random.fold_in(rng, 0))
    one = lambda k: torch.as_tensor(np.asarray(jax.random.normal(k, (SB, ACT), jnp.float32)))  # noqa: E731
    return one(rng_t), torch.stack([one(r) for r in jax.random.split(rng_adv, n_sample)])


def _assert_nets_close(port, ref, groups, targets):
    got = port.get_state()
    for group in groups:
        want = flax_to_state_dict(jax.device_get(ref.params[group]))
        count, mu, nu = from_jax_adam_state(jax.device_get(ref.opt_state[group]))
        assert got["opt_state"][group]["count"] == count, group
        for k, v in want.items():
            name = f"{group}.{k}"
            np.testing.assert_allclose(got["weights"][name], v, rtol=1e-5, atol=1.5e-5, err_msg=name)
            np.testing.assert_allclose(got["opt_state"][group]["mu"][name], mu[k], rtol=1e-5,
                                       atol=1.5e-5, err_msg=name)
            np.testing.assert_allclose(got["opt_state"][group]["nu"][name], nu[k], rtol=1e-5,
                                       atol=1e-8, err_msg=name)
    for key, names, tensors in targets:
        want = flax_to_state_dict(jax.device_get(ref.aux_state[key]))
        for name, t in zip(names, tensors):
            np.testing.assert_allclose(t.numpy(), want[name], rtol=1e-5, atol=1.5e-5, err_msg=name)


def _assert_stats_close(got, want, names):
    assert tuple(got) == names and set(want) == set(names)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1.5e-5 * abs(v) + 1e-5, (k, got[k], v)


@pytest.mark.parametrize("warm,bc_iters", [(0, 5), (2, 2)])
def test_one_cql_update_matches_reference(warm, bc_iters):
    """Update 1 of 5 in the BC warmup, and update 3 after a warmup of 2."""
    ref, port, rng = _offline_pair(CQLJaxPolicy, CQLTorchPolicy, JCQLConfig, from_jax_cql_state,
                                   warm, bc_iters=bc_iters, num_actions=3, min_q_weight=2.0,
                                   temperature=0.8)
    assert int(port.aux_state["step"]) == warm
    b = _sac_batch(rng)
    draws = _cql_draws(ref._rng, 3)
    want = ref.learn_on_batch(JSampleBatch(dict(b)))
    got = port.learn_on_batch(SampleBatch(dict(b)), draws=draws)
    _assert_stats_close(got, want, CQL_STATS)
    assert got["in_bc_warmup"] == want["in_bc_warmup"] == float(warm < bc_iters)
    assert int(port.aux_state["step"]) == int(ref.aux_state["step"]) == warm + 1
    _assert_nets_close(port, ref, ("actor", "critic", "log_alpha")[:2],
                       [("target_critic", port.critic_names, port.aux_state["target_critic"])])
    np.testing.assert_allclose(port.get_weights()["log_alpha"], np.asarray(ref.params["log_alpha"]),
                               rtol=1e-5, atol=1.5e-5)


@pytest.mark.parametrize("weight_type", ["bin", "exp"])
def test_one_crr_update_matches_reference(weight_type):
    ref, port, rng = _offline_pair(CRRJaxPolicy, CRRTorchPolicy, JCRRConfig, from_jax_crr_state,
                                   1, weight_type=weight_type, n_action_sample=3,
                                   temperature=0.7, max_weight=5.0,
                                   target_update_grad_intervals=3)
    b = _sac_batch(rng)
    draws = _crr_draws(ref._rng, 3)
    want = ref.learn_on_batch(JSampleBatch(dict(b)))
    got = port.learn_on_batch(SampleBatch(dict(b)), draws=draws)
    _assert_stats_close(got, want, CRR_STATS)
    _assert_nets_close(port, ref, ("actor", "critic"),
                       [("target_actor", port.actor_names, port.aux_state["target_actor"]),
                        ("target_critic", port.critic_names, port.aux_state["target_critic"])])
    assert port.get_state()["opt_state"]["log_alpha"]["count"] == 0


def test_crr_target_sync_interval():
    port = CRRTorchPolicy(Box(-1, 1, (SOBS,)), Box(LOW, HIGH, (ACT,)),
                          {**HIDDEN, "seed": 0, "target_update_grad_intervals": 3}, device="cpu")
    rng = np.random.default_rng(1)
    first = [t.clone() for t in port.aux_state["target_actor"] + port.aux_state["target_critic"]]
    for step in range(1, 7):
        port.learn_on_batch(SampleBatch(_sac_batch(rng)))
        targets = port.aux_state["target_actor"] + port.aux_state["target_critic"]
        nets = list(port.actor.parameters()) + list(port.critic.parameters())
        if step % 3 == 0:
            assert all(torch.equal(t, p) for t, p in zip(targets, nets)), step
            first = [t.clone() for t in targets]
        else:
            assert all(torch.equal(t, f) for t, f in zip(targets, first)), step
            assert not all(torch.equal(t, p) for t, p in zip(targets, nets)), step


def _pendulum_offline_data(tmp_path):
    """A small Pendulum-v1 dataset from SAC with learning held off (the
    reference's ``_pendulum_offline_data``)."""
    out_dir = str(tmp_path / "pendulum_data")
    sac = (SACConfig().environment("Pendulum-v1")
           .rollouts(num_rollout_workers=0, rollout_fragment_length=64)
           .training(train_batch_size=64, num_steps_sampled_before_learning_starts=10 ** 9,
                     **HIDDEN)
           .offline_data(output=out_dir).debugging(seed=0).resources(device="cpu").build())
    for _ in range(4):
        sac.train()
    sac.stop()
    return out_dir


def test_cql_and_crr_offline_steps(tmp_path):
    data = _pendulum_offline_data(tmp_path)
    assert JsonReader(data).read_all().count == 256
    cql = (CQLConfig().environment("Pendulum-v1").rollouts(num_rollout_workers=0)
           .training(train_batch_size=64, bc_iters=2, num_actions=4, min_q_weight=5.0, **HIDDEN)
           .offline_data(input_=data).debugging(seed=0).resources(device="cpu").build())
    flags = []
    for _ in range(3):
        info = cql.train()["info"]["learner"]["default_policy"]
        flags.append(info["in_bc_warmup"])
        assert np.isfinite(info["critic_loss"]) and np.isfinite(info["cql_penalty"])
    assert flags == [1.0, 1.0, 0.0]
    assert cql._counters["num_env_steps_trained"] == 3 * 64
    cql.stop()
    crr = (CRRConfig().environment("Pendulum-v1").rollouts(num_rollout_workers=0)
           .training(train_batch_size=64, weight_type="exp", temperature=1.0, n_action_sample=2,
                     target_update_grad_intervals=2, **HIDDEN)
           .offline_data(input_=data).debugging(seed=0).resources(device="cpu").build())
    for _ in range(3):
        info = crr.train()["info"]["learner"]["default_policy"]
    assert np.isfinite(info["actor_loss"]) and np.isfinite(info["critic_loss"])
    assert 0.0 <= info["mean_weight"] <= 20.0
    crr.stop()
    with pytest.raises(NotImplementedError, match="Lagrangian"):
        CQLConfig().environment("Pendulum-v1").training(lagrangian=True).build()
    with pytest.raises(NotImplementedError, match="twin_q"):
        CRRConfig().environment("Pendulum-v1").training(twin_q=False).build()


@pytest.mark.slow
def test_bc_learns_cartpole_from_ppo_data(tmp_path):
    """PPO until its mean reaches 160, its samples written, then BC from
    them to an evaluation mean of 120 (the reference's bar)."""
    from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig

    out_dir = str(tmp_path / "ppo_data")
    ppo = (PPOConfig().environment("CartPole-v1")
           .rollouts(num_rollout_workers=0, rollout_fragment_length=256, num_envs_per_worker=4)
           .training(train_batch_size=2048, sgd_minibatch_size=256, num_sgd_iter=8, lr=3e-4,
                     entropy_coeff=0.01, clip_param=0.2, kl_coeff=0.0,
                     model={"fcnet_hiddens": [256, 256]})
           .debugging(seed=0).resources(device="cpu").build())
    best = -np.inf
    deadline = time.time() + 420
    while time.time() < deadline and best < 160.0:
        r = ppo.train().get("episode_reward_mean", np.nan)
        if np.isfinite(r):
            best = max(best, r)
    assert best >= 160.0, f"expert PPO too weak: {best}"
    lw = ppo.workers.local_worker()
    lw.config["output"] = out_dir
    for _ in range(8):
        lw.sample()
    ppo.stop()
    bc = (BCConfig().environment("CartPole-v1").rollouts(num_rollout_workers=0)
          .training(train_batch_size=1024, lr=1e-3, num_sgd_iter=4,
                    model={"fcnet_hiddens": [256, 256]})
          .offline_data(input_=out_dir, off_policy_estimation_methods=[])
          .evaluation(evaluation_interval=5, evaluation_duration=10)
          .debugging(seed=0).resources(device="cpu").build())
    best_bc = -np.inf
    deadline = time.time() + 300
    while time.time() < deadline and best_bc < 120.0:
        ev = bc.train().get("evaluation") or {}
        r = ev.get("episode_reward_mean", np.nan)
        if np.isfinite(r):
            best_bc = max(best_bc, r)
    bc.stop()
    assert best_bc >= 120.0, f"BC failed to clone the expert: {best_bc}"
