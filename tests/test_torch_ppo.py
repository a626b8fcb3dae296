"""The PPO learner of the port against the reference's, on the CPU.

One ``learn_on_batch`` on a small frame-pool batch at the pixel
geometry (84x84x4, 6 actions, B=64, minibatch 16, 2 epochs, float32
model). The reference runs on a one-shard mesh (the test process has 8
virtual devices; more shards would change the permutations and add a
pmean). The port starts from the reference's initial weights and is
handed the reference's per-epoch permutations, re-derived from its key
stream. Tolerances: stats 1e-4 relative; parameters and Adam moments
1e-5 relative plus an absolute floor: 5e-5 for parameters (a tenth of
one Adam step at lr 5e-4: where a gradient element is near zero, Adam's
m/sqrt(v) turns float32 noise in the gradient into a visible part of
the step; 1.5e-5 was measured), 1e-6 for the first moment and 1e-9 for
the second. Eight Adam
steps of float32 arithmetic, summed in other orders by the two
frameworks.
"""

from __future__ import annotations

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

from ray_tpu.algorithms.ppo.ppo import PPOJaxPolicy
from ray_tpu.sharding import get_mesh
from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig, PPOTorchPolicy
from ray_tpu_torch.env.spaces import Box, Discrete
from ray_tpu_torch.ops.framestack import frame_stream_columns
from ray_tpu_torch.utils.jax_params import (
    flax_to_state_dict,
    from_jax_adam_state,
    from_jax_params,
)

B, MB, ITERS, K, A = 64, 16, 2, 4, 6


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (B + K - 1, 21, 21, 1), dtype=np.uint8)
    frames = np.kron(base, np.ones((1, 4, 4, 1), np.uint8))
    return {
        **frame_stream_columns(frames, B, K),
        "actions": rng.integers(0, A, B).astype(np.int64),
        "action_logp": np.full(B, -1.79, np.float32),
        "action_dist_inputs": rng.standard_normal((B, A)).astype(np.float32),
        "advantages": rng.standard_normal(B).astype(np.float32),
        "value_targets": rng.standard_normal(B).astype(np.float32),
    }


CONFIG = {
    "train_batch_size": B,
    "sgd_minibatch_size": MB,
    "num_sgd_iter": ITERS,
    "lr": 5e-4,
    "kl_coeff": 0.2,
    "entropy_coeff": 0.01,
    "grad_clip": 40.0,
    "model": {"dtype": "float32"},
    "seed": 3,
}


def _reference_perms(key):
    """The permutations ``JaxPolicy``'s nest draws on shard 0 from the
    policy key ``key`` (learn_on_device_batch splits it once; the nest
    folds in the shard index, splits per epoch, and permutes with the
    first half of each epoch key)."""
    _, rng = jax.random.split(key)
    rng = jax.random.fold_in(rng, 0)
    return np.stack([
        np.asarray(jax.random.permutation(jax.random.split(r)[0], B))
        for r in jax.random.split(rng, ITERS)
    ])


def test_one_learn_step_matches_reference():
    ref = PPOJaxPolicy(
        gym.spaces.Box(0, 255, (84, 84, K), np.uint8), gym.spaces.Discrete(A),
        {**CONFIG, "_mesh": get_mesh(devices=jax.devices()[:1])},
    )
    port = PPOTorchPolicy(Box(0, 255, (84, 84, K), np.uint8), Discrete(A), CONFIG, device="cpu")
    from_jax_params(jax.device_get(ref.params), port.model)
    perms = _reference_perms(ref._rng)
    batch = _batch()

    ref_stats = ref.learn_on_batch(batch)
    stats = port.learn_on_batch(batch, perms=torch.as_tensor(perms))

    assert set(stats) == set(ref_stats)
    for k, v in ref_stats.items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-4, atol=1e-7, err_msg=k)

    ref_params = flax_to_state_dict(jax.device_get(ref.params))
    got = port.get_weights()
    for name, r in ref_params.items():
        np.testing.assert_allclose(got[name], r, rtol=1e-5, atol=5e-5, err_msg=name)

    count, mu, nu = from_jax_adam_state(jax.device_get(ref.opt_state))
    state = port.get_state()["opt_state"]
    assert state["count"] == count == ITERS * (B // MB)
    for name in ref_params:
        np.testing.assert_allclose(state["mu"][name], mu[name], rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(state["nu"][name], nu[name], rtol=1e-5, atol=1e-9, err_msg=name)
    assert port.coeff_values["kl_coeff"] == pytest.approx(ref.coeff_values["kl_coeff"])


def test_learn_state_roundtrip_and_repeatable_perms():
    """Fixed seed → identical learn results; get_state/set_state carries
    weights, Adam state and coefficients across policies."""
    space, act = Box(0, 255, (84, 84, K), np.uint8), Discrete(A)
    cfg = {**CONFIG, "model": {"conv_filters": [[8, [8, 8], [4, 4]], [8, [4, 4], [2, 2]]],
                               "post_fcnet_hiddens": [32]}}
    a = PPOTorchPolicy(space, act, cfg, device="cpu")
    b = PPOTorchPolicy(space, act, cfg, device="cpu")
    sa, sb = a.learn_on_batch(_batch(1)), b.learn_on_batch(_batch(1))
    assert sa == sb
    c = PPOTorchPolicy(space, act, {**cfg, "seed": 99}, device="cpu")
    c.set_state(a.get_state())
    assert c.opt_state.count == a.opt_state.count
    assert c.learn_on_batch(_batch(2), perms=a.draw_permutations(B)) == b.learn_on_batch(
        _batch(2), perms=b.draw_permutations(B)
    )


def _tiny_ppo(seed):
    cfg = PPOConfig().environment(
        "PongLiteJax-v0", env_config={"max_steps": 6, "rallies": 2}, env_backend="jax"
    )
    cfg.rollouts(num_rollout_workers=0, num_envs_per_worker=2, rollout_fragment_length=8)
    cfg.training(
        train_batch_size=16, sgd_minibatch_size=8, num_sgd_iter=2, lr=3e-4,
        model={"conv_filters": [[8, [8, 8], [4, 4]], [8, [4, 4], [2, 2]]],
               "post_fcnet_hiddens": [32]},
    )
    cfg.lambda_ = 0.95
    return cfg.debugging(seed=seed).resources(device="cpu").build()


def test_ppo_train_repeatable_and_result_keys():
    """Two runs on one seed give identical results (N=2, T=8)."""
    runs = []
    for _ in range(2):
        algo = _tiny_ppo(seed=11)
        runs.append([algo.train() for _ in range(2)])
    (r1a, r1b), (r2a, r2b) = runs
    for key in (
        "episode_reward_mean", "episodes_this_iter", "num_env_steps_sampled",
        "timesteps_total", "training_iteration",
    ):
        assert key in r1b
    assert r1b["num_env_steps_sampled"] == 32 and r1b["training_iteration"] == 2
    assert r1a["episodes_this_iter"] + r1b["episodes_this_iter"] >= 4
    learner = r1b["info"]["learner"]["default_policy"]
    assert {"policy_loss", "vf_loss", "kl", "entropy", "total_loss", "grad_gnorm",
            "cur_lr", "cur_kl_coeff"} <= set(learner)
    for a, b in ((r1a, r2a), (r1b, r2b)):
        assert a["info"]["learner"] == b["info"]["learner"]
        np.testing.assert_array_equal(a["episode_reward_mean"], b["episode_reward_mean"])
        assert a["episodes_this_iter"] == b["episodes_this_iter"]
    other = _tiny_ppo(seed=12).train()
    assert other["info"]["learner"] != r1a["info"]["learner"]
