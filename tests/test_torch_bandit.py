"""LinUCB and LinTS of the port against the reference's, on the CPU.

Contracts:

- after the same updates, the stacked precision (A, d, d) and moment
  (A, d) within 1e-5 relative (plus 1e-6: float32 sums of the same
  rank-1 terms in other orders);
- the scores on a batch of contexts, greedy and exploring (UCB; Thompson
  sampling with the reference's draw injected, ``jax.random.normal`` of
  the policy key's split), within 1e-5 relative plus 1e-5: one float32
  inversion of a precision whose condition number the check prints
  (below 100 here), then products; the chosen arms equal;
- the weights round-trip, the reference's state carried by
  ``from_jax_bandit_state``, gymnasium's ``Discrete`` accepted and
  another space refused as the reference refuses it;
- ``BanditLinUCB`` and ``BanditLinTS`` learn the port's linear-context
  bandit: the late mean reward above the early one and above a uniform
  random policy's expected reward (the reference's
  ``tests/test_bandit_qmix.py`` cases).
"""

from __future__ import annotations

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

from ray_tpu.algorithms.bandit import bandit as jbandit
from ray_tpu.data.sample_batch import SampleBatch as JSampleBatch
from ray_tpu_torch.algorithms.bandit import bandit
from ray_tpu_torch.algorithms.bandit.bandit import (
    BanditLinTSConfig,
    BanditLinUCBConfig,
    LinearContextBandit,
)
from ray_tpu_torch.data.sample_batch import SampleBatch
from ray_tpu_torch.env.spaces import Box, Discrete
from ray_tpu_torch.utils.jax_params import from_jax_bandit_state

D, ARMS = 5, 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batches(n_batches=6, n=16, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((ARMS, D))
    out = []
    for _ in range(n_batches):
        ctx = rng.standard_normal((n, D)).astype(np.float32)
        act = rng.integers(0, ARMS, n).astype(np.int64)
        rew = ((ctx * w[act]).sum(-1) + 0.1 * rng.standard_normal(n)).astype(np.float32)
        out.append({"obs": ctx, "actions": act, "rewards": rew})
    return out


KINDS = {"ucb": (jbandit._UCBPolicy, bandit._UCBPolicy, {"ucb_coeff": 1.5}),
         "ts": (jbandit._TSPolicy, bandit._TSPolicy, {"sample_theta_std": 0.7})}


def _pair(kind, **over):
    jcls, tcls, extra = KINDS[kind]
    cfg = {"lambda_reg": 0.1, "seed": 3, **extra, **over}
    ref = jcls(gym.spaces.Box(-10, 10, (D,), np.float32), gym.spaces.Discrete(ARMS), cfg)
    port = tcls(Box(-10, 10, (D,), np.float32), Discrete(ARMS), cfg, device="cpu")
    return ref, port


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_updates_and_scores_match_reference(kind):
    ref, port = _pair(kind)
    for b in _batches():
        got, want = port.learn_on_batch(SampleBatch(dict(b))), ref.learn_on_batch(JSampleBatch(dict(b)))
        assert got["update_count"] == want["update_count"]
        _close(got["mean_reward"], want["mean_reward"])
        _close(port.precision.numpy(), np.asarray(ref.precision))
        _close(port.moment.numpy(), np.asarray(ref.moment))
    cond = np.linalg.cond(np.asarray(ref.precision, np.float64)).max()
    print("precision condition number", cond)
    assert cond < 100
    ctx = np.random.default_rng(9).standard_normal((32, D)).astype(np.float32)
    score_fn = ref._build_score_fn()
    for explore in (False, True):
        ref._rng, rng = jax.random.split(ref._rng)
        noise = torch.as_tensor(np.array(jax.random.normal(rng, (ARMS, D))))
        want_a, want = score_fn(ref.precision, ref.moment, jax.numpy.asarray(ctx), rng, explore)
        got = port.scores(torch.as_tensor(ctx), explore, noise if kind == "ts" else None)
        _close(got.numpy(), want, atol=1e-5)
        a, _, _ = port.compute_actions(ctx, explore=explore, noise=noise)
        np.testing.assert_array_equal(a, np.asarray(want_a))


def test_weights_round_trip_and_spaces():
    ref, port = _pair("ucb")
    for b in _batches(2):
        ref.learn_on_batch(JSampleBatch(dict(b)))
    from_jax_bandit_state(port, ref.get_weights())
    np.testing.assert_array_equal(port.precision.numpy(), np.asarray(ref.precision))
    other = bandit._UCBPolicy(gym.spaces.Box(-10, 10, (D,), np.float32), gym.spaces.Discrete(ARMS),
                              {}, device="cpu")
    other.set_weights(port.get_weights())
    np.testing.assert_array_equal(other.moment.numpy(), np.asarray(ref.moment))
    assert other.precision.dtype == torch.float32
    with pytest.raises(ValueError, match="Discrete"):
        bandit._TSPolicy(Box(-1, 1, (D,), np.float32), Box(-1, 1, (2,), np.float32), {},
                         device="cpu")


def test_draws_come_from_the_generator():
    _, a = _pair("ts")
    _, b = _pair("ts")
    ctx = np.random.default_rng(1).standard_normal((8, D)).astype(np.float32)
    assert (a.compute_actions(ctx)[0] == b.compute_actions(ctx)[0]).all()
    g = torch.Generator().manual_seed(3)
    noise = torch.randn((ARMS, D), generator=g)
    _, c = _pair("ts")
    np.testing.assert_array_equal(c.scores(torch.as_tensor(ctx), True, noise).numpy(),
                                  _pair("ts")[1].scores(torch.as_tensor(ctx), True).numpy())


@pytest.mark.parametrize("config_cls", [BanditLinUCBConfig, BanditLinTSConfig])
def test_bandit_learns_linear_problem(config_cls):
    env_config = {"dim": 4, "num_arms": 3}
    algo = (config_cls().environment(LinearContextBandit, env_config=env_config)
            .rollouts(num_rollout_workers=0, rollout_fragment_length=16)
            .training(train_batch_size=16).debugging(seed=0).resources(device="cpu").build())
    try:
        early = algo.train()["episode_reward_mean"]
        for _ in range(25):
            result = algo.train()
        late = result["episode_reward_mean"]
        env = LinearContextBandit(env_config)
        ctx = np.random.default_rng(0).standard_normal((20000, 4)).astype(np.float32)
        uniform = float(env.expected_rewards(ctx).mean())
        assert np.isfinite(late) and late > early and late > uniform + 0.5, (early, late, uniform)
        assert float(np.abs(algo.get_policy().moment.numpy()).sum()) > 0
        assert algo.get_policy().precision.device.type == "cpu"
    finally:
        algo.stop()
