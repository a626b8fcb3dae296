"""Rainbow's parts of the port's DQN against the JAX package's, on the CPU.

- ``adjust_nstep`` bitwise, with terminals inside the fragment and at
  its end;
- ``categorical_projection`` bitwise (the reference test's golden case
  and the Rainbow yaml's support), and the C51 support bitwise against
  ``jnp.linspace``;
- ``NoisyDense`` and ``DQNModel.q_dist`` (C51 + noisy + dueling) within
  1e-5 relative, on the reference's weights and its injected draws (the
  port's noise is the reference's ``jax.random`` normals, split as its
  ``noise_key`` is);
- one learn call of Rainbow (C51 + noisy + dueling + double Q + n-step
  + prioritized replay's IS weights) from the reference's parameters,
  target and draws: parameters within 1.5e-5 (the repo's Adam
  tolerance), stats within 1e-5; the PER priorities (the per-row
  cross-entropy) within 1e-5;
- ``_materialize_compressed`` bitwise against the reference's and
  against the stacks before compression;
- the act step's noise: exploring, the heads' draws come before the
  exploration's, and ``action_draws`` takes exactly what
  ``compute_actions`` draws;
- a Rainbow checkpoint round trip, bitwise, and cartpole-rainbow.yaml
  building and training with no refusal, and a pixel DQN with frame
  pools shipped, on the actor lane.
"""

from __future__ import annotations

import pathlib

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.algorithms.dqn import dqn as jdqn
from ray_tpu.algorithms.dqn.dqn_model import DQNModel as JDQNModel
from ray_tpu.algorithms.dqn.dqn_model import NoisyDense as JNoisyDense
from ray_tpu.algorithms.dqn.dqn_model import categorical_projection as j_projection
from ray_tpu.data.sample_batch import SampleBatch as JSampleBatch
from ray_tpu.ops import framestack as jfs
from ray_tpu.sharding import get_mesh
from ray_tpu_torch.algorithms.dqn import dqn as tdqn
from ray_tpu_torch.algorithms.dqn.dqn import DQNConfig, DQNTorchPolicy, adjust_nstep
from ray_tpu_torch.algorithms.dqn.dqn_model import (
    DQNModel,
    NoisyDense,
    c51_support,
    categorical_projection,
)
from ray_tpu_torch.data.sample_batch import SampleBatch
from ray_tpu_torch.env.spaces import Box, Discrete
from ray_tpu_torch.ops import framestack as tfs
from ray_tpu_torch.utils.jax_params import (
    flax_to_state_dict,
    from_jax_adam_state,
    from_jax_dqn_target,
    from_jax_params,
)
from ray_tpu_torch.utils.tuned_example import build_tuned_example

REPO = pathlib.Path(__file__).resolve().parents[1]
RAINBOW_YAML = REPO / "tuned_examples" / "dqn" / "cartpole-rainbow.yaml"


def _one_shard():
    return get_mesh(devices=jax.devices()[:1])


# -- n-step ----------------------------------------------------------------------


def _fragment(rng, n, done_at, obs_dim=3):
    obs = rng.standard_normal((n + 1, obs_dim)).astype(np.float32)
    dones = np.zeros(n, bool)
    dones[list(done_at)] = True
    return {
        "obs": obs[:-1], "new_obs": obs[1:], "actions": rng.integers(0, 2, n),
        "rewards": rng.standard_normal(n).astype(np.float32), "dones": dones,
    }


@pytest.mark.parametrize("n_step,gamma,done_at", [
    (3, 0.99, (4, 5, 11)), (2, 0.9, ()), (5, 0.97, (0, 9, 15)), (3, 0.99, (15,)),
])
def test_adjust_nstep_bitwise(n_step, gamma, done_at):
    cols = _fragment(np.random.default_rng(n_step + len(done_at)), 16, done_at)
    ref = JSampleBatch({k: v.copy() for k, v in cols.items()})
    port = SampleBatch({k: v.copy() for k, v in cols.items()})
    jdqn.adjust_nstep(n_step, gamma, ref)
    adjust_nstep(n_step, gamma, port)
    assert set(port) == set(ref) and "n_steps" in port
    for k in ref:
        a, b = np.asarray(port[k]), np.asarray(ref[k])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    # a fold stops at a terminal: the row before it folds that terminal
    for t in done_at:
        assert port["dones"][t] and port["n_steps"][t] == 1.0


# -- the C51 projection and support -------------------------------------------------


@pytest.mark.parametrize("v_min,v_max,atoms", [(0.0, 500.0, 51), (-10.0, 10.0, 51), (-2.0, 2.0, 11),
                                               (-5.0, 5.0, 21)])
def test_c51_support_is_the_reference_linspace(v_min, v_max, atoms):
    assert c51_support(v_min, v_max, atoms).tobytes() == np.asarray(
        jnp.linspace(v_min, v_max, atoms)).tobytes()


def _projection_inputs(seed, B, atoms, disc):
    rng = np.random.default_rng(seed)
    p = rng.random((B, atoms)).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    rewards = rng.uniform(-3, 3, B).astype(np.float32)
    disc = np.asarray(disc, np.float32) * np.ones(B, np.float32)
    not_done = (rng.random(B) > 0.3).astype(np.float32)
    return p, rewards, disc, not_done


@pytest.mark.parametrize("seed,B,atoms,v_min,v_max,disc", [
    (0, 16, 11, -2.0, 2.0, 0.9),  # tests/test_dqn_rainbow.py's golden case
    (1, 64, 51, 0.0, 500.0, 0.99 ** 3),  # cartpole-rainbow.yaml's support, n_step 3
    (2, 32, 51, -10.0, 10.0, 0.5),  # many atoms into one bin
])
def test_categorical_projection_bitwise(seed, B, atoms, v_min, v_max, disc):
    """Mass onto the neighbouring bins, summed in the reference's order:
    bitwise, and still a distribution."""
    p, r, d, nd = _projection_inputs(seed, B, atoms, disc)
    want = np.asarray(j_projection(*map(jnp.asarray, (p, r, d, nd)), v_min, v_max))
    got = categorical_projection(*map(torch.as_tensor, (p, r, d, nd)), v_min, v_max).numpy()
    assert got.tobytes() == want.tobytes()
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


# -- the noisy heads and the C51 model ------------------------------------------------


def _normals(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def _head_noise(key, head):
    """A ``NoisyDense``'s (ε_in, ε_out) as the reference draws them from
    its key, shaped as the port's draws (leading dim 1)."""
    k_in, k_out = jax.random.split(key)
    return (torch.as_tensor(_normals(k_in, (head.in_features, 1))[None]),
            torch.as_tensor(_normals(k_out, (1, head.features))[None]))


def model_noise(key, model):
    """``DQNModel.q_dist``'s noise as the reference's ``q_dist`` draws it
    from ``noise_key``: the advantage head's key, then the value head's."""
    k_a, k_v = jax.random.split(key)
    out = _head_noise(k_a, model.adv_head)
    if model.dueling:
        out += _head_noise(k_v, model.value_head)
    return out


def learn_noise(key, model, double_q=True):
    """The three noise sets of one reference TD error from its ``rng``:
    online on OBS, target on NEXT_OBS, online on NEXT_OBS."""
    keys = jax.random.split(key, 3)
    return tuple(model_noise(k, model) for k in keys[: 3 if double_q else 2])


def test_noisy_dense_matches_reference():
    x = np.random.default_rng(0).standard_normal((7, 12)).astype(np.float32)
    jl = JNoisyDense(5, sigma0=0.5)
    params = jax.device_get(jl.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    tl = NoisyDense(12, 5, 0.5)
    with torch.no_grad():
        for name in ("w_mu", "w_sigma", "b_mu", "b_sigma"):
            getattr(tl, name).copy_(torch.as_tensor(np.array(params[name])))
    key = jax.random.PRNGKey(3)
    want = np.asarray(jl.apply({"params": params}, jnp.asarray(x), noise_key=key))
    mean = np.asarray(jl.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tl(torch.as_tensor(x), _head_noise(key, tl)).numpy()
        got_mean = tl(torch.as_tensor(x)).numpy()
        # a vectorized bucket's per-row noise: row i with noise i
        per_row = [_head_noise(k, tl) for k in jax.random.split(key, 7)]
        rows = tl(torch.as_tensor(x), tuple(torch.cat(e) for e in zip(*per_row))).numpy()
        one_by_one = np.concatenate([tl(torch.as_tensor(x[i:i + 1]), e).numpy()
                                     for i, e in enumerate(per_row)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_mean, mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rows, one_by_one, rtol=1e-6, atol=1e-6)
    # the reference's sigma init and the port's agree
    assert float(NoisyDense(12, 5, 0.5).w_sigma[0, 0].detach()) == pytest.approx(0.5 / np.sqrt(12))


@pytest.mark.parametrize("dueling", [True, False])
def test_q_dist_c51_noisy_matches_reference(dueling):
    obs = np.random.default_rng(1).standard_normal((6, 4)).astype(np.float32)
    kw = dict(hiddens=(32, 16), activation="relu", num_atoms=51, v_min=0.0, v_max=500.0,
              dueling=dueling, noisy=True, sigma0=0.5)
    jm = JDQNModel(num_outputs=3, **kw)
    params = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.asarray(obs)))
    tm = from_jax_params(params, DQNModel((4,), 3, **kw))
    for key in (None, jax.random.PRNGKey(5)):
        want = jm.apply(params, jnp.asarray(obs), noise_key=key, method=JDQNModel.q_dist)
        noise = None if key is None else model_noise(key, tm)
        with torch.no_grad():
            got = tm.q_dist(torch.as_tensor(obs), noise)
        for g, w, name in zip(got, want, ("q", "support logits", "probs")):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=name)


# -- one Rainbow learn call --------------------------------------------------------

B, OBS, ACTS = 32, 4, 2
RAINBOW = {
    "train_batch_size": B, "lr": 5e-4, "grad_clip": 40.0, "gamma": 0.99, "seed": 3,
    "model": {"fcnet_hiddens": [32, 32], "fcnet_activation": "tanh"},
    "num_atoms": 51, "v_min": 0.0, "v_max": 500.0, "noisy": True, "sigma0": 0.5,
    "dueling": True, "double_q": True, "n_step": 3,
}


def _rainbow_batch(seed):
    """An n-step folded fragment with IS weights, as a prioritized
    replay of cartpole-rainbow.yaml gives one."""
    rng = np.random.default_rng(seed)
    cols = _fragment(rng, B, (7, 19, 30), OBS)
    cols["rewards"] = np.ones(B, np.float32)
    sb = SampleBatch(cols)
    adjust_nstep(3, 0.99, sb)
    sb["weights"] = (rng.random(B) + 0.5).astype(np.float32)
    return {k: np.asarray(v) for k, v in sb.items()}


def _rainbow_pair(**over):
    cfg = {**RAINBOW, **over}
    space = gym.spaces.Box(-1, 1, (OBS,), np.float32)
    ref = jdqn.DQNJaxPolicy(space, gym.spaces.Discrete(ACTS), {**cfg, "_mesh": _one_shard()})
    other = jdqn.DQNJaxPolicy(space, gym.spaces.Discrete(ACTS),
                              {**cfg, "seed": 8, "_mesh": _one_shard()})
    ref.aux_state = {"target_params": other.params}  # a target unlike the online net
    port = DQNTorchPolicy(Box(-1, 1, (OBS,), np.float32), Discrete(ACTS), cfg, device="cpu")
    from_jax_params(jax.device_get(ref.params), port.model)
    from_jax_dqn_target(port, jax.device_get(ref.aux_state))
    return ref, port


def _learn_key(key):
    """The loss's rng and the permutation of one reference learn call
    from the policy key (one epoch, one minibatch, shard 0)."""
    _, rng = jax.random.split(key)
    (r,) = jax.random.split(jax.random.fold_in(rng, 0), 1)
    perm_rng, scan_rng = jax.random.split(r)
    (mb_rng,) = jax.random.split(scan_rng, 1)
    return mb_rng, torch.as_tensor(np.asarray(jax.random.permutation(perm_rng, B)))[None]


def _priority_key(key):
    return jax.random.split(key)[1]


@pytest.mark.parametrize("double_q", [True, False])
def test_one_rainbow_learn_matches_reference(double_q, monkeypatch):
    ref, port = _rainbow_pair(double_q=double_q)
    batch = _rainbow_batch(0)
    # the priorities before the update: the per-row cross-entropy
    noise = learn_noise(_priority_key(ref._rng), port.model, double_q)
    ref_pri = ref.compute_td_error(JSampleBatch(dict(batch)))
    np.testing.assert_allclose(port.compute_td_error(batch, noise=noise), ref_pri,
                               rtol=1e-5, atol=1e-5)
    mb_rng, perm = _learn_key(ref._rng)
    monkeypatch.setattr(port, "draw_learn_noise",
                        lambda: learn_noise(mb_rng, port.model, double_q))
    ref_stats = ref.learn_on_batch(JSampleBatch(dict(batch)))
    stats = port.learn_on_batch(batch, perms=perm)
    assert set(stats) == set(ref_stats)
    for k, v in ref_stats.items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-5, atol=1e-5, err_msg=k)
    got = port.get_weights()
    for name, r in flax_to_state_dict(jax.device_get(ref.params)).items():
        np.testing.assert_allclose(got[name], r, rtol=1e-5, atol=1.5e-5, err_msg=name)
    count, mu, _ = from_jax_adam_state(jax.device_get(ref.opt_state))
    assert port.opt_state.count == count == 1
    for i, name in enumerate(port.param_names):
        np.testing.assert_allclose(port.opt_state.mu[i].numpy(), mu[name], rtol=1e-5, atol=1e-6)
    # the priorities after it
    noise = learn_noise(_priority_key(ref._rng), port.model, double_q)
    np.testing.assert_allclose(port.compute_td_error(batch, noise=noise),
                               ref.compute_td_error(JSampleBatch(dict(batch))), rtol=1e-5, atol=1e-5)


def test_rainbow_state_roundtrip_is_bitwise():
    space, act = Box(-1, 1, (OBS,), np.float32), Discrete(ACTS)
    a = DQNTorchPolicy(space, act, RAINBOW, device="cpu")
    a.learn_on_batch(_rainbow_batch(1))
    b = DQNTorchPolicy(space, act, {**RAINBOW, "seed": 9}, device="cpu")
    b.set_state(a.get_state())
    for x, y in zip(a.aux_state["target_params"] + a.params, b.aux_state["target_params"] + b.params):
        assert torch.equal(x, y)
    b.action_generator.set_state(a.action_generator.get_state())
    perms = a.draw_permutations(B)
    assert a.learn_on_batch(_rainbow_batch(2), perms=perms) == b.learn_on_batch(_rainbow_batch(2),
                                                                               perms=perms)
    obs = np.random.default_rng(3).standard_normal((5, OBS)).astype(np.float32)
    assert np.array_equal(a.compute_actions(obs)[0], b.compute_actions(obs)[0])


# -- the act step ------------------------------------------------------------------


def test_noisy_act_step_draws_noise_first():
    space, act = Box(-1, 1, (OBS,), np.float32), Discrete(ACTS)
    p = DQNTorchPolicy(space, act, RAINBOW, device="cpu")
    obs = np.random.default_rng(4).standard_normal((1, OBS)).astype(np.float32)
    state = p.action_generator.get_state()
    draws = p.action_draws(p.action_generator, True)
    assert len(draws) == 4 + 2  # two heads' (ε_in, ε_out), then EpsilonGreedy's two
    assert [tuple(d.shape) for d in draws[:4]] == [(1, 32, 1), (1, 1, ACTS * 51), (1, 32, 1),
                                                   (1, 1, 51)]
    with torch.no_grad():
        taken, _, extra = p._action_step_body(torch.as_tensor(obs), None, True, draws=draws)
    p.action_generator.set_state(state)
    actions, _, out = p.compute_actions(obs)
    assert np.array_equal(actions, taken.numpy())
    assert out["action_dist_inputs"].tobytes() == extra["action_dist_inputs"].numpy().tobytes()
    # the noise reaches the Q values: greedy (no noise) and exploring differ
    _, _, greedy = p.compute_actions(obs, explore=False)
    assert not np.array_equal(greedy["action_dist_inputs"], out["action_dist_inputs"])
    assert p.supports_batched_serve


# -- frame pools in replay -----------------------------------------------------------


def _pixel_fragment(rng, n=24, k=4, hw=(6, 5), dones_at=(9, 17)):
    """Stacked pixel rows of episodes that end inside the fragment, with
    each episode's own terminal stack as the last NEXT_OBS."""
    obs, next_obs = [], []
    starts = [0, *[d + 1 for d in dones_at]]
    ends = [*[d + 1 for d in dones_at], n]
    for s, e in zip(starts, ends):
        frames = rng.integers(0, 255, (e - s + k,) + hw, dtype=np.uint8)
        stacks = np.stack([np.moveaxis(frames[i:i + k], 0, -1) for i in range(e - s + 1)])
        obs.append(stacks[:-1])
        next_obs.append(stacks[1:])
    dones = np.zeros(n, bool)
    dones[list(dones_at)] = True
    return {
        "obs": np.concatenate(obs), "new_obs": np.concatenate(next_obs), "dones": dones,
        "truncateds": np.zeros(n, bool), "actions": rng.integers(0, 3, n),
        "rewards": rng.standard_normal(n).astype(np.float32),
    }


class _Owner:
    """The one thing ``_materialize_compressed`` reads of its algorithm."""

    def __init__(self, k):
        self.space = type("S", (), {"shape": (6, 5, k)})()

    def get_policy(self, pid="default_policy"):
        return type("P", (), {"observation_space": self.space})()


def test_materialize_compressed_bitwise():
    cols = _pixel_fragment(np.random.default_rng(0))
    args = (cols["obs"], cols["new_obs"], cols["dones"] | cols["truncateds"])
    pool, idx = tfs.compress_replay_obs(*args)
    rpool, ridx = jfs.compress_replay_obs(*args)
    assert pool.tobytes() == np.asarray(rpool).tobytes() and idx.tobytes() == np.asarray(ridx).tobytes()
    rest = {k: v for k, v in cols.items() if k not in ("obs", "new_obs")}
    port = tdqn.DQN._materialize_compressed(
        _Owner(4), SampleBatch({**rest, tfs.FRAMES: pool, tfs.FRAME_IDX: idx}))
    ref = jdqn.DQN._materialize_compressed(
        _Owner(4), JSampleBatch({**rest, jfs.FRAMES: rpool, jfs.FRAME_IDX: ridx}))
    for k in ("obs", "new_obs"):
        assert port[k].tobytes() == np.asarray(ref[k]).tobytes() == cols[k].tobytes(), k
    assert tfs.FRAMES not in port and set(port) == set(ref)


# -- the actor lane ----------------------------------------------------------------


def test_cartpole_rainbow_yaml_trains_on_the_actor_lane():
    algo, stop = build_tuned_example(RAINBOW_YAML, device="cpu",
                                     num_steps_sampled_before_learning_starts=16)
    try:
        policy = algo.get_policy()
        assert policy.model.noisy and policy.model.num_atoms == 51 and stop["timesteps_total"]
        results = [algo.train() for _ in range(9)]  # 72 rows: a batch of 64
        learner = results[-1]["info"]["learner"]["default_policy"]
        assert np.isfinite(list(learner.values())).all()
        buf = algo.local_replay_buffer.buffers["default_policy"]
        assert "n_steps" in buf._store and "weights" not in buf._store
        assert results[-1]["num_env_steps_trained"] > 0
    finally:
        algo.stop()


def test_rainbow_on_the_device_lane():
    """C51 and noisy heads on the device lane too (n_step 1 there, as the
    reference's): the lane's act step draws the heads' noise from the
    policy's generator; the updates are the actor lane's."""
    cfg = (DQNConfig().environment("CartPoleJax-v0", env_backend="jax")
           .rollouts(num_envs_per_worker=4, rollout_fragment_length=4)
           .training(num_atoms=11, v_min=0.0, v_max=50.0, noisy=True, train_batch_size=16,
                     num_steps_sampled_before_learning_starts=16, target_network_update_freq=32,
                     model={"fcnet_hiddens": [16]},
                     replay_buffer_config={"capacity": 256, "prioritized_replay": True})
           .debugging(seed=0).resources(device="cpu"))
    algo = cfg.build()
    results = [algo.train() for _ in range(4)]
    learner = results[-1]["info"]["learner"]["default_policy"]
    assert np.isfinite(list(learner.values())).all() and algo._counters["num_target_updates"] >= 1
    with pytest.raises(ValueError, match="n_step=1 only"):
        DQNConfig().environment("CartPoleJax-v0", env_backend="jax").training(
            n_step=3).resources(device="cpu").build().train()

