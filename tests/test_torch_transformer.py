"""The port's decoder-transformer torso against the JAX package's, on the CPU.

The small torso of ``tests/test_model_parallel.py`` (d_model 32, 2
layers, 2 heads, 4 tokens, ff 64). The reference runs on a one-device
mesh, where its Megatron collectives are not emitted; the port starts
from the reference's initial parameters (a plain dict tree, carried
leaf for leaf) and is handed the reference's permutations, actions and
serves. Inputs come from numpy seeds.

Tolerances: the forward within 1e-5 relative (plus 1e-6 absolute);
after one ``learn_on_batch`` parameters within 1e-5 relative plus 1.5e-5
absolute and stats within 1e-4 relative, as for PR 1's PPO learner
(float32 Adam steps summed in other orders by the two frameworks). The
key biases ``layer_i.attn.bk`` are the exception: the softmax over keys
does not change when every score of a row moves by the same q·bk, so
their exact gradient is 0 and both frameworks step them by float32
noise that Adam scales up to about lr per step, differently in each.
They are checked through the outputs they feed (logits and values of
the updated models, within the parameter tolerance) instead; Adam
moments within 1e-5 relative plus 1e-6 (first) and 1e-9 (second)
absolute; on the rollout lane data columns bitwise, ``vf_preds``,
``action_logp`` and logits within 1e-5 and standardised advantages and
value targets within 1e-4.
"""

from __future__ import annotations

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.algorithms.dqn.dqn import DQNJaxPolicy
from ray_tpu.algorithms.ppo.ppo import PPOJaxPolicy
from ray_tpu.data.sample_batch import SampleBatch as JSampleBatch
from ray_tpu.env.jax_env import env_keys
from ray_tpu.env.jax_pong import PongLiteJax
from ray_tpu.execution.jax_rollout import JaxRolloutEngine
from ray_tpu.models.transformer import TransformerPolicyNet as JTransformer
from ray_tpu.sharding import get_mesh
from ray_tpu_torch.algorithms.dqn.dqn import DQNTorchPolicy
from ray_tpu_torch.algorithms.ppo.ppo import PPOTorchPolicy
from ray_tpu_torch.env.pong_lite_tensor import PongLiteTensor
from ray_tpu_torch.env.spaces import Box, Discrete
from ray_tpu_torch.execution.device_rollout import DeviceRolloutEngine, RolloutDraws
from ray_tpu_torch.models.catalog import ModelCatalog
from ray_tpu_torch.models.transformer import TransformerPolicyNet
from ray_tpu_torch.ops.flash_attention import flash_attention
from ray_tpu_torch.utils.jax_params import from_jax_adam_state, from_jax_params, to_state_dict

MODEL = {
    "use_transformer": True,
    "transformer_dim": 32,
    "transformer_num_layers": 2,
    "transformer_num_heads": 2,
    "transformer_seq_len": 4,
    "transformer_ff_dim": 64,
}
GEOMETRY = dict(d_model=32, num_layers=2, num_heads=2, ff_dim=64, seq_len=4)


def _one_shard():
    return get_mesh(devices=jax.devices()[:1])


# -- the module ------------------------------------------------------------------


@pytest.mark.parametrize("obs_shape,dtype", [((8,), np.float32), ((84, 84, 1), np.uint8)])
def test_forward_matches_reference(obs_shape, dtype):
    rng = np.random.default_rng(0)
    if dtype == np.uint8:
        obs = rng.integers(0, 256, (5,) + obs_shape, dtype=np.uint8)
    else:
        obs = rng.standard_normal((5,) + obs_shape).astype(dtype)
    jm = JTransformer(num_outputs=4, **GEOMETRY)
    params = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.asarray(obs)))
    tm = TransformerPolicyNet(int(np.prod(obs_shape)), 4, **GEOMETRY)
    assert set(to_state_dict(params)) == {n for n, _ in tm.named_parameters()}
    from_jax_params(params, tm)
    ref_logits, ref_value, _ = jm.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        logits, value, state = tm(torch.as_tensor(obs))
    assert state == () and logits.shape == (5, 4) and value.shape == (5,)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(value.numpy(), np.asarray(ref_value), rtol=1e-5, atol=1e-6)
    assert tm.num_params() == jm.num_params()


def test_catalog_builds_the_torso_and_refuses_partition_rules():
    box, act = Box(-1, 1, (8,), np.float32), Discrete(4)
    m = ModelCatalog.get_model(box, act, 4, MODEL, generator=torch.Generator().manual_seed(0))
    assert isinstance(m, TransformerPolicyNet)
    assert (m.d_model, m.num_layers, m.num_heads, m.head_dim, m.ff_dim, m.seq_len, m.tok) == (
        32, 2, 2, 16, 64, 4, 2)
    img = ModelCatalog.get_model(Box(0, 255, (84, 84, 1), np.uint8), act, 4, MODEL)
    assert isinstance(img, TransformerPolicyNet) and img.tok == 7056 // 4
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 7"):
        ModelCatalog.get_model(box, act, 4, {**MODEL, "partition_rules": [("wq", None)]})
    for bad in ({"num_atoms": 51}, {"noisy": True}):
        with pytest.raises(ValueError, match="DQNModel"):
            DQNTorchPolicy(box, act, {"model": MODEL, **bad}, device="cpu")


# -- PPO: one learn call, then the Adam state carried across ----------------------

B, MB, ITERS, OBS, A = 64, 32, 2, 8, 4
PPO_CONFIG = {
    "train_batch_size": B, "sgd_minibatch_size": MB, "num_sgd_iter": ITERS, "lr": 1e-3,
    "entropy_coeff": 0.01, "grad_clip": 40.0, "seed": 0, "model": MODEL,
}


def _ppo_batch(seed):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.standard_normal((B, OBS)).astype(np.float32),
        "actions": rng.integers(0, A, B).astype(np.int64),
        "action_logp": np.full(B, -1.3, np.float32),
        "action_dist_inputs": rng.standard_normal((B, A)).astype(np.float32),
        "advantages": rng.standard_normal(B).astype(np.float32),
        "value_targets": rng.standard_normal(B).astype(np.float32),
    }


def _reference_perms(key, n, iters):
    """The permutations ``JaxPolicy``'s nest draws on shard 0 from the
    policy key (split once per learn call, folded with the shard index,
    split per epoch, permuted with the first half of each epoch key)."""
    _, rng = jax.random.split(key)
    rng = jax.random.fold_in(rng, 0)
    return torch.as_tensor(np.stack([
        np.asarray(jax.random.permutation(jax.random.split(r)[0], n))
        for r in jax.random.split(rng, iters)
    ]))


def _is_key_bias(name):
    return name.endswith(".attn.bk")


def _assert_learn_matches(port, ref, stats, ref_stats, obs):
    assert set(stats) == set(ref_stats)
    for k, v in ref_stats.items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-4, atol=1e-7, err_msg=k)
    ref_params = to_state_dict(jax.device_get(ref.params))
    got = port.get_weights()
    assert set(got) == set(ref_params)
    for name, r in ref_params.items():
        if not _is_key_bias(name):
            np.testing.assert_allclose(got[name], r, rtol=1e-5, atol=1.5e-5, err_msg=name)
    # the key biases are compared through what they feed: the outputs
    ref_logits, ref_value, _ = ref.model.apply(ref.params, jnp.asarray(obs))
    with torch.no_grad():
        logits, value, _ = port.model(torch.as_tensor(obs))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=1e-5, atol=1.5e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(ref_value), rtol=1e-5, atol=1.5e-5)
    count, mu, nu = from_jax_adam_state(jax.device_get(ref.opt_state))
    state = port.get_state()["opt_state"]
    assert state["count"] == count
    for name in ref_params:
        np.testing.assert_allclose(state["mu"][name], mu[name], rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(state["nu"][name], nu[name], rtol=1e-5, atol=1e-9, err_msg=name)


def test_ppo_learn_and_adam_carry_match_reference():
    box, act = gym.spaces.Box(-1, 1, (OBS,), np.float32), gym.spaces.Discrete(A)
    ref = PPOJaxPolicy(box, act, {**PPO_CONFIG, "_mesh": _one_shard()})
    port = PPOTorchPolicy(Box(-1, 1, (OBS,), np.float32), Discrete(A), PPO_CONFIG, device="cpu")
    from_jax_params(jax.device_get(ref.params), port.model)
    perms = _reference_perms(ref._rng, B, ITERS)
    before = flash_attention.launches
    ref_stats = ref.learn_on_batch(_ppo_batch(0))
    stats = port.learn_on_batch(_ppo_batch(0), perms=perms)
    assert flash_attention.launches == before  # the CPU runs the plain version
    _assert_learn_matches(port, ref, stats, ref_stats, _ppo_batch(0)["obs"])
    assert port.get_state()["opt_state"]["count"] == ITERS * (B // MB)

    # a fresh port policy takes the reference's params and Adam state
    # (count, mu, nu) after the first call; the second call matches again
    fresh = PPOTorchPolicy(Box(-1, 1, (OBS,), np.float32), Discrete(A),
                           {**PPO_CONFIG, "seed": 7}, device="cpu")
    count, mu, nu = from_jax_adam_state(jax.device_get(ref.opt_state))
    fresh.set_state({
        "weights": to_state_dict(jax.device_get(ref.params)),
        "opt_state": {"count": count, "mu": mu, "nu": nu},
        "coeff_values": dict(port.coeff_values),
    })
    perms = _reference_perms(ref._rng, B, ITERS)
    ref_stats = ref.learn_on_batch(_ppo_batch(1))
    stats = fresh.learn_on_batch(_ppo_batch(1), perms=perms)
    _assert_learn_matches(fresh, ref, stats, ref_stats, _ppo_batch(1)["obs"])
    assert fresh.get_state()["opt_state"]["count"] == 2 * ITERS * (B // MB)


# -- DQN: the torso's logits as Q values --------------------------------------------

DQN_B = 16


def test_dqn_learn_matches_reference():
    cfg = {"train_batch_size": DQN_B, "lr": 5e-4, "grad_clip": 40.0, "gamma": 0.99,
           "model": MODEL, "seed": 3}
    box = gym.spaces.Box(-1, 1, (OBS,), np.float32)
    ref = DQNJaxPolicy(box, gym.spaces.Discrete(A), {**cfg, "_mesh": _one_shard()})
    other = DQNJaxPolicy(box, gym.spaces.Discrete(A), {**cfg, "seed": 8, "_mesh": _one_shard()})
    ref.aux_state = {"target_params": other.params}  # a target unlike the online net
    port = DQNTorchPolicy(Box(-1, 1, (OBS,), np.float32), Discrete(A), cfg, device="cpu")
    assert isinstance(port.model, TransformerPolicyNet)
    from_jax_params(jax.device_get(ref.params), port.model)
    target = to_state_dict(jax.device_get(other.params))
    port.aux_state = {"target_params": [torch.as_tensor(target[n]).clone() for n in port.param_names]}
    rng = np.random.default_rng(0)
    batch = {
        "obs": rng.standard_normal((DQN_B, OBS)).astype(np.float32),
        "new_obs": rng.standard_normal((DQN_B, OBS)).astype(np.float32),
        "actions": rng.integers(0, A, DQN_B).astype(np.int32),
        "rewards": rng.standard_normal(DQN_B).astype(np.float32),
        "dones": rng.random(DQN_B) < 0.25,
        "weights": (rng.random(DQN_B) + 0.5).astype(np.float32),
    }
    np.testing.assert_allclose(port.compute_td_error(batch),
                               ref.compute_td_error(JSampleBatch(dict(batch))), rtol=1e-5, atol=1e-5)
    perm = _reference_perms(ref._rng, DQN_B, 1)
    ref_stats = ref.learn_on_batch(JSampleBatch(dict(batch)))
    stats = port.learn_on_batch(batch, perms=perm)
    _assert_learn_matches(port, ref, stats, ref_stats, batch["obs"])
    np.testing.assert_allclose(port.compute_td_error(batch),
                               ref.compute_td_error(JSampleBatch(dict(batch))), rtol=1e-5, atol=1e-5)


# -- the device rollout lane with the torso ----------------------------------------

_split = jax.jit(jax.vmap(jax.random.split))
_serve = jax.jit(jax.vmap(PongLiteJax._serve))


def _draw(keys):
    """(keys advanced, (N, 3) serves), as PongLiteJax consumes its key."""
    pair = _split(keys)
    by, vx, vy = _serve(pair[:, 1])
    return pair[:, 0], torch.as_tensor(np.stack([by, vx, vy], axis=1))


def _reference_draws(seed, n, t, done_rows, keys=None):
    """The serves the reference lane consumed (the first reset's only
    when ``keys`` is None; per step, the step's and the auto-reset's)."""
    init = None
    if keys is None:
        keys, init = _draw(env_keys(seed, n))
    steps, resets = [], []
    for i in range(t):
        keys, s = _draw(keys)
        reset_keys, r = _draw(keys)
        keys = jnp.where(done_rows[i][:, None], reset_keys, keys)
        steps.append(s)
        resets.append(r)
    return keys, init, torch.stack(steps), torch.stack(resets)


def test_rollout_lane_matches_reference():
    n, t, seed = 4, 8, 2
    cfg = {"gamma": 0.99, "lambda": 0.95, "seed": 5, "train_batch_size": n * t,
           "sgd_minibatch_size": n * t, "model": MODEL}
    env_cfg = {"max_steps": 5, "rallies": 2}
    ref_pol = PPOJaxPolicy(gym.spaces.Box(0, 255, (84, 84, 1), np.uint8), gym.spaces.Discrete(3),
                           {**cfg, "_mesh": _one_shard()})
    ref_eng = JaxRolloutEngine(ref_pol, PongLiteJax(env_cfg), n, t, seed=seed)
    port_pol = PPOTorchPolicy(Box(0, 255, (84, 84, 1), np.uint8), Discrete(3), cfg, device="cpu")
    from_jax_params(jax.device_get(ref_pol.params), port_pol.model)
    keys, port_eng = None, None
    for _ in range(2):  # two rollouts: the carry crosses a fragment edge
        batch, bsize = ref_eng.rollout()
        ref = {k: np.asarray(v) for k, v in batch.items()}

        def tn(col):  # env-major rows → (T, N)
            return ref[col].reshape(n, t).T

        done = tn("dones") | tn("truncateds")
        keys, init, step_serves, reset_serves = _reference_draws(seed, n, t, done, keys)
        if port_eng is None:
            port_eng = DeviceRolloutEngine(port_pol, PongLiteTensor(env_cfg), n, t, initial_draws=init)
        got, psize = port_eng.rollout(
            RolloutDraws(torch.as_tensor(tn("actions")), step_serves, reset_serves))
        got = {k: v.numpy() for k, v in got.items()}
        assert psize == bsize == n * t and set(got) == set(ref)
        for col in ("obs", "new_obs", "actions", "rewards", "dones", "truncateds", "t", "agent_index"):
            assert got[col].tobytes() == ref[col].astype(got[col].dtype).tobytes(), col
        for col in ("vf_preds", "action_logp", "action_dist_inputs"):
            np.testing.assert_allclose(got[col], ref[col], rtol=1e-5, atol=1e-5, err_msg=col)
        for col in ("advantages", "value_targets"):
            np.testing.assert_allclose(got[col], ref[col], rtol=1e-4, atol=1e-4, err_msg=col)
        assert done.any()
        ref_eps = [(m.episode_length, m.episode_reward) for m in ref_eng.get_metrics()]
        port_eps = [(m.episode_length, m.episode_reward) for m in port_eng.get_metrics()]
        assert port_eps == ref_eps and ref_eps
