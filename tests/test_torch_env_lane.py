"""PongLite on tensors and the device rollout lane against the reference.

The reference draws its serves from a PRNG key carried in each env's
state; the port takes them as an input. These tests replay the
reference's key stream with ``jax.random`` to get its serves, and hand
them (and, for the lane, the reference's sampled actions) to the port.

- env step and reset: frames bitwise, state and rewards exact;
- rollout lane (two rollouts, so the carry crosses a fragment edge):
  observations, actions, rewards, terminations, truncations, episode
  step counters and episode metrics exact; ``vf_preds`` and
  ``action_logp`` within 1e-5 (float32 model, CPU convolutions summed
  in other orders); standardised advantages and value targets within
  1e-4 (standardisation divides by a std of order 0.1-1).
"""

from __future__ import annotations

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import torch

from ray_tpu.algorithms.ppo.ppo import PPOJaxPolicy
from ray_tpu.env.jax_env import env_keys
from ray_tpu.env.jax_pong import PongLiteJax
from ray_tpu.execution.jax_rollout import JaxRolloutEngine
from ray_tpu.sharding import get_mesh
from ray_tpu_torch.algorithms.ppo.ppo import PPOTorchPolicy
from ray_tpu_torch.env.pong_lite_tensor import PongLiteTensor
from ray_tpu_torch.env.tensor_env import tree_where
from ray_tpu_torch.execution.device_rollout import DeviceRolloutEngine, RolloutDraws
from ray_tpu_torch.utils.jax_params import from_jax_params

_split = jax.jit(jax.vmap(jax.random.split))
_serve = jax.jit(jax.vmap(PongLiteJax._serve))


def _draw(keys):
    """(keys advanced, (N, 3) serves) — one ``split`` + ``_serve`` per
    env, as PongLiteJax's reset and step consume their carried key."""
    pair = _split(keys)
    by, vx, vy = _serve(pair[:, 1])
    return pair[:, 0], torch.as_tensor(np.stack([by, vx, vy], axis=1))


def _port_state(ref_state):
    return {k: torch.as_tensor(np.array(v)) for k, v in ref_state.items() if k != "key"}


def _assert_state_equal(port_state, ref_state):
    for k, v in _port_state(ref_state).items():
        assert torch.equal(port_state[k], v), k


def test_pong_step_and_reset_match_reference():
    cfg = {"rallies": 3, "max_steps": 25, "paddle_speed": 3.0}
    ref, port = PongLiteJax(cfg), PongLiteTensor(cfg)
    n = 8
    init_b, reset_b, step_b = (jax.jit(jax.vmap(f)) for f in (ref.init, ref.reset, ref.step))
    state, obs = reset_b(init_b(env_keys(4, n)))
    keys = init_b(env_keys(4, n))["key"]
    keys, serves = _draw(keys)
    pstate, pobs = port.reset(port.init(n, torch.device("cpu")), serves)
    assert np.asarray(obs).tobytes() == pobs.numpy().tobytes()
    _assert_state_equal(pstate, state)
    actions = np.random.default_rng(0).integers(0, 3, (60, n))
    ends = 0
    for t in range(60):
        a = actions[t]
        keys, step_serves = _draw(keys)
        state2, obs2, rew, term, trunc = step_b(state, jnp.asarray(a, jnp.int32))
        pstate2, pobs2, prew, pterm, ptrunc = port.step(pstate, torch.as_tensor(a), step_serves)
        assert np.asarray(obs2).tobytes() == pobs2.numpy().tobytes()
        _assert_state_equal(pstate2, state2)
        np.testing.assert_array_equal(prew.numpy(), np.asarray(rew))
        np.testing.assert_array_equal(pterm.numpy(), np.asarray(term))
        np.testing.assert_array_equal(ptrunc.numpy(), np.asarray(trunc))
        # auto-reset rows that finished, as the lanes do
        done = np.asarray(term | trunc)
        ends += int(done.sum())
        reset_keys, reset_serves = _draw(keys)
        state3, obs3 = reset_b(state2)
        pstate3, pobs3 = port.reset(pstate2, reset_serves)
        keys = jnp.where(done[:, None], reset_keys, keys)
        state = jax.tree_util.tree_map(
            lambda x, y: jnp.where(done.reshape((-1,) + (1,) * (x.ndim - 1)), x, y),
            state3, state2,
        )
        pstate = tree_where(torch.as_tensor(done), pstate3, pstate2)
        _assert_state_equal(pstate, state)
    assert ends >= n  # every env finished at least one episode


def _reference_draws(seed, n, t, done_rows, keys=None):
    """Serves the reference lane consumed: the first reset's (only when
    ``keys`` is None) and, per step, the step's and the auto-reset's."""
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
    cfg = {
        "gamma": 0.99, "lambda": 0.95, "seed": 5,
        "train_batch_size": n * t, "sgd_minibatch_size": n * t,
        "model": {"dtype": "float32", "post_fcnet_hiddens": [32],
                  "conv_filters": [[8, [8, 8], [4, 4]], [8, [4, 4], [2, 2]]]},
    }
    env_cfg = {"max_steps": 5, "rallies": 2}
    ref_pol = PPOJaxPolicy(
        gym.spaces.Box(0, 255, (84, 84, 1), np.uint8), gym.spaces.Discrete(3),
        {**cfg, "_mesh": get_mesh(devices=jax.devices()[:1])},
    )
    ref_eng = JaxRolloutEngine(ref_pol, PongLiteJax(env_cfg), n, t, seed=seed)
    port_pol = PPOTorchPolicy(ref_pol.observation_space, ref_pol.action_space, cfg, device="cpu")
    from_jax_params(jax.device_get(ref_pol.params), port_pol.model)

    keys = None
    port_eng = None
    for _ in range(2):
        batch, bsize = ref_eng.rollout()
        ref = {k: np.asarray(v) for k, v in batch.items()}

        def tn(col):  # env-major rows → (T, N)
            return ref[col].reshape(n, t).T

        done = tn("dones") | tn("truncateds")
        keys, init, step_serves, reset_serves = _reference_draws(seed, n, t, done, keys)
        if port_eng is None:
            port_eng = DeviceRolloutEngine(
                port_pol, PongLiteTensor(env_cfg), n, t, initial_draws=init
            )
        got, psize = port_eng.rollout(
            RolloutDraws(torch.as_tensor(tn("actions")), step_serves, reset_serves)
        )
        got = {k: v.numpy() for k, v in got.items()}
        assert psize == bsize == n * t
        assert set(got) == set(ref)
        for col in ("obs", "new_obs", "actions", "rewards", "dones", "truncateds", "t",
                    "agent_index"):
            assert got[col].tobytes() == ref[col].astype(got[col].dtype).tobytes(), col
        for col in ("vf_preds", "action_logp", "action_dist_inputs"):
            np.testing.assert_allclose(got[col], ref[col], rtol=1e-5, atol=1e-5, err_msg=col)
        for col in ("advantages", "value_targets"):
            np.testing.assert_allclose(got[col], ref[col], rtol=1e-4, atol=1e-4, err_msg=col)
        assert done.any()
        ref_eps = [(m.episode_length, m.episode_reward) for m in ref_eng.get_metrics()]
        port_eps = [(m.episode_length, m.episode_reward) for m in port_eng.get_metrics()]
        assert port_eps == ref_eps and ref_eps
