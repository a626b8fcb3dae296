"""CartPole and GridRooms on tensors, and the lane at any observation
rank, against the reference.

The reference's envs draw their resets from a PRNG key carried in each
env's state; the port takes uniform draws as an input. These tests
replay the reference's key stream with ``jax.random`` and hand the port
the same draws: CartPole the [0, 1) uniforms behind
``jax.random.uniform(-0.05, 0.05)``, GridRooms ``(cell + 0.5) / room``
for the reference's ``jax.random.randint`` start cells.

- CartPole reset: bitwise. Step: the state within 1e-6 absolute and
  1e-5 relative over 60 steps (float32 ``sin``/``cos`` of XLA and of
  PyTorch may differ in the last ulp, and the Euler steps carry it);
  reward and truncation exact. ``terminated`` must agree on every row
  whose |x| and |θ| lie further than 1e-5 from their bounds; a row
  within 1e-5 of a bound may flip on that last ulp and is reported, not
  compared. No test re-seeds to avoid such a row.
- GridRooms reset and step: bitwise (integer logic).
- The rollout lane on CartPole with FCNet against ``JaxRolloutEngine``
  with the reference's actions and resets injected: observations within
  1e-5, actions, rewards, terminations, truncations, step counters and
  episode metrics exact, ``vf_preds`` and ``action_logp`` within 1e-5,
  standardised advantages and value targets within 1e-4 (as for
  PongLite).
- The lane's reset select at observation ranks 1 and 3: shapes and the
  terminal-observation contract on a row that finishes mid-fragment.
"""

from __future__ import annotations

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.algorithms.ppo.ppo import PPOJaxPolicy
from ray_tpu.env.jax_control import CartPoleJax, GridRoomsJax
from ray_tpu.env.jax_env import env_keys
from ray_tpu.execution.jax_rollout import JaxRolloutEngine
from ray_tpu.sharding import get_mesh
from ray_tpu_torch.algorithms.ppo.ppo import PPOTorchPolicy
from ray_tpu_torch.env.control_tensor import CartPoleTensor, GridRoomsTensor
from ray_tpu_torch.env.pong_lite_tensor import PongLiteTensor
from ray_tpu_torch.env.registry import get_env_creator
from ray_tpu_torch.env.tensor_env import tree_where
from ray_tpu_torch.execution.device_rollout import DeviceRolloutEngine, RolloutDraws
from ray_tpu_torch.utils.jax_params import from_jax_params

CPU = torch.device("cpu")
_split = jax.jit(jax.vmap(jax.random.split))
_uniform4 = jax.jit(jax.vmap(lambda k: jax.random.uniform(k, (4,))))


def _cartpole_draws(keys):
    """(keys advanced, (N, 4) uniforms): the split and the [0, 1)
    uniforms behind one CartPoleJax reset per env."""
    pair = _split(keys)
    return pair[:, 0], torch.as_tensor(np.array(_uniform4(pair[:, 1])))


def _grid_cells(keys, room):
    """(keys advanced, (N, 2) start cells, (N, 2) port draws) of one
    GridRoomsJax reset per env."""
    pair = _split(keys)
    cells = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (2,), 0, room))(pair[:, 1]))
    return pair[:, 0], cells, torch.as_tensor((cells + 0.5) / room, dtype=torch.float32)


def _vmapped(env):
    return tuple(jax.jit(jax.vmap(f)) for f in (env.init, env.reset, env.step))


def test_registry_knows_the_control_envs():
    assert isinstance(get_env_creator("CartPoleJax-v0")({}), CartPoleTensor)
    grid = get_env_creator("GridRoomsJax-v0")({"size": 7})
    assert isinstance(grid, GridRoomsTensor) and grid.size == 7
    assert grid.observation_space.shape == (2,) and grid.action_space.n == 4
    assert CartPoleTensor().observation_space.shape == (4,)
    with pytest.raises(ValueError, match="odd size"):
        GridRoomsTensor({"size": 8})


def test_cartpole_step_and_reset_match_reference():
    cfg = {"max_steps": 40}
    ref, port = CartPoleJax(cfg), CartPoleTensor(cfg)
    n = 16
    init_b, reset_b, step_b = _vmapped(ref)
    state, obs = reset_b(init_b(env_keys(7, n)))
    keys, u = _cartpole_draws(env_keys(7, n))
    pstate, pobs = port.reset(port.init(n, CPU), u)
    assert np.asarray(obs).tobytes() == pobs.numpy().tobytes()
    actions = np.random.default_rng(1).integers(0, 2, (60, n))
    ends, near = 0, 0
    for t in range(60):
        a = actions[t]
        state2, obs2, rew, term, trunc = step_b(state, jnp.asarray(a, jnp.int32))
        pstate2, pobs2, prew, pterm, ptrunc = port.step(pstate, torch.as_tensor(a), None)
        ref_s = np.asarray(state2["s"])
        np.testing.assert_allclose(pobs2.numpy(), np.asarray(obs2), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(pstate2["steps"].numpy(), np.asarray(state2["steps"]))
        np.testing.assert_array_equal(prew.numpy(), np.asarray(rew))
        np.testing.assert_array_equal(ptrunc.numpy(), np.asarray(trunc))
        margin = np.minimum(np.abs(np.abs(ref_s[:, 0]) - 2.4),
                            np.abs(np.abs(ref_s[:, 2]) - CartPoleTensor._THETA_LIMIT))
        clear = margin > 1e-5
        near += int((~clear).sum())
        np.testing.assert_array_equal(pterm.numpy()[clear], np.asarray(term)[clear])
        done = np.asarray(term | trunc)
        ends += int(done.sum())
        # auto-reset the rows that finished, as the lanes do
        reset_keys, u = _cartpole_draws(keys)
        state3, _ = reset_b(state2)
        pstate3, _ = port.reset(pstate2, u)
        keys = jnp.where(done[:, None], reset_keys, keys)
        state = jax.tree_util.tree_map(
            lambda x, y: jnp.where(done.reshape((-1,) + (1,) * (x.ndim - 1)), x, y),
            state3, state2,
        )
        pstate = tree_where(torch.as_tensor(done), pstate3, pstate2)
        # carry the reference's state so the comparison stays per step
        pstate = {"s": torch.as_tensor(np.asarray(state["s"])), "steps": pstate["steps"]}
    assert ends >= n  # every env ended an episode (terminated or truncated)
    assert near <= 2, f"{near} rows within 1e-5 of a bound"


def test_gridrooms_step_and_reset_match_reference():
    cfg = {"size": 9, "max_steps": 30}
    ref, port = GridRoomsJax(cfg), GridRoomsTensor(cfg)
    n, room = 32, 9 // 2
    init_b, reset_b, step_b = _vmapped(ref)
    state, obs = reset_b(init_b(env_keys(2, n)))
    keys, cells, u = _grid_cells(env_keys(2, n), room)
    pstate, pobs = port.reset(port.init(n, CPU), u)
    assert np.array_equal(pstate["pos"].numpy(), np.asarray(state["pos"]))
    assert np.array_equal(cells, np.asarray(state["pos"]))
    assert np.asarray(obs).tobytes() == pobs.numpy().tobytes()
    # a biased walk (down and right) so that some rows reach the goal
    actions = np.random.default_rng(3).choice(4, (120, n), p=[0.15, 0.35, 0.15, 0.35])
    goals = 0
    for t in range(120):
        a = actions[t]
        state2, obs2, rew, term, trunc = step_b(state, jnp.asarray(a, jnp.int32))
        pstate2, pobs2, prew, pterm, ptrunc = port.step(pstate, torch.as_tensor(a), None)
        assert np.asarray(obs2).tobytes() == pobs2.numpy().tobytes()
        for k in ("pos", "steps"):
            assert np.array_equal(pstate2[k].numpy(), np.asarray(state2[k])), k
        assert prew.numpy().tobytes() == np.asarray(rew).tobytes()
        np.testing.assert_array_equal(pterm.numpy(), np.asarray(term))
        np.testing.assert_array_equal(ptrunc.numpy(), np.asarray(trunc))
        goals += int(np.asarray(term).sum())
        done = np.asarray(term | trunc)
        reset_keys, cells, u = _grid_cells(keys, room)
        state3, _ = reset_b(state2)
        pstate3, _ = port.reset(pstate2, u)
        keys = jnp.where(done[:, None], reset_keys, keys)
        state = jax.tree_util.tree_map(
            lambda x, y: jnp.where(done.reshape((-1,) + (1,) * (x.ndim - 1)), x, y),
            state3, state2,
        )
        pstate = tree_where(torch.as_tensor(done), pstate3, pstate2)
        assert np.array_equal(pstate["pos"].numpy(), np.asarray(state["pos"]))
    assert goals >= 1


def _reference_cartpole_draws(seed, n, t, done_rows, keys=None):
    """The uniforms the reference lane consumed: the first reset's (only
    when ``keys`` is None) and each step's auto-reset's."""
    init = None
    if keys is None:
        keys, init = _cartpole_draws(env_keys(seed, n))
    resets = []
    for i in range(t):
        reset_keys, r = _cartpole_draws(keys)
        keys = jnp.where(done_rows[i][:, None], reset_keys, keys)
        resets.append(r)
    return keys, init, torch.stack(resets)


def test_cartpole_rollout_lane_matches_reference():
    n, t, seed = 8, 24, 4
    cfg = {
        "gamma": 0.99, "lambda": 0.95, "seed": 5,
        "train_batch_size": n * t, "sgd_minibatch_size": n * t,
        "model": {"fcnet_hiddens": [32, 32]},
    }
    env_cfg = {"max_steps": 15}
    ref_pol = PPOJaxPolicy(
        gym.spaces.Box(-np.inf, np.inf, (4,), np.float32), gym.spaces.Discrete(2),
        {**cfg, "_mesh": get_mesh(devices=jax.devices()[:1])},
    )
    ref_eng = JaxRolloutEngine(ref_pol, CartPoleJax(env_cfg), n, t, seed=seed)
    port_pol = PPOTorchPolicy(ref_pol.observation_space, ref_pol.action_space, cfg, device="cpu")
    from_jax_params(jax.device_get(ref_pol.params), port_pol.model)

    keys, port_eng = None, None
    for _ in range(2):
        batch, bsize = ref_eng.rollout()
        ref = {k: np.asarray(v) for k, v in batch.items()}

        def tn(col):  # env-major rows → (T, N)
            return ref[col].reshape(n, t).T

        done = tn("dones") | tn("truncateds")
        keys, init, resets = _reference_cartpole_draws(seed, n, t, done, keys)
        if port_eng is None:
            port_eng = DeviceRolloutEngine(
                port_pol, CartPoleTensor(env_cfg), n, t, initial_draws=init
            )
        got, psize = port_eng.rollout(
            RolloutDraws(torch.as_tensor(tn("actions").copy()), torch.zeros_like(resets), resets)
        )
        got = {k: v.numpy() for k, v in got.items()}
        assert psize == bsize == n * t
        assert set(got) == set(ref)
        assert got["obs"].shape == (n * t, 4)
        for col in ("actions", "rewards", "dones", "truncateds", "t", "agent_index"):
            assert got[col].tobytes() == ref[col].astype(got[col].dtype).tobytes(), col
        for col in ("obs", "new_obs", "vf_preds", "action_logp", "action_dist_inputs"):
            np.testing.assert_allclose(got[col], ref[col], rtol=1e-5, atol=1e-5, err_msg=col)
        for col in ("advantages", "value_targets"):
            np.testing.assert_allclose(got[col], ref[col], rtol=1e-4, atol=1e-4, err_msg=col)
        assert done.any()
        ref_eps = [(m.episode_length, m.episode_reward) for m in ref_eng.get_metrics()]
        port_eps = [(m.episode_length, m.episode_reward) for m in port_eng.get_metrics()]
        assert port_eps == ref_eps and ref_eps


@pytest.mark.parametrize("env_name", ["cartpole", "pong"])
def test_lane_reset_select_at_any_obs_rank(env_name):
    """A (N, 4) and a (N, 84, 84, 1) env through the lane: the obs shapes
    and, on a row that finishes mid-fragment, NEXT_OBS is the final
    observation and the successor's OBS the reset observation."""
    if env_name == "cartpole":
        env, shape, max_steps = CartPoleTensor({"max_steps": 3}), (4,), 3
        model = {"fcnet_hiddens": [8]}
    else:
        env, shape, max_steps = PongLiteTensor({"max_steps": 3, "rallies": 21}), (84, 84, 1), 3
        model = {"conv_filters": [[4, [8, 8], [4, 4]], [4, [4, 4], [2, 2]]],
                 "post_fcnet_hiddens": [8], "dtype": "float32"}
    n, t = 4, 7
    policy = PPOTorchPolicy(env.observation_space, env.action_space,
                            {"seed": 0, "model": model}, device="cpu")
    eng = DeviceRolloutEngine(policy, env, n, t, seed=1)
    batch, _ = eng.rollout()
    obs = batch["obs"].reshape((n, t) + shape)
    new_obs = batch["new_obs"].reshape((n, t) + shape)
    assert eng.carry["obs"].shape == (n,) + shape
    ts = batch["t"].reshape(n, t)
    assert torch.equal(ts[0], torch.tensor([0, 1, 2, 0, 1, 2, 0], dtype=ts.dtype))
    done = (batch["dones"] | batch["truncateds"]).reshape(n, t)
    assert bool(done[:, max_steps - 1].all())
    for i in range(n):
        step = max_steps - 1  # the row's episode ends here, mid-fragment
        # the successor's OBS is a reset observation, not the final one
        assert not torch.equal(new_obs[i, step], obs[i, step + 1])
        # inside an episode NEXT_OBS[t] == OBS[t + 1]
        assert torch.equal(new_obs[i, 0], obs[i, 1])
    if env_name == "cartpole":
        assert bool((obs[:, max_steps].abs() <= 0.05).all())
