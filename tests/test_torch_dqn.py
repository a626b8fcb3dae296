"""The port's DQN slice against the JAX package's, on the CPU.

- ``DQNModel`` against the flax ``DQNModel`` through
  ``from_jax_params``: float32 convolutions within 1e-5 relative (plus
  1e-6 absolute), bfloat16 within 2e-2 absolute (the two frameworks
  round to bf16 after other operations);
- one learn call of ``DQNTorchPolicy`` against ``DQNJaxPolicy`` from the
  same parameters, target network and batch, with the reference's
  permutation injected: parameters within 1.5e-5 absolute plus 1e-5
  relative after the Adam step, per-row TD errors and stats within 1e-5
  (float32 forwards summed in other orders), double-Q on and off;
  ``update_target`` copies the parameters;
- the ``postprocess="none"`` rollout lane against
  ``JaxRolloutEngine(postprocess="none")`` with the reference's actions
  and serves injected: data columns bitwise, Q values and
  log-probabilities within the bf16 model tolerance (2e-2);
- ``DQN.train()`` on ``PongLiteJax-v0`` through learning starts and
  target updates: the sampled, trained and target-update counters equal
  the reference's run of the same config, and the first prioritized
  draw (all priorities still at the max) picks the same rows; the
  port's fixed-seed runs repeat bitwise.
"""

from __future__ import annotations

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.algorithms.dqn.dqn import (
    DQNConfig as JDQNConfig,
    DQNJaxPolicy,
    _epsilon_exploration_config as j_epsilon_config,
)
from ray_tpu.algorithms.dqn.dqn_model import DQNModel as JDQNModel
from ray_tpu.data.sample_batch import SampleBatch as JSampleBatch
from ray_tpu.env.jax_env import env_keys
from ray_tpu.env.jax_pong import PongLiteJax
from ray_tpu.execution.jax_rollout import JaxRolloutEngine
from ray_tpu.sharding import get_mesh
from ray_tpu.utils.exploration.exploration import EpsilonGreedy as JEpsilonGreedy
from ray_tpu_torch.algorithms.dqn.dqn import (
    DQNConfig,
    DQNTorchPolicy,
    _epsilon_exploration_config,
)
from ray_tpu_torch.algorithms.dqn.dqn_model import DQNModel
from ray_tpu_torch.env.pong_lite_tensor import PongLiteTensor
from ray_tpu_torch.env.spaces import Box, Discrete
from ray_tpu_torch.execution.device_rollout import DeviceRolloutEngine, RolloutDraws
from ray_tpu_torch.models.distributions import Categorical
from ray_tpu_torch.utils.exploration import EpsilonGreedy
from ray_tpu_torch.utils.jax_params import flax_to_state_dict, from_jax_params

FILTERS = ((4, (4, 4), (2, 2)), (8, (3, 3), (2, 2)))
PONG_FILTERS = [[4, [8, 8], [4, 4]], [8, [4, 4], [2, 2]]]


def _one_shard():
    return get_mesh(devices=jax.devices()[:1])


# -- model ---------------------------------------------------------------------


@pytest.mark.parametrize("dueling", [True, False])
@pytest.mark.parametrize("conv_dtype,rtol,atol", [("float32", 1e-5, 1e-6), ("bfloat16", 0.0, 2e-2)])
def test_dqn_model_matches_flax(dueling, conv_dtype, rtol, atol):
    obs = np.random.default_rng(0).integers(0, 256, (5, 16, 16, 1), dtype=np.uint8)
    jm = JDQNModel(num_outputs=3, hiddens=(32,), activation="relu", use_conv=True,
                   conv_filters=FILTERS, conv_dtype=conv_dtype, dueling=dueling)
    params = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.asarray(obs)))
    tm = DQNModel((16, 16, 1), 3, hiddens=(32,), activation="relu", use_conv=True,
                  conv_filters=FILTERS, conv_dtype=conv_dtype, dueling=dueling)
    from_jax_params(params, tm)
    ref_q, ref_v, _ = jm.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        q, v, state = tm(torch.as_tensor(obs))
    assert state == () and q.dtype == torch.float32 and q.shape == (5, 3)
    np.testing.assert_allclose(q.numpy(), np.asarray(ref_q), rtol=rtol, atol=atol)
    np.testing.assert_allclose(v.numpy(), np.asarray(ref_v), rtol=rtol, atol=atol)


def test_dqn_model_mlp_names_and_unported_heads():
    obs = np.random.default_rng(1).standard_normal((4, 6)).astype(np.float32)
    jm = JDQNModel(num_outputs=2, hiddens=(16, 8), activation="tanh")
    params = jax.device_get(jm.init(jax.random.PRNGKey(2), jnp.asarray(obs)))
    assert set(flax_to_state_dict(params)) == {
        "fc_0.weight", "fc_0.bias", "fc_1.weight", "fc_1.bias",
        "adv_head.weight", "adv_head.bias", "value_head.weight", "value_head.bias",
    }
    tm = from_jax_params(params, DQNModel((6,), 2, hiddens=(16, 8), activation="tanh"))
    with torch.no_grad():
        q = tm(torch.as_tensor(obs))[0]
    np.testing.assert_allclose(q.numpy(), np.asarray(jm.apply(params, jnp.asarray(obs))[0]),
                               rtol=1e-5, atol=1e-6)
    # the Rainbow heads build (held against the reference in
    # tests/test_torch_rainbow.py): C51's (B, A, atoms) logits and the
    # noisy heads' flax names
    c51 = DQNModel((6,), 2, num_atoms=51)
    assert c51.adv_head.weight.shape == (102, 256) and c51.value_head.weight.shape == (51, 256)
    jn = JDQNModel(num_outputs=2, hiddens=(16, 8), noisy=True)
    noisy_params = jax.device_get(jn.init(jax.random.PRNGKey(2), jnp.asarray(obs)))
    noisy = from_jax_params(noisy_params, DQNModel((6,), 2, hiddens=(16, 8), noisy=True))
    assert {n for n, _ in noisy.named_parameters() if "head" in n} == {
        f"{h}.{p}" for h in ("adv_head", "value_head")
        for p in ("w_mu", "w_sigma", "b_mu", "b_sigma")}


# -- exploration -----------------------------------------------------------------


def test_epsilon_greedy_schedule_and_sampling():
    cfgs = [
        {"initial_epsilon": 1.0, "final_epsilon": 0.02, "epsilon_timesteps": 10000},
        {"exploration_config": {"final_epsilon": 0.1}, "final_epsilon": 0.3,
         "epsilon_timesteps": 50},
        {"exploration_config": {"initial_epsilon": 0.5}},
    ]
    for cfg in cfgs:
        assert _epsilon_exploration_config(cfg) == j_epsilon_config(cfg)
        ec = _epsilon_exploration_config(cfg)
        port, ref = EpsilonGreedy(Discrete(3), ec), JEpsilonGreedy(gym.spaces.Discrete(3), ec)
        assert port.init_coeffs() == ref.init_coeffs()
        for t in (0, 25, 5000, 10000, 20000):
            a, b = {}, {}
            port.update_coeffs(a, t)
            ref.update_coeffs(b, t)
            assert a == b
    q = torch.tensor([[0.0, 2.0, -1.0]] * 3000)
    dist = Categorical(q)
    eg = EpsilonGreedy(Discrete(3), {})
    greedy, _, _ = eg.sample_fn(dist, torch.Generator().manual_seed(0), True, {"epsilon": 0.0}, ())
    assert torch.equal(greedy, torch.ones(3000, dtype=torch.int64))
    a1, logp, _ = eg.sample_fn(dist, torch.Generator().manual_seed(5), True, {"epsilon": 1.0}, ())
    a2, _, _ = eg.sample_fn(dist, torch.Generator().manual_seed(5), True, {"epsilon": 1.0}, ())
    assert torch.equal(a1, a2) and torch.allclose(logp, dist.logp(a1))
    freq = torch.bincount(a1, minlength=3).float() / 3000
    assert torch.allclose(freq, torch.full((3,), 1 / 3), atol=0.04)
    det, _, _ = eg.sample_fn(dist, None, False, {"epsilon": 1.0}, ())
    assert torch.equal(det, greedy)


# -- one learn call --------------------------------------------------------------

B, OBS = 16, 6
LEARN_CONFIG = {
    "train_batch_size": B, "lr": 5e-4, "grad_clip": 40.0, "gamma": 0.99,
    "model": {"fcnet_hiddens": [32, 32], "fcnet_activation": "tanh"}, "seed": 3,
}


def _learn_batch(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.standard_normal((B, OBS)).astype(np.float32),
        "new_obs": rng.standard_normal((B, OBS)).astype(np.float32),
        "actions": rng.integers(0, 3, B).astype(np.int32),
        "rewards": rng.standard_normal(B).astype(np.float32),
        "dones": rng.random(B) < 0.25,
        "weights": (rng.random(B) + 0.5).astype(np.float32),
    }


def _reference_perm(key):
    """The one-epoch permutation ``JaxPolicy``'s nest draws on shard 0
    from the policy key ``key``."""
    _, rng = jax.random.split(key)
    rng = jax.random.fold_in(rng, 0)
    (r,) = jax.random.split(rng, 1)
    return np.asarray(jax.random.permutation(jax.random.split(r)[0], B))[None]


def _port_params(policy, tree):
    sd = flax_to_state_dict(jax.device_get(tree))
    return [torch.as_tensor(np.asarray(sd[n])).clone() for n in policy.param_names]


@pytest.mark.parametrize("double_q", [True, False])
def test_one_learn_call_matches_reference(double_q):
    cfg = {**LEARN_CONFIG, "double_q": double_q}
    obs_space = gym.spaces.Box(-1, 1, (OBS,), np.float32)
    ref = DQNJaxPolicy(obs_space, gym.spaces.Discrete(3), {**cfg, "_mesh": _one_shard()})
    other = DQNJaxPolicy(obs_space, gym.spaces.Discrete(3), {**cfg, "seed": 8, "_mesh": _one_shard()})
    ref.aux_state = {"target_params": other.params}  # a target unlike the online net
    port = DQNTorchPolicy(Box(-1, 1, (OBS,), np.float32), Discrete(3), cfg, device="cpu")
    from_jax_params(jax.device_get(ref.params), port.model)
    port.aux_state = {"target_params": _port_params(port, other.params)}
    batch = _learn_batch()

    ref_td0 = ref.compute_td_error(JSampleBatch(dict(batch)))
    np.testing.assert_allclose(port.compute_td_error(batch), ref_td0, rtol=1e-5, atol=1e-5)
    perm = _reference_perm(ref._rng)
    ref_stats = ref.learn_on_batch(JSampleBatch(dict(batch)))
    stats = port.learn_on_batch(batch, perms=torch.as_tensor(perm))
    assert set(stats) == set(ref_stats)
    for k, v in ref_stats.items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    got = port.get_weights()
    for name, r in flax_to_state_dict(jax.device_get(ref.params)).items():
        np.testing.assert_allclose(got[name], r, rtol=1e-5, atol=1.5e-5, err_msg=name)
    np.testing.assert_allclose(
        port.compute_td_error(batch), ref.compute_td_error(JSampleBatch(dict(batch))),
        rtol=1e-5, atol=1e-5,
    )
    port.update_target()
    ref.update_target()
    target = flax_to_state_dict(jax.device_get(ref.aux_state["target_params"]))
    for name, t, p in zip(port.param_names, port.aux_state["target_params"], port.params):
        assert torch.equal(t, p.detach()) and t.data_ptr() != p.data_ptr()
        np.testing.assert_allclose(t.numpy(), target[name], rtol=1e-5, atol=1.5e-5)


def test_policy_state_roundtrip_carries_target():
    space, act = Box(-1, 1, (OBS,), np.float32), Discrete(3)
    a = DQNTorchPolicy(space, act, LEARN_CONFIG, device="cpu")
    a.learn_on_batch(_learn_batch(1))
    b = DQNTorchPolicy(space, act, {**LEARN_CONFIG, "seed": 9}, device="cpu")
    b.set_state(a.get_state())
    for x, y in zip(a.aux_state["target_params"], b.aux_state["target_params"]):
        assert torch.equal(x, y)
    perms = a.draw_permutations(B)
    assert a.learn_on_batch(_learn_batch(2), perms=perms) == b.learn_on_batch(_learn_batch(2), perms=perms)
    with pytest.raises(ValueError, match="R2D2"):
        DQNTorchPolicy(space, act, {"model": {"use_lstm": True}}, device="cpu")


# -- the postprocess="none" lane -------------------------------------------------

_split = jax.jit(jax.vmap(jax.random.split))
_serve = jax.jit(jax.vmap(PongLiteJax._serve))


def _draw(keys):
    pair = _split(keys)
    by, vx, vy = _serve(pair[:, 1])
    return pair[:, 0], torch.as_tensor(np.stack([by, vx, vy], axis=1))


def _reference_draws(seed, n, t, done_rows, keys=None):
    """The serves the reference lane consumed (first reset's only when
    ``keys`` is None; per step, the step's and the auto-reset's)."""
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


def test_replay_fill_lane_matches_reference():
    n, t, seed = 4, 6, 2
    cfg = {"seed": 5, "train_batch_size": 8,
           "model": {"conv_filters": PONG_FILTERS, "post_fcnet_hiddens": [16]}}
    env_cfg = {"max_steps": 5, "rallies": 2}
    ref_pol = DQNJaxPolicy(
        gym.spaces.Box(0, 255, (84, 84, 1), np.uint8), gym.spaces.Discrete(3),
        {**cfg, "_mesh": _one_shard()},
    )
    ref_eng = JaxRolloutEngine(ref_pol, PongLiteJax(env_cfg), n, t, seed=seed, postprocess="none")
    port_pol = DQNTorchPolicy(Box(0, 255, (84, 84, 1), np.uint8), Discrete(3), cfg, device="cpu")
    from_jax_params(jax.device_get(ref_pol.params), port_pol.model)
    keys, port_eng = None, None
    for _ in range(2):
        batch, bsize = ref_eng.rollout()
        ref = {k: np.asarray(v) for k, v in batch.items()}

        def tn(col):  # env-major rows → (T, N)
            return ref[col].reshape(n, t).T

        done = tn("dones") | tn("truncateds")
        keys, init, step_serves, reset_serves = _reference_draws(seed, n, t, done, keys)
        if port_eng is None:
            port_eng = DeviceRolloutEngine(
                port_pol, PongLiteTensor(env_cfg), n, t, initial_draws=init, postprocess="none"
            )
        got, psize = port_eng.rollout(
            RolloutDraws(torch.as_tensor(tn("actions")), step_serves, reset_serves)
        )
        got = {k: v.numpy() for k, v in got.items()}
        assert psize == bsize == n * t
        assert set(got) == set(ref) == {
            "obs", "new_obs", "actions", "rewards", "dones", "truncateds", "t",
            "action_dist_inputs", "action_logp", "agent_index",
        }
        for col in ("obs", "new_obs", "actions", "rewards", "dones", "truncateds", "t",
                    "agent_index"):
            assert got[col].tobytes() == ref[col].astype(got[col].dtype).tobytes(), col
        for col in ("action_dist_inputs", "action_logp"):
            np.testing.assert_allclose(got[col], ref[col], rtol=0, atol=2e-2, err_msg=col)
        assert done.any()


# -- DQN.train() -------------------------------------------------------------------

TRAIN_STEPS = dict(train_batch_size=8, num_steps_sampled_before_learning_starts=16,
                   target_network_update_freq=16)
ENV_CFG = {"max_steps": 20, "rallies": 2}
MODEL = {"conv_filters": PONG_FILTERS, "post_fcnet_hiddens": [16]}
RB = {"capacity": 64, "prioritized_replay": True}


def _port_dqn(seed, **training):
    cfg = (
        DQNConfig()
        .environment("PongLiteJax-v0", env_config=ENV_CFG, env_backend="jax")
        .rollouts(num_envs_per_worker=2, rollout_fragment_length=4)
        .training(replay_buffer_config=RB, model=MODEL, **TRAIN_STEPS, **training)
    )
    return cfg.debugging(seed=seed).resources(device="cpu").build()


def _record_draws(buf, into):
    sample = buf.sample

    def recorded(*args, **kwargs):
        b = sample(*args, **kwargs)
        into.append(np.asarray(b.indices.cpu() if isinstance(b.indices, torch.Tensor) else b.indices))
        return b

    buf.sample = recorded


def _train(algo, iters, draws):
    results = []
    for i in range(iters):
        results.append(algo.train())
        if i == 0:
            _record_draws(algo.local_replay_buffer.buffers["default_policy"], draws)
    return results


def test_dqn_train_counters_and_first_draw_match_reference():
    cfg = (
        JDQNConfig()
        .environment("PongLiteJax-v0", env_config=ENV_CFG, env_backend="jax")
        .rollouts(num_rollout_workers=0, num_envs_per_worker=2, rollout_fragment_length=4)
        .training(train_batch_size=8, replay_device_resident=True, model=MODEL)
        .debugging(seed=3)
        .resources(learner_devices=1)  # a one-shard mesh, as the port's one device
    )
    cfg.num_steps_sampled_before_learning_starts = 16
    cfg.target_network_update_freq = 16
    cfg.replay_buffer_config.update(RB)
    ref = cfg.build()
    try:
        ref_draws, port_draws = [], []
        ref_results = _train(ref, 6, ref_draws)
        ref_buf = ref.local_replay_buffer.buffers["default_policy"]
        assert ref_buf.tree_plane == "host"
    finally:
        ref.cleanup()
    port = _port_dqn(3)
    port_results = _train(port, 6, port_draws)
    buf = port.local_replay_buffer.buffers["default_policy"]
    assert len(buf) == len(ref_buf) == 48
    for r, p in zip(ref_results, port_results):
        for key in ("num_env_steps_sampled", "num_env_steps_trained", "num_target_updates"):
            assert p["info"].get(key, 0) == r["info"].get(key, 0), key
        assert p["num_env_steps_sampled"] == r["num_env_steps_sampled"]
    assert port_results[-1]["info"]["num_target_updates"] == 2
    assert len(port_draws) == len(ref_draws) == 5, (port_draws, ref_draws)
    np.testing.assert_array_equal(port_draws[0], ref_draws[0])
    learner = port_results[-1]["info"]["learner"]["default_policy"]
    assert {"mean_q", "mean_td_error", "max_q", "total_loss", "grad_gnorm", "cur_lr"} <= set(learner)
    assert all(np.isfinite(v) for v in learner.values())
    assert port.get_policy().coeff_values["epsilon"] < 1.0


def test_dqn_train_repeatable_and_checkpoint():
    a, b = _port_dqn(11), _port_dqn(11)
    ra = [a.train() for _ in range(4)]
    rb = [b.train() for _ in range(4)]
    for x, y in zip(ra, rb):
        assert x["info"] == y["info"]
        np.testing.assert_array_equal(x["episode_reward_mean"], y["episode_reward_mean"])
    c = _port_dqn(12)
    rc = [c.train() for _ in range(4)]
    assert rc[-1]["info"]["learner"] != ra[-1]["info"]["learner"]
    c.__setstate__(a.__getstate__())
    sa = a.local_replay_buffer.buffers["default_policy"]
    sc = c.local_replay_buffer.buffers["default_policy"]
    assert (len(sc), sc._idx, sc._max_priority) == (len(sa), sa._idx, sa._max_priority)
    assert sc._dtree.sum_value.numpy().tobytes() == sa._dtree.sum_value.numpy().tobytes()
    sc._rng.bit_generator.state = sa._rng.bit_generator.state
    xa, xc = sa.sample(8, beta=0.4), sc.sample(8, beta=0.4)
    assert torch.equal(xa.indices, xc.indices)
    for k in xa.tree:
        assert torch.equal(xa.tree[k], xc.tree[k]), k
    assert c._counters == a._counters
    # the lane's rollouts pulled back once into a host ring: the same
    # draws and the same learns, bitwise
    h = _port_dqn(11, replay_device_resident=False)
    rh = [h.train() for _ in range(4)]
    sh = h.local_replay_buffer.buffers["default_policy"]
    assert type(sh).__name__ == "PrioritizedReplayBuffer"
    for x, y in zip(ra, rh):
        y["info"].pop("timers", None)  # the host ring's learns time their upload
        assert x["info"] == y["info"]
    np.testing.assert_array_equal(sh._priority_state()["leaf_values"],
                                  sa.get_state()["priorities"]["leaf_values"])
