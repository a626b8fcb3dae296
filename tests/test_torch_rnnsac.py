"""RNNSAC of the port against the reference's, on the CPU.

Contracts:

- the nets (``_RNNActorNet``, ``_RNNTwinQNet``) through
  ``from_jax_rnnsac_state``: sequence outputs within 1e-5 relative plus
  1e-6, and the reference test's shapes and reset isolation
  (``tests/test_rnnsac.py``): outputs after a reset do not see the
  steps before it;
- recurrent acting: the initial state, the greedy actions and the
  carried ``(h, c)`` against the reference's ``compute_actions`` within
  1e-5 relative plus 1e-6 (plus the float32 tanh's step on an action),
  and the carried state changes the next action;
- one update on a fixed sequence batch, from the reference's state, with
  the reference's two (B, T, action_dim) normal draws injected, with and
  without burn-in and with padding: SAC's tolerances
  (``tests/test_torch_sac.py``): the stats within 1e-5 relative plus
  1e-6 plus the tanh budget, every parameter, the target and the three
  Adam states within 1e-6 absolute plus 1e-5 relative;
- flat SAC's update through the same hooks is unchanged (its tests);
- ``RNNSAC.train()`` on the port's Pendulum-v1 (the reference's
  ``test_rnnsac_end_to_end_pendulum``), and the refusals: stored states
  (``zero_init_states=False``) and SAC's recurrent model.
"""

from __future__ import annotations

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.algorithms.sac.rnnsac import RNNSACConfig as JRNNSACConfig
from ray_tpu.algorithms.sac.rnnsac import RNNSACJaxPolicy
from ray_tpu.data.sample_batch import SampleBatch as JSampleBatch
from ray_tpu.sharding import get_mesh
from ray_tpu_torch.algorithms.sac.rnnsac import RNNSACConfig, RNNSACTorchPolicy
from ray_tpu_torch.algorithms.sac.sac import SAC_STATS, SACTorchPolicy
from ray_tpu_torch.data.sample_batch import SampleBatch
from ray_tpu_torch.env.spaces import Box
from ray_tpu_torch.utils.jax_params import from_jax_rnnsac_state
from test_torch_sac import _assert_sac_state_close, _tanh_budget

OBS, ACT = 3, 2
B, T = 4, 6
NETS = {"policy_model_config": {"fcnet_hiddens": [16], "lstm_cell_size": 8},
        "q_model_config": {"fcnet_hiddens": [12], "lstm_cell_size": 8}}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _seq_batch(rng, obs_scale=0.5, burn_pad=True):
    resets = np.zeros((B, T), np.float32)
    resets[:, 0] = 1.0
    resets[2, 3] = 1.0  # an episode restart inside a sequence
    mask = np.ones((B, T), np.float32)
    if burn_pad:
        mask[0, -2:] = 0.0  # a padded tail
    dones = np.zeros((B, T), np.float32)
    dones[2, 2] = 1.0
    dones[1, 4] = 1.0
    return {
        "obs": (rng.standard_normal((B, T, OBS)) * obs_scale).astype(np.float32),
        "new_obs": (rng.standard_normal((B, T, OBS)) * obs_scale).astype(np.float32),
        "actions": rng.uniform(-1, 1, (B, T, ACT)).astype(np.float32),
        "rewards": rng.standard_normal((B, T)).astype(np.float32),
        "dones": dones,
        "resets": resets,
        "mask": mask,
    }


def _config(**over):
    cfg = {k: v for k, v in JRNNSACConfig().to_dict().items() if k != "env"}
    cfg.update(NETS, train_batch_size=B * T, seed=0, gamma=0.97, initial_alpha=0.7, tau=0.05,
               **over)
    return cfg


def _pair(**over):
    """A reference policy one update in and a port policy with its
    state."""
    cfg = _config(**over)
    ref = RNNSACJaxPolicy(gym.spaces.Box(-1, 1, (OBS,), np.float32),
                          gym.spaces.Box(-1, 1, (ACT,), np.float32),
                          {**cfg, "_mesh": get_mesh(devices=jax.devices()[:1])})
    rng = np.random.default_rng(0)
    ref.learn_on_batch(JSampleBatch(_seq_batch(rng)))
    port = RNNSACTorchPolicy(Box(-1, 1, (OBS,)), Box(-1, 1, (ACT,)), cfg, device="cpu")
    from_jax_rnnsac_state(port, jax.device_get(ref.params), jax.device_get(ref.aux_state),
                          jax.device_get(ref.opt_state))
    return ref, port, rng


def _close(port, ref, extra=0.0):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    bound = 1e-5 * np.abs(ref) + 1e-6 + extra
    assert port.shape == ref.shape and (np.abs(port - ref) <= bound).all(), (
        np.max(np.abs(port - ref) - bound))


def test_nets_shapes_reset_isolation_and_reference_outputs():
    ref, port, rng = _pair()
    obs = rng.standard_normal((2, T, OBS)).astype(np.float32)
    acts = rng.uniform(-1, 1, (2, T, ACT)).astype(np.float32)
    resets = np.array([[1, 0, 0, 1, 0, 0]] * 2, np.float32)
    with torch.no_grad():
        di = port.actor(torch.as_tensor(obs), torch.as_tensor(resets)).numpy()
        q1, q2 = (q.numpy() for q in port.critic(torch.as_tensor(obs), torch.as_tensor(acts),
                                                 torch.as_tensor(resets)))
    assert di.shape == (2, T, 2 * ACT) and q1.shape == (2, T) and q2.shape == (2, T)
    assert not np.allclose(q1, q2)
    _close(di, ref.actor.apply(ref.params["actor"], jnp.asarray(obs), jnp.asarray(resets)))
    rq = ref.critic.apply(ref.params["critic"], jnp.asarray(obs), jnp.asarray(acts),
                          jnp.asarray(resets))
    _close(q1, rq[0])
    _close(q2, rq[1])
    obs_b = obs.copy()
    obs_b[:, :3] += 5.0
    with torch.no_grad():
        di_b = port.actor(torch.as_tensor(obs_b), torch.as_tensor(resets)).numpy()
    np.testing.assert_array_equal(di[:, 3:], di_b[:, 3:])
    assert np.abs(di[:, :3] - di_b[:, :3]).max() > 1e-3
    names = set(port.param_names)
    assert {"actor.fc_0.weight", "actor._cell.hf.bias", "actor._head.weight",
            "critic._fcs_q2_0.weight", "critic._cells_q1.ii.weight", "critic._heads_q2.bias",
            "log_alpha"} <= names


def test_recurrent_acting_matches_reference():
    ref, port, rng = _pair()
    init = port.get_initial_state()
    assert len(init) == 2 and init[0].shape == (8,)
    for a, b in zip(init, ref.get_initial_state()):
        np.testing.assert_array_equal(a, b)
    obs = rng.standard_normal((3, OBS)).astype(np.float32)
    state = None
    for _ in range(3):
        a, s, extra = port.compute_actions(obs, state_batches=state, explore=False)
        ra, rs, _ = ref.compute_actions(obs, state_batches=state, explore=False)
        _close(a, ra, 5e-7)
        for x, y in zip(s, rs):
            _close(x, y)
        assert a.shape == (3, ACT) and s[0].shape == (3, 8) and "action_logp" in extra
        a2, _, _ = port.compute_actions(obs, state_batches=s, explore=False)
        assert not np.allclose(a, a2)  # the carried state moves the action
        state = rs


def _reference_normals(key):
    _, rng = jax.random.split(key)
    rng_t, rng_a = jax.random.split(jax.random.fold_in(rng, 0))
    return tuple(torch.as_tensor(np.array(jax.random.normal(r, (B, T, ACT), jnp.float32)))
                 for r in (rng_t, rng_a))


def _raw(port, obs, resets, eps):
    with torch.no_grad():
        d = port._dist(torch.as_tensor(obs), torch.as_tensor(resets))
        return (d.mean + d.std * eps).numpy()


@pytest.mark.parametrize("burn_in", [0, 2])
def test_one_update_matches_reference(burn_in):
    ref, port, rng = _pair(replay_burn_in=burn_in)
    b = _seq_batch(rng)
    normals = _reference_normals(ref._rng)
    budget_t, _ = _tanh_budget(_raw(port, b["new_obs"], b["resets"], normals[0]), -1.0, 1.0)
    budget_a, _ = _tanh_budget(_raw(port, b["obs"], b["resets"], normals[1]), -1.0, 1.0)
    assert max(budget_t.max(), budget_a.max()) < 2e-4  # no sample near saturation
    ref_stats = ref.learn_on_batch(JSampleBatch(dict(b)))
    stats = port.learn_on_batch(SampleBatch(dict(b)), normals=normals)
    assert tuple(stats) == SAC_STATS and set(stats) == set(ref_stats)
    alpha = float(np.exp(port.get_weights()["log_alpha"]))
    slack = 4 * (alpha + 10) * max(budget_t.max(), budget_a.max())
    for k, v in ref_stats.items():
        assert abs(stats[k] - v) <= 1e-5 * abs(v) + 1e-6 + slack, (k, stats[k], v)
    _assert_sac_state_close(port, ref)
    assert port.num_grad_updates == 1


def test_draws_come_from_the_generator_when_not_given():
    _, port, rng = _pair()
    b = _seq_batch(rng)
    twin = RNNSACTorchPolicy(Box(-1, 1, (OBS,)), Box(-1, 1, (ACT,)), _config(), device="cpu")
    twin.set_state(port.get_state())
    g = torch.Generator().manual_seed(11)
    port.action_generator.manual_seed(11)
    normals = (torch.randn((B, T, ACT), generator=g), torch.randn((B, T, ACT), generator=g))
    assert port.learn_on_batch(SampleBatch(dict(b))) == twin.learn_on_batch(
        SampleBatch(dict(b)), normals=normals)


def test_rnnsac_trains_on_pendulum_and_refusals():
    algo = (RNNSACConfig().environment("Pendulum-v1")
            .rollouts(num_rollout_workers=0, rollout_fragment_length=20)
            .training(train_batch_size=80, replay_sequence_length=10, replay_burn_in=2,
                      num_steps_sampled_before_learning_starts=40, **NETS)
            .debugging(seed=0).resources(device="cpu").build())
    try:
        for _ in range(4):
            result = algo.train()
        info = result["info"]["learner"]["default_policy"]
        assert all(np.isfinite(info[k]) for k in SAC_STATS)
        assert algo._counters["num_env_steps_trained"] > 0 and len(algo.seq_buffer) >= 8
        seq = algo.seq_buffer._storage[0]
        assert seq["obs"].shape == (10, 3) and seq["new_obs"].shape == (10, 3)
    finally:
        algo.stop()
    with pytest.raises(ValueError, match="zero_init_states"):
        RNNSACConfig().environment("Pendulum-v1").training(zero_init_states=False).resources(
            device="cpu").build()
    with pytest.raises(ValueError, match="RNNSAC.*ported"):
        SACTorchPolicy(Box(-1, 1, (OBS,)), Box(-1, 1, (ACT,)), {"model": {"use_lstm": True}},
                       device="cpu")
