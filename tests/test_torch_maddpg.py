"""MADDPG of the port against the reference's, on the CPU.

Contracts:

- the agent-stacked actors and centralized critics carried from the
  reference (``from_jax_maddpg_state``: kernels (n, in, out) → weights
  (n, out, in)) and their forwards within 1e-5 relative (plus 1e-6);
- the joint collector with the reference's exploration normals injected
  (``jax.random.normal`` of its key's split): each stored row (obs,
  actions, rewards, next_obs, the termination-only done) within 1e-5
  relative plus 1e-6 (the actions pass through float32 nets of two
  frameworks), and the batch's index draw bitwise (the same ``_np_rng``
  stream);
- one learn from the reference's trained state on the same rows: critics,
  actors, both targets and both Adam states' moments within the learn
  contract (1e-5 relative + 1.5e-5), the counts equal, the stats within
  1e-4 relative; a second learn from there, so the actor step's use of
  the updated critic and the (n, B) mean are checked twice;
- the checkpoint round trip (the reference's
  ``test_maddpg_checkpoint_roundtrip``) and the refusals: a Discrete
  action space, ``env_backend="jax"``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_bandit_qmix import CoopSpreadEnv, TwoStepCoopEnv

from ray_tpu.algorithms.maddpg.maddpg import MADDPGConfig as JMADDPGConfig
from ray_tpu.env.registry import register_env as jregister_env
from ray_tpu_torch.algorithms.maddpg.maddpg import GROUPS, MADDPGConfig
from ray_tpu_torch.env.registry import register_env
from ray_tpu_torch.utils.jax_params import _stacked_to_state_dict, from_jax_maddpg_state

RTOL, ATOL = 1e-5, 1.5e-5  # the learn contract

for _register in (register_env, jregister_env):
    _register("maddpg_spread", lambda cfg: CoopSpreadEnv(cfg))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SMALL = dict(actor_hiddens=[16, 16], critic_hiddens=[24, 16], train_batch_size=16,
             rollout_fragment_length=8, num_steps_sampled_before_learning_starts=16,
             actor_lr=3e-3, critic_lr=2e-3, tau=0.05)


def _configs(**over):
    out = []
    for cls in (JMADDPGConfig, MADDPGConfig):
        c = cls().environment("maddpg_spread").debugging(seed=0)
        for k, v in {**SMALL, **over}.items():
            setattr(c, k, v)
        out.append(c)
    return out[0], out[1].resources(device="cpu")


def _pair(**over):
    ref_cfg, port_cfg = _configs(**over)
    ref, port = ref_cfg.build(), port_cfg.build()
    _carry(ref, port)
    return ref, port


def _carry(ref, port):
    from_jax_maddpg_state(port, jax.device_get(ref.params), jax.device_get(ref.target_params),
                          jax.device_get(ref.opt_state))


def _recording(ref):
    """The standard normals of every exploring act step the reference
    takes from now on (its ``_actions`` wrapped)."""
    recorded = []
    act = ref._actions

    def recording(obs_stack, explore):
        _, rng = jax.random.split(ref._rng)
        recorded.append(np.asarray(jax.random.normal(rng, (ref.n_agents, ref.act_dim))))
        return act(obs_stack, explore)

    ref._actions = recording
    return recorded


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _state_close(port, ref):
    got = port.__getstate__()
    for g in GROUPS:
        for part, tree in (("params", ref.params), ("target_params", ref.target_params)):
            for n, w in _stacked_to_state_dict(jax.device_get(tree[g])).items():
                _close(got[part][g][n], w, f"{part} {g} {n}")
        adam = jax.device_get(ref.opt_state[g])[0]
        assert got["opt_state"][g]["count"] == int(adam.count)
        for key in ("mu", "nu"):
            for n, w in _stacked_to_state_dict(getattr(adam, key)).items():
                _close(got["opt_state"][g][key][n], w, f"adam {g} {key} {n}")


def test_forward_matches_reference():
    ref, port = _pair()
    try:
        rng = np.random.default_rng(0)
        B, n = 6, port.n_agents
        obs = rng.standard_normal((B, n, port.obs_dim)).astype(np.float32) * 2
        want = jax.vmap(ref.actor.apply, in_axes=(0, 1), out_axes=1)(ref.params["actor"],
                                                                      jnp.asarray(obs))
        got = port.model.act(torch.tensor(obs).transpose(0, 1)).transpose(0, 1)
        _close(got.detach(), want, "actors", atol=1e-6)
        jobs = obs.reshape(B, -1)
        jact = rng.uniform(-1, 1, (B, n * port.act_dim)).astype(np.float32)
        want_q = jax.vmap(lambda cp: ref.critic.apply(cp, jobs, jact))(ref.params["critic"])
        got_q = port.model.q(port.model.critic, torch.tensor(jobs).expand(n, B, -1),
                             torch.tensor(jact).expand(n, B, -1))
        _close(got_q.detach(), want_q, "critics", atol=1e-6)
    finally:
        ref.cleanup()
        port.stop()


def test_collector_rows_and_index_draws():
    ref, port = _pair()
    try:
        recorded = _recording(ref)
        ref._collect(20)  # inside CoopSpread's first 25-step episode
        port._collect(20, normals=recorded)
        assert len(port._buffer) == len(ref._buffer) == 20
        for got, want in zip(port._buffer, ref._buffer):
            assert set(got) == set(want) and got["done"] == want["done"] == 0.0
            for k in want:
                assert got[k].dtype == np.asarray(want[k]).dtype, k
                _close(got[k], want[k], k, rtol=1e-5, atol=1e-6)
        assert port._counters["num_agent_steps_sampled"] == ref._counters["num_agent_steps_sampled"]
        state = ref._np_rng.bit_generator.state
        idx = ref._np_rng.integers(0, 20, 8)
        ref._np_rng.bit_generator.state = state
        rows = port.sample_rows(8)
        assert np.array_equal(rows["obs"], np.stack([port._buffer[i]["obs"] for i in idx]))
    finally:
        ref.cleanup()
        port.stop()


def test_learn_matches_reference():
    ref, port = _pair()
    try:
        for _ in range(4):
            ref.training_step()
        assert ref._learn_fn is not None
        _carry(ref, port)
        port._buffer = list(ref._buffer)
        port._np_rng.bit_generator.state = ref._np_rng.bit_generator.state
        bs = SMALL["train_batch_size"]
        for _ in range(2):
            idx = ref._np_rng.integers(0, len(ref._buffer), bs)
            jbatch = {k: jnp.asarray(np.stack([ref._buffer[i][k] for i in idx]))
                      for k in ref._buffer[0]}
            ref.params, ref.target_params, ref.opt_state, ref_stats = ref._learn_fn(
                ref.params, ref.target_params, ref.opt_state, jbatch)
            rows = port.sample_rows(bs)
            assert all(np.array_equal(rows[k], np.asarray(jbatch[k])) for k in rows)
            stats = port.learn_on_batch(rows)
            assert set(stats) == set(ref_stats)
            for k, v in jax.device_get(ref_stats).items():
                np.testing.assert_allclose(stats[k], float(v), rtol=1e-4, atol=1e-6, err_msg=k)
            _state_close(port, ref)
    finally:
        ref.cleanup()
        port.stop()


def test_checkpoint_roundtrip(tmp_path):
    _, cfg = _configs(rollout_fragment_length=8, train_batch_size=16,
                      num_steps_sampled_before_learning_starts=16)
    algo = cfg.build()
    try:
        for _ in range(3):
            r = algo.train()
        assert np.isfinite(r["info"]["learner"]["default_policy"]["critic_loss"])
        path = algo.save(str(tmp_path))
        want = algo.__getstate__()
    finally:
        algo.stop()
    back = cfg.build()
    try:
        back.restore(path)
        got = back.__getstate__()
        for part in ("params", "target_params"):
            for g in GROUPS:
                assert all(np.array_equal(got[part][g][n], v) for n, v in want[part][g].items())
        assert all(got["opt_state"][g]["count"] == want["opt_state"][g]["count"] > 0
                   for g in GROUPS)
        assert got["counters"] == want["counters"]
    finally:
        back.stop()


def test_refusals():
    with pytest.raises(ValueError, match="Box"):
        MADDPGConfig().environment(TwoStepCoopEnv).resources(device="cpu").build()
    with pytest.raises(NotImplementedError, match="joint collector"):
        MADDPGConfig().environment("maddpg_spread", env_backend="jax").resources(
            device="cpu").build()
