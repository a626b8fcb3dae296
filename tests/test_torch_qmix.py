"""QMIX of the port against the reference's, on the CPU.

Contracts:

- flax's ``GRUCell`` against ``models/rnn.GRUCell`` on the same weights:
  one step and a T-step unroll within 1e-6;
- the act step from converted weights (``from_jax_qmix_state``): the
  agent net's Q values within 1e-5, the carries within 1e-6, the actions
  equal under the reference's ``jax.random`` draws injected;
- the collector at epsilon 1 with those draws: every padded episode row
  (obs (T+1, n, d), int32 actions (T, n), reward, done, mask) bitwise the
  reference's episode list, on the device ring (the row-scatter kernel's
  plain version on the CPU) and on the port's own episode list, with the
  unpadded step counts of ``_ep_steps``; the first insert past
  ``replay_memory_cap_bytes`` abandons the ring for the list;
- the index draws bitwise (the same ``_np_rng`` stream), so the gathered
  batch (the row-gather kernel's plain version) is the reference's rows;
- one learn from the reference's trained state, recurrent with double Q,
  ``double_q=False`` and ``agent_rnn=False``: parameters, targets and
  Adam moments within the learn contract (1e-5 relative + 1.5e-5), the
  stats within 1e-4 relative;
- the target-update counters over training steps equal the reference's;
- the checkpoint round trip (the reference's
  ``test_qmix_checkpoint_roundtrip``), the ``_mesh`` refusal naming item
  7 and the Discrete-action check.
"""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_bandit_qmix import CoopSpreadEnv, RecallCoopEnv, TwoStepCoopEnv

import flax.linen as fnn
from ray_tpu.algorithms.qmix.qmix import QMIXConfig as JQMIXConfig
from ray_tpu.env.registry import register_env as jregister_env
from ray_tpu_torch.algorithms.qmix.qmix import QMIX, QMIXConfig
from ray_tpu_torch.env.registry import register_env
from ray_tpu_torch.models.rnn import GRUCell, gru_unroll
from ray_tpu_torch.utils.jax_params import from_jax_params, from_jax_qmix_state

RTOL, ATOL = 1e-5, 1.5e-5  # the learn contract

for _register in (register_env, jregister_env):
    _register("qmix_two_step", lambda cfg: TwoStepCoopEnv(cfg))
    _register("qmix_recall", lambda cfg: RecallCoopEnv(cfg))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SMALL = dict(agent_hiddens=[16], agent_cell_size=8, mixing_embed_dim=8, hypernet_hidden=12,
             episode_limit=4, train_batch_size=8, buffer_size=64, rollout_fragment_length=8,
             num_steps_sampled_before_learning_starts=16, target_network_update_freq=24,
             lr=3e-3)


def _configs(env="qmix_recall", **over):
    """The reference's and the port's configs, SMALL with ``over``."""
    kw = {**SMALL, **over}
    out = []
    for cls in (JQMIXConfig, QMIXConfig):
        c = cls().environment(env).debugging(seed=0)
        for k, v in kw.items():
            # the reference's CPU runs keep the episode list
            if cls is QMIXConfig or not k.startswith("replay_"):
                setattr(c, k, v)
        out.append(c)
    ref_cfg, port_cfg = out
    return ref_cfg, port_cfg.resources(device="cpu")


def _pair(env="qmix_recall", **over):
    ref_cfg, port_cfg = _configs(env, **over)
    ref, port = ref_cfg.build(), port_cfg.build()
    from_jax_qmix_state(port, jax.device_get(ref.params), jax.device_get(ref.target_params),
                        jax.device_get(ref.opt_state))
    return ref, port


def _recording(ref):
    """The draws of every act step the reference takes from now on, in
    order (its ``_actions`` wrapped)."""
    recorded = []
    act = ref._actions

    def recording(obs_stack, eps):
        recorded.append(_draws(ref._rng, ref.n_agents, ref.num_actions))
        return act(obs_stack, eps)

    ref._actions = recording
    return recorded


def _draws(key, n, num_actions):
    """The act step's draws of the reference's next ``_actions`` call:
    its key split off ``key`` (``self._rng``), then (uniform, action)."""
    _, rng = jax.random.split(key)
    rng_u, rng_a = jax.random.split(rng)
    rand = np.asarray(jax.random.randint(rng_a, (n,), 0, num_actions))
    u = np.asarray(jax.random.uniform(rng_u, (n,)))
    return rand, u


def _collect_both(ref, port, steps):
    """``steps`` joint steps of each collector, the port given the
    reference's draws."""
    recorded = _recording(ref)
    ref._collect(steps)
    port._collect(steps, draws=recorded)


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _state_close(port, ref):
    from ray_tpu_torch.utils.jax_params import _qmix_state_dict

    got = port.__getstate__()
    want = {"params": _qmix_state_dict(jax.device_get(ref.params)),
            "target_params": _qmix_state_dict(jax.device_get(ref.target_params))}
    for part in ("params", "target_params"):
        for n, w in want[part].items():
            _close(got[part][n], w, f"{part} {n}")
    adam = jax.device_get(ref.opt_state)[0]
    assert got["opt_state"]["count"] == int(adam.count)
    for key in ("mu", "nu"):
        for n, w in _qmix_state_dict(getattr(adam, key)).items():
            _close(got["opt_state"][key][n], w, f"adam {key} {n}")


# -- the GRU -------------------------------------------------------------------


def test_gru_cell_and_unroll_match_flax():
    rng = np.random.default_rng(0)
    B, T, D, H = 5, 7, 6, 8
    cell = fnn.GRUCell(H)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    h0 = rng.standard_normal((B, H)).astype(np.float32)
    params = cell.init(jax.random.PRNGKey(3), jnp.asarray(h0), jnp.asarray(x[:, 0]))
    port = GRUCell(D, H, torch.Generator().manual_seed(0))
    from_jax_params(jax.device_get(params), port)
    assert sorted(n for n, _ in port.named_parameters()) == sorted(
        [f"{g}.weight" for g in ("ir", "iz", "in", "hr", "hz", "hn")]
        + [f"{g}.bias" for g in ("ir", "iz", "in", "hn")])
    want, _ = cell.apply(params, jnp.asarray(h0), jnp.asarray(x[:, 0]))
    got, out = port(torch.tensor(h0), torch.tensor(x[:, 0]))
    assert torch.equal(got, out)
    _close(got.detach(), want, "one step", rtol=0.0, atol=1e-6)
    h, ys = jnp.asarray(h0), []
    for t in range(T):
        h, y = cell.apply(params, h, jnp.asarray(x[:, t]))
        ys.append(y)
    y_got, h_got = gru_unroll(port, torch.tensor(x), torch.tensor(h0))
    _close(y_got.detach(), jnp.stack(ys, axis=1), "unroll outputs", rtol=0.0, atol=1e-6)
    _close(h_got.detach(), h, "unroll carry", rtol=0.0, atol=1e-6)
    # a reset zeroes the carry before its step
    resets = np.zeros((B, T), np.float32)
    resets[:, 3] = 1.0
    y_r, _ = gru_unroll(port, torch.tensor(x), torch.tensor(h0), torch.tensor(resets))
    y_fresh, _ = gru_unroll(port, torch.tensor(x[:, 3:]), torch.zeros(B, H))
    assert torch.equal(y_r[:, 3:], y_fresh)


# -- acting and the episode rows -------------------------------------------------


def test_act_step_q_values_carries_and_actions():
    ref, port = _pair()
    try:
        rng = np.random.default_rng(1)
        obs = rng.standard_normal((2, 3)).astype(np.float32)
        h = rng.standard_normal((2, SMALL["agent_cell_size"])).astype(np.float32)
        q_ref, h_ref = ref.qnet.apply(ref.params["agent"], jnp.asarray(obs)[:, None], jnp.asarray(h))
        q, h_new = port.model.agent(torch.tensor(obs)[:, None], torch.tensor(h))
        _close(q.detach(), q_ref, "q values", rtol=1e-5, atol=1e-6)
        _close(h_new.detach(), h_ref, "carry", rtol=0.0, atol=1e-6)
        for eps in (0.0, 0.5, 1.0):
            for _ in range(4):
                draws = _draws(ref._rng, 2, ref.num_actions)
                o = rng.standard_normal((2, 3)).astype(np.float32)
                a_ref = ref._actions(o, eps)
                a = port._actions(o, eps, draws=draws)
                assert np.array_equal(a, a_ref), (eps, a, a_ref)
                _close(port._hidden, ref._hidden, "carried state", rtol=0.0, atol=1e-6)
    finally:
        ref.cleanup()
        port.stop()


@pytest.mark.parametrize("resident,limit", [(True, 4), (True, 1), (False, 4)])
def test_episode_rows_ring_and_draws_bitwise(resident, limit):
    """RecallCoop's two-step episodes whole (episode_limit 4) and cut
    into one-step chunks (episode_limit 1)."""
    ref, port = _pair(final_epsilon=1.0, replay_device_resident=resident, episode_limit=limit)
    try:
        assert (port._dev_buffer is not None) == resident and ref._dev_buffer is None
        _collect_both(ref, port, 23)
        rows = ref._buffer
        assert port.buffer_len() == len(rows) == (11 if limit == 4 else 23)
        if resident:
            ring = port._dev_buffer
            assert ring._store["obs"].shape[1:] == (limit + 1, 2, 3)
            assert ring._store["actions"].dtype == torch.int32
            for k in rows[0]:
                got = ring._store[k][: len(rows)].numpy()
                want = np.stack([r[k] for r in rows])
                assert got.dtype == want.dtype and np.array_equal(got, want), k
            steps = [float(r["mask"].sum()) for r in rows]
            assert np.array_equal(port._ep_steps[: len(rows)], np.float32(steps))
        else:
            for got, want in zip(port._buffer, rows):
                assert all(np.array_equal(got[k], want[k]) for k in want)
        assert len(port._episode_rows) == len(ref._episode_rows)
        for got, want in zip(port._episode_rows, ref._episode_rows):
            assert all(np.array_equal(np.asarray(got[k]), np.asarray(want[k])) for k in want)
        # the index draw is the reference's stream: the same rows gathered
        state = ref._np_rng.bit_generator.state
        idx = ref._np_rng.integers(0, len(rows), 8)
        ref._np_rng.bit_generator.state = state
        batch, steps = port.sample_episodes(8)
        assert steps == int(sum(float(rows[i]["mask"].sum()) for i in idx))
        for k in rows[0]:
            assert np.array_equal(batch[k].numpy(), np.stack([rows[i][k] for i in idx])), k
    finally:
        ref.cleanup()
        port.stop()


def test_first_insert_past_the_cap_keeps_the_episode_list():
    _, port_cfg = _configs(final_epsilon=1.0, replay_memory_cap_bytes=1)
    port = port_cfg.build()
    try:
        assert port._dev_buffer is not None
        port._collect(6)
        assert port._dev_buffer is None and port._ep_steps is None
        assert port.buffer_len() == len(port._buffer) == 3
    finally:
        port.stop()


# -- the learn -------------------------------------------------------------------


def _trained_pair(**over):
    """The reference trained a few steps; the port collects the same steps
    on the reference's draws, then takes the reference's whole state and
    its index generator."""
    ref, port = _pair(final_epsilon=1.0, **over)
    recorded = _recording(ref)
    for _ in range(4):
        ref.training_step()
    assert ref._learn_fn is not None
    port._collect(len(recorded), draws=recorded)
    from_jax_qmix_state(port, jax.device_get(ref.params), jax.device_get(ref.target_params),
                        jax.device_get(ref.opt_state))
    port._np_rng.bit_generator.state = ref._np_rng.bit_generator.state
    return ref, port


@pytest.mark.parametrize("variant", [{}, {"double_q": False}, {"agent_rnn": False}],
                         ids=["recurrent_double_q", "no_double_q", "feed_forward"])
def test_one_learn_matches_reference(variant):
    ref, port = _trained_pair(**variant)
    try:
        assert port.recurrent == variant.get("agent_rnn", True)
        assert not np.array_equal(*(np.asarray(jax.tree_util.tree_leaves(p)[0])
                                    for p in (ref.params, ref.target_params)))
        state = ref._np_rng.bit_generator.state
        idx = ref._np_rng.integers(0, len(ref._buffer), 8)
        ref._np_rng.bit_generator.state = state
        batch, _ = port.sample_episodes(8)
        jbatch = {k: jnp.asarray(np.stack([ref._buffer[i][k] for i in idx]))
                  for k in ref._buffer[0]}
        for k in jbatch:
            assert np.array_equal(batch[k].numpy(), np.asarray(jbatch[k])), k
        params, opt_state, ref_stats = ref._learn_fn(ref.params, ref.target_params, ref.opt_state,
                                                     jbatch, ref._rng)
        ref.params, ref.opt_state = params, opt_state
        stats = port.learn_on_batch(batch)
        assert set(stats) == set(ref_stats)
        for k, v in jax.device_get(ref_stats).items():
            np.testing.assert_allclose(stats[k], float(v), rtol=1e-4, atol=1e-6, err_msg=k)
        _state_close(port, ref)
    finally:
        ref.cleanup()
        port.stop()


def test_target_update_counters_match_reference():
    ref_cfg, port_cfg = _configs("qmix_two_step", final_epsilon=1.0)
    ref, port = ref_cfg.build(), port_cfg.build()
    try:
        for _ in range(8):
            ref.training_step()
            port.training_step()
            for key in ("num_env_steps_sampled", "num_env_steps_trained", "num_target_updates",
                        "num_agent_steps_sampled"):
                assert port._counters[key] == ref._counters[key], key
            assert port._last_target_update == ref._last_target_update
        assert port._counters["num_target_updates"] >= 2
        r = port.train()
        assert np.isfinite(r["info"]["learner"]["default_policy"]["loss"])
    finally:
        ref.cleanup()
        port.stop()


# -- the surface -----------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    _, cfg = _configs("qmix_two_step", rollout_fragment_length=8, train_batch_size=16,
                      num_steps_sampled_before_learning_starts=16)
    algo = cfg.build()
    try:
        for _ in range(5):  # 20 two-step episodes: learning starts at 16
            algo.train()
        path = algo.save(str(tmp_path))
        want = algo.__getstate__()
    finally:
        algo.stop()
    back = cfg.build()
    try:
        back.restore(path)
        got = back.__getstate__()
        for part in ("params", "target_params"):
            assert all(np.array_equal(got[part][n], v) for n, v in want[part].items())
        assert got["opt_state"]["count"] == want["opt_state"]["count"] > 0
        assert got["counters"] == want["counters"]
    finally:
        back.stop()


def test_refusals():
    _, cfg = _configs()
    with pytest.raises(NotImplementedError, match="item 7"):
        QMIX(config={**cfg.to_dict(), "_mesh": types.SimpleNamespace(shape={"data": 2})})
    QMIX(config={**cfg.to_dict(), "_mesh": types.SimpleNamespace(shape={"data": 1})}).stop()
    with pytest.raises(NotImplementedError, match="joint collector"):
        cfg.environment("qmix_recall", env_backend="jax").build()
    with pytest.raises(ValueError, match="Discrete"):
        QMIXConfig().environment(CoopSpreadEnv).resources(device="cpu").build()
