"""The recurrent learn path and recurrent PPO, IMPALA and APPO of the
port against the reference's, on the CPU.

Sizes as in ``tests/test_torch_recurrent.py`` (LSTM cell 16, hiddens
[16]; GTrXL dim 16, two heads of 8, memory 4, MLP 16), ``max_seq_len``
5. Contracts:

- bitwise: the ``resets`` derivation (row 0 a reset without stored
  state, and with it only where its episode starts) and
  ``prepare_batch`` (tiling with a reset at each wrap, trimming, one
  stored state an unroll in ``__chunk__state_in_k``) against the
  reference's trees;
- 1e-5 absolute (the reference test's): the unroll forward against
  per-episode forwards, the stored-state learn forward against the
  rollout mid-episode, and GTrXL's segments isolated by ``resets``;
- the learn tests' tolerance (stats 1e-4 relative and 1e-7 absolute,
  parameters 1e-5 relative plus 1.5e-5 absolute: Adam steps of float32
  arithmetic summed in other orders): one recurrent PPO
  ``learn_on_batch`` (LSTM with stored states; GTrXL) handed the
  reference's sequence permutations, and one IMPALA and one APPO learn
  with the LSTM (the V-trace tests' learn tolerance); GTrXL's key bias,
  whose gradient is zero up to rounding, within the steps' reach
  (steps x lr); ``compute_gradients`` on per-row stored states within
  1e-4 relative and 1e-6 absolute.

And end to end, through ``config.build()`` / ``train()`` with
``num_workers: 0``: recurrent PPO (LSTM and GTrXL), IMPALA and APPO
(LSTM), and the evaluate CLI threading an LSTM's state.
"""

from __future__ import annotations

import json

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

from ray_tpu.algorithms.appo.appo import APPOJaxPolicy
from ray_tpu.algorithms.impala.impala import ImpalaJaxPolicy
from ray_tpu.data.sample_batch import SampleBatch as RefSampleBatch
from ray_tpu.sharding import get_mesh
from ray_tpu_torch import evaluate
from ray_tpu_torch.algorithms.appo.appo import APPOConfig, APPOTorchPolicy
from ray_tpu_torch.algorithms.impala.impala import IMPALAConfig, ImpalaTorchPolicy
from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig, PPOTorchPolicy
from ray_tpu_torch.data.sample_batch import SampleBatch
from ray_tpu_torch.env.spaces import Box, Discrete
from ray_tpu_torch.utils.jax_params import flax_to_state_dict, from_jax_params
from test_torch_recurrent import (
    GTRXL,
    LSTM,
    OBS,
    _assert_same,
    _close,
    _port,
    _ppo_pair,
    _rows,
    _shared_pair,
    _t,
)


# -- the learn path ---------------------------------------------------------------


@pytest.mark.parametrize("model", ["lstm", "gtrxl"])
def test_resets_derived_from_eps_and_step_columns(model):
    """Row 0 is a reset without stored state (GTrXL) and only at t == 0
    with it (the LSTM); the rest where EPS_ID changes or T does not
    count on."""
    port, ref = _shared_pair(model)
    for eps, ts in (([7, 7, 7, 9, 9, 9, 9, 3, 3, 3], [0, 1, 2, 0, 1, 2, 3, 5, 6, 7]),
                    ([7, 7, 7, 7], [0, 1, 5, 6]), ([4, 4, 4, 5], [3, 4, 5, 0])):
        cols = _rows(len(eps), eps, ts, states=(16, 16) if model == "lstm" else ())
        p = port._batch_to_train_tree(SampleBatch(dict(cols)))
        r = ref._batch_to_train_tree(RefSampleBatch(dict(cols)))
        assert set(p) == set(r) and ("state_in_0" in p) == (model == "lstm")
        for k in r:
            _assert_same(p[k], r[k], k)
    assert p["resets"].tolist() == [float(model == "gtrxl"), 0.0, 0.0, 1.0]


@pytest.mark.parametrize("case", ["tiled", "trimmed", "whole"])
@pytest.mark.parametrize("model", ["lstm", "gtrxl"])
def test_prepare_batch_matches_reference(case, model):
    """Tiling a short batch up to one unroll (a reset at each wrap),
    trimming a long one to whole unrolls, and one stored state an
    unroll (``__chunk__state_in_k``): bitwise the reference's tree."""
    n = {"tiled": 3, "trimmed": 23, "whole": 20}[case]
    eps = np.repeat([1, 2, 3, 4], 6)[:n]
    ts = np.concatenate([np.arange(2, 8), np.arange(6), np.arange(6), np.arange(6)])[:n]
    cols = _rows(n, eps, ts, seed=n, states=(16, 16) if model == "lstm" else ())
    port, ref = _shared_pair(model)
    p, pb = port.prepare_batch(SampleBatch(dict(cols)))
    r, rb = ref.prepare_batch(RefSampleBatch(dict(cols)))
    assert pb == rb == {"tiled": 5, "trimmed": 20, "whole": 20}[case]
    assert set(p) == set(r)
    for k in r:
        _assert_same(p[k], r[k], k)
    if model == "lstm":
        assert "state_in_0" not in p and p["__chunk__state_in_0"].shape == (pb // 5, 16)
    if case == "tiled":  # the first row starts an episode only without stored state
        assert p["resets"].tolist() == [float(model == "gtrxl"), 0.0, 0.0, 1.0, 0.0]


def test_unroll_forward_matches_per_episode_forwards():
    port = _port(LSTM)
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((5, OBS)).astype(np.float32)
    resets = np.array([1, 0, 0, 1, 0], np.float32)  # episodes [0:3], [3:5]
    logits, value, _ = port.model_forward_train({"obs": _t(obs), "resets": _t(resets)})

    def episode(seg):
        return port.model(_t(seg[None]), port.model.initial_state(1))

    (la, va, _), (lb, vb, _) = episode(obs[:3]), episode(obs[3:])
    _close(logits, torch.cat([la, lb]).detach(), "logits", rtol=0, atol=1e-5)
    _close(value, torch.cat([va, vb]).detach(), "value", rtol=0, atol=1e-5)


def test_stored_state_train_forward_matches_rollout_mid_episode():
    """A chunk that continues an episode (t[0] > 0) trains from the
    sampler's stored chunk-start state and reproduces the rollout."""
    port = _port(LSTM)
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((10, OBS)).astype(np.float32)
    state = port.get_initial_state()
    states, rollout = [], []
    for t in range(10):
        states.append(state)
        _, state, extra = port.compute_single_action(obs[t], state, explore=False)
        rollout.append(extra["action_dist_inputs"])
    cols = {"obs": obs[5:], "eps_id": np.full(5, 42, np.int64), "t": np.arange(5, 10),
            "state_in_0": np.stack([s[0] for s in states[5:]]),
            "state_in_1": np.stack([s[1] for s in states[5:]])}
    tree, _ = port.prepare_batch(SampleBatch(cols))
    assert tree["resets"].tolist() == [0.0] * 5 and "__chunk__state_in_0" in tree
    logits, _, _ = port.model_forward_train({k: _t(v) for k, v in tree.items()})
    _close(logits, np.stack(rollout[5:]), "logits", rtol=0, atol=1e-5)


def test_attention_resets_isolate_episodes():
    port = _port(GTRXL)
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((5, OBS)).astype(np.float32)
    resets = np.array([1, 0, 0, 1, 0], np.float32)
    moved = obs.copy()
    moved[:3] += 10.0  # only the first episode

    def fwd(o):
        return port.model_forward_train({"obs": _t(o), "resets": _t(resets)})[0].detach().numpy()

    a, b = fwd(obs), fwd(moved)
    np.testing.assert_allclose(a[3:], b[3:], atol=1e-5)
    assert np.abs(a[:3] - b[:3]).max() > 1e-3


def _reference_seq_perms(key, batch_size, T, iters=2):
    """The sequence permutations the reference's nest draws on shard 0
    (its row permutations' key stream, ``tests/test_torch_ppo.py``, over
    ``batch_size // T`` unrolls)."""
    _, rng = jax.random.split(key)
    rng = jax.random.fold_in(rng, 0)
    return np.stack([
        np.asarray(jax.random.permutation(jax.random.split(r)[0], batch_size // T))
        for r in jax.random.split(rng, iters)
    ])


@pytest.mark.parametrize("model", ["lstm", "gtrxl"])
def test_one_recurrent_learn_matches_reference(model):
    port, ref = _ppo_pair(LSTM if model == "lstm" else GTRXL)
    eps = np.repeat([1, 2, 3], [8, 8, 7])
    ts = np.concatenate([np.arange(3, 11), np.arange(8), np.arange(7)])
    cols = _rows(23, eps, ts, seed=5, states=(16, 16) if model == "lstm" else ())
    perms = _reference_seq_perms(ref._rng, 20, 5)
    ref_stats = ref.learn_on_batch(RefSampleBatch(dict(cols)))
    stats = port.learn_on_batch(SampleBatch(dict(cols)), perms=torch.as_tensor(perms))
    assert set(stats) == set(ref_stats)
    for k, v in ref_stats.items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-4, atol=1e-7, err_msg=k)
    assert port.opt_state.count == 4  # 2 epochs x 2 minibatches of 2 unrolls
    got = port.get_weights()
    lr, steps = 1e-3, port.opt_state.count
    for name, r in flax_to_state_dict(jax.device_get(ref.params)).items():
        # GTrXL's key bias has a zero gradient up to rounding (q·b_k
        # shifts a query's every score alike, which its softmax
        # cancels), and Adam turns each framework's rounding noise into
        # steps of up to lr: held within the steps' reach instead
        atol = steps * lr if name.startswith("k_") and name.endswith(".bias") else 1.5e-5
        np.testing.assert_allclose(got[name], r, rtol=1e-5, atol=atol, err_msg=name)


def test_minibatches_round_to_whole_unrolls():
    port = PPOTorchPolicy(Box(-1.0, 1.0, (OBS,), np.float32), Discrete(2), {
        "model": {**LSTM, "max_seq_len": 20}, "train_batch_size": 2048,
        "sgd_minibatch_size": 256, "num_sgd_iter": 2}, device="cpu")
    assert port._nest_shape(2040) == (240, 8)  # cartpole-ppo.yaml's 2048 and 256
    assert port._host_permutations(2040).shape == (2, 102)
    with pytest.raises(ValueError, match="max_seq_len"):
        port._nest_shape(2048)


def test_compute_gradients_on_per_row_states_matches_reference():
    port, ref = _ppo_pair(LSTM)
    eps = np.repeat([1, 2], [6, 6])
    cols = _rows(12, eps, np.concatenate([np.arange(4, 10), np.arange(6)]), seed=7,
                 states=(16, 16))
    ref_grads, ref_stats = ref.compute_gradients(RefSampleBatch(dict(cols)))
    grads, stats = port.compute_gradients(SampleBatch(dict(cols)))
    for k, v in ref_stats.items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-4, atol=1e-7, err_msg=k)
    for name, g in flax_to_state_dict(ref_grads).items():
        np.testing.assert_allclose(grads[name], g, rtol=1e-4, atol=1e-6, err_msg=name)
    with pytest.raises(ValueError, match="shorter than one"):
        port.compute_gradients(SampleBatch(_rows(3, [1, 1, 1], [0, 1, 2], states=(16, 16))))


def test_fixed_seed_repeats():
    a, b = _port(LSTM), _port(LSTM)
    cols = _rows(20, np.repeat([1, 2], 10), np.concatenate([np.arange(10)] * 2), states=(16, 16))
    assert a.learn_on_batch(SampleBatch(dict(cols))) == b.learn_on_batch(SampleBatch(dict(cols)))
    for name, w in a.get_weights().items():
        _assert_same(w, b.get_weights()[name], name)
    obs = np.zeros((2, OBS), np.float32)
    acts_a = a.compute_actions(obs, [np.zeros((2, 16), np.float32)] * 2)
    acts_b = b.compute_actions(obs, [np.zeros((2, 16), np.float32)] * 2)
    for x, y in zip(jax.tree_util.tree_leaves(acts_a), jax.tree_util.tree_leaves(acts_b)):
        _assert_same(x, y, "act")


# -- IMPALA and APPO -------------------------------------------------------------------

T = 5
VTRACE_PAIRS = [(ImpalaTorchPolicy, ImpalaJaxPolicy), (APPOTorchPolicy, APPOJaxPolicy)]


def _unrolls(seed, n=6):
    """``n`` fixed unrolls of T steps with episode ends inside some."""
    rng = np.random.default_rng(seed)
    rows = n * T
    terms = np.zeros(rows, bool)
    truncs = np.zeros(rows, bool)
    terms[[2, 13]] = True
    truncs[[21]] = True
    return SampleBatch({
        "obs": rng.standard_normal((rows, OBS)).astype(np.float32),
        "new_obs": rng.standard_normal((rows, OBS)).astype(np.float32),
        "actions": rng.integers(0, 2, rows).astype(np.int64),
        "rewards": rng.standard_normal(rows).astype(np.float32),
        "dones": terms, "truncateds": truncs,
        "action_logp": np.full(rows, -0.69, np.float32),
        "unroll_id": np.repeat(np.arange(n), T).astype(np.int64),
    })


def _reference_perms(key, batch_size, iters=1):
    _, rng = jax.random.split(key)
    rng = jax.random.fold_in(rng, 0)
    return np.stack([
        np.asarray(jax.random.permutation(jax.random.split(r)[0], batch_size))
        for r in jax.random.split(rng, iters)
    ])


@pytest.mark.parametrize("cls_pair", VTRACE_PAIRS, ids=["impala", "appo"])
def test_one_lstm_vtrace_learn_matches_reference(cls_pair):
    port_cls, ref_cls = cls_pair
    cfg = {"model": {"use_lstm": True, "lstm_cell_size": 16, "fcnet_hiddens": [16]}, "seed": 0,
           "rollout_fragment_length": T, "train_batch_size": 3 * T, "lr": 1e-3,
           "entropy_coeff": 0.01, "grad_clip": 40.0, "_fixed_unrolls": True}
    ref = ref_cls(gym.spaces.Box(-1.0, 1.0, (OBS,), np.float32), gym.spaces.Discrete(2),
                  {**cfg, "_mesh": get_mesh(devices=jax.devices()[:1])})
    port = port_cls(Box(-1.0, 1.0, (OBS,), np.float32), Discrete(2), cfg, device="cpu")
    from_jax_params(jax.device_get(ref.params), port.model)
    if hasattr(port, "update_target"):
        port.update_target()
    batch = _unrolls(3)
    perms = _reference_perms(ref._rng, 6)
    ref_stats = ref.learn_on_batch(RefSampleBatch(dict(batch)))
    stats = port.learn_on_batch(batch, perms=torch.as_tensor(perms))
    assert set(stats) == set(ref_stats)
    for k, v in ref_stats.items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-4, atol=1e-7, err_msg=k)
    assert port.opt_state.count == 2  # 6 unrolls in minibatches of 3
    got = port.get_weights()
    for name, r in flax_to_state_dict(jax.device_get(ref.params)).items():
        np.testing.assert_allclose(got[name], r, rtol=1e-5, atol=1.5e-5, err_msg=name)


# -- the algorithms end to end --------------------------------------------------------


def _learner(result):
    return result["info"]["learner"].get("default_policy", {})


@pytest.mark.parametrize("model", ["lstm", "gtrxl"])
def test_recurrent_ppo_trains_on_cartpole(model):
    algo = (PPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, rollout_fragment_length=40, num_envs_per_worker=2)
            .training(train_batch_size=80, sgd_minibatch_size=40, num_sgd_iter=2,
                      model=LSTM if model == "lstm" else GTRXL)
            .resources(device="cpu").debugging(seed=0).build())
    try:
        for _ in range(2):
            result = algo.train()
        assert np.isfinite(_learner(result)["total_loss"])
        assert result["timesteps_total"] == 160
        policy = algo.get_policy()
        # 80 rows of 2 slots: 16 unrolls, minibatches of 8, 2 epochs
        assert policy.opt_state.count == 8
        state = policy.get_initial_state()
        action, state, _ = algo.compute_single_action(np.zeros(4, np.float32), state)
        assert [s.shape for s in state] == [s.shape for s in policy.get_initial_state()]
    finally:
        algo.stop()


@pytest.mark.parametrize("config_cls", [IMPALAConfig, APPOConfig], ids=["impala", "appo"])
def test_lstm_vtrace_algorithms_train(config_cls):
    algo = (config_cls().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, rollout_fragment_length=20)
            .training(train_batch_size=80, lr=5e-4,
                      model={"use_lstm": True, "lstm_cell_size": 16, "fcnet_hiddens": [16]})
            .resources(device="cpu").debugging(seed=0).build())
    try:
        info = {}
        for _ in range(60):
            info = _learner(algo.train())
            if "total_loss" in info:
                break
        assert np.isfinite(info["total_loss"]), info
    finally:
        algo.stop()


def test_evaluate_cli_threads_the_state(tmp_path, capsys):
    algo = (PPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, rollout_fragment_length=20)
            .training(train_batch_size=40, sgd_minibatch_size=20, num_sgd_iter=1, model=LSTM)
            .resources(device="cpu").debugging(seed=0).build())
    try:
        algo.train()
        path = algo.save(str(tmp_path / "ckpt"))
    finally:
        algo.stop()
    assert evaluate.main([path, "--run", "PPO", "--env", "CartPole-v1", "--episodes", "2",
                          "--config", json.dumps({"device": "cpu", "model": LSTM})]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["episodes"] == 2 and out["max_reward"] >= out["mean_reward"] > 0
