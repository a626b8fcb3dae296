"""R2D2 and SimpleQ of the port against the reference's, on the CPU.

Contracts:

- ``h_function`` against the reference's on float32 inputs within 1e-6
  relative (plus 1e-6 absolute), near 0 and at large |x|; ``h_inverse``
  and the round trip within the same plus one float32 step of the
  closed form (its leading term's last bit over ``2 eps^2``: 0.0596 at
  eps 1e-3, where the cancellation leaves nothing finer), and the round
  trip within the reference test's bound (``tests/test_apex.py``: 0.1
  absolute, 2e-3 relative);
- the chopper's sequences (padding, masks, resets under both state
  strategies, integer columns kept) and the sequence buffer's draws:
  bitwise;
- R2D2's loss on one sequence batch, and one ``learn_on_batch`` with the
  reference's permutation injected, from the reference's online net,
  target and Adam state (``from_jax_r2d2_state``), with zero and with
  stored initial states, with and without burn-in: loss and stats within
  1e-5 relative plus 1e-6, parameters and Adam moments within the
  learn contract (1e-5 relative plus 1.5e-5);
- SimpleQ's config equals the reference's, and one update from the
  reference's weights and a target unlike them, under DQN's contract
  (``tests/test_torch_dqn.py``);
- ``R2D2.train()`` through learning starts and target updates under both
  strategies, with the reference's ``tests/test_apex.py`` case: 160
  trained steps, a finite TD error, a filled sequence buffer; the
  stored-state strategy's sequences start from the sampler's states.

``-m slow`` runs ``cartpole-r2d2.yaml`` for 60 s on the CPU (recorded,
as the reference's yaml: no bar within a tier's time).
"""

from __future__ import annotations

import pathlib
import time

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.algorithms.dqn.dqn import DQNJaxPolicy
from ray_tpu.algorithms.dqn.dqn import SimpleQConfig as JSimpleQConfig
from ray_tpu.algorithms.r2d2 import r2d2 as jr2d2
from ray_tpu.data.sample_batch import SampleBatch as JSampleBatch
from ray_tpu.sharding import get_mesh
from ray_tpu_torch.algorithms.dqn.dqn import DQNTorchPolicy, SimpleQConfig
from ray_tpu_torch.algorithms.r2d2 import r2d2
from ray_tpu_torch.algorithms.r2d2.r2d2 import R2D2Config, R2D2TorchPolicy
from ray_tpu_torch.data.sample_batch import SampleBatch
from ray_tpu_torch.env.spaces import Box, Discrete
from ray_tpu_torch.utils.jax_params import (
    flax_to_state_dict,
    from_jax_adam_state,
    from_jax_dqn_target,
    from_jax_params,
    from_jax_r2d2_state,
)
from ray_tpu_torch.utils.tuned_example import build_tuned_example

REPO = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1.5e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _one_shard():
    return get_mesh(devices=jax.devices()[:1])


# -- the value rescaling -----------------------------------------------------------

H_INPUTS = np.concatenate([
    np.linspace(-1e-3, 1e-3, 41), np.linspace(-5.0, 5.0, 101), np.linspace(-500.0, 500.0, 101),
    [-1e4, -3e3, 3e3, 1e4],
]).astype(np.float32)


def _quantum(y, eps):
    """One float32 step of ``h_inverse``'s closed form at ``y``: its
    leading term ``2 eps y + (2 eps + 1)`` loses everything below its
    last bit to the cancellation, and the quotient by ``2 eps^2`` scales
    that bit (0.0596 at eps 1e-3 and |y| < 500)."""
    lead = (np.abs(2 * eps * np.asarray(y, np.float64)) + 2 * eps + 1).astype(np.float32)
    return np.spacing(lead).astype(np.float64) / (2 * eps ** 2)


def _inverse_close(got, want, y, eps):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = 1e-6 * np.abs(want) + 1e-6 + _quantum(y, eps)
    assert (np.abs(got - want) <= bound).all(), np.max(np.abs(got - want) - bound)


@pytest.mark.parametrize("eps", [1e-3, 1e-2])
def test_h_function_and_inverse_match_reference(eps):
    """``h_function`` within 1e-6 relative (bitwise, measured);
    ``h_inverse`` within 1e-6 relative plus one step of its closed form
    (:func:`_quantum`): the two frameworks' float32 square roots part by
    one bit on some inputs (one step measured at most)."""
    x = torch.as_tensor(H_INPUTS)
    h = r2d2.h_function(x, eps).numpy()
    np.testing.assert_allclose(h, np.asarray(jr2d2.h_function(jnp.asarray(H_INPUTS), eps)),
                               rtol=1e-6, atol=1e-6)
    # h_inverse on h's range, near 0 included
    y = np.concatenate([np.linspace(-1e-3, 1e-3, 41), h]).astype(np.float32)
    _inverse_close(r2d2.h_inverse(torch.as_tensor(y), eps).numpy(),
                   np.asarray(jr2d2.h_inverse(jnp.asarray(y), eps)), y, eps)
    back = r2d2.h_inverse(r2d2.h_function(x, eps), eps).numpy()
    ref_back = np.asarray(jr2d2.h_inverse(jr2d2.h_function(jnp.asarray(H_INPUTS), eps), eps))
    _inverse_close(back, ref_back, h, eps)
    np.testing.assert_allclose(back, H_INPUTS, rtol=2e-3, atol=0.1)


# -- the chopper and the sequence buffer --------------------------------------------


def _fragment(n=37, seed=0, cell=8):
    rng = np.random.default_rng(seed)
    # episodes start at rows 7 and 29; 6 and 28 end theirs by a done,
    # the one starting at 17 continues an id (a truncation's restart)
    eps_id = np.array([4, 9, 11])[np.searchsorted([7, 29], np.arange(n), side="right")]
    eps_id[17:29] = 9
    eps_id[np.arange(n) >= 17] += 1
    dones = np.zeros(n, bool)
    dones[[i for i in (6, 28) if i < n]] = True
    return SampleBatch({
        "obs": rng.standard_normal((n, 4)).astype(np.float32),
        "new_obs": rng.standard_normal((n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n).astype(np.int64),
        "rewards": rng.standard_normal(n).astype(np.float32),
        "dones": dones,
        "eps_id": eps_id.astype(np.int64),
        "state_in_0": (rng.standard_normal((n, cell)) * 0.5).astype(np.float32),
        "state_in_1": (rng.standard_normal((n, cell)) * 0.5).astype(np.float32),
    })


COLUMNS = ("obs", "actions", "rewards", "dones")


@pytest.mark.parametrize("first_row_is_reset", [True, False])
@pytest.mark.parametrize("T", [5, 10, 40])
def test_chopper_bitwise(T, first_row_is_reset):
    frag = _fragment()
    got = r2d2.chop_fragment_into_sequences(frag, T, COLUMNS, first_row_is_reset=first_row_is_reset)
    want = jr2d2.chop_fragment_into_sequences(JSampleBatch(dict(frag)), T, COLUMNS,
                                              first_row_is_reset=first_row_is_reset)
    assert [s for s, _ in got] == [s for s, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_sequence_buffer_draws_bitwise():
    got, want = r2d2.SequenceReplayBuffer(5, seed=3), jr2d2.SequenceReplayBuffer(5, seed=3)
    for i in range(3):
        for _, seq in r2d2.chop_fragment_into_sequences(_fragment(seed=i), 6, COLUMNS):
            got.add_sequence(seq)
            want.add_sequence({k: v.copy() for k, v in seq.items()})
        assert len(got) == len(want) and got.num_added == want.num_added
        a, b = got.sample(7), want.sample(7)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- the loss and one learn ------------------------------------------------------------

NSEQ, T, CELL = 6, 10, 8
MODEL = {"use_lstm": True, "lstm_cell_size": CELL, "fcnet_hiddens": [16]}


def _seq_batch(stored: bool, seed=0):
    frags = [_fragment(n=T * 2, seed=seed + i) for i in range(NSEQ // 2)]
    seqs = []
    for frag in frags:
        for start, seq in r2d2.chop_fragment_into_sequences(frag, T, COLUMNS,
                                                           first_row_is_reset=not stored):
            for k in ("state_in_0", "state_in_1"):
                seq[k] = frag[k][start] if stored else np.zeros(CELL, np.float32)
            seqs.append(seq)
    return {k: np.stack([s[k] for s in seqs]) for k in seqs[0]}


def _r2d2_pair(burn_in, h=True):
    cfg = {**{k: v for k, v in jr2d2.R2D2Config().to_dict().items() if k != "env"},
           "model": MODEL, "train_batch_size": NSEQ, "replay_sequence_length": T,
           "replay_burn_in": burn_in, "lr": 3e-3, "gamma": 0.95, "use_h_function": h, "seed": 2}
    obs_space = gym.spaces.Box(-1, 1, (4,), np.float32)
    ref = jr2d2.R2D2JaxPolicy(obs_space, gym.spaces.Discrete(2), {**cfg, "_mesh": _one_shard()})
    # one learn first: a target unlike the online net, Adam counts past 1
    ref.learn_on_batch(JSampleBatch(_seq_batch(True, seed=50)))
    port = R2D2TorchPolicy(Box(-1, 1, (4,), np.float32), Discrete(2), cfg, device="cpu")
    from_jax_r2d2_state(port, jax.device_get(ref.params), jax.device_get(ref.aux_state),
                        jax.device_get(ref.opt_state))
    return ref, port


def _reference_perm(key, n):
    _, rng = jax.random.split(key)
    rng = jax.random.fold_in(rng, 0)
    (r,) = jax.random.split(rng, 1)
    return torch.as_tensor(np.array(jax.random.permutation(jax.random.split(r)[0], n)))[None]


CASES = [(False, 0, True), (True, 0, True), (True, 3, True), (False, 2, False)]


@pytest.mark.parametrize("stored,burn_in,h", CASES)
def test_r2d2_loss_matches_reference(stored, burn_in, h):
    ref, port = _r2d2_pair(burn_in, h)
    b = _seq_batch(stored, seed=7)
    jb = ref._batch_to_train_tree(JSampleBatch(dict(b)))
    loss, stats = ref.loss_with_aux(ref.params, ref.aux_state, jax.tree_util.tree_map(
        jnp.asarray, jb), jax.random.PRNGKey(0), ref._learn_coeffs())
    tb = {k: torch.as_tensor(v) for k, v in port._batch_to_train_tree(SampleBatch(dict(b))).items()}
    ploss, pstats = port.loss_with_aux(tb, port.aux_state, port._load_coeffs())
    np.testing.assert_allclose(float(ploss.detach()), float(loss), rtol=1e-5, atol=1e-6)
    assert set(pstats) == set(stats)
    for k, v in stats.items():
        np.testing.assert_allclose(float(pstats[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("stored,burn_in,h", CASES)
def test_r2d2_one_learn_matches_reference(stored, burn_in, h):
    ref, port = _r2d2_pair(burn_in, h)
    b = _seq_batch(stored, seed=11)
    perm = _reference_perm(ref._rng, NSEQ)
    ref_stats = ref.learn_on_batch(JSampleBatch(dict(b)))
    stats = port.learn_on_batch(SampleBatch(dict(b)), perms=perm)
    assert set(stats) == set(ref_stats)
    for k, v in ref_stats.items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    want = flax_to_state_dict(jax.device_get(ref.params))
    got = port.get_weights()
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=RTOL, atol=ATOL, err_msg=name)
    count, mu, nu = from_jax_adam_state(jax.device_get(ref.opt_state))
    st = port.get_state()["opt_state"]
    assert st["count"] == count == 2
    for name in want:
        np.testing.assert_allclose(st["mu"][name], mu[name], rtol=RTOL, atol=ATOL, err_msg=name)
        np.testing.assert_allclose(st["nu"][name], nu[name], rtol=RTOL, atol=ATOL, err_msg=name)
    target = flax_to_state_dict(jax.device_get(ref.aux_state["target_params"]))
    for name, t in zip(port.param_names, port.aux_state["target_params"]):
        np.testing.assert_array_equal(t.numpy(), target[name])


def test_dqn_still_refuses_a_recurrent_model():
    with pytest.raises(ValueError, match="R2D2.*ported"):
        DQNTorchPolicy(Box(-1, 1, (4,), np.float32), Discrete(2), {"model": MODEL}, device="cpu")


# -- SimpleQ ------------------------------------------------------------------------------


def test_simple_q_config_and_update_match_reference():
    got, want = SimpleQConfig().to_dict(), JSimpleQConfig().to_dict()
    for key in ("double_q", "dueling", "n_step", "lr", "train_batch_size", "grad_clip",
                "target_network_update_freq", "num_steps_sampled_before_learning_starts"):
        assert got[key] == want[key], key
    n, obs = 16, 6
    cfg = {**{k: v for k, v in want.items() if k != "env"}, "train_batch_size": n,
           "model": {"fcnet_hiddens": [32, 32], "fcnet_activation": "tanh"}, "seed": 3}
    space = gym.spaces.Box(-1, 1, (obs,), np.float32)
    ref = DQNJaxPolicy(space, gym.spaces.Discrete(3), {**cfg, "_mesh": _one_shard()})
    other = DQNJaxPolicy(space, gym.spaces.Discrete(3), {**cfg, "seed": 8, "_mesh": _one_shard()})
    ref.aux_state = {"target_params": other.params}
    port = DQNTorchPolicy(Box(-1, 1, (obs,), np.float32), Discrete(3), cfg, device="cpu")
    from_jax_params(jax.device_get(ref.params), port.model)
    from_jax_dqn_target(port, {"target_params": jax.device_get(other.params)})
    assert "value_head.weight" not in port.param_names  # dueling off
    rng = np.random.default_rng(0)
    batch = {
        "obs": rng.standard_normal((n, obs)).astype(np.float32),
        "new_obs": rng.standard_normal((n, obs)).astype(np.float32),
        "actions": rng.integers(0, 3, n).astype(np.int32),
        "rewards": rng.standard_normal(n).astype(np.float32),
        "dones": rng.random(n) < 0.25,
    }
    perm = _reference_perm(ref._rng, n)
    ref_stats = ref.learn_on_batch(JSampleBatch(dict(batch)))
    stats = port.learn_on_batch(batch, perms=perm)
    assert set(stats) == set(ref_stats)
    for k, v in ref_stats.items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    got_w = port.get_weights()
    for name, r in flax_to_state_dict(jax.device_get(ref.params)).items():
        np.testing.assert_allclose(got_w[name], r, rtol=1e-5, atol=1.5e-5, err_msg=name)
    np.testing.assert_allclose(port.compute_td_error(batch),
                               ref.compute_td_error(JSampleBatch(dict(batch))), rtol=1e-5, atol=1e-5)


def test_simple_q_trains_on_cartpole():
    algo = (SimpleQConfig().environment("CartPole-v1")
            .rollouts(rollout_fragment_length=8, num_envs_per_worker=2)
            .training(train_batch_size=32, num_steps_sampled_before_learning_starts=64,
                      target_network_update_freq=64,
                      replay_buffer_config={"capacity": 1000, "prioritized_replay": True},
                      model={"fcnet_hiddens": [16]})
            .debugging(seed=0).resources(device="cpu").build())
    try:
        for _ in range(12):
            result = algo.train()
        assert type(algo).__name__ == "SimpleQ"
        assert np.isfinite(result["info"]["learner"]["default_policy"]["mean_td_error"])
        assert algo._counters["num_target_updates"] >= 1
        assert algo.get_policy().config["double_q"] is False
    finally:
        algo.stop()


# -- R2D2.train() ---------------------------------------------------------------------------


@pytest.mark.parametrize("zero_init", [True, False])
def test_r2d2_trains_through_target_updates(zero_init):
    algo = (R2D2Config().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, rollout_fragment_length=20)
            .training(train_batch_size=8, replay_sequence_length=10, replay_burn_in=2,
                      num_steps_sampled_before_learning_starts=100, target_network_update_freq=64,
                      zero_init_states=zero_init, model={"use_lstm": True, "lstm_cell_size": 16})
            .debugging(seed=0).resources(device="cpu").build())
    try:
        assert algo.get_policy().model.is_recurrent
        while algo._counters.get("num_env_steps_trained", 0) < 160:
            result = algo.train()
        info = result["info"]["learner"]["default_policy"]
        assert np.isfinite(info["mean_td_error"])
        assert len(algo.seq_buffer) > 0 and algo._counters["num_target_updates"] >= 2
        starts = np.stack([s["state_in_0"] for s in algo.seq_buffer._storage])
        # zero-init sequences start from zeros; stored ones from the
        # sampler's carried states (zero only at a fragment's episode start)
        assert (np.abs(starts).sum() == 0) == zero_init
    finally:
        algo.stop()


@pytest.mark.slow
def test_cartpole_r2d2_yaml_runs():
    algo, _ = build_tuned_example(REPO / "tuned_examples" / "r2d2" / "cartpole-r2d2.yaml",
                                  device="cpu")
    best, deadline = -np.inf, time.time() + 60
    try:
        while time.time() < deadline:
            r = algo.train().get("episode_reward_mean", np.nan)
            if np.isfinite(r):
                best = max(best, r)
    finally:
        algo.stop()
    assert np.isfinite(best) and algo._counters["num_target_updates"] >= 1
