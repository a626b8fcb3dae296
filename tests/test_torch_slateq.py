"""SlateQ of the port against the reference's, on the CPU.

Contracts:

- ``SyntheticSlate-v0`` (``env/synthetic_slate.py``): spaces, and a
  seeded rollout across the horizon's truncation and a reset, bitwise the
  reference's ``SyntheticSlateEnv`` (observations, rewards, flags);
- the (A, S) slate table bitwise (90 ordered slates at 10 candidates);
- the fixed proportional scorer (``score_documents``) within 1e-6;
- ``_slate_values`` within 1e-6 relative (plus 1e-7), the greedy slates
  equal, and the exploring slates equal under the reference's
  ``jax.random`` draws injected;
- one learn, then a second, from the reference's weights with a target
  unlike the online net and two learning rates (``lr`` for ``q``,
  ``lr_choice_model`` for ``choice``): every parameter, the target and
  both Adam states' moments within the learn contract (1e-5 relative +
  1.5e-5), the counts equal, the stats within 1e-4 relative;
  ``compute_td_error`` within 1e-5; the state round trip;
- the refusals (``n_step != 1``, ``lr_schedule``, ``env_backend="jax"``)
  and ``synthetic-slateq.yaml`` training on DQN's actor lane and device
  rings (four replay columns), which the reference's SlateQ fails on (its
  policy reads 8 candidates from the config, the env shows 10).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from ray_tpu.algorithms.slateq.slateq import SlateQJaxPolicy, _score_documents
from ray_tpu.algorithms.slateq.slateq import SyntheticSlateEnv as JSyntheticSlateEnv
from ray_tpu.data.sample_batch import SampleBatch as JSampleBatch
from ray_tpu.sharding import get_mesh
from ray_tpu_torch.algorithms.slateq.slateq import (
    SlateQConfig,
    SlateQTorchPolicy,
    score_documents,
)
from ray_tpu_torch.data.sample_batch import SampleBatch
from ray_tpu_torch.env.registry import get_env_creator
from ray_tpu_torch.env.synthetic_slate import SyntheticSlateEnv
from ray_tpu_torch.utils.jax_params import _slateq_group, from_jax_slateq_state
from ray_tpu_torch.utils.tuned_example import build_tuned_example

RTOL, ATOL = 1e-5, 1.5e-5  # the learn contract
ENV = {"num_candidates": 10, "slate_size": 2, "embedding_dim": 4}
B = 32


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def test_env_rollout_bitwise():
    ref = JSyntheticSlateEnv({**ENV, "seed": 3})
    port = get_env_creator("SyntheticSlate-v0")({**ENV, "seed": 3})
    assert isinstance(port, SyntheticSlateEnv)
    assert port.observation_space.shape == ref.observation_space.shape == (48,)
    assert list(port.action_space.nvec) == list(ref.action_space.nvec) == [10, 10]
    assert np.array_equal(port.reset(seed=5)[0], ref.reset(seed=5)[0])
    acts = np.random.default_rng(0)
    for t in range(45):  # the 20-step horizon twice, and a reset without a seed
        a = acts.choice(10, 2, replace=False)
        got, want = port.step(a), ref.step(a)
        assert np.array_equal(got[0], want[0]) and got[0].dtype == np.float32
        assert got[1:4] == want[1:4], t
        if got[3]:
            assert np.array_equal(port.reset()[0], ref.reset()[0])


def _policies(**over):
    env = JSyntheticSlateEnv(ENV)
    cfg = {**ENV, "hiddens": [16, 16], "seed": 1, "lr": 2e-3, "lr_choice_model": 5e-3,
           "gamma": 0.9, **over}
    ref = SlateQJaxPolicy(env.observation_space, env.action_space,
                          {**cfg, "_mesh": get_mesh(devices=jax.devices()[:1])})
    other = SlateQJaxPolicy(env.observation_space, env.action_space,
                            {**cfg, "seed": 8, "_mesh": get_mesh(devices=jax.devices()[:1])})
    ref.aux_state = {"target_params": other.params["q"]}  # a target unlike the online net
    port_env = SyntheticSlateEnv(ENV)
    port = SlateQTorchPolicy(port_env.observation_space, port_env.action_space, cfg,
                             device="cpu")
    from_jax_slateq_state(port, jax.device_get(ref.params), jax.device_get(ref.aux_state),
                          jax.device_get(ref.opt_state))
    return ref, port


def _batch(seed=0, n=B):
    """Rows of a rollout under random slates, a quarter marked terminal."""
    env = SyntheticSlateEnv({**ENV, "seed": seed})
    rng = np.random.default_rng(seed)
    obs, _ = env.reset(seed=seed)
    cols = {"obs": [], "new_obs": [], "actions": [], "dones": []}
    for _ in range(n):
        a = rng.choice(10, 2, replace=False)
        nxt, _, _, _, _ = env.step(a)
        for k, v in zip(cols, (obs, nxt, a, rng.random() < 0.25)):
            cols[k].append(v)
        obs = nxt
    return {k: np.stack(v) for k, v in cols.items()}


def test_slate_table_values_and_actions():
    ref, port = _policies()
    assert port.slates_np.shape == (90, 2)
    assert np.array_equal(port.slates_np, ref.slates) and port.slates_np.dtype == ref.slates.dtype
    rng = np.random.default_rng(2)
    q = rng.standard_normal((6, 10)).astype(np.float32)
    scores = rng.random((6, 10)).astype(np.float32) + 0.1
    no_click = rng.random(6).astype(np.float32)
    want = ref._slate_values(jax.numpy.asarray(q), jax.numpy.asarray(scores),
                             jax.numpy.asarray(no_click))
    got = port._slate_values(torch.tensor(q), torch.tensor(scores), torch.tensor(no_click))
    _close(got, want, "slate values", rtol=1e-6, atol=1e-7)
    user = rng.standard_normal((6, 4)).astype(np.float32)
    docs = rng.standard_normal((6, 10, 4)).astype(np.float32)
    for w, g in zip(_score_documents(jax.numpy.asarray(user), jax.numpy.asarray(docs)),
                    score_documents(torch.tensor(user), torch.tensor(docs))):
        _close(g, w, "fixed scores", rtol=1e-6, atol=1e-6)
    obs = _batch(1)["obs"]
    greedy = port.compute_actions(obs, explore=False)[0]
    assert np.array_equal(greedy, ref.compute_actions(obs, explore=False)[0])
    for who in (ref, port):
        who.global_timestep = 4000  # epsilon 0.6
    for _ in range(3):
        _, rng_key = jax.random.split(ref._rng)
        rng_u, rng_a = jax.random.split(rng_key)
        draws = (np.asarray(jax.random.randint(rng_a, (B,), 0, 90)),
                 np.asarray(jax.random.uniform(rng_u, (B,))))
        want = ref.compute_actions(obs, explore=True)[0]
        got = port.compute_actions(obs, explore=True, draws=draws)[0]
        assert np.array_equal(got, want)
        assert not np.array_equal(want, greedy)


def _state_close(port, ref):
    got = port.get_state()
    for g in ("q", "choice"):
        for n, w in _slateq_group(jax.device_get(ref.params[g]), g).items():
            _close(got["weights"][n], w, n)
        adam = jax.device_get(ref.opt_state).inner_states[g].inner_state[0]
        assert got["opt_state"][g]["count"] == int(adam.count)
        for key in ("mu", "nu"):
            for n, w in _slateq_group(getattr(adam, key)[g], g).items():
                _close(got["opt_state"][g][key][n], w, f"adam {key} {n}")
    target = _slateq_group(jax.device_get(ref.aux_state["target_params"]), "q")
    for n, w in target.items():
        _close(got["target_weights"][n], w, f"target {n}")


def test_learn_with_two_learning_rates_matches_reference():
    ref, port = _policies()
    for seed in (0, 1):
        batch = _batch(seed)
        _close(port.compute_td_error(SampleBatch(dict(batch))),
               ref.compute_td_error(JSampleBatch(dict(batch))), "td error", atol=1e-5)
        want = ref.learn_on_batch(JSampleBatch(dict(batch)))
        got = port.learn_on_batch(SampleBatch(dict(batch)))
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
        _state_close(port, ref)
    # the choice model moved at its own rate
    assert port.get_state()["weights"]["choice.beta"] != 0.0
    ref.update_target()
    port.update_target()
    _state_close(port, ref)
    back = SlateQTorchPolicy(port.observation_space, port.action_space,
                             {**port.config, "seed": 5}, device="cpu")
    back.set_state(port.get_state())
    batch = _batch(2)
    assert back.learn_on_batch(SampleBatch(dict(batch))) == port.learn_on_batch(
        SampleBatch(dict(batch)))


def test_refusals():
    with pytest.raises(ValueError, match="n_step must be 1"):
        SlateQConfig().environment("SyntheticSlate-v0").training(n_step=3).resources(
            device="cpu").build()
    with pytest.raises(ValueError, match="lr_schedule"):
        SlateQConfig().environment("SyntheticSlate-v0").training(
            lr_schedule=[[0, 1e-3], [100, 1e-4]]).resources(device="cpu").build()
    algo = SlateQConfig().environment("SyntheticSlate-v0", env_backend="jax").resources(
        device="cpu").build()
    try:
        with pytest.raises(NotImplementedError, match="actor lane"):
            algo.train()
    finally:
        algo.stop()


def test_tuned_example_trains_on_the_rings():
    algo, stop = build_tuned_example("tuned_examples/slateq/synthetic-slateq.yaml", device="cpu")
    try:
        policy = algo.get_policy()
        assert type(algo).__name__ == "SlateQ" and (policy.E, policy.C, policy.S) == (4, 10, 2)
        for _ in range(32):
            r = algo.train()
        buf = algo.local_replay_buffer.buffers["default_policy"]
        assert sorted(buf._store) == ["actions", "dones", "new_obs", "obs"]
        assert buf._store["obs"].shape[1:] == (48,) and buf._store["actions"].dtype == torch.int32
        c = algo._counters
        assert c["num_env_steps_trained"] > 0 and c["num_target_updates"] >= 1
        stats = r["info"]["learner"]["default_policy"]
        assert all(np.isfinite(v) for v in stats.values()) and stats["choice_beta"] != 0.0
    finally:
        algo.stop()
