"""ES and ARS of the port against the reference's, on the CPU.

Contracts, all bitwise (host numpy, the reference's code):

- the noise table (its seed's draws, slices, index draws) and the
  centered ranks (ties, shapes);
- the flat parameter vector: the reference's ``ravel_pytree`` order of
  the catalog model's flax tree (``FlatParams``), both ways, so one
  theta means the same weights (the greedy actions of the card policy's
  port, the CPU engine and the reference's engine agree on it);
- ``_FlatAdam`` over several steps;
- ES's and ARS's updates (``_apply_results``) on given indices and
  returns, run through both packages' methods on stand-in drivers:
  theta, the optimizer's moments and the reported stats;
- ``from_jax_es_state``: a reference driver's theta, optimizer and
  filter carried into a port ES;
- the port's ES and ARS with two ES actors (one runtime a module): an
  iteration's theta equals a numpy recomputation from the indices and
  returns it gathered, both floors hold (``episodes_per_batch`` and
  ``train_batch_size``), ARS's ``num_rollouts`` rounds up to whole
  per-worker quotas, and a checkpoint round-trips theta, optimizer and
  filter (``tests/test_es.py``'s cases).
"""

from __future__ import annotations

import copy
from types import SimpleNamespace

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

from ray_tpu.algorithms.es import es as jes
from ray_tpu.sharding import get_mesh
from ray_tpu.utils.filter import MeanStdFilter as JMeanStdFilter
from ray_tpu_torch import core
from ray_tpu_torch.algorithms.es import es
from ray_tpu_torch.algorithms.es.es import ARSConfig, ESConfig, ESTorchPolicy, FlatParams
from ray_tpu_torch.env.spaces import Box, Discrete
from ray_tpu_torch.utils.jax_params import from_jax_es_state, from_jax_params

MODEL = {"fcnet_hiddens": [16, 8], "fcnet_activation": "tanh"}


@pytest.fixture(scope="module", autouse=True)
def _runtime():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    core.shutdown()  # a runtime an earlier module left up
    core.init(num_cpus=2)
    yield
    core.shutdown()
    torch.set_num_threads(before)


def test_noise_table_and_ranks_bitwise():
    for count, seed in ((1000, 7), (50_000, 42)):
        a, b = es.SharedNoiseTable(count, seed), jes.SharedNoiseTable(count, seed)
        np.testing.assert_array_equal(a.noise, b.noise)
        assert a.noise.dtype == np.float32
        np.testing.assert_array_equal(a.get(17, 33), b.get(17, 33))
        ra, rb = np.random.RandomState(3), np.random.RandomState(3)
        assert [a.sample_index(ra, 100) for _ in range(20)] == [
            b.sample_index(rb, 100) for _ in range(20)]
    rng = np.random.default_rng(0)
    for x in (np.array([[1.0, 5.0], [3.0, 2.0]]), rng.standard_normal((9, 2)),
              rng.integers(0, 4, (12, 2)).astype(np.float32), rng.standard_normal(7)):
        got, want = es.compute_centered_ranks(x), jes.compute_centered_ranks(x)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    r = es.compute_centered_ranks(np.array([[1.0, 5.0], [3.0, 2.0]]))
    assert r.min() == -0.5 and r.max() == 0.5 and r[0, 1] == 0.5


def _policies():
    space_j = gym.spaces.Box(-np.inf, np.inf, (4,), np.float32)
    ref = jes.ESJaxPolicy(space_j, gym.spaces.Discrete(2),
                          {"model": MODEL, "seed": 1, "_mesh": get_mesh(devices=jax.devices()[:1])})
    port = ESTorchPolicy(Box(-np.inf, np.inf, (4,), np.float32), Discrete(2), {"model": MODEL},
                         device="cpu")
    from_jax_params(jax.device_get(ref.params), port.model)
    return ref, port


def test_flat_vector_is_the_reference_ravel_order():
    ref, port = _policies()
    flat = ref.get_flat_weights()
    np.testing.assert_array_equal(port.get_flat_weights(), flat)
    theta = np.random.default_rng(5).standard_normal(flat.size).astype(np.float32) * 0.3
    ref.set_flat_weights(theta)
    port.set_flat_weights(theta)
    np.testing.assert_array_equal(port.get_flat_weights(), theta)
    np.testing.assert_array_equal(ref.get_flat_weights(), theta)
    obs = np.random.default_rng(6).standard_normal((64, 4)).astype(np.float32)
    a, _, _ = port.compute_actions(obs, explore=False)
    ra, _, _ = ref.compute_actions(obs, explore=False)
    np.testing.assert_array_equal(a, ra)
    # the CPU engine and the reference's engine, greedy on the same theta
    engine = es._RolloutEngine({"model": MODEL}, "CartPole-v1")
    ref_engine = jes._RolloutEngine({"model": MODEL}, "CartPole-v1")
    assert engine.num_params == ref_engine.num_params == theta.size
    engine.flat.set(theta)
    params = ref_engine._unravel(theta)
    np.testing.assert_array_equal(engine.act(obs), a)
    np.testing.assert_array_equal(
        np.array([int(ref_engine._act(params, o)) for o in obs[:16]]), a[:16])
    ret, steps = engine.rollout(theta)
    assert steps >= 1 and ret == float(steps)  # CartPole pays 1 a step


def test_flat_params_conv_layout():
    """A conv kernel goes out as HWIO and back."""
    conv = torch.nn.Conv2d(2, 3, (4, 5))
    flat = FlatParams(conv)
    assert flat.paths == [("bias",), ("kernel",)]
    v = flat.get()
    np.testing.assert_array_equal(v[3:].reshape(4, 5, 2, 3),
                                  conv.weight.detach().numpy().transpose(2, 3, 1, 0))
    flat.set(v * 2)
    np.testing.assert_array_equal(flat.get(), v * 2)


def test_flat_adam_bitwise():
    rng = np.random.default_rng(0)
    a, b = es._FlatAdam(50, 0.05), jes._FlatAdam(50, 0.05)
    ta = tb = rng.standard_normal(50).astype(np.float32)
    for _ in range(5):
        g = rng.standard_normal(50).astype(np.float32)
        ta, tb = a.update(ta, g), b.update(tb, g)
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(a.m, b.m)
        np.testing.assert_array_equal(a.v, b.v)
    assert a.t == b.t == 5


def _stand_in(module, cfg, theta, noise):
    policy = SimpleNamespace(set_flat_weights=lambda v: None)
    return SimpleNamespace(config=cfg, _theta=theta.copy(), noise=noise,
                           _optimizer=module._FlatAdam(theta.size, cfg.get("stepsize", 0.01)),
                           get_policy=lambda: policy)


@pytest.mark.parametrize("algo", ["ES", "ARS"])
def test_updates_from_given_returns_bitwise(algo):
    dim = 60
    noise = es.SharedNoiseTable(5000, 42)
    rng = np.random.default_rng(1)
    theta = rng.standard_normal(dim).astype(np.float32)
    cfg = {"noise_stdev": 0.05, "stepsize": 0.05, "l2_coeff": 0.005, "rollouts_used": 5,
           "sgd_stepsize": 0.05}
    port_cls, ref_cls = (es.ES, jes.ES) if algo == "ES" else (es.ARS, jes.ARS)
    port, ref = _stand_in(es, cfg, theta, noise), _stand_in(jes, cfg, theta, noise)
    for it in range(3):
        agg = {"indices": [int(i) for i in rng.integers(0, 5000 - dim, 8)],
               "pos": list(rng.integers(10, 200, 8).astype(float)),
               "neg": list(rng.integers(10, 200, 8).astype(float)), "steps": 0}
        got = port_cls._apply_results(port, copy.deepcopy(agg))
        want = ref_cls._apply_results(ref, copy.deepcopy(agg))
        np.testing.assert_array_equal(port._theta, ref._theta)
        assert port._theta.dtype == ref._theta.dtype
        assert got == want
        if algo == "ES":
            np.testing.assert_array_equal(port._optimizer.m, ref._optimizer.m)
            np.testing.assert_array_equal(port._optimizer.v, ref._optimizer.v)


def _es(cls, **training):
    training.setdefault("episodes_per_batch", 8)
    training.setdefault("noise_size", 500_000)
    training.setdefault("train_batch_size", 100)
    return (cls().environment("CartPole-v1").rollouts(num_rollout_workers=2)
            .training(model=MODEL, **training).debugging(seed=0).resources(device="cpu"))


def _recompute(algo, agg, theta0, opt0):
    """The driver's update, recomputed in numpy from what the iteration
    gathered (its indices and returns)."""
    cfg = algo.config
    stdev = float(cfg["noise_stdev"])
    rows = np.stack([algo.noise.get(i, theta0.size) for i in agg["indices"]])
    pos, neg = np.asarray(agg["pos"], np.float32), np.asarray(agg["neg"], np.float32)
    if isinstance(algo, es.ARS):
        k = min(int(cfg["rollouts_used"]), len(pos))
        order = np.argsort(-np.maximum(pos, neg))[:k]
        std = max(float(np.concatenate([pos[order], neg[order]]).std()), 1e-6)
        grad = (pos[order] - neg[order]) @ rows[order] / (k * std)
        return theta0 + float(cfg["sgd_stepsize"]) * grad
    ranks = es.compute_centered_ranks(np.stack([pos, neg], axis=1))
    grad = (ranks[:, 0] - ranks[:, 1]) @ rows / (len(pos) * stdev)
    return opt0.update(theta0, -grad + float(cfg["l2_coeff"]) * theta0)


@pytest.mark.parametrize("cls", [ESConfig, ARSConfig])
def test_iteration_matches_numpy_recomputation(cls):
    over = {"num_rollouts": 3, "rollouts_used": 2, "sgd_stepsize": 0.05} if cls is ARSConfig else {}
    algo = _es(cls, noise_stdev=0.05, stepsize=0.05, train_batch_size=400, **over).build()
    try:
        for _ in range(2):
            theta0, opt0 = algo._theta.copy(), copy.deepcopy(algo._optimizer)
            result = algo.train()
            agg = algo.last_iteration
            np.testing.assert_array_equal(algo._theta, _recompute(algo, agg, theta0, opt0))
            # the policy holds float32 weights; ES's Adam step leaves theta
            # float64, as the reference's does
            np.testing.assert_array_equal(algo.get_policy().get_flat_weights(),
                                          algo._theta.astype(np.float32))
            info = result["info"]["learner"]
            assert agg["steps"] >= 400  # the timestep floor
            if cls is ARSConfig:
                # 3 pairs a round, rounded up to whole per-worker quotas
                assert len(agg["indices"]) >= 3 and info["reward_std"] > 0
            else:
                assert len(agg["indices"]) >= 4  # the episode floor: 8 episodes
            assert result["episodes_this_iter"] == 2 * len(agg["indices"])
            assert np.isfinite(result["episode_reward_mean"])
        # the learned normalization where checkpoints and evaluation read it
        lw = algo.workers.local_worker().filters["default_policy"]
        np.testing.assert_array_equal(lw.rs.mean, algo._filter.rs.mean)
    finally:
        algo.stop()


def test_checkpoint_round_trip_and_reference_state(tmp_path):
    cfg = _es(ESConfig, noise_stdev=0.05, stepsize=0.05)
    algo = cfg.build()
    try:
        algo.train()
        theta, t_opt = algo._theta.copy(), algo._optimizer.t
        path = algo.save(str(tmp_path))
    finally:
        algo.stop()
    algo2 = cfg.build()
    try:
        algo2.restore(path)
        # a restore casts theta to float32, as the reference's does
        np.testing.assert_array_equal(algo2._theta, theta.astype(np.float32))
        np.testing.assert_array_equal(algo2.get_policy().get_flat_weights(),
                                      theta.astype(np.float32))
        assert algo2._optimizer.t == t_opt and algo2._filter.rs.n > 0
        # a reference driver's state: theta, its _FlatAdam and its filter
        ref_opt = jes._FlatAdam(theta.size, 0.05)
        rng = np.random.default_rng(2)
        ref_theta = ref_opt.update(theta, rng.standard_normal(theta.size).astype(np.float32))
        filt = JMeanStdFilter((4,))
        for _ in range(5):
            filt(rng.standard_normal(4))
        from_jax_es_state(algo2, {"theta": ref_theta, "optimizer": dict(ref_opt.__dict__),
                                  "filter": filt.as_serializable()})
        np.testing.assert_array_equal(algo2.get_policy().get_flat_weights(),
                                      ref_theta.astype(np.float32))
        np.testing.assert_array_equal(algo2._optimizer.m, ref_opt.m)
        assert algo2._optimizer.t == 1 and algo2._filter.rs.n == 5
        np.testing.assert_array_equal(algo2._filter.rs.mean, filt.rs.mean)
    finally:
        algo2.stop()
