"""PG, A2C and A3C of the port against the reference's, on the CPU.

Contracts (the port's learn contract: 1e-5 relative plus 1.5e-5
absolute):

- PG's and A2C's loss on one batch, and one ``learn_on_batch`` from the
  reference's weights with the reference's permutation injected: stats,
  parameters and Adam moments within the contract;
- A3C's gradient API: ``RolloutWorker.compute_gradients`` (the worker's
  default policy) against the reference's ``compute_gradients`` on the
  same batch, and ``apply_gradients`` of the reference's gradients on
  the learner against the reference's ``apply_gradients`` (its optax
  chain, clip included, then ``-lr``): parameters and Adam state within
  the contract, twice in a row;
- the configs: PG's and A2C's defaults equal the reference's, A2C's
  ``to_dict`` spells ``lambda``, and ``microbatch_size`` is refused, as
  is ``env_backend: "jax"`` (no rollout workers for the step);
- ``A2C.train()`` gives a finite ``total_loss`` (the reference's
  ``tests/test_offpolicy.py`` case), PG's and A2C's postprocessing the
  reference's advantages bitwise;
- A3C with two remote workers: gradients of both workers applied, one
  call in flight a worker, the workers' weights synced after each step.

``-m slow`` runs ``cartpole-pg.yaml`` to the reference test's bar (80,
``tests/test_algorithms_extra.py``).
"""

from __future__ import annotations

import pathlib
import time

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

from ray_tpu.algorithms.a2c.a2c import A2CConfig as JA2CConfig
from ray_tpu.algorithms.a2c.a2c import A2CJaxPolicy
from ray_tpu.algorithms.pg.pg import PGConfig as JPGConfig
from ray_tpu.algorithms.pg.pg import PGJaxPolicy
from ray_tpu.data.sample_batch import SampleBatch as JSampleBatch
from ray_tpu.sharding import get_mesh
from ray_tpu_torch import core
from ray_tpu_torch.algorithms.a2c.a2c import A2CConfig, A2CTorchPolicy, A3CConfig
from ray_tpu_torch.algorithms.pg.pg import PGConfig, PGTorchPolicy
from ray_tpu_torch.data.sample_batch import SampleBatch
from ray_tpu_torch.env.spaces import Box, Discrete
from ray_tpu_torch.utils.jax_params import (
    flax_to_state_dict,
    from_jax_adam_state,
    from_jax_params,
)
from ray_tpu_torch.utils.tuned_example import build_tuned_example

REPO = pathlib.Path(__file__).resolve().parents[1]
B, OBS, A = 32, 4, 2  # CartPole-v1's spaces (the gradient test's worker)
RTOL, ATOL = 1e-5, 1.5e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    if core.is_initialized():
        core.shutdown()


def _batch(seed=0, n=B):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.standard_normal((n, OBS)).astype(np.float32),
        "actions": rng.integers(0, A, n).astype(np.int64),
        "advantages": rng.standard_normal(n).astype(np.float32),
        "value_targets": (rng.standard_normal(n) * 3).astype(np.float32),
    }


CONFIG = {"train_batch_size": B, "lr": 3e-3, "entropy_coeff": 0.02, "seed": 5,
          "model": {"fcnet_hiddens": [16, 16]}}
KINDS = {
    "PG": (PGJaxPolicy, PGTorchPolicy, JPGConfig, PGConfig, {}),
    "A2C": (A2CJaxPolicy, A2CTorchPolicy, JA2CConfig, A2CConfig,
            {"vf_loss_coeff": 0.7, "grad_clip": 0.5}),
}


def _pair(kind):
    jcls, tcls, jcfg, tcfg, extra = KINDS[kind]
    cfg = {**{k: v for k, v in jcfg().to_dict().items() if k != "env"}, **CONFIG, **extra}
    ref = jcls(gym.spaces.Box(-1, 1, (OBS,), np.float32), gym.spaces.Discrete(A),
               {**cfg, "_mesh": get_mesh(devices=jax.devices()[:1])})
    port = tcls(Box(-1, 1, (OBS,), np.float32), Discrete(A), cfg, device="cpu")
    from_jax_params(jax.device_get(ref.params), port.model)
    return ref, port


def _reference_perm(key):
    """The permutation of ``JaxPolicy``'s one-epoch nest on shard 0 (as
    ``tests/test_torch_ppo.py`` derives it)."""
    _, rng = jax.random.split(key)
    rng = jax.random.fold_in(rng, 0)
    (r,) = jax.random.split(rng, 1)
    return torch.as_tensor(np.array(jax.random.permutation(jax.random.split(r)[0], B)))[None]


def _close_params(port, ref):
    got = port.get_weights()
    want = flax_to_state_dict(jax.device_get(ref.params))
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=RTOL, atol=ATOL, err_msg=name)
    count, mu, nu = from_jax_adam_state(jax.device_get(ref.opt_state))
    st = port.get_state()["opt_state"]
    assert st["count"] == count
    for name in want:
        np.testing.assert_allclose(st["mu"][name], mu[name], rtol=RTOL, atol=ATOL, err_msg=name)
        np.testing.assert_allclose(st["nu"][name], nu[name], rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_loss_matches_reference(kind):
    ref, port = _pair(kind)
    b = _batch(1)
    jb = {k: jax.numpy.asarray(v) for k, v in b.items()}
    total, stats = ref.loss(ref.params, jb, jax.random.PRNGKey(0), ref._learn_coeffs())
    pt, pstats = port.loss({k: torch.as_tensor(v) for k, v in b.items()}, port._load_coeffs())
    np.testing.assert_allclose(float(pt.detach()), float(total), rtol=RTOL, atol=ATOL)
    assert set(pstats) == set(stats)
    for k, v in stats.items():
        np.testing.assert_allclose(float(pstats[k]), float(v), rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_one_learn_matches_reference(kind):
    ref, port = _pair(kind)
    perm = _reference_perm(ref._rng)
    b = _batch(2)
    ref_stats = ref.learn_on_batch(dict(b))
    stats = port.learn_on_batch(SampleBatch(dict(b)), perms=perm)
    assert set(stats) == set(ref_stats)
    for k, v in ref_stats.items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-4, atol=ATOL, err_msg=k)
    _close_params(port, ref)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_postprocessing_matches_reference(kind):
    ref, port = _pair(kind)
    rng = np.random.default_rng(4)
    for terminated in (True, False):
        n = 11
        ep = {
            "obs": rng.standard_normal((n, OBS)).astype(np.float32),
            "new_obs": rng.standard_normal((n, OBS)).astype(np.float32),
            "actions": rng.integers(0, A, n),
            "rewards": rng.standard_normal(n).astype(np.float32),
            "dones": np.arange(n) == n - 1 if terminated else np.zeros(n, bool),
            "truncateds": np.zeros(n, bool),
            "vf_preds": rng.standard_normal(n).astype(np.float32),
            "eps_id": np.zeros(n, np.int64),
        }
        want = ref.postprocess_trajectory(JSampleBatch(dict(ep)))
        got = port.postprocess_trajectory(SampleBatch(dict(ep)))
        for col in ("advantages", "value_targets"):
            # bitwise where the tail terminated; the bootstrap is a model
            # forward in each framework
            if terminated:
                np.testing.assert_array_equal(got[col], want[col])
            else:
                np.testing.assert_allclose(got[col], want[col], rtol=1e-6, atol=1e-6)


def test_gradient_api_matches_reference():
    """A3C's path: the worker's gradients, then two applied steps."""
    ref, port = _pair("A2C")
    algo = (A3CConfig().environment("CartPole-v1")
            .training(**{k: v for k, v in CONFIG.items() if k != "seed"}, vf_loss_coeff=0.7,
                      grad_clip=0.5)
            .debugging(seed=5).resources(device="cpu").build())
    try:
        worker = algo.workers.local_worker()
        policy = algo.get_policy()
        for _ in range(2):
            policy.set_state(port.get_state())  # the learner = the port pair's state
            b = _batch(3)
            grads, info = worker.compute_gradients(SampleBatch(dict(b)))
            rgrads, rinfo = ref.compute_gradients(JSampleBatch(dict(b)))
            want = flax_to_state_dict(rgrads)
            assert set(grads) == set(want)
            for name, g in want.items():
                np.testing.assert_allclose(grads[name], g, rtol=RTOL, atol=ATOL, err_msg=name)
            for k, v in rinfo.items():
                np.testing.assert_allclose(info[k], v, rtol=1e-4, atol=ATOL, err_msg=k)
            ref.apply_gradients(rgrads)
            worker.apply_gradients(want)
            port.set_state(policy.get_state())
            _close_params(policy, ref)
        assert policy.opt_state.count == 2
    finally:
        algo.stop()


def test_configs_match_reference():
    for port_cls, ref_cls in ((PGConfig, JPGConfig), (A2CConfig, JA2CConfig)):
        got, want = port_cls().to_dict(), ref_cls().to_dict()
        for key in ("lr", "train_batch_size", "num_sgd_iter", "use_gae", "use_critic",
                    "rollout_fragment_length", "vf_loss_coeff", "entropy_coeff", "grad_clip",
                    "lambda", "microbatch_size"):
            if key in want:
                assert got[key] == want[key], key
    assert "lambda" in A2CConfig().training(lambda_=0.9).to_dict()
    with pytest.raises(ValueError, match="microbatch_size"):
        A2CConfig().environment("CartPole-v1").training(microbatch_size=8).resources(
            device="cpu").build()
    # the device lane builds no rollout workers for their training step
    algo = PGConfig().environment("CartPoleJax-v0", env_backend="jax").resources(
        device="cpu").build()
    try:
        with pytest.raises(NotImplementedError, match="actor lane"):
            algo.train()
    finally:
        algo.stop()


@pytest.mark.parametrize("cfg_cls", [PGConfig, A2CConfig])
def test_train_step_is_finite(cfg_cls):
    algo = (cfg_cls().environment("CartPole-v1").rollouts(rollout_fragment_length=32)
            .training(train_batch_size=128).debugging(seed=0).resources(device="cpu").build())
    try:
        result = algo.train()
        info = result["info"]["learner"]["default_policy"]
        assert np.isfinite(info["total_loss"])
        assert result["timesteps_total"] >= 128
        assert algo._counters["num_env_steps_trained"] == result["timesteps_total"]
    finally:
        algo.stop()


def test_a3c_two_remote_workers():
    core.shutdown()  # a runtime an earlier module left up
    core.init(num_cpus=2)
    algo = (A3CConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=2, rollout_fragment_length=16)
            .training(model={"fcnet_hiddens": [16]}).debugging(seed=0)
            .resources(device="cpu").build())
    try:
        w0 = {k: v.copy() for k, v in algo.get_policy().get_weights().items()}
        for _ in range(8):
            result = algo.train()
            assert len(algo._grad_refs) == 2  # one call in flight a worker
        assert set(algo.grads_applied) == {1, 2}, algo.grads_applied
        assert sum(algo.grads_applied.values()) == algo._counters["num_grads_applied"] >= 8
        assert np.isfinite(result["info"]["learner"]["default_policy"]["total_loss"])
        learner = algo.get_policy().get_weights()
        assert any(not np.array_equal(learner[k], w0[k]) for k in w0)
        # the weights the workers hold are the learner's (each worker's
        # queue runs its set_weights before its next call)
        remote = core.get([w.get_weights.remote() for w in algo.workers.remote_workers()],
                          timeout=120)
        for k, v in learner.items():
            for r in remote:
                np.testing.assert_array_equal(r["default_policy"][k], v)
    finally:
        algo.stop()
        core.shutdown()


@pytest.mark.slow
def test_cartpole_pg_yaml_reaches_reference_bar():
    algo, _ = build_tuned_example(REPO / "tuned_examples" / "pg" / "cartpole-pg.yaml",
                                  device="cpu")
    best, deadline = -np.inf, time.time() + 240
    try:
        while time.time() < deadline and best < 80.0:
            r = algo.train().get("episode_reward_mean", np.nan)
            if np.isfinite(r):
                best = max(best, r)
    finally:
        algo.stop()
    assert best >= 80.0, best
