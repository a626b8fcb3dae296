"""Evaluation on the port: the evaluation workers, ``evaluate()``,
``results["evaluation"]``, and the evaluate CLI, on the CPU.

Contracts:

- ``evaluate()`` with ``evaluation_num_workers`` 0 and 1 samples until
  at least ``evaluation_duration`` episodes have finished;
- before the evaluation samples, every evaluation worker holds the
  learner's weights and ``MeanStdFilter`` statistics, bitwise;
- ``results["evaluation"]`` appears on exactly the iterations that
  ``evaluation_interval`` names;
- bitwise against the reference: with the reference's initial weights
  carried across and the same injected actions (a fixed function of the
  observation) on seeded gymnasium CartPole, the evaluation's episodes
  (lengths and rewards) and its summary equal the reference's
  ``evaluate()``;
- ``evaluation_interval`` on the device lane (a tensor env) builds the
  evaluation workers over ``TensorVectorEnvAdapter`` and reports
  ``evaluation`` as the actor lane does; the lane's ``input`` still
  raises;
- ``python -m ray_tpu_torch.evaluate`` on a checkpoint made here, with
  ``--config '{"device": "cpu", ...}'``, exits 0 and its last line is
  the reference's JSON.
"""

from __future__ import annotations

import json
import os
import pathlib
import random
import subprocess
import sys

import gymnasium as gym
import numpy as np
import pytest

from _torch_actor_probe import scripted_actions
from ray_tpu.algorithms.ppo import PPOConfig as RefPPOConfig
from ray_tpu.env import registry as ref_registry
from ray_tpu_torch import core
from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig
from ray_tpu_torch.env import registry
from ray_tpu_torch.utils.jax_params import from_jax_policy_weights

REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(train_batch_size=64, sgd_minibatch_size=32, num_sgd_iter=1,
             model={"fcnet_hiddens": [16]})


def _ppo(**evaluation):
    cfg = (PPOConfig().environment("CartPole-v1")
           .rollouts(num_rollout_workers=0, rollout_fragment_length=32)
           .training(**SMALL).evaluation(**evaluation).debugging(seed=0).resources(device="cpu"))
    cfg.observation_filter = "MeanStdFilter"
    return cfg.build()


def _same_tree(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_same_tree(a[k], b[k]) for k in a)
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _filter_stats(f):
    return {"num": np.int64(f.rs.num), "mean": f.rs.mean_, "s": f.rs.s}


class _FirstSample:
    """A remote evaluation worker's handle whose first ``sample.remote()``
    reads the worker's weights and filters first (a worker runs its
    calls in order: these are what ``evaluate()`` sent before it)."""

    def __init__(self, handle):
        self._h = handle
        self.seen = None
        probe = self

        class _Sample:
            @staticmethod
            def remote():
                if probe.seen is None:
                    probe.seen = core.get([handle.get_weights.remote(), handle.get_filters.remote()])
                return handle.sample.remote()

        self.sample = _Sample()

    def __getattr__(self, name):
        return getattr(self._h, name)


@pytest.mark.parametrize("num_eval_workers", [0, 1])
def test_evaluate_syncs_then_samples_the_duration(num_eval_workers):
    if num_eval_workers:
        core.shutdown()
        core.init(num_cpus=1)
    algo = _ppo(evaluation_interval=5, evaluation_duration=4,
                evaluation_num_workers=num_eval_workers)
    try:
        algo.train()
        local = algo.workers.local_worker()
        want_w = local.get_weights()
        want_f = _filter_stats(local.filters["default_policy"])
        assert want_f["num"] > 0
        ev = algo.evaluation_workers
        assert ev.num_remote_workers() == num_eval_workers
        if num_eval_workers:
            probe = _FirstSample(ev.remote_workers()[0])
            ev._remote_workers = [probe]
        else:
            lw, seen = ev.local_worker(), []
            real = lw.sample

            def sample():
                if not seen:
                    seen.append((lw.get_weights(), lw.get_filters()))
                return real()

            lw.sample = sample
        out = algo.evaluate()
        weights, filters = probe.seen if num_eval_workers else seen[0]
        assert _same_tree(weights, want_w)
        assert _same_tree(_filter_stats(filters["default_policy"]), want_f)
        assert out["episodes_this_iter"] >= 4
        assert np.isfinite(out["episode_reward_mean"])
    finally:
        algo.stop()
        if num_eval_workers:
            core.shutdown()


def test_evaluation_lands_on_the_named_iterations():
    algo = _ppo(evaluation_interval=2, evaluation_duration=1)
    try:
        has = ["evaluation" in algo.train() for _ in range(4)]
    finally:
        algo.stop()
    assert has == [False, True, False, True]


def test_evaluation_on_the_device_lane_raises():
    """What the device lane refuses is ``input`` and ``output``; its
    evaluation runs, on the same weights as the learner's."""
    cfg = (PPOConfig().environment("CartPoleJax-v0", env_backend="jax")
           .rollouts(num_envs_per_worker=4, rollout_fragment_length=16)
           .training(train_batch_size=64, sgd_minibatch_size=32, num_sgd_iter=1,
                     model={"fcnet_hiddens": [16]})
           .evaluation(evaluation_interval=1, evaluation_duration=3).resources(device="cpu"))
    algo = cfg.build()
    try:
        result = algo.train()
        lw = algo.evaluation_workers.local_worker()
        assert type(lw.vector_env).__name__ == "TensorVectorEnvAdapter"
        for name, w in lw.policy().get_weights().items():
            assert np.array_equal(w, algo.policy.get_weights()[name]), name
    finally:
        algo.stop()
    assert result["evaluation"]["episodes_this_iter"] >= 3
    assert set(result["evaluation"]) >= {"episode_reward_mean", "episode_len_mean"}
    with pytest.raises(ValueError, match="device lane"):
        cfg.update_from_dict({"input": "/nonexistent"}).build()


# -- the port against the reference ------------------------------------------------------


def _gym_cartpole(cfg):
    return gym.make("CartPole-v1")


def _evaluator(package):
    common = dict(rollout_fragment_length=40, num_envs_per_worker=2)
    training = dict(train_batch_size=80, sgd_minibatch_size=40, num_sgd_iter=1,
                    model={"fcnet_hiddens": [16], "dtype": "float32"})
    evaluation = dict(evaluation_interval=1, evaluation_duration=6)
    random.seed(0)
    if package == "reference":
        ref_registry.register_env("gym_cartpole", _gym_cartpole)
        return (RefPPOConfig().environment("gym_cartpole").rollouts(num_rollout_workers=0, **common)
                .training(**training).evaluation(**evaluation).debugging(seed=6)
                .resources(learner_devices=1).build())
    registry.register_env("gym_cartpole", _gym_cartpole)
    return (PPOConfig().environment("gym_cartpole").rollouts(num_rollout_workers=0, **common)
            .training(**training).evaluation(**evaluation).debugging(seed=6)
            .resources(device="cpu").build())


def _recording(worker, into):
    real = worker.get_metrics

    def get_metrics():
        eps = real()
        into.extend(eps)
        return eps

    worker.get_metrics = get_metrics


def test_evaluation_matches_the_reference():
    ref, port = _evaluator("reference"), _evaluator("port")
    try:
        from_jax_policy_weights(ref.workers.local_worker().get_weights(),
                                port.workers.local_worker().policy_map)
        ref_eps, eps = [], []
        for algo, into in ((ref, ref_eps), (port, eps)):
            lw = algo.evaluation_workers.local_worker()
            scripted_actions(lw.policy_map["default_policy"])
            _recording(lw, into)
        ref_out, out = ref.evaluate(), port.evaluate()
    finally:
        port.stop()
        ref.cleanup()
    assert len(eps) == len(ref_eps) >= 6
    assert [(e.episode_length, e.episode_reward) for e in eps] == [
        (e.episode_length, e.episode_reward) for e in ref_eps]
    keys = ("episode_reward_max", "episode_reward_min", "episode_reward_mean", "episode_len_mean",
            "episodes_this_iter")
    assert {k: out[k] for k in keys} == {k: ref_out[k] for k in keys}


# -- the evaluate CLI --------------------------------------------------------------------


def test_evaluate_cli_on_a_checkpoint(tmp_path):
    algo = (PPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, rollout_fragment_length=32).training(**SMALL)
            .debugging(seed=0).resources(device="cpu").build())
    try:
        algo.train()
        path = algo.save(str(tmp_path / "ckpt"))
    finally:
        algo.stop()
    env = {**os.environ, "PYTHONPATH": str(REPO), "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.evaluate", path, "--run", "PPO", "--env",
         "CartPole-v1", "--episodes", "2",
         "--config", json.dumps({"device": "cpu", "model": {"fcnet_hiddens": [16]}})],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("episode 0: reward=")
    out = json.loads(lines[-1])
    assert out["episodes"] == 2 and out["max_reward"] >= out["mean_reward"] > 0
