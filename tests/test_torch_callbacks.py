"""User callbacks on the port (``ray_tpu_torch/algorithms/callbacks.py``):
the port of ``tests/test_callbacks.py``, and the port against the
reference on the CPU.

Contracts:

- an episode gets as many ``on_episode_step`` calls as its ``length``;
  ``on_episode_start`` count >= ``on_episode_end`` count >= 1; one
  ``on_sample_end`` per sample, with that batch's count;
- ``custom_metrics/<k>_mean|min|max`` are numpy's mean, min and max of
  the episodes' values, bitwise; ``on_train_result``'s mutation shows in
  the result;
- ``MultiCallbacks`` fans one hook out to each class, in order;
- callbacks on a remote worker (``num_workers: 1``): their episodes'
  ``custom_metrics`` reach the main process's result;
- bitwise against the reference: both packages' PPO sample with the
  reference's initial weights carried across, the same injected actions
  (a fixed function of the observation) and seeded gymnasium CartPole;
  the hook sequence (hook, env slot, episode length, reward, the env's
  info), the episodes' lengths and rewards and the ``custom_metrics``
  summary are equal.
"""

from __future__ import annotations

import random

import gymnasium as gym
import jax
import numpy as np
import pytest

from _torch_actor_probe import EpisodeCallbacks, scripted_actions
from ray_tpu.algorithms.callbacks import DefaultCallbacks as RefDefaultCallbacks
from ray_tpu.algorithms.ppo import PPOConfig as RefPPOConfig
from ray_tpu.env import registry as ref_registry
from ray_tpu.evaluation import metrics as ref_metrics
from ray_tpu_torch import core
from ray_tpu_torch.algorithms.callbacks import DefaultCallbacks, MultiCallbacks
from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig
from ray_tpu_torch.env import registry
from ray_tpu_torch.evaluation import metrics
from ray_tpu_torch.utils.jax_params import from_jax_policy_weights


class _Recorder(DefaultCallbacks):
    events = []  # class-level: the worker runs in this process (num_workers 0)
    values = []

    def on_episode_start(self, *, episode=None, **kw):
        _Recorder.events.append("start")
        episode.user_data["rewards"] = []

    def on_episode_step(self, *, episode=None, **kw):
        episode.user_data["rewards"].append(1.0)

    def on_episode_end(self, *, episode=None, **kw):
        _Recorder.events.append("end")
        assert len(episode.user_data["rewards"]) == episode.length
        episode.custom_metrics["my_steps"] = float(len(episode.user_data["rewards"]))
        _Recorder.values.append(float(episode.length))

    def on_sample_end(self, *, samples=None, **kw):
        _Recorder.events.append(f"sample:{samples.count}")

    def on_train_result(self, *, algorithm=None, result=None, **kw):
        _Recorder.events.append("train_result")
        result["from_callback"] = True


def _ppo(**over):
    cfg = (PPOConfig().environment("CartPole-v1")
           .rollouts(num_rollout_workers=0, rollout_fragment_length=64)
           .training(train_batch_size=256, sgd_minibatch_size=128, num_sgd_iter=2,
                     model={"fcnet_hiddens": [16]})
           .debugging(seed=0).resources(device="cpu"))
    cfg.update_from_dict(over)
    return cfg.build()


def test_episode_hooks_and_custom_metrics():
    _Recorder.events, _Recorder.values = [], []
    algo = _ppo(callbacks_class=_Recorder)
    try:
        result = algo.train()
    finally:
        algo.stop()
    events = _Recorder.events
    assert result["from_callback"] is True and events[-1] == "train_result"
    assert events.count("start") >= events.count("end") >= 1
    # the sampler's first on_episode_start precedes its first reset
    assert events[0] == "start"
    samples = [int(e.split(":")[1]) for e in events if e.startswith("sample:")]
    assert len(samples) == 4 and sum(samples) == result["num_env_steps_sampled"] == 256
    cm = result["custom_metrics"]
    vals = np.asarray(_Recorder.values)
    assert len(vals) == result["episodes_this_iter"] == events.count("end")
    assert (cm["my_steps_mean"], cm["my_steps_min"], cm["my_steps_max"]) == (
        float(np.mean(vals)), float(np.min(vals)), float(np.max(vals)))
    assert cm["my_steps_min"] <= cm["my_steps_mean"] <= cm["my_steps_max"]


def test_multi_callbacks_fan_out():
    calls = []

    class A(DefaultCallbacks):
        def on_train_result(self, **kw):
            calls.append("A")

    class B(DefaultCallbacks):
        def on_train_result(self, **kw):
            calls.append("B")

        def on_episode_end(self, *, episode=None, **kw):
            calls.append(("B", episode))

    mc = MultiCallbacks([A, B])
    mc.on_train_result(algorithm=None, result={})
    mc.on_episode_end(episode="ep")
    assert calls == ["A", "B", ("B", "ep")]


def test_raising_callback_fails_the_sample():
    class Boom(DefaultCallbacks):
        def on_episode_step(self, **kw):
            raise RuntimeError("user bug")

    algo = _ppo(callbacks_class=Boom)
    try:
        with pytest.raises(RuntimeError, match="user bug"):
            algo.train()
    finally:
        algo.stop()


def test_callbacks_run_on_a_remote_worker():
    core.shutdown()
    core.init(num_cpus=1)
    algo = _ppo(num_workers=1, callbacks_class=EpisodeCallbacks)
    try:
        result = algo.train()
        assert algo.workers.num_remote_workers() == 1
    finally:
        algo.stop()
        core.shutdown()
    assert result["callbacks_saw_iteration"] == 1
    cm = result["custom_metrics"]
    assert result["episodes_this_iter"] >= 1
    assert cm["steps_mean"] == pytest.approx(result["episode_len_mean"], rel=1e-12)
    assert cm["reward_mean"] == pytest.approx(result["episode_reward_mean"], rel=1e-12)


def test_device_lane_runs_on_train_result_only():
    _Recorder.events = []
    cfg = (PPOConfig().environment("CartPoleJax-v0", env_backend="jax")
           .rollouts(num_envs_per_worker=4, rollout_fragment_length=16)
           .training(train_batch_size=64, sgd_minibatch_size=32, num_sgd_iter=1,
                     model={"fcnet_hiddens": [16]})
           .callbacks(_Recorder).debugging(seed=0).resources(device="cpu"))
    result = cfg.build().train()
    assert result["from_callback"] is True and _Recorder.events == ["train_result"]


# -- the port against the reference ------------------------------------------------------


def _gym_cartpole(cfg):
    return gym.make("CartPole-v1")


def _sequence_callbacks(base, log):
    """A callbacks class of ``base`` (either package's DefaultCallbacks)
    that appends every hook call to ``log`` and records two custom
    metrics an episode."""

    class Seq(base):
        def on_episode_start(self, *, episode=None, env_index=None, **kw):
            log.append(("start", env_index, episode.length))

        def on_episode_step(self, *, episode=None, env_index=None, **kw):
            log.append(("step", env_index, episode.length, episode.total_reward,
                        sorted(episode.last_info)))

        def on_episode_end(self, *, episode=None, env_index=None, **kw):
            log.append(("end", env_index, episode.length))
            episode.custom_metrics["len"] = float(episode.length)
            episode.custom_metrics["half_reward"] = episode.total_reward / 2

        def on_sample_end(self, *, samples=None, **kw):
            log.append(("sample_end", samples.count))

    return Seq


def _run(package, samples=3):
    log = []
    common = dict(rollout_fragment_length=48, num_envs_per_worker=2)
    training = dict(train_batch_size=96, sgd_minibatch_size=48, num_sgd_iter=1,
                    model={"fcnet_hiddens": [16], "dtype": "float32"})
    random.seed(0)
    if package == "reference":
        ref_registry.register_env("gym_cartpole", _gym_cartpole)
        algo = (RefPPOConfig().environment("gym_cartpole").rollouts(num_rollout_workers=0, **common)
                .training(**training).callbacks(_sequence_callbacks(RefDefaultCallbacks, log))
                .debugging(seed=4).resources(learner_devices=1).build())
    else:
        registry.register_env("gym_cartpole", _gym_cartpole)
        algo = (PPOConfig().environment("gym_cartpole").rollouts(num_rollout_workers=0, **common)
                .training(**training).callbacks(_sequence_callbacks(DefaultCallbacks, log))
                .debugging(seed=4).resources(device="cpu").build())
    worker = algo.workers.local_worker()
    scripted_actions(worker.policy_map["default_policy"])
    return algo, worker, log, samples


def test_hooks_and_custom_metrics_match_the_reference():
    ref, ref_worker, ref_log, n = _run("reference")
    port, worker, log, _ = _run("port")
    try:
        from_jax_policy_weights(ref_worker.get_weights(), worker.policy_map)
        for _ in range(n):
            ref_worker.sample()
            worker.sample()
        ref_eps, eps = ref_worker.get_metrics(), worker.get_metrics()
    finally:
        port.stop()
        ref.cleanup()
    assert log == ref_log
    assert sum(1 for e in log if e[0] == "end") == len(eps) >= 3
    assert [(e.episode_length, e.episode_reward, e.custom_metrics) for e in eps] == [
        (e.episode_length, e.episode_reward, e.custom_metrics) for e in ref_eps]
    ours, theirs = metrics.summarize_episodes(eps), ref_metrics.summarize_episodes(ref_eps)
    assert ours["custom_metrics"] == theirs["custom_metrics"]
    assert set(ours["custom_metrics"]) == {f"{k}_{s}" for k in ("len", "half_reward")
                                           for s in ("mean", "min", "max")}
    jax.clear_caches()
