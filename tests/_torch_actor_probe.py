"""Functions the actor-lane tests send to remote rollout workers
(``WorkerSet.foreach_worker``). They sit in a module of their own that
imports only the port, so a worker process that resolves them by name
imports no JAX."""

from __future__ import annotations

import os


def policy_weights(worker):
    return worker.policy().get_weights()


def device_report(worker):
    import torch

    return {
        "worker_index": worker.worker_index,
        "policy_device": str(worker.policy().device),
        "cuda_initialized": torch.cuda.is_initialized(),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "pid": os.getpid(),
    }


class StandInSampler:
    """A stand-in rollout worker for the request-manager tests (made
    remote there): ``sample()`` returns (wid, call #), or with
    ``payload`` an array of that many bytes, each the call #."""

    def __init__(self, wid, delay=0.0, payload=0):
        self.wid = wid
        self.delay = float(delay)
        self.payload = int(payload)
        self.n = 0

    def sample(self):
        import time

        if self.delay:
            time.sleep(self.delay)
        self.n += 1
        if self.payload:
            import numpy as np

            return np.full(self.payload, self.n, np.uint8)
        return (self.wid, self.n)

    def die(self):
        os._exit(1)


class FleetProbe:
    """A stand-in rollout worker for the resilience tests: ``sample`` and
    ``ping`` (each after an optional sleep), and the fleet controller's
    ``preemption_notice`` (``notice``: the grace it answers) and
    ``drain_for_preemption``."""

    def __init__(self, ping_delay=0.0, notice=None):
        self.ping_delay = float(ping_delay)
        self.notice = notice

    def sample(self, delay=0.0):
        import time

        if delay:
            time.sleep(delay)
        return "result"

    def ping(self):
        import time

        if self.ping_delay:
            time.sleep(self.ping_delay)
        return "pong"

    def preemption_notice(self):
        return self.notice

    def drain_for_preemption(self):
        return {"filters": {}, "metrics": [], "num_sample_calls": 0}


class EpisodeCallbacks:
    """Callbacks (``algorithms/callbacks.DefaultCallbacks``'s hooks,
    duck-typed so that this module imports nothing of the port) that a
    remote rollout worker builds from ``callbacks_class``: each episode
    counts its steps in ``user_data`` and records them, with its reward,
    as ``custom_metrics``; ``on_train_result`` marks the result."""

    def on_episode_start(self, *, episode=None, **kwargs):
        episode.user_data["steps"] = 0

    def on_episode_step(self, *, episode=None, **kwargs):
        episode.user_data["steps"] += 1

    def on_episode_end(self, *, episode=None, **kwargs):
        assert episode.user_data["steps"] == episode.length
        episode.custom_metrics["steps"] = float(episode.user_data["steps"])
        episode.custom_metrics["reward"] = float(episode.total_reward)

    def on_sample_end(self, *, samples=None, **kwargs):
        pass

    def on_train_result(self, *, result=None, **kwargs):
        result["callbacks_saw_iteration"] = result["training_iteration"]


def scripted_actions(policy):
    """Wrap ``policy.compute_actions`` (of either package): the policy's
    own extras, the actions a fixed function of a CartPole observation
    (pushing the pole over, so that episodes are short), so that two
    packages' samplers take the same actions."""
    import numpy as np

    real = policy.compute_actions

    def compute_actions(obs_batch, state_batches=None, *args, **kwargs):
        _, state, extra = real(obs_batch, state_batches, *args, **kwargs)
        obs = np.asarray(obs_batch)
        return (obs[:, 2] + 0.5 * obs[:, 3] < 0).astype(np.int64), state, extra

    policy.compute_actions = compute_actions
