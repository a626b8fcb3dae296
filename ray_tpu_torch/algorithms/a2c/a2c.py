"""A2C (synchronous) and A3C (asynchronous gradients).

Counterpart of ``ray_tpu/algorithms/a2c/a2c.py``. A2C samples
synchronously to ``train_batch_size`` env steps and learns once with the
actor-critic loss (``-mean(logp · adv) + vf_loss_coeff · mean((v -
targets)^2) - entropy_coeff · entropy``, gradients clipped at 40).

A3C's workers each sample and compute gradients on their own batch
(``RolloutWorker.compute_gradients``, on the CPU); the learner applies
whichever are ready (``RolloutWorker.apply_gradients``: the same Adam
step as a learn, under the worker's act lock) and sends the new weights
to every worker. The reference submits a call to every worker each
step, applies one ready result and leaves the rest queued on their
actors, never read; the port keeps one call in flight a worker instead,
applies each that is ready (at least one, waiting up to 60 s) and asks
that worker again (ROADMAP.md queue 3, "Deliberate differences").

``microbatch_size`` is stored and never read by the reference; the port
refuses a value other than None rather than ignore it.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Optional

import torch

from ray_tpu_torch import core
from ray_tpu_torch.algorithms.algorithm import (
    NUM_ENV_STEPS_SAMPLED,
    Algorithm,
    refuse_device_lane,
)
from ray_tpu_torch.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.data.sample_batch import DEFAULT_POLICY_ID, SampleBatch
from ray_tpu_torch.evaluation.postprocessing import compute_gae_for_sample_batch
from ray_tpu_torch.execution.rollout_ops import synchronous_parallel_sample
from ray_tpu_torch.execution.train_ops import train_one_step
from ray_tpu_torch.policy.torch_policy import TorchPolicy

A3C_WAIT_S = 60.0


class A2CConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or A2C)
        self.lr = 1e-4
        self.train_batch_size = 200
        self.rollout_fragment_length = 20
        self.use_gae = True
        self.lambda_ = 1.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.entropy_coeff_schedule = None
        self.grad_clip = 40.0
        self.microbatch_size = None

    def training(
        self,
        *,
        use_gae: Optional[bool] = None,
        lambda_: Optional[float] = None,
        vf_loss_coeff: Optional[float] = None,
        entropy_coeff: Optional[float] = None,
        entropy_coeff_schedule=None,
        microbatch_size: Optional[int] = None,
        **kwargs,
    ) -> "A2CConfig":
        super().training(**kwargs)
        for name, value in (
            ("use_gae", use_gae),
            ("lambda_", lambda_),
            ("vf_loss_coeff", vf_loss_coeff),
            ("entropy_coeff", entropy_coeff),
            ("entropy_coeff_schedule", entropy_coeff_schedule),
            ("microbatch_size", microbatch_size),
        ):
            if value is not None:
                setattr(self, name, value)
        return self

    def to_dict(self) -> Dict:
        d = super().to_dict()
        d["lambda"] = d.pop("lambda_", 1.0)
        return d


class A2CTorchPolicy(TorchPolicy):
    """The vanilla actor-critic loss."""

    _ship_next_obs = False

    def loss(self, batch, coeffs):
        dist_inputs, values, _ = self.model_forward_train(batch)
        dist = self.dist_class(dist_inputs)
        logp = dist.logp(batch[SampleBatch.ACTIONS])
        pi_loss = -torch.mean(logp * batch[SampleBatch.ADVANTAGES])
        vf_loss = torch.mean(torch.square(values - batch[SampleBatch.VALUE_TARGETS]))
        entropy = torch.mean(dist.entropy())
        total = (pi_loss + self.config.get("vf_loss_coeff", 0.5) * vf_loss
                 - coeffs["entropy_coeff"] * entropy)
        return total, {"policy_loss": pi_loss.detach(), "vf_loss": vf_loss.detach(),
                       "entropy": entropy.detach()}

    def postprocess_trajectory(self, sample_batch, other_agent_batches=None, episode=None):
        return compute_gae_for_sample_batch(self, sample_batch, other_agent_batches, episode)


class A2C(Algorithm):
    _default_policy_class = A2CTorchPolicy
    _actor_lane = True
    _learns_under_act_lock = True

    @classmethod
    def get_default_config(cls) -> A2CConfig:
        return A2CConfig(cls)

    def __init__(self, config=None, env=None):
        cfg = config.to_dict() if isinstance(config, AlgorithmConfig) else dict(config or {})
        if cfg.get("microbatch_size") is not None:
            raise ValueError(
                "microbatch_size: the reference's A2C stores it and never reads it; the port "
                "refuses it rather than ignore it (set None)"
            )
        super().__init__(cfg, env)

    def training_step(self) -> Dict:
        """One synchronous sample round, one learn on the local worker,
        then the weights and the timestep to every worker."""
        refuse_device_lane(self)
        train_batch = synchronous_parallel_sample(
            worker_set=self.workers, max_env_steps=self.config["train_batch_size"]
        )
        self._counters[NUM_ENV_STEPS_SAMPLED] += train_batch.env_steps()
        info = train_one_step(self, train_batch)
        self.workers.sync_weights(global_vars={"timestep": self._counters[NUM_ENV_STEPS_SAMPLED]})
        return info


class A3CConfig(A2CConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or A3C)


def sample_and_grad(worker):
    """On a remote worker: one sample and its gradients,
    ``(gradients, stats, env steps)``."""
    batch = worker.sample()
    grads, info = worker.compute_gradients(batch)
    return grads, info, batch.env_steps()


class A3C(A2C):
    """Each remote worker samples and computes gradients; the learner
    applies the ready ones and sends the weights back. Without remote
    workers a step is A2C's."""

    def __init__(self, config=None, env=None):
        super().__init__(config, env)
        # remote worker -> its sample_and_grad call in flight
        self._grad_refs: Dict[int, object] = {}
        # gradients applied, by worker index (``WorkerSet.index_of``)
        self.grads_applied = Counter()

    @classmethod
    def get_default_config(cls) -> A3CConfig:
        return A3CConfig(cls)

    def training_step(self) -> Dict:
        refuse_device_lane(self)
        workers = self.workers.remote_workers()
        if not workers:
            return super().training_step()
        live = {id(w): w for w in workers}
        self._grad_refs = {k: r for k, r in self._grad_refs.items() if k in live}
        for key, w in live.items():
            if key not in self._grad_refs:
                self._grad_refs[key] = w.apply.remote(sample_and_grad)
        by_ref = {id(r): k for k, r in self._grad_refs.items()}
        ready, _ = core.wait(list(self._grad_refs.values()), num_returns=1, timeout=A3C_WAIT_S)
        local = self.workers.local_worker()
        info: Dict = {}
        for ref in ready:
            key = by_ref[id(ref)]
            del self._grad_refs[key]
            grads, g_info, steps = core.get(ref)
            local.apply_gradients(grads)
            self._counters[NUM_ENV_STEPS_SAMPLED] += steps
            self._counters["num_grads_applied"] += 1
            self.grads_applied[self.workers.index_of(live[key])] += 1
            info = {DEFAULT_POLICY_ID: g_info}
        self.workers.sync_weights(global_vars={"timestep": self._counters[NUM_ENV_STEPS_SAMPLED]})
        for key in list(live):
            if key not in self._grad_refs:
                self._grad_refs[key] = live[key].apply.remote(sample_and_grad)
        return info

    def on_fleet_change(self, added, removed) -> None:
        super().on_fleet_change(added, removed)
        for w in removed:
            self._grad_refs.pop(id(w), None)

    def on_recovery(self, kind: str) -> None:
        super().on_recovery(kind)
        self._grad_refs = {}

    def stop(self) -> None:
        self._grad_refs = {}
        super().stop()
