"""Vanilla policy gradient (REINFORCE).

Counterpart of ``ray_tpu/algorithms/pg/pg.py``: the loss ``-mean(logp
· adv) - entropy_coeff · entropy`` in the base policy's SGD nest, the
advantages the raw discounted returns (``compute_gae_for_sample_batch``
with ``use_gae`` and ``use_critic`` off), and a training step of one
synchronous sample round, one learn on the local worker and the weights
to every worker. It runs on the actor lane.
"""

from __future__ import annotations

from typing import Dict

import torch

from ray_tpu_torch.algorithms.algorithm import (
    NUM_AGENT_STEPS_SAMPLED,
    NUM_ENV_STEPS_SAMPLED,
    Algorithm,
    refuse_device_lane,
)
from ray_tpu_torch.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.data.sample_batch import SampleBatch
from ray_tpu_torch.evaluation.postprocessing import compute_gae_for_sample_batch
from ray_tpu_torch.execution.rollout_ops import synchronous_parallel_sample
from ray_tpu_torch.execution.train_ops import train_one_step
from ray_tpu_torch.policy.torch_policy import TorchPolicy


class PGConfig(AlgorithmConfig):
    """The reference's PGConfig: lr 4e-4, train batch 200, one SGD pass,
    no GAE and no critic."""

    def __init__(self, algo_class=None):
        super().__init__(algo_class or PG)
        self.lr = 0.0004
        self.train_batch_size = 200
        self.num_sgd_iter = 1
        self.use_gae = False
        self.use_critic = False


class PGTorchPolicy(TorchPolicy):
    """``-mean(logp · advantages) - entropy_coeff · mean(entropy)``."""

    _ship_next_obs = False

    def loss(self, batch, coeffs):
        dist_inputs, _, _ = self.model_forward_train(batch)
        dist = self.dist_class(dist_inputs)
        logp = dist.logp(batch[SampleBatch.ACTIONS])
        policy_loss = -torch.mean(logp * batch[SampleBatch.ADVANTAGES])
        entropy = torch.mean(dist.entropy())
        total = policy_loss - coeffs["entropy_coeff"] * entropy
        return total, {"policy_loss": policy_loss.detach(), "entropy": entropy.detach()}

    def postprocess_trajectory(self, sample_batch, other_agent_batches=None, episode=None):
        return compute_gae_for_sample_batch(self, sample_batch, other_agent_batches, episode)


class PG(Algorithm):
    _default_policy_class = PGTorchPolicy
    _actor_lane = True
    _learns_under_act_lock = True  # train_one_step: the worker's learn_on_batch

    @classmethod
    def get_default_config(cls) -> PGConfig:
        return PGConfig(cls)

    def training_step(self) -> Dict:
        """One synchronous sample round to ``train_batch_size`` env steps,
        one learn on the local worker, then the weights and the timestep
        to every worker."""
        refuse_device_lane(self)
        train_batch = synchronous_parallel_sample(
            worker_set=self.workers, max_env_steps=self.config["train_batch_size"]
        )
        self._counters[NUM_ENV_STEPS_SAMPLED] += train_batch.env_steps()
        self._counters[NUM_AGENT_STEPS_SAMPLED] += train_batch.env_steps()
        train_info = train_one_step(self, train_batch)
        self.workers.sync_weights(global_vars={"timestep": self._counters[NUM_ENV_STEPS_SAMPLED]})
        return train_info
