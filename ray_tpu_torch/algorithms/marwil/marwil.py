"""MARWIL (advantage-weighted imitation) and BC (behaviour cloning).

Counterpart of ``ray_tpu/algorithms/marwil/marwil.py``. The loss is the
reference's: ``-mean(exp(beta * adv / (1e-8 + sqrt(c))) * logp(a))``
with ``adv = returns - V(s)`` and the weights held fixed, plus
``vf_coeff * 0.5 * mean(adv^2)``; ``c`` is the moving average of the
squared advantage, a host coefficient that rides the learn call as a
device scalar and moves after each learn by
``c += moving_average_sqd_adv_norm_update_rate * (adv_sqd_mean - c)``
(one update a learn call, the reference's rule; with the default
``num_sgd_iter = 1`` that is once an SGD step). BC is MARWIL with
``beta = 0``: unit weights and no value loss.

The ``advantages`` column holds plain discounted returns
(``use_gae=False``, ``use_critic=False``), bootstrapped with V(last
obs) where a fragment does not end in a termination. With an offline
reader (``input`` a path), a train batch is drawn line by line and each
line postprocessed one episode at a time, so returns never cross an
episode boundary inside a written line. The ``is`` / ``wis`` estimators
(``off_policy_estimation_methods``) score the policy after each learn on
that train batch, under ``off_policy_estimation/<name>`` in the learner
stats. Without a reader the algorithm samples its workers, as PPO does.
MARWIL runs on the actor lane only.
"""

from __future__ import annotations

import warnings
from typing import Dict, Optional

import torch

from ray_tpu_torch.algorithms.algorithm import (
    NUM_AGENT_STEPS_SAMPLED,
    NUM_ENV_STEPS_SAMPLED,
    Algorithm,
)
from ray_tpu_torch.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.data.sample_batch import DEFAULT_POLICY_ID, SampleBatch, concat_samples
from ray_tpu_torch.evaluation.postprocessing import compute_gae_for_sample_batch
from ray_tpu_torch.execution.rollout_ops import synchronous_parallel_sample
from ray_tpu_torch.execution.train_ops import train_one_step
from ray_tpu_torch.offline.off_policy_estimator import (
    ImportanceSampling,
    WeightedImportanceSampling,
)
from ray_tpu_torch.offline.offline_ops import setup_offline_reader
from ray_tpu_torch.policy.torch_policy import TorchPolicy


class MARWILConfig(AlgorithmConfig):
    """The reference's MARWILConfig defaults."""

    def __init__(self, algo_class=None):
        super().__init__(algo_class or MARWIL)
        self.beta = 1.0
        self.vf_coeff = 1.0
        self.bc_logstd_coeff = 0.0
        self.moving_average_sqd_adv_norm_start = 100.0
        self.moving_average_sqd_adv_norm_update_rate = 1e-8
        self.lr = 1e-4
        self.train_batch_size = 2000
        self.num_sgd_iter = 1
        self.use_gae = False
        self.use_critic = False
        self.off_policy_estimation_methods = ["is", "wis"]

    def training(
        self,
        *,
        beta: Optional[float] = None,
        vf_coeff: Optional[float] = None,
        bc_logstd_coeff: Optional[float] = None,
        moving_average_sqd_adv_norm_start: Optional[float] = None,
        moving_average_sqd_adv_norm_update_rate: Optional[float] = None,
        num_sgd_iter: Optional[int] = None,
        **kwargs,
    ) -> "MARWILConfig":
        super().training(**kwargs)
        for name, value in (
            ("beta", beta),
            ("vf_coeff", vf_coeff),
            ("bc_logstd_coeff", bc_logstd_coeff),
            ("moving_average_sqd_adv_norm_start", moving_average_sqd_adv_norm_start),
            ("moving_average_sqd_adv_norm_update_rate", moving_average_sqd_adv_norm_update_rate),
            ("num_sgd_iter", num_sgd_iter),
        ):
            if value is not None:
                setattr(self, name, value)
        return self


class BCConfig(MARWILConfig):
    """The reference's BCConfig: MARWIL with ``beta = 0`` and no value
    loss."""

    def __init__(self, algo_class=None):
        super().__init__(algo_class or BC)
        self.beta = 0.0
        self.vf_coeff = 0.0


class MARWILTorchPolicy(TorchPolicy):
    # the loss never reads NEXT_OBS
    _ship_next_obs = False

    def _init_coeffs(self) -> None:
        self.coeff_values["ma_sqd_adv_norm"] = float(
            self.config.get("moving_average_sqd_adv_norm_start", 100.0)
        )

    def loss(self, batch, coeffs):
        beta = float(self.config.get("beta", 1.0))
        dist_inputs, values, _ = self.model_forward_train(batch)
        dist = self.dist_class(dist_inputs)
        logp = dist.logp(batch[SampleBatch.ACTIONS])
        stats = {}
        if beta != 0.0:
            adv = batch[SampleBatch.ADVANTAGES] - values
            adv_sqd_mean = torch.mean(torch.square(adv))
            with torch.no_grad():
                exp_advs = torch.exp(
                    beta * (adv / (1e-8 + torch.sqrt(coeffs["ma_sqd_adv_norm"])))
                )
            v_loss = 0.5 * adv_sqd_mean
            stats["adv_sqd_mean"] = adv_sqd_mean.detach()
            stats["vf_loss"] = v_loss.detach()
            p_loss = -torch.mean(exp_advs * logp)
            total = p_loss + float(self.config.get("vf_coeff", 1.0)) * v_loss
        else:
            p_loss = -torch.mean(logp)
            total = p_loss
        stats["policy_loss"] = p_loss.detach()
        stats["entropy"] = torch.mean(dist.entropy()).detach()
        return total, stats

    def after_learn_on_batch(self, stats: Dict[str, float]) -> Dict:
        """The normaliser's moving-average step on the learn call's
        ``adv_sqd_mean``; MARWIL reports the new value, BC nothing."""
        if "adv_sqd_mean" not in stats:
            return {}
        rate = float(self.config.get("moving_average_sqd_adv_norm_update_rate", 1e-8))
        cur = self.coeff_values["ma_sqd_adv_norm"]
        self.coeff_values["ma_sqd_adv_norm"] = cur + rate * (stats["adv_sqd_mean"] - cur)
        return {"moving_average_sqd_adv_norm": self.coeff_values["ma_sqd_adv_norm"]}

    def postprocess_trajectory(self, sample_batch, other_agent_batches=None, episode=None):
        """Discounted returns into ``advantages`` (the config's
        ``use_gae``/``use_critic``, both False by default)."""
        return compute_gae_for_sample_batch(self, sample_batch, other_agent_batches, episode)


class MARWIL(Algorithm):
    _default_policy_class = MARWILTorchPolicy
    _actor_lane = True
    _learns_under_act_lock = True  # train_one_step: the worker's learn_on_batch

    @classmethod
    def get_default_config(cls) -> MARWILConfig:
        return MARWILConfig(cls)

    def __init__(self, config=None, env=None):
        super().__init__(config, env)
        self._reader = setup_offline_reader(self.config)
        self._estimators = []
        self._est_warned = False
        if self._reader is not None:
            methods = self.config.get("off_policy_estimation_methods", ["is", "wis"])
            gamma = self.config.get("gamma", 0.99)
            policy = self.get_policy()
            if "is" in methods:
                self._estimators.append(ImportanceSampling(policy, gamma))
            if "wis" in methods:
                self._estimators.append(WeightedImportanceSampling(policy, gamma))

    def _next_offline_batch(self) -> SampleBatch:
        """Lines from the reader until ``train_batch_size`` rows, each
        line split by episode and each episode postprocessed alone."""
        target = int(self.config.get("train_batch_size", 2000))
        out, steps = [], 0
        policy = self.get_policy()
        while steps < target:
            for ep in self._reader.next().split_by_episode():
                ep = policy.postprocess_trajectory(ep)
                out.append(ep)
                steps += ep.count
        return concat_samples(out)

    def training_step(self) -> Dict:
        if self.config.get("env_backend") == "jax":
            raise NotImplementedError(
                "MARWIL and BC run on the actor lane (the reference's have no device lane)"
            )
        if self._reader is not None:
            train_batch = self._next_offline_batch()
        else:
            train_batch = synchronous_parallel_sample(
                worker_set=self.workers, max_env_steps=self.config["train_batch_size"]
            )
        self._counters[NUM_ENV_STEPS_SAMPLED] += train_batch.env_steps()
        self._counters[NUM_AGENT_STEPS_SAMPLED] += train_batch.env_steps()
        info = train_one_step(self, train_batch)
        if self._estimators and info:
            sub = info[DEFAULT_POLICY_ID]
            batch = getattr(train_batch, "policy_batches", {DEFAULT_POLICY_ID: train_batch})[
                DEFAULT_POLICY_ID]
            for est in self._estimators:
                name = type(est).__name__
                try:
                    sub[f"off_policy_estimation/{name}"] = est.estimate(batch)
                except Exception as e:  # the reference's rule: warn once, train on
                    if not self._est_warned:
                        self._est_warned = True
                        warnings.warn(
                            f"off-policy estimation ({name}) failed: {e!r} (does the "
                            "dataset carry action_logp?)"
                        )
        self.workers.sync_weights(global_vars={"timestep": self._counters[NUM_ENV_STEPS_SAMPLED]})
        return info


class BC(MARWIL):
    @classmethod
    def get_default_config(cls) -> BCConfig:
        return BCConfig(cls)
