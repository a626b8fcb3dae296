"""PPO: config, policy (loss and KL adaptation), and algorithm.

Counterpart of ``ray_tpu/algorithms/ppo/ppo.py``. The learner runs the
clipped-surrogate / clipped-value / entropy loss in the ``num_sgd_iter``
x minibatches nest of :class:`TorchPolicy`. ``PPO.training_step`` runs
on the device lane (``env_backend: jax`` in the reference's configs,
which here means "on the device"): K superstep slots of [roll out N x T
steps on the card, GAE there, the SGD nest on the device-resident
batch], one CUDA graph replayed K times (``config.superstep``). The
actor lane (CPU rollout workers) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ray_tpu_torch.algorithms.algorithm import (
    NUM_AGENT_STEPS_SAMPLED,
    NUM_AGENT_STEPS_TRAINED,
    NUM_ENV_STEPS_SAMPLED,
    NUM_ENV_STEPS_TRAINED,
    Algorithm,
)
from ray_tpu_torch.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.data.sample_batch import DEFAULT_POLICY_ID, SampleBatch
from ray_tpu_torch.policy.torch_policy import TorchPolicy


class PPOConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or PPO)
        self.lr = 5e-5
        self.train_batch_size = 4000
        self.sgd_minibatch_size = 128
        self.num_sgd_iter = 30
        self.lambda_ = 1.0
        self.use_gae = True
        self.use_critic = True
        self.kl_coeff = 0.2
        self.kl_target = 0.01
        self.vf_loss_coeff = 1.0
        self.entropy_coeff = 0.0
        self.entropy_coeff_schedule = None
        self.clip_param = 0.3
        self.vf_clip_param = 10.0
        self.shuffle_sequences = True

    def training(
        self,
        *,
        lambda_: Optional[float] = None,
        kl_coeff: Optional[float] = None,
        kl_target: Optional[float] = None,
        sgd_minibatch_size: Optional[int] = None,
        num_sgd_iter: Optional[int] = None,
        vf_loss_coeff: Optional[float] = None,
        entropy_coeff: Optional[float] = None,
        entropy_coeff_schedule=None,
        clip_param: Optional[float] = None,
        vf_clip_param: Optional[float] = None,
        **kwargs,
    ) -> "PPOConfig":
        super().training(**kwargs)
        for name, value in (
            ("lambda_", lambda_),
            ("kl_coeff", kl_coeff),
            ("kl_target", kl_target),
            ("sgd_minibatch_size", sgd_minibatch_size),
            ("num_sgd_iter", num_sgd_iter),
            ("vf_loss_coeff", vf_loss_coeff),
            ("entropy_coeff", entropy_coeff),
            ("entropy_coeff_schedule", entropy_coeff_schedule),
            ("clip_param", clip_param),
            ("vf_clip_param", vf_clip_param),
        ):
            if value is not None:
                setattr(self, name, value)
        return self

    def to_dict(self) -> Dict:
        d = super().to_dict()
        d["lambda"] = d.pop("lambda_", 1.0)
        return d


def explained_variance(y: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    y_var = torch.var(y, unbiased=False)
    diff_var = torch.var(y - pred, unbiased=False)
    return torch.clamp_min(1.0 - diff_var / (y_var + 1e-8), -1.0)


class PPOTorchPolicy(TorchPolicy):
    """Clipped-surrogate PPO loss, with the KL coefficient adapted on
    the host between learn calls."""

    _ship_next_obs = False

    def _init_coeffs(self):
        self.coeff_values["kl_coeff"] = float(self.config.get("kl_coeff", 0.2))

    def loss(self, batch, coeffs):
        cfg = self.config
        clip_param = cfg.get("clip_param", 0.3)
        vf_clip = cfg.get("vf_clip_param", 10.0)
        vf_coeff = cfg.get("vf_loss_coeff", 1.0)

        dist_inputs, value, _ = self.model_forward(batch[SampleBatch.OBS])
        dist = self.dist_class(dist_inputs)
        prev_dist = self.dist_class(batch[SampleBatch.ACTION_DIST_INPUTS])

        logp = dist.logp(batch[SampleBatch.ACTIONS])
        logp_ratio = torch.exp(logp - batch[SampleBatch.ACTION_LOGP])
        advantages = batch[SampleBatch.ADVANTAGES]
        surrogate = torch.minimum(
            advantages * logp_ratio,
            advantages
            * torch.clamp(logp_ratio, 1.0 - clip_param, 1.0 + clip_param),
        )
        action_kl = prev_dist.kl(dist)
        entropy = dist.entropy()

        value_targets = batch[SampleBatch.VALUE_TARGETS]
        vf_loss = torch.square(value - value_targets)
        vf_loss_clipped = torch.clamp(vf_loss, 0.0, vf_clip)

        total = torch.mean(
            -surrogate
            + coeffs["kl_coeff"] * action_kl
            + vf_coeff * vf_loss_clipped
            - coeffs["entropy_coeff"] * entropy
        )
        with torch.no_grad():
            stats = {
                "policy_loss": torch.mean(-surrogate),
                "vf_loss": torch.mean(vf_loss_clipped),
                "kl": torch.mean(action_kl),
                "entropy": torch.mean(entropy),
                "vf_explained_var": explained_variance(value_targets, value),
            }
        return total, stats

    def after_learn_on_batch(self, stats: Dict[str, float]) -> Dict:
        """Adaptive KL coefficient."""
        kl = stats.get("kl", 0.0)
        target = self.config.get("kl_target", 0.01)
        if self.coeff_values["kl_coeff"] > 0.0:
            if kl > 2.0 * target:
                self.coeff_values["kl_coeff"] *= 1.5
            elif kl < 0.5 * target:
                self.coeff_values["kl_coeff"] *= 0.5
        return {"cur_kl_coeff": self.coeff_values["kl_coeff"]}


class PPO(Algorithm):
    _default_policy_class = PPOTorchPolicy

    @classmethod
    def get_default_config(cls) -> PPOConfig:
        return PPOConfig(cls)

    def _engine(self):
        """The device rollout engine, built on first use: N =
        num_envs_per_worker x max(1, num_workers) env slots, T =
        rollout_fragment_length; one rollout is one train batch, so the
        lane needs ``train_batch_size == N * T``."""
        if self._rollout_engine is None:
            from ray_tpu_torch.execution.device_rollout import DeviceRolloutEngine

            cfg = self.config
            n = int(cfg.get("num_envs_per_worker", 1)) * max(
                1, int(cfg.get("num_workers", 0))
            )
            t = int(cfg.get("rollout_fragment_length", 200))
            if n * t != int(cfg["train_batch_size"]):
                raise ValueError(
                    "the device lane needs train_batch_size == "
                    "num_envs_per_worker * max(1, num_workers) * "
                    f"rollout_fragment_length, got {n * t} != "
                    f"{cfg['train_batch_size']}"
                )
            self._rollout_engine = DeviceRolloutEngine(
                self.get_policy(), self.env, n, t, seed=cfg.get("seed"),
            )
            self._extra_metric_sources.append(self._rollout_engine.get_metrics)
        return self._rollout_engine

    def training_step(self) -> Dict:
        """K x [rollout(T) + GAE + the num_sgd_iter-epoch nest] on the
        device lane (the reference's ``_training_step_jax_rollout``): one
        ``learn_rollout_superstep`` call with ``jax_fused_rollout`` (the
        default), else K eager rollout-then-learn rounds. The KL
        coefficient adapts on the drained per-update stats, in order."""
        if self.config.get("env_backend") != "jax":
            raise NotImplementedError(
                "the actor lane is not ported yet; set env_backend='jax' "
                "to run PPO on the device lane"
            )
        eng = self._engine()
        policy = self.get_policy()
        bsize = eng.batch_size
        K = self._resolve_superstep_k()
        if self.config.get("jax_fused_rollout", True):
            infos, carry, metrics, skipped = policy.learn_rollout_superstep(
                K, bsize, eng.superstep_feed(), k_max=K
            )
            eng.advance(carry, metrics)
            for info_i in infos:
                info_i.update(policy.after_learn_on_batch(info_i))
            info = infos[-1]
            if any(skipped):
                self._counters["num_nan_batches_skipped"] += sum(skipped)
        else:
            for _ in range(K):
                batch, bsize = eng.rollout()
                info = policy.learn_on_device_batch(eng.learn_batch(batch), bsize)
        info["cur_lr"] = policy.coeff_values.get("lr")
        for key in (
            NUM_ENV_STEPS_SAMPLED, NUM_AGENT_STEPS_SAMPLED,
            NUM_ENV_STEPS_TRAINED, NUM_AGENT_STEPS_TRAINED,
        ):
            self._counters[key] += K * bsize
        policy.global_timestep = self._counters[NUM_ENV_STEPS_SAMPLED]
        return {DEFAULT_POLICY_ID: info}
