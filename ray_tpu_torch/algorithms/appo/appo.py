"""APPO: asynchronous PPO on the IMPALA actor-learner.

Counterpart of ``ray_tpu/algorithms/appo/appo.py``. The loss is a
V-trace weighted PPO-clip surrogate against a slowly refreshed "old
policy" (the target parameters in ``aux_state``): V-trace runs against
the old policy's log-probabilities, and the ratio is doubly corrected,
``clamp(exp(behaviour_logp - old_logp), 0, 2) * exp(cur_logp -
behaviour_logp)``, so that the clipping anchor stays on the old policy
while samples come from slightly stale behaviour policies.

The main thread refreshes the target every ``target_update_frequency``
train batches (and adapts the KL coefficient under ``use_kl_loss``). The
reference does that on its main thread, which is safe with JAX's
immutable arrays; here Adam updates the parameters in place on the
learner thread, so the refresh takes the learner thread's step lock and
the target is always the parameters between two learner steps.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ray_tpu_torch.algorithms.algorithm import NUM_ENV_STEPS_TRAINED
from ray_tpu_torch.algorithms.impala.impala import IMPALA, IMPALAConfig, ImpalaTorchPolicy
from ray_tpu_torch.data.sample_batch import DEFAULT_POLICY_ID, SampleBatch


class APPOConfig(IMPALAConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or APPO)
        self.vtrace = True
        self.use_critic = True
        self.use_gae = True
        self.lambda_ = 1.0
        self.clip_param = 0.4
        self.use_kl_loss = False
        self.kl_coeff = 1.0
        self.kl_target = 0.01
        # train batches between old-policy refreshes
        self.target_update_frequency = 1

    def training(
        self,
        *,
        clip_param: Optional[float] = None,
        use_kl_loss: Optional[bool] = None,
        kl_coeff: Optional[float] = None,
        kl_target: Optional[float] = None,
        lambda_: Optional[float] = None,
        target_update_frequency: Optional[int] = None,
        **kwargs,
    ) -> "APPOConfig":
        super().training(**kwargs)
        for name, value in (
            ("clip_param", clip_param),
            ("use_kl_loss", use_kl_loss),
            ("kl_coeff", kl_coeff),
            ("kl_target", kl_target),
            ("lambda_", lambda_),
            ("target_update_frequency", target_update_frequency),
        ):
            if value is not None:
                setattr(self, name, value)
        return self


class APPOTorchPolicy(ImpalaTorchPolicy):
    """The V-trace weighted PPO-clip surrogate against the old policy."""

    def _init_coeffs(self):
        self.coeff_values["kl_coeff"] = float(self.config.get("kl_coeff", 1.0))

    def _init_aux_state(self):
        return {"target_params": [p.detach().clone() for p in self.params]}

    def update_target(self) -> None:
        """The old policy := the current parameters, in place."""
        torch._foreach_copy_(self.aux_state["target_params"], [p.detach() for p in self.params])

    def loss_with_aux(self, batch, aux, coeffs):
        cfg = self.config
        clip_param = cfg.get("clip_param", 0.4)
        B, T = batch[SampleBatch.OBS].shape[:2]

        dist_inputs, values, bootstrap_value = self._forward_unrolls(batch)
        with torch.no_grad():
            old_inputs, _, _ = self._forward_unrolls(batch, aux["target_params"])
        dist = self.dist_class(dist_inputs)
        old_dist = self.dist_class(old_inputs)

        actions = batch[SampleBatch.ACTIONS]
        flat_actions = actions.reshape((B * T,) + tuple(actions.shape[2:]))
        cur_logp = dist.logp(flat_actions)
        old_logp = old_dist.logp(flat_actions)
        behaviour_logp = batch[SampleBatch.ACTION_LOGP].reshape(B * T)

        # V-trace against the old policy (its logp as the target's)
        vtr = self._vtrace(batch, old_logp, values, bootstrap_value)
        advantages = vtr.pg_advantages.reshape(B * T)

        is_ratio = torch.clamp(torch.exp(behaviour_logp - old_logp), 0.0, 2.0)
        logp_ratio = is_ratio * torch.exp(cur_logp - behaviour_logp)
        surrogate = torch.minimum(
            advantages * logp_ratio,
            advantages * torch.clamp(logp_ratio, 1.0 - clip_param, 1.0 + clip_param),
        )
        pi_loss = -torch.mean(surrogate)
        vf_loss = 0.5 * torch.mean(torch.square(vtr.vs - values))
        entropy_mean = torch.mean(dist.entropy())
        action_kl = torch.mean(old_dist.kl(dist))

        total = pi_loss + cfg.get("vf_loss_coeff", 0.5) * vf_loss - coeffs["entropy_coeff"] * entropy_mean
        if cfg.get("use_kl_loss", False):
            total = total + coeffs["kl_coeff"] * action_kl
        with torch.no_grad():
            stats = {
                "policy_loss": pi_loss,
                "vf_loss": vf_loss,
                "entropy": entropy_mean,
                "kl": action_kl,
                "mean_is_ratio": torch.mean(is_ratio),
            }
        return total, stats


class APPO(IMPALA):
    _default_policy_class = APPOTorchPolicy

    @classmethod
    def get_default_config(cls) -> APPOConfig:
        return APPOConfig(cls)

    def __init__(self, config=None, env=None):
        super().__init__(config, env)
        self._last_target_refresh = 0

    def training_step(self) -> Dict:
        results = super().training_step()
        trained = self._counters[NUM_ENV_STEPS_TRAINED]
        freq = self.config.get("target_update_frequency", 1)
        batch_size = max(1, self.config.get("train_batch_size", 500))
        if trained - self._last_target_refresh >= freq * batch_size:
            self._last_target_refresh = trained
            self._counters["num_target_updates"] += 1
            self._refresh_target(results.get(DEFAULT_POLICY_ID, {}).get("kl"))
        return results

    def _refresh_target(self, kl: Optional[float]) -> None:
        """The target refresh and the KL adaptation, between two learner
        steps (under the learner thread's step lock)."""
        policy = self.get_policy()
        with self._learner_thread.lock:
            policy.update_target()
            if self.config.get("use_kl_loss") and kl is not None:
                target = self.config.get("kl_target", 0.01)
                if kl > 2.0 * target:
                    policy.coeff_values["kl_coeff"] *= 1.5
                elif kl < 0.5 * target:
                    policy.coeff_values["kl_coeff"] *= 0.5
