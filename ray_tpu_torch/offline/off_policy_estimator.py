"""Off-policy evaluation: importance sampling (IS) and weighted
importance sampling (WIS).

Copy of ``ray_tpu/offline/off_policy_estimator.py``. Given logged
episodes with the behaviour policy's ``action_logp``, the target policy
is scored without running it: per-step ratios ``rho_t = pi(a|s) /
pi_b(a|s)`` (the log-ratio clipped to [-20, 20]), cumulated within each
episode, ``P_t = prod_{k<=t} rho_k``.

- IS:  ``V = mean over episodes of sum_t gamma^t * P_t * r_t``;
- WIS: the same, each ``P_t`` divided by its mean over the episodes at
  the same step index.

The target policy's log-likelihoods come from one
``policy.compute_log_likelihoods(actions, obs)`` over the whole batch
(one forward on the policy's device, one copy back), sliced by episode
after; the reference calls it once an episode. Sums are float64 on the
host, as the reference's.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ray_tpu_torch.data.sample_batch import SampleBatch


class OffPolicyEstimator:
    def __init__(self, policy, gamma: float = 0.99):
        self.policy = policy
        self.gamma = gamma

    def _episodes(self, batch: SampleBatch) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Each episode's float64 rewards and ratios ``rho_t``, in the
        order of its ``eps_id`` (the whole batch without one)."""
        new_logp = self.policy.compute_log_likelihoods(
            batch[SampleBatch.ACTIONS], batch[SampleBatch.OBS]
        )
        old_logp = np.asarray(batch[SampleBatch.ACTION_LOGP])
        ratios = np.exp(np.clip(new_logp - old_logp, -20.0, 20.0))
        rewards = np.asarray(batch[SampleBatch.REWARDS], np.float64)
        if SampleBatch.EPS_ID not in batch:
            return [(rewards, ratios)]
        eps = np.asarray(batch[SampleBatch.EPS_ID])
        out = []
        for eid in np.unique(eps):
            idx = np.nonzero(eps == eid)[0]
            out.append((rewards[idx], ratios[idx]))
        return out

    def estimate(self, batch: SampleBatch) -> Dict[str, float]:
        raise NotImplementedError


def _summary(v_behavior: List[float], v_target: List[float]) -> Dict[str, float]:
    vb = float(np.mean(v_behavior))
    vt = float(np.mean(v_target))
    return {"v_behavior": vb, "v_target": vt, "v_gain": vt / vb if vb != 0 else np.nan}


class ImportanceSampling(OffPolicyEstimator):
    def estimate(self, batch: SampleBatch) -> Dict[str, float]:
        v_behavior, v_target = [], []
        for rewards, ratios in self._episodes(batch):
            gammas = self.gamma ** np.arange(len(rewards))
            p = np.cumprod(ratios)
            v_behavior.append(float((gammas * rewards).sum()))
            v_target.append(float((gammas * p * rewards).sum()))
        return _summary(v_behavior, v_target)


class WeightedImportanceSampling(OffPolicyEstimator):
    def estimate(self, batch: SampleBatch) -> Dict[str, float]:
        episodes = self._episodes(batch)
        all_p = [np.cumprod(ratios) for _, ratios in episodes]
        max_t = max(len(p) for p in all_p)
        # the per-step-index mean of the cumulative ratios over the
        # episodes (the WIS normaliser w_t)
        sums = np.zeros(max_t)
        counts = np.zeros(max_t)
        for p in all_p:
            sums[: len(p)] += p
            counts[: len(p)] += 1
        w = sums / np.maximum(counts, 1)
        v_behavior, v_target = [], []
        for (rewards, _), p in zip(episodes, all_p):
            T = len(rewards)
            gammas = self.gamma ** np.arange(T)
            norm_p = p / np.maximum(w[:T], 1e-8)
            v_behavior.append(float((gammas * rewards).sum()))
            v_target.append(float((gammas * norm_p * rewards).sum()))
        return _summary(v_behavior, v_target)
