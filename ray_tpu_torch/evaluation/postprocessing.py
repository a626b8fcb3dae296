"""Host trajectory postprocessing (GAE) of the actor lane.

Copy of ``ray_tpu/evaluation/postprocessing.py``: numpy and
``scipy.signal.lfilter`` on the rollout workers, bitwise the
reference's for the same batch and ``last_r``. The device lane's GAE is
the CUDA kernel of ``ops/gae.py``; the actor lane does not use it, as
the reference's does not use its Pallas scan.
"""

from __future__ import annotations

import numpy as np
import scipy.signal

from ray_tpu_torch.data.sample_batch import SampleBatch


def discount_cumsum(x: np.ndarray, gamma: float) -> np.ndarray:
    """y[t] = sum_k gamma^k x[t+k], as an IIR filter."""
    return scipy.signal.lfilter([1], [1, float(-gamma)], x[::-1], axis=0)[::-1].astype(
        np.float32
    )


def compute_advantages(
    rollout: SampleBatch,
    last_r: float,
    gamma: float = 0.9,
    lambda_: float = 1.0,
    use_gae: bool = True,
    use_critic: bool = True,
) -> SampleBatch:
    """ADVANTAGES and VALUE_TARGETS of a fragment, bootstrapped with
    ``last_r``."""
    rewards = np.asarray(rollout[SampleBatch.REWARDS], np.float32)
    if use_gae:
        vpred = np.asarray(rollout[SampleBatch.VF_PREDS], np.float32)
        vpred_t = np.concatenate([vpred, np.array([last_r], np.float32)])
        delta_t = rewards + gamma * vpred_t[1:] - vpred_t[:-1]
        advantages = discount_cumsum(delta_t, gamma * lambda_)
        rollout[SampleBatch.ADVANTAGES] = advantages
        rollout[SampleBatch.VALUE_TARGETS] = (advantages + vpred).astype(np.float32)
    else:
        rewards_plus_v = np.concatenate([rewards, np.array([last_r], np.float32)])
        discounted_returns = discount_cumsum(rewards_plus_v, gamma)[:-1]
        if use_critic:
            vpred = np.asarray(rollout[SampleBatch.VF_PREDS], np.float32)
            rollout[SampleBatch.ADVANTAGES] = discounted_returns - vpred
            rollout[SampleBatch.VALUE_TARGETS] = discounted_returns
        else:
            rollout[SampleBatch.ADVANTAGES] = discounted_returns
            rollout[SampleBatch.VALUE_TARGETS] = np.zeros_like(discounted_returns)
    rollout[SampleBatch.ADVANTAGES] = rollout[SampleBatch.ADVANTAGES].astype(np.float32)
    return rollout


def compute_gae_for_sample_batch(
    policy, sample_batch: SampleBatch, other_agent_batches=None, episode=None
) -> SampleBatch:
    """Bootstrap the fragment's tail with V(s_T) when it was cut or
    truncated, 0 when its episode terminated. A recurrent policy steps
    from the state after the fragment's last step: the sampler's
    ``last_state_out``, else a ``state_out_k`` column's last row, else
    the initial state."""
    terminated = bool(sample_batch[SampleBatch.TERMINATEDS][-1])
    truncated = bool(
        sample_batch.get(SampleBatch.TRUNCATEDS, np.zeros(len(sample_batch), bool))[-1]
    )
    if terminated and not truncated:
        last_r = 0.0
    else:
        last_obs = sample_batch[SampleBatch.NEXT_OBS][-1]
        state = None
        if policy.is_recurrent:
            last = getattr(sample_batch, "last_state_out", None)
            if last is not None:
                state = [np.asarray(s)[None] for s in last]
            elif "state_out_0" in sample_batch:
                state = [sample_batch[f"state_out_{i}"][-1][None]
                         for i in range(len(policy.get_initial_state()))]
            else:
                state = [np.asarray(s)[None] for s in policy.get_initial_state()]
        last_r = float(policy.value_batch(last_obs[None], state)[0])
    return compute_advantages(
        sample_batch,
        last_r,
        policy.config.get("gamma", 0.99),
        policy.config.get("lambda", 1.0),
        use_gae=policy.config.get("use_gae", True),
        use_critic=policy.config.get("use_critic", True),
    )
