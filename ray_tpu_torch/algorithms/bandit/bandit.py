"""Contextual bandits: LinUCB and linear Thompson sampling.

Counterpart of ``ray_tpu/algorithms/bandit/bandit.py``: per-arm exact
Bayesian linear regression over the context, every arm's statistics in
stacked tensors on the policy's device (precision (A, d, d), starting at
``lambda_reg · I``; moment (A, d)). Scoring inverts the precisions once
(``theta_a = P_a^-1 b_a``) and takes the mean plus ``ucb_coeff`` times
the posterior std (LinUCB), or the mean under ``theta_a + std · L_a z_a``
with ``L_a`` the Cholesky factor of ``P_a^-1`` and ``z`` standard
normals (LinTS: drawn from the policy's generator, or given as
``noise``); the update adds each row's rank-1 outer product and reward ·
context to its arm's statistics through a one-hot. The reference
computes these outside any Pallas kernel, and so does the port, with
``torch.linalg``.

The bandit env of the chip smoke (:class:`LinearContextBandit`) is the
port's own: numpy, no gymnasium.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.algorithms.algorithm import (
    NUM_AGENT_STEPS_SAMPLED,
    NUM_ENV_STEPS_SAMPLED,
    Algorithm,
    refuse_device_lane,
)
from ray_tpu_torch.algorithms.algorithm_config import AlgorithmConfig
from ray_tpu_torch.data.sample_batch import DEFAULT_POLICY_ID, SampleBatch
from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.env.spaces import Box, Discrete
from ray_tpu_torch.execution.rollout_ops import synchronous_parallel_sample
from ray_tpu_torch.policy.policy import Policy


class BanditConfig(AlgorithmConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class)
        self.rollout_fragment_length = 1
        self.train_batch_size = 1
        self.lambda_reg = 0.1  # the ridge prior's precision
        self.min_time_s_per_iteration = None


class BanditLinUCBConfig(BanditConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or BanditLinUCB)
        self.ucb_coeff = 1.0


class BanditLinTSConfig(BanditConfig):
    def __init__(self, algo_class=None):
        super().__init__(algo_class or BanditLinTS)
        self.sample_theta_std = 1.0


def _is_discrete(space) -> bool:
    """The port's ``Discrete`` or gymnasium's (by class name: the port
    imports no gymnasium)."""
    return isinstance(space, Discrete) or (
        type(space).__name__ == "Discrete" and hasattr(space, "n"))


class LinearBanditPolicy(Policy):
    """Stacked per-arm online linear regression, scored by UCB
    (``exploit = "ucb"``) or Thompson sampling (``"ts"``)."""

    exploit = "ucb"

    def __init__(self, observation_space, action_space, config: Dict, device=None):
        super().__init__(observation_space, action_space, config)
        if not _is_discrete(action_space):
            raise ValueError("bandits require a Discrete action space")
        self.device = resolve_device(device)
        self.num_arms = int(action_space.n)
        self.dim = int(np.prod(observation_space.shape))
        lam = float(config.get("lambda_reg", 0.1))
        eye = torch.eye(self.dim, dtype=torch.float32, device=self.device)
        self.precision = (lam * eye)[None].repeat(self.num_arms, 1, 1)
        self.moment = torch.zeros((self.num_arms, self.dim), dtype=torch.float32, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(config.get("seed") or 0))
        self.ucb_coeff = float(config.get("ucb_coeff", 1.0))
        self.ts_std = float(config.get("sample_theta_std", 1.0))
        self.last_learn_timers: Dict[str, float] = {}

    # -- scoring ----------------------------------------------------------

    @torch.no_grad()
    def scores(self, ctx: torch.Tensor, explore: bool = True,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, A) scores of contexts (B, d): the posterior means, plus
        the exploration's term when ``explore``; LinTS's (A, d) standard
        normals are ``noise`` or drawn from :attr:`generator`."""
        cov = torch.linalg.inv(self.precision)
        theta = torch.einsum("aij,aj->ai", cov, self.moment)
        mean = torch.einsum("bd,ad->ba", ctx, theta)
        if not explore:
            return mean
        if self.exploit == "ucb":
            var = torch.einsum("bi,aij,bj->ba", ctx, cov, ctx)
            return mean + self.ucb_coeff * torch.sqrt(torch.clamp_min(var, 1e-12))
        chol = torch.linalg.cholesky(cov + 1e-8 * torch.eye(self.dim, device=self.device)[None])
        if noise is None:
            noise = torch.randn(theta.shape, generator=self.generator, device=self.device)
        theta_s = theta + self.ts_std * torch.einsum("aij,aj->ai", chol, noise.to(self.device))
        return torch.einsum("bd,ad->ba", ctx, theta_s)

    def compute_actions(self, obs_batch, state_batches=None, prev_action_batch=None,
                        prev_reward_batch=None, explore: bool = True, noise=None, **kwargs):
        ctx = torch.as_tensor(np.asarray(obs_batch, np.float32), device=self.device).reshape(
            len(obs_batch), -1)
        actions = torch.argmax(self.scores(ctx, explore, noise), dim=-1)
        return actions.cpu().numpy(), [], {}

    # -- learning: the exact posterior update ------------------------------

    @torch.no_grad()
    def learn_on_batch(self, samples) -> Dict:
        n = samples.count
        ctx = torch.as_tensor(np.asarray(samples[SampleBatch.OBS], np.float32),
                              device=self.device).reshape(n, -1)
        actions = torch.as_tensor(np.asarray(samples[SampleBatch.ACTIONS]), device=self.device)
        rewards = torch.as_tensor(np.asarray(samples[SampleBatch.REWARDS], np.float32),
                                  device=self.device)
        onehot = torch.nn.functional.one_hot(actions.long(), self.num_arms).float()
        outer = torch.einsum("bi,bj->bij", ctx, ctx)
        self.precision = self.precision + torch.einsum("ba,bij->aij", onehot, outer)
        self.moment = self.moment + torch.einsum("ba,b,bi->ai", onehot, rewards, ctx)
        return {"update_count": int(n), "mean_reward": float(rewards.mean())}

    # -- state ------------------------------------------------------------

    def get_weights(self, read=None) -> Dict[str, np.ndarray]:
        return {"precision": self.precision.cpu().numpy(), "moment": self.moment.cpu().numpy()}

    def set_weights(self, weights) -> None:
        self.precision = torch.from_numpy(np.array(weights["precision"], np.float32)).to(self.device)
        self.moment = torch.from_numpy(np.array(weights["moment"], np.float32)).to(self.device)


class _UCBPolicy(LinearBanditPolicy):
    exploit = "ucb"


class _TSPolicy(LinearBanditPolicy):
    exploit = "ts"


class _BanditBase(Algorithm):
    _actor_lane = True

    def training_step(self) -> Dict:
        """Sample ``train_batch_size`` env steps, one exact update, the
        statistics to every worker."""
        refuse_device_lane(self)
        batch = synchronous_parallel_sample(
            worker_set=self.workers, max_env_steps=self.config.get("train_batch_size", 1))
        if hasattr(batch, "policy_batches"):
            batch = batch.policy_batches[DEFAULT_POLICY_ID]
        self._counters[NUM_ENV_STEPS_SAMPLED] += batch.env_steps()
        self._counters[NUM_AGENT_STEPS_SAMPLED] += batch.env_steps()
        info = self.get_policy().learn_on_batch(batch)
        self.workers.sync_weights()
        return {DEFAULT_POLICY_ID: info}


class BanditLinUCB(_BanditBase):
    _default_policy_class = _UCBPolicy

    @classmethod
    def get_default_config(cls) -> BanditLinUCBConfig:
        return BanditLinUCBConfig(cls)


class BanditLinTS(_BanditBase):
    _default_policy_class = _TSPolicy

    @classmethod
    def get_default_config(cls) -> BanditLinTSConfig:
        return BanditLinTSConfig(cls)


class LinearContextBandit:
    """A linear-context bandit: each step shows a context of ``dim``
    standard normals; arm a pays ``context · w_a`` plus normal noise of
    std ``noise``, with the arms' weights ``w`` drawn once from
    ``weights_seed``. An episode is one step. ``env_config``: ``dim``
    (8), ``arms`` (4), ``noise`` (0.1), ``weights_seed`` (0)."""

    def __init__(self, config: Optional[Dict] = None):
        cfg = dict(config or {})
        self.dim = int(cfg.get("dim", 8))
        self.arms = int(cfg.get("num_arms", 4))
        self.noise = float(cfg.get("noise", 0.1))
        self.weights = np.random.default_rng(int(cfg.get("weights_seed", 0))).standard_normal(
            (self.arms, self.dim)).astype(np.float32)
        self.observation_space = Box(-10.0, 10.0, (self.dim,), np.float32)
        self.action_space = Discrete(self.arms)
        self._rng = np.random.default_rng()
        self._ctx = None

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._ctx = self._rng.standard_normal(self.dim).astype(np.float32)
        return self._ctx.copy(), {}

    def expected_rewards(self, ctx: np.ndarray) -> np.ndarray:
        """Every arm's mean reward at ``ctx``."""
        return np.asarray(ctx, np.float32) @ self.weights.T

    def step(self, action):
        mean = float(self.expected_rewards(self._ctx)[int(action)])
        reward = mean + self.noise * float(self._rng.standard_normal())
        return self._ctx.copy(), reward, True, False, {"regret": float(
            self.expected_rewards(self._ctx).max() - mean)}

    def close(self) -> None:
        pass
