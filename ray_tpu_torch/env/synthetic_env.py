"""SyntheticEnv: a near-free env for measuring what the framework moves.

Copy of ``ray_tpu/env/synthetic_env.py`` on the port's own spaces (the
card's machine has no gymnasium). A step indexes a pool of
pre-generated observations, so a run on it measures the sampler, action
inference and shipping with the env's cost near zero. The observation is
a float vector (``obs_dim``) and the reward a fixed function of the pool
index, so gradients are not degenerate; nothing is meant to be learned.
Registered as ``SyntheticFast-v0``; the same config and seed give the
reference's observations and rewards bitwise.
"""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.env.registry import register_env
from ray_tpu_torch.env.spaces import Box, Discrete


class SyntheticEnv:
    def __init__(self, config=None):
        config = config or {}
        self.obs_dim = int(config.get("obs_dim", 16))
        self.num_actions = int(config.get("num_actions", 4))
        self.episode_len = int(config.get("episode_len", 200))
        pool = int(config.get("pool", 256))
        rng = np.random.default_rng(int(config.get("seed", 0)))
        self._pool = rng.standard_normal((pool, self.obs_dim)).astype(np.float32)
        self._rewards = rng.standard_normal(pool).astype(np.float32)
        self.observation_space = Box(-np.inf, np.inf, (self.obs_dim,), np.float32)
        self.action_space = Discrete(self.num_actions)
        self._i = 0
        self._t = 0

    def reset(self, *, seed=None, options=None):
        self._t = 0
        self._i = (self._i + 1) % len(self._pool)
        return self._pool[self._i], {}

    def step(self, action):
        self._t += 1
        self._i = (self._i + int(action) + 1) % len(self._pool)
        return (self._pool[self._i], float(self._rewards[self._i]), False,
                self._t >= self.episode_len, {})


register_env("SyntheticFast-v0", lambda cfg: SyntheticEnv(cfg))
