"""Pendulum-v1 as a host env of the port's own.

The card's machine has no gymnasium, so the port writes the dynamics of
gymnasium's ``Pendulum-v1`` (``gymnasium/envs/classic_control/
pendulum.py``, 1.2.2) under ``TimeLimit(200)`` itself and registers it
as ``Pendulum-v1``: SAC's and PPO's Pendulum yamls run unchanged on
either machine. Constants, operation order and NumPy types are
gymnasium's, so the two envs agree bitwise (``tests/
test_torch_pendulum.py``):

- the state is float64; the observation ``[cos th, sin th, thdot]`` is
  float32;
- ``u = clip(action, -2, 2)[0]`` keeps the action's NumPy type (float32
  from the sampler), so under NumPy 2's promotion ``0.001 * u**2`` and
  ``3 / (m l^2) * u`` round in float32 while the angle and velocity
  terms are float64;
- the reward is ``-(angle_normalize(th)**2 + 0.1 thdot**2 + 0.001 u**2)``,
  velocity clipped to ±8 after the Euler step;
- ``reset(seed=...)`` draws the state from ``uniform(-[pi, 1], [pi,
  1])`` of a ``PCG64(SeedSequence(seed))`` generator, the stream of
  gymnasium's ``Env.reset``; a reset without a seed keeps the stream;
- the 200th step of an episode is truncated (``TimeLimit``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ray_tpu_torch.env.registry import register_env
from ray_tpu_torch.env.spaces import Box

MAX_EPISODE_STEPS = 200


def angle_normalize(x):
    return ((x + np.pi) % (2 * np.pi)) - np.pi


class PendulumEnv:
    max_speed = 8
    max_torque = 2.0
    dt = 0.05
    m = 1.0
    l = 1.0  # noqa: E741 (gymnasium's name)

    def __init__(self, config: Optional[Dict] = None):
        config = dict(config or {})
        self.g = config.get("g", 10.0)  # gymnasium's one constructor argument
        high = np.array([1.0, 1.0, self.max_speed], dtype=np.float32)
        self.action_space = Box(-self.max_torque, self.max_torque, (1,), np.float32)
        self.observation_space = Box(-high, high, dtype=np.float32)
        self.np_random: Optional[np.random.Generator] = None
        self.state = None
        self._elapsed_steps = 0

    def reset(self, *, seed: Optional[int] = None, options=None):
        if options:
            raise NotImplementedError("Pendulum-v1 reset options (x_init, y_init)")
        if seed is not None or self.np_random is None:
            self.np_random = np.random.Generator(np.random.PCG64(np.random.SeedSequence(seed)))
        high = np.array([np.pi, 1.0])
        self.state = self.np_random.uniform(low=-high, high=high)
        self._elapsed_steps = 0
        return self._get_obs(), {}

    def step(self, u):
        th, thdot = self.state
        g, m, l, dt = self.g, self.m, self.l, self.dt
        u = np.clip(u, -self.max_torque, self.max_torque)[0]
        costs = angle_normalize(th) ** 2 + 0.1 * thdot**2 + 0.001 * (u**2)
        newthdot = thdot + (3 * g / (2 * l) * np.sin(th) + 3.0 / (m * l**2) * u) * dt
        newthdot = np.clip(newthdot, -self.max_speed, self.max_speed)
        newth = th + newthdot * dt
        self.state = np.array([newth, newthdot])
        self._elapsed_steps += 1
        truncated = self._elapsed_steps >= MAX_EPISODE_STEPS
        return self._get_obs(), -costs, False, truncated, {}

    def _get_obs(self):
        theta, thetadot = self.state
        return np.array([np.cos(theta), np.sin(theta), thetadot], dtype=np.float32)

    def close(self) -> None:
        pass


register_env("Pendulum-v1", PendulumEnv)
