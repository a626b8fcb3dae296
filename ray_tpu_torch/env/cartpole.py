"""CartPole-v1 as a host env of the port's own.

The card's machine has no gymnasium, so the port writes the dynamics of
gymnasium's ``CartPole-v1`` (``gymnasium/envs/classic_control/
cartpole.py``, 1.2.2) under ``TimeLimit(500)`` itself and registers it
as ``CartPole-v1``: the CartPole yamls and the multi-agent CartPole
configs run unchanged on either machine. Constants, operation order and
NumPy types are gymnasium's, so the two envs agree bitwise (``tests/
test_torch_multi_agent.py``):

- the state is float64 and the observation its float32 copy;
- one Euler step of the pole's equations with ``force = ±10``;
- the episode terminates when ``|x| > 2.4`` or ``|theta| > 12°``; the
  terminating step's reward is 1, and a step after it (which gymnasium
  warns of) gets 0;
- ``reset(seed=...)`` draws the state from ``uniform(-0.05, 0.05,
  (4,))`` of a ``PCG64(SeedSequence(seed))`` generator, the stream of
  gymnasium's ``Env.reset``; a reset without a seed keeps the stream,
  and the first one without any seed draws its seed from entropy;
- the 500th step of an episode is truncated (``TimeLimit``).

``config["sutton_barto_reward"]`` is gymnasium's one constructor
argument (rewards 0 while the pole stands and -1 when it falls).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

from ray_tpu_torch.env.registry import register_env
from ray_tpu_torch.env.spaces import Box, Discrete


def float_option(x) -> float:
    """A reset option as a float, refused as gymnasium refuses it."""
    try:
        return float(x)
    except (ValueError, TypeError) as e:
        raise ValueError(f"An option ({x}) could not be converted to a float.") from e

MAX_EPISODE_STEPS = 500


class CartPoleEnv:
    gravity = 9.8
    masscart = 1.0
    masspole = 0.1
    total_mass = masspole + masscart
    length = 0.5  # half the pole's length
    polemass_length = masspole * length
    force_mag = 10.0
    tau = 0.02  # seconds between state updates
    theta_threshold_radians = 12 * 2 * math.pi / 360
    x_threshold = 2.4

    def __init__(self, config: Optional[Dict] = None):
        config = dict(config or {})
        self._sutton_barto_reward = bool(config.get("sutton_barto_reward", False))
        high = np.array(
            [self.x_threshold * 2, np.inf, self.theta_threshold_radians * 2, np.inf],
            dtype=np.float32,
        )
        self.action_space = Discrete(2)
        self.observation_space = Box(-high, high, dtype=np.float32)
        self.np_random: Optional[np.random.Generator] = None
        self.state = None
        self.steps_beyond_terminated = None
        self._elapsed_steps = 0

    def reset(self, *, seed: Optional[int] = None, options=None):
        """gymnasium's reset: ``options`` may give the uniform draw's
        ``low`` and ``high`` (default -0.05 and 0.05)."""
        low, high = -0.05, 0.05
        if options is not None:
            low = float_option(options.get("low", low))
            high = float_option(options.get("high", high))
            if low > high:
                raise ValueError(f"Lower bound ({low}) must be lower than higher bound ({high}).")
        if seed is not None or self.np_random is None:
            self.np_random = np.random.Generator(np.random.PCG64(np.random.SeedSequence(seed)))
        self.state = self.np_random.uniform(low=low, high=high, size=(4,))
        self.steps_beyond_terminated = None
        self._elapsed_steps = 0
        return np.array(self.state, dtype=np.float32), {}

    def step(self, action):
        if action not in (0, 1):
            raise ValueError(f"{action!r} ({type(action)}) invalid")
        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta = np.cos(theta)
        sintheta = np.sin(theta)
        temp = (force + self.polemass_length * np.square(theta_dot) * sintheta) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * np.square(costheta) / self.total_mass)
        )
        xacc = temp - self.polemass_length * thetaacc * costheta / self.total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self.state = np.array((x, x_dot, theta, theta_dot), dtype=np.float64)

        terminated = bool(
            x < -self.x_threshold
            or x > self.x_threshold
            or theta < -self.theta_threshold_radians
            or theta > self.theta_threshold_radians
        )
        if not terminated:
            reward = 0.0 if self._sutton_barto_reward else 1.0
        elif self.steps_beyond_terminated is None:
            self.steps_beyond_terminated = 0
            reward = -1.0 if self._sutton_barto_reward else 1.0
        else:
            self.steps_beyond_terminated += 1
            reward = -1.0 if self._sutton_barto_reward else 0.0
        self._elapsed_steps += 1
        truncated = self._elapsed_steps >= MAX_EPISODE_STEPS
        return np.array(self.state, dtype=np.float32), reward, terminated, truncated, {}

    def close(self) -> None:
        pass


register_env("CartPole-v1", CartPoleEnv)
