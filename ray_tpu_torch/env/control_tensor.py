"""CartPole and the four-rooms gridworld on tensors: the device lane's
classic-control envs.

Counterpart of ``ray_tpu/env/jax_control.py`` (``CartPoleJax``,
``GridRoomsJax``), registered under the same names, ``CartPoleJax-v0``
and ``GridRoomsJax-v0``, so the reference's tuned examples run
unchanged. All N envs step as one batch of tensors.

Randomness is an input, as for PongLite: a reset takes an (N,
num_draws) float32 tensor of uniform [0, 1) draws. CartPole maps its 4
draws to [-0.05, 0.05) as ``jax.random.uniform(minval, maxval)`` does
(``max(lo, u * (hi - lo) + lo)`` with float32 bounds and the
multiply-add rounded once), so the reference's own uniforms reproduce
its reset bitwise.
GridRooms turns its 2 draws into the start cell ``floor(u * room)``,
the cell ``jax.random.randint(0, room)`` draws. Neither env's step
uses its draws.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.env.registry import register_env
from ray_tpu_torch.env.tensor_env import ArraySpec, TensorVectorEnv

# the reset's bounds and span in float32, as jax.random.uniform casts them
_RESET_LO = float(np.float32(-0.05))
_RESET_SPAN = float(np.float32(0.05) - np.float32(-0.05))


class CartPoleTensor(TensorVectorEnv):
    """gymnasium CartPole-v1 as the reference writes it: the same
    constants, the same Euler order and float32 arithmetic, a ±0.05
    uniform reset, termination at |x| > 2.4 or |θ| > 12°, reward 1 per
    step, truncation at ``max_steps`` (500, configurable)."""

    obs_spec = ArraySpec((4,), np.float32)
    action_spec = ArraySpec((), np.int32, num_values=2)
    num_draws = 4

    _GRAVITY = 9.8
    _MASSCART = 1.0
    _MASSPOLE = 0.1
    _LENGTH = 0.5  # half pole length
    _FORCE_MAG = 10.0
    _TAU = 0.02
    _THETA_LIMIT = 12 * 2 * math.pi / 360
    _X_LIMIT = 2.4

    def __init__(self, config: Optional[Dict] = None):
        super().__init__(config)
        self.max_steps = int(self.config.get("max_steps", 500))

    def init(self, num_envs, device):
        return {
            "s": torch.zeros((num_envs, 4), dtype=torch.float32, device=device),
            "steps": torch.zeros(num_envs, dtype=torch.int32, device=device),
        }

    def reset(self, state, draws):
        # XLA contracts u * span + lo into one rounding; the product of
        # two float32 values is exact in float64, so one float64
        # multiply-add rounded to float32 gives the reference's values
        s = torch.clamp_min((draws.double() * _RESET_SPAN + _RESET_LO).float(), _RESET_LO)
        return {"s": s, "steps": torch.zeros_like(state["steps"])}, s

    def step(self, state, action, draws):
        s = state["s"]
        x, x_dot, theta, theta_dot = s.unbind(1)
        force = torch.where(action == 1, self._FORCE_MAG, -self._FORCE_MAG)
        costh = torch.cos(theta)
        sinth = torch.sin(theta)
        total_mass = self._MASSCART + self._MASSPOLE
        polemass_length = self._MASSPOLE * self._LENGTH
        temp = (force + polemass_length * theta_dot**2 * sinth) / total_mass
        theta_acc = (self._GRAVITY * sinth - costh * temp) / (
            self._LENGTH * (4.0 / 3.0 - self._MASSPOLE * costh**2 / total_mass)
        )
        x_acc = temp - polemass_length * theta_acc * costh / total_mass
        x = x + self._TAU * x_dot
        x_dot = x_dot + self._TAU * x_acc
        theta = theta + self._TAU * theta_dot
        theta_dot = theta_dot + self._TAU * theta_acc
        s = torch.stack([x, x_dot, theta, theta_dot], dim=1)
        steps = state["steps"] + 1
        terminated = (torch.abs(x) > self._X_LIMIT) | (torch.abs(theta) > self._THETA_LIMIT)
        truncated = steps >= self.max_steps
        reward = torch.ones_like(x)
        return {"s": s, "steps": steps}, s, reward, terminated, truncated


class GridRoomsTensor(TensorVectorEnv):
    """The reference's four-rooms gridworld (``size`` x ``size``, walls
    on the middle row and column with a door in each arm): a start cell
    uniform in the top-left room, the goal in the bottom-right corner
    (+1 and terminated), 4 moves, truncation at ``max_steps``. The
    observation is the (row, col) cell scaled to [0, 1] in float32.
    Integer logic throughout, so it is bitwise the reference's."""

    obs_spec = ArraySpec((2,), np.float32)
    action_spec = ArraySpec((), np.int32, num_values=4)
    num_draws = 2

    def __init__(self, config: Optional[Dict] = None):
        super().__init__(config)
        self.size = int(self.config.get("size", 9))
        self.max_steps = int(self.config.get("max_steps", 100))
        if self.size % 2 == 0:
            raise ValueError("GridRoomsJax needs an odd size")

    def _wall(self, r, c):
        mid = self.size // 2
        door = mid // 2
        on_mid = (r == mid) | (c == mid)
        gap = ((r == mid) & ((c == door) | (c == self.size - 1 - door))) | (
            (c == mid) & ((r == door) | (r == self.size - 1 - door))
        )
        return on_mid & ~gap

    def _obs(self, pos):
        return pos.to(torch.float32) / float(self.size - 1)

    def init(self, num_envs, device):
        return {
            "pos": torch.zeros((num_envs, 2), dtype=torch.int32, device=device),
            "steps": torch.zeros(num_envs, dtype=torch.int32, device=device),
        }

    def reset(self, state, draws):
        room = self.size // 2  # the top-left room spans [0, mid)
        pos = torch.clamp((draws * room).to(torch.int32), 0, room - 1)
        return {"pos": pos, "steps": torch.zeros_like(state["steps"])}, self._obs(pos)

    def step(self, state, action, draws):
        # the reference's moves: 0 up, 1 down, 2 left, 3 right
        move = torch.stack([
            (action == 1).to(torch.int32) - (action == 0).to(torch.int32),
            (action == 3).to(torch.int32) - (action == 2).to(torch.int32),
        ], dim=1)
        nxt = torch.clamp(state["pos"] + move, 0, self.size - 1)
        blocked = self._wall(nxt[:, 0], nxt[:, 1])
        pos = torch.where(blocked[:, None], state["pos"], nxt)
        goal = (pos == self.size - 1).all(dim=1)
        steps = state["steps"] + 1
        return (
            {"pos": pos, "steps": steps},
            self._obs(pos),
            goal.to(torch.float32),
            goal,
            steps >= self.max_steps,
        )


register_env("CartPoleJax-v0", lambda cfg: CartPoleTensor(cfg))
register_env("GridRoomsJax-v0", lambda cfg: GridRoomsTensor(cfg))
