"""PongLite on tensors: the device lane's Atari-shaped env.

Counterpart of ``ray_tpu/env/jax_pong.py`` (``PongLiteJax``), registered
under the same name, ``PongLiteJax-v0``, so the reference's tuned
examples run unchanged. Same constants and the same update order: 84x84
uint8 frames rendered from (ball, paddle) state, Discrete(3) actions,
+1 paddle contact / -1 miss, ``rallies`` rallies per episode,
truncation at ``max_steps``. All N envs step as one batch of tensors.

The serve draws are an input: ``draws`` is an (N, 3) float32 tensor of
(by, vx, vy) per env, made by :meth:`PongLiteTensor.draw` from the
caller's generator. ``reset`` serves from it; ``step`` uses it where a
rally ends and the episode goes on (the reference drew a serve on every
step and used it only there).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.env.registry import register_env
from ray_tpu_torch.env.tensor_env import ArraySpec, TensorVectorEnv

_SIZE = 84
_PADDLE_H = 12
_PADDLE_W = 2
_BALL = 2
_SPEED = 2.2
_SERVE_X = float(np.float32(_SIZE * 0.3))


class PongLiteTensor(TensorVectorEnv):
    obs_spec = ArraySpec((_SIZE, _SIZE, 1), np.uint8)
    action_spec = ArraySpec((), np.int32, num_values=3)
    num_draws = 3

    def __init__(self, config: Optional[Dict] = None):
        super().__init__(config)
        cfg = self.config
        self.rallies_per_episode = int(cfg.get("rallies", 21))
        self.max_steps = int(cfg.get("max_steps", 1000))
        self.paddle_speed = float(cfg.get("paddle_speed", 3.0))

    def draw(self, generator, num_envs, device):
        """(N, 3) serves (by, vx, vy): by uniform on [2, 82), the angle
        uniform on [-0.7, 0.7), speed 2.2."""
        u = torch.rand((num_envs, 2), generator=generator, device=device)
        by = _BALL + u[:, 0] * (_SIZE - 2 * _BALL)
        angle = u[:, 1] * 1.4 - 0.7
        return torch.stack(
            [by, _SPEED * torch.cos(angle), _SPEED * torch.sin(angle)], dim=1
        )

    @staticmethod
    def _render(py, bx, by) -> torch.Tensor:
        """(N,) positions → (N, 84, 84, 1) uint8 frames."""
        grid = torch.arange(_SIZE, device=py.device, dtype=torch.int32)
        rows = grid[None, :, None]
        cols = grid[None, None, :]
        byi = by.to(torch.int32)[:, None, None]
        bxi = bx.to(torch.int32)[:, None, None]
        pyi = py.to(torch.int32)[:, None, None]
        ball = (
            (rows >= torch.clamp_min(byi - _BALL, 0))
            & (rows < byi + _BALL)
            & (cols >= torch.clamp_min(bxi - _BALL, 0))
            & (cols < bxi + _BALL)
        )
        paddle = (
            (rows >= torch.clamp_min(pyi - _PADDLE_H // 2, 0))
            & (rows < pyi + _PADDLE_H // 2)
            & (cols >= _SIZE - _PADDLE_W - 1)
            & (cols < _SIZE - 1)
        )
        frame = torch.where(
            ball, 255, torch.where(paddle, 180, 0)
        ).to(torch.uint8)
        return frame[..., None]

    def init(self, num_envs, device):
        f = torch.zeros(num_envs, dtype=torch.float32, device=device)
        i = torch.zeros(num_envs, dtype=torch.int32, device=device)
        return {
            "py": f, "bx": f.clone(), "by": f.clone(), "vx": f.clone(),
            "vy": f.clone(), "rallies": i, "steps": i.clone(),
        }

    def reset(self, state, draws):
        n = draws.shape[0]
        py = torch.full((n,), _SIZE / 2.0, device=draws.device)
        state = {
            "py": py,
            "bx": torch.full_like(py, _SERVE_X),
            "by": draws[:, 0].contiguous(),
            "vx": draws[:, 1].contiguous(),
            "vy": draws[:, 2].contiguous(),
            "rallies": torch.zeros_like(state["rallies"]),
            "steps": torch.zeros_like(state["steps"]),
        }
        return state, self._render(state["py"], state["bx"], state["by"])

    def step(self, state, action, draws):
        speed = self.paddle_speed
        py = state["py"]
        py = torch.where(
            action == 1, py - speed, torch.where(action == 2, py + speed, py)
        )
        py = torch.clamp(py, _PADDLE_H / 2.0, float(_SIZE - _PADDLE_H / 2))

        bx = state["bx"] + state["vx"]
        by = state["by"] + state["vy"]
        vx, vy = state["vx"], state["vy"]
        # top/bottom and left-wall bounces
        wall = (by <= _BALL) | (by >= _SIZE - _BALL)
        vy = torch.where(wall, -vy, vy)
        by = torch.clamp(by, float(_BALL), float(_SIZE - _BALL))
        left = bx <= _BALL
        vx = torch.where(left, torch.abs(vx), vx)
        bx = torch.where(left, torch.full_like(bx, _BALL), bx)

        paddle_x = _SIZE - _PADDLE_W - 1
        at_paddle = bx >= paddle_x - _BALL
        hit = at_paddle & (torch.abs(by - py) <= _PADDLE_H / 2.0 + _BALL)
        reward = torch.where(
            at_paddle,
            torch.where(hit, 1.0, -1.0),
            torch.zeros_like(bx),
        )
        # contact: reflect + spin + pin to the contact line
        vx = torch.where(hit, -torch.abs(vx), vx)
        vy = torch.where(hit, vy + 0.5 * (by - py) / (_PADDLE_H / 2.0), vy)
        bx = torch.where(hit, torch.full_like(bx, paddle_x - _BALL), bx)

        rallies = state["rallies"] + at_paddle.to(torch.int32)
        # serve a new rally (hit or miss) while the episode continues
        serve = at_paddle & (rallies < self.rallies_per_episode)
        bx = torch.where(serve, torch.full_like(bx, _SERVE_X), bx)
        by = torch.where(serve, draws[:, 0], by)
        vx = torch.where(serve, draws[:, 1], vx)
        vy = torch.where(serve, draws[:, 2], vy)

        steps = state["steps"] + 1
        terminated = rallies >= self.rallies_per_episode
        truncated = steps >= self.max_steps
        state = {
            "py": py, "bx": bx, "by": by, "vx": vx, "vy": vy,
            "rallies": rallies, "steps": steps,
        }
        return state, self._render(py, bx, by), reward, terminated, truncated


register_env("PongLiteJax-v0", lambda cfg: PongLiteTensor(cfg))
