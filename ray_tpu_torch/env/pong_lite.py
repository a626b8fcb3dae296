"""PongLite on the host: the actor lane's Atari-shaped pixel env.

Copy of ``ray_tpu/env/pong_lite.py`` without gymnasium: the same
dynamics, the same ``np.random.default_rng(seed)`` draws in the same
order and the same ``reset``/``step`` five-tuple, with the port's
spaces (``env/spaces.py``) in place of a ``gym.Env`` base. 84x84 uint8
frames, Discrete(3) actions (stay, up, down): a ball bounces around the
field and the agent moves a right-edge paddle; contact rewards +1 and
serves a new rally, a miss -1. An episode is ``rallies`` rallies,
truncated at ``max_steps``.

Registered as ``PongLite-v0`` (framestacked, k = 4) and
``PongLiteFlat-v0`` (single frames). The device lane's tensor version is
``env/pong_lite_tensor.py`` (``PongLiteJax-v0``).
"""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.env.registry import register_env
from ray_tpu_torch.env.spaces import Box, Discrete

_SIZE = 84
_PADDLE_H = 12
_PADDLE_W = 2
_BALL = 2


class PongLite:
    metadata = {"render_modes": []}

    def __init__(self, config=None):
        config = config or {}
        self.rallies_per_episode = int(config.get("rallies", 21))
        self.max_steps = int(config.get("max_steps", 1000))
        self.paddle_speed = float(config.get("paddle_speed", 3.0))
        self._rng = np.random.default_rng(config.get("seed"))
        self.observation_space = Box(0, 255, (_SIZE, _SIZE, 1), np.uint8)
        self.action_space = Discrete(3)  # stay / up / down

    def _serve(self):
        self.bx = _SIZE * 0.3
        self.by = self._rng.uniform(_BALL, _SIZE - _BALL)
        angle = self._rng.uniform(-0.7, 0.7)
        speed = 2.2
        self.vx = speed * np.cos(angle)
        self.vy = speed * np.sin(angle)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.py = _SIZE / 2.0
        self.rallies = 0
        self.steps = 0
        self._serve()
        return self._render(), {}

    def step(self, action):
        self.steps += 1
        if action == 1:
            self.py -= self.paddle_speed
        elif action == 2:
            self.py += self.paddle_speed
        self.py = float(np.clip(self.py, _PADDLE_H / 2, _SIZE - _PADDLE_H / 2))

        self.bx += self.vx
        self.by += self.vy
        # top/bottom and left-wall bounces
        if self.by <= _BALL or self.by >= _SIZE - _BALL:
            self.vy = -self.vy
            self.by = float(np.clip(self.by, _BALL, _SIZE - _BALL))
        if self.bx <= _BALL:
            self.vx = abs(self.vx)
            self.bx = float(_BALL)

        reward = 0.0
        paddle_x = _SIZE - _PADDLE_W - 1
        if self.bx >= paddle_x - _BALL:
            if abs(self.by - self.py) <= _PADDLE_H / 2 + _BALL:
                reward = 1.0
                self.vx = -abs(self.vx)
                # spin: the contact point steers the return angle
                self.vy += 0.5 * (self.by - self.py) / (_PADDLE_H / 2)
                self.bx = float(paddle_x - _BALL)
            else:
                reward = -1.0
            self.rallies += 1
            if self.rallies < self.rallies_per_episode:
                self._serve()

        terminated = self.rallies >= self.rallies_per_episode
        truncated = self.steps >= self.max_steps
        return self._render(), reward, terminated, truncated, {}

    def _render(self):
        f = np.zeros((_SIZE, _SIZE, 1), np.uint8)
        by, bx = int(self.by), int(self.bx)
        f[max(0, by - _BALL) : by + _BALL, max(0, bx - _BALL) : bx + _BALL] = 255
        py = int(self.py)
        f[
            max(0, py - _PADDLE_H // 2) : py + _PADDLE_H // 2,
            _SIZE - _PADDLE_W - 1 : _SIZE - 1,
        ] = 180
        return f

    def close(self):
        pass


def make_pong_lite(config=None):
    """PongLite with the standard 4-frame stack (the Atari obs shape)."""
    from ray_tpu_torch.env.wrappers import FrameStack

    return FrameStack(PongLite(config), k=4)


register_env("PongLite-v0", make_pong_lite)
register_env("PongLiteFlat-v0", PongLite)
