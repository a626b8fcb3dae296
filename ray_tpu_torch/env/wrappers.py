"""Env wrappers, without gymnasium.

Counterpart of ``ray_tpu/env/wrappers.py``; this slice ports
:class:`FrameStack` only (the other Atari wrappers wait, ``ROADMAP.md``
queue 1 item 3). A wrapper forwards ``reset``/``step``/``close`` and any
other attribute to the env it wraps.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from ray_tpu_torch.env.spaces import Box


class Wrapper:
    def __init__(self, env):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space

    @property
    def unwrapped(self):
        return getattr(self.env, "unwrapped", self.env)

    def reset(self, **kwargs):
        return self.env.reset(**kwargs)

    def step(self, action):
        return self.env.step(action)

    def close(self):
        close = getattr(self.env, "close", None)
        if close is not None:
            close()

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.env, name)


class FrameStack(Wrapper):
    """Stack the last k frames along the channel axis (the reference's
    ``FrameStack``)."""

    def __init__(self, env, k: int = 4):
        super().__init__(env)
        self.k = k
        self.frames = deque([], maxlen=k)
        shp = env.observation_space.shape
        self.observation_space = Box(
            0, 255, (shp[0], shp[1], shp[2] * k), env.observation_space.dtype
        )

    def reset(self, **kwargs):
        ob, info = self.env.reset(**kwargs)
        for _ in range(self.k):
            self.frames.append(ob)
        return self._get_ob(), info

    def step(self, action):
        ob, reward, term, trunc, info = self.env.step(action)
        self.frames.append(ob)
        return self._get_ob(), reward, term, trunc, info

    def _get_ob(self):
        return np.concatenate(list(self.frames), axis=2)
