"""Env wrappers, without gymnasium: deepmind-style Atari preprocessing
and frame stacking.

Counterpart of ``ray_tpu/env/wrappers.py`` (``is_atari``,
``FrameStack``, ``MaxAndSkipEnv``, ``ClipRewardEnv``, ``WarpFrame``,
``EpisodicLifeEnv``, ``NoopResetEnv``, ``wrap_deepmind``) on the port's
own :class:`Wrapper`, which forwards ``reset``/``step``/``close`` and
any other attribute to the env it wraps (the card's machine has no
gymnasium). ``WarpFrame`` computes the reference's float64 luminance,
area mean and uint8 cast, so its frames are the reference's bit for
bit. ``EpisodicLifeEnv`` reads the lives of an ALE env
(``unwrapped.ale.lives()``), as the reference does, and of any other env
from ``info["lives"]``.
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


class RewardWrapper(Wrapper):
    def step(self, action):
        ob, reward, term, trunc, info = self.env.step(action)
        return ob, self.reward(reward), term, trunc, info

    def reward(self, reward):
        raise NotImplementedError


class ObservationWrapper(Wrapper):
    def reset(self, **kwargs):
        ob, info = self.env.reset(**kwargs)
        return self.observation(ob), info

    def step(self, action):
        ob, reward, term, trunc, info = self.env.step(action)
        return self.observation(ob), reward, term, trunc, info

    def observation(self, ob):
        raise NotImplementedError


def is_atari(env) -> bool:
    return hasattr(env, "unwrapped") and type(env.unwrapped).__module__.startswith("ale_py")


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


class MaxAndSkipEnv(Wrapper):
    """Repeat the action ``skip`` times; the max over the last two frames."""

    def __init__(self, env, skip: int = 4):
        super().__init__(env)
        self._obs_buffer = np.zeros((2,) + env.observation_space.shape, dtype=env.observation_space.dtype)
        self._skip = skip

    def step(self, action):
        total_reward = 0.0
        term = trunc = False
        info = {}
        for i in range(self._skip):
            obs, reward, term, trunc, info = self.env.step(action)
            if i == self._skip - 2:
                self._obs_buffer[0] = obs
            if i == self._skip - 1:
                self._obs_buffer[1] = obs
            total_reward += float(reward)
            if term or trunc:
                break
        return self._obs_buffer.max(axis=0), total_reward, term, trunc, info


class ClipRewardEnv(RewardWrapper):
    def reward(self, reward):
        return float(np.sign(reward))


class WarpFrame(ObservationWrapper):
    """``dim`` x ``dim`` grayscale: the float64 luminance, then an area
    mean over a crop to a multiple of ``dim`` (nearest rows and columns
    when the frame is smaller), cast to uint8."""

    def __init__(self, env, dim: int = 84):
        super().__init__(env)
        self.dim = dim
        self.observation_space = Box(0, 255, (dim, dim, 1), np.uint8)

    def observation(self, frame):
        if frame.ndim == 3 and frame.shape[2] == 3:
            frame = 0.299 * frame[..., 0] + 0.587 * frame[..., 1] + 0.114 * frame[..., 2]
        h, w = frame.shape[:2]
        fh, fw = h // self.dim, w // self.dim
        if fh >= 1 and fw >= 1:
            frame = frame[: fh * self.dim, : fw * self.dim]
            frame = frame.reshape(self.dim, fh, self.dim, fw).mean(axis=(1, 3))
        else:
            ys = (np.arange(self.dim) * h // self.dim).clip(0, h - 1)
            xs = (np.arange(self.dim) * w // self.dim).clip(0, w - 1)
            frame = frame[ys][:, xs]
        return frame.astype(np.uint8)[:, :, None]


def _lives(env, info) -> int:
    ale = getattr(env.unwrapped, "ale", None)
    if ale is not None:
        return int(ale.lives())
    return int(info.get("lives", 0))


class EpisodicLifeEnv(Wrapper):
    """A lost life ends the episode; the env resets only when the game
    is over."""

    def __init__(self, env):
        super().__init__(env)
        self.lives = 0
        self.was_real_done = True

    def step(self, action):
        obs, reward, term, trunc, info = self.env.step(action)
        self.was_real_done = term or trunc
        lives = _lives(self.env, info)
        if 0 < lives < self.lives:
            term = True
        self.lives = lives
        return obs, reward, term, trunc, info

    def reset(self, **kwargs):
        if self.was_real_done:
            obs, info = self.env.reset(**kwargs)
        else:
            obs, _, _, _, info = self.env.step(0)
        self.lives = _lives(self.env, info)
        return obs, info


class NoopResetEnv(Wrapper):
    """1 to ``noop_max`` no-op steps after each reset, counted from a
    generator of its own (seeded by ``reset(seed=)``)."""

    def __init__(self, env, noop_max: int = 30):
        super().__init__(env)
        self.noop_max = noop_max
        self._noop_rng = np.random.default_rng()

    def reset(self, **kwargs):
        if kwargs.get("seed") is not None:
            self._noop_rng = np.random.default_rng(kwargs["seed"])
        obs, info = self.env.reset(**kwargs)
        noops = int(self._noop_rng.integers(1, self.noop_max + 1))
        for _ in range(noops):
            obs, _, term, trunc, info = self.env.step(0)
            if term or trunc:
                obs, info = self.env.reset(**kwargs)
        return obs, info


def wrap_deepmind(env, dim: int = 84, framestack: bool = True):
    """The reference's ``wrap_deepmind``: no-op resets, frame skipping and
    episodic lives for an ALE env, then ``WarpFrame``, ``ClipRewardEnv``
    and (``framestack``) a 4-frame ``FrameStack``."""
    if is_atari(env):
        env = NoopResetEnv(env, noop_max=30)
        env = MaxAndSkipEnv(env, skip=4)
        env = EpisodicLifeEnv(env)
    env = WarpFrame(env, dim)
    env = ClipRewardEnv(env)
    if framestack:
        env = FrameStack(env, 4)
    return env
