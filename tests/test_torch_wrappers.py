"""The port's Atari wrappers (``env/wrappers.py``, on its own
``Wrapper``, no gymnasium) and ``DictFlatteningPreprocessor`` held
bitwise against the reference's (``ray_tpu/env/wrappers.py`` on
gymnasium, ``ray_tpu/models/preprocessors.py``), on the CPU.

- a seeded synthetic RGB env (a gymnasium ``Env``, so the reference's
  wrappers take it; lives both in ``unwrapped.ale.lives()`` and in
  ``info["lives"]``) driven by one action sequence through each wrapper
  and through ``wrap_deepmind``: observations, rewards, flags and infos
  bitwise, ``WarpFrame``'s float64 luminance, area mean and uint8 cast
  at 84 from 210 x 160 and its nearest-row path from a smaller frame;
  ``EpisodicLifeEnv`` on an env without ``ale`` reads ``info["lives"]``
  and ends the same episodes;
- ``DictFlatteningPreprocessor`` on nested Dict and Tuple spaces, the
  port's spaces and gymnasium's: shapes and transforms bitwise.
"""

from __future__ import annotations

import gymnasium as gym
import numpy as np
import pytest

from ray_tpu.env import wrappers as ref_w
from ray_tpu.models import preprocessors as ref_pre
from ray_tpu_torch.env import spaces as port_spaces
from ray_tpu_torch.env import wrappers as port_w
from ray_tpu_torch.models import preprocessors as pre


class _Ale:
    def __init__(self, env):
        self.env = env

    def lives(self):
        return self.env.lives


class SyntheticRGB(gym.Env):
    """Seeded random RGB frames; a life lost every 7 steps (3 lives), a
    reward in {-2, -1, 0, 1, 3} each step, the game over with the lives."""

    def __init__(self, h=210, w=160, with_ale=True):
        self.observation_space = gym.spaces.Box(0, 255, (h, w, 3), np.uint8)
        self.action_space = gym.spaces.Discrete(4)
        self.h, self.w = h, w
        if with_ale:
            self.ale = _Ale(self)
        self._rng = np.random.default_rng(0)
        self.lives = 3
        self.t = 0

    def _frame(self):
        return self._rng.integers(0, 256, (self.h, self.w, 3), dtype=np.uint8)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.lives, self.t = 3, 0
        return self._frame(), {"lives": self.lives}

    def step(self, action):
        self.t += 1
        if self.t % 7 == 0:
            self.lives -= 1
        reward = float(self._rng.choice([-2.0, -1.0, 0.0, 1.0, 3.0])) + 0.01 * int(action)
        return self._frame(), reward, self.lives == 0, False, {"lives": self.lives}


def _assert_same(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), what
        assert a.tobytes() == b.tobytes(), what
    elif isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _assert_same(a[k], b[k], f"{what}/{k}")
    else:
        assert type(a) is type(b) and a == b, f"{what}: {a!r} != {b!r}"


def _drive(env, actions, seed=3):
    out = [env.reset(seed=seed)]
    for a in actions:
        step = env.step(a)
        out.append(step)
        if step[2] or step[3]:
            out.append(env.reset(seed=seed))
    return out


def _compare(mine, theirs, steps=60, seed=3):
    actions = np.random.default_rng(1).integers(0, 4, steps).tolist()
    got, want = _drive(mine, actions, seed), _drive(theirs, actions, seed)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w)
        for j, (x, y) in enumerate(zip(g, w)):
            _assert_same(x, y, f"step {i} item {j}")
    assert mine.observation_space.shape == theirs.observation_space.shape
    assert np.dtype(mine.observation_space.dtype) == np.dtype(theirs.observation_space.dtype)


WRAPPERS = {
    "warp84": (lambda e: port_w.WarpFrame(e, 84), lambda e: ref_w.WarpFrame(e, 84)),
    "warp_small": (lambda e: port_w.WarpFrame(e, 84), lambda e: ref_w.WarpFrame(e, 84)),
    "max_and_skip": (lambda e: port_w.MaxAndSkipEnv(e, 4), lambda e: ref_w.MaxAndSkipEnv(e, 4)),
    "clip_reward": (port_w.ClipRewardEnv, ref_w.ClipRewardEnv),
    "episodic_life": (port_w.EpisodicLifeEnv, ref_w.EpisodicLifeEnv),
    "noop_reset": (lambda e: port_w.NoopResetEnv(e, 30), lambda e: ref_w.NoopResetEnv(e, 30)),
    "frame_stack": (lambda e: port_w.FrameStack(port_w.WarpFrame(e, 42), 4),
                    lambda e: ref_w.FrameStack(ref_w.WarpFrame(e, 42), 4)),
    "wrap_deepmind": (port_w.wrap_deepmind, ref_w.wrap_deepmind),
    "atari_stack": (
        lambda e: port_w.EpisodicLifeEnv(port_w.MaxAndSkipEnv(port_w.NoopResetEnv(e, 30), 4)),
        lambda e: ref_w.EpisodicLifeEnv(ref_w.MaxAndSkipEnv(ref_w.NoopResetEnv(e, 30), 4)),
    ),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_matches_reference(name):
    mine_fn, ref_fn = WRAPPERS[name]
    shape = (60, 50) if name == "warp_small" else (210, 160)
    mine, theirs = mine_fn(SyntheticRGB(*shape)), ref_fn(SyntheticRGB(*shape))
    _compare(mine, theirs)
    assert port_w.is_atari(mine) == ref_w.is_atari(theirs) is False


def test_episodic_life_reads_info_lives_without_ale():
    """An env with no ``ale`` gives its lives in ``info``: the port's
    ``EpisodicLifeEnv`` ends the same episodes as the reference's over an
    ALE-style env."""
    mine = port_w.EpisodicLifeEnv(SyntheticRGB(20, 16, with_ale=False))
    theirs = ref_w.EpisodicLifeEnv(SyntheticRGB(20, 16))
    _compare(mine, theirs, steps=40)


# -- DictFlatteningPreprocessor ------------------------------------------------------


def _nested(mod, box):
    return mod.Dict({
        "pos": box(-1.0, 1.0, (2, 3), np.float32),
        "kind": mod.Discrete(3),
        "inner": mod.Tuple((mod.Discrete(2), box(0.0, 5.0, (4,), np.float32),
                            mod.Dict({"z": box(-2.0, 2.0, (1,), np.float32),
                                      "a": mod.Discrete(4)}))),
    })


def _obs(rng):
    return {
        "pos": rng.uniform(-1, 1, (2, 3)).astype(np.float32),
        "kind": int(rng.integers(0, 3)),
        "inner": (int(rng.integers(0, 2)), rng.uniform(0, 5, 4).astype(np.float32),
                  {"z": rng.uniform(-2, 2, 1).astype(np.float32), "a": int(rng.integers(0, 4))}),
    }


def _gym_box(low, high, shape, dtype):
    return gym.spaces.Box(low, high, shape, dtype)


@pytest.mark.parametrize("which", ["port", "gymnasium"])
def test_dict_flattening_matches_reference(which):
    ref_space = _nested(gym.spaces, _gym_box)
    space = _nested(port_spaces, port_spaces.Box) if which == "port" else ref_space
    mine, theirs = pre.get_preprocessor_for_space(space), ref_pre.get_preprocessor_for_space(ref_space)
    assert type(mine).__name__ == type(theirs).__name__ == "DictFlatteningPreprocessor"
    assert tuple(mine.shape) == tuple(theirs.shape) == (2 * 3 + 3 + 2 + 4 + 1 + 4,)
    assert tuple(mine.observation_space.shape) == tuple(theirs.observation_space.shape)
    rng = np.random.default_rng(7)
    for _ in range(16):
        o = _obs(rng)
        _assert_same(mine.transform(o), theirs.transform(o), "transform")
    tup = (port_spaces.Tuple((port_spaces.Discrete(3), port_spaces.Box(0, 1, (2,), np.float32)))
           if which == "port" else gym.spaces.Tuple((gym.spaces.Discrete(3),
                                                     gym.spaces.Box(0, 1, (2,), np.float32))))
    ref_tup = ref_pre.get_preprocessor_for_space(
        gym.spaces.Tuple((gym.spaces.Discrete(3), gym.spaces.Box(0, 1, (2,), np.float32))))
    o = (2, np.array([0.25, 0.5], np.float32))
    _assert_same(pre.get_preprocessor_for_space(tup).transform(o), ref_tup.transform(o), "tuple")
