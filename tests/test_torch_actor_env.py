"""The actor lane's host envs, preprocessors and filters against the
reference's, on the CPU.

Every contract here is bitwise: host numpy code on the same inputs.

- ``PongLite`` (``env/pong_lite.py``) against ``ray_tpu/env/pong_lite.py``
  over a fixed action sequence, through episode ends (terminated and
  truncated), framestacked (``PongLite-v0``) and flat;
- ``FrameStack`` on a counter env;
- ``VectorEnv.vectorize_gym_envs``'s terminal-observation contract: the
  final obs at a done step, the reset obs from ``reset_at``;
- the preprocessors on the port's spaces and gymnasium's, and
  ``MeanStdFilter`` through pushes, ``apply_changes`` and ``sync``;
- the registry: the host and tensor PongLite names resolve to their own
  modules, CartPole-v1 resolves to the port's own (``env/cartpole.py``,
  held bitwise against gymnasium's in ``tests/test_torch_multi_agent.py``)
  and resets as gymnasium's does, and the port imports and builds its
  host envs with gymnasium blocked.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys
import textwrap

import gymnasium as gym
import numpy as np
import pytest

from ray_tpu.env import registry as ref_registry
from ray_tpu.env.vector_env import VectorEnv as RefVectorEnv
from ray_tpu.env.wrappers import FrameStack as RefFrameStack
from ray_tpu.models import preprocessors as ref_pre
from ray_tpu.utils import filter as ref_filter
from ray_tpu_torch.env import registry
from ray_tpu_torch.env.pong_lite import PongLite
from ray_tpu_torch.env.pong_lite_tensor import PongLiteTensor
from ray_tpu_torch.env.spaces import Box, Discrete
from ray_tpu_torch.env.vector_env import VectorEnv
from ray_tpu_torch.env.wrappers import FrameStack
from ray_tpu_torch.models import preprocessors as pre
from ray_tpu_torch.utils import filter as filt

REPO = pathlib.Path(__file__).resolve().parents[1]
ENV_CFG = {"rallies": 2, "max_steps": 56}  # episodes end both ways


def _actions(n, seed=0):
    return np.random.default_rng(seed).integers(0, 3, n)


def _assert_same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b), what


@pytest.mark.parametrize("name", ["PongLite-v0", "PongLiteFlat-v0"])
def test_ponglite_matches_reference(name):
    port = registry.get_env_creator(name)(dict(ENV_CFG))
    ref = ref_registry.get_env_creator(name)(dict(ENV_CFG))
    for seed in (0, 7):
        (po, _), (ro, _) = port.reset(seed=seed), ref.reset(seed=seed)
        _assert_same(po, ro, "reset obs")
        ends = []
        for t, a in enumerate(_actions(300, seed)):
            p, r = port.step(int(a)), ref.step(int(a))
            _assert_same(p[0], r[0], f"obs at {t}")
            assert p[1:4] == r[1:4], (t, p[1:4], r[1:4])
            if p[2] or p[3]:
                ends.append((p[2], p[3]))
                (po, _), (ro, _) = port.reset(), ref.reset()
                _assert_same(po, ro, f"reset obs after {t}")
        assert (True, False) in ends and (False, True) in ends, ends
    assert port.observation_space.shape == ref.observation_space.shape
    assert port.observation_space.dtype == ref.observation_space.dtype
    assert port.action_space.n == ref.action_space.n


class _Counter:
    """A single-channel image env whose frame t is filled with t."""

    def __init__(self, config=None):
        self.observation_space = Box(0, 255, (3, 2, 1), np.uint8)
        self.action_space = Discrete(2)

    def reset(self, *, seed=None, options=None):
        self.t = 0 if seed is None else seed
        return np.full((3, 2, 1), self.t, np.uint8), {}

    def step(self, action):
        self.t += 1 + int(action)
        return np.full((3, 2, 1), self.t, np.uint8), float(self.t), self.t > 20, False, {}


class _GymCounter(_Counter, gym.Env):
    def __init__(self, config=None):
        super().__init__(config)
        self.observation_space = gym.spaces.Box(0, 255, (3, 2, 1), np.uint8)
        self.action_space = gym.spaces.Discrete(2)


@pytest.mark.parametrize("k", [2, 4])
def test_framestack_matches_reference(k):
    port, ref = FrameStack(_Counter(), k=k), RefFrameStack(_GymCounter(), k=k)
    assert port.observation_space.shape == ref.observation_space.shape == (3, 2, k)
    _assert_same(port.reset(seed=3)[0], ref.reset(seed=3)[0], "reset")
    for t, a in enumerate(_actions(12, k)):
        p, r = port.step(int(a)), ref.step(int(a))
        _assert_same(p[0], r[0], f"stack at {t}")
        assert p[1:4] == r[1:4]


def test_vector_env_terminal_obs_contract():
    """A done step returns the final observation; ``reset_at`` then gives
    the reset one. Same obs, rewards and flags as the reference's vector
    env over PongLite-v0 (3 envs, seed 11)."""
    make_p = registry.get_env_creator("PongLite-v0")
    make_r = ref_registry.get_env_creator("PongLite-v0")
    cfg = {"rallies": 1, "max_steps": 40}
    port = VectorEnv.vectorize_gym_envs(lambda i: make_p(dict(cfg)), 3, seed=11)
    ref = RefVectorEnv.vectorize_gym_envs(lambda i: make_r(dict(cfg)), 3, seed=11)
    for a, b in zip(port.vector_reset()[0], ref.vector_reset()[0]):
        _assert_same(a, b, "reset")
    dones = 0
    for t, acts in enumerate(np.random.default_rng(1).integers(0, 3, (90, 3))):
        p, r = port.vector_step(list(acts)), ref.vector_step(list(acts))
        for i in range(3):
            _assert_same(p[0][i], r[0][i], f"obs {t},{i}")
        assert p[1:4] == r[1:4]
        for i in range(3):
            if p[2][i] or p[3][i]:
                dones += 1
                final = p[0][i]
                reset_p, reset_r = port.reset_at(i)[0], ref.reset_at(i)[0]
                _assert_same(reset_p, reset_r, f"reset_at {t},{i}")
                # the final obs is the episode's, not the reset's
                assert not np.array_equal(final, reset_p)
    assert dones >= 3


@pytest.mark.parametrize("case", ["discrete", "multi_discrete", "box", "image", "flatten"])
def test_preprocessors_match_reference(case):
    rng = np.random.default_rng(0)
    if case == "discrete":
        spaces = [Discrete(5), gym.spaces.Discrete(5)]
        ref_space, obs = gym.spaces.Discrete(5), [0, 3, 4]
    elif case == "multi_discrete":
        spaces = [gym.spaces.MultiDiscrete([3, 4])]
        ref_space, obs = gym.spaces.MultiDiscrete([3, 4]), [np.array([2, 1]), np.array([0, 3])]
    elif case in ("box", "flatten"):
        spaces = [Box(-1, 1, (2, 3), np.float32), gym.spaces.Box(-1, 1, (2, 3), np.float32)]
        ref_space = gym.spaces.Box(-1, 1, (2, 3), np.float32)
        obs = [rng.standard_normal((2, 3)).astype(np.float32) for _ in range(3)]
    else:
        spaces = [Box(0, 255, (84, 84, 4), np.uint8), gym.spaces.Box(0, 255, (84, 84, 4), np.uint8)]
        ref_space = gym.spaces.Box(0, 255, (84, 84, 4), np.uint8)
        obs = [rng.integers(0, 255, (84, 84, 4), dtype=np.uint8)]
    if case == "flatten":
        ref_p = ref_pre.FlattenPreprocessor(ref_space)
        ports = [pre.FlattenPreprocessor(s) for s in spaces]
    else:
        ref_p = ref_pre.get_preprocessor_for_space(ref_space)
        ports = [pre.get_preprocessor_for_space(s) for s in spaces]
    for p in ports:
        assert type(p).__name__ == type(ref_p).__name__
        assert tuple(p.shape) == tuple(ref_p.shape) and p.size == ref_p.size
        assert tuple(p.observation_space.shape) == tuple(ref_p.observation_space.shape)
        for o in obs:
            _assert_same(p.transform(o), ref_p.transform(o), case)


def test_dict_spaces_wait_with_a_pointer():
    """Dict spaces are ported: ``DictFlatteningPreprocessor`` on
    gymnasium's Dict and the port's, bitwise the reference's (nested
    cases: tests/test_torch_wrappers.py)."""
    from ray_tpu_torch.env import spaces as port_spaces

    ref_p = ref_pre.get_preprocessor_for_space(gym.spaces.Dict({"a": gym.spaces.Discrete(2)}))
    for space in (gym.spaces.Dict({"a": gym.spaces.Discrete(2)}),
                  port_spaces.Dict({"a": port_spaces.Discrete(2)})):
        p = pre.get_preprocessor_for_space(space)
        assert type(p).__name__ == "DictFlatteningPreprocessor" and p.shape == ref_p.shape == (2,)
        for o in (0, 1):
            assert p.transform({"a": o}).tobytes() == ref_p.transform({"a": o}).tobytes()


def _assert_filters_equal(p, r):
    for a, b in ((p.rs, r.rs), (p.buffer, r.buffer)):
        assert a.num == b.num
        _assert_same(a.mean_, b.mean_, "mean")
        _assert_same(a.s, b.s, "s")


def test_mean_std_filter_matches_reference():
    rng = np.random.default_rng(3)
    shape = (4,)
    port, ref = filt.get_filter("MeanStdFilter", shape), ref_filter.get_filter("MeanStdFilter", shape)
    worker_p, worker_r = filt.MeanStdFilter(shape), ref_filter.MeanStdFilter(shape)
    for i in range(6):
        x = (rng.standard_normal((5, 4)) * (i + 1) + i).astype(np.float32)
        _assert_same(port(x), ref(x), f"batch {i}")
        _assert_same(port(x[0]), ref(x[0]), f"row {i}")
        _assert_same(worker_p(x[::-1]), worker_r(x[::-1]), f"worker {i}")
        _assert_same(port(x, update=False), ref(x, update=False), f"frozen {i}")
    port.apply_changes(worker_p.as_serializable(), with_buffer=False)
    ref.apply_changes(worker_r.as_serializable(), with_buffer=False)
    _assert_filters_equal(port, ref)
    worker_p.sync(port.copy())
    worker_r.sync(ref.copy())
    _assert_filters_equal(worker_p, worker_r)
    worker_p.clear_buffer()
    worker_r.clear_buffer()
    _assert_filters_equal(worker_p, worker_r)
    x = rng.standard_normal((3, 4)).astype(np.float32) * 100
    _assert_same(worker_p(x), worker_r(x), "clipped")
    assert isinstance(filt.get_filter("NoFilter", shape), filt.NoFilter)
    _assert_same(filt.get_filter(None, shape)(x), x, "no filter")


def test_registry_resolves_host_and_tensor_ponglite():
    assert type(registry.get_env_creator("PongLite-v0")({})).__name__ == "FrameStack"
    stacked = registry.get_env_creator("PongLite-v0")({})
    assert isinstance(stacked, FrameStack) and isinstance(stacked.env, PongLite)
    assert stacked.observation_space.shape == (84, 84, 4)
    assert isinstance(registry.get_env_creator("PongLiteFlat-v0")({}), PongLite)
    assert isinstance(registry.get_env_creator("PongLiteJax-v0")({}), PongLiteTensor)
    with pytest.raises(ValueError, match="unknown in-repo env"):
        registry.get_env_creator("PongLiteNope-v0")


def test_cartpole_through_the_registry():
    env = registry.get_env_creator("CartPole-v1")({})
    assert env.observation_space.shape == (4,) and int(env.action_space.n) == 2
    assert pre.get_preprocessor_for_space(env.observation_space).shape == (4,)
    obs, _ = env.reset(seed=0)
    ref_obs, _ = gym.make("CartPole-v1").reset(seed=0)
    _assert_same(obs, ref_obs, "reset")
    assert env.step(1)[0].shape == (4,)


def test_port_builds_host_envs_without_gymnasium():
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys

        class _Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] == "gymnasium":
                    raise ImportError(name + " blocked by test")
                return None

        sys.meta_path.insert(0, _Block())
        import ray_tpu_torch
        for m in pkgutil.walk_packages(ray_tpu_torch.__path__, "ray_tpu_torch."):
            importlib.import_module(m.name)
        from ray_tpu_torch.env.registry import get_env_creator
        env = get_env_creator("PongLite-v0")({})
        obs, _ = env.reset(seed=0)
        assert obs.shape == (84, 84, 4) and env.step(1)[0].shape == (84, 84, 4)
        assert "gymnasium" not in sys.modules
        print("ok")
        """
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr
