"""The algorithm registry against the reference's, and the reset options
of the port's CartPole-v1 and Pendulum-v1 against gymnasium's envs.

- every name of the reference's ``_BUILTINS``: a class of the same
  name where the port has it (``ApexDQN`` and ``ApexDDPG`` included),
  else ``NotImplementedError`` naming its ROADMAP.md item; a name
  neither package knows raises the reference's ``ValueError``, with its
  message; ``register_algorithm`` resolves ahead of the built-ins;
- ``CartPole-v1`` with ``low``/``high`` and ``Pendulum-v1`` with
  ``x_init``/``y_init``: the first observation and an episode's steps
  bitwise against gymnasium's for the same seed, and a bad option
  refused as gymnasium refuses it.
"""

import gymnasium as gym
import numpy as np
import pytest

from ray_tpu.algorithms import registry as ref_registry
from ray_tpu_torch.algorithms import registry
from ray_tpu_torch.env.cartpole import CartPoleEnv
from ray_tpu_torch.env.pendulum import PendulumEnv


@pytest.mark.parametrize("name", sorted(ref_registry._BUILTINS))
def test_every_reference_name(name):
    if name in registry.ALGORITHMS:
        cls = registry.get_algorithm_class(name)
        assert cls.__name__ == ref_registry._BUILTINS[name][1]
        assert cls._registry_name == name
    else:
        item = registry.NOT_PORTED[name]
        with pytest.raises(NotImplementedError, match=rf"item {item}$"):
            registry.get_algorithm_class(name)


def test_unknown_name_and_register_algorithm():
    with pytest.raises(ValueError) as port:
        registry.get_algorithm_class("NoSuchAlgo")
    with pytest.raises(ValueError) as ref:
        ref_registry.get_algorithm_class("NoSuchAlgo")
    assert str(port.value) == str(ref.value)
    assert set(registry.ALGORITHMS) | set(registry.NOT_PORTED) == set(ref_registry._BUILTINS)

    class Custom:
        pass

    registry.register_algorithm("CustomAlgo", lambda: Custom)
    try:
        assert registry.get_algorithm_class("CustomAlgo") is Custom
        assert Custom._registry_name == "CustomAlgo"
    finally:
        registry._ALGORITHMS.pop("CustomAlgo")


def _episode(env, seed, options, actions):
    obs, _ = env.reset(seed=seed, options=options)
    out = [obs]
    for a in actions:
        obs, rew, term, trunc, _ = env.step(a)
        out.append((obs, rew, term, trunc))
        if term or trunc:
            break
    return out


def _equal(a, b):
    assert len(a) == len(b)
    np.testing.assert_array_equal(a[0], b[0])
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x[0], y[0])
        assert x[1:] == y[1:]


@pytest.mark.parametrize("options", [None, {}, {"low": -0.2}, {"high": 0.1},
                                     {"low": -0.5, "high": 0.5}, {"low": "0.01", "high": 0.02}])
def test_cartpole_reset_options_bitwise_gymnasium(options):
    actions = np.random.default_rng(0).integers(0, 2, 60)
    gym_env = gym.make("CartPole-v1").unwrapped
    _equal(_episode(CartPoleEnv(), 7, options, actions), _episode(gym_env, 7, options, actions))


@pytest.mark.parametrize("options", [None, {}, {"x_init": 0.5}, {"y_init": 2.0},
                                     {"x_init": 1.0, "y_init": 0.25}])
def test_pendulum_reset_options_bitwise_gymnasium(options):
    actions = np.random.default_rng(1).uniform(-2, 2, (40, 1)).astype(np.float32)
    gym_env = gym.make("Pendulum-v1").unwrapped
    port = _episode(PendulumEnv(), 5, options, actions)
    ref = _episode(gym_env, 5, options, actions)
    np.testing.assert_array_equal(port[0], ref[0])
    for x, y in zip(port[1:], ref[1:]):
        np.testing.assert_array_equal(x[0], y[0])
        assert np.float64(x[1]) == np.float64(y[1]) and x[2] == y[2]


def test_bad_reset_options_refused_as_gymnasium():
    for env, options in ((CartPoleEnv(), {"low": 0.2, "high": 0.1}),
                         (CartPoleEnv(), {"low": "x"}),
                         (PendulumEnv(), {"x_init": None})):
        with pytest.raises(ValueError) as port:
            env.reset(seed=0, options=options)
        gym_env = gym.make("CartPole-v1" if isinstance(env, CartPoleEnv) else "Pendulum-v1")
        with pytest.raises(ValueError) as ref:
            gym_env.unwrapped.reset(seed=0, options=options)
        assert str(port.value) == str(ref.value)
