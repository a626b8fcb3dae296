"""Observation preprocessors (host numpy).

Copy of ``ray_tpu/models/preprocessors.py``: they run on the rollout
workers before observations enter a batch, so the learner sees flat,
fixed-shape float or uint8 arrays. Spaces are read by their attributes,
not their class (the port's spaces and gymnasium's alike): a discrete
space has ``n`` and shape (), a multi-discrete one ``nvec``, a
composite one ``spaces``. ``DictFlatteningPreprocessor`` waits for a
Dict or Tuple space in the port (``ROADMAP.md`` queue 1 item 3d).
"""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.env.spaces import Box


def _is_discrete(space) -> bool:
    return getattr(space, "n", None) is not None and tuple(getattr(space, "shape", ()) or ()) == ()


def _is_multi_discrete(space) -> bool:
    return getattr(space, "nvec", None) is not None


class Preprocessor:
    def __init__(self, obs_space):
        self._obs_space = obs_space
        self.shape = self._init_shape(obs_space)
        self._size = int(np.prod(self.shape))

    def _init_shape(self, obs_space):
        raise NotImplementedError

    def transform(self, observation) -> np.ndarray:
        raise NotImplementedError

    @property
    def size(self) -> int:
        return self._size

    @property
    def observation_space(self):
        space = Box(-1.0, 1.0, self.shape, np.float32)
        space.original_space = self._obs_space
        return space


class NoPreprocessor(Preprocessor):
    def _init_shape(self, obs_space):
        return obs_space.shape

    def transform(self, observation):
        return np.asarray(observation)

    @property
    def observation_space(self):
        return self._obs_space


class OneHotPreprocessor(Preprocessor):
    """Discrete (or MultiDiscrete) → one-hot."""

    def _init_shape(self, obs_space):
        if _is_discrete(obs_space):
            return (int(obs_space.n),)
        return (int(np.sum(obs_space.nvec)),)

    def transform(self, observation):
        out = np.zeros(self.shape, dtype=np.float32)
        if _is_discrete(self._obs_space):
            out[int(observation)] = 1.0
        else:
            offset = 0
            for i, n in enumerate(self._obs_space.nvec):
                out[offset + int(observation[i])] = 1.0
                offset += int(n)
        return out


class FlattenPreprocessor(Preprocessor):
    def _init_shape(self, obs_space):
        return (int(np.prod(obs_space.shape)),)

    def transform(self, observation):
        return np.asarray(observation, dtype=np.float32).reshape(-1)


def get_preprocessor_for_space(obs_space) -> Preprocessor:
    """The reference's ``ModelCatalog.get_preprocessor``."""
    if _is_discrete(obs_space) or _is_multi_discrete(obs_space):
        return OneHotPreprocessor(obs_space)
    if getattr(obs_space, "spaces", None) is not None:
        raise NotImplementedError(
            "Dict and Tuple observation spaces (DictFlatteningPreprocessor) "
            "are not ported yet: ROADMAP.md queue 1 item 3d"
        )
    return NoPreprocessor(obs_space)
