"""Observation preprocessors (host numpy).

Copy of ``ray_tpu/models/preprocessors.py``: they run on the rollout
workers before observations enter a batch, so the learner sees flat,
fixed-shape float or uint8 arrays. Spaces are read by their attributes,
not their class (the port's spaces and gymnasium's alike): a discrete
space has ``n`` and shape (), a multi-discrete one ``nvec``, a
composite one ``spaces`` (a mapping for a Dict space, whose keys it
flattens in sorted order, as the reference does; a sequence for a Tuple
space).
"""

from __future__ import annotations

from collections.abc import Mapping

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


class DictFlatteningPreprocessor(Preprocessor):
    """A Dict or Tuple space → one flat float32 vector: each sub-space's
    preprocessor, Dict keys in sorted order (the reference's
    ``DictFlatteningPreprocessor`` / ``TupleFlatteningPreprocessor``)."""

    def _init_shape(self, obs_space):
        subs = obs_space.spaces
        if isinstance(subs, Mapping):
            self._keys = sorted(subs)
            items = [subs[k] for k in self._keys]
        else:
            self._keys = None
            items = list(subs)
        self._children = [get_preprocessor_for_space(sp) for sp in items]
        return (sum(c.size for c in self._children),)

    def transform(self, observation):
        if self._keys is not None:
            parts = [c.transform(observation[k]).reshape(-1)
                     for c, k in zip(self._children, self._keys)]
        else:
            parts = [c.transform(o).reshape(-1) for c, o in zip(self._children, observation)]
        return np.concatenate([p.astype(np.float32) for p in parts])


def get_preprocessor_for_space(obs_space) -> Preprocessor:
    """The reference's ``ModelCatalog.get_preprocessor``."""
    if _is_discrete(obs_space) or _is_multi_discrete(obs_space):
        return OneHotPreprocessor(obs_space)
    if getattr(obs_space, "spaces", None) is not None:
        return DictFlatteningPreprocessor(obs_space)
    return NoPreprocessor(obs_space)
