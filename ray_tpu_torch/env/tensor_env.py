"""TensorVectorEnv: the vectorized-env API of the device rollout lane.

Counterpart of ``ray_tpu/env/jax_env.py``. An env is three functions
over a batched state dict of tensors (leading dim N, on one device):

  - ``init(num_envs, device) -> state``
  - ``reset(state, draws) -> (state, obs)``  begin an episode in every row
  - ``step(state, action, draws) -> (state, obs, reward, terminated,
    truncated)``  one transition, NO auto-reset

Randomness is an input: ``draws`` is an (N, num_draws) float32 tensor
that the caller makes with :meth:`TensorVectorEnv.draw` from its own
``torch.Generator`` (the reference carried a PRNG key inside the state).
Tests hand both packages the same draws.

**Terminal-observation contract** (the reference's, unchanged): at a
step where ``terminated | truncated``, the row's NEXT_OBS is the final
(pre-reset) observation; the episode's successor row's OBS is the reset
observation of the new episode. GAE bootstraps 0 across ``terminated``
and V(final obs) across ``truncated``. Auto-reset is not part of the
env; the rollout engine does it by select (:func:`tree_where`).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.env.spaces import Box, Discrete


class ArraySpec(NamedTuple):
    """Static shape/dtype of one env's array (no batch dim)."""

    shape: Tuple[int, ...]
    dtype: Any
    # Discrete action count (None for continuous specs)
    num_values: Optional[int] = None


class TensorVectorEnv:
    obs_spec: ArraySpec
    action_spec: ArraySpec
    # float32 random numbers one env consumes per reset or step
    num_draws: int = 0

    def __init__(self, config: Optional[Dict] = None):
        self.config = dict(config or {})

    def init(self, num_envs: int, device: torch.device) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def reset(self, state, draws):
        raise NotImplementedError

    def step(self, state, action, draws):
        raise NotImplementedError

    def draw(
        self, generator: torch.Generator, num_envs: int, device: torch.device
    ) -> torch.Tensor:
        """(N, num_draws) uniform [0, 1) float32 draws."""
        return torch.rand(
            (num_envs, self.num_draws), generator=generator, device=device
        )

    @property
    def observation_space(self):
        spec = self.obs_spec
        if np.dtype(spec.dtype) == np.uint8:
            return Box(0, 255, spec.shape, np.uint8)
        return Box(-np.inf, np.inf, spec.shape, spec.dtype)

    @property
    def action_space(self):
        spec = self.action_spec
        if spec.num_values is not None:
            return Discrete(spec.num_values)
        return Box(-1.0, 1.0, spec.shape, spec.dtype)


def where_rows(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``where(mask, a, b)`` with the (N,) mask broadcast over the
    trailing dims of (N, ...) tensors of any rank."""
    return torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


def tree_where(mask: torch.Tensor, a: Dict, b: Dict) -> Dict:
    """Per-key :func:`where_rows` — the auto-reset selector."""
    return {k: where_rows(mask, x, b[k]) for k, x in a.items()}
