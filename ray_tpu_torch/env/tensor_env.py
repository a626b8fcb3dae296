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

:class:`TensorVectorEnvAdapter` drives a tensor env on the actor lane
(the reference's ``JaxVectorEnvAdapter``): the ``VectorEnv`` protocol
the samplers step, with the device lane's draws and resets, so the
same seed gives the same trajectories on both lanes.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

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


class TensorVectorEnvAdapter:
    """A :class:`TensorVectorEnv` of ``num_envs`` slots on ``device``
    behind the ``VectorEnv`` protocol (``vector_reset``, ``vector_step``,
    ``reset_at``), for the samplers of the actor lane.

    The draws are the device lane's (``DeviceRolloutEngine``): one
    generator seeded ``seed`` (0 when None) at ``vector_reset``, whose
    reset seeds every slot; then each ``vector_step`` draws the step's
    draws and every slot's reset draws, in that order, and computes the
    reset of every slot. The env itself never resets a slot: a finished
    slot shows its final observation until the sampler calls
    ``reset_at``, which puts in that slot's reset from the step, the
    state and observation the lane's select would have taken. So a
    fixed-seed trajectory is the lane's, bitwise, under the same
    actions."""

    def __init__(self, env: TensorVectorEnv, num_envs: int, seed: Optional[int] = None,
                 device=None):
        self.tensor_env = env
        self.num_envs = int(num_envs)
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self.device = torch.device(device or "cpu")
        self._seed = 0 if seed is None else int(seed)
        self.generator: Optional[torch.Generator] = None
        self._state: Optional[Dict[str, torch.Tensor]] = None
        self._resets = None  # (state, obs) of every slot's reset at the last step

    def _draw(self) -> torch.Tensor:
        return self.tensor_env.draw(self.generator, self.num_envs, self.device)

    def _rows(self, obs: torch.Tensor) -> List[np.ndarray]:
        host = obs.cpu().numpy()
        return [host[i] for i in range(self.num_envs)]

    @torch.no_grad()
    def vector_reset(self):
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self._seed)
        state = self.tensor_env.init(self.num_envs, self.device)
        self._state, obs = self.tensor_env.reset(state, self._draw())
        self._resets = None
        return self._rows(obs), [{} for _ in range(self.num_envs)]

    @torch.no_grad()
    def reset_at(self, index: int):
        state, obs = self._resets
        for k, v in self._state.items():
            v[index] = state[k][index]
        return obs[index].cpu().numpy(), {}

    @torch.no_grad()
    def vector_step(self, actions):
        act = torch.as_tensor(np.stack([np.asarray(a) for a in actions]), device=self.device)
        env = self.tensor_env
        state, obs, rew, term, trunc = env.step(self._state, act, self._draw())
        self._resets = env.reset(state, self._draw())
        self._state = state
        return (
            self._rows(obs),
            [float(r) for r in rew.float().cpu().tolist()],
            [bool(t) for t in term.cpu().tolist()],
            [bool(t) for t in trunc.cpu().tolist()],
            [{} for _ in range(self.num_envs)],
        )

    def get_sub_environments(self) -> List[Any]:
        return []
