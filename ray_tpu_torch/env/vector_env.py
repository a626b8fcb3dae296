"""A vector env over N host sub-envs.

Copy of ``ray_tpu/env/vector_env.py``: the sub-envs step one after the
other in the worker's process.

**Terminal-observation contract** (the reference's): ``vector_step``
never resets by itself. At a ``terminated | truncated`` step it returns
the env's final observation, which the sampler records as that row's
NEXT_OBS (GAE bootstraps 0 across ``terminated`` and V(final obs)
across ``truncated``). The sampler then calls ``reset_at(index)``, and
the reset observation becomes the next row's OBS.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple


class VectorEnv:
    def __init__(self, observation_space, action_space, num_envs: int):
        self.observation_space = observation_space
        self.action_space = action_space
        self.num_envs = num_envs

    @staticmethod
    def vectorize_gym_envs(
        make_env: Callable[[int], Any],
        num_envs: int,
        seed: Optional[int] = None,
    ) -> "_VectorizedGymEnv":
        envs = [make_env(i) for i in range(num_envs)]
        return _VectorizedGymEnv(envs, seed=seed)

    def vector_reset(self) -> Tuple[List[Any], List[dict]]:
        raise NotImplementedError

    def reset_at(self, index: int) -> Tuple[Any, dict]:
        raise NotImplementedError

    def vector_step(self, actions):
        """→ (obs, rewards, terminateds, truncateds, infos)."""
        raise NotImplementedError

    def get_sub_environments(self) -> List[Any]:
        return []


class _VectorizedGymEnv(VectorEnv):
    def __init__(self, envs: List[Any], seed: Optional[int] = None):
        super().__init__(envs[0].observation_space, envs[0].action_space, len(envs))
        self.envs = envs
        self._seed = seed

    def vector_reset(self):
        obs, infos = [], []
        for i, e in enumerate(self.envs):
            seed = None if self._seed is None else self._seed + i
            o, info = e.reset(seed=seed)
            obs.append(o)
            infos.append(info)
        return obs, infos

    def reset_at(self, index: int):
        return self.envs[index].reset()

    def vector_step(self, actions):
        obs, rewards, terms, truncs, infos = [], [], [], [], []
        for e, a in zip(self.envs, actions):
            o, r, term, trunc, info = e.step(a)
            obs.append(o)
            rewards.append(float(r))
            terms.append(bool(term))
            truncs.append(bool(trunc))
            infos.append(info)
        return obs, rewards, terms, truncs, infos

    def get_sub_environments(self):
        return self.envs
