"""Multi-agent environment interface.

Copy of ``ray_tpu/env/multi_agent_env.py``: dict-in / dict-out stepping
keyed by agent id, with the special ``__all__`` key in the terminated
and truncated dicts, and :func:`make_multi_agent`, N independent copies
of a single-agent env. A string env name goes through the port's own
registry (``env/registry.get_env_creator``), so ``CartPole-v1`` is the
port's ``env/cartpole.py`` and any other gymnasium id still reaches
gymnasium (``GymCreator``).

As in the reference, ``reset()`` without a seed passes none to the
sub-envs: each keeps its own stream (an unseeded one draws from
entropy).
"""

from __future__ import annotations

from typing import Dict, Optional, Set, Tuple

from ray_tpu_torch.env.registry import get_env_creator


class MultiAgentEnv:
    def __init__(self):
        self._agent_ids: Set = set()
        if not hasattr(self, "observation_space"):
            self.observation_space = None
        if not hasattr(self, "action_space"):
            self.action_space = None

    def reset(self, *, seed: Optional[int] = None, options: Optional[dict] = None) -> Tuple[Dict, Dict]:
        """→ (obs_dict, info_dict) of the agents that act first."""
        raise NotImplementedError

    def step(self, action_dict: Dict):
        """→ (obs, rewards, terminateds, truncateds, infos) dicts; the
        terminateds and truncateds carry ``"__all__"``."""
        raise NotImplementedError

    def get_agent_ids(self) -> Set:
        return self._agent_ids


def make_multi_agent(env_name_or_creator):
    """A MultiAgentEnv class of ``config["num_agents"]`` (default 2)
    independent copies of a single-agent env, agent ids 0..N-1."""

    class IndependentMultiEnv(MultiAgentEnv):
        def __init__(self, config=None):
            super().__init__()
            config = config or {}
            num = config.get("num_agents", 2)
            if callable(env_name_or_creator):
                self.envs = [env_name_or_creator(config) for _ in range(num)]
            else:
                creator = get_env_creator(env_name_or_creator)
                self.envs = [creator({}) for _ in range(num)]
            self._agent_ids = set(range(num))
            self.observation_space = self.envs[0].observation_space
            self.action_space = self.envs[0].action_space
            self.terminateds = set()
            self.truncateds = set()

        def reset(self, *, seed=None, options=None):
            self.terminateds = set()
            self.truncateds = set()
            obs, infos = {}, {}
            for i, e in enumerate(self.envs):
                obs[i], infos[i] = e.reset(seed=None if seed is None else seed + i)
            return obs, infos

        def step(self, action_dict):
            obs, rew, term, trunc, info = {}, {}, {}, {}, {}
            for i, action in action_dict.items():
                obs[i], rew[i], term[i], trunc[i], info[i] = self.envs[i].step(action)
                if term[i]:
                    self.terminateds.add(i)
                if trunc[i]:
                    self.truncateds.add(i)
            term["__all__"] = len(self.terminateds) == len(self.envs)
            trunc["__all__"] = len(self.truncateds) == len(self.envs)
            return obs, rew, term, trunc, info

        def close(self):
            for e in self.envs:
                close = getattr(e, "close", None)
                if close is not None:
                    close()

    return IndependentMultiEnv
