"""Episode bookkeeping for the metrics and the callbacks.

Copy of ``ray_tpu/evaluation/episode.py``. Episode ids come from
``random.getrandbits(62)``, as in the reference, so a run that seeds
Python's ``random`` gets the reference's ids. A multi-agent episode adds
each agent's rewards up under its id (``agent_rewards``). The callback
surface (``algorithms/callbacks.py``): ``user_data`` is the episode's
scratch space, ``custom_metrics`` its scalars for the result, and
``last_info`` the env's info of the latest step.
"""

from __future__ import annotations

import random
from typing import Dict


class EpisodeRecord:
    def __init__(self):
        self.episode_id = random.getrandbits(62)
        self.total_reward = 0.0
        self.length = 0
        self.agent_rewards: Dict = {}
        self.user_data: Dict = {}
        self.custom_metrics: Dict[str, float] = {}
        self.last_info: Dict = {}

    def add(self, reward: float, agent_id=None):
        self.total_reward += reward
        self.length += 1
        if agent_id is not None:
            self.agent_rewards[agent_id] = self.agent_rewards.get(agent_id, 0.0) + reward
