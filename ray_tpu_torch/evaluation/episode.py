"""Episode bookkeeping for the metrics.

Copy of ``ray_tpu/evaluation/episode.py``, without the callback surface
(callbacks wait, ``ROADMAP.md`` queue 1 item 3c). Episode ids come from
``random.getrandbits(62)``, as in the reference, so a run that seeds
Python's ``random`` gets the reference's ids. A multi-agent episode adds
each agent's rewards up under its id (``agent_rewards``).
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

    def add(self, reward: float, agent_id=None):
        self.total_reward += reward
        self.length += 1
        if agent_id is not None:
            self.agent_rewards[agent_id] = self.agent_rewards.get(agent_id, 0.0) + reward
