"""Episode bookkeeping for the metrics.

Copy of ``ray_tpu/evaluation/episode.py``, without the callback surface
(callbacks wait, ``ROADMAP.md`` queue 1 item 3). Episode ids come from
``random.getrandbits(62)``, as in the reference, so a run that seeds
Python's ``random`` gets the reference's ids.
"""

from __future__ import annotations

import random


class EpisodeRecord:
    def __init__(self):
        self.episode_id = random.getrandbits(62)
        self.total_reward = 0.0
        self.length = 0

    def add(self, reward: float):
        self.total_reward += reward
        self.length += 1
