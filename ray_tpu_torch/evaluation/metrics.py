"""Rollout metrics aggregation.

Copy of ``ray_tpu/evaluation/metrics.py`` (episode records and the
summary behind ``episode_reward_mean``), without custom metrics.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


class RolloutMetrics:
    def __init__(self, episode_length: int, episode_reward: float):
        self.episode_length = episode_length
        self.episode_reward = episode_reward


def summarize_episodes(episodes: List[RolloutMetrics]) -> Dict:
    rewards = [e.episode_reward for e in episodes]
    lengths = [e.episode_length for e in episodes]
    return {
        "episode_reward_max": float(np.max(rewards)) if rewards else np.nan,
        "episode_reward_min": float(np.min(rewards)) if rewards else np.nan,
        "episode_reward_mean": float(np.mean(rewards)) if rewards else np.nan,
        "episode_len_mean": float(np.mean(lengths)) if lengths else np.nan,
        "episodes_this_iter": len(episodes),
    }
