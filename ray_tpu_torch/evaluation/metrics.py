"""Rollout metrics aggregation.

Copy of ``ray_tpu/evaluation/metrics.py``: episode records and the
summary behind ``episode_reward_mean``, ``policy_reward_mean`` and
``custom_metrics`` (each key an episode's callbacks recorded, as
``<key>_mean``, ``<key>_min`` and ``<key>_max`` over the episodes).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class RolloutMetrics:
    """One finished episode; ``agent_rewards`` maps (agent id, policy
    id) to that agent's reward in a multi-agent episode;
    ``custom_metrics`` holds the episode's callback scalars."""

    def __init__(self, episode_length: int, episode_reward: float,
                 agent_rewards: Optional[Dict] = None,
                 custom_metrics: Optional[Dict] = None):
        self.episode_length = episode_length
        self.episode_reward = episode_reward
        self.agent_rewards = agent_rewards or {}
        self.custom_metrics = custom_metrics or {}


def summarize_episodes(episodes: List[RolloutMetrics]) -> Dict:
    rewards = [e.episode_reward for e in episodes]
    lengths = [e.episode_length for e in episodes]
    policy_rewards: Dict[str, List[float]] = {}
    for e in episodes:
        for (_, pid), r in e.agent_rewards.items():
            policy_rewards.setdefault(pid, []).append(r)
    out = {
        "episode_reward_max": float(np.max(rewards)) if rewards else np.nan,
        "episode_reward_min": float(np.min(rewards)) if rewards else np.nan,
        "episode_reward_mean": float(np.mean(rewards)) if rewards else np.nan,
        "episode_len_mean": float(np.mean(lengths)) if lengths else np.nan,
        "episodes_this_iter": len(episodes),
        "policy_reward_mean": {pid: float(np.mean(rs)) for pid, rs in policy_rewards.items()},
    }
    custom: Dict[str, List[float]] = {}
    for e in episodes:
        for k, v in e.custom_metrics.items():
            custom.setdefault(k, []).append(float(v))
    if custom:
        out["custom_metrics"] = {}
        for k, vals in custom.items():
            out["custom_metrics"][f"{k}_mean"] = float(np.mean(vals))
            out["custom_metrics"][f"{k}_min"] = float(np.min(vals))
            out["custom_metrics"][f"{k}_max"] = float(np.max(vals))
    return out
