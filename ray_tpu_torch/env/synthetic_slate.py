"""``SyntheticSlate-v0``: the interest-evolution-style slate env of SlateQ.

Counterpart of ``SyntheticSlateEnv`` in
``ray_tpu/algorithms/slateq/slateq.py``, on the port's ``Box`` and
``MultiDiscrete``. Each step shows ``num_candidates`` unit-norm documents
of ``embedding_dim``; the user clicks one of the ``slate_size`` shown
documents in proportion to ``max(user · doc + 1, 0)``, or none with mass
1; a click pays its watch time ``max(0, user · doc) + 0.1`` and drifts
the user's interest toward the document. The observation is the flat
RecSim layout ``[user (E) | docs (C·E) | response (2·S)]``, the response
holding the last step's click indicators and watch times. Episodes end
by truncation at ``horizon`` steps. All draws come from one numpy
generator (``config["seed"]``, or ``reset(seed=)``), in the reference's
order, so a seeded rollout is the reference's bitwise.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ray_tpu_torch.env.registry import register_env
from ray_tpu_torch.env.spaces import Box, MultiDiscrete


class SyntheticSlateEnv:
    def __init__(self, config: Optional[Dict] = None):
        config = config or {}
        self.E = int(config.get("embedding_dim", 4))
        self.C = int(config.get("num_candidates", 8))
        self.S = int(config.get("slate_size", 2))
        self.horizon = int(config.get("horizon", 20))
        self._rng = np.random.default_rng(config.get("seed", 0))
        self.observation_space = Box(-np.inf, np.inf, (self.E + self.C * self.E + 2 * self.S,),
                                     np.float32)
        self.action_space = MultiDiscrete([self.C] * self.S)

    def _sample_docs(self) -> np.ndarray:
        docs = self._rng.standard_normal((self.C, self.E))
        return (docs / np.linalg.norm(docs, axis=1, keepdims=True)).astype(np.float32)

    def _obs(self) -> np.ndarray:
        return np.concatenate(
            [self.user, self.docs.reshape(-1), self.last_response.reshape(-1)]
        ).astype(np.float32)

    def reset(self, *, seed=None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        user = self._rng.standard_normal(self.E)
        self.user = (user / np.linalg.norm(user)).astype(np.float32)
        self.docs = self._sample_docs()
        self.last_response = np.zeros((2, self.S), np.float32)
        self._t = 0
        return self._obs(), {}

    def step(self, action):
        slate = np.asarray(action, np.int64).reshape(-1)[: self.S]
        scores = self.docs[slate] @ self.user  # (S,)
        probs = np.maximum(scores + 1.0, 0.0)
        all_mass = np.concatenate([probs, [1.0]])  # no-click last
        all_mass = all_mass / all_mass.sum()
        choice = self._rng.choice(self.S + 1, p=all_mass)
        click = np.zeros(self.S, np.float32)
        watch = np.zeros(self.S, np.float32)
        reward = 0.0
        if choice < self.S:
            click[choice] = 1.0
            watch[choice] = max(0.0, float(scores[choice])) + 0.1
            reward = float(watch[choice])
            doc = self.docs[slate[choice]]
            self.user = (0.95 * self.user + 0.05 * doc).astype(np.float32)
            self.user /= np.linalg.norm(self.user)
        self.last_response = np.stack([click, watch])
        self.docs = self._sample_docs()
        self._t += 1
        return self._obs(), reward, False, self._t >= self.horizon, {}

    def close(self) -> None:
        pass


register_env("SyntheticSlate-v0", lambda cfg: SyntheticSlateEnv(cfg))
