"""Policy base class.

Counterpart of ``ray_tpu/policy/policy.py``: the per-policy inference and
learning contract, without view requirements (no recurrent or shifted
columns are ported yet).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class Policy:
    """Per-policy inference/learning contract."""

    def __init__(self, observation_space, action_space, config: Dict):
        self.observation_space = observation_space
        self.action_space = action_space
        self.config = config or {}
        self.global_timestep = 0

    def compute_actions(
        self,
        obs_batch: np.ndarray,
        state_batches: Optional[List[np.ndarray]] = None,
        explore: bool = True,
        **kwargs,
    ) -> Tuple[np.ndarray, List[np.ndarray], Dict[str, np.ndarray]]:
        """→ (actions, state_outs, extra_fetches)."""
        raise NotImplementedError

    def compute_single_action(self, obs, explore: bool = True, **kwargs):
        actions, state_out, extra = self.compute_actions(
            np.asarray(obs)[None], explore=explore, **kwargs
        )
        return (
            actions[0],
            [s[0] for s in state_out],
            {k: v[0] for k, v in extra.items()},
        )

    def get_initial_state(self) -> List[np.ndarray]:
        return []

    @property
    def is_recurrent(self) -> bool:
        return bool(self.get_initial_state())

    def postprocess_trajectory(self, sample_batch, other_agent_batches=None, episode=None):
        """A fragment's host postprocessing on the actor lane (PPO: GAE)."""
        return sample_batch

    def on_global_var_update(self, global_vars: Dict[str, Any]) -> None:
        self.global_timestep = global_vars.get("timestep", self.global_timestep)

    def learn_on_batch(self, samples) -> Dict[str, Any]:
        raise NotImplementedError

    def get_weights(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def get_inference_weights(self) -> Dict[str, np.ndarray]:
        """The weights acting reads (all, unless a subclass keeps fewer)."""
        return self.get_weights()

    def set_weights(self, weights) -> None:
        raise NotImplementedError

    def get_state(self) -> Dict[str, Any]:
        return {
            "weights": self.get_weights(),
            "global_timestep": self.global_timestep,
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        self.set_weights(state["weights"])
        self.global_timestep = state.get("global_timestep", 0)
