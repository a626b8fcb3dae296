"""Policy base class and view requirements.

Counterpart of ``ray_tpu/policy/policy.py``: the per-policy inference
and learning contract, and :class:`ViewRequirement`, the declaration of
a column the sampler collects for the policy (a shifted or windowed
view of another column is built by ``evaluation/view_collector.py``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.data.sample_batch import SampleBatch


class ViewRequirement:
    """A column the policy needs at compute or train time.

    ``shift`` is an int (0: this step, -1: the step before, ...) or a
    window ``"a:b"`` with ``a <= b <= 0`` (``"-3:0"``: the last four
    values, this step's included, stacked on a new leading axis and
    zero-filled before the episode's start). A view with a ``data_col``
    is built from that column by the sampler's ``ViewCollector``;
    positive shifts are the NEXT_OBS column."""

    def __init__(
        self,
        data_col: Optional[str] = None,
        shift=0,
        used_for_compute_actions: bool = True,
        used_for_training: bool = True,
        space=None,
    ):
        self.data_col = data_col
        self.shift = shift
        self.used_for_compute_actions = used_for_compute_actions
        self.used_for_training = used_for_training
        self.space = space
        if isinstance(shift, str):
            lo, hi = (int(s) for s in shift.split(":"))
            if lo > hi or hi > 0:
                raise ValueError(f"window shift {shift!r} must satisfy a <= b <= 0")
            self.shift_from, self.shift_to = lo, hi
        else:
            self.shift_from = self.shift_to = int(shift)

    @property
    def is_window(self) -> bool:
        return isinstance(self.shift, str)

    @property
    def lookback(self) -> int:
        """How many past steps the view reaches into."""
        return max(0, -self.shift_from)


class Policy:
    """Per-policy inference/learning contract."""

    def __init__(self, observation_space, action_space, config: Dict):
        self.observation_space = observation_space
        self.action_space = action_space
        self.config = config or {}
        self.global_timestep = 0
        self.view_requirements: Dict[str, ViewRequirement] = {
            SampleBatch.OBS: ViewRequirement(space=observation_space),
            SampleBatch.ACTIONS: ViewRequirement(space=action_space, used_for_compute_actions=False),
            SampleBatch.REWARDS: ViewRequirement(used_for_compute_actions=False),
            SampleBatch.TERMINATEDS: ViewRequirement(used_for_compute_actions=False),
            SampleBatch.TRUNCATEDS: ViewRequirement(used_for_compute_actions=False),
            SampleBatch.EPS_ID: ViewRequirement(used_for_compute_actions=False),
        }

    def compute_actions(
        self,
        obs_batch: np.ndarray,
        state_batches: Optional[List[np.ndarray]] = None,
        prev_action_batch: Optional[np.ndarray] = None,
        prev_reward_batch: Optional[np.ndarray] = None,
        explore: bool = True,
        **kwargs,
    ) -> Tuple[np.ndarray, List[np.ndarray], Dict[str, np.ndarray]]:
        """→ (actions, state_outs, extra_fetches). ``kwargs`` carries
        the views the policy declared for compute time."""
        raise NotImplementedError

    def compute_single_action(self, obs, state=None, explore: bool = True, **kwargs):
        """One observation's ``(action, state_out, extra)``; the
        reference's signature. A recurrent policy steps from ``state``
        (one array per state tensor, no batch dim) and returns the state
        after the step the same way."""
        state_batches = [np.asarray(s)[None] for s in state] if state else None
        actions, state_out, extra = self.compute_actions(
            np.asarray(obs)[None], state_batches, explore=explore, **kwargs
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

    def get_weights(self, read=None) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def get_inference_weights(self) -> Dict[str, np.ndarray]:
        """The weights acting reads (all, unless a subclass keeps fewer)."""
        return self.get_weights()

    def set_weights(self, weights) -> None:
        raise NotImplementedError

    def get_state(self, read=None) -> Dict[str, Any]:
        """The policy's state; ``read`` (``torch_policy.host_read`` when
        None) turns each device tensor the state holds into its host
        value, so a caller can copy the tensors its own way (the
        checkpoint streamer's device snapshot)."""
        return {
            "weights": self.get_weights(read),
            "global_timestep": self.global_timestep,
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        self.set_weights(state["weights"])
        self.global_timestep = state.get("global_timestep", 0)

    def export_checkpoint(self, export_dir: str) -> None:
        """``get_state()`` pickled into ``<export_dir>/policy_state.pkl``."""
        import os
        import pickle

        os.makedirs(export_dir, exist_ok=True)
        with open(os.path.join(export_dir, "policy_state.pkl"), "wb") as f:
            pickle.dump(self.get_state(), f)
