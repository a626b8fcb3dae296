"""Trajectory views: the shifted and windowed columns a policy declares.

Copy of ``ray_tpu/evaluation/view_collector.py``. The
:class:`ViewCollector` builds every requirement keyed off another column
(``data_col``) from the declaration alone: a bounded history per env
slot, zeros before the episode's start, a window stacked on a new
leading axis, and nothing reaching across an episode boundary. The
sampler's own columns and its prev-1 shortcuts (``PREV_ACTIONS`` and
``PREV_REWARDS``) stay on its direct path.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

import numpy as np

from ray_tpu_torch.data.sample_batch import SampleBatch

# the columns the sampler itself writes every step
_BASE = {
    SampleBatch.OBS,
    SampleBatch.NEXT_OBS,
    SampleBatch.ACTIONS,
    SampleBatch.REWARDS,
    SampleBatch.TERMINATEDS,
    SampleBatch.TRUNCATEDS,
    SampleBatch.EPS_ID,
    SampleBatch.AGENT_INDEX,
    SampleBatch.T,
    SampleBatch.PREV_ACTIONS,
    SampleBatch.PREV_REWARDS,
}


def derived_requirements(view_requirements: Dict) -> Dict:
    """The requirements the collector builds: those keyed off another
    column through ``data_col``, other than the sampler's own columns."""
    out = {}
    for key, req in (view_requirements or {}).items():
        if key in _BASE:
            continue
        if getattr(req, "data_col", None) is None:
            continue  # the policy's own extra fetches
        out[key] = req
    return out


class ViewCollector:
    def __init__(self, view_requirements: Dict, num_envs: int):
        self.reqs = derived_requirements(view_requirements)
        self.lookback = max([r.lookback for r in self.reqs.values()], default=0)
        # per env slot, per source column: the bounded history of past steps
        self._hist: List[Dict[str, deque]] = [{} for _ in range(num_envs)]

    @property
    def active(self) -> bool:
        return bool(self.reqs)

    def _zero(self, req, like: Optional[np.ndarray]) -> np.ndarray:
        if like is not None:
            return np.zeros_like(like)
        space = getattr(req, "space", None)
        if space is not None:
            return np.zeros(space.shape, space.dtype)
        raise ValueError(
            f"view requirement on {req.data_col!r} needs a `space` to zero-fill "
            "before any value was collected"
        )

    def _view_at(self, hist: deque, shift: int, req, like):
        """The source column ``shift`` (<= 0) steps back; shift 0 is this
        step's value, ``like``."""
        if shift == 0:
            if like is None:
                raise ValueError(f"{req.data_col!r} shift 0 view has no current value")
            return np.asarray(like)
        idx = len(hist) + shift
        if idx < 0:
            return self._zero(req, like if like is not None else (hist[0] if hist else None))
        return hist[idx]

    def _materialize(self, env_i: int, key: str, req, current):
        hist = self._hist[env_i].setdefault(req.data_col, deque(maxlen=max(self.lookback, 1)))
        if req.is_window:
            return np.stack([
                self._view_at(hist, s, req, current)
                for s in range(req.shift_from, req.shift_to + 1)
            ])
        return self._view_at(hist, req.shift_from, req, current)

    # -- the sampler's hooks ---------------------------------------------

    def compute_action_views(self, env_i: int, current: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """This step's views for ``compute_actions``; ``current`` maps
        source columns to their values of this step (the current obs)."""
        out = {}
        for key, req in self.reqs.items():
            if req.used_for_compute_actions:
                out[key] = self._materialize(env_i, key, req, current.get(req.data_col))
        return out

    def annotate_row(self, env_i: int, row: Dict) -> None:
        """Write the train-time views into the row, then take the row's
        source columns into the history. Called after the sampler has
        filled the row's own columns."""
        for key, req in self.reqs.items():
            if not req.used_for_training or key in row:  # the policy's extras win
                continue
            row[key] = self._materialize(env_i, key, req, row.get(req.data_col))
        if self.lookback > 0:
            hist_i = self._hist[env_i]
            for col in {r.data_col for r in self.reqs.values()}:
                if col in row:
                    hist_i.setdefault(col, deque(maxlen=max(self.lookback, 1))).append(
                        np.asarray(row[col])
                    )

    def reset_env(self, env_i: int) -> None:
        """An episode boundary: no view reaches into the episode before."""
        for h in self._hist[env_i].values():
            h.clear()
