"""Columnar trajectory batches.

Counterpart of ``ray_tpu/data/sample_batch.py``: a SampleBatch is a dict
of equal-length columns. Columns may be numpy arrays (host batches) or
torch tensors (device batches of the rollout lane); row transforms keep
each column's kind. The frame pool of the deduplicated framestack format
(``obs_frames``) is not a row column: its length is rows + k - 1.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ray_tpu_torch.ops.framestack import FRAME_IDX, FRAMES

# Column name constants (same strings as the JAX package).
OBS = "obs"
NEXT_OBS = "new_obs"
ACTIONS = "actions"
REWARDS = "rewards"
PREV_ACTIONS = "prev_actions"
PREV_REWARDS = "prev_rewards"
TERMINATEDS = "dones"
TRUNCATEDS = "truncateds"
INFOS = "infos"
EPS_ID = "eps_id"
UNROLL_ID = "unroll_id"
AGENT_INDEX = "agent_index"
T = "t"
ACTION_DIST_INPUTS = "action_dist_inputs"
ACTION_LOGP = "action_logp"
ACTION_PROB = "action_prob"
VF_PREDS = "vf_preds"
ADVANTAGES = "advantages"
VALUE_TARGETS = "value_targets"
SEQ_LENS = "seq_lens"
OBS_FRAMES = FRAMES
OBS_FRAME_IDX = FRAME_IDX

DEFAULT_POLICY_ID = "default_policy"


def _is_row_col(key: str) -> bool:
    return key not in (SEQ_LENS, FRAMES)


def _cat(vals):
    if isinstance(vals[0], torch.Tensor):
        return torch.cat(vals, dim=0)
    return np.concatenate(vals, axis=0)


class SampleBatch(dict):
    """A dict of columns with equal leading dimension (``count``)."""

    OBS = OBS
    NEXT_OBS = NEXT_OBS
    ACTIONS = ACTIONS
    REWARDS = REWARDS
    PREV_ACTIONS = PREV_ACTIONS
    PREV_REWARDS = PREV_REWARDS
    TERMINATEDS = TERMINATEDS
    DONES = TERMINATEDS
    TRUNCATEDS = TRUNCATEDS
    INFOS = INFOS
    EPS_ID = EPS_ID
    UNROLL_ID = UNROLL_ID
    AGENT_INDEX = AGENT_INDEX
    T = T
    ACTION_DIST_INPUTS = ACTION_DIST_INPUTS
    ACTION_LOGP = ACTION_LOGP
    ACTION_PROB = ACTION_PROB
    VF_PREDS = VF_PREDS
    ADVANTAGES = ADVANTAGES
    VALUE_TARGETS = VALUE_TARGETS
    SEQ_LENS = SEQ_LENS
    OBS_FRAMES = OBS_FRAMES
    OBS_FRAME_IDX = OBS_FRAME_IDX

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            if isinstance(v, (list, tuple)) and k != INFOS:
                self[k] = np.asarray(v)
        counts = {len(v) for k, v in self.items() if _is_row_col(k)}
        if len(counts) > 1:
            raise ValueError(
                "All columns must have equal length, got "
                f"{ {k: len(v) for k, v in self.items() if _is_row_col(k)} }"
            )
        self.count = counts.pop() if counts else 0

    def __len__(self) -> int:
        return self.count

    def env_steps(self) -> int:
        return self.count

    def slice(self, start: int, end: int) -> "SampleBatch":
        """Row-slice [start, end) of every column."""
        if FRAMES in self:
            raise ValueError(
                "SampleBatch.slice does not support the frame-pool format "
                f"({FRAMES!r}); materialize stacked observations first"
            )
        return SampleBatch(
            {k: v[start:end] for k, v in self.items() if _is_row_col(k)}
        )

    def __getitem__(self, key):
        if isinstance(key, slice):
            return self.slice(
                key.start or 0,
                key.stop if key.stop is not None else self.count,
            )
        return super().__getitem__(key)


def concat_samples(batches: Sequence[SampleBatch]) -> SampleBatch:
    """Concatenate row-wise. Frame-pool batches merge their pools and
    offset each batch's first-frame indices."""
    if not batches:
        return SampleBatch()
    pooled = [FRAMES in b for b in batches]
    if any(pooled) and not all(pooled):
        raise ValueError(
            "cannot concatenate frame-pool batches with stacked ones"
        )
    out = {}
    keys = list(batches[0].keys())
    if all(pooled):
        pools = [b[FRAMES] for b in batches]
        offsets = np.cumsum([0] + [len(p) for p in pools[:-1]])
        out[FRAMES] = _cat(pools)
        out[FRAME_IDX] = _cat(
            [b[FRAME_IDX] + int(off) for b, off in zip(batches, offsets)]
        )
        keys = [k for k in keys if k not in (FRAMES, FRAME_IDX)]
    for k in keys:
        if _is_row_col(k):
            out[k] = _cat([b[k] for b in batches])
    return SampleBatch(out)
