"""Columnar trajectory batches.

Counterpart of ``ray_tpu/data/sample_batch.py``: a SampleBatch is a dict
of equal-length columns. Columns may be numpy arrays (host batches) or
torch tensors (device batches of the rollout lane); row transforms keep
each column's kind. The frame pool of the deduplicated framestack format
(``obs_frames``) is not a row column: its length is rows + k - 1.

A :class:`MultiAgentBatch` maps policy ids to SampleBatches; its
``count`` is env steps, as in the reference, and ``agent_steps()`` the
rows of all its policy batches.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np
import torch

from ray_tpu_torch.ops.framestack import FRAME_IDX, FRAMES, materialize_fragment

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

    def size_bytes(self) -> int:
        return sum(v.nbytes for v in self.values() if isinstance(v, np.ndarray))

    def copy(self, shallow: bool = False) -> "SampleBatch":
        if shallow:
            return SampleBatch(dict(self))
        return SampleBatch({k: v.copy() if isinstance(v, np.ndarray) else v
                            for k, v in self.items()})

    def timeslices(self, size: int) -> List["SampleBatch"]:
        """Slices of ``size`` rows; a final partial slice is dropped."""
        return [self.slice(i, i + size) for i in range(0, self.count - size + 1, size)]

    def as_multi_agent(self) -> "MultiAgentBatch":
        return MultiAgentBatch({DEFAULT_POLICY_ID: self}, self.count)

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


def concat_samples(
    batches: Sequence[Union[SampleBatch, "MultiAgentBatch"]]
) -> Union[SampleBatch, "MultiAgentBatch"]:
    """Concatenate row-wise. Frame-pool batches merge their pools and
    offset each batch's first-frame indices; a mix of pooled and stacked
    batches rebuilds the pooled ones' stacks first. A list that starts
    with a MultiAgentBatch concatenates per policy
    (:meth:`MultiAgentBatch.concat_samples`)."""
    if not batches:
        return SampleBatch()
    if isinstance(batches[0], MultiAgentBatch):
        return MultiAgentBatch.concat_samples(list(batches))
    pooled = [FRAMES in b for b in batches]
    if any(pooled) and not all(pooled):
        # compression is per fragment and depends on the data (one
        # worker's fragment can pool while a sibling's cannot), so a mix
        # goes back to stacks, with the depth of a stacked sibling
        stack_k = next(
            int(np.asarray(b[OBS]).shape[-1])
            for b in batches
            if FRAMES not in b and OBS in b
        )
        batches = [
            SampleBatch(materialize_fragment(dict(b), stack_k)) if p else b
            for b, p in zip(batches, pooled)
        ]
        pooled = [False] * len(batches)
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
            out[k] = _cat([b[k] for b in batches if k in b])
    return SampleBatch(out)


class MultiAgentBatch:
    """Policy id -> SampleBatch, with the env steps they cover."""

    def __init__(self, policy_batches: Dict[str, SampleBatch], env_steps: int):
        self.policy_batches = policy_batches
        self.count = env_steps

    def env_steps(self) -> int:
        return self.count

    def agent_steps(self) -> int:
        return sum(b.count for b in self.policy_batches.values())

    def size_bytes(self) -> int:
        return sum(b.size_bytes() for b in self.policy_batches.values())

    def timeslices(self, size: int) -> List["MultiAgentBatch"]:
        """Every policy batch cut into ``size``-row slices, as many
        batches as the shortest policy batch gives."""
        slices = {pid: b.timeslices(size) for pid, b in self.policy_batches.items()}
        n = min(len(s) for s in slices.values()) if slices else 0
        return [MultiAgentBatch({pid: s[i] for pid, s in slices.items()}, size) for i in range(n)]

    @staticmethod
    def concat_samples(batches: List[Union[SampleBatch, "MultiAgentBatch"]]) -> "MultiAgentBatch":
        """Per policy; a SampleBatch in the list counts as the default
        policy's."""
        policy_batches: Dict[str, List[SampleBatch]] = {}
        env_steps = 0
        for b in batches:
            if isinstance(b, SampleBatch):
                b = b.as_multi_agent()
            env_steps += b.env_steps()
            for pid, sb in b.policy_batches.items():
                policy_batches.setdefault(pid, []).append(sb)
        return MultiAgentBatch(
            {pid: concat_samples(sbs) for pid, sbs in policy_batches.items()}, env_steps
        )

    @staticmethod
    def wrap_as_needed(
        policy_batches: Dict[str, SampleBatch], env_steps: int
    ) -> Union[SampleBatch, "MultiAgentBatch"]:
        """The default policy's batch alone stays a SampleBatch."""
        if len(policy_batches) == 1 and DEFAULT_POLICY_ID in policy_batches:
            return policy_batches[DEFAULT_POLICY_ID]
        return MultiAgentBatch(policy_batches, env_steps)

    def copy(self) -> "MultiAgentBatch":
        return MultiAgentBatch({pid: b.copy() for pid, b in self.policy_batches.items()}, self.count)

    def __repr__(self):
        return f"MultiAgentBatch({self.count}: {list(self.policy_batches)})"
