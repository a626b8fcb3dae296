"""Train ops.

Counterpart of ``ray_tpu/execution/train_ops.py``: :func:`train_one_step`,
the actor lane's learn call on the local worker, and
:func:`superstep_train_replay`, the replay superstep that the DQN family
runs when it makes several updates per round.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.data.sample_batch import MultiAgentBatch
from ray_tpu_torch.execution.replay_buffer import DeviceReplayBuffer

NUM_ENV_STEPS_TRAINED = "num_env_steps_trained"
NUM_AGENT_STEPS_TRAINED = "num_agent_steps_trained"


def batch_is_finite(batch) -> bool:
    """True when no float column of a host batch (every policy batch of
    a ``MultiAgentBatch``) holds a NaN or an Inf (the nan guard's test,
    ``ray_tpu/resilience/recovery.py``)."""
    policy_batches = getattr(batch, "policy_batches", None)
    for b in policy_batches.values() if policy_batches is not None else [batch]:
        for v in b.values():
            if isinstance(v, np.ndarray) and np.issubdtype(v.dtype, np.floating) and not np.isfinite(v).all():
                return False
    return True


def train_one_step(algorithm, train_batch) -> Dict:
    """One ``learn_on_batch`` of the local worker on a host batch (a
    ``MultiAgentBatch`` counts its env steps and its agent steps). With
    ``config["nan_guard"]`` a batch with a non-finite float is skipped
    and counted (``num_nan_batches_skipped``), not learned from. The
    call's seconds go to ``algorithm._timers["learn_on_batch_s"]``."""
    if algorithm.config.get("nan_guard") and not batch_is_finite(train_batch):
        algorithm._counters["num_nan_batches_skipped"] += 1
        return {}
    t0 = time.perf_counter()
    info = algorithm.workers.local_worker().learn_on_batch(train_batch)
    algorithm._timers["learn_on_batch_s"] = time.perf_counter() - t0
    algorithm._counters[NUM_ENV_STEPS_TRAINED] += train_batch.env_steps()
    algorithm._counters[NUM_AGENT_STEPS_TRAINED] += (
        train_batch.agent_steps() if isinstance(train_batch, MultiAgentBatch) else train_batch.count
    )
    return info


def superstep_train_replay(
    algorithm,
    policy,
    buf,
    k: int,
    k_max: int,
    batch_size: int,
    *,
    prioritized: bool = False,
    beta: float = 0.4,
    overlap: Optional[Callable[[], None]] = None,
) -> Dict:
    """``k`` replay updates of ``policy`` from ``buf`` in one host call.

    The k index sets are drawn up front on the host, in the per-update
    generator order, against the trees as they stand (the reference's
    documented within-chain staleness).

    - **Device rings** ship them once into the feed's static buffers
      (``buf.superstep_feed``); each slot of ``policy.learn_superstep``
      then draws (prefix-descent kernel, under the device tree) and
      gathers (row-gather kernel) its rows in place and updates.
    - **Host rings** (and a spilled device buffer) take the reference's
      host stacked path: the k drawn batches' replay columns stacked
      into one (k, B, ...) upload, which the slots read from their
      static input buffers.

    A prioritized buffer gets the slots' post-update |TD| errors as one
    (k, B) copy, applied in update order (one stacked write on the device
    tree); the nan guard's skipped updates write no priorities.
    ``overlap`` runs on the host while the slots run on the card (see
    ``TorchPolicy.learn_superstep``). Returns the last update's stats."""
    if isinstance(buf, DeviceReplayBuffer) and not buf.spilled:
        if prioritized:
            feed = buf.superstep_feed(k, k_max, batch_size, beta)
        else:
            feed = buf.superstep_feed(k, k_max, batch_size)
        infos, pri, skipped = policy.learn_superstep(
            k, batch_size, rings=feed, k_max=k_max, refresh_priorities=prioritized,
            overlap=overlap,
        )
        if prioritized:
            buf.refresh_priorities_stacked(feed.idx[:k], pri, active=[not s for s in skipped])
    else:
        src = buf._host if isinstance(buf, DeviceReplayBuffer) else buf
        if prioritized:
            idx, weights = src.draw_prioritized_sets(k, batch_size, beta)
        else:
            idx = src.draw_index_sets(k, batch_size)
        trees = []
        for i in range(k):
            b = src._make_batch(idx[i])
            if prioritized:
                b["weights"] = weights[i]
            trees.append(policy.replay_columns(b))
        stacked = {c: torch.from_numpy(np.stack([t[c] for t in trees])) for c in trees[0]}
        infos, pri, skipped = policy.learn_superstep(
            k, batch_size, stacked=stacked, k_max=k_max, refresh_priorities=prioritized,
            overlap=overlap,
        )
        if prioritized:
            for i in range(k):
                if not skipped[i]:
                    buf.update_priorities(idx[i], pri[i] + 1e-6)
    n_skipped = sum(skipped)
    if n_skipped and algorithm is not None:
        algorithm._counters["num_nan_batches_skipped"] += n_skipped
    return infos[-1]
