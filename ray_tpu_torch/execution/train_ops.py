"""Train ops.

Counterpart of ``ray_tpu/execution/train_ops.py``: :func:`train_one_step`,
the actor lane's learn call on the local worker, and
:func:`superstep_train_replay`, the replay superstep that the DQN family
runs when it makes several updates per round.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np

from ray_tpu_torch.execution.replay_buffer import DevicePrioritizedReplayBuffer

NUM_ENV_STEPS_TRAINED = "num_env_steps_trained"
NUM_AGENT_STEPS_TRAINED = "num_agent_steps_trained"


def batch_is_finite(batch) -> bool:
    """True when no float column of a host batch holds a NaN or an Inf
    (the nan guard's test, ``ray_tpu/resilience/recovery.py``)."""
    for v in batch.values():
        if isinstance(v, np.ndarray) and np.issubdtype(v.dtype, np.floating) and not np.isfinite(v).all():
            return False
    return True


def train_one_step(algorithm, train_batch) -> Dict:
    """One ``learn_on_batch`` of the local worker on a host batch. With
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
    algorithm._counters[NUM_AGENT_STEPS_TRAINED] += train_batch.count
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
) -> Dict:
    """``k`` replay updates of ``policy`` from the device buffer ``buf``
    in one host call.

    The k index sets are drawn up front on the host, in the per-update
    generator order, against the tree as it stands (the reference's
    documented within-chain staleness), and ship once into the feed's
    static buffers (``buf.superstep_feed``). Each slot of
    ``policy.learn_superstep`` then draws (prefix-descent kernel) and
    gathers (row-gather kernel) its rows in place and updates. A
    prioritized buffer gets the slots' post-update |TD| errors as one
    (k, B) copy, powered on the host and written as one stacked tree
    update in update order; the nan guard's skipped updates write no
    priorities. Returns the last update's stats."""
    if prioritized:
        if not isinstance(buf, DevicePrioritizedReplayBuffer):
            raise TypeError("a prioritized superstep needs a DevicePrioritizedReplayBuffer")
        feed = buf.superstep_feed(k, k_max, batch_size, beta)
    else:
        feed = buf.superstep_feed(k, k_max, batch_size)
    infos, pri, skipped = policy.learn_superstep(
        k, batch_size, rings=feed, k_max=k_max, refresh_priorities=prioritized
    )
    if prioritized:
        buf.refresh_priorities_stacked(feed.idx[:k], pri, active=[not s for s in skipped])
    n_skipped = sum(skipped)
    if n_skipped and algorithm is not None:
        algorithm._counters["num_nan_batches_skipped"] += n_skipped
    return infos[-1]
