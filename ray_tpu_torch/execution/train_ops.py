"""Train ops of the replay family.

Counterpart of ``ray_tpu/execution/train_ops.py``; this slice ports
:func:`superstep_train_replay`, the replay superstep that the DQN family
runs when it makes several updates per round. The actor lane's
``train_one_step`` comes with the actor lane (ROADMAP).
"""

from __future__ import annotations

from typing import Dict

from ray_tpu_torch.execution.replay_buffer import DevicePrioritizedReplayBuffer


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
