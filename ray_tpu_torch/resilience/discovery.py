"""Checkpoint discovery, shared by recovery and serving.

Counterpart of ``ray_tpu/resilience/discovery.py``: one place answers
"what is the newest restorable state under this ``checkpoint_root``?"
for the main process's ``RecoveryManager`` (a crash's restore, or a training
run started again on the same root) and the serve plane's hot-reload
watcher (``serve/policy_server.py``), so both restore the same
snapshot. :class:`MembershipFeed` surfaces a deployment's replica
membership to the ingress router.

The preference: a stream tail (the ``CheckpointStreamer``'s newest
``<root>/stream/snapshot_*.pkl``) wins whenever its iteration is at
least the newest periodic ``checkpoint_*`` directory's; an unreadable
tail (pruned or torn while being read) falls back to the periodic
checkpoint.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Tuple

PERIODIC_PREFIX = "checkpoint_"


class MembershipFeed:
    """Versioned replica-membership feed for routing consumers.

    The serve controller publishes a deployment's live replica set on a
    long-poll key every time membership changes (scale-up, scale-down,
    dead-replica replacement); the ingress coalescing router polls this
    feed between batches and adopts the new set, the discipline
    ``DeploymentHandle``'s listener thread follows, without a listener
    thread of its own."""

    def __init__(self, host, key: str):
        self._host = host
        self._key = key

    def current(self) -> Tuple[int, List[Any]]:
        version, members = self._host.current(self._key)
        return version, list(members or [])

    def wait_changed(
        self, version: int, timeout: Optional[float] = None
    ) -> Optional[Tuple[int, List[Any]]]:
        out = self._host.listen(self._key, version, timeout=timeout)
        if out is None:
            return None
        new_version, members = out
        return new_version, list(members or [])


def latest_periodic(checkpoint_root: Optional[str]) -> Optional[str]:
    """Newest ``checkpoint_*`` entry under ``checkpoint_root`` (the
    zero-padded iteration names sort chronologically), or None."""
    if not checkpoint_root or not os.path.isdir(checkpoint_root):
        return None
    try:
        ckpts = sorted(
            d for d in os.listdir(checkpoint_root) if d.startswith(PERIODIC_PREFIX)
        )
    except OSError:
        return None
    if not ckpts:
        return None
    return os.path.join(checkpoint_root, ckpts[-1])


def latest_stream_tail(checkpoint_root: Optional[str]) -> Optional[str]:
    """The newest stream snapshot under ``<root>/stream/``, or None."""
    if not checkpoint_root:
        return None
    from ray_tpu_torch.resilience.streamer import CheckpointStreamer

    return CheckpointStreamer.latest(CheckpointStreamer.stream_root(checkpoint_root))


def periodic_iteration(path: Optional[str]) -> int:
    """Iteration baked into a periodic checkpoint's directory name
    (``checkpoint_{iteration:06d}``); -1 when unparseable."""
    if not path:
        return -1
    try:
        return int(os.path.basename(path).split("_")[-1])
    except ValueError:
        return -1


def pick_restore_target(
    periodic: Optional[str], stream_tail: Optional[str]
) -> Tuple[str, Optional[str]]:
    """``(kind, path)``: the newest of a periodic checkpoint and a
    stream tail (kinds ``"checkpoint"`` and ``"stream"``). The tail wins
    when its iteration is at least the checkpoint's; an unreadable tail
    loses."""
    if stream_tail is None:
        return ("checkpoint", periodic)
    if periodic is None:
        return ("stream", stream_tail)
    from ray_tpu_torch.resilience.streamer import CheckpointStreamer

    try:
        tail_iter = CheckpointStreamer.peek(stream_tail)["iteration"]
    except Exception:
        return ("checkpoint", periodic)
    if tail_iter >= periodic_iteration(periodic):
        return ("stream", stream_tail)
    return ("checkpoint", periodic)


def discover(checkpoint_root: Optional[str]) -> Tuple[str, Optional[str]]:
    """Scan ``checkpoint_root`` and return the preferred ``(kind,
    path)`` restore target (path None when nothing exists yet): the
    one-call surface the serve watcher polls."""
    return pick_restore_target(
        latest_periodic(checkpoint_root), latest_stream_tail(checkpoint_root)
    )


def target_version(kind: str, path: str) -> Tuple[int, int]:
    """Orderable ``(iteration, superstep)`` freshness of a restore
    target, comparable across kinds. Periodic checkpoints carry no
    superstep (0); raises when the target is gone or torn, or the name
    carries no iteration (a poller tries again)."""
    if kind == "stream":
        from ray_tpu_torch.resilience.streamer import CheckpointStreamer

        head = CheckpointStreamer.peek(path)
        return (int(head["iteration"]), int(head["superstep"]))
    it = periodic_iteration(path)
    if it < 0:
        raise ValueError(f"unversioned periodic checkpoint {path!r}")
    return (it, 0)
