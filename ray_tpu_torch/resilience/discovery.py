"""Checkpoint discovery for the serving plane.

Counterpart of ``ray_tpu/resilience/discovery.py``: one place answers
"what is the newest restorable state under this ``checkpoint_root``?"
for the serve plane's hot-reload watcher (``serve/policy_server.py``),
and :class:`MembershipFeed` surfaces a deployment's replica membership
to the ingress router.

The reference prefers a continuous-stream snapshot
(``<root>/stream/snapshot_*.pkl``, written by its checkpoint streamer)
over the newest periodic ``checkpoint_*`` directory whenever the
snapshot's iteration is at least the checkpoint's. The port has no
streamer yet (ROADMAP queue 1 item 3d): a root without a ``stream``
directory is discovered exactly as the reference discovers it, and a
root with one raises, naming the item, rather than serving an older
periodic checkpoint in its place.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Tuple

PERIODIC_PREFIX = "checkpoint_"
STREAM_DIR = "stream"


def _stream_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: continuous-stream snapshots (the reference's CheckpointStreamer) are not "
        "ported yet: ROADMAP.md queue 1 item 3d"
    )


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
    """None when the root has no ``stream`` directory; raises when it
    has one (the port cannot read stream snapshots yet)."""
    if not checkpoint_root or not os.path.isdir(os.path.join(checkpoint_root, STREAM_DIR)):
        return None
    raise _stream_not_ported(f"{checkpoint_root!r} holds a stream directory")


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
    """``(kind, path)``: the periodic checkpoint (kind
    ``"checkpoint"``); a stream tail raises (item 3d)."""
    if stream_tail is not None:
        raise _stream_not_ported(f"stream tail {stream_tail!r}")
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
    target. Periodic checkpoints carry no superstep (0); raises when the
    name carries no iteration."""
    if kind == "stream":
        raise _stream_not_ported(f"stream snapshot {path!r}")
    it = periodic_iteration(path)
    if it < 0:
        raise ValueError(f"unversioned periodic checkpoint {path!r}")
    return (it, 0)
