"""Checkpoint-based recovery of the training loop.

Counterpart of ``ray_tpu/resilience/recovery.py``: one main-process
:class:`RecoveryManager` that ``Algorithm.train`` consults whenever a
training step raises.

- **A worker's death** (:data:`ACTOR_DEAD_ERRORS`): with
  ``recreate_failed_workers``, probe the fleet under one bounded budget,
  drop the dead, start replacements (weights and filters synced, fault
  injection disarmed) and go on; with ``ignore_worker_failures`` alone,
  go on with the workers that are left.
- **A restartable main-process failure** (any other exception, with
  ``restore_on_failure`` and something to restore): restore the newest
  of the latest periodic checkpoint and the stream tail
  (``resilience/discovery.pick_restore_target``) and go on.
- **A non-finite learn batch** (``nan_guard``): the learn choke points
  skip it and report here (``note_skipped_batch``).

Each action spends one unit of the ``max_failures`` budget (negative:
unlimited); a drained preemption spends none. ``stats()`` is what
``train()`` puts under ``info/recovery``. The reference's Prometheus
counters and ``recovery:*`` spans go to the no-ops of
``util/telemetry.py`` (``ROADMAP.md`` queue 1 item 9).

:func:`batch_is_finite` is the nan guard's test, here as in the
reference (``execution/train_ops`` re-exports it).
"""

from __future__ import annotations

import collections
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np

from ray_tpu_torch.core.object_store import RayActorError, WorkerCrashedError
from ray_tpu_torch.resilience import discovery
from ray_tpu_torch.resilience.streamer import CheckpointStreamer
from ray_tpu_torch.util import telemetry

ACTOR_DEAD_ERRORS = (RayActorError, WorkerCrashedError)


def batch_is_finite(batch) -> bool:
    """True when no float column of a host batch (every policy batch of
    a ``MultiAgentBatch``) holds a NaN or an Inf."""
    policy_batches = getattr(batch, "policy_batches", None)
    for b in policy_batches.values() if policy_batches is not None else [batch]:
        for v in b.values():
            if isinstance(v, np.ndarray) and np.issubdtype(v.dtype, np.floating) and not np.isfinite(v).all():
                return False
    return True


class RecoveryManager:
    """The failure budget, the periodic-checkpoint cadence and the
    restore path of one algorithm; inert unless the config arms them."""

    def __init__(self, algorithm):
        self.algo = algorithm
        cfg = algorithm.config
        mf = cfg.get("max_failures")
        self.max_failures = int(mf) if mf is not None else -1
        self.checkpoint_frequency = int(cfg.get("checkpoint_frequency") or 0)
        self.restore_on_failure = bool(cfg.get("restore_on_failure"))
        self.checkpoint_root = cfg.get("checkpoint_root")
        self.failures = 0
        self.num_worker_restarts = 0
        self.num_recoveries: collections.Counter = collections.Counter()
        self.num_skipped_batches = 0
        self.num_preemptions_drained = 0
        self.num_preemptions_lost = 0
        self.time_lost_s = 0.0
        self.iter_time_lost_s = 0.0
        # a training run started again on the same checkpoint_root picks up
        # the newest periodic checkpoint (and the stream tail, below)
        self.latest_checkpoint: Optional[str] = discovery.latest_periodic(self.checkpoint_root)

    def begin_iteration(self) -> None:
        self.iter_time_lost_s = 0.0

    def _budget_ok(self) -> bool:
        self.failures += 1
        return self.max_failures < 0 or self.failures <= self.max_failures

    def _note(self, kind: str, t0: float) -> None:
        dt = time.time() - t0
        self.time_lost_s += dt
        self.iter_time_lost_s += dt
        self.num_recoveries[kind] += 1
        telemetry.inc_recoveries(kind)

    # -- the failure protocol --------------------------------------------

    def handle_failure(self, exc: BaseException) -> bool:
        """True when the loop may go on (the failure was absorbed),
        False when ``exc`` must propagate."""
        if isinstance(exc, ACTOR_DEAD_ERRORS):
            return self._recover_workers(exc)
        if isinstance(exc, Exception) and self.restore_on_failure and (
            self.latest_checkpoint or self._stream_tail()
        ):
            return self._restore_from_checkpoint(exc)
        return False

    def _stream_tail(self) -> Optional[str]:
        """The newest stream snapshot: the live streamer's, else what an
        earlier run left under ``<checkpoint_root>/stream``."""
        streamer = getattr(self.algo, "_ckpt_streamer", None)
        if streamer is not None and streamer.latest_path:
            return streamer.latest_path
        return discovery.latest_stream_tail(self.checkpoint_root)

    def _pick_restore_target(self) -> Tuple[str, Optional[str]]:
        return discovery.pick_restore_target(self.latest_checkpoint, self._stream_tail())

    def restore_latest(self) -> Optional[str]:
        """Restore the newest recovery state (stream tail or periodic
        checkpoint) into the algorithm; the path, or None when there is
        nothing yet."""
        kind, path = self._pick_restore_target()
        if path is None:
            return None
        if kind == "stream":
            CheckpointStreamer.restore_into(self.algo, path)
        else:
            self.algo.restore(path)
        return path

    def _recover_workers(self, exc: BaseException) -> bool:
        cfg = self.algo.config
        recreate = bool(cfg.get("recreate_failed_workers"))
        if not recreate and not cfg.get("ignore_worker_failures"):
            return False
        if not self._budget_ok():
            return False
        t0 = time.time()
        with telemetry.span("recovery:workers", error=type(exc).__name__):
            if recreate:
                restarted = self.algo.workers.recreate_failed_workers()
            else:
                restarted = 0
                bad = self.algo.workers.probe_unhealthy_workers()
                self.algo.workers.remove_workers(
                    [w for i, w in enumerate(self.algo.workers.remote_workers()) if i + 1 in bad]
                )
        self.num_worker_restarts += restarted
        self._note("workers", t0)
        self.algo.on_recovery("workers")
        return True

    def _restore_from_checkpoint(self, exc: BaseException) -> bool:
        if not self._budget_ok():
            return False
        t0 = time.time()
        with telemetry.span("recovery:restore", error=type(exc).__name__):
            restored = self.restore_latest()
        if restored is None:
            return False
        self._note("restore", t0)
        self.algo.on_recovery("restore")
        return True

    def note_skipped_batch(self) -> None:
        """A learn choke point skipped a non-finite batch."""
        self.num_skipped_batches += 1
        telemetry.inc_skipped_batches()
        telemetry.event("recovery:skip_nan_batch")

    def note_preemption(self, drained: bool) -> None:
        """A worker's preemption ran its course. A drained one is no
        failure and spends no budget; a lost one is counted here, and
        its death goes through the ordinary death path."""
        if drained:
            self.num_preemptions_drained += 1
        else:
            self.num_preemptions_lost += 1
        telemetry.event("recovery:preemption", drained=drained)

    # -- periodic checkpoints --------------------------------------------

    def maybe_checkpoint(self) -> Optional[str]:
        """End of an iteration: every ``checkpoint_frequency`` iterations,
        save under ``checkpoint_root`` (default ``<logdir>/resilience``)
        and keep it as the restore target. ``save_checkpoint`` prunes to
        ``keep_checkpoints_num``."""
        if self.checkpoint_frequency <= 0:
            return None
        it = self.algo.iteration + 1  # the iteration just completed
        if it % self.checkpoint_frequency:
            return None
        root = self.checkpoint_root or os.path.join(self.algo.logdir, "resilience")
        os.makedirs(root, exist_ok=True)
        t0 = time.time()
        with telemetry.span("recovery:checkpoint", iteration=it):
            path = self.algo.save(os.path.join(root, f"checkpoint_{it:06d}"))
        self.iter_time_lost_s += time.time() - t0
        self.latest_checkpoint = path
        return path

    def stats(self) -> Dict:
        return {
            "failures": self.failures,
            "worker_restarts": self.num_worker_restarts,
            "recoveries": dict(self.num_recoveries),
            "skipped_batches": self.num_skipped_batches,
            "preemptions_drained": self.num_preemptions_drained,
            "preemptions_lost": self.num_preemptions_lost,
            "time_lost_s": round(self.time_lost_s, 4),
            "time_lost_s_this_iter": round(self.iter_time_lost_s, 4),
            "latest_checkpoint": self.latest_checkpoint,
        }
