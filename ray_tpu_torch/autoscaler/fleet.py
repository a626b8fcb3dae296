"""FleetController: an elastic, preemption-aware rollout fleet.

Counterpart of ``ray_tpu/autoscaler/fleet.py``. Two halves, split by
thread:

- the **monitor thread** (a daemon; ``stop()`` joins it; the algorithm
  starts and stops it) only observes: it keeps one
  ``preemption_notice`` call out per worker and harvests the answers
  without blocking, watches the sampler-side queue depths for a starved
  learner, and tracks each worker's idleness across the registered
  request managers. It never changes the fleet;
- **``reconcile()``** runs on the main thread between training-step
  rounds and applies what the monitor queued: it drains noticed
  workers, reaps workers idle for ``fleet_idle_timeout_s`` down to
  ``min_workers``, and settles a scale request within ``[min_workers,
  max_workers]``, so the worker set never changes under a round.

A worker goes joining (synced ahead of any sample) → active → draining
(out of every rotation, its done results harvested, its pending ones
dropped, its filter deltas and episodes handed over) → gone. The reaper
never takes a worker with a request in flight or a drain under way. A
drained preemption spends no recovery budget.

The starvation signal: the reference reads its telemetry's queue-depth
gauges, which the port does not have yet (``ROADMAP.md`` queue 1 item
9); here the algorithm reports the same queues' depths
(``Algorithm.sampler_queue_depths``: IMPALA's learner inqueue, PPO's
prefetch feeder), and a synchronous algorithm reports none, so nothing
scales it up on its own, as in the reference.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

from ray_tpu_torch.core import api
from ray_tpu_torch.core.object_store import RayActorError, WorkerCrashedError
from ray_tpu_torch.util import telemetry

_ACTOR_DEAD_ERRORS = (RayActorError, WorkerCrashedError)


class FleetController:
    def __init__(self, algorithm, worker_set, config: Dict):
        self.algo = algorithm
        self.workers = worker_set
        n0 = int(config.get("num_workers", 0))
        self.min_workers = int(config.get("min_workers") or 1)
        self.max_workers = int(config.get("max_workers") or max(2 * n0, n0 + 1))
        self.drain_grace_s = float(config.get("drain_grace_s", 15.0))
        self.idle_timeout_s = float(config.get("fleet_idle_timeout_s", 30.0))
        self.update_interval_s = float(config.get("fleet_interval_s", 1.0))
        self.starvation_patience = int(config.get("fleet_starvation_patience", 3))
        self.scale_up_step = int(config.get("scale_up_step", 1))

        self._lock = threading.Lock()
        self._managers: List = []  # registered AsyncRequestsManagers
        self._noticed: Dict[int, object] = {}  # id(w) -> worker
        self._draining: set = set()  # id(w) with a drain under way
        self._probe_refs: Dict[int, tuple] = {}  # id(w) -> (ref, w)
        self._idle_since: Dict[int, float] = {}
        self._reap_candidates: Dict[int, object] = {}
        self._pending_scale = 0
        self._starved_polls = 0
        self._drained_metrics: List = []

        self.num_scale_ups = 0
        self.num_scale_downs = 0
        self.num_drained = 0
        self.num_preempt_lost = 0
        self.num_reaped = 0

        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="fleet_controller")
        self._thread.start()

    # -- wiring ----------------------------------------------------------

    def register_manager(self, manager) -> None:
        """A request manager whose rotation this fleet feeds: drains take
        workers out of it, and its in-flight counts are the idleness
        signal."""
        with self._lock:
            if manager not in self._managers:
                self._managers.append(manager)

    def request_scale(self, delta: int) -> None:
        """Queue a change of the fleet's size, applied at the next
        ``reconcile()`` within ``[min_workers, max_workers]``."""
        with self._lock:
            self._pending_scale += int(delta)

    def take_drained_metrics(self) -> List:
        """The episodes drained workers handed over (the algorithm's
        metrics read them, so a graceful exit loses no episode)."""
        with self._lock:
            out, self._drained_metrics = self._drained_metrics, []
        return out

    # -- the monitor thread: observe only ----------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self.update_interval_s):
            try:
                self.update()
            except Exception:
                pass

    def update(self) -> None:
        """One observation pass (the monitor thread, or a test): notices,
        starvation, idleness. Records decisions, changes nothing."""
        self._poll_notices()
        self._poll_starvation()
        self._poll_idle()

    def _poll_notices(self) -> None:
        """One ``preemption_notice`` call out per active worker; the
        answers that are in are harvested. A probe queues behind the
        worker's sample calls, so a notice is seen about one sample
        later, well inside a grace window."""
        with self._lock:
            skip = set(self._noticed) | self._draining
        for w in list(self.workers.remote_workers()):
            wid = id(w)
            if wid in skip or wid in self._probe_refs:
                continue
            self._probe_refs[wid] = (w.preemption_notice.remote(), w)
        if not self._probe_refs:
            return
        refs = [r for r, _ in self._probe_refs.values()]
        ready, _ = api.wait(refs, num_returns=len(refs), timeout=0)
        done = {r.id for r in ready}
        for wid, (ref, w) in list(self._probe_refs.items()):
            if ref.id not in done:
                continue
            del self._probe_refs[wid]
            try:
                grace = api.get(ref)
            except Exception:
                continue  # a dead worker: the failure path has it
            if grace is not None:
                with self._lock:
                    self._noticed[wid] = w
                telemetry.event("fleet:preemption_notice", grace_s=float(grace))

    def _poll_starvation(self) -> None:
        """A scale-up step when every sampler-side queue the algorithm
        reports sits empty for ``starvation_patience`` polls in a row."""
        report = getattr(self.algo, "sampler_queue_depths", None)
        depths = list(report().values()) if report is not None else []
        if not depths or any(d > 0 for d in depths):
            self._starved_polls = 0
            return
        self._starved_polls += 1
        if self._starved_polls < self.starvation_patience:
            return
        self._starved_polls = 0
        with self._lock:
            if self.workers.num_remote_workers() + self._pending_scale < self.max_workers:
                self._pending_scale += self.scale_up_step

    def _poll_idle(self) -> None:
        """Reap candidates: workers with no request in flight in any
        registered manager for ``idle_timeout_s``. Without a manager
        (the synchronous algorithms) there is no idleness signal and the
        reaper is off; a draining or noticed worker is never one."""
        with self._lock:
            managers = list(self._managers)
            skip = set(self._noticed) | self._draining
        if not managers:
            return
        now = time.monotonic()
        for w in list(self.workers.remote_workers()):
            wid = id(w)
            if wid in skip or any(m.in_flight(w) > 0 for m in managers):
                self._idle_since.pop(wid, None)
                continue
            t0 = self._idle_since.setdefault(wid, now)
            if now - t0 >= self.idle_timeout_s:
                with self._lock:
                    self._reap_candidates[wid] = w

    # -- the main thread: act --------------------------------------------

    def reconcile(self) -> None:
        """Apply the queued decisions (the main thread, between
        rounds): drain the noticed, reap the idle down to
        ``min_workers``, then settle a scale request."""
        with self._lock:
            noticed = list(self._noticed.items())
            self._noticed.clear()
            self._draining.update(wid for wid, _ in noticed)
        for wid, w in noticed:
            self._retire(w, preempted=True)
            with self._lock:
                self._draining.discard(wid)

        with self._lock:
            reap = list(self._reap_candidates.values())
            self._reap_candidates.clear()
        for w in reap:
            if self.workers.num_remote_workers() <= self.min_workers:
                break
            if w not in self.workers.remote_workers():
                continue
            with self._lock:
                # busy, noticed or draining since it was seen idle
                busy = (id(w) in self._draining or id(w) in self._noticed
                        or any(m.in_flight(w) > 0 for m in self._managers))
            if not busy:
                self._retire(w, preempted=False)

        with self._lock:
            delta, self._pending_scale = self._pending_scale, 0
        if delta:
            cur = self.workers.num_remote_workers()
            target = min(self.max_workers, max(self.min_workers, cur + delta))
            if target > cur:
                self._scale_up(target - cur)
            elif target < cur:
                for w in list(self.workers.remote_workers())[target:]:
                    self._retire(w, preempted=False)
        self._set_gauges()

    def _scale_up(self, k: int) -> None:
        with telemetry.span("fleet:scale_up", workers=k):
            new = self.workers.scale_up(k)
        self.num_scale_ups += len(new)
        if new:
            telemetry.event("fleet:joined", workers=len(new), fleet=self.workers.num_remote_workers())
            self.algo.on_fleet_change(added=new, removed=[])

    def _retire(self, w, *, preempted: bool) -> bool:
        """The drain: stop submissions, take the worker's last state
        within the grace budget, keep its done results for the harvest,
        drop its pending ones, end its process. True when it drained."""
        with self._lock:
            managers = list(self._managers)
        for m in managers:
            m.remove_workers([w])
        recovery = getattr(self.algo, "_recovery", None)
        try:
            final = api.get(w.drain_for_preemption.remote(), timeout=self.drain_grace_s)
        except Exception:
            # died or wedged before the drain: a lost preemption after
            # all; the ordinary death path owns what is left of it
            for m in managers:
                m.retire_worker(w)
            self.workers.remove_workers([w])
            if preempted:
                self.num_preempt_lost += 1
                telemetry.inc_preemptions(drained=False)
                if recovery is not None:
                    recovery.note_preemption(drained=False)
            return False
        self.workers.absorb_filters(final.get("filters") or {})
        with self._lock:
            self._drained_metrics.extend(final.get("metrics") or [])
        for m in managers:
            m.retire_worker(w)
        self.workers.remove_workers([w])
        self._idle_since.pop(id(w), None)
        self._probe_refs.pop(id(w), None)
        if preempted:
            self.num_drained += 1
            telemetry.inc_preemptions(drained=True)
            if recovery is not None:
                recovery.note_preemption(drained=True)
        else:
            self.num_reaped += 1
            self.num_scale_downs += 1
        self.algo.on_fleet_change(added=[], removed=[w])
        return True

    # -- reporting -------------------------------------------------------

    def _set_gauges(self) -> None:
        with self._lock:
            draining = len(self._draining)
        telemetry.set_fleet_size(active=max(0, self.workers.num_remote_workers() - draining),
                                 draining=draining)

    def stats(self) -> Dict:
        with self._lock:
            draining = len(self._draining)
            pending = self._pending_scale
        return {
            "size": self.workers.num_remote_workers(),
            "min_workers": self.min_workers,
            "max_workers": self.max_workers,
            "draining": draining,
            "pending_scale": pending,
            "scale_ups": self.num_scale_ups,
            "scale_downs": self.num_scale_downs,
            "preemptions_drained": self.num_drained,
            "preemptions_lost": self.num_preempt_lost,
            "reaped_idle": self.num_reaped,
        }

    def stop(self) -> None:
        """Signal the monitor thread and join it: an observer must not
        outlive the worker set it watches."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
