"""Asynchronous request management for rollout-worker fleets.

Counterpart of ``ray_tpu/execution/parallel_requests.py``, over the
port's runtime (``core.wait``/``core.get``): keep up to
``max_remote_requests_in_flight_per_worker`` requests outstanding per
actor, harvest completions with ``wait`` (a straggler does not gate the
round: results flow in completion order), and drop dead actors from the
rotation and report them instead of raising.

The reference frees a harvested ref with ``ray.free``; here dropping
the ref is the free, because the port's object plane unlinks an
object's segment when its last ref in the main process goes
(``core/object_store.py``). ``return_object_refs`` (IMPALA's
aggregation actors) harvests the done refs themselves: the caller
passes each on, and reports a worker whose ref turns out dead with
``report_dead``.

The elastic half (the fleet controller's drains): ``retire_worker``
takes a worker out of the rotation, keeps its done requests for the
normal harvest, drops its pending ones and keeps a later death of it
from being reported; ``remove_workers(drop_in_flight=True)`` drops every
request of the removed workers. ``retry_policy`` (the resilience
layer's ``RetryPolicy``) bounds a harvest the caller did not bound and
retries a submission's transport faults.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.core import api
from ray_tpu_torch.core.object_store import RayActorError, WorkerCrashedError
from ray_tpu_torch.telemetry import metrics as telemetry_metrics
from ray_tpu_torch.util import tracing

# actor-fatal errors: the worker is gone, and its pending results with it
_ACTOR_DEAD_ERRORS = (RayActorError, WorkerCrashedError)


def _default_remote_fn(worker):
    return worker.sample.remote()


class AsyncRequestsManager:
    """Tracks in-flight remote requests across a set of actors.

    - ``submit`` and ``submit_available`` enforce the per-worker cap.
    - ``get_ready`` blocks (up to ``timeout``) until ``min_results``
      requests are done, then sweeps everything else already done.
    - A worker whose harvested ref raises an actor-fatal error leaves
      the rotation and is queued for ``take_dead_workers`` (reported
      once). A task error (``RayTaskError``) still raises. In refs mode
      (``return_object_refs``) ``get_ready`` returns the refs, and the
      caller reports a dead worker (``report_dead``).
    """

    def __init__(
        self,
        workers: Optional[List] = None,
        *,
        max_remote_requests_in_flight_per_worker: int = 2,
        return_object_refs: bool = False,
        retry_policy=None,
        name: str = "default",
    ):
        # the manager's tag on its in-flight gauge and dead-worker counter
        self.name = name
        self._max_in_flight = int(max_remote_requests_in_flight_per_worker)
        self._return_refs = bool(return_object_refs)
        self._retry = retry_policy
        self._workers: List = []
        self._in_flight: Dict = {}  # ref -> worker
        self._counts: Dict[int, int] = {}  # id(worker) -> outstanding
        self._dead: List = []  # seen dead, not yet reported
        self._dead_ids: set = set()  # id() of every worker ever seen dead
        self.num_completed = 0
        self.num_dropped = 0  # results lost to dead workers
        self.add_workers(workers or [])

    # -- fleet membership ------------------------------------------------

    def add_workers(self, workers: List) -> None:
        for w in workers:
            if w not in self._workers:
                self._workers.append(w)
                # reset, not setdefault: a new handle can reuse a freed
                # id(), and a dead one's count or dead mark must not
                # stick to it
                self._counts[id(w)] = 0
                self._dead_ids.discard(id(w))
                self._dead = [d for d in self._dead if d is not w]

    def remove_workers(self, workers: List, *, drop_in_flight: bool = False) -> int:
        """Stop submitting to ``workers``. Their in-flight refs stay
        tracked and drain through ``get_ready``, or, with
        ``drop_in_flight``, are dropped (and so freed). Returns the
        number dropped."""
        drop = {id(w) for w in workers}
        self._workers = [w for w in self._workers if id(w) not in drop]
        if not drop_in_flight:
            return 0
        return self._drop_refs(drop)

    def _drop_refs(self, worker_ids: set, pending_only: bool = False) -> int:
        """Drop the in-flight refs of ``worker_ids``; ``pending_only``
        keeps the done ones, whose results harvest normally even after
        the worker's process is gone."""
        victims = [ref for ref, w in self._in_flight.items() if id(w) in worker_ids]
        if pending_only and victims:
            ready, _ = api.wait(victims, num_returns=len(victims), timeout=0)
            done = {r.id for r in ready}
            victims = [r for r in victims if r.id not in done]
        for ref in victims:
            wid = id(self._in_flight.pop(ref))
            self._counts[wid] = max(0, self._counts.get(wid, 1) - 1)
            self.num_dropped += 1
        return len(victims)

    def retire_worker(self, worker) -> int:
        """A planned exit (a drain or a reap): out of the rotation, its
        done requests kept for the harvest, its pending ones dropped, and
        a later death of it not reported (a planned exit is no failure).
        Returns the number dropped."""
        self._workers = [w for w in self._workers if w is not worker]
        dropped = self._drop_refs({id(worker)}, pending_only=True)
        self._dead_ids.add(id(worker))
        self._dead = [d for d in self._dead if d is not worker]
        return dropped

    def workers(self) -> List:
        return list(self._workers)

    def take_dead_workers(self) -> List:
        """Workers seen dead since the last call (reported once)."""
        dead, self._dead = self._dead, []
        return dead

    # -- submission ------------------------------------------------------

    def in_flight(self, worker=None) -> int:
        if worker is not None:
            return self._counts.get(id(worker), 0)
        return len(self._in_flight)

    def submit(self, remote_fn: Optional[Callable] = None, *, worker=None) -> bool:
        """``remote_fn(worker)`` (default ``worker.sample.remote()``) if
        the worker is live and under its cap; with no ``worker``, the
        least-loaded live worker with a free slot. False when nothing
        was submitted."""
        remote_fn = remote_fn or _default_remote_fn
        if worker is None:
            candidates = [w for w in self._workers if self._counts.get(id(w), 0) < self._max_in_flight]
            if not candidates:
                return False
            worker = min(candidates, key=lambda w: self._counts.get(id(w), 0))
        elif worker not in self._workers or self._counts.get(id(worker), 0) >= self._max_in_flight:
            return False
        try:
            if self._retry is not None:
                # transport faults retry on the schedule; a death does not
                ref = self._retry.call(lambda: remote_fn(worker))
            else:
                ref = remote_fn(worker)
        except _ACTOR_DEAD_ERRORS:
            self._mark_dead(worker)
            return False
        self._in_flight[ref] = worker
        self._counts[id(worker)] = self._counts.get(id(worker), 0) + 1
        return True

    def submit_available(self, remote_fn: Optional[Callable] = None) -> int:
        """Top every live worker up to the cap; returns the count sent."""
        t0 = time.time()
        n = 0
        for w in list(self._workers):
            while self.submit(remote_fn, worker=w):
                n += 1
        if n:
            telemetry_metrics.set_requests_in_flight(self.name, len(self._in_flight))
            tracing.record_span("requests:submit", t0, time.time(), manager=self.name,
                                submitted=n, in_flight=len(self._in_flight))
        return n

    # -- harvest ---------------------------------------------------------

    def get_ready(self, *, timeout: Optional[float] = None, min_results: int = 1) -> Dict[Any, List]:
        """Done requests as ``{worker: [result, ...]}``, each worker's in
        submission order. Blocks up to ``timeout`` (None: without limit)
        for ``min_results`` completions, then sweeps whatever else is
        done without blocking. Dead workers are dropped and recorded."""
        refs = list(self._in_flight)
        if not refs:
            return {}
        if timeout is None and self._retry is not None:
            # no wait without a bound against a wedged actor: the caller
            # sees an empty harvest and polls again
            timeout = self._retry.timeout_s
        if timeout is None or timeout > 0:
            api.wait(refs, num_returns=min(max(1, min_results), len(refs)), timeout=timeout)
        ready, _ = api.wait(refs, num_returns=len(refs), timeout=0)
        t_harvest0 = time.time()
        out: Dict[Any, List] = {}
        for ref in ready:
            worker = self._in_flight.pop(ref)
            wid = id(worker)
            self._counts[wid] = max(0, self._counts.get(wid, 1) - 1)
            if self._return_refs:
                out.setdefault(worker, []).append(ref)
                self.num_completed += 1
                continue
            try:
                result = api.get(ref)
            except _ACTOR_DEAD_ERRORS:
                self._mark_dead(worker)
                continue
            out.setdefault(worker, []).append(result)
            self.num_completed += 1
        if ready:
            telemetry_metrics.set_requests_in_flight(self.name, len(self._in_flight))
            tracing.record_span("requests:harvest", t_harvest0, time.time(), manager=self.name,
                                harvested=len(ready), workers=len(out))
        return out

    def report_dead(self, worker) -> None:
        """A death the caller saw (refs mode: a harvested ref that raises
        where the caller reads or passes it): the worker leaves the
        rotation and is queued for ``take_dead_workers``."""
        self._mark_dead(worker)

    def _mark_dead(self, worker) -> None:
        self.num_dropped += 1
        self.remove_workers([worker])
        if id(worker) not in self._dead_ids:
            self._dead_ids.add(id(worker))
            self._dead.append(worker)
            telemetry_metrics.inc_dead_workers(self.name)
            tracing.event("worker:dead", manager=self.name, live_workers=len(self._workers))

    def stats(self) -> Dict[str, int]:
        return {
            "num_requests_in_flight": len(self._in_flight),
            "num_completed": self.num_completed,
            "num_dropped_dead_worker": self.num_dropped,
            "num_live_workers": len(self._workers),
        }


def asynchronous_parallel_requests(
    manager: AsyncRequestsManager,
    *,
    remote_fn: Optional[Callable] = None,
    timeout: Optional[float] = 0.1,
    min_results: int = 1,
) -> Dict[Any, List]:
    """One poll round: top every live worker up to its cap, then
    harvest whatever has completed."""
    manager.submit_available(remote_fn)
    return manager.get_ready(timeout=timeout, min_results=min_results)


def wait_asynchronous_requests(
    manager: AsyncRequestsManager, *, deadline_s: float, min_results: int = 1
) -> Dict[Any, List]:
    """``get_ready`` with an absolute budget: polls again until
    ``min_results`` arrive or ``deadline_s`` passes (a dead worker can
    end one wait early with nothing)."""
    t0 = time.monotonic()
    out: Dict[Any, List] = {}
    got = 0
    while True:
        remaining = deadline_s - (time.monotonic() - t0)
        ready = manager.get_ready(timeout=max(0.0, remaining), min_results=min_results - got)
        for w, results in ready.items():
            out.setdefault(w, []).extend(results)
            got += len(results)
        if got >= min_results or remaining <= 0 or not manager.in_flight():
            return out
