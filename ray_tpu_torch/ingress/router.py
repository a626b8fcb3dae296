"""Cross-replica batch coalescing: the router behind the front door.

Counterpart of ``ray_tpu/ingress/router.py``. Each
``BatchedPolicyServer`` coalesces only the requests that reach its own
queue, so at moderate load N replicas run N under-full buckets where one
full bucket would do. This router merges the streams before dispatch:
every ingress request for a deployment lands in one queue, the batcher
forms full power-of-two buckets from it, and each bucket goes to one
replica as a single atomic run (``submit_many`` /
``PolicyDeployment.handle_rows``). Merging changes a bucket's occupancy,
never its shape, so a replica replays only the graphs it captured at
warmup.

Determinism: a replica's server draws once per real request in arrival
order, and the router dispatches buckets to a replica in formation order
from one batcher thread, so any router coalescing of a fixed-seed stream
onto one replica is bitwise the same as sequential ``compute_actions``.

Reliability: expired requests are dropped at collection, before
dispatch; a dispatch that dies (actor death, stopped server, timeout)
marks the replica dead and re-queues the bucket's requests at the front;
the router polls the serve controller's membership feed
(``serve.membership_feed``) between batches.
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ray_tpu_torch.core.api import ActorHandle
from ray_tpu_torch.serve.policy_server import TrailingWindow, default_buckets
from ray_tpu_torch.util import telemetry


class DeadlineExpired(RuntimeError):
    """The request's deadline passed before a replica computed it."""


class NoReplicasAvailable(RuntimeError):
    """Every known replica is dead and membership has no fresh ones."""


class LocalReplica:
    """In-process replica client over a ``BatchedPolicyServer`` (or a
    ``PolicyDeployment`` owning one). ``begin`` enqueues the bucket
    atomically on the caller's thread (per-replica FIFO, the determinism
    anchor); ``finish`` blocks for the results on a dispatch thread."""

    def __init__(self, server, name: str = "local"):
        self.server = getattr(server, "server", server)
        self.name = name
        self.dead = False

    def begin(self, rows: Sequence[Any], explore):
        return self.server.submit_many(rows, explore=explore)

    def finish(self, token, timeout_s: float) -> List[Dict[str, Any]]:
        out = []
        deadline = time.perf_counter() + timeout_s
        for fut in token:
            action, extra = fut.result(max(0.0, deadline - time.perf_counter()))
            out.append({"action": action, "params_version": fut.params_version, "extra": extra})
        return out

    def alive(self) -> bool:
        return not self.dead and self.server.error is None and not self.server._stop.is_set()

    def queue_wait_p50_s(self) -> Optional[float]:
        # the same window stats() feeds the autoscaler
        return self.server.queue_wait_window()["p50_s"]


class ActorReplica:
    """Replica client over a serve-core ``_Replica`` actor hosting a
    ``PolicyDeployment``. ``begin`` is the non-blocking actor call
    (ordered per actor), ``finish`` the bounded harvest; actor-death
    errors surface in ``finish`` and mark the replica dead."""

    def __init__(self, actor, name: str = "replica"):
        self.actor = actor
        self.name = name
        self.dead = False

    def begin(self, rows: Sequence[Any], explore):
        return self.actor.call_method.remote(
            "handle_rows", [[np.asarray(r).tolist() for r in rows]], {"explore": explore},
        )

    def finish(self, token, timeout_s: float) -> List[Dict[str, Any]]:
        from ray_tpu_torch import core

        return core.get(token, timeout=timeout_s)

    def alive(self) -> bool:
        return not self.dead

    def queue_wait_p50_s(self) -> Optional[float]:
        # remote stats are the autoscaler's polling job, not the
        # per-request admission path's
        return None


def _is_actor_handle(member) -> bool:
    # by type: an ActorHandle makes an ActorMethod for any public
    # attribute name, so every hasattr() probe answers True
    return isinstance(member, ActorHandle)


def wrap_replica(member, index: int = 0):
    """Default membership wrap: serve actors to :class:`ActorReplica`,
    in-process servers or deployments to :class:`LocalReplica`."""
    if _is_actor_handle(member):
        return ActorReplica(member, name=f"replica-{index}")
    return LocalReplica(member, name=f"local-{index}")


def _as_client(member, index: int, wrap) -> Any:
    """One membership entry as a replica client: actor handles and bare
    servers go through ``wrap``; objects that already speak the client
    protocol (begin/finish) pass through."""
    if _is_actor_handle(member):
        return wrap(member, index)
    if hasattr(member, "begin") and hasattr(member, "finish"):
        return member
    return wrap(member, index)


def _safe_reject(fut: Future, err: BaseException) -> None:
    """Reject a request future, tolerating a client that cancelled it."""
    try:
        fut.set_exception(err)
    except Exception:
        pass


def _safe_resolve(fut: Future, value) -> None:
    try:
        if fut.set_running_or_notify_cancel():
            fut.set_result(value)
    except Exception:
        pass


class _RouterRequest:
    __slots__ = ("obs", "explore", "deadline", "future", "t_submit")

    def __init__(self, obs, explore, deadline, future, t_submit):
        self.obs = obs
        self.explore = explore
        self.deadline = deadline
        self.future = future
        self.t_submit = t_submit


class CoalescingRouter:
    """Merges ingress requests across replicas into full power-of-two
    buckets before dispatch. Callers enqueue from any thread; ONE
    batcher thread forms buckets and begins dispatches (per-replica
    FIFO); a small pool harvests results, so a slow replica never stalls
    bucket formation."""

    def __init__(
        self,
        name: str,
        replicas: Sequence[Any] = (),
        *,
        membership=None,
        wrap: Optional[Callable[[Any, int], Any]] = None,
        max_batch_size: int = 32,
        buckets: Optional[Sequence[int]] = None,
        batch_wait_timeout_s: float = 0.002,
        default_deadline_s: Optional[float] = None,
        dispatch_timeout_s: float = 60.0,
        dispatch_workers: int = 4,
        stats_window_s: float = 30.0,
        start: bool = True,
    ):
        self.name = name
        self.max_batch_size = int(max_batch_size)
        self.buckets = tuple(
            sorted(set(int(b) for b in buckets)) if buckets
            else default_buckets(self.max_batch_size)
        )
        self.batch_wait_timeout_s = float(batch_wait_timeout_s)
        self.default_deadline_s = default_deadline_s
        self.dispatch_timeout_s = float(dispatch_timeout_s)
        self._membership = membership
        self._wrap = wrap or wrap_replica
        self._members_version = -1
        self._members_lock = threading.Lock()
        self._replicas: List[Any] = [_as_client(r, i, self._wrap) for i, r in enumerate(replicas)]
        self._rr = 0

        self._queue: "collections.deque[_RouterRequest]" = collections.deque()
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self.error: Optional[BaseException] = None

        self.batches_total = 0
        self.merged_rows_total = 0
        self.expired_total = 0
        self.rerouted_total = 0
        self._wait_window = TrailingWindow(stats_window_s)

        self._pool = ThreadPoolExecutor(max_workers=int(dispatch_workers),
                                        thread_name_prefix=f"router_dispatch_{name}")
        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._refresh_membership()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"router_batcher_{self.name}")
        self._thread.start()

    # -- client side -----------------------------------------------------

    def submit(self, obs, explore: Optional[bool] = None,
               deadline_s: Optional[float] = None) -> Future:
        """Enqueue one observation; returns a ``concurrent.futures``
        Future of ``{"action", "params_version", ...}`` (or raising
        :class:`DeadlineExpired` / :class:`NoReplicasAvailable`).
        ``deadline_s`` is relative; an expired request is dropped before
        dispatch, never computed."""
        if self._stop.is_set():
            raise RuntimeError("router is stopped")
        now = time.perf_counter()
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        fut: Future = Future()
        req = _RouterRequest(obs, explore, now + deadline_s if deadline_s is not None else None,
                             fut, now)
        with self._cv:
            self._queue.append(req)
            self._cv.notify_all()
        return fut

    # -- batcher thread --------------------------------------------------

    def _run(self) -> None:
        try:
            while True:
                with self._cv:
                    while not self._queue and not self._stop.is_set():
                        self._cv.wait()
                    if self._stop.is_set() and not self._queue:
                        break
                self._refresh_membership()
                batch, expired = self._collect()
                self._drop_expired(expired)
                if batch:
                    self._dispatch(batch)
        except BaseException as e:  # pragma: no cover - defensive
            self.error = e
            with self._cv:
                pending = list(self._queue)
                self._queue.clear()
            for req in pending:
                _safe_reject(req.future, e)

    def _refresh_membership(self) -> None:
        """Adopt the controller's replica set when its feed version
        moved. A republished membership holds only live actors, so a
        fresh wrap also clears stale dead marks. Called from the batcher
        thread and from health and stats readers, hence the lock."""
        if self._membership is None:
            return
        try:
            version, members = self._membership.current()
        except Exception:
            return
        with self._members_lock:
            if version == self._members_version:
                return
            self._members_version = version
            if members:
                self._replicas = [_as_client(m, i, self._wrap) for i, m in enumerate(members)]

    def _collect(self):
        """Form one bucket: wait for a full ``max_batch_size`` run (or
        the coalesce timeout after the FIRST request), then drain a
        same-explore FIFO run, splitting out expired requests."""
        with self._cv:
            if not self._queue:
                return [], []
            deadline = self._queue[0].t_submit + self.batch_wait_timeout_s
            while len(self._queue) < self.max_batch_size and not self._stop.is_set():
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            now = time.perf_counter()
            batch: List[_RouterRequest] = []
            expired: List[_RouterRequest] = []
            flag = None
            while self._queue and len(batch) < self.max_batch_size:
                req = self._queue[0]
                if req.deadline is not None and now > req.deadline:
                    expired.append(self._queue.popleft())
                    continue
                if flag is None:
                    flag = req.explore
                elif req.explore != flag:
                    break
                batch.append(self._queue.popleft())
            return batch, expired

    def _drop_expired(self, expired) -> None:
        if not expired:
            return
        self.expired_total += len(expired)
        telemetry.inc_router_expired(self.name, len(expired))
        for req in expired:
            _safe_reject(req.future, DeadlineExpired(
                f"request expired before dispatch (waited {time.perf_counter() - req.t_submit:.3f}s)"
            ))

    def _next_replica(self):
        n = len(self._replicas)
        for _ in range(n):
            r = self._replicas[self._rr % n]
            self._rr += 1
            if r.alive():
                return r
        return None

    def _dispatch(self, batch: List[_RouterRequest]) -> None:
        """Begin the bucket on one live replica (on THIS thread, so a
        replica sees buckets in formation order) and hand the blocking
        harvest to the pool."""
        replica = self._next_replica()
        if replica is None:
            # one forced membership refresh before giving up: the
            # controller may have replaced the corpses already
            self._members_version = -1
            self._refresh_membership()
            replica = self._next_replica()
        if replica is None:
            err = NoReplicasAvailable(f"deployment {self.name!r}: no live replicas")
            for req in batch:
                _safe_reject(req.future, err)
            return
        rows = [req.obs for req in batch]
        t0 = time.perf_counter()
        try:
            token = replica.begin(rows, batch[0].explore)
        except Exception:
            replica.dead = True
            self._requeue(batch)
            return
        self.batches_total += 1
        self.merged_rows_total += len(batch)
        telemetry.observe_router_batch(self.name, len(batch))
        for req in batch:
            self._wait_window.observe(t0 - req.t_submit, t=t0)
        self._pool.submit(self._finish, replica, token, batch)

    def _requeue(self, batch: List[_RouterRequest]) -> None:
        """A failed bucket's requests back at the FRONT of the queue in
        their original order (the next collection filters expired
        ones)."""
        self.rerouted_total += len(batch)
        telemetry.inc_router_rerouted(self.name, len(batch))
        with self._cv:
            for req in reversed(batch):
                self._queue.appendleft(req)
            self._cv.notify_all()

    def _finish(self, replica, token, batch) -> None:
        """Harvest one dispatched bucket on a pool thread; a dead or
        wedged replica sends the bucket back through the queue."""
        try:
            with telemetry.span("router:dispatch", rows=len(batch), replica=replica.name):
                results = replica.finish(token, self.dispatch_timeout_s)
            if len(results) != len(batch):
                raise RuntimeError(
                    f"replica returned {len(results)} results for {len(batch)} requests"
                )
        except BaseException:
            replica.dead = True
            self._requeue(batch)
            return
        for req, row in zip(batch, results):
            _safe_resolve(req.future, row)

    # -- introspection / lifecycle ---------------------------------------

    def queue_wait_signal(self) -> Optional[float]:
        """The shedding signal for admission control: the worst p50
        queue wait across this router's window and every local
        replica's ``queue_wait_window()``."""
        waits = [self._wait_window.pct(50)]
        for r in self._replicas:
            try:
                waits.append(r.queue_wait_p50_s())
            except Exception:
                pass
        waits = [w for w in waits if w is not None]
        return max(waits) if waits else None

    def num_replicas(self) -> int:
        self._refresh_membership()
        return len(self._replicas)

    def num_dead(self) -> int:
        return sum(0 if r.alive() else 1 for r in self._replicas)

    def stats(self) -> Dict[str, Any]:
        with self._cv:
            depth = len(self._queue)
        return {
            "name": self.name,
            "queue_depth": depth,
            "replicas": self.num_replicas(),
            "dead_replicas": self.num_dead(),
            "batches_total": self.batches_total,
            "merged_rows_total": self.merged_rows_total,
            "mean_merged_rows": (self.merged_rows_total / self.batches_total
                                 if self.batches_total else 0.0),
            "expired_total": self.expired_total,
            "rerouted_total": self.rerouted_total,
            "queue_wait": self._wait_window.snapshot(),
            "buckets": list(self.buckets),
        }

    def stop(self, join_timeout: float = 30.0) -> None:
        self._stop.set()
        with self._cv:
            pending = list(self._queue)
            self._queue.clear()
            self._cv.notify_all()
        err = RuntimeError("router stopped")
        for req in pending:
            _safe_reject(req.future, err)
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=join_timeout)
        self._pool.shutdown(wait=False)
