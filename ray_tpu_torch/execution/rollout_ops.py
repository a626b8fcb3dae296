"""Rollout collection: ``synchronous_parallel_sample`` and
``SamplePrefetcher``.

Counterpart of ``ray_tpu/execution/rollout_ops.py``.
``synchronous_parallel_sample`` keeps the reference's round semantics:
one ``sample`` request per worker per round, the round's batches
ordered by worker index, rounds until the step target is met (env
steps; agent steps of a ``MultiAgentBatch`` under ``max_agent_steps``),
concatenated per policy when the batches are multi-agent; a dead
worker raises ``RayActorError`` after the healthy workers' results are
in. The round waits with ``wait``/``get`` directly instead of the
reference's ``AsyncRequestsManager``, whose docstring states that both
give bit-identical results.

``SamplePrefetcher`` is the on-policy prefetch pipeline
(``sample_prefetch``): a thread keeps every worker at its in-flight cap
(``AsyncRequestsManager``), harvests fragments in completion order,
gathers them into train batches and hands each to ``deliver`` (PPO:
standardize, prepare, and put on a ``DeviceFeeder``, whose bounded
queue is the back-pressure that bounds staleness). A batch is made of
whole rounds, as ``synchronous_parallel_sample`` makes it: a round is
the next harvested fragment of each live worker, in the rotation's
order, and rounds are added until the step target is met. Harvested
fragments wait in per-worker queues, so a slow worker delays a batch
but not the harvest of the others. The reference instead concatenates
fragments in the order they arrive, which makes a batch depend on which
reply a harvest saw first; here the first batch of a run is the
synchronous path's first batch, bitwise.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, List, Optional

from ray_tpu_torch.core import api
from ray_tpu_torch.core.object_store import RayActorError, WorkerCrashedError
from ray_tpu_torch.data.sample_batch import MultiAgentBatch, SampleBatch, concat_samples
from ray_tpu_torch.execution.parallel_requests import (
    AsyncRequestsManager,
    asynchronous_parallel_requests,
)
from ray_tpu_torch.util import tracing


def synchronous_parallel_sample(
    *,
    worker_set,
    max_agent_steps: Optional[int] = None,
    max_env_steps: Optional[int] = None,
    concat: bool = True,
):
    """Sample from every worker in parallel until the step target is met
    (the local worker when there is no remote one)."""
    max_steps = max_agent_steps or max_env_steps
    steps = 0
    all_batches: List = []
    workers = worker_set.remote_workers()
    while True:
        if not workers:
            batches = [worker_set.local_worker().sample()]
        else:
            refs = [w.sample.remote() for w in workers]
            api.wait(refs, num_returns=len(refs))
            batches, dead = [], False
            for ref in refs:
                try:
                    batches.append(api.get(ref))
                except (RayActorError, WorkerCrashedError):
                    dead = True
            if dead:
                raise RayActorError("rollout worker died during synchronous_parallel_sample")
        steps += _count_steps(batches, max_agent_steps)
        all_batches.extend(batches)
        if max_steps is None or steps >= max_steps:
            break
    return concat_samples(all_batches) if concat else all_batches


def _count_steps(batches, by_agent_steps) -> int:
    if by_agent_steps:
        return sum(b.agent_steps() if isinstance(b, MultiAgentBatch) else b.count for b in batches)
    return sum(b.env_steps() for b in batches)


class SamplePrefetcher:
    """A daemon thread that samples train batches ahead of the learner.

    It saturates every rollout worker (``max_in_flight`` requests each),
    harvests fragments in completion order into per-worker queues, and
    whenever whole rounds of them reach ``target_steps``, concatenates
    those rounds and calls ``deliver(batch)``, which may block on
    back-pressure. Dead workers are dropped and reported
    (:meth:`take_dead_workers`), and their waiting fragments with them;
    the pipeline goes on with the others. An exception on the thread
    parks in :attr:`error` and ends the thread."""

    def __init__(
        self,
        worker_set,
        *,
        target_steps: int,
        deliver: Callable[[SampleBatch], None],
        max_in_flight: int = 2,
        poll_timeout_s: float = 0.2,
    ):
        self._manager = AsyncRequestsManager(
            worker_set.remote_workers(),
            max_remote_requests_in_flight_per_worker=max_in_flight,
            name="sample_prefetcher",
        )
        self._target = int(target_steps)
        self._deliver = deliver
        self._poll_timeout = float(poll_timeout_s)
        self._stop = threading.Event()
        self.error: Optional[BaseException] = None
        self.num_batches = 0
        self.num_fragments = 0
        self.num_env_steps = 0  # harvested
        self._thread = threading.Thread(target=self._run, daemon=True, name="sample_prefetcher")
        self._thread.start()

    def _take_rounds(self, fifos: Dict[int, collections.deque]) -> Optional[List]:
        """The fragments of the fewest whole rounds that reach the step
        target (round-major, workers in rotation order), taken off their
        queues; None while the queued rounds fall short."""
        live = self._manager.workers()
        if not live:
            return None
        queues = [fifos.setdefault(id(w), collections.deque()) for w in live]
        steps, rounds = 0, 0
        while steps < self._target and rounds < min(len(q) for q in queues):
            steps += sum(q[rounds].env_steps() for q in queues)
            rounds += 1
        if steps < self._target:
            return None
        return [q.popleft() for _ in range(rounds) for q in queues]

    def _run(self) -> None:
        fifos: Dict[int, collections.deque] = {}
        try:
            while not self._stop.is_set():
                ready = asynchronous_parallel_requests(self._manager, timeout=self._poll_timeout)
                if not ready and not self._manager.in_flight():
                    # every worker dead or removed: wait for the main thread
                    self._stop.wait(self._poll_timeout)
                    continue
                for w, results in ready.items():
                    fifos.setdefault(id(w), collections.deque()).extend(results)
                    self.num_fragments += len(results)
                    self.num_env_steps += sum(b.env_steps() for b in results)
                live = {id(w) for w in self._manager.workers()}
                for wid in [k for k in fifos if k not in live]:
                    del fifos[wid]  # a dead worker's fragments go with it
                frags = self._take_rounds(fifos)
                while frags is not None:
                    with tracing.start_span("prefetch:assemble", fragments=len(frags),
                                            steps=sum(b.env_steps() for b in frags)):
                        batch = concat_samples(frags)
                    # blocks on the feeder's backpressure: the prefetch depth
                    with tracing.start_span("prefetch:deliver"):
                        self._deliver(batch)
                    self.num_batches += 1
                    frags = self._take_rounds(fifos)
        except BaseException as e:  # surfaced through healthy() and error
            self.error = e

    def healthy(self) -> bool:
        return self.error is None and self._thread.is_alive()

    @property
    def manager(self) -> AsyncRequestsManager:
        """The request manager of the thread's rotation (the elastic
        fleet drains workers out of it and reads its in-flight counts)."""
        return self._manager

    def take_dead_workers(self) -> List:
        return self._manager.take_dead_workers()

    def add_workers(self, workers: List) -> None:
        """Workers that join the rotation (replacements, joiners)."""
        self._manager.add_workers(workers)

    def stats(self) -> dict:
        return {"num_train_batches": self.num_batches, "num_fragments": self.num_fragments,
                "num_env_steps_harvested": self.num_env_steps, **self._manager.stats()}

    def request_stop(self) -> None:
        """Signal the thread without joining; call before stopping the
        feeder, so that a ``deliver`` unblocked by the feeder's stop
        finds the flag set."""
        self._stop.set()

    def stop(self, join_timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=join_timeout)
