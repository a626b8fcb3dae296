"""WorkerSet: the local (learner) worker and N remote rollout actors.

Counterpart of ``ray_tpu/evaluation/worker_set.py``. The remote workers
are ``RolloutWorker`` actors of the port's runtime (``core/``), each in
a process of its own with its policies on the CPU; every worker gets the
same ``policy_specs`` and ``policy_mapping_fn`` (a lambda travels by
value: ``core/serialization.py``). ``sync_weights`` takes the learner's
weights of every policy (or of ``policies``) once as numpy, makes one
``put`` (a shared-memory segment above 256 KB) and sends every worker
that ref; a worker's calls run in submission order, so the new weights
are in place before its next ``sample``.

:func:`evaluation_worker_config` is the config of an algorithm's
evaluation worker set (``Algorithm.evaluation_workers``).

The elastic set (the resilience layer's, ``ROADMAP.md`` queue 1 item
3d): ``add_workers`` starts workers mid-run and queues the learner's
weights and filters on them ahead of any sample call (a worker's calls
run in submission order), so a joiner never samples with stale weights;
``replace_failed_workers`` (deaths a request manager saw) and
``recreate_failed_workers`` (a bounded ``probe_unhealthy_workers``
sweep) start replacements with ``_REPLACEMENT_OVERRIDES``, which disarm
the fault injector; ``scale_up``, ``scale_to`` and ``absorb_filters``
serve the fleet controller. ``remove_workers`` drops workers (seen dead,
or wedged) and ends their processes. Every blocking call on the remote
workers (``sync_filters``, ``foreach_worker``) is bounded by the
config's ``RetryPolicy`` (``retry_policy``); a dead worker does not stop
a broadcast to the others. The reference's in-place actor restarts
(``max_restarts``) are the runtime's (item 9): a dead worker is always
replaced by the recovery layer here.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ray_tpu_torch.core import api
from ray_tpu_torch.core.object_store import GetTimeoutError, RayActorError, WorkerCrashedError
from ray_tpu_torch.evaluation.rollout_worker import RolloutWorker
from ray_tpu_torch.resilience.retry import RetryPolicy, probe_actors
from ray_tpu_torch.telemetry import metrics as telemetry_metrics
from ray_tpu_torch.utils.filter import MeanStdFilter

STOP_TIMEOUT_S = 10.0
_ACTOR_DEAD_ERRORS = (RayActorError, WorkerCrashedError)


def evaluation_worker_config(config: Dict) -> Dict:
    """The evaluation workers' config, as the reference builds it
    (``ray_tpu/algorithms/algorithm.py:222-249``): ``evaluation_config``
    merged over ``config``, ``num_workers`` 0 (the evaluation set's own
    count is ``evaluation_num_workers``), and ``input``/``output`` only
    where ``evaluation_config`` names them."""
    over = config.get("evaluation_config") or {}
    return {**config, **over, "num_workers": 0,
            "output": over.get("output"), "input": over.get("input")}


class WorkerSet:
    def __init__(
        self,
        *,
        env_creator,
        policy_cls,
        config: Dict,
        num_workers: int = 0,
        device=None,
        policy_specs: Optional[Dict] = None,
        policy_mapping_fn: Optional[Callable] = None,
    ):
        self._env_creator = env_creator
        self._policy_cls = policy_cls
        self._config = config
        self._specs = dict(policy_specs=policy_specs, policy_mapping_fn=policy_mapping_fn)
        self._remote_workers: List = []
        # each remote handle's worker_index (id(handle) -> index), which
        # seeds its env and policy
        self._indices: Dict[int, int] = {}
        # the one retry and timeout schedule of every blocking remote call here
        self._retry = RetryPolicy.from_config(config)
        self._local_worker = RolloutWorker(
            env_creator=env_creator, policy_cls=policy_cls, config=config,
            worker_index=0, num_workers=num_workers, device=device, **self._specs,
        )
        if num_workers > 0:
            # the first workers need no sync: they built their policies
            # from the config and seed the local worker did
            self.add_workers(num_workers, sync=False)

    def add_workers(self, num_workers: int, *, config_overrides: Optional[Dict] = None,
                    sync: bool = True, indices: Optional[List[int]] = None) -> None:
        """Start ``num_workers`` remote workers, numbered ``indices`` (a
        replacement takes its dead worker's) or after the largest live
        index, so no two live workers share a seed; ``num_workers`` tells
        each the fleet's size. ``config_overrides`` over the config (the
        replacements' disarmed injector); ``sync`` queues the learner's
        weights and filters on them before anything else is sent."""
        if not api.is_initialized():
            api.init()
        remote_worker = api.remote(RolloutWorker)
        start = len(self._remote_workers)
        if indices is None:
            last = max(self._indices.values(), default=0)
            indices = list(range(last + 1, last + 1 + num_workers))
        fleet = start + num_workers
        config = {**self._config, **(config_overrides or {})}
        for index in indices:
            w = remote_worker.remote(
                env_creator=self._env_creator, policy_cls=self._policy_cls, config=config,
                worker_index=index, num_workers=fleet, **self._specs,
            )
            self._remote_workers.append(w)
            self._indices[id(w)] = index
        self._update_fleet_gauge()
        if sync:
            self._sync_new_workers(self._remote_workers[start:])

    def _sync_new_workers(self, new_workers: List) -> None:
        if not new_workers or not self._local_worker.policy_map:
            return
        ref = api.put(self._local_worker.get_weights())
        filters = self._local_worker.get_filters()
        for w in new_workers:
            w.set_weights.remote(ref)
            w.sync_filters.remote(filters)

    def _update_fleet_gauge(self) -> None:
        telemetry_metrics.gauge(
            telemetry_metrics.ROLLOUT_WORKERS, "live remote rollout workers in this WorkerSet",
        ).set(float(len(self._remote_workers)))

    def local_worker(self) -> RolloutWorker:
        return self._local_worker

    def remote_workers(self) -> List:
        return self._remote_workers

    def num_remote_workers(self) -> int:
        return len(self._remote_workers)

    @property
    def retry_policy(self) -> RetryPolicy:
        return self._retry

    def remove_workers(self, workers: List) -> None:
        """Drop these worker handles (seen dead by the caller, or wedged)
        and end their processes."""
        drop = {id(w) for w in workers}
        for w in self._remote_workers:
            if id(w) in drop:
                api.kill(w)
                self._indices.pop(id(w), None)
        self._remote_workers = [w for w in self._remote_workers if id(w) not in drop]
        self._update_fleet_gauge()

    # -- the elastic set ---------------------------------------------------

    # replacements and joiners start with the injector disarmed: an empty
    # spec also disarms RAY_TPU_FAULTS, so a replacement does not die its
    # predecessor's death
    _REPLACEMENT_OVERRIDES = {"fault_injection": {}}

    def probe_unhealthy_workers(self, timeout_s: Optional[float] = None) -> List[int]:
        """The 1-based indices of the workers that fail a ping, every
        ping under one budget (``worker_health_probe_timeout_s``, 10 s)."""
        if timeout_s is None:
            timeout_s = float(self._config.get("worker_health_probe_timeout_s", 10.0))
        return [i + 1 for i in probe_actors(self._remote_workers, timeout_s=timeout_s)]

    def replace_failed_workers(self, dead: List) -> List:
        """Remove workers seen dead and start as many replacements;
        returns the new handles (weights and filters queued)."""
        if not dead:
            return []
        indices = [self._indices[id(w)] for w in dead]
        self.remove_workers(dead)
        before = len(self._remote_workers)
        self.add_workers(len(dead), config_overrides=self._REPLACEMENT_OVERRIDES, indices=indices)
        telemetry_metrics.inc_worker_restarts(len(dead))
        return self._remote_workers[before:]

    def recreate_failed_workers(self) -> int:
        """Probe the fleet (bounded), replace the unhealthy; returns how
        many were replaced."""
        bad = self.probe_unhealthy_workers()
        if not bad:
            return 0
        self.replace_failed_workers([w for i, w in enumerate(self._remote_workers) if i + 1 in bad])
        return len(bad)

    def scale_up(self, num_workers: int) -> List:
        """Grow the fleet by ``num_workers`` synced joiners (injector
        disarmed: a joiner must not inherit a spec keyed on reused
        indices); returns them."""
        if num_workers <= 0:
            return []
        before = len(self._remote_workers)
        self.add_workers(num_workers, config_overrides=self._REPLACEMENT_OVERRIDES)
        return self._remote_workers[before:]

    def scale_to(self, n: int) -> Dict[str, List]:
        """Exactly ``n`` remote workers: joiners on the way up; on the way
        down the newest leave the set, and the caller (the fleet
        controller) drains and ends them. ``{"added", "removed"}``."""
        n = max(0, int(n))
        cur = len(self._remote_workers)
        if n > cur:
            return {"added": self.scale_up(n - cur), "removed": []}
        victims = self._remote_workers[n:]
        self._remote_workers = self._remote_workers[:n]
        for w in victims:
            self._indices.pop(id(w), None)
        return {"added": [], "removed": victims}

    def absorb_filters(self, remote_filters: Dict) -> None:
        """One drained worker's flushed filter deltas into the local
        worker's filters (``sync_filters``'s sum, for one worker)."""
        local = self._local_worker.filters
        for pid, f in (remote_filters or {}).items():
            if pid in local and isinstance(f, MeanStdFilter):
                local[pid].apply_changes(f, with_buffer=False)

    # -- sync ------------------------------------------------------------

    def sync_weights(
        self,
        policies: Optional[List[str]] = None,
        global_vars: Optional[Dict] = None,
        inference_only: bool = False,
    ) -> None:
        """The learner's weights of ``policies`` (all when None) to every
        remote worker in one ``put`` (``inference_only``: the acting
        subset, ``get_inference_weights``, as the reference ships SAC's
        actor without its critic and target), and ``global_vars`` to
        every worker. A dead worker does not stop the broadcast (a call
        to it fails its own ref)."""
        if self._remote_workers:
            ref = api.put(self._local_worker.get_weights(policies, inference_only=inference_only))
            for w in self._remote_workers:
                w.set_weights.remote(ref, global_vars)
        if global_vars:
            self._local_worker.set_global_vars(global_vars)

    def sync_filters(self) -> None:
        """Add the workers' filter deltas into the local worker's filters
        and send the merged statistics back. A dead or wedged worker
        (no answer within the retry schedule) adds nothing."""
        if not self._remote_workers:
            return
        remote_filters = []
        for w in self._remote_workers:
            try:
                remote_filters.append(self._get_bounded(w.get_filters.remote(True)))
            except (_ACTOR_DEAD_ERRORS + (GetTimeoutError,)):
                continue
        local = self._local_worker.filters
        for rf in remote_filters:
            for pid, f in rf.items():
                if pid in local and isinstance(f, MeanStdFilter):
                    local[pid].apply_changes(f, with_buffer=False)
        ref = api.put({pid: f.as_serializable() for pid, f in local.items()})
        for w in self._remote_workers:
            w.sync_filters.remote(ref)

    # -- mapping ---------------------------------------------------------

    def _get_bounded(self, refs):
        """``get`` under the retry policy: each attempt bounded by its
        timeout, a timeout waits again on the schedule (the calls keep
        running: nothing is sent twice); a death propagates at once."""
        return self._retry.call(
            lambda: api.get(refs, timeout=self._retry.timeout_s), retry_on=(GetTimeoutError,)
        )

    def foreach_worker(self, fn: Callable) -> List:
        """``fn(worker)`` on every worker, local first. ``fn`` goes to the
        remote workers by name, so it is a module-level function."""
        return [fn(self._local_worker)] + self._get_bounded(
            [w.apply.remote(fn) for w in self._remote_workers]
        )

    def foreach_worker_with_index(self, fn: Callable) -> List:
        return [fn(self._local_worker, 0)] + self._get_bounded(
            [w.apply.remote(fn, i + 1) for i, w in enumerate(self._remote_workers)]
        )

    def stop(self) -> None:
        """Stop every worker and end the remote workers' processes."""
        self._local_worker.stop()
        refs = [w.stop.remote() for w in self._remote_workers]
        if refs:
            api.wait(refs, num_returns=len(refs), timeout=STOP_TIMEOUT_S)
        for w in self._remote_workers:
            api.kill(w)
        self._remote_workers = []
        self._indices = {}

