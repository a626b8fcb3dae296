"""WorkerSet: the local (learner) worker and N remote rollout actors.

Counterpart of ``ray_tpu/evaluation/worker_set.py``. The remote workers
are ``RolloutWorker`` actors of the port's runtime (``core/``), each in
a process of its own with its policy on the CPU. ``sync_weights`` takes
the learner's weights once as numpy, makes one ``put`` (a shared-memory
segment above 256 KB) and sends every worker that ref; a worker's calls
run in submission order, so the new weights are in place before its
next ``sample``.

``remove_workers`` drops workers that an ``AsyncRequestsManager`` saw
die and ends their processes. Not ported (``ROADMAP.md`` queue 1 item
3): adding and recreating workers (the elastic set;
``replace_failed_workers`` raises), ``RetryPolicy`` and
``probe_unhealthy_workers``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from ray_tpu_torch.core import api
from ray_tpu_torch.evaluation.rollout_worker import RolloutWorker
from ray_tpu_torch.utils.filter import MeanStdFilter

STOP_TIMEOUT_S = 10.0
_ITEM = "ROADMAP.md queue 1 item 3"


class WorkerSet:
    def __init__(
        self,
        *,
        env_creator,
        policy_cls,
        config: Dict,
        num_workers: int = 0,
        device=None,
    ):
        self._remote_workers: List = []
        self._local_worker = RolloutWorker(
            env_creator=env_creator, policy_cls=policy_cls, config=config,
            worker_index=0, num_workers=num_workers, device=device,
        )
        if num_workers > 0:
            if not api.is_initialized():
                api.init()
            remote_worker = api.remote(RolloutWorker)
            for i in range(num_workers):
                self._remote_workers.append(
                    remote_worker.remote(
                        env_creator=env_creator, policy_cls=policy_cls, config=config,
                        worker_index=i + 1, num_workers=num_workers,
                    )
                )

    def local_worker(self) -> RolloutWorker:
        return self._local_worker

    def remote_workers(self) -> List:
        return self._remote_workers

    def num_remote_workers(self) -> int:
        return len(self._remote_workers)

    def remove_workers(self, workers: List) -> None:
        """Drop these worker handles (seen dead by the caller) and end
        their processes."""
        drop = {id(w) for w in workers}
        for w in self._remote_workers:
            if id(w) in drop:
                api.kill(w)
        self._remote_workers = [w for w in self._remote_workers if id(w) not in drop]

    def replace_failed_workers(self, dead: List) -> List:
        raise NotImplementedError(f"recreating workers (the elastic worker set) is not ported yet: {_ITEM}")

    # -- sync ------------------------------------------------------------

    def sync_weights(self, global_vars: Optional[Dict] = None, inference_only: bool = False) -> None:
        """The learner's weights to every remote worker (``inference_only``:
        the acting subset, ``get_inference_weights``, as the reference
        ships SAC's actor without its critic and target), and
        ``global_vars`` to every worker."""
        if self._remote_workers:
            ref = api.put(self._local_worker.get_weights(inference_only=inference_only))
            for w in self._remote_workers:
                w.set_weights.remote(ref, global_vars)
        if global_vars:
            self._local_worker.set_global_vars(global_vars)

    def sync_filters(self) -> None:
        """Add the workers' filter deltas into the local worker's filters
        and send the merged statistics back."""
        if not self._remote_workers:
            return
        remote_filters = api.get([w.get_filters.remote(True) for w in self._remote_workers])
        local = self._local_worker.filters
        for rf in remote_filters:
            for pid, f in rf.items():
                if pid in local and isinstance(f, MeanStdFilter):
                    local[pid].apply_changes(f, with_buffer=False)
        ref = api.put({pid: f.as_serializable() for pid, f in local.items()})
        for w in self._remote_workers:
            w.sync_filters.remote(ref)

    # -- mapping ---------------------------------------------------------

    def foreach_worker(self, fn: Callable) -> List:
        """``fn(worker)`` on every worker, local first. ``fn`` goes to the
        remote workers by name, so it is a module-level function."""
        return [fn(self._local_worker)] + api.get(
            [w.apply.remote(fn) for w in self._remote_workers]
        )

    def foreach_worker_with_index(self, fn: Callable) -> List:
        return [fn(self._local_worker, 0)] + api.get(
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
