"""Rollout collection: ``synchronous_parallel_sample``.

Counterpart of ``ray_tpu/execution/rollout_ops.py:32-110``, with the
same round semantics: one ``sample`` request per worker per round, the
round's batches ordered by worker index, rounds until the step target is
met; a dead worker raises ``RayActorError`` after the healthy workers'
results are in. The round waits with ``wait``/``get`` directly instead
of the reference's ``AsyncRequestsManager``, whose docstring states
that both give bit-identical results. ``SamplePrefetcher`` waits for the
prefetch slice (``ROADMAP.md`` queue 1 item 3).
"""

from __future__ import annotations

from typing import List, Optional

from ray_tpu_torch.core import api
from ray_tpu_torch.core.object_store import RayActorError, WorkerCrashedError
from ray_tpu_torch.data.sample_batch import concat_samples


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
        steps += sum(b.count for b in batches)
        all_batches.extend(batches)
        if max_steps is None or steps >= max_steps:
            break
    return concat_samples(all_batches) if concat else all_batches
