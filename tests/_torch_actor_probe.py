"""Functions the actor-lane tests send to remote rollout workers
(``WorkerSet.foreach_worker``). They sit in a module of their own that
imports only the port, so a worker process that resolves them by name
imports no JAX."""

from __future__ import annotations

import os


def policy_weights(worker):
    return worker.policy().get_weights()


def device_report(worker):
    import torch

    return {
        "worker_index": worker.worker_index,
        "policy_device": str(worker.policy().device),
        "cuda_initialized": torch.cuda.is_initialized(),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        "pid": os.getpid(),
    }
