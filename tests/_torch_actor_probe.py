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


class StandInSampler:
    """A stand-in rollout worker for the request-manager tests (made
    remote there): ``sample()`` returns (wid, call #), or with
    ``payload`` an array of that many bytes, each the call #."""

    def __init__(self, wid, delay=0.0, payload=0):
        self.wid = wid
        self.delay = float(delay)
        self.payload = int(payload)
        self.n = 0

    def sample(self):
        import time

        if self.delay:
            time.sleep(self.delay)
        self.n += 1
        if self.payload:
            import numpy as np

            return np.full(self.payload, self.n, np.uint8)
        return (self.wid, self.n)

    def die(self):
        os._exit(1)
