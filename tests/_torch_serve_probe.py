"""Deployment classes the serve-core tests run in replica actors. They
sit in a module of their own that imports only the port, so a replica
process that resolves them by name imports no JAX."""

from __future__ import annotations

import os


class FakeQueueServer:
    """A deployment whose queue-wait stat is read from a file: synthetic
    load for the queue-wait autoscaler (replica processes share no
    memory with the test)."""

    def __init__(self, wait_file):
        self._wait_file = wait_file

    def __call__(self, x):
        return x

    def stats(self):
        try:
            with open(self._wait_file) as f:
                wait = float(f.read().strip())
        except (OSError, ValueError):
            wait = 0.0
        return {"queue_depth": 0, "queue_wait_p50_s": wait}


class Echo:
    def __call__(self, x):
        return x + 1

    def pid(self):
        return os.getpid()


class Scaler:
    """``user_config`` pushes set the factor, without a restart."""

    def __init__(self):
        self.scale = 1

    def reconfigure(self, config):
        self.scale = config["scale"]

    def __call__(self, x):
        return x * self.scale


class Adder:
    def __call__(self, payload):
        return payload["x"] + 1


class Chain:
    """Calls another deployment through the HTTP proxy from inside its
    replica (the composition handle)."""

    def __call__(self, payload):
        from ray_tpu_torch.serve import serve

        h = serve.get_deployment_handle("adder")
        once = h.remote({"x": payload["x"]}).result()
        twice = h.remote({"x": once}).result()
        return {"twice": twice}


class LedgerModel:
    """Reports the device-ledger fields a policy server's stats carry,
    steered by ``user_config``."""

    def __init__(self):
        self.fill = 0.0
        self.headroom = 1.0

    def reconfigure(self, config):
        self.fill = config["fill"]
        self.headroom = config["headroom"]

    def __call__(self, x):
        return x

    def stats(self):
        return {
            "batch_fill_fraction": self.fill,
            "batches_total": 100,
            "device": {"mfu": None, "hbm_headroom": self.headroom},
        }


class EnvReport:
    """Reports its worker process's environment variables."""

    def env(self, name):
        return os.environ.get(name)
