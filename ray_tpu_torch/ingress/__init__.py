"""The serving front door (``ray_tpu/ingress``), three layers between a
TCP socket and a replica's batched forward:

- :mod:`~ray_tpu_torch.ingress.http`: the asyncio HTTP/ASGI ingress
  (``POST /v1/policy/<name>/actions``, ``/healthz``, ``/metrics``);
- :mod:`~ray_tpu_torch.ingress.router`: cross-replica batch coalescing
  into full power-of-two buckets, with deadlines and dead-replica
  rerouting;
- :mod:`~ray_tpu_torch.ingress.admission`: a bounded in-flight budget,
  per-policy quotas and queue-wait shedding (429/503 + Retry-After);
- :mod:`~ray_tpu_torch.ingress.supervisor`: N ingress processes on one
  port, with crash respawn, forwarded membership, whole-bank drain and
  one merged ``/metrics``.
"""

from ray_tpu_torch.ingress.admission import AdmissionController, AdmissionDecision
from ray_tpu_torch.ingress.http import PolicyIngress
from ray_tpu_torch.ingress.router import (
    ActorReplica,
    CoalescingRouter,
    DeadlineExpired,
    LocalReplica,
    NoReplicasAvailable,
    wrap_replica,
)
from ray_tpu_torch.ingress.supervisor import (
    ForwardedFeed,
    IngressSupervisor,
    WorkerContext,
    reuseport_available,
)

__all__ = [
    "AdmissionController",
    "AdmissionDecision",
    "PolicyIngress",
    "CoalescingRouter",
    "LocalReplica",
    "ActorReplica",
    "DeadlineExpired",
    "NoReplicasAvailable",
    "wrap_replica",
    "ForwardedFeed",
    "IngressSupervisor",
    "WorkerContext",
    "reuseport_available",
]
