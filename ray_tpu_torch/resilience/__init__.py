"""Fault tolerance for the training loop and checkpoint discovery.

Counterpart of ``ray_tpu/resilience``: the fault injector
(``faults.py``), the one retry schedule of the control plane
(``retry.py``), the ``RecoveryManager`` that ``Algorithm.train``
consults on a failure (``recovery.py``), the checkpoint streamer, whose
capture copies the state on the card (``streamer.py``), checkpoint
discovery shared by recovery and serving (``discovery.py``) and the
provider preemption notice (``provider_notice.py``). Configure with
``AlgorithmConfig.fault_tolerance(...)``.
"""

from ray_tpu_torch.resilience import faults  # noqa: F401
from ray_tpu_torch.resilience.faults import FaultInjector, InjectedCrash  # noqa: F401
from ray_tpu_torch.resilience.recovery import (  # noqa: F401
    ACTOR_DEAD_ERRORS,
    RecoveryManager,
    batch_is_finite,
)
from ray_tpu_torch.resilience.retry import (  # noqa: F401
    DEFAULT_RETRYABLE,
    RetryPolicy,
    probe_actors,
    ray_get_retrying,
)
from ray_tpu_torch.resilience.streamer import CheckpointStreamer  # noqa: F401

__all__ = [
    "ACTOR_DEAD_ERRORS",
    "CheckpointStreamer",
    "DEFAULT_RETRYABLE",
    "FaultInjector",
    "InjectedCrash",
    "RecoveryManager",
    "RetryPolicy",
    "batch_is_finite",
    "faults",
    "probe_actors",
    "ray_get_retrying",
]
