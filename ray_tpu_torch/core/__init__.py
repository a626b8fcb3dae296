"""The port's actor runtime (``core/api.py``): the processes that the
actor lane's rollout workers run in."""

from ray_tpu_torch.core.api import (
    ActorHandle,
    get,
    init,
    is_initialized,
    kill,
    put,
    remote,
    shutdown,
    wait,
)
from ray_tpu_torch.core.object_store import (
    GetTimeoutError,
    ObjectRef,
    RayActorError,
    RayTaskError,
    WorkerCrashedError,
)

__all__ = [
    "ActorHandle", "GetTimeoutError", "ObjectRef", "RayActorError", "RayTaskError",
    "WorkerCrashedError", "get", "init", "is_initialized", "kill", "put", "remote",
    "shutdown", "wait",
]
