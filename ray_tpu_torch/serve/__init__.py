"""The port's serving plane (``ray_tpu/serve``): the serve core
(``serve.py``: deployments of replica actors, handles, the autoscaler,
the per-request HTTP proxy), the batched policy server with its CUDA
graph a bucket (``policy_server.py``) and the long-poll host."""

from ray_tpu_torch.serve.policy_server import (
    BatchedPolicyServer,
    CheckpointWatcher,
    PolicyDeployment,
    policy_deployment,
    restore_policy,
)
from ray_tpu_torch.serve.serve import (
    Deployment,
    DeploymentHandle,
    DeploymentResponse,
    HTTPDeploymentHandle,
    autoscale,
    deployment,
    get_deployment,
    get_deployment_handle,
    get_running,
    membership_feed,
    run,
    shutdown,
    update_deployment,
)

__all__ = [
    "autoscale",
    "deployment",
    "Deployment",
    "DeploymentHandle",
    "DeploymentResponse",
    "HTTPDeploymentHandle",
    "run",
    "get_deployment",
    "get_deployment_handle",
    "update_deployment",
    "shutdown",
    "get_running",
    "membership_feed",
    "BatchedPolicyServer",
    "CheckpointWatcher",
    "PolicyDeployment",
    "policy_deployment",
    "restore_policy",
]
