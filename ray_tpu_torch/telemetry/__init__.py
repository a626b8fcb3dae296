"""ray_tpu_torch.telemetry — end-to-end run observability for the
training loop; the port's counterpart of ``ray_tpu/telemetry``.

- :func:`init_from_config` / :func:`init` — config-driven activation
  (``AlgorithmConfig.telemetry(metrics_port=..., trace=...)``);
- :mod:`~ray_tpu_torch.telemetry.metrics` — the metric catalog the
  instrumented hot path feeds (names the reference's);
- :func:`iteration_rollup` — per-iteration stage wall-times and the
  rollout/learn **overlap fraction**, computed from spans and reported
  under ``info/telemetry`` in every ``train()`` result;
- :mod:`~ray_tpu_torch.telemetry.device` — the program ledger over the
  CUDA graphs and eager nests, timed by CUDA events, under
  ``info/device_ledger``;
- :mod:`~ray_tpu_torch.telemetry.report` — the flight-recorder CLI.

The reference's fleet view (``FleetAggregator``, ``HostExporter``,
``fleetview``) comes with ROADMAP.md item 6.2.
"""

from ray_tpu_torch.telemetry import device  # noqa: F401
from ray_tpu_torch.telemetry import metrics  # noqa: F401
from ray_tpu_torch.telemetry.rollup import (  # noqa: F401
    STAGE_PREFIXES,
    intersect,
    iteration_rollup,
    merge_intervals,
)
from ray_tpu_torch.telemetry.runtime import (  # noqa: F401
    TelemetryRuntime,
    enabled,
    init,
    init_from_config,
    runtime,
)

__all__ = [
    "TelemetryRuntime",
    "STAGE_PREFIXES",
    "device",
    "enabled",
    "init",
    "init_from_config",
    "intersect",
    "iteration_rollup",
    "merge_intervals",
    "metrics",
    "runtime",
]
