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
- :mod:`~ray_tpu_torch.telemetry.report` — the flight-recorder CLI;
- :mod:`~ray_tpu_torch.telemetry.fleetview` — the fleet view: per-host
  registry snapshots merged into one host-labelled exposition, the
  skew-corrected fleet timeline and barrier attribution
  (:class:`FleetAggregator`); its KV publisher (``HostExporter``) is
  ROADMAP.md item 7;
- :mod:`~ray_tpu_torch.telemetry.fleet_report` — the fleet report CLI.
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

# imported last: fleetview pulls in tracing and the metric catalog above
from ray_tpu_torch.telemetry import fleetview  # noqa: E402,F401
from ray_tpu_torch.telemetry.fleetview import (  # noqa: E402,F401
    FleetAggregator,
    HostExporter,
    registry_snapshot,
)

__all__ = [
    "FleetAggregator",
    "HostExporter",
    "fleetview",
    "registry_snapshot",
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
