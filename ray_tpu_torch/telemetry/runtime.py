"""Config-driven telemetry activation.

The port's counterpart of ``ray_tpu/telemetry/runtime.py``.
``AlgorithmConfig.telemetry(metrics_port=..., trace=...)`` lands in
``config["telemetry_config"]``; :func:`init_from_config` (called by
``Algorithm.__init__`` before its ``WorkerSet`` exists) turns it into a
live runtime: a
:class:`~ray_tpu_torch.utils.metrics_exporter.MetricsServer` scrape
target, span tracing via :mod:`ray_tpu_torch.util.tracing`, and the
device ledger (:mod:`ray_tpu_torch.telemetry.device`).

One runtime per process: a second Algorithm in the same process
reuses the running server (ports are process-wide); tracing enable is
idempotent. ``RAY_TPU_TRACE=1`` remains the env-var override that
needs no config at all.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

_LOCK = threading.Lock()
_RUNTIME: Optional["TelemetryRuntime"] = None


class TelemetryRuntime:
    """Live telemetry state for this process."""

    def __init__(
        self,
        *,
        metrics_port: Optional[int] = None,
        trace: bool = False,
        metrics_host: str = "127.0.0.1",
        device_ledger: Any = True,
    ):
        self.trace = bool(trace)
        self.metrics_server = None
        self.metrics_port: Optional[int] = None
        if metrics_port is not None:
            from ray_tpu_torch.utils.metrics_exporter import MetricsServer

            self.metrics_server = MetricsServer(
                host=metrics_host, port=int(metrics_port)
            )
            self.metrics_port = self.metrics_server.port
        if self.trace:
            from ray_tpu_torch.util import tracing

            tracing.enable()
        # program ledger (telemetry/device.py): on whenever the runtime
        # is — "light" keeps counters/forensics but skips the FLOP and
        # byte count over each capture's eager first slot; False leaves
        # the launch path untouched
        self.device_ledger = device_ledger
        if device_ledger:
            from ray_tpu_torch.telemetry import device as device_lib

            device_lib.enable(
                analyze=(device_ledger != "light")
            )

    def shutdown(self) -> None:
        global _RUNTIME
        if self.metrics_server is not None:
            self.metrics_server.shutdown()
            self.metrics_server = None
        if self.trace:
            from ray_tpu_torch.util import tracing

            tracing.disable()
        if self.device_ledger:
            from ray_tpu_torch.telemetry import device as device_lib

            device_lib.disable()
        with _LOCK:
            if _RUNTIME is self:
                _RUNTIME = None


def runtime() -> Optional[TelemetryRuntime]:
    """The process's active runtime (None when telemetry is off)."""
    return _RUNTIME


def enabled() -> bool:
    return _RUNTIME is not None


def init(
    *,
    metrics_port: Optional[int] = None,
    trace: bool = False,
    metrics_host: str = "127.0.0.1",
    device_ledger: Any = True,
) -> TelemetryRuntime:
    """Start (or return the already-running) telemetry runtime."""
    global _RUNTIME
    with _LOCK:
        if _RUNTIME is not None:
            # upgrade in place: a later config may add tracing or a
            # scrape port the first runtime didn't ask for (and a
            # tracing.disable() elsewhere must not leave a trace=True
            # runtime silently dark — re-enable unconditionally)
            if trace:
                from ray_tpu_torch.util import tracing

                tracing.enable()
                _RUNTIME.trace = True
            if device_ledger:
                from ray_tpu_torch.telemetry import device as device_lib

                device_lib.enable(
                    analyze=(device_ledger != "light")
                )
                _RUNTIME.device_ledger = device_ledger
            if (
                metrics_port is not None
                and _RUNTIME.metrics_server is None
            ):
                from ray_tpu_torch.utils.metrics_exporter import (
                    MetricsServer,
                )

                _RUNTIME.metrics_server = MetricsServer(
                    host=metrics_host, port=int(metrics_port)
                )
                _RUNTIME.metrics_port = (
                    _RUNTIME.metrics_server.port
                )
            return _RUNTIME
        _RUNTIME = TelemetryRuntime(
            metrics_port=metrics_port,
            trace=trace,
            metrics_host=metrics_host,
            device_ledger=device_ledger,
        )
        return _RUNTIME


def init_from_config(
    config: Dict[str, Any],
) -> Optional[TelemetryRuntime]:
    """Activate telemetry when ``config["telemetry_config"]`` asks for
    it. Returns the runtime, or None when the config leaves telemetry
    off (the default — zero threads, zero spans, null-span hot path)."""
    tc = (config or {}).get("telemetry_config") or {}
    metrics_port = tc.get("metrics_port")
    trace = bool(tc.get("trace", False))
    # device_ledger=True may activate telemetry alone (counters-only
    # runs that want the program ledger without spans or a scrape port)
    ledger_cfg = tc.get("device_ledger")
    if metrics_port is None and not trace and not ledger_cfg:
        return None
    if tc.get("peak_flops"):
        from ray_tpu_torch.telemetry import device as device_lib

        device_lib.set_peak_flops(
            tc.get("peak_flops"), tc.get("peak_hbm_bytes_per_s")
        )
    return init(
        metrics_port=metrics_port,
        trace=trace,
        device_ledger=(
            True if ledger_cfg is None else ledger_cfg
        ),
    )
