"""No-op stand-ins for the serving plane's and the resilience layer's
telemetry.

The reference's serve, router, ingress and resilience modules report Prometheus
counters, gauges and histograms (``ray_tpu/telemetry/metrics.py``) and
trace spans (``ray_tpu/util/tracing.py``). Their port waits for ROADMAP
queue 1 item 9 (telemetry: metrics, the device ledger, the fleet view).
Until then every call here does nothing, so the port's serving modules
keep the reference's call sites, and item 9 fills them in. Everything
that the ``stats()`` methods of those modules return is measured.
"""

from __future__ import annotations

import contextlib


def _noop(*args, **kwargs) -> None:
    return None


# serve counters and gauges (ray_tpu/telemetry/metrics.py)
set_serve_params_version = _noop
inc_serve_requests = _noop
set_serve_queue_depth = _noop
observe_serve_batch = _noop
set_serve_batch_fill = _noop
observe_serve_latency = _noop
observe_serve_queue_wait = _noop
add_h2d_bytes = _noop
# router
inc_router_expired = _noop
observe_router_batch = _noop
inc_router_rerouted = _noop
# ingress
set_ingress_inflight = _noop
set_ingress_policy_inflight = _noop
inc_ingress_shed = _noop
inc_ingress_request = _noop
observe_ingress_latency = _noop
# resilience: recoveries, skipped batches, the stream, the fleet
inc_recoveries = _noop
inc_skipped_batches = _noop
inc_worker_restarts = _noop
inc_dead_workers = _noop
inc_preemptions = _noop
inc_stream_snapshots = _noop
set_stream_lag = _noop
set_fleet_size = _noop


# trace spans (ray_tpu/util/tracing.py)
def span(*args, **kwargs):
    """``start_span`` and ``context_span``: a span that records nothing."""
    return contextlib.nullcontext()


event = _noop
