"""Run-telemetry metric catalog: the aggregate series the training
loop exports.

The port's counterpart of ``ray_tpu/telemetry/metrics.py``. The metric
names are the reference's, so one dashboard reads either package's
scrape; every series is a process-local
:mod:`ray_tpu_torch.utils.metrics` instrument, scraped through the
``MetricsServer`` the telemetry runtime starts. All accessors are
get-or-create and therefore safe to call from hot paths.

Names kept for comparability, and what they count in the port:

- ``ray_tpu_compile_traces_total`` / ``..._recompiles_total`` /
  ``ray_tpu_compile_time_seconds_total``: CUDA-graph captures (the
  port's compile), captures of a program label beyond its first, and
  the seconds the captures took, eager first slot included
  (``telemetry/device.capture_stats``);
- ``ray_tpu_jax_live_buffers``: live CUDA allocations
  (``torch.cuda.memory_stats()["active.all.current"]`` of the current
  device; absent on the CPU, where torch tracks none);
- ``ray_tpu_jax_device_memory_bytes{device}``: bytes allocated by
  tensors on each CUDA device (``allocated_bytes.all.current``);
- ``ray_tpu_program_*``: the device ledger's programs, whose execution
  times are CUDA-event times (``telemetry/device.py``).

Left out, with the parts that feed them (ROADMAP.md): the learner
fleet and KV series (item 7; the fleet view's clock offset with its
``HostExporter``), the AOT cache events (item 6.3), the flood harness's
gauges (item 1, the port's benchmark).
"""

from __future__ import annotations

from typing import Dict, Optional

from ray_tpu_torch.utils.metrics import (
    Counter,
    Gauge,
    Histogram,
    get_metric,
    timer_histogram,
)

# -- metric names (one place, so docs/tests/dashboards can't drift) ----

ENV_STEPS_PER_S = "ray_tpu_env_steps_per_s"
LEARN_STEPS_PER_S = "ray_tpu_learn_steps_per_s"
ENV_STEPS_TOTAL = "ray_tpu_env_steps_sampled_total"
LEARN_STEPS_TOTAL = "ray_tpu_learn_steps_total"
QUEUE_DEPTH = "ray_tpu_queue_depth"
REQUESTS_IN_FLIGHT = "ray_tpu_requests_in_flight"
DEAD_WORKERS_TOTAL = "ray_tpu_dead_workers_total"
ROLLOUT_WORKERS = "ray_tpu_rollout_workers"
COMPILE_TRACES = "ray_tpu_compile_traces_total"
COMPILE_RECOMPILES = "ray_tpu_compile_recompiles_total"
COMPILE_TIME_S = "ray_tpu_compile_time_seconds_total"
JAX_LIVE_BUFFERS = "ray_tpu_jax_live_buffers"
JAX_DEVICE_MEMORY = "ray_tpu_jax_device_memory_bytes"
OVERLAP_FRACTION = "ray_tpu_iteration_overlap_fraction"
ITERATION_SECONDS = "ray_tpu_iteration_seconds"
# resilience layer (docs/resilience.md)
WORKER_RESTARTS_TOTAL = "ray_tpu_worker_restarts_total"
RECOVERIES_TOTAL = "ray_tpu_recoveries_total"
SKIPPED_BATCHES_TOTAL = "ray_tpu_skipped_batches_total"
# elastic fleets & preemption (docs/resilience.md): rollout-fleet size
# by lifecycle state, preemptions by outcome (drained = graceful exit
# inside the notice window; a lost preemption fell through to the
# ordinary kill path), and the continuous checkpoint stream's
# snapshot count + how many supersteps the written tail lags the run
FLEET_SIZE = "ray_tpu_fleet_size"
# fleet view (telemetry/fleetview.py): per-host barrier wall at each
# epoch-scoped barrier (seconds a host's arrival led the LAST
# arriver's, skew-corrected), straggler attribution (times a host WAS
# the last arriver), and how many hosts the aggregator holds live
# snapshots for
FLEET_BARRIER_WAIT_SECONDS = "ray_tpu_fleet_barrier_wait_seconds"
FLEET_STRAGGLER_TOTAL = "ray_tpu_fleet_straggler_total"
FLEET_HOSTS_REPORTING = "ray_tpu_fleet_hosts_reporting"
PREEMPTIONS_TOTAL = "ray_tpu_preemptions_total"
CKPT_STREAM_SNAPSHOTS_TOTAL = (
    "ray_tpu_checkpoint_stream_snapshots_total"
)
CKPT_STREAM_LAG = "ray_tpu_checkpoint_stream_lag_supersteps"
# device-resident data plane (docs/data_plane.md): host→device bytes
# by path — feeder (pipelined transfer), learn (sync learn_on_batch /
# stacked-chain transfer), replay_insert (each transition's ONE
# crossing into a device-resident replay buffer)
H2D_BYTES_TOTAL = "ray_tpu_h2d_bytes_total"
# superstep learner contract (docs/data_plane.md): updates executed
# inside fused K-updates-per-dispatch programs
SUPERSTEP_UPDATES_TOTAL = "ray_tpu_superstep_updates_total"
# prioritized-replay segment-tree operations by op and by which tree
# implementation performed them (docs/data_plane.md "device sum
# tree"): host = the numpy SumSegmentTree walk, device = the
# mesh-resident f64 tree programs. A healthy device-tree run shows
# its sample/update ops under tree="device" and zero under "host".
REPLAY_TREE_OPS_TOTAL = "ray_tpu_replay_tree_ops_total"
# device→host payload bytes by path — the mirror of the H2D counter
# for the readbacks the data plane still performs (today:
# "replay_priorities", the stacked |td| pull that feeds the host
# alpha-power before a device-tree priority refresh)
D2H_BYTES_TOTAL = "ray_tpu_d2h_bytes_total"
# device rollout lane (docs/pipeline.md): env steps taken INSIDE
# device-resident rollout programs (the tensor-env lane) — compare against
# ray_tpu_env_steps_sampled_total for the on-device fraction
ENV_STEPS_ON_DEVICE_TOTAL = "ray_tpu_env_steps_on_device_total"
REPLAY_ROWS = "ray_tpu_replay_buffer_rows"
REPLAY_CAPACITY = "ray_tpu_replay_buffer_capacity"
REPLAY_BYTES = "ray_tpu_replay_buffer_bytes"
# param placement (docs/sharding.md "2-D mesh & param partitioning"):
# policy parameter bytes, global vs per-device — at M-way model
# parallelism per_shard sits near global/M; and the count of batch
# leaves whose ragged leading dim forced the replication fallback
# (specs.leaf_sharding) — a nonzero rate means a hot path ships
# full-copy columns it meant to row-shard
PARAMS_BYTES = "ray_tpu_params_bytes"
SHARDING_FALLBACK_TOTAL = (
    "ray_tpu_sharding_fallback_replicated_total"
)
# inference plane (docs/serving.md): the continuous-batching policy
# server's queue depth, coalesced forward batch sizes, request count,
# end-to-end request latency (p50/p99 read off the histogram or the
# server's exact stats()), and the params version the replica serves
# (bumps on checkpoint hot-reload)
SERVE_QUEUE_DEPTH = "ray_tpu_serve_queue_depth"
SERVE_BATCH_SIZE = "ray_tpu_serve_batch_size"
SERVE_REQUESTS_TOTAL = "ray_tpu_serve_requests_total"
SERVE_LATENCY_SECONDS = "ray_tpu_serve_latency_seconds"
SERVE_PARAMS_VERSION = "ray_tpu_serve_params_version"
# serve-plane batch observability (docs/serving.md): occupancy of the
# executed bucket (1.0 = every padded row was real work) and how long
# a request waited in the queue before its batch launched
SERVE_BATCH_FILL_FRACTION = "ray_tpu_serve_batch_fill_fraction"
SERVE_QUEUE_WAIT_SECONDS = "ray_tpu_serve_queue_wait_seconds"
# ingress front door (docs/serving.md "the front door",
# ray_tpu/ingress/): per-route request counts by HTTP status, admitted
# requests currently in flight, sheds by reason (inflight budget /
# queue-wait / expired deadline), and end-to-end ingress latency
INGRESS_REQUESTS_TOTAL = "ray_tpu_ingress_requests_total"
INGRESS_INFLIGHT = "ray_tpu_ingress_inflight"
INGRESS_SHED_TOTAL = "ray_tpu_ingress_shed_total"
INGRESS_LATENCY_SECONDS = "ray_tpu_ingress_latency_seconds"
# admitted in-flight per policy (the per-tenant quota's observable)
INGRESS_POLICY_INFLIGHT = "ray_tpu_ingress_policy_inflight"
# multi-process front door (ingress/supervisor.py): worker processes in
# the bank by state, and workers respawned after a crash
INGRESS_WORKERS = "ray_tpu_ingress_workers"
INGRESS_WORKER_RESPAWNS_TOTAL = (
    "ray_tpu_ingress_worker_respawns_total"
)
# cross-replica coalescing router (ingress/router.py): dispatched
# buckets, rows merged into them, requests dropped at their deadline
# BEFORE dispatch, and batches re-routed off a dead replica
ROUTER_BATCHES_TOTAL = "ray_tpu_router_batches_total"
ROUTER_MERGED_ROWS_TOTAL = "ray_tpu_router_merged_rows_total"
ROUTER_EXPIRED_TOTAL = "ray_tpu_router_expired_total"
ROUTER_REROUTED_TOTAL = "ray_tpu_router_rerouted_total"
# device-plane program ledger (docs/observability.md "device ledger",
# telemetry/device.py): per compiled program — steady-state execution
# count, cumulative device-busy seconds closed at the drain points,
# and the program's per-execution FLOPs from cost_analysis()
PROGRAM_EXECUTIONS_TOTAL = "ray_tpu_program_executions_total"
PROGRAM_DEVICE_SECONDS_TOTAL = "ray_tpu_program_device_seconds_total"
PROGRAM_FLOPS = "ray_tpu_program_flops"


def gauge(
    name: str, description: str = "", tag_keys=()
) -> Gauge:
    """Get-or-create a Gauge (idempotent, like timer_histogram)."""
    m = get_metric(name)
    if isinstance(m, Gauge):
        return m
    return Gauge(name, description, tag_keys=tag_keys)


def counter(
    name: str, description: str = "", tag_keys=()
) -> Counter:
    m = get_metric(name)
    if isinstance(m, Counter):
        return m
    return Counter(name, description, tag_keys=tag_keys)


def histogram(name: str, description: str = "") -> Histogram:
    return timer_histogram(name, description)


# -- pipeline gauges (called from the execution layer) -----------------


def set_queue_depth(queue_name: str, depth: int) -> None:
    """Depth of one bounded pipeline queue (feeder in/out, learner
    in/out, prefetch) — the saturation signal of docs/pipeline.md."""
    gauge(
        QUEUE_DEPTH,
        "bounded pipeline queue depth",
        ("queue",),
    ).set(float(depth), {"queue": queue_name})


def set_requests_in_flight(manager: str, n: int) -> None:
    gauge(
        REQUESTS_IN_FLIGHT,
        "outstanding sample requests per AsyncRequestsManager",
        ("manager",),
    ).set(float(n), {"manager": manager})


def inc_dead_workers(manager: str, n: int = 1) -> None:
    counter(
        DEAD_WORKERS_TOTAL,
        "rollout workers observed dead",
        ("manager",),
    ).inc(float(n), {"manager": manager})


def inc_worker_restarts(n: int = 1) -> None:
    """Rollout workers recreated after observed death (fed by
    WorkerSet.replace_failed_workers / recreate_failed_workers)."""
    counter(
        WORKER_RESTARTS_TOTAL,
        "rollout workers recreated after failure",
    ).inc(float(n))


def inc_recoveries(kind: str, n: int = 1) -> None:
    """Recovery actions taken by the RecoveryManager, by kind
    (``workers`` = fleet probe+recreate, ``restore`` =
    checkpoint auto-restore)."""
    counter(
        RECOVERIES_TOTAL,
        "training-loop recovery actions",
        ("kind",),
    ).inc(float(n), {"kind": kind})


def inc_skipped_batches(n: int = 1) -> None:
    """Learn batches skipped by the non-finite guard (nan_guard)."""
    counter(
        SKIPPED_BATCHES_TOTAL,
        "learn batches skipped by the non-finite guard",
    ).inc(float(n))


def set_fleet_size(
    active: int, draining: int = 0, joining: int = 0
) -> None:
    """Rollout-fleet size by lifecycle state (set by the
    FleetController on every transition; docs/resilience.md fleet
    state machine)."""
    g = gauge(
        FLEET_SIZE,
        "rollout workers by fleet lifecycle state",
        ("state",),
    )
    g.set(float(active), {"state": "active"})
    g.set(float(draining), {"state": "draining"})
    g.set(float(joining), {"state": "joining"})


def inc_preemptions(drained: bool, n: int = 1) -> None:
    """Worker preemptions observed, split by outcome: ``drained`` =
    the eviction notice was honored (graceful exit, zero recovery
    budget); otherwise the preemption fell through to the ordinary
    kill/recovery path."""
    counter(
        PREEMPTIONS_TOTAL,
        "worker preemptions by drain outcome",
        ("drained",),
    ).inc(float(n), {"drained": "true" if drained else "false"})






























def inc_stream_snapshots(n: int = 1) -> None:
    """Snapshots written by the continuous CheckpointStreamer."""
    counter(
        CKPT_STREAM_SNAPSHOTS_TOTAL,
        "continuous checkpoint stream snapshots written",
    ).inc(float(n))


def set_stream_lag(supersteps: int) -> None:
    """How many supersteps the written stream tail lags the live run
    (the work-lost bound on a driver crash)."""
    gauge(
        CKPT_STREAM_LAG,
        "supersteps between the run head and the written stream tail",
    ).set(float(supersteps))


def inc_superstep_updates(n: int = 1) -> None:
    """Learner updates executed inside fused superstep programs (K
    updates per dispatch — docs/data_plane.md). Compare against
    ``ray_tpu_learn_steps_total`` for the fused fraction."""
    counter(
        SUPERSTEP_UPDATES_TOTAL,
        "learner updates run inside fused superstep dispatches",
    ).inc(float(n))


def inc_env_steps_on_device(n: int) -> None:
    """Env steps executed inside a device rollout program (the device
    lane's tensor env — zero rollout bytes over H2D)."""
    counter(
        ENV_STEPS_ON_DEVICE_TOTAL,
        "env steps taken inside mesh-resident rollout programs",
    ).inc(float(n))


def add_h2d_bytes(path: str, n: int) -> None:
    """Host→device payload bytes about to cross the wire on ``path``
    (``feeder`` | ``learn`` | ``replay_insert`` | ``rollout`` — the
    device rollout lane's key stacks, its entire payload). The byte
    diet of
    docs/data_plane.md is read off this counter: a device-resident
    replay run moves each transition once (``replay_insert``) instead
    of once per learn step (``learn``)."""
    if n <= 0:
        return
    counter(
        H2D_BYTES_TOTAL,
        "host to device payload bytes by transfer path",
        ("path",),
    ).inc(float(n), {"path": path})


def inc_tree_op(op: str, tree: str, n: int = 1) -> None:
    """One segment-tree operation on the prioritized-replay path:
    ``op`` ∈ insert | update | sample, ``tree`` ∈ host | device
    (which implementation walked the tree)."""
    counter(
        REPLAY_TREE_OPS_TOTAL,
        "prioritized-replay segment-tree ops by op and tree plane",
        ("op", "tree"),
    ).inc(float(n), {"op": op, "tree": tree})


def add_d2h_bytes(path: str, n: int) -> None:
    """Device→host payload bytes about to cross on ``path``
    (``replay_priorities``: the stacked |td| pull for the host
    alpha-power — docs/data_plane.md documents why that transform
    stays host-side)."""
    if n <= 0:
        return
    counter(
        D2H_BYTES_TOTAL,
        "device to host payload bytes by transfer path",
        ("path",),
    ).inc(float(n), {"path": path})


def d2h_bytes_by_path() -> Dict[str, float]:
    """Per-path totals of the D2H byte counter ({} before any
    readback) — same shape as :func:`h2d_bytes_by_path`."""
    m = get_metric(D2H_BYTES_TOTAL)
    if m is None:
        return {}
    out: Dict[str, float] = {}
    for tags, v in m.series():
        path = dict(tags).get("path", "")
        out[path] = out.get(path, 0.0) + v
    return out


def set_replay_occupancy(
    policy_id: str, rows: int, capacity: int, nbytes: int,
    device: bool,
) -> None:
    """Occupancy of one replay buffer (device-resident or the host
    spill fallback): stored rows, row capacity, and resident storage
    bytes (for device buffers this is HBM/accelerator memory)."""
    tags = {
        "policy": policy_id,
        "storage": "device" if device else "host",
    }
    gauge(
        REPLAY_ROWS, "replay buffer stored rows", ("policy", "storage")
    ).set(float(rows), tags)
    gauge(
        REPLAY_CAPACITY,
        "replay buffer row capacity",
        ("policy", "storage"),
    ).set(float(capacity), tags)
    gauge(
        REPLAY_BYTES,
        "replay buffer resident storage bytes",
        ("policy", "storage"),
    ).set(float(nbytes), tags)


def set_params_bytes(
    policy: str, global_bytes: int, per_shard_bytes: int
) -> None:
    """Parameter memory of one policy, next to the replay/live-buffer
    gauges: ``global`` = the full tree, ``per_shard`` = what one
    device actually holds under the active placement (equal when
    replicated; ~global/M at M-way model parallelism)."""
    g = gauge(
        PARAMS_BYTES,
        "policy parameter bytes by placement",
        ("policy", "placement"),
    )
    g.set(float(global_bytes), {"policy": policy, "placement": "global"})
    g.set(
        float(per_shard_bytes),
        {"policy": policy, "placement": "per_shard"},
    )


def inc_sharding_fallback(n: int = 1) -> None:
    """Batch leaves replicated by the ragged-leading-dim fallback in
    ``sharding.specs.leaf_sharding`` (should be 0 on a healthy hot
    path)."""
    counter(
        SHARDING_FALLBACK_TOTAL,
        "batch leaves replicated by the ragged-leading-dim fallback",
    ).inc(float(n))


def set_serve_queue_depth(deployment: str, depth: int) -> None:
    """Requests waiting in one policy server's batch queue — the
    serve-plane saturation signal the queue-wait autoscaler keys off
    (docs/serving.md)."""
    gauge(
        SERVE_QUEUE_DEPTH,
        "policy-server requests waiting to be batched",
        ("deployment",),
    ).set(float(depth), {"deployment": deployment})


def observe_serve_batch(deployment: str, rows: int) -> None:
    """Size of one coalesced forward batch (pre-padding): the
    continuous-batching efficiency signal — a p50 near 1 under load
    means the batcher is flushing too eagerly."""
    m = get_metric(SERVE_BATCH_SIZE)
    if not isinstance(m, Histogram):
        m = Histogram(
            SERVE_BATCH_SIZE,
            "coalesced policy-server forward batch rows",
            boundaries=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0),
            tag_keys=("deployment",),
        )
    m.observe(float(rows), {"deployment": deployment})


def inc_serve_requests(deployment: str, n: int = 1) -> None:
    counter(
        SERVE_REQUESTS_TOTAL,
        "policy-server requests accepted",
        ("deployment",),
    ).inc(float(n), {"deployment": deployment})


def observe_serve_latency(deployment: str, seconds: float) -> None:
    """End-to-end request latency (submit → result ready): queue wait
    + batch assembly + the sharded forward + scatter."""
    m = get_metric(SERVE_LATENCY_SECONDS)
    if not isinstance(m, Histogram):
        m = Histogram(
            SERVE_LATENCY_SECONDS,
            "policy-server request latency seconds",
            tag_keys=("deployment",),
        )
    m.observe(float(seconds), {"deployment": deployment})


def set_serve_batch_fill(deployment: str, fill: float) -> None:
    """Occupancy of the bucket the last forward executed: real rows /
    bucket rows (post-padding). A sustained low fill means the batcher
    flushes under-full buckets — wasted device work per request."""
    gauge(
        SERVE_BATCH_FILL_FRACTION,
        "real rows / executed bucket rows of the last serve batch",
        ("deployment",),
    ).set(float(fill), {"deployment": deployment})


def observe_serve_queue_wait(deployment: str, seconds: float) -> None:
    """Time one request sat in the batch queue before its forward
    launched — the queue-wait component of the end-to-end latency
    histogram (and the autoscaler's saturation signal, exact
    percentiles in the server's stats())."""
    m = get_metric(SERVE_QUEUE_WAIT_SECONDS)
    if not isinstance(m, Histogram):
        m = Histogram(
            SERVE_QUEUE_WAIT_SECONDS,
            "policy-server request queue-wait seconds",
            tag_keys=("deployment",),
        )
    m.observe(float(seconds), {"deployment": deployment})


def inc_ingress_request(route: str, status: int) -> None:
    """One HTTP request answered by the ingress front door, by route
    and final status code (2xx served, 429/503 shed, 504 expired)."""
    counter(
        INGRESS_REQUESTS_TOTAL,
        "ingress HTTP requests by route and status",
        ("route", "status"),
    ).inc(1.0, {"route": route, "status": str(status)})


def set_ingress_inflight(n: int) -> None:
    """Requests admitted past the front door and not yet answered —
    the admission controller's bounded budget."""
    gauge(
        INGRESS_INFLIGHT,
        "admitted ingress requests currently in flight",
    ).set(float(n))


def inc_ingress_shed(reason: str, n: int = 1) -> None:
    """One request shed at the ingress: ``inflight`` (budget
    exhausted → 429), ``quota`` (the POLICY's in-flight share
    exhausted → 429), ``queue_wait`` (replica waits over target →
    503), or ``deadline`` (already expired on arrival → 504)."""
    counter(
        INGRESS_SHED_TOTAL,
        "requests shed by the admission controller, by reason",
        ("reason",),
    ).inc(float(n), {"reason": reason})


def observe_ingress_latency(route: str, seconds: float) -> None:
    """End-to-end ingress latency: socket accept to response write —
    the number a client actually experiences (queue wait + coalesce +
    forward + serialization)."""
    m = get_metric(INGRESS_LATENCY_SECONDS)
    if not isinstance(m, Histogram):
        m = Histogram(
            INGRESS_LATENCY_SECONDS,
            "end-to-end ingress request latency seconds",
            tag_keys=("route",),
        )
    m.observe(float(seconds), {"route": route})






def set_ingress_workers(state: str, n: int) -> None:
    """Worker-process census of the multi-process front door bank
    (ingress/supervisor.py): ``state="live"`` is the processes
    currently accepting on the shared port; ``state="target"`` the
    configured bank size."""
    gauge(
        INGRESS_WORKERS,
        "ingress worker processes by state",
        ("state",),
    ).set(float(n), {"state": state})


def inc_ingress_worker_respawns(n: int = 1) -> None:
    """One crashed ingress worker the supervisor replaced (the bank
    keeps accepting on the shared port throughout)."""
    counter(
        INGRESS_WORKER_RESPAWNS_TOTAL,
        "ingress worker processes respawned after a crash",
    ).inc(float(n))


def set_barrier_wait(host: str, epoch: int, seconds: float) -> None:
    """How long ``host``'s arrival at the latest barrier or drain point
    led the LAST arriver's (0 for the straggler itself), skew-corrected
    by the fleet aggregator (telemetry/fleetview.py)."""
    gauge(
        FLEET_BARRIER_WAIT_SECONDS,
        "seconds a host waited on the barrier's last arriver",
        ("host", "epoch"),
    ).set(float(seconds), {"host": host, "epoch": str(epoch)})


def inc_straggler(host: str, n: int = 1) -> None:
    """One barrier where ``host`` was the LAST arriver (the fleet's
    measured straggler)."""
    counter(
        FLEET_STRAGGLER_TOTAL,
        "barriers where this host arrived last",
        ("host",),
    ).inc(float(n), {"host": host})


def set_hosts_reporting(n: int) -> None:
    """Hosts the fleet aggregator currently holds a live (non-aged)
    snapshot for."""
    gauge(
        FLEET_HOSTS_REPORTING,
        "hosts with a live snapshot at the fleet aggregator",
    ).set(float(n))


def set_ingress_policy_inflight(policy: str, n: int) -> None:
    """Admitted in-flight requests of ONE policy — the observable the
    per-tenant quota bounds (shed reason ``quota`` fires when a
    policy's next request would exceed its share)."""
    gauge(
        INGRESS_POLICY_INFLIGHT,
        "admitted in-flight ingress requests per policy",
        ("policy",),
    ).set(float(n), {"policy": policy})








def observe_router_batch(deployment: str, rows: int) -> None:
    """One coalesced bucket the router dispatched to a replica, with
    the rows merged into it (cross-request, cross-connection)."""
    counter(
        ROUTER_BATCHES_TOTAL,
        "coalesced buckets dispatched by the router",
        ("deployment",),
    ).inc(1.0, {"deployment": deployment})
    counter(
        ROUTER_MERGED_ROWS_TOTAL,
        "rows merged into dispatched router buckets",
        ("deployment",),
    ).inc(float(rows), {"deployment": deployment})


def inc_router_expired(deployment: str, n: int = 1) -> None:
    """Requests the router dropped at their deadline BEFORE dispatch
    (no dead device work was computed for them)."""
    counter(
        ROUTER_EXPIRED_TOTAL,
        "requests dropped at their deadline before dispatch",
        ("deployment",),
    ).inc(float(n), {"deployment": deployment})


def inc_router_rerouted(deployment: str, n: int = 1) -> None:
    """Requests re-queued off a replica that died mid-dispatch and
    routed to a surviving one."""
    counter(
        ROUTER_REROUTED_TOTAL,
        "requests rerouted off dead replicas",
        ("deployment",),
    ).inc(float(n), {"deployment": deployment})




def inc_program_execution(program: str, n: int = 1) -> None:
    """One steady-state execution of a compiled device program
    (traced/compile calls excluded — telemetry/device.py)."""
    counter(
        PROGRAM_EXECUTIONS_TOTAL,
        "compiled-program executions by program label",
        ("program",),
    ).inc(float(n), {"program": program})


def add_program_device_seconds(program: str, seconds: float) -> None:
    """Device-busy wall seconds accrued by one program's execution
    interval (dispatch start → drain point)."""
    if seconds <= 0:
        return
    counter(
        PROGRAM_DEVICE_SECONDS_TOTAL,
        "cumulative device-busy seconds by program label",
        ("program",),
    ).inc(float(seconds), {"program": program})


def set_program_flops(program: str, flops: float) -> None:
    """Per-execution FLOPs of a program (in the port: counted over its
    eager first slot by ``telemetry/device.py``, once per capture)."""
    gauge(
        PROGRAM_FLOPS,
        "per-execution FLOPs of a compiled program (cost_analysis)",
        ("program",),
    ).set(float(flops), {"program": program})


def set_serve_params_version(deployment: str, version: int) -> None:
    """Monotonic params version a policy server is serving; bumps
    exactly once per applied checkpoint hot-reload."""
    gauge(
        SERVE_PARAMS_VERSION,
        "params version served (bumps on checkpoint hot-reload)",
        ("deployment",),
    ).set(float(version), {"deployment": deployment})


def h2d_bytes_by_path() -> Dict[str, float]:
    """Current per-path totals of the H2D byte counter ({} before any
    transfer). Algorithm.train diffs this across an iteration for the
    ``info/telemetry`` byte roll-up."""
    m = get_metric(H2D_BYTES_TOTAL)
    if m is None:
        return {}
    out: Dict[str, float] = {}
    for tags, v in m.series():
        path = dict(tags).get("path", "")
        out[path] = out.get(path, 0.0) + v
    return out


def counter_total(name: str) -> float:
    """Sum of a counter's series across all tag values (0.0 when the
    counter was never touched)."""
    m = get_metric(name)
    if m is None:
        return 0.0
    return sum(v for _, v in m.series())


def learn_steps_total() -> float:
    """Cumulative SGD programs dispatched in this process (fed by
    TorchPolicy's learn calls); Algorithm.train diffs it across an
    iteration for the learn-steps/s gauge."""
    m = get_metric(LEARN_STEPS_TOTAL)
    if m is None:
        return 0.0
    return sum(v for _, v in m.series())


# -- per-iteration runtime sampling (called by Algorithm.train) --------


def sample_runtime_gauges() -> Dict[str, Optional[float]]:
    """Refresh the process-level gauges that must be polled: the CUDA
    graph captures (the port's compiles) and the CUDA caching
    allocator's live allocations and bytes per device. Returns the
    sampled values (reported under ``info/telemetry`` too);
    ``jax_live_buffers`` is None on a host without CUDA, where torch
    counts no live tensors. Reads allocator counters only: no sync."""
    import torch

    from ray_tpu_torch.telemetry import device as device_lib

    cs = device_lib.capture_stats()
    gauge(COMPILE_TRACES, "CUDA graph captures (process-wide)").set(
        float(cs["traces"])
    )
    gauge(
        COMPILE_RECOMPILES, "CUDA graph captures beyond a label's first"
    ).set(float(cs["recompiles"]))
    gauge(
        COMPILE_TIME_S, "cumulative CUDA graph capture seconds"
    ).set(float(cs["compile_time_s"]))
    out: Dict[str, Optional[float]] = {
        "compile_traces": float(cs["traces"]),
        "compile_recompiles": float(cs["recompiles"]),
        "compile_time_s": float(cs["compile_time_s"]),
        "jax_live_buffers": None,
    }
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return out
    stats = torch.cuda.memory_stats()
    n_live = float(stats.get("active.all.current", 0))
    gauge(
        JAX_LIVE_BUFFERS, "live CUDA allocations in this process"
    ).set(n_live)
    out["jax_live_buffers"] = n_live
    g = gauge(
        JAX_DEVICE_MEMORY,
        "bytes in use on the learner devices",
        ("device",),
    )
    total = 0.0
    for i in range(torch.cuda.device_count()):
        b = float(
            torch.cuda.memory_stats(i).get("allocated_bytes.all.current", 0)
        )
        g.set(b, {"device": str(i)})
        total += b
    out["device_memory_bytes"] = total
    return out




def record_iteration_throughput(
    env_steps: float, learn_steps: float, wall_s: float
) -> Dict[str, float]:
    """Set the per-iteration throughput gauges; returns the values for
    the ``info/telemetry`` roll-up."""
    wall_s = max(wall_s, 1e-9)
    env_rate = env_steps / wall_s
    learn_rate = learn_steps / wall_s
    gauge(
        ENV_STEPS_PER_S, "env steps sampled per second (last iter)"
    ).set(env_rate)
    gauge(
        LEARN_STEPS_PER_S, "learner SGD programs per second (last iter)"
    ).set(learn_rate)
    counter(ENV_STEPS_TOTAL, "env steps sampled").inc(
        max(0.0, float(env_steps))
    )
    histogram(
        ITERATION_SECONDS, "train-iteration wall seconds"
    ).observe(wall_s)
    return {
        "env_steps_per_s": env_rate,
        "learn_steps_per_s": learn_rate,
    }
