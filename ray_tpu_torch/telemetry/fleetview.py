"""The fleet view: many processes' observability merged into one.

Counterpart of ``ray_tpu/telemetry/fleetview.py``, less its KV plane.
Each process serializes its metric registry (:func:`registry_snapshot`)
and ships it, with its finished spans and its collective drain-point
arrivals (:func:`record_arrival`), as one snapshot. A
:class:`FleetAggregator` merges the snapshots:

- ONE Prometheus exposition (:meth:`FleetAggregator.merged_exposition`),
  a ``host=`` label on every series: counters SUM on a full-key
  collision, gauges take the last write in sorted host order,
  histograms merge bucket-wise; the text is the reference's, byte for
  byte, for the same snapshots;
- a skew-corrected fleet chrome timeline
  (:meth:`FleetAggregator.export_fleet_timeline`), one lane group per
  host, each host's stamps mapped into the reference frame as
  ``t - clock_offset_s``;
- barrier and drain-point **straggler attribution**
  (``ray_tpu_fleet_barrier_wait_seconds{host,epoch}``,
  ``ray_tpu_fleet_straggler_total{host}``, ``fleet:barrier`` spans).

The ingress bank (``ingress/supervisor.py``) feeds an aggregator over
its workers' pipes. The reference's KV transport, its publisher
(:class:`HostExporter`), the clock handshake against the KV server's
clock and an aggregator that subscribes to the KV channels
(``kv=``) are ROADMAP.md item 7: they raise, naming it.

Env knob: ``RAY_TPU_FLEETVIEW_MAX_AGE_S``, the aggregator's staleness
horizon (15 s): a host that stops reporting ages out of the merged
exposition.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.telemetry import metrics as tm
from ray_tpu_torch.util import tracing
from ray_tpu_torch.utils import metrics as instruments
from ray_tpu_torch.utils.metrics_exporter import _fmt_tags

# the reference's channel and key names, kept for its report CLI's
# layout; nothing in the port publishes on them yet (item 7)
CH_FLEETVIEW = "fleetview/host"
CH_BARRIER = "fleet/barrier_arrival"
K_AGGREGATE = "fleetview/aggregate"

MAX_AGE_ENV = "RAY_TPU_FLEETVIEW_MAX_AGE_S"

# the KV heartbeat's round-trip gauge (item 7); report_data reads it
# from a host's snapshot where the host set it
KV_RTT_SECONDS = "ray_tpu_kv_rtt_seconds"

# families the aggregator computes itself (rendered from its local
# registry, skipped in host snapshots so an aggregating process that
# also reports can't duplicate them)
AGGREGATOR_FAMILIES = (
    tm.FLEET_BARRIER_WAIT_SECONDS,
    tm.FLEET_STRAGGLER_TOTAL,
    tm.FLEET_HOSTS_REPORTING,
)

_KV_ITEM = "the fleet view's KV plane is not ported yet: ROADMAP.md queue 1 item 7"


def snapshot_key(host: str) -> str:
    return f"fleetview/host/{host}"


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


# -- collective drain-point arrivals ------------------------------------
#
# Hot paths call record_arrival(); it is one flag check until armed
# (arm_arrivals, the reference's HostExporter arms it). Under the
# lockstep contract every host reaches the k-th arrival of a named point
# together, so (point, index) is a cross-host join key the aggregator
# can attribute without barriers.

_ARR_ON = False
_ARR_LOCK = threading.Lock()
_ARR_RECORDS: "collections.deque" = collections.deque(maxlen=512)
_ARR_COUNTS: Dict[str, int] = {}


def arrivals_on() -> bool:
    return _ARR_ON


def arm_arrivals(on: bool = True) -> None:
    """Start (or stop) recording drain-point arrivals in this process."""
    global _ARR_ON
    _ARR_ON = bool(on)


def record_arrival(point: str, ts: Optional[float] = None) -> None:
    """Record this process's arrival at a collective drain point. No-op
    (one flag check) until armed."""
    if not _ARR_ON:
        return
    if ts is None:
        ts = time.time()
    with _ARR_LOCK:
        idx = _ARR_COUNTS.get(point, 0)
        _ARR_COUNTS[point] = idx + 1
        _ARR_RECORDS.append({"point": point, "index": idx, "ts": ts})


def _drain_arrivals() -> List[Dict[str, Any]]:
    """The arrivals recorded since the last drain (a snapshot's
    ``arrivals``)."""
    with _ARR_LOCK:
        out = list(_ARR_RECORDS)
        _ARR_RECORDS.clear()
    return out


def _reset_arrivals() -> None:
    with _ARR_LOCK:
        _ARR_RECORDS.clear()
        _ARR_COUNTS.clear()


# -- snapshot building --------------------------------------------------


def registry_snapshot() -> List[Dict[str, Any]]:
    """Serialize the local metric registry: one dict per family (name,
    kind, description, boundaries for histograms, series as
    ``(sorted-tag-items, value)`` pairs), families sorted by name so a
    snapshot renders byte-stable."""
    fams: List[Dict[str, Any]] = []
    for m in instruments.all_metrics():
        fam: Dict[str, Any] = {
            "name": m.name,
            "kind": m.kind,
            "description": m.description,
        }
        if isinstance(m, instruments.Histogram):
            fam["boundaries"] = list(m.boundaries)
            fam["series"] = [(list(tags), dict(val)) for tags, val in m.series()]
        else:
            fam["series"] = [(list(tags), val) for tags, val in m.series()]
        fams.append(fam)
    fams.sort(key=lambda f: f["name"])
    return fams


def clock_handshake(kv, samples: int = 3) -> Tuple[float, float]:
    """The reference's NTP-style skew measurement against the KV
    server's clock; the KV plane is ROADMAP.md item 7."""
    raise NotImplementedError(f"clock_handshake: {_KV_ITEM}")


class HostExporter:
    """The reference's per-host publisher of snapshots onto the KV
    plane; ROADMAP.md item 7. A process without the KV plane hands its
    snapshots to an aggregator directly (:meth:`FleetAggregator.ingest`),
    as the ingress bank's workers do over their pipes."""

    def __init__(self, kv, host: str, *args, **kwargs):
        raise NotImplementedError(f"HostExporter: {_KV_ITEM}")


# -- the aggregator -----------------------------------------------------


def _merge_value(kind: str, prev, new):
    """Cross-host merge on a full-key collision (same family, same
    complete tag set after host injection): counters SUM (each host
    counted its own events), gauges LAST-WRITE in sorted host order,
    histograms merge bucket-wise."""
    if kind == "counter":
        return prev + new
    if kind == "histogram" and isinstance(prev, dict):
        pb, nb = prev.get("buckets", []), new.get("buckets", [])
        if len(pb) != len(nb):
            return new
        return {
            "buckets": [a + b for a, b in zip(pb, nb)],
            "sum": prev.get("sum", 0.0) + new.get("sum", 0.0),
            "count": prev.get("count", 0) + new.get("count", 0),
        }
    return new  # gauge (and unknown kinds): last write wins


class FleetAggregator:
    """Merge every host's snapshot into one exposition, one timeline and
    per-host barrier attribution.

    Snapshots arrive through :meth:`ingest` and barrier arrivals through
    :meth:`ingest_barrier` (the ingress supervisor's pipes, tests,
    offline tools). Staleness: a host whose last snapshot is older than
    ``max_age`` is pruned at render time. ``kv=`` (the reference's KV
    subscription and its aggregate digest) is ROADMAP.md item 7."""

    def __init__(
        self,
        kv=None,
        max_age: Optional[float] = None,
        subscribe: bool = True,
        publish_aggregate: bool = True,
        max_spans_per_host: int = 20000,
        poll_timeout: float = 1.0,
    ):
        if kv is not None:
            raise NotImplementedError(f"FleetAggregator(kv=...): {_KV_ITEM}")
        self.max_age = max_age if max_age is not None else _env_f(MAX_AGE_ENV, 15.0)
        self.max_spans_per_host = int(max_spans_per_host)
        self._lock = threading.Lock()
        self._snaps: Dict[str, Dict[str, Any]] = {}
        self._spans: Dict[str, "collections.deque"] = {}
        self._arrivals: Dict[str, Dict[Tuple[str, int], float]] = {}
        self._collective_done: set = set()
        self._barriers: Dict[Tuple[int, str], Dict[str, float]] = {}
        self._barrier_world: Dict[Tuple[int, str], Tuple[str, ...]] = {}
        self._barrier_done: set = set()
        self.barrier_history: List[Dict[str, Any]] = []
        self.latest_gen = 0

    def ingest(self, snap: Dict[str, Any]) -> None:
        """Absorb one host snapshot."""
        host = snap.get("host")
        if not host:
            return
        now = time.time()
        with self._lock:
            self._snaps[host] = dict(snap, _recv_at=now)
            dq = self._spans.get(host)
            if dq is None:
                dq = self._spans[host] = collections.deque(maxlen=self.max_spans_per_host)
            dq.extend(snap.get("spans") or ())
            arr = self._arrivals.setdefault(host, {})
            for rec in snap.get("arrivals") or ():
                try:
                    arr[(str(rec["point"]), int(rec["index"]))] = float(rec["ts"])
                except (KeyError, TypeError, ValueError):
                    continue
            self._attribute_collectives_locked()

    def ingest_barrier(self, rec: Dict[str, Any]) -> None:
        """Absorb one barrier-arrival event. When every host of the
        record's epoch has arrived, attribute waits and the straggler."""
        try:
            gen = int(rec["gen"])
            name = str(rec["name"])
            host = str(rec["host"])
            ts = float(rec["ts"])
        except (KeyError, TypeError, ValueError):
            return
        with self._lock:
            self.latest_gen = max(self.latest_gen, gen)
            key = (gen, name)
            if key in self._barrier_done:
                return
            world = tuple(rec.get("hosts") or ())
            if world:
                self._barrier_world[key] = world
            self._barriers.setdefault(key, {})[host] = ts
            world = self._barrier_world.get(key, ())
            arr = self._barriers[key]
            if world and set(world) <= set(arr):
                self._attribute_locked(gen, name, {h: arr[h] for h in world}, kind="barrier")
                self._barrier_done.add(key)
                self._barriers.pop(key, None)

    # -- attribution (under self._lock; local compute only) ------------

    def _offset_locked(self, host: str) -> float:
        snap = self._snaps.get(host)
        if snap is None:
            return 0.0
        try:
            return float(snap.get("clock_offset_s") or 0.0)
        except (TypeError, ValueError):
            return 0.0

    def _attribute_collectives_locked(self) -> None:
        """Attribute every (point, index) drain point all live hosts
        have reached."""
        live = sorted(self._snaps)
        if len(live) < 2:
            return
        for key in list(self._arrivals.get(live[0], {})):
            if key in self._collective_done:
                continue
            if not all(key in self._arrivals.get(h, {}) for h in live):
                continue
            arrivals = {h: self._arrivals[h][key] for h in live}
            self._attribute_locked(self.latest_gen, f"{key[0]}[{key[1]}]", arrivals,
                                   kind="collective")
            self._collective_done.add(key)
            if len(self._collective_done) > 8192:
                self._collective_done.clear()
            for h in live:
                self._arrivals.get(h, {}).pop(key, None)

    def _attribute_locked(self, gen: int, name: str, arrivals: Dict[str, float],
                          kind: str) -> None:
        corrected = {h: arrivals[h] - self._offset_locked(h) for h in sorted(arrivals)}
        t_last = max(corrected.values())
        straggler = max(sorted(corrected), key=lambda h: corrected[h])
        waits = {h: t_last - t for h, t in corrected.items()}
        for h, w in waits.items():
            tm.set_barrier_wait(h, gen, w)
        tm.inc_straggler(straggler)
        rec = {
            "gen": gen,
            "name": name,
            "kind": kind,
            "straggler": straggler,
            "start": min(corrected.values()),
            "end": t_last,
            "waits": waits,
        }
        self.barrier_history.append(rec)
        if len(self.barrier_history) > 1024:
            del self.barrier_history[: len(self.barrier_history) - 1024]
        # the fleet-level span, in the reference clock frame already
        tracing.record_span("fleet:barrier", rec["start"], rec["end"], barrier=name, gen=gen,
                            straggler=straggler, kind=kind)

    # -- reads ----------------------------------------------------------

    def _prune_locked(self, now: float) -> None:
        for host in [h for h, s in self._snaps.items()
                     if now - s.get("_recv_at", now) > self.max_age]:
            del self._snaps[host]

    def hosts(self) -> List[str]:
        """Hosts with a live (non-aged) snapshot, sorted."""
        with self._lock:
            self._prune_locked(time.time())
            return sorted(self._snaps)

    def merged_exposition(self) -> str:
        """The fleet's ONE Prometheus exposition: every live host's
        families with a ``host=`` label injected on series that lack
        one, plus the aggregator-computed families from the local
        registry. Families sorted by name; within a family, series
        iterate hosts in sorted order (byte-stable given the same
        snapshots)."""
        with self._lock:
            self._prune_locked(time.time())
            snaps = [self._snaps[h] for h in sorted(self._snaps)]
        tm.set_hosts_reporting(len(snaps))
        fams: Dict[str, Dict[str, Any]] = {}

        def add_family(fam, inject_host=None):
            name = fam.get("name")
            if not name:
                return
            rec = fams.get(name)
            if rec is None:
                rec = fams[name] = {
                    "kind": fam.get("kind", "untyped"),
                    "description": fam.get("description", ""),
                    "boundaries": fam.get("boundaries"),
                    "series": collections.OrderedDict(),
                }
            for tags, value in fam.get("series", ()):
                t = dict(tags)
                if inject_host is not None and "host" not in t:
                    t["host"] = inject_host
                key = tuple(sorted(t.items()))
                prev = rec["series"].get(key)
                if prev is None:
                    rec["series"][key] = value
                else:
                    rec["series"][key] = _merge_value(rec["kind"], prev, value)

        local = {f["name"]: f for f in registry_snapshot()}
        for name in AGGREGATOR_FAMILIES:
            if name in local:
                add_family(local[name])
        for snap in snaps:
            for fam in snap.get("metrics", ()):
                if fam.get("name") in AGGREGATOR_FAMILIES:
                    continue
                add_family(fam, inject_host=snap["host"])
        lines: List[str] = []
        for name in sorted(fams):
            rec = fams[name]
            pname = name.replace(".", "_")
            if rec["description"]:
                lines.append(f"# HELP {pname} {rec['description']}")
            lines.append(f"# TYPE {pname} {rec['kind']}")
            if rec["kind"] == "histogram":
                bounds = rec.get("boundaries") or []
                for key, data in rec["series"].items():
                    cum = 0.0
                    for b, c in zip(bounds, data["buckets"]):
                        cum += c
                        t = dict(key)
                        t["le"] = repr(float(b))
                        lines.append(f"{pname}_bucket{_fmt_tags(sorted(t.items()))} {cum}")
                    total = sum(data["buckets"])
                    t = dict(key)
                    t["le"] = "+Inf"
                    lines.append(f"{pname}_bucket{_fmt_tags(sorted(t.items()))} {total}")
                    lines.append(f"{pname}_sum{_fmt_tags(key)} {data['sum']}")
                    lines.append(f"{pname}_count{_fmt_tags(key)} {data['count']}")
            else:
                for key, value in rec["series"].items():
                    lines.append(f"{pname}{_fmt_tags(key)} {value}")
        return "\n".join(lines) + "\n"

    def export_fleet_timeline(self, path: str, since: Optional[float] = None) -> str:
        """One chrome://tracing file for the whole fleet: each host's
        shipped spans shifted into the reference frame (``t - offset``),
        the per-host child-clamp rule of
        :func:`tracing._clamped_intervals`, one process-lane group per
        (host, original pid) labelled with the host name; attributed
        barriers on a ``fleet`` lane (pid 0) naming the straggler."""
        with self._lock:
            hosts = sorted(set(self._spans) | set(self._snaps))
            per_host = {h: list(self._spans.get(h, ())) for h in hosts}
            offsets = {h: self._offset_locked(h) for h in hosts}
            barriers = list(self.barrier_history)
        events: List[Dict[str, Any]] = []
        pid_map: Dict[Tuple[str, int], int] = {}

        def lane_pid(host, orig_pid):
            key = (host, orig_pid)
            if key not in pid_map:
                pid_map[key] = len(pid_map) + 1
                events.append({
                    "name": "process_name",
                    "ph": "M",
                    "pid": pid_map[key],
                    "tid": 0,
                    "args": {"name": f"{host} (pid {orig_pid})"},
                })
            return pid_map[key]

        for host in hosts:
            spans = per_host[host]
            if since is not None:
                spans = [s for s in spans
                         if (s.get("end") or s.get("start") or 0.0) >= since]
            off = offsets.get(host, 0.0)
            shifted = []
            for s in spans:
                c = dict(s)
                c["start"] = s["start"] - off
                c["end"] = (s["end"] if s.get("end") is not None else s["start"]) - off
                shifted.append(c)
            clamped = tracing._clamped_intervals(shifted)
            lanes: Dict[Tuple[int, int], Optional[str]] = {}
            for s in shifted:
                start, end = clamped.get(s.get("span_id"), (s["start"], s["end"]))
                pid = lane_pid(host, s.get("pid", 0))
                tid = s.get("tid", 0)
                events.append({
                    "name": s["name"],
                    "cat": "span",
                    "ph": "X",
                    "ts": start * 1e6,
                    "dur": (end - start) * 1e6,
                    "pid": pid,
                    "tid": tid,
                    "args": {
                        "host": host,
                        "trace_id": s.get("trace_id"),
                        "span_id": s.get("span_id"),
                        "parent_id": s.get("parent_id"),
                        **(s.get("attributes") or {}),
                    },
                })
                lanes.setdefault((pid, tid), s.get("thread_name"))
            for (pid, tid), tname in sorted(lanes.items()):
                if tname:
                    events.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                                   "args": {"name": tname}})
        if barriers:
            events.append({"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                           "args": {"name": "fleet"}})
            for rec in barriers:
                if since is not None and rec["end"] < since:
                    continue
                events.append({
                    "name": "fleet:barrier",
                    "cat": "span",
                    "ph": "X",
                    "ts": rec["start"] * 1e6,
                    "dur": max(0.0, rec["end"] - rec["start"]) * 1e6,
                    "pid": 0,
                    "tid": 0,
                    "args": {
                        "barrier": rec["name"],
                        "gen": rec["gen"],
                        "kind": rec["kind"],
                        "straggler": rec["straggler"],
                        "waits": rec["waits"],
                    },
                })
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)
        return path

    def report_data(self) -> Dict[str, Any]:
        """JSON-safe digest for the report CLI: per-host health (age,
        seq, skew, rtt, ledger MFU), barrier history, latest epoch
        generation."""
        now = time.time()
        with self._lock:
            self._prune_locked(now)
            hosts = []
            for h in sorted(self._snaps):
                s = self._snaps[h]
                ledger = s.get("ledger") or {}
                totals = ledger.get("totals") or {}
                hosts.append({
                    "host": h,
                    "seq": s.get("seq"),
                    "age_s": now - s.get("_recv_at", now),
                    "clock_offset_s": s.get("clock_offset_s"),
                    "rtt_s": s.get("rtt_s"),
                    "mfu": totals.get("mfu"),
                    "kv_rtt_s": _family_value(s, KV_RTT_SECONDS),
                    "spans_buffered": len(self._spans.get(h, ())),
                })
            return {
                "ts": now,
                "max_age_s": self.max_age,
                "latest_gen": self.latest_gen,
                "hosts": hosts,
                "barriers": list(self.barrier_history[-50:]),
            }


def _family_value(snap: Dict[str, Any], family: str):
    """First series value of ``family`` in a snapshot's serialized
    registry (None when the host never set it)."""
    for fam in snap.get("metrics", ()):
        if fam.get("name") == family:
            for _tags, value in fam.get("series", ()):
                return value
    return None


# -- process-wide installation (the /metrics hook) ----------------------

_INSTALLED = None


def install(agg):
    """Make ``agg`` this process's fleet view: the ingress ``/metrics``
    route and any MetricsServer constructed with
    ``render=fleetview.render_installed`` serve its merged exposition
    instead of the process-local one. ``agg`` is anything with a
    ``merged_exposition()`` (an ingress worker installs the bank's last
    merged text this way)."""
    global _INSTALLED
    _INSTALLED = agg
    return agg


def current():
    return _INSTALLED


def uninstall(agg=None) -> None:
    global _INSTALLED
    if agg is None or _INSTALLED is agg:
        _INSTALLED = None


def render_installed() -> Optional[str]:
    """Merged exposition of the installed aggregator, or None (callers
    fall back to the process-local exposition)."""
    agg = _INSTALLED
    if agg is None:
        return None
    return agg.merged_exposition()
