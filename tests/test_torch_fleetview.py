"""The port's fleet view (``ray_tpu_torch/telemetry/fleetview.py``,
``fleet_report.py``) against the reference's on the same snapshots: the
merged exposition byte for byte (the cases of
``tests/test_fleetview.py``: golden, ingest order, merge rules, churn
ageing out, install and render), the skew-corrected fleet timeline and
the barrier and collective attribution equal, ``registry_snapshot``
equal after the same instrument calls in both registries, the
``--dump`` report rendering the reference's text, and the KV plane's
parts refusing with ROADMAP.md item 7."""

import json
import os
import subprocess
import sys
import time

import pytest

from ray_tpu.telemetry import fleet_report as ref_report
from ray_tpu.telemetry import fleetview as ref_fv
from ray_tpu.telemetry import metrics as ref_tm
from ray_tpu.util import tracing as ref_tracing
from ray_tpu.utils import metrics as ref_m
from ray_tpu_torch.telemetry import fleet_report as port_report
from ray_tpu_torch.telemetry import fleetview as port_fv
from ray_tpu_torch.telemetry import metrics as port_tm
from ray_tpu_torch.util import tracing as port_tracing
from ray_tpu_torch.utils import metrics as port_m

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reset():
    for tracing, m, fv in ((ref_tracing, ref_m, ref_fv), (port_tracing, port_m, port_fv)):
        tracing.disable()
        tracing.clear()
        m.clear_registry()
        fv._reset_arrivals()
        fv.uninstall()


def setup_function(_fn):
    _reset()


def teardown_function(_fn):
    _reset()


def _snap(host, offset=0.0, metrics=(), spans=(), arrivals=(), seq=1):
    return {
        "host": host,
        "seq": seq,
        "ts": time.time(),
        "clock_offset_s": offset,
        "rtt_s": 0.0005,
        "metrics": list(metrics),
        "spans": list(spans),
        "arrivals": list(arrivals),
        "ledger": None,
    }


def _demo_metrics(requests, depth, shared, temp):
    return [
        {"name": "ray_tpu_demo_queue_depth", "kind": "gauge",
         "description": "demo queue depth", "series": [([], depth)]},
        {"name": "ray_tpu_demo_requests_total", "kind": "counter",
         "description": "demo requests", "series": [([("route", "/act")], requests)]},
        # already host-tagged with the SAME key on every host: a full-key
        # collision, counters SUM
        {"name": "ray_tpu_demo_shared_total", "kind": "counter",
         "description": "fleet-wide shared counter", "series": [([("host", "fleet")], shared)]},
        # the same collision for a gauge: last write in sorted host order
        {"name": "ray_tpu_demo_temp", "kind": "gauge",
         "description": "fleet-wide shared gauge", "series": [([("host", "fleet")], temp)]},
        {"name": "ray_tpu_demo_latency_seconds", "kind": "histogram",
         "description": "demo latency", "boundaries": [0.001, 0.01, 0.1],
         "series": [([("route", "/act")],
                     {"buckets": [1, requests, 2, 0], "sum": 0.25 * requests,
                      "count": 3 + requests}),
                    ([("host", "fleet")], {"buckets": [0, 1, 0, 1], "sum": 1.5, "count": 2})]},
    ]


def _pair(**kw):
    return (ref_fv.FleetAggregator(subscribe=False, **kw),
            port_fv.FleetAggregator(subscribe=False, **kw))


def _both(aggs, method, *args):
    return [getattr(a, method)(*args) for a in aggs]


GOLDEN = """\
# HELP ray_tpu_demo_queue_depth demo queue depth
# TYPE ray_tpu_demo_queue_depth gauge
ray_tpu_demo_queue_depth{host="host0"} 2.0
ray_tpu_demo_queue_depth{host="host1"} 7.0
# HELP ray_tpu_demo_requests_total demo requests
# TYPE ray_tpu_demo_requests_total counter
ray_tpu_demo_requests_total{host="host0",route="/act"} 3.0
ray_tpu_demo_requests_total{host="host1",route="/act"} 4.0
# HELP ray_tpu_demo_shared_total fleet-wide shared counter
# TYPE ray_tpu_demo_shared_total counter
ray_tpu_demo_shared_total{host="fleet"} 3.0
# HELP ray_tpu_demo_temp fleet-wide shared gauge
# TYPE ray_tpu_demo_temp gauge
ray_tpu_demo_temp{host="fleet"} 9.0
# HELP ray_tpu_fleet_hosts_reporting hosts with a live snapshot at \
the fleet aggregator
# TYPE ray_tpu_fleet_hosts_reporting gauge
ray_tpu_fleet_hosts_reporting 2.0
"""


def _golden_metrics(requests, depth, shared, temp):
    return [f for f in _demo_metrics(requests, depth, shared, temp)
            if f["kind"] != "histogram"]


@pytest.mark.parametrize("order", ["sorted", "reversed"])
@pytest.mark.parametrize("with_histogram", [False, True])
def test_merged_exposition_equals_the_reference(order, with_histogram):
    mk = _demo_metrics if with_histogram else _golden_metrics
    snaps = [_snap("host0", metrics=mk(3.0, 2.0, 1.0, 4.0)),
             _snap("host1", metrics=mk(4.0, 7.0, 2.0, 9.0))]
    if order == "reversed":
        snaps.reverse()
    aggs = _pair()
    for s in snaps:
        _both(aggs, "ingest", s)
    ref_text, port_text = _both(aggs, "merged_exposition")
    assert port_text == ref_text
    assert aggs[1].merged_exposition() == port_text  # byte-stable across scrapes
    if not with_histogram:
        assert port_text == GOLDEN
    else:
        assert ('ray_tpu_demo_latency_seconds_bucket{host="fleet",le="+Inf"} 4' in port_text)


@pytest.mark.parametrize("case", [
    ("counter", 2.0, 3.0),
    ("gauge", 2.0, 3.0),
    ("histogram", {"buckets": [1, 2], "sum": 0.5, "count": 3},
     {"buckets": [0, 1], "sum": 0.2, "count": 1}),
    # boundary mismatch (a host upgraded mid-flight): last write wins
    ("histogram", {"buckets": [1, 2], "sum": 0.5, "count": 3},
     {"buckets": [0], "sum": 0.2, "count": 1}),
])
def test_merge_value_rules(case):
    assert port_fv._merge_value(*case) == ref_fv._merge_value(*case)


def test_churn_ages_a_silent_host_out():
    aggs = _pair(max_age=0.2)
    _both(aggs, "ingest", _snap("host0", metrics=_golden_metrics(3.0, 2.0, 1.0, 4.0)))
    _both(aggs, "ingest", _snap("host1", metrics=_golden_metrics(4.0, 7.0, 2.0, 9.0)))
    ref_text, port_text = _both(aggs, "merged_exposition")
    assert port_text == ref_text and 'host="host1"' in port_text
    time.sleep(0.3)
    _both(aggs, "ingest", _snap("host0", metrics=_golden_metrics(5.0, 2.0, 1.0, 4.0)))
    ref_text, port_text = _both(aggs, "merged_exposition")
    assert port_text == ref_text
    assert 'host="host1"' not in port_text
    assert "ray_tpu_fleet_hosts_reporting 1.0" in port_text
    assert _both(aggs, "hosts") == [["host0"], ["host0"]]


def test_install_and_render_installed():
    assert port_fv.render_installed() is None
    aggs = _pair()
    _both(aggs, "ingest", _snap("host0", metrics=_golden_metrics(3.0, 2.0, 1.0, 4.0)))
    ref_fv.install(aggs[0])
    port_fv.install(aggs[1])
    assert port_fv.current() is aggs[1]
    assert port_fv.render_installed() == ref_fv.render_installed()
    assert 'ray_tpu_demo_queue_depth{host="host0"} 2.0' in port_fv.render_installed()
    port_fv.uninstall(aggs[0])  # not the installed one: no-op
    assert port_fv.current() is aggs[1]
    port_fv.uninstall(aggs[1])
    assert port_fv.render_installed() is None


def test_metrics_route_and_server_serve_the_installed_view():
    import urllib.request

    from ray_tpu_torch.ingress.http import PolicyIngress
    from ray_tpu_torch.utils.metrics_exporter import MetricsServer, format_prometheus

    agg = port_fv.FleetAggregator(subscribe=False)
    agg.ingest(_snap("host0", metrics=_golden_metrics(3.0, 2.0, 1.0, 4.0)))
    ingress = PolicyIngress().start()

    def boom():
        raise RuntimeError("renderer down")

    servers = [MetricsServer(render=port_fv.render_installed), MetricsServer(render=boom)]
    try:
        def get(url):
            return urllib.request.urlopen(url + "/metrics", timeout=10).read().decode()

        port_fv.install(agg)
        merged = agg.merged_exposition()
        assert get(ingress.url) == merged
        assert get(f"http://127.0.0.1:{servers[0].port}") == merged
        # a renderer that raises falls back to the process-local text
        assert "ray_tpu_demo_queue_depth" not in get(f"http://127.0.0.1:{servers[1].port}")
        port_fv.uninstall()
        local = get(ingress.url)
        assert "ray_tpu_demo_queue_depth" not in local and "# TYPE" in local
        assert get(f"http://127.0.0.1:{servers[0].port}").startswith(format_prometheus()[:40])
    finally:
        ingress.stop()
        for s in servers:
            s.shutdown()


def _span(sid, start=100.05, end=100.07, pid=1, tid=1, name="learn:nest", parent=None,
          thread_name=None):
    s = {"name": name, "start": start, "end": end, "span_id": sid, "parent_id": parent,
         "trace_id": "t", "pid": pid, "tid": tid, "attributes": {"k": sid}}
    if thread_name:
        s["thread_name"] = thread_name
    return s


def _timelines(aggs, tmp_path, since=None):
    out = []
    for tag, agg in zip(("ref", "port"), aggs):
        path = str(tmp_path / f"{tag}.json")
        agg.export_fleet_timeline(path, since=since)
        with open(path) as f:
            out.append(json.load(f))
    return out


@pytest.mark.parametrize("since", [None, 100.06])
def test_skew_corrected_fleet_timeline_equals_the_reference(tmp_path, since):
    # true order: host0's span [100.00, 100.02], then host1's [100.10,
    # 100.12]; host0's clock runs 50 ms ahead and host1's 50 ms behind,
    # so both stamp [100.05, 100.07]: only the correction separates them
    aggs = _pair()
    _both(aggs, "ingest", _snap("host0", offset=0.05, spans=[
        _span("a", thread_name="main"),
        # a child that outlives its parent is clamped into it
        _span("a2", start=100.055, end=100.09, parent="a", name="learn:sgd"),
        _span("a3", start=100.051, end=None, pid=2, name="event")]))
    _both(aggs, "ingest", _snap("host1", offset=-0.05, spans=[_span("b")]))
    _both(aggs, "ingest_barrier", {"gen": 3, "name": "epoch", "host": "host0",
                                   "hosts": ["host0", "host1"], "ts": 100.2})
    _both(aggs, "ingest_barrier", {"gen": 3, "name": "epoch", "host": "host1",
                                   "hosts": ["host0", "host1"], "ts": 100.21})
    ref_tl, port_tl = _timelines(aggs, tmp_path, since)
    assert port_tl == ref_tl
    xs = {e["args"]["span_id"]: e for e in port_tl["traceEvents"]
          if e.get("ph") == "X" and e.get("cat") == "span" and "span_id" in e["args"]}
    if since is None:
        assert xs["a"]["ts"] == pytest.approx(100.00 * 1e6)
        assert xs["b"]["ts"] == pytest.approx(100.10 * 1e6)
        assert xs["a"]["ts"] + xs["a"]["dur"] <= xs["b"]["ts"]


def test_barrier_attribution_equals_the_reference():
    ref_tracing.enable()
    port_tracing.enable()
    aggs = _pair()
    _both(aggs, "ingest", _snap("host0", offset=0.05))
    _both(aggs, "ingest", _snap("host1", offset=-0.05))
    rec = {"gen": 1, "name": "epoch", "host": "host0", "hosts": ["host0", "host1"],
           "ts": 10.00}
    _both(aggs, "ingest_barrier", rec)
    assert aggs[1].barrier_history == [] == aggs[0].barrier_history
    for _ in range(2):  # a duplicate delivery is idempotent
        _both(aggs, "ingest_barrier", dict(rec, host="host1", ts=10.05))
    # a malformed record is dropped
    _both(aggs, "ingest_barrier", {"gen": "x"})
    assert aggs[1].barrier_history == aggs[0].barrier_history
    assert len(aggs[1].barrier_history) == 1
    done = aggs[1].barrier_history[0]
    assert done["straggler"] == "host1" and done["kind"] == "barrier"
    assert done["waits"]["host0"] == pytest.approx(0.15)
    assert aggs[1].latest_gen == aggs[0].latest_gen == 1
    ref_text, port_text = _both(aggs, "merged_exposition")
    assert port_text == ref_text
    assert 'ray_tpu_fleet_straggler_total{host="host1"} 1.0' in port_text
    assert 'ray_tpu_fleet_barrier_wait_seconds{epoch="1",host="host0"}' in port_text

    def fleet_spans(tracing):
        return [(s["start"], s["end"], s["attributes"]) for s in tracing.get_spans()
                if s["name"] == "fleet:barrier"]

    assert fleet_spans(port_tracing) == fleet_spans(ref_tracing)
    assert len(fleet_spans(port_tracing)) == 1


def test_collective_drain_point_attribution_equals_the_reference():
    aggs = _pair()
    _both(aggs, "ingest", _snap("host0", arrivals=[
        {"point": "put_global", "index": 0, "ts": 5.0},
        {"point": "put_global", "index": 1, "ts": 6.0},
        {"point": "resize"}]))
    assert aggs[1].barrier_history == []  # one host is not a fleet
    for _ in range(2):  # re-ingesting the same records does not re-attribute
        _both(aggs, "ingest", _snap("host1", offset=0.01, arrivals=[
            {"point": "put_global", "index": 0, "ts": 5.2},
            {"point": "put_global", "index": 1, "ts": 5.9}]))
    assert aggs[1].barrier_history == aggs[0].barrier_history
    assert [b["name"] for b in aggs[1].barrier_history] == ["put_global[0]", "put_global[1]"]
    assert [b["straggler"] for b in aggs[1].barrier_history] == ["host1", "host0"]
    assert _both(aggs, "merged_exposition")[0] == aggs[1].merged_exposition()


def test_registry_snapshot_equals_the_reference():
    for tm in (ref_tm, port_tm):
        tm.set_queue_depth("learner_in", 3)
        tm.inc_ingress_request("actions", 200)
        tm.inc_ingress_request("actions", 429)
        for v in (0.0004, 0.003, 0.2, 7.0):
            tm.observe_ingress_latency("actions", v)
        tm.set_ingress_workers("live", 2)
        tm.set_ingress_workers("target", 2)
        tm.inc_ingress_worker_respawns()
        tm.set_barrier_wait("host0", 4, 0.25)
        tm.inc_straggler("host1", 2)
        tm.set_hosts_reporting(3)
    assert port_fv.registry_snapshot() == ref_fv.registry_snapshot()
    assert json.dumps(port_fv.registry_snapshot()) == json.dumps(ref_fv.registry_snapshot())


def test_arrival_recorder_arming():
    assert not port_fv.arrivals_on()
    port_fv.record_arrival("put_global")  # unarmed: dropped
    port_fv.arm_arrivals()
    try:
        port_fv.record_arrival("put_global", ts=1.0)
        port_fv.record_arrival("put_global", ts=2.0)
        port_fv.record_arrival("resize", ts=3.0)
        got = port_fv._drain_arrivals()
        assert [(a["point"], a["index"], a["ts"]) for a in got] == [
            ("put_global", 0, 1.0), ("put_global", 1, 2.0), ("resize", 0, 3.0)]
        assert port_fv._drain_arrivals() == []
    finally:
        port_fv.arm_arrivals(False)
    assert port_fv.snapshot_key("h9") == ref_fv.snapshot_key("h9")
    assert port_fv.AGGREGATOR_FAMILIES == ref_fv.AGGREGATOR_FAMILIES
    assert (port_fv.CH_FLEETVIEW, port_fv.CH_BARRIER, port_fv.K_AGGREGATE) == (
        ref_fv.CH_FLEETVIEW, ref_fv.CH_BARRIER, ref_fv.K_AGGREGATE)


def test_the_kv_plane_refuses_naming_item_7():
    with pytest.raises(NotImplementedError, match="item 7"):
        port_fv.HostExporter(object(), "h0", interval=0)
    with pytest.raises(NotImplementedError, match="item 7"):
        port_fv.clock_handshake(object())
    with pytest.raises(NotImplementedError, match="item 7"):
        port_fv.FleetAggregator(kv=object())
    with pytest.raises(NotImplementedError, match="item 7"):
        port_report.build_report(kv="127.0.0.1:1")


def _report_data():
    aggs = _pair()
    _both(aggs, "ingest", _snap("host0", offset=0.012, metrics=[
        {"name": ref_tm.KV_RTT_SECONDS, "kind": "gauge", "description": "kv rtt",
         "series": [([("host", "host0")], 0.0021)]}]))
    snap1 = _snap("host1", offset=-0.003, spans=[_span("s")], seq=7)
    snap1["ledger"] = {"totals": {"mfu": 0.4321}}
    _both(aggs, "ingest", snap1)
    _both(aggs, "ingest_barrier", {"gen": 2, "name": "epoch", "host": "host0",
                                   "hosts": ["host0", "host1"], "ts": 50.0})
    _both(aggs, "ingest_barrier", {"gen": 2, "name": "epoch", "host": "host1",
                                   "hosts": ["host0", "host1"], "ts": 50.4})
    return _both(aggs, "report_data")


def test_report_data_equals_the_reference():
    ref, port = _report_data()
    for r in (ref, port):
        r.pop("ts")
        for h in r["hosts"]:
            assert 0.0 <= h.pop("age_s") < 60.0
    assert port == ref
    assert port["hosts"][0]["kv_rtt_s"] == 0.0021 and port["hosts"][1]["mfu"] == 0.4321


def test_fleet_report_dump_renders_the_reference_text(tmp_path):
    _, port = _report_data()
    port["epochs"] = [{"gen": 2, "hosts": ["host0", "host1"]}]
    path = tmp_path / "aggregate.json"
    path.write_text(json.dumps(port))
    want = ref_report.render_text(ref_report.build_report(dump=str(path)))
    assert port_report.render_text(port_report.build_report(dump=str(path))) == want
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.telemetry.fleet_report", "--dump", str(path)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout == want + "\n"
    assert "STALE" not in out.stdout and "host1" in out.stdout
