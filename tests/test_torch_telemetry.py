"""The port's telemetry against the reference's, on the CPU.

- the Prometheus exposition: one event sequence fed to both packages'
  registries renders the same text, byte for byte (the reference's
  golden included), with series keys stable across tag orders;
- histogram observations under concurrent writers;
- the metric catalog: the reference's names less the series of parts
  the port lacks (the learner fleet and KV, the AOT cache, the ingress
  bank and the flood harness);
- the iteration roll-up, ``merge_intervals`` and ``intersect``, bitwise
  against the reference's on one seeded span list (late spans too);
- ``AlgorithmConfig.telemetry()`` and its refusal of the fleet view;
- ``GET /metrics`` answering 200 with the process's exposition;
- PPO end to end with one remote worker, the reference's
  ``tests/test_telemetry.py`` e2e as the port's: ``info/telemetry``
  with the reference's keys, the scrape's series, and one timeline
  with spans from two processes, two driver threads and the device
  lanes;
- telemetry off records nothing.
"""

import asyncio
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from ray_tpu.telemetry import metrics as ref_catalog
from ray_tpu.telemetry import rollup as ref_rollup
from ray_tpu.utils import metrics as ref_metrics
from ray_tpu.utils import metrics_exporter as ref_exporter
from ray_tpu_torch import telemetry
from ray_tpu_torch.telemetry import device as device_ledger
from ray_tpu_torch.telemetry import metrics as catalog
from ray_tpu_torch.telemetry import rollup
from ray_tpu_torch.util import tracing
from ray_tpu_torch.utils import metrics
from ray_tpu_torch.utils import metrics_exporter


@pytest.fixture(autouse=True)
def _clean():
    tracing.disable()
    tracing.clear()
    yield
    rt = telemetry.runtime()
    if rt is not None:
        rt.shutdown()
    tracing.disable()
    tracing.clear()
    device_ledger.disable()
    device_ledger.clear()


def _feed(m):
    """One event sequence on a registry module (either package's)."""
    m.clear_registry()
    c = m.Counter("gold_req", "requests", ("zone", "path"))
    # tags given in different insertion orders render identically
    c.inc(2, {"zone": "a", "path": "/x"})
    c.inc(3, {"path": "/y", "zone": "b"})
    c.inc(0.5, {"path": "/x", "zone": "a"})
    g = m.Gauge("gold_depth", "queue depth", ("queue",))
    g.set(4, {"queue": "in"})
    g.set(7.25, {"queue": "out"})
    m.Gauge("gold.dotted")  # a name with a dot, no help text
    h = m.Histogram("gold_lat", "latency", boundaries=[0.1, 1.0], tag_keys=("op",))
    for v in (0.05, 0.5, 5.0, 0.1, 1.0):
        h.observe(v, {"op": "put"})
    h.observe(0.3, {"op": 'q"e\\d\n'})  # label escaping
    t = m.timer_histogram("gold_timer", "timer")
    for v in (0.0001, 0.003, 0.7, 200.0):
        t.observe(v)
    assert m.timer_histogram("gold_timer") is t
    return c, g, h


def test_exposition_text_bitwise_the_reference():
    _feed(metrics)
    port_text = metrics_exporter.format_prometheus()
    _feed(ref_metrics)
    ref_text = ref_exporter.format_prometheus()
    assert port_text == ref_text
    assert 'gold_req{path="/x",zone="a"} 2.5' in port_text
    assert 'gold_lat_bucket{le="+Inf",op="put"} 5.0' in port_text
    metrics.clear_registry()
    ref_metrics.clear_registry()


def test_exposition_golden():
    """The reference test's golden text, from the port's registry."""
    metrics.clear_registry()
    c = metrics.Counter("gold_req", "requests", ("zone", "path"))
    c.inc(2, {"zone": "a", "path": "/x"})
    c.inc(3, {"path": "/y", "zone": "b"})
    metrics.Gauge("gold_depth", "queue depth", ("queue",)).set(4, {"queue": "in"})
    h = metrics.Histogram("gold_lat", "latency", boundaries=[0.1, 1.0], tag_keys=("op",))
    for v in (0.05, 0.5, 5.0):
        h.observe(v, {"op": "put"})
    assert metrics_exporter.format_prometheus() == """\
# HELP gold_req requests
# TYPE gold_req counter
gold_req{path="/x",zone="a"} 2.0
gold_req{path="/y",zone="b"} 3.0
# HELP gold_depth queue depth
# TYPE gold_depth gauge
gold_depth{queue="in"} 4.0
# HELP gold_lat latency
# TYPE gold_lat histogram
gold_lat_bucket{le="0.1",op="put"} 1.0
gold_lat_bucket{le="1.0",op="put"} 2.0
gold_lat_bucket{le="+Inf",op="put"} 3.0
gold_lat_sum{op="put"} 5.55
gold_lat_count{op="put"} 3
"""
    with pytest.raises(ValueError):
        c.inc(-1)
    metrics.clear_registry()


def test_histogram_concurrent_observe_threadsafe():
    metrics.clear_registry()
    h = metrics.Histogram("conc_lat", boundaries=[0.5], tag_keys=("t",))

    def pound(i):
        for k in range(500):
            h.observe(0.25 if k % 2 else 0.75, {"t": str(i % 2)})

    threads = [threading.Thread(target=pound, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    series = dict(h.series())
    assert sum(s["count"] for s in series.values()) == 8 * 500
    for s in series.values():
        assert sum(s["buckets"]) == s["count"]
        assert s["sum"] == pytest.approx(s["count"] * 0.5)
    metrics.clear_registry()


# the reference's series the port leaves out, with the parts that feed them
OMITTED = {
    # the learner fleet and KV (item 7)
    "ray_tpu_learner_fleet_hosts", "ray_tpu_mesh_epoch", "ray_tpu_mesh_resizes_total",
    "ray_tpu_fleet_aot_preseeds_total", "ray_tpu_fleet_clock_offset_seconds",
    "ray_tpu_kv_rtt_seconds", "ray_tpu_kv_retries_total",
    "ray_tpu_kv_reconnects_total", "ray_tpu_fleet_fenced_writes_total",
    "ray_tpu_fleet_coordinator_term", "ray_tpu_fleet_failovers_total",
    "ray_tpu_fleet_self_fences_total",
    # the AOT cache (item 6.3)
    "ray_tpu_aot_cache_events_total",
    # the flood harness, which belongs to the port's benchmark (item 1)
    "ray_tpu_flood_offered_rps", "ray_tpu_flood_goodput_rps", "ray_tpu_flood_responses_total",
}


def _names(mod):
    return {k: v for k, v in vars(mod).items()
            if k.isupper() and isinstance(v, str) and v.startswith("ray_tpu_")}


def test_catalog_names_are_the_reference_less_the_omissions():
    port, ref = _names(catalog), _names(ref_catalog)
    assert set(port.values()) == set(ref.values()) - OMITTED
    assert OMITTED <= set(ref.values())
    for const, name in port.items():
        assert ref[const] == name
    # every accessor the port keeps is the reference's
    port_fns = {k for k, v in vars(catalog).items() if callable(v) and not k.startswith("_")}
    assert {"set_queue_depth", "inc_superstep_updates", "add_h2d_bytes", "add_d2h_bytes",
            "set_program_flops", "sample_runtime_gauges",
            "record_iteration_throughput"} <= port_fns


def test_catalog_series_render_like_the_reference():
    """The same accessor calls on both catalogs scrape the same text."""

    def drive(cat, m, exporter):
        m.clear_registry()
        cat.set_queue_depth("feeder_out", 2)
        cat.set_requests_in_flight("sample_prefetcher", 3)
        cat.add_h2d_bytes("learn", 4096)
        cat.add_h2d_bytes("learn", 0)
        cat.add_d2h_bytes("replay_priorities", 128)
        cat.inc_superstep_updates(8)
        cat.observe_serve_batch("d", 5)
        cat.observe_serve_latency("d", 0.003)
        cat.set_fleet_size(2, draining=1)
        cat.inc_preemptions(drained=True)
        cat.inc_tree_op("sample", "device", 3)
        cat.inc_program_execution("superstep[X:4x2]")
        cat.add_program_device_seconds("superstep[X:4x2]", 0.25)
        cat.set_program_flops("superstep[X:4x2]", 1e6)
        cat.set_replay_occupancy("p", 10, 100, 4000, device=True)
        cat.record_iteration_throughput(env_steps=128, learn_steps=2, wall_s=0.5)
        text = exporter.format_prometheus()
        totals = (cat.h2d_bytes_by_path(), cat.d2h_bytes_by_path(),
                  cat.counter_total(cat.SUPERSTEP_UPDATES_TOTAL))
        m.clear_registry()
        return text, totals

    port = drive(catalog, metrics, metrics_exporter)
    ref = drive(ref_catalog, ref_metrics, ref_exporter)
    # the port's program FLOPs gauge says how it counts them
    assert port[1] == ref[1]
    strip = [ln for ln in port[0].splitlines() if not ln.startswith("# HELP ray_tpu_program_flops")]
    assert strip == [ln for ln in ref[0].splitlines()
                     if not ln.startswith("# HELP ray_tpu_program_flops")]


def _spans(seed=0, n=60):
    rng = np.random.default_rng(seed)
    names = ["rollout:sample", "sampler:collect", "prefetch:assemble", "prefetch:deliver",
             "feeder:transfer", "learn:transfer", "learn:nest", "learn:superstep",
             "device:superstep[P:8x2]", "recovery:checkpoint", "train:iteration",
             "requests:harvest"]
    out = []
    for i in range(n):
        start = float(rng.uniform(0.0, 10.0))
        end = start + float(rng.exponential(0.8)) if i % 7 else None
        out.append({"name": names[i % len(names)], "start": start, "end": end,
                    "span_id": f"s{i}", "parent_id": None, "trace_id": "t",
                    "pid": 1 + i % 2, "tid": i % 3, "attributes": {}})
    return out


@pytest.mark.parametrize("window", [(0.0, 10.0), (2.5, 6.0), (9.0, 9.5), (11.0, 12.0)])
def test_rollup_bitwise_the_reference(window):
    spans = _spans()
    late = _spans(seed=1, n=12)
    for args in ((spans, *window), (spans, *window, late)):
        assert rollup.iteration_rollup(*args) == ref_rollup.iteration_rollup(*args)
    assert telemetry.STAGE_PREFIXES == ref_rollup.STAGE_PREFIXES
    ivs = [(s["start"], s["end"] or s["start"]) for s in spans]
    merged = rollup.merge_intervals(ivs)
    assert merged == ref_rollup.merge_intervals(ivs)
    other = rollup.merge_intervals(ivs[::3])
    assert rollup.intersect(merged, other) == ref_rollup.intersect(merged, other)
    assert rollup.late_stage_times(late) == ref_rollup.late_stage_times(late)


def test_rollup_primitives_and_overlap():
    assert rollup.merge_intervals([(0, 2), (1, 3), (5, 6), (6, 7), (9, 9)]) == [(0, 3), (5, 7)]
    assert rollup.intersect([(0, 3), (5, 7)], [(2, 6)]) == [(2, 3), (5, 6)]
    spans = [{"name": "rollout:sample", "start": 0.0, "end": 6.0},
             {"name": "learn:nest", "start": 5.0, "end": 8.0}]
    r = rollup.iteration_rollup(spans, 0.0, 10.0)
    assert r["overlap_fraction"] == pytest.approx(1.0 / 3.0)
    assert rollup.iteration_rollup(spans, 0.0, 1.0)["overlap_fraction"] == 0.0


def test_config_telemetry_knobs():
    from ray_tpu.algorithms.ppo import PPOConfig as RefPPOConfig
    from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig

    assert PPOConfig().telemetry_config == {} == RefPPOConfig().telemetry_config
    kw = dict(metrics_port=0, trace=True, device_ledger="light", profile_iters=2,
              peak_flops=1e12)
    assert (PPOConfig().telemetry(**kw).telemetry_config
            == RefPPOConfig().telemetry(**kw).telemetry_config)
    with pytest.raises(NotImplementedError, match="item 7"):
        PPOConfig().telemetry(fleetview=True)
    with pytest.raises(TypeError):
        PPOConfig().telemetry(no_such_knob=1)
    assert telemetry.init_from_config({}) is None


def test_runtime_one_per_process_and_scrape():
    rt = telemetry.init(metrics_port=0)
    assert telemetry.enabled() and telemetry.runtime() is rt and device_ledger.enabled()
    again = telemetry.init_from_config({"telemetry_config": {"trace": True}})
    assert again is rt and rt.trace and tracing.is_enabled()
    catalog.set_queue_depth("learner_in", 3)
    blob = urllib.request.urlopen(f"http://127.0.0.1:{rt.metrics_port}/metrics",
                                  timeout=10).read().decode()
    assert 'ray_tpu_queue_depth{queue="learner_in"} 3.0' in blob
    assert blob == metrics_exporter.format_prometheus()
    rt.shutdown()
    assert not telemetry.enabled() and not tracing.is_enabled()


def test_ingress_metrics_route_answers_200():
    from ray_tpu_torch.ingress.http import PolicyIngress

    catalog.inc_ingress_request("actions", 200)
    ingress = PolicyIngress()
    status, headers, payload = asyncio.run(ingress._dispatch("GET", "/metrics", b""))
    assert status == 200 and dict(headers)["Content-Type"].startswith("text/plain")
    assert 'ray_tpu_ingress_requests_total{route="actions",status="200"}' in payload.decode()


def test_telemetry_off_records_nothing():
    from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig

    assert PPOConfig().telemetry_config == {}
    assert not tracing.is_enabled() and not device_ledger.enabled()
    with tracing.start_span("learn:nest") as sp:
        sp.set_attribute("k", "v")  # a no-op on the null span
    tracing.event("worker:dead")
    tracing.record_span("learner:queue_wait", 0.0, 1.0)
    assert tracing.inject_context() is None
    ex = device_ledger.begin("x", "cpu")
    device_ledger.end(ex)
    device_ledger.drain_point()
    assert ex is None and tracing.get_spans() == []
    assert device_ledger.snapshot()["programs"] == []


# -- end to end, the reference's tests/test_telemetry.py e2e ------------------


REF_TELEMETRY_KEYS = (
    set(ref_rollup.iteration_rollup([], 0.0, 1.0))
    | {"window_iterations_ago", "env_steps_per_s", "learn_steps_per_s", "compile_traces",
       "compile_recompiles", "compile_time_s", "jax_live_buffers", "h2d_bytes",
       "rollout_lane", "replay", "superstep"}
)


def test_ppo_telemetry_end_to_end(tmp_path):
    """``telemetry(metrics_port=0, trace=True)`` on PPO with one remote
    worker, prefetch and K = 2: ``info/telemetry`` has the reference's
    keys, ``info/device_ledger`` the superstep program, the scrape its
    series, and the timeline spans from two processes, two driver
    threads and the device lanes."""
    from ray_tpu_torch import core
    from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig

    torch.set_num_threads(1)
    if core.is_initialized():
        core.shutdown()
    cfg = (
        PPOConfig()
        .environment("CartPole-v1")
        .rollouts(num_rollout_workers=1, rollout_fragment_length=64, sample_prefetch=1)
        .training(train_batch_size=128, sgd_minibatch_size=64, num_sgd_iter=2, lr=3e-4,
                  superstep=2, model={"fcnet_hiddens": [16, 16], "dtype": "float32"})
        .debugging(seed=0)
        .resources(device="cpu")
        .telemetry(metrics_port=0, trace=True)
    )
    algo = cfg.build()
    try:
        results = [algo.train() for _ in range(3)]
        result = results[-1]
        tel = result["info"]["telemetry"]
        assert set(tel) == REF_TELEMETRY_KEYS
        # the worker's spans ride its replies: an iteration that only
        # learned prefetched batches rolls up the previous window
        assert tel["learn_s"] > 0
        assert any(r["info"]["telemetry"]["sample_s"] > 0 for r in results)
        assert tel["window_iterations_ago"] in (0, 1)
        assert 0.0 <= tel["overlap_fraction"] <= 1.0
        assert tel["superstep"]["updates"] > 0
        assert set(tel["rollout_lane"]) == {"backend", "env_steps", "h2d_bytes"}
        assert tel["h2d_bytes"]["total"] == sum(
            v for k, v in tel["h2d_bytes"].items() if k != "total")

        ledger = result["info"]["device_ledger"]
        sup = next(p for p in ledger["programs"] if p["label"].startswith("superstep["))
        assert sup["flops"] > 0 and sup["bytes_accessed"] > 0
        assert sup["executions"] >= 1 and sup["device_time_s"] > 0
        assert sup["mfu"] is not None and sup["mfu"] > 0
        assert ledger["totals"]["mfu"] is not None and ledger["peak_flops_per_device"] > 0

        blob = urllib.request.urlopen(
            f"http://127.0.0.1:{algo._telemetry.metrics_port}/metrics", timeout=10
        ).read().decode()
        for series in ("ray_tpu_env_steps_per_s", "ray_tpu_learn_steps_per_s",
                       'ray_tpu_queue_depth{queue="feeder_out"}',
                       'ray_tpu_requests_in_flight{manager="sample_prefetcher"}',
                       "ray_tpu_program_executions_total", "ray_tpu_program_device_seconds_total",
                       "ray_tpu_program_flops", "ray_tpu_rollout_workers"):
            assert series in blob, series

        # the whole run: under load the last iterations may learn only
        # batches sampled before them
        path = algo.export_timeline(str(tmp_path / "run.json"))
        events = json.load(open(path))["traceEvents"]
        x = [e for e in events if e["ph"] == "X"]
        last = json.load(open(algo.export_timeline(str(tmp_path / "last.json"), last_n=1)))
        last_x = [e for e in last["traceEvents"] if e["ph"] == "X"]
        assert 0 < len(last_x) < len(x)
        assert min(e["ts"] + e["dur"] for e in last_x) >= algo._iteration_marks[-1] * 1e6 - 1
        names = {e["name"] for e in x}
        assert {"rollout:sample", "sampler:collect", "prefetch:assemble", "feeder:transfer",
                "learn:superstep", "train:iteration", "actor:RolloutWorker.sample"} <= names
        assert any(n.startswith("device:superstep[") for n in names)
        assert len({e["pid"] for e in x}) >= 2
        driver_pid = next(e["pid"] for e in x if e["name"] == "learn:superstep")
        assert len({e["tid"] for e in x if e["pid"] == driver_pid
                    and not e["name"].startswith("device:")}) >= 2
        assert all(e["dur"] >= 0 for e in x)
    finally:
        algo.stop()
        core.shutdown()
