"""The port's span tracing (``ray_tpu_torch/util/tracing.py``) against
the reference's (``ray_tpu/util/tracing.py``), on the CPU.

- one span list through both packages' chrome exports, a child whose
  clock runs ahead of its parent's and one whose parent is not in the
  list among them: equal event for event, ``since`` windows too;
- span records: the reference's keys, parentage under ``start_span``,
  ``event`` and ``record_span``, and a thread's id as its lane;
- the boundary plumbing of ``core/``: ``inject_context`` on the driver,
  ``remote_span`` on the worker (which turns tracing on for the call's
  own spans), ``drain_finished`` onto the reply, ``record_spans`` back;
- ``context_span`` on the serving path: the client's trace id, and the
  null span while tracing is off;
- the buffer bound (``RAY_TPU_TRACE_BUFFER``) drops the oldest spans.
"""

import json
import threading
import time

import pytest

from ray_tpu.util import tracing as ref_tracing
from ray_tpu_torch.util import tracing


@pytest.fixture(autouse=True)
def _clean():
    for t in (tracing, ref_tracing):
        t.disable()
        t.clear()
    yield
    for t in (tracing, ref_tracing):
        t.disable()
        t.clear()


def _span(name, sid, parent, start, end, pid=1, tid=7, attrs=None):
    return {"trace_id": "t0", "span_id": sid, "parent_id": parent, "name": name,
            "start": start, "end": end, "attributes": dict(attrs or {}), "pid": pid,
            "tid": tid, "thread_name": f"lane{tid}"}


SPANS = [
    _span("train:iteration", "a", None, 100.0, 110.0),
    _span("requests:submit", "b", "a", 100.5, 100.6, attrs={"submitted": 2}),
    # a worker whose clock runs 3 s ahead: clamped into its parent
    _span("actor:RolloutWorker.sample", "c", "b", 103.0, 114.0, pid=2, tid=3),
    _span("rollout:sample", "d", "c", 104.0, 104.5, pid=2, tid=3, attrs={"env_steps": 64}),
    _span("learn:nest", "e", "a", 101.0, 101.0 + 2.5, tid=8),
    _span("device:learn[P:128]", "f", None, 101.1, 101.9, tid=0x0DE00001),
    _span("jit:recompile", "g", "a", 105.0, 105.0, attrs={"cause": "x: f32[1] -> f32[2]"}),
    # an end before its start, and a parent missing from the list
    _span("feeder:transfer", "h", "zz", 106.0, 105.5, tid=9, attrs={"nbytes": 4096}),
    _span("open", "i", "a", 107.0, None),
]


@pytest.mark.parametrize("since", [None, 104.2, 109.0])
def test_chrome_export_equals_the_reference(tmp_path, since):
    for t in (tracing, ref_tracing):
        t.enable()
        t.record_spans([dict(s, attributes=dict(s["attributes"])) for s in SPANS])
    port = json.load(open(tracing.export_chrome_trace(str(tmp_path / "p.json"), since=since)))
    ref = json.load(open(ref_tracing.export_chrome_trace(str(tmp_path / "r.json"), since=since)))
    assert port == ref
    ev = {e["name"]: e for e in port["traceEvents"] if e["ph"] == "X"}
    if since is None:
        # the skewed child ends inside its parent's parent
        assert ev["actor:RolloutWorker.sample"]["ts"] + ev["actor:RolloutWorker.sample"]["dur"] \
            <= ev["train:iteration"]["ts"] + ev["train:iteration"]["dur"]
        assert ev["feeder:transfer"]["dur"] == 0.0
    assert tracing._clamped_intervals(SPANS) == ref_tracing._clamped_intervals(SPANS)


def test_span_records_and_lanes(tmp_path):
    for t in (tracing, ref_tracing):
        t.enable()
        with t.start_span("train:iteration", iteration=1) as root:
            t.event("worker:dead", manager="m")
            t.record_span("learner:queue_wait", root.start, root.start + 0.001)
            with t.start_span("learn:nest") as child:
                child.set_attribute("deferred", False)
    port, ref = tracing.get_spans(), ref_tracing.get_spans()
    assert [sorted(s) for s in port] == [sorted(s) for s in ref]
    assert [s["name"] for s in port] == [s["name"] for s in ref]
    by = {s["name"]: s for s in port}
    root = by["train:iteration"]
    for name in ("worker:dead", "learner:queue_wait", "learn:nest"):
        assert by[name]["parent_id"] == root["span_id"]
        assert by[name]["trace_id"] == root["trace_id"]
    assert by["learn:nest"]["attributes"] == {"deferred": False}
    assert by["worker:dead"]["start"] == by["worker:dead"]["end"]

    def lane():
        with tracing.start_span("feeder:transfer", nbytes=8):
            time.sleep(0.001)

    th = threading.Thread(target=lane, name="device_feeder")
    th.start()
    th.join()
    events = json.load(open(tracing.export_chrome_trace(str(tmp_path / "t.json"))))["traceEvents"]
    x = {e["name"]: e for e in events if e["ph"] == "X"}
    assert x["feeder:transfer"]["tid"] != x["learn:nest"]["tid"]
    assert {"ph": "M", "name": "thread_name", "pid": x["feeder:transfer"]["pid"],
            "tid": x["feeder:transfer"]["tid"], "args": {"name": "device_feeder"}} in events


def test_boundary_plumbing_driver_to_worker_and_back():
    """What ``core/api.py`` and ``core/worker_proc.py`` do with a call,
    in one process: the worker side runs with tracing off, as a fresh
    worker process does, and the context turns it on for the call."""
    tracing.enable()
    with tracing.start_span("train:iteration") as root:
        ctx = tracing.inject_context()
    assert ctx == {"trace_id": root.trace_id, "parent_span_id": root.span_id}
    driver_spans = tracing.drain_finished()
    tracing.disable()
    with tracing.remote_span(ctx, "actor:RolloutWorker.sample") as call:
        with tracing.start_span("rollout:sample", worker_index=1):
            pass
    assert not tracing.is_enabled()
    shipped = tracing.drain_finished()
    assert [s["name"] for s in shipped] == ["rollout:sample", "actor:RolloutWorker.sample"]
    with tracing.remote_span(None, "actor:RolloutWorker.sample") as nothing:
        pass
    assert nothing is None and tracing.drain_finished() == []
    tracing.enable()
    tracing.record_spans(driver_spans + shipped)
    by = {s["name"]: s for s in tracing.get_spans()}
    assert by["actor:RolloutWorker.sample"]["parent_id"] == root.span_id
    assert by["rollout:sample"]["parent_id"] == call.span_id
    assert {s["trace_id"] for s in by.values()} == {root.trace_id}
    tracing.disable()
    assert tracing.inject_context() is None


def test_context_span_stitches_the_serving_path():
    with tracing.context_span({"trace_id": "client1", "parent_span_id": None}, "x") as sp:
        assert sp is tracing._NULL_SPAN
    tracing.enable()
    with tracing.context_span({"trace_id": "client1", "parent_span_id": None},
                              "ingress:request", policy="p") as ingress:
        ctx = tracing.inject_context()

    def dispatch():  # another thread: no contextvar parent
        with tracing.context_span(ctx, "router:dispatch", rows=2):
            pass

    th = threading.Thread(target=dispatch)
    th.start()
    th.join()
    with tracing.context_span(None, "serve:batch") as batch:
        pass
    by = {s["name"]: s for s in tracing.get_spans()}
    assert by["ingress:request"]["trace_id"] == "client1"
    assert by["router:dispatch"]["trace_id"] == "client1"
    assert by["router:dispatch"]["parent_id"] == ingress.span_id
    assert by["serve:batch"]["parent_id"] is None and batch.trace_id != "client1"


def test_buffer_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(tracing, "_MAX_SPANS", 5)
    tracing.enable()
    for i in range(8):
        tracing.event(f"e{i}")
    assert [s["name"] for s in tracing.get_spans()] == [f"e{i}" for i in range(3, 8)]
