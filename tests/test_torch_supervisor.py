"""The port's ingress bank (``ray_tpu_torch/ingress/supervisor.py``)
held to the reference supervisor's contracts
(``tests/test_ingress_supervisor.py``) on echo banks over real sockets:
answers from two worker processes over SO_REUSEPORT, a SIGKILLed worker
respawned with its membership replayed and the respawn counted, the
whole-bank drain to 503, the inherited-listener fallback with a
``worker_init`` closure over local state, a ``worker_init`` that raises
failing ``start()``; and the bank's merged ``/metrics`` byte for byte
equal to the reference's ``FleetAggregator`` over the snapshots the
port's supervisor received.

Workers are spawned: the echo replica, its feed and its init live in
``tests/_torch_serve_probe.py``, which imports only the port, so a worker
imports no JAX. Two banks in all (one module-scoped), five worker
processes with the respawn.
"""

import json
import os
import signal
import socket
import time
import urllib.error
import urllib.request

import pytest

import _torch_serve_probe as probe
from ray_tpu_torch.ingress import IngressSupervisor
from ray_tpu_torch.telemetry import metrics as catalog
from ray_tpu_torch.utils import metrics as port_instruments


def _post(url, obs=(0.1, 0.2), timeout=10.0):
    req = urllib.request.Request(url, data=json.dumps({"obs": list(obs)}).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _scrape(url):
    with urllib.request.urlopen(url + "/metrics", timeout=5) as r:
        return r.read().decode()


def _bank(**kw):
    kw.setdefault("num_workers", 2)
    kw.setdefault("worker_init", probe.echo_worker_init)
    kw.setdefault("heartbeat_s", 0.1)
    kw.setdefault("metrics_interval_s", 0.3)
    sup = IngressSupervisor(**kw)
    sup.follow_membership("echo", feed=probe.StaticFeed())
    return sup


@pytest.fixture(scope="module")
def bank():
    port_instruments.clear_registry()
    sup = _bank()
    # every merged text the supervisor broadcasts, with the snapshots it
    # merged: the pump thread ingests and merges in turn, so no ingest
    # lands between the copy and the merge
    merges = sup._agg_record = []

    def start_recording(s):
        inner = s._agg.merged_exposition

        def recorded():
            with s._agg._lock:
                snaps = [dict(v) for v in s._agg._snaps.values()]
            text = inner()
            merges.append((snaps, text))
            del merges[:-200]
            return text

        s._agg.merged_exposition = recorded

    sup.start()
    start_recording(sup)
    yield sup
    sup.stop()


@pytest.mark.skipif(not hasattr(socket, "SO_REUSEPORT"), reason="kernel lacks SO_REUSEPORT")
def test_reuseport_spreads_across_worker_processes(bank):
    assert bank.stats()["reuseport"]
    url = bank.url + "/v1/policy/echo/actions"
    pids = set()
    for _ in range(60):
        status, out = _post(url)
        assert status == 200
        pids.add(out["action"])
    assert pids <= {p for p in bank.worker_pids() if p is not None}
    assert len(pids) >= 2, f"all requests served by one process: {pids}"


def test_merged_metrics_equal_the_reference_aggregator(bank):
    from ray_tpu.telemetry.fleetview import FleetAggregator as RefAggregator
    from ray_tpu.utils import metrics as ref_instruments

    url = bank.url + "/v1/policy/echo/actions"
    for _ in range(20):
        assert _post(url)[0] == 200
    deadline = time.time() + 20
    text = ""
    while time.time() < deadline:
        text = _scrape(bank.url)
        if 'host="ingress-w0"' in text and 'host="ingress-w1"' in text:
            break
        time.sleep(0.2)
    assert 'host="ingress-w0"' in text and 'host="ingress-w1"' in text
    # the request counters of both workers are in it, each under its host
    assert 'ray_tpu_ingress_requests_total{host="ingress-w0",route="actions",status="200"}' in text
    assert 'ray_tpu_ingress_requests_total{host="ingress-w1",route="actions",status="200"}' in text
    matches = [snaps for snaps, t in list(bank._agg_record) if t == text]
    assert matches, "the scraped text is none of the supervisor's merges"
    snaps = matches[-1]
    assert sorted(s["host"] for s in snaps) == ["ingress-w0", "ingress-w1"]
    ref_instruments.clear_registry()
    ref = RefAggregator(kv=None, subscribe=False)
    for snap in sorted(snaps, key=lambda s: s["host"]):
        ref.ingest({k: v for k, v in snap.items() if k != "_recv_at"})
    assert ref.merged_exposition() == text
    ref_instruments.clear_registry()


def test_crash_respawn_replays_membership_and_counts(bank):
    url = bank.url + "/v1/policy/echo/actions"
    assert _post(url)[0] == 200
    before = catalog.counter_total(catalog.INGRESS_WORKER_RESPAWNS_TOTAL)
    victim = bank.worker_pids()[0]
    os.kill(victim, signal.SIGKILL)
    deadline = time.time() + 60
    while time.time() < deadline and (bank.respawned_total < 1 or bank.num_live() < 2
                                      or not bank._slots[0].ready):
        time.sleep(0.1)
    assert bank.respawned_total >= 1, "crash never respawned"
    assert bank.num_live() == 2 and bank._slots[0].ready
    assert catalog.counter_total(catalog.INGRESS_WORKER_RESPAWNS_TOTAL) == before + 1
    new_pid = bank.worker_pids()[0]
    assert victim != new_pid and victim not in bank.worker_pids()
    # the REPLACEMENT routes: its membership came from the supervisor's
    # replay, not from any client action; fresh connections reach it
    served = set()
    for _ in range(200):
        status, out = _post(url)
        assert status == 200
        served.add(out["action"])
        if new_pid in served:
            break
    assert new_pid in served, served


def test_drain_flips_the_whole_bank_to_503(bank):
    deadline = time.time() + 20
    ok = 0
    while time.time() < deadline and ok < 4:
        try:
            with urllib.request.urlopen(bank.url + "/healthz", timeout=5) as r:
                ok = ok + 1 if r.status == 200 else 0
        except urllib.error.HTTPError:
            ok = 0
        time.sleep(0.05)
    assert ok >= 4, "bank never became healthy"
    bank.drain(grace_s=5.0)
    assert bank.draining
    time.sleep(0.5)
    results = []
    for _ in range(8):  # fresh connections: both workers
        try:
            with urllib.request.urlopen(bank.url + "/healthz", timeout=5) as r:
                results.append((r.status, r.read()))
        except urllib.error.HTTPError as e:
            results.append((e.code, e.read()))
    assert [s for s, _ in results] == [503] * 8, results
    for _, body in results:
        assert json.loads(body)["status"] == "draining"


def test_inherited_listener_with_a_closure_worker_init():
    """force_inherited_listener: ONE listening socket bound by the
    supervisor, every worker accepting from its queue; the worker_init
    is a closure over this test's local state, carried by value."""
    offset = 10 ** 7
    tag = {"policy": "echo"}

    def init(ctx):
        from ray_tpu_torch.ingress import CoalescingRouter

        router = CoalescingRouter(tag["policy"], membership=ctx.membership("echo"),
                                  wrap=lambda m, i: probe.EchoPidReplica(i, offset),
                                  batch_wait_timeout_s=0.001)
        ctx.ingress.add_policy(tag["policy"], router)

    sup = _bank(force_inherited_listener=True, worker_init=init).start()
    try:
        assert not sup.stats()["reuseport"]
        url = sup.url + "/v1/policy/echo/actions"
        pids = set()
        for _ in range(30):
            status, out = _post(url)
            assert status == 200
            pids.add(out["action"] - offset)
        assert pids <= {p for p in sup.worker_pids() if p is not None}
        assert len(pids) >= 1  # shared accept queue: the kernel's pick
        boot = sup.worker_stats()
        for i in range(2):
            deadline = time.time() + 10
            while boot[i] is None and time.time() < deadline:
                time.sleep(0.1)
                boot = sup.worker_stats()
            b = boot[i]["boot"]
            assert b["spawned_at"] <= b["entered_at"] <= b["init_done_at"] <= b["ready_at"]
    finally:
        sup.stop()


def test_a_worker_init_that_raises_fails_start():
    sup = IngressSupervisor(num_workers=1, worker_init=probe.failing_worker_init)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="no card for this worker"):
        sup.start()
    assert time.monotonic() - t0 < 50
    assert sup.num_live() == 0
