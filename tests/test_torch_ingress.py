"""The port's front door (``ray_tpu_torch/ingress``) on the CPU: the
reference's ``tests/test_ingress.py`` as port counterparts.

- the shared queue-wait accessor: ``stats()`` and the router's shedding
  signal read the same numbers;
- the router: any merge order of a fixed-seed stream onto one replica is
  bitwise the same as sequential batch-1 ``compute_actions`` (actions and
  extras, two chunkings); concurrent clients merge into multi-row
  buckets with no program built after warmup; requests past their
  deadline are dropped before dispatch; a replica that dies mid-dispatch
  is marked dead and its bucket re-queued onto the survivor (greedy
  parity through the failover); the membership feed is followed;
- admission, exactly the reference's decisions on the same sequence of
  calls: the in-flight budget (429), quotas (429 ``quota``), queue-wait
  shedding (503 with a Retry-After of twice the wait, the signal cached
  between polls), dead-on-arrival refusal (504);
- HTTP over real sockets: POST bitwise against sequential calls,
  keep-alive, ``/healthz``, ``/metrics`` answering 200 with the
  process's exposition (the ingress counters among its series),
  404 and 405; concurrent socket clients coalescing; an overload burst
  answered 429/503 with Retry-After and a bounded admitted queue; the
  ASGI 3 app over the same dispatch;
- the front door over the serve core's replica actors
  (``serve_deployment``): routed buckets through ``handle_rows``, the
  membership feed followed through a rescale to two replicas;
- ``-m slow``: the batched front door against the per-request HTTP proxy
  at 32 clients of another process, both warmed: the same greedy actions
  and the reference's bar of at least 4x the requests/s. It fails on the
  CPU: both paths sit at the load generator's own rate, 960-1,140
  requests/s with a 16x16 MLP (ROADMAP.md queue 3).
"""

from __future__ import annotations

import asyncio
import http.client
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig, PPOTorchPolicy
from ray_tpu_torch.env.spaces import Box, Discrete
from ray_tpu_torch.ingress import (
    AdmissionController,
    CoalescingRouter,
    DeadlineExpired,
    LocalReplica,
    PolicyIngress,
)
from ray_tpu_torch.resilience.discovery import MembershipFeed
from ray_tpu_torch.serve.long_poll import LongPollHost
from ray_tpu_torch.serve.policy_server import BatchedPolicyServer

OBS = Box(-1.0, 1.0, (4,), np.float32)


def _policy(seed=7):
    cfg = PPOConfig().to_dict()
    cfg.update(seed=seed, model={"fcnet_hiddens": [16, 16]})
    return PPOTorchPolicy(OBS, Discrete(2), cfg, device="cpu")


def _server(seed=7, name="policy", **kw):
    kw.setdefault("max_batch_size", 8)
    kw.setdefault("batch_wait_timeout_s", 0.002)
    kw.setdefault("explore", True)
    srv = BatchedPolicyServer(_policy(seed), name=name, start=False, **kw)
    srv.warmup()
    srv.start()
    return srv


def _obs(n, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 4)).astype(np.float32)


def _post(url, payload, timeout=30.0):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def test_queue_wait_shared_accessor_pins_stats():
    server = _server()
    try:
        for o in _obs(9):
            server.submit(o).result(30.0)
        st = server.stats()
        qw = server.queue_wait_window()
        assert st["queue_wait_p50_s"] == qw["p50_s"] and st["queue_wait_p99_s"] == qw["p99_s"]
        assert st["latency_p50_s"] == server.latency_window()["p50_s"]
        assert qw["p50_s"] is not None and qw["n"] == 9
        router = CoalescingRouter("pin", [LocalReplica(server)], start=False)
        assert router.queue_wait_signal() == qw["p50_s"]
    finally:
        server.stop()


# -- the router ----------------------------------------------------------------------


def test_router_coalescing_bitwise_parity():
    obs = _obs(13, seed=1)
    ref = _policy()
    refs = [ref.compute_actions(o[None], explore=True) for o in obs]
    for chunks in ([1, 5, 7], [2] * 6 + [1]):
        server = _server()
        router = CoalescingRouter("parity", [LocalReplica(server)], max_batch_size=8,
                                  batch_wait_timeout_s=0.002)
        try:
            futs, i = [], 0
            for c in chunks:
                futs += [router.submit(o, explore=True) for o in obs[i:i + c]]
                i += c
                time.sleep(0.02)
            outs = [f.result(30.0) for f in futs]
        finally:
            router.stop()
            server.stop()
        for i, (a_ref, _, ex_ref) in enumerate(refs):
            assert outs[i]["action"].tobytes() == a_ref[0].tobytes(), (chunks, i)
            for k, v in ex_ref.items():
                assert outs[i]["extra"][k].tobytes() == v[0].tobytes(), (chunks, i, k)
        assert server.stats()["captures_after_warmup"] == 0


def test_router_merges_concurrent_requests():
    server = _server(explore=False, max_batch_size=16)
    router = CoalescingRouter("merge", [LocalReplica(server)], max_batch_size=16,
                              batch_wait_timeout_s=0.02)
    obs = _obs(48, seed=2)
    try:
        def client(rows):
            for o in rows:
                router.submit(o, explore=False).result(30.0)

        threads = [threading.Thread(target=client, args=(obs[i::8],)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        st = router.stats()
        assert st["merged_rows_total"] == 48
        assert st["batches_total"] < 48 and st["mean_merged_rows"] > 1.0
        assert server.stats()["captures_after_warmup"] == 0
    finally:
        router.stop()
        server.stop()


def test_router_deadline_expiry_drops_before_dispatch():
    server = _server()
    served0 = server.requests_total
    router = CoalescingRouter("deadline", [LocalReplica(server)], max_batch_size=8,
                              batch_wait_timeout_s=0.25)
    try:
        futs = [router.submit(o, explore=True, deadline_s=0.01) for o in _obs(3)]
        for f in futs:
            with pytest.raises(DeadlineExpired):
                f.result(30.0)
        assert router.expired_total == 3
        assert server.requests_total == served0  # never dispatched
        out = router.submit(_obs(1)[0], explore=True, deadline_s=30.0).result(30.0)
        assert "action" in out
    finally:
        router.stop()
        server.stop()


def test_router_routes_around_a_dead_replica():
    class DiesOnFinish:
        name = "corpse"

        def __init__(self):
            self.dead = False
            self.begun = 0

        def begin(self, rows, explore):
            self.begun += len(rows)
            return list(rows)

        def finish(self, token, timeout_s):
            raise RuntimeError("replica actor died")

        def alive(self):
            return not self.dead

        def queue_wait_p50_s(self):
            return None

    server = _server(explore=False)
    corpse = DiesOnFinish()
    router = CoalescingRouter("failover", [corpse, LocalReplica(server, name="survivor")],
                              max_batch_size=4, batch_wait_timeout_s=0.002)
    try:
        obs = _obs(8, seed=3)
        outs = [f.result(30.0) for f in [router.submit(o, explore=False) for o in obs]]
        assert corpse.dead and router.num_dead() == 1
        assert router.rerouted_total >= corpse.begun > 0
        ref = _policy()
        for i, o in enumerate(obs):
            a_ref, _, _ = ref.compute_actions(o[None], explore=False)
            assert outs[i]["action"] == a_ref[0]
    finally:
        router.stop()
        server.stop()


def test_router_follows_the_membership_feed():
    host = LongPollHost()
    feed = MembershipFeed(host, "replicas:feedtest")
    s1, s2 = _server(name="feed1"), _server(name="feed2")
    host.notify("replicas:feedtest", [s1])
    router = CoalescingRouter("feedtest", membership=feed, max_batch_size=4,
                              batch_wait_timeout_s=0.002)
    try:
        assert router.num_replicas() == 1
        assert "action" in router.submit(_obs(1)[0], explore=True).result(30.0)
        host.notify("replicas:feedtest", [s1, s2])
        assert feed.wait_changed(1, timeout=1.0) == (2, [s1, s2])
        deadline = time.time() + 5
        while time.time() < deadline and router.num_replicas() != 2:
            router.submit(_obs(1)[0], explore=True).result(30.0)
        assert router.num_replicas() == 2
    finally:
        router.stop()
        s1.stop()
        s2.stop()


# -- admission against the reference -------------------------------------------------


def _decisions(ctrl, calls):
    out = []
    for op, kw in calls:
        if op == "admit":
            d = ctrl.try_admit(**kw)
            out.append(None if d is None else (d.status, d.reason, d.retry_after_s))
        else:
            ctrl.release(**kw)
    st = ctrl.stats()
    return out, {k: st[k] for k in ("inflight", "admitted_total", "shed_total", "policy_inflight")}


def test_admission_decisions_equal_the_reference():
    from ray_tpu.ingress.admission import AdmissionController as Ref

    calls = ([("admit", {})] * 3 + [("release", {}), ("admit", {}), ("admit", {"deadline_s": 0.0}),
             ("admit", {"deadline_s": -1.0}), ("release", {})]
             + [("admit", {"policy": "a"})] * 3 + [("admit", {"policy": "b"}),
                                                  ("release", {"policy": "a"}),
                                                  ("admit", {"policy": "a"})])
    for kw in ({"max_inflight": 2}, {"max_inflight": 5, "quotas": {"a": 2}},
               {"max_inflight": 8, "default_quota": 1}):
        assert _decisions(AdmissionController(**kw), calls) == _decisions(Ref(**kw), calls), kw
    # the in-flight budget's 429, then admitting again after a release
    ctrl = AdmissionController(max_inflight=2)
    assert ctrl.try_admit() is None and ctrl.try_admit() is None
    d = ctrl.try_admit()
    assert (d.status, d.reason) == (429, "inflight") and d.retry_after_s > 0
    ctrl.release()
    assert ctrl.try_admit() is None
    with ctrl.admit() as a:
        assert not a.admitted
    assert ctrl.num_inflight() == 2


def test_admission_queue_wait_shed_and_dead_on_arrival():
    from ray_tpu.ingress.admission import AdmissionController as Ref

    calls = []

    def signal():
        calls.append(1)
        return 2.0

    for cls in (AdmissionController, Ref):
        ctrl = cls(max_inflight=100, shed_queue_wait_s=0.5, wait_signal=signal,
                   signal_interval_s=60.0)
        d1, d2 = ctrl.try_admit(), ctrl.try_admit()
        assert d1.status == d2.status == 503 and d1.reason == "queue_wait"
        assert d1.retry_after_s == pytest.approx(4.0)
    assert len(calls) == 2  # one signal read per controller: cached between polls
    assert AdmissionController(shed_queue_wait_s=0.5, wait_signal=lambda: 0.01).try_admit() is None
    d = AdmissionController().try_admit(deadline_s=0.0)
    assert (d.status, d.reason) == (504, "deadline")


# -- the HTTP/ASGI front door over real sockets ------------------------------------------


def test_http_ingress_socket_end_to_end():
    server = _server()
    router = CoalescingRouter("cartpole", [LocalReplica(server)], max_batch_size=8,
                              batch_wait_timeout_s=0.002)
    ingress = PolicyIngress().start()
    ingress.add_policy("cartpole", router)
    url = ingress.url + "/v1/policy/cartpole/actions"
    try:
        obs = _obs(9, seed=4)
        outs = []
        for o in obs:
            status, out = _post(url, {"obs": o.tolist()})
            assert status == 200
            outs.append(out)
        ref = _policy()
        for i, o in enumerate(obs):
            a_ref, _, ex_ref = ref.compute_actions(o[None], explore=True)
            assert int(outs[i]["action"]) == int(a_ref[0])
            assert np.float32(outs[i]["logp"]) == ex_ref["action_logp"][0]
            assert outs[i]["params_version"] == 1
        conn = http.client.HTTPConnection(ingress.host, ingress.port, timeout=30)
        for _ in range(2):  # keep-alive: two requests on one connection
            conn.request("POST", "/v1/policy/cartpole/actions",
                         body=json.dumps({"obs": obs[0].tolist()}),
                         headers={"Content-Type": "application/json", "x-ray-tpu-trace": "t1"})
            resp = conn.getresponse()
            assert resp.status == 200 and resp.getheader("x-ray-tpu-trace") == "t1"
            resp.read()
        conn.close()
        with urllib.request.urlopen(ingress.url + "/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["policies"]["cartpole"]["replicas"] == 1
        with urllib.request.urlopen(ingress.url + "/metrics", timeout=10) as r:
            assert r.status == 200
            scrape = r.read().decode()
        assert 'ray_tpu_ingress_requests_total{route="actions",status="200"}' in scrape
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(ingress.url + "/v1/policy/nope/actions", {"obs": [0, 0, 0, 0]})
        assert ei.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url, timeout=10)
        assert ei.value.code == 405
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, {"nobs": 1})
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, {"obs": obs[0].tolist(), "deadline_ms": 0})
        assert ei.value.code == 504
    finally:
        ingress.stop()
        router.stop()
        server.stop()


def test_http_ingress_coalesces_concurrent_clients():
    server = _server(explore=False, max_batch_size=16)
    router = CoalescingRouter("cartpole", [LocalReplica(server)], max_batch_size=16,
                              batch_wait_timeout_s=0.02)
    ingress = PolicyIngress().start()
    ingress.add_policy("cartpole", router)
    obs = _obs(32, seed=5)
    try:
        results = [None] * len(obs)

        def client(idxs):
            for i in idxs:
                results[i] = _post(ingress.url + "/v1/policy/cartpole/actions",
                                   {"obs": obs[i].tolist()})[1]

        threads = [threading.Thread(target=client, args=(range(i, 32, 8),)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert router.stats()["mean_merged_rows"] > 1.0
        assert server.stats()["captures_after_warmup"] == 0
        ref = _policy()
        for i, o in enumerate(obs):
            assert results[i]["action"] == int(ref.compute_actions(o[None], explore=False)[0][0])
    finally:
        ingress.stop()
        router.stop()
        server.stop()


def test_http_ingress_overload_sheds_429_503():
    class Slow:
        name = "slow"
        dead = False

        def __init__(self, server):
            self.server = server

        def begin(self, rows, explore):
            return self.server.submit_many(rows, explore=explore)

        def finish(self, token, timeout_s):
            time.sleep(0.15)  # a slow forward
            return LocalReplica(self.server).finish(token, timeout_s)

        def alive(self):
            return True

        def queue_wait_p50_s(self):
            return None

    server = _server(explore=False)
    router = CoalescingRouter("cartpole", [Slow(server)], max_batch_size=4,
                              batch_wait_timeout_s=0.001, dispatch_workers=1)
    ingress = PolicyIngress(max_inflight=4).start()
    ingress.add_policy("cartpole", router)
    statuses, retry_after = [], []
    lock = threading.Lock()
    try:
        def client():
            try:
                status, _ = _post(ingress.url + "/v1/policy/cartpole/actions",
                                  {"obs": [0.0, 0.0, 0.0, 0.0]}, timeout=60.0)
            except urllib.error.HTTPError as e:
                with lock:
                    statuses.append(e.code)
                    if e.headers.get("Retry-After"):
                        retry_after.append(int(e.headers["Retry-After"]))
                return
            with lock:
                statuses.append(status)

        threads = [threading.Thread(target=client) for _ in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        served = statuses.count(200)
        shed = [s for s in statuses if s in (429, 503)]
        assert served >= 1 and len(shed) >= 1, statuses
        assert len(retry_after) == len(shed) and all(r >= 1 for r in retry_after)
        assert served + len(shed) == 24
        st = ingress.stats()["policies"]["cartpole"]
        assert st["admission"]["shed_total"]["inflight"] >= 1
        assert st["admission"]["max_inflight"] == 4
    finally:
        ingress.stop()
        router.stop()
        server.stop()


def test_asgi_app_contract():
    server = _server()
    router = CoalescingRouter("cartpole", [LocalReplica(server)], max_batch_size=8,
                              batch_wait_timeout_s=0.002)
    ingress = PolicyIngress()  # not started: no socket
    ingress.add_policy("cartpole", router)
    app = ingress.asgi_app()

    async def call(method, path, body=b""):
        sent = []
        received = [{"type": "http.request", "body": body, "more_body": False}]

        async def receive():
            return received.pop(0)

        async def send(msg):
            sent.append(msg)

        await app({"type": "http", "method": method, "path": path}, receive, send)
        return sent[0]["status"], json.loads(b"".join(m.get("body", b"") for m in sent[1:]))

    async def lifespan():
        msgs = [{"type": "lifespan.startup"}, {"type": "lifespan.shutdown"}]
        sent = []

        async def receive():
            return msgs.pop(0)

        async def send(msg):
            sent.append(msg["type"])

        await app({"type": "lifespan"}, receive, send)
        return sent

    loop = asyncio.new_event_loop()
    try:
        assert loop.run_until_complete(lifespan()) == [
            "lifespan.startup.complete", "lifespan.shutdown.complete"]
        status, health = loop.run_until_complete(call("GET", "/healthz"))
        assert status == 200 and health["status"] == "ok"
        obs = _obs(1, seed=6)[0]
        status, out = loop.run_until_complete(
            call("POST", "/v1/policy/cartpole/actions", json.dumps({"obs": obs.tolist()}).encode()))
        assert status == 200
        assert out["action"] == int(_policy().compute_actions(obs[None], explore=True)[0][0])
        status, _ = loop.run_until_complete(call("POST", "/v1/policy/cartpole/actions", b"{}"))
        assert status == 400
    finally:
        loop.close()
        router.stop()
        server.stop()


# -- the front door over replica actors ------------------------------------------------


def _cartpole_checkpoint(tmp_path):
    from ray_tpu_torch.algorithms.ppo.ppo import PPO

    algo = PPO(config={"env": "CartPole-v1", "seed": 7, "num_workers": 0,
                       "train_batch_size": 64, "sgd_minibatch_size": 32, "num_sgd_iter": 1,
                       "model": {"fcnet_hiddens": [16, 16]}, "device": "cpu"})
    root = str(tmp_path / "ckpts")
    try:
        algo.save(os.path.join(root, "checkpoint_000001"))
    finally:
        algo.stop()
    return root


def test_ingress_fronts_serve_deployment_actors(tmp_path):
    from ray_tpu_torch import core
    from ray_tpu_torch.serve import serve
    from ray_tpu_torch.serve.policy_server import policy_deployment, restore_policy

    root = _cartpole_checkpoint(tmp_path)
    core.shutdown()
    core.init(num_cpus=1)
    ingress = None
    try:
        serve.run(policy_deployment(root, name="cartpole", watch=False, device="cpu"))
        ingress = PolicyIngress().start()
        ingress.serve_deployment("cartpole", max_batch_size=8, batch_wait_timeout_s=0.01)
        url = ingress.url + "/v1/policy/cartpole/actions"
        obs = _obs(6, seed=7)
        outs = [_post(url, {"obs": o.tolist()}, timeout=120.0)[1] for o in obs]
        local = restore_policy(root, device="cpu")[0]
        for o, out in zip(obs, outs):
            assert out["action"] == int(local.compute_actions(o[None], explore=False)[0][0])
            assert out["params_version"] == 1 and "logp" in out
        st = ingress.stats()["policies"]["cartpole"]["router"]
        assert st["replicas"] == 1 and st["merged_rows_total"] == 6
        serve.update_deployment("cartpole", num_replicas=2)
        deadline = time.time() + 60
        n_now = 1
        while time.time() < deadline and n_now < 2:
            assert _post(url, {"obs": obs[0].tolist()}, timeout=120.0)[0] == 200
            n_now = ingress.stats()["policies"]["cartpole"]["router"]["replicas"]
        assert n_now == 2
    finally:
        if ingress is not None:
            ingress.stop()
        serve.shutdown()
        core.shutdown()


@pytest.mark.slow
def test_ingress_throughput_vs_per_request_http_slow(tmp_path):
    """The batched front door over an in-process replica against the
    per-request HTTP proxy (one replica-actor call a request) at 32
    clients of another process (``tests/_torch_http_load.py``): at least
    4x the requests/s and the same greedy actions."""
    import subprocess
    import sys

    from ray_tpu_torch import core
    from ray_tpu_torch.serve import serve
    from ray_tpu_torch.serve.policy_server import PolicyDeployment, policy_deployment

    obs_path = str(tmp_path / "obs.npy")
    np.save(obs_path, _obs(512, seed=8))
    load = os.path.join(os.path.dirname(__file__), "_torch_http_load.py")

    def sweep(url):
        out_path = str(tmp_path / "out.json")
        subprocess.run([sys.executable, load, url, "32", obs_path, out_path], check=True,
                       timeout=600)
        with open(out_path) as f:
            out = json.load(f)
        return out["rps"], out["results"]

    root = _cartpole_checkpoint(tmp_path)
    dep = PolicyDeployment(root, name="cartpole", max_batch_size=32, watch=False, device="cpu")
    router = CoalescingRouter("cartpole", [LocalReplica(dep)], max_batch_size=32,
                              batch_wait_timeout_s=0.005)
    ingress = PolicyIngress().start()
    ingress.add_policy("cartpole", router)
    try:
        batched_rps, batched = sweep(ingress.url + "/v1/policy/cartpole/actions")
        assert dep.stats()["captures_after_warmup"] == 0
    finally:
        ingress.stop()
        router.stop()
        dep.stop()
    core.shutdown()
    core.init(num_cpus=1)
    try:
        serve.run(policy_deployment(root, name="cartpole_naive", max_batch_size=1, watch=False,
                                    device="cpu"), http_host="127.0.0.1")
        naive_rps, naive = sweep(f"http://127.0.0.1:{serve.http_port()}/cartpole_naive")
    finally:
        serve.shutdown()
        core.shutdown()
    assert [int(b["action"]) for b in batched] == [int(n["action"]) for n in naive]
    assert batched_rps >= 4.0 * naive_rps, (batched_rps, naive_rps)
