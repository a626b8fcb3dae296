"""The port's serve core (``ray_tpu_torch/serve/serve.py``) over the
port's actor runtime, on the CPU: the reference's
``tests/test_serve_policy.py``, ``tests/test_serve_autoscale.py`` and
``tests/test_serve_composition.py`` serve-core cases as port
counterparts, with at most two replica actors alive per test.

- long-poll versions; a ``user_config`` push reaches the live replica
  without a restart (its request count carries over);
- queue-wait autoscaling: a hot queue wait (read from a file by the
  replicas) scales 1 → 2, a cold one back to 1; replica stats reach
  ``RunningDeployment.stats()``;
- the ledger signal: hot batch fill scales up only once the reported
  HBM headroom allows it; ``serve.autoscale`` retunes the running loop
  and validates its inputs;
- a killed replica: the handle routes around it (at most two calls
  fail), the controller's health pass replaces it, the republished
  membership clears the dead mark;
- a rescale reaches the handle by long poll;
- composition: a replica calls another deployment through the
  per-request HTTP proxy (``RAY_TPU_SERVE_HTTP``), end to end from an
  HTTP client; the controlling process's lookup returns the actor handle;
- a ``policy_deployment`` of a port checkpoint in a replica actor built
  with ``device="cpu"`` (the worker hides the card by default);
  ``worker_env`` keeps ``CUDA_VISIBLE_DEVICES`` as the caller gave it.

The deployment classes live in ``tests/_torch_serve_probe.py``, which
imports only the port, so a replica process imports no JAX.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

import _torch_serve_probe as probe
from ray_tpu_torch import core
from ray_tpu_torch.serve import serve
from ray_tpu_torch.serve.long_poll import LongPollHost


@pytest.fixture(scope="module")
def runtime():
    core.shutdown()
    core.init(num_cpus=1)
    yield
    serve.shutdown()
    core.shutdown()


@pytest.fixture(autouse=True)
def _serve_cleanup(runtime):
    yield
    serve.shutdown()


def _wait(pred, timeout=30.0, every=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline and not pred():
        time.sleep(every)
    return pred()


def test_long_poll_host_versions():
    host = LongPollHost()
    assert host.listen("k", 0, timeout=0.05) is None
    v1 = host.notify("k", "a")
    assert host.listen("k", 0, timeout=1.0) == (v1, "a")
    out = []
    t = threading.Thread(target=lambda: out.append(host.listen("k", v1, timeout=5.0)))
    t.start()
    time.sleep(0.1)
    v2 = host.notify("k", "b")
    t.join(timeout=5.0)
    assert out == [(v2, "b")]
    assert host.current("k") == (v2, "b") and host.current("none") == (0, None)


def test_user_config_push_without_restart_and_rescale():
    dep = serve.deployment(probe.Scaler, name="cfg", user_config={"scale": 2})
    handle = serve.run(dep.bind())
    assert core.get(handle.remote(10), timeout=60) == 20
    serve.update_deployment("cfg", user_config={"scale": 5})
    assert core.get(handle.remote(10), timeout=60) == 50
    running = serve.get_running("cfg")
    stats = core.get(running.replicas[0].stats.remote(), timeout=60)
    assert stats["num_requests"] >= 2 and stats["num_reconfigures"] >= 2
    # a rescale reaches the handle through the long poll, and the new
    # replica is born with the current user_config
    serve.update_deployment("cfg", num_replicas=2)
    assert _wait(lambda: handle.num_replicas() == 2, 10)
    assert sorted(core.get([handle.remote(1) for _ in range(4)], timeout=60)) == [5, 5, 5, 5]
    serve.update_deployment("cfg", num_replicas=1)
    assert _wait(lambda: handle.num_replicas() == 1, 10)
    assert serve.get_deployment("cfg") is handle


def test_queue_wait_autoscale_up_and_down(tmp_path):
    wait_file = str(tmp_path / "wait")
    with open(wait_file, "w") as f:
        f.write("0.5")  # a hot queue from the start
    dep = serve.deployment(
        probe.FakeQueueServer, name="qwait",
        autoscaling_config={
            "min_replicas": 1, "max_replicas": 2,
            # inflight cannot trigger anything: only the queue wait does
            "target_num_ongoing_requests_per_replica": 1e9,
            "target_queue_wait_s": 0.05, "upscale_delay_s": 0.1,
            "downscale_delay_s": 0.3, "interval_s": 0.1, "stats_timeout_s": 10.0,
        },
    )
    handle = serve.run(dep.bind(wait_file))
    assert handle.num_replicas() == 1
    assert _wait(lambda: handle.num_replicas() >= 2, 40), "no queue-wait upscale"
    agg = serve.get_running("qwait").stats()
    assert agg["queue_wait_p50_s_max"] == 0.5 and agg["num_replicas"] == 2
    with open(wait_file, "w") as f:
        f.write("0.001")  # cold: back down
    assert _wait(lambda: handle.num_replicas() == 1, 40), "no scale-down on a cold queue"


def test_ledger_signal_gates_on_headroom_and_retunes():
    dep = serve.deployment(
        probe.LedgerModel, name="ledger",
        user_config={"fill": 0.95, "headroom": 0.02},  # hot, but no room
        autoscaling_config={
            "min_replicas": 1, "max_replicas": 2, "signal": "queue_wait",
            "target_batch_fill": 0.8, "upscale_delay_s": 0.1, "downscale_delay_s": 0.3,
            "interval_s": 0.1, "stats_timeout_s": 10.0,
        },
    )
    handle = serve.run(dep.bind())
    with pytest.raises(ValueError):
        serve.autoscale("ledger", signal="vibes")
    with pytest.raises(ValueError):
        serve.autoscale("ledger", not_a_knob=1)
    time.sleep(0.6)  # the queue_wait source ignores the ledger
    assert handle.num_replicas() == 1
    assert serve.autoscale("ledger", signal="ledger")["signal"] == "ledger"
    time.sleep(1.0)  # hot fill, no headroom: no upscale
    assert handle.num_replicas() == 1, "upscaled into full memory"
    serve.update_deployment("ledger", user_config={"fill": 0.95, "headroom": 0.9})
    assert _wait(lambda: handle.num_replicas() >= 2, 30), "no upscale after headroom freed"
    serve.update_deployment("ledger", user_config={"fill": 0.1, "headroom": 0.9})
    assert _wait(lambda: handle.num_replicas() == 1, 30), "no downscale on a cold fill"
    assert serve.autoscale("ledger", target_batch_fill=0.99)["target_batch_fill"] == 0.99
    serve.run(serve.deployment(probe.Echo, name="static").bind())
    with pytest.raises(ValueError, match="without an autoscaler"):
        serve.autoscale("static", signal="ledger")


def test_handle_routes_around_a_dead_replica_and_the_controller_replaces_it():
    dep = serve.deployment(
        probe.Echo, name="routed",
        autoscaling_config={"min_replicas": 2, "max_replicas": 2,
                            "health_check_interval_s": 0.2, "interval_s": 0.1,
                            "stats_timeout_s": 10.0},
    )
    handle = serve.run(dep.bind())
    assert core.get(handle.remote(1), timeout=60) == 2
    running = serve.get_running("routed")
    core.kill(running.replicas[0])
    failures = 0
    for _ in range(8):
        try:
            assert core.get(handle.remote(1), timeout=60) == 2
        except core.RayActorError:
            failures += 1
    assert failures <= 2
    assert handle.num_dead() >= 1 or running.num_replaced >= 1
    for _ in range(4):
        assert core.get(handle.remote(1), timeout=60) == 2
    assert _wait(lambda: running.num_replaced >= 1, 30)
    assert _wait(lambda: handle.num_dead() == 0, 10)
    assert handle.num_replicas() == 2
    assert core.get(handle.remote(5), timeout=60) == 6


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def test_composition_through_the_http_proxy():
    """An HTTP client → chain's replica → the proxy → adder's replica
    (twice); the controlling process's lookup is the actor-routing handle."""
    serve.run(serve.deployment(probe.Adder, name="adder").bind(), http_host="127.0.0.1")
    handle = serve.run(serve.deployment(probe.Chain, name="chain").bind(), http_host="127.0.0.1")
    assert core.get(handle.remote({"x": 5}), timeout=60) == {"twice": 7}
    url = f"http://127.0.0.1:{serve.http_port()}"
    assert _post(url + "/chain", {"x": 1}) == {"result": {"twice": 3}}
    assert isinstance(serve.get_deployment_handle("adder"), serve.DeploymentHandle)
    with pytest.raises(ValueError):
        serve.get_deployment_handle("nope")
    with pytest.raises(RuntimeError, match="already bound"):
        serve.run(serve.deployment(probe.Echo, name="e").bind(), http_host="127.0.0.2",
                  http_port=1)


def test_policy_deployment_in_a_cpu_replica(tmp_path):
    from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig
    from ray_tpu_torch.serve.policy_server import policy_deployment, restore_policy

    algo = (PPOConfig().environment("CartPole-v1").rollouts(num_rollout_workers=0)
            .training(train_batch_size=64, model={"fcnet_hiddens": [8]})
            .debugging(seed=2).resources(device="cpu").build())
    root = str(tmp_path / "ckpts")
    try:
        algo.save(os.path.join(root, "checkpoint_000001"))
    finally:
        algo.stop()
    handle = serve.run(policy_deployment(root, name="cp", watch=False, max_batch_size=4,
                                         device="cpu"))
    obs = np.asarray([0.01, -0.02, 0.03, 0.04], np.float32)
    out = core.get(handle.remote({"obs": obs.tolist()}), timeout=120)
    local, _, _, _ = restore_policy(root, device="cpu")
    a, _, ex = local.compute_actions(obs[None], explore=False)
    assert out["action"] == int(a[0]) and out["params_version"] == 1
    assert np.float32(out["logp"]) == ex["action_logp"][0]
    rows = core.get(handle.method("handle_rows").remote([obs.tolist()] * 3), timeout=60)
    assert [r["action"] for r in rows] == [int(a[0])] * 3
    st = core.get(serve.get_running("cp").replicas[0].stats.remote(), timeout=60)
    assert st["captures_after_warmup"] == 0 and st["device"] is None


def test_worker_env_keeps_the_card_variable_when_asked(monkeypatch):
    """A worker hides the card (``CUDA_VISIBLE_DEVICES=""``) unless
    RAY_TPU_WORKER_PLATFORM names another platform; an actor class's
    ``runtime_env`` adds its variables."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    report = core.remote(probe.EnvReport)
    hidden = report.remote()
    shown = report.options(
        runtime_env={"env_vars": {"RAY_TPU_WORKER_PLATFORM": "cuda", "X_MARK": "1"}}
    ).remote()
    assert core.get(hidden.env.remote("CUDA_VISIBLE_DEVICES"), timeout=60) == ""
    assert core.get(hidden.env.remote("X_MARK"), timeout=60) is None
    assert core.get(shown.env.remote("CUDA_VISIBLE_DEVICES"), timeout=60) == "0"
    assert core.get(shown.env.remote("X_MARK"), timeout=60) == "1"
    core.kill(hidden)
    core.kill(shown)
    with pytest.raises(NotImplementedError, match="item 9"):
        report.options(runtime_env={"pip": ["x"]})


def test_on_ready_passes_the_error_and_outlives_a_raising_callback():
    """``core.api.on_ready`` hands each callback the call's stored error
    (None on success), also when the caller dropped the ref before the
    reply came in; a callback that raises is logged and neither stops
    the callbacks after it nor the runtime's reader thread."""
    from ray_tpu_torch.core import api as core_api

    echo = core.remote(probe.Echo).remote()
    seen, done = [], threading.Event()

    def boom(error):
        raise RuntimeError("callback fault")

    def record(error):
        seen.append(error)
        done.set()

    ref = echo.pid.remote()
    core_api.on_ready(ref, boom)
    core_api.on_ready(ref, record)
    del ref  # dropped before its reply: the entry is freed on completion
    assert done.wait(60) and seen == [None]
    assert core.get(echo.pid.remote(), timeout=60) > 0  # the reader thread lives on
    core.kill(echo)
    dead, got = echo.pid.remote(), []
    core_api.on_ready(dead, got.append)
    assert _wait(lambda: got, 30)
    assert isinstance(got[0], core.RayActorError)
