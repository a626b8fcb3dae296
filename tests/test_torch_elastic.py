"""The elastic fleet of the port (``autoscaler/fleet.py``, the elastic
``WorkerSet``, the request manager's elastic half) held against the
reference's (``tests/test_elastic.py`` and the manager and probe cases
of ``tests/test_resilience.py``), on the CPU.

- the preemption notice arms once, with its grace, as the reference's;
- the request manager: a worker added again gets fresh slots and a
  cleared dead mark; ``retire_worker`` harvests the done request, drops
  the pending one and reports no later death; ``remove_workers(
  drop_in_flight=True)`` drops every request;
- ``probe_actors``: one wedged actor costs the sweep one budget;
- the worker set's indices: a replacement takes its dead worker's, a
  joiner the one after the largest live index, none shared; IMPALA's
  rotation follows the worker set after a worker recovery;
- the fleet controller: the reaper spares a busy and a draining worker
  and never goes below ``min_workers``; a scale request is clamped to
  ``[min_workers, max_workers]``; a noticed worker drains (its filter
  deltas and episodes handed over) at no recovery cost; the monitor
  thread is a daemon that ``stop()`` joins;
- the elastic PPO run (the reference's ``test_elastic_chaos_e2e``, at 2
  workers): its first iteration, before any churn, bitwise a non-elastic
  run's (loss, weights, filters); then a noticed preemption drains at no
  budget, an unnoticed kill costs one worker recovery, and a scale-up's
  joiner holds the learner's weights and filters before it samples.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from _torch_actor_probe import FleetProbe, policy_weights
from ray_tpu.resilience import faults as ref_faults
from ray_tpu_torch import core
from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig
from ray_tpu_torch.autoscaler.fleet import FleetController
from ray_tpu_torch.execution.parallel_requests import AsyncRequestsManager
from ray_tpu_torch.resilience import faults as my_faults
from ray_tpu_torch.resilience.retry import probe_actors

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU learns: beside
    other test processes on the same cores, torch's thread pool spins
    for far longer than these learns compute."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


_Probe = core.remote(FleetProbe)


@pytest.fixture(scope="module")
def runtime():
    core.shutdown()
    core.init(num_cpus=1)
    yield
    core.shutdown()


def test_preempt_notice_arms_once_with_grace(monkeypatch):
    armed = {"mine": [], "ref": []}
    monkeypatch.setattr(my_faults, "_arm_exit_timer", lambda g: armed["mine"].append(g))
    monkeypatch.setattr(ref_faults, "_arm_exit_timer", lambda g: armed["ref"].append(g))
    spec = {"preempt_worker": [{"worker_index": 1, "on_call": 2, "grace_s": 600.0}]}
    for key, inj in (("mine", my_faults.FaultInjector(spec)), ("ref", ref_faults.FaultInjector(spec))):
        assert inj.preemption_notice() is None
        inj.on_sample(worker_index=1, call_n=1)
        assert inj.preemption_notice() is None
        inj.on_sample(worker_index=1, call_n=2)
        g = inj.preemption_notice()
        assert g is not None and 590.0 < g <= 600.0
        inj.on_sample(worker_index=1, call_n=3)
        inj.on_sample(worker_index=1, call_n=2)
        assert armed[key] == [600.0]
    assert (my_faults._parse_env_spec("preempt_worker:2@3x5,4@1;kill_worker:1@2")
            == ref_faults._parse_env_spec("preempt_worker:2@3x5,4@1;kill_worker:1@2"))


# -- the request manager and the probe ---------------------------------------------


def test_manager_readd_clears_dead_mark_and_counts(runtime):
    w = _Probe.remote()
    mgr = AsyncRequestsManager([w], max_remote_requests_in_flight_per_worker=2)
    assert mgr.submit(worker=w) and mgr.submit(worker=w)
    mgr.report_dead(w)
    assert mgr.take_dead_workers() == [w]
    assert not mgr.submit(worker=w)
    mgr.add_workers([w])
    assert mgr.in_flight(w) == 0 and mgr.submit(worker=w)
    mgr.report_dead(w)
    assert mgr.take_dead_workers() == [w]
    core.kill(w)


def test_manager_retire_harvests_done_and_drops_pending(runtime):
    w = _Probe.remote()
    mgr = AsyncRequestsManager([w], max_remote_requests_in_flight_per_worker=2)
    assert mgr.submit(lambda a: a.sample.remote(0.0), worker=w)
    assert mgr.submit(lambda a: a.sample.remote(5.0), worker=w)
    deadline = time.monotonic() + 30
    ready = []
    while time.monotonic() < deadline and not ready:
        ready, _ = core.wait(list(mgr._in_flight), num_returns=2, timeout=0.05)
    assert ready, "the fast request never completed"
    assert mgr.retire_worker(w) == 1
    assert not mgr.submit(worker=w)
    assert list(mgr.get_ready(timeout=1.0).values()) == [["result"]]
    assert mgr.in_flight() == 0 and mgr.in_flight(w) == 0
    mgr.report_dead(w)
    assert mgr.take_dead_workers() == []
    # dropping every request of a removed worker
    mgr2 = AsyncRequestsManager([w], max_remote_requests_in_flight_per_worker=2)
    assert mgr2.submit(lambda a: a.sample.remote(5.0), worker=w)
    assert mgr2.submit(lambda a: a.sample.remote(5.0), worker=w)
    assert mgr2.remove_workers([w], drop_in_flight=True) == 2
    assert mgr2.in_flight() == 0 and mgr2.in_flight(w) == 0 and mgr2.get_ready(timeout=0.1) == {}
    core.kill(w)


def test_probe_actors_bounded_by_one_budget(runtime):
    ok, wedged = _Probe.remote(), _Probe.remote(ping_delay=60.0)
    assert core.get(ok.ping.remote(), timeout=60) == "pong"
    t0 = time.monotonic()
    assert probe_actors([ok, wedged, ok], timeout_s=2.0) == [1]
    assert time.monotonic() - t0 < 10.0
    core.kill(wedged)
    assert probe_actors([ok, wedged], timeout_s=2.0) == [1]  # dead: submission or ping fails
    core.kill(ok)


# -- the fleet controller ------------------------------------------------------------


class _StubWorkerSet:
    def __init__(self, workers):
        self._w = list(workers)
        self.absorbed = []

    def remote_workers(self):
        return list(self._w)

    def num_remote_workers(self):
        return len(self._w)

    def remove_workers(self, workers):
        drop = {id(w) for w in workers}
        self._w = [w for w in self._w if id(w) not in drop]

    def absorb_filters(self, f):
        self.absorbed.append(f)

    def scale_up(self, k):
        new = [_Probe.remote() for _ in range(k)]
        self._w.extend(new)
        return new


class _StubManager:
    def __init__(self):
        self.busy = {}
        self.removed = []
        self.retired = []

    def in_flight(self, w):
        return self.busy.get(id(w), 0)

    def remove_workers(self, ws):
        self.removed.extend(ws)

    def retire_worker(self, w):
        self.retired.append(w)
        return 0


class _StubRecovery:
    def __init__(self):
        self.preemptions = []

    def note_preemption(self, drained):
        self.preemptions.append(drained)


class _StubAlgo:
    def __init__(self):
        self._recovery = _StubRecovery()
        self.changes = []

    def on_fleet_change(self, added, removed):
        self.changes.append((len(added), len(removed)))


def _controller(workers, **cfg):
    base = {"num_workers": len(workers), "min_workers": 1, "max_workers": 8,
            "fleet_interval_s": 3600.0, "fleet_idle_timeout_s": 0.05, "drain_grace_s": 10.0}
    base.update(cfg)
    ws = _StubWorkerSet(workers)
    return FleetController(_StubAlgo(), ws, base), ws


def test_idle_reaper_spares_busy_and_draining_workers(runtime):
    fleet, ws = _controller([_Probe.remote() for _ in range(3)])
    try:
        busy_w, draining_w, idle_w = ws.remote_workers()
        mgr = _StubManager()
        mgr.busy[id(busy_w)] = 1
        fleet.register_manager(mgr)
        fleet._draining.add(id(draining_w))
        for _ in range(2):
            time.sleep(0.1)
            fleet._poll_idle()
        fleet.reconcile()
        assert ws.remote_workers() == [busy_w, draining_w]
        assert fleet.num_reaped == 1 and idle_w in mgr.retired
        assert fleet.algo.changes == [(0, 1)] and fleet.algo._recovery.preemptions == []
    finally:
        fleet._draining.clear()
        fleet.stop()
    # never below min_workers
    fleet, ws = _controller(ws.remote_workers(), min_workers=2)
    try:
        fleet.register_manager(_StubManager())
        for _ in range(2):
            time.sleep(0.1)
            fleet._poll_idle()
        fleet.reconcile()
        assert ws.num_remote_workers() == 2 and fleet.num_reaped == 0
    finally:
        fleet.stop()
        for w in ws.remote_workers():
            core.kill(w)


def test_scale_requests_clamp_and_notices_drain_at_no_cost(runtime):
    noticed = _Probe.remote(notice=30.0)
    fleet, ws = _controller([_Probe.remote(), noticed], min_workers=1, max_workers=3)
    try:
        fleet.request_scale(+5)
        fleet.reconcile()
        assert ws.num_remote_workers() == 3 and fleet.stats()["scale_ups"] == 1
        deadline = time.monotonic() + 30
        while noticed not in fleet._noticed.values() and time.monotonic() < deadline:
            fleet.update()
            time.sleep(0.05)
        fleet.reconcile()
        assert noticed not in ws.remote_workers() and fleet.num_drained == 1
        assert fleet.algo._recovery.preemptions == [True] and ws.absorbed == [{}]
        assert fleet.stats()["preemptions_drained"] == 1 and fleet.stats()["size"] == 2
        fleet.request_scale(-5)
        fleet.reconcile()
        assert ws.num_remote_workers() == 1 and fleet.num_scale_downs == 1
    finally:
        fleet.stop()
        for w in ws.remote_workers() + [noticed]:
            core.kill(w)


class _StartedWorker:
    """What ``api.remote(RolloutWorker).remote(...)`` returns in the index
    test: the keyword arguments the worker was started with."""

    def __init__(self, **kwargs):
        self.kwargs = kwargs


def test_worker_indices_stay_distinct_through_replace_and_scale(monkeypatch):
    """A replacement takes its dead worker's index and a joiner the one
    after the largest live index, so no two live workers share a seed
    (``seed + 1000 * worker_index``); each is told the fleet's size."""
    from ray_tpu_torch.evaluation import worker_set as ws_mod

    monkeypatch.setattr(ws_mod.api, "is_initialized", lambda: True)
    monkeypatch.setattr(ws_mod.api, "remote", lambda cls: type("R", (), {"remote": staticmethod(_StartedWorker)}))
    monkeypatch.setattr(ws_mod.api, "kill", lambda w: None)
    ws = ws_mod.WorkerSet.__new__(ws_mod.WorkerSet)
    ws._env_creator, ws._policy_cls, ws._config, ws._specs = None, None, {}, {}
    ws._remote_workers, ws._indices = [], {}
    ws._local_worker = type("L", (), {"policy_map": {}})()  # nothing to sync
    ws.add_workers(4, sync=False)

    def indices():
        return [w.kwargs["worker_index"] for w in ws.remote_workers()]

    assert indices() == [1, 2, 3, 4]
    dead = ws.remote_workers()[1:3]
    new = ws.replace_failed_workers(dead)
    assert [w.kwargs["worker_index"] for w in new] == [2, 3]
    assert [w.kwargs["config"]["fault_injection"] for w in new] == [{}, {}]
    assert sorted(indices()) == [1, 2, 3, 4]
    assert {w.kwargs["num_workers"] for w in ws.remote_workers()} == {4}
    assert [w.kwargs["worker_index"] for w in ws.scale_up(2)] == [5, 6]
    tail = ws.remote_workers()[3:]
    assert ws.scale_to(3) == {"added": [], "removed": tail}
    assert sorted(indices()) == [1, 2, 4]
    joiners = ws.scale_up(2)
    assert [w.kwargs["worker_index"] for w in joiners] == [5, 6]
    assert [w.kwargs["num_workers"] for w in joiners] == [5, 5]
    assert len(set(indices())) == len(indices()) == 5


def test_impala_worker_recovery_syncs_its_rotation():
    """After the recovery manager's worker probe, IMPALA's sampling
    rotation is the worker set: recreated workers join it and dropped
    ones leave, once, in ``on_recovery("workers")`` (no step rescans)."""
    from ray_tpu_torch.algorithms.impala.impala import IMPALA

    a, b, c, d = (object() for _ in range(4))
    live = [a, c, d]
    algo = IMPALA.__new__(IMPALA)
    algo._sample_manager = AsyncRequestsManager([a, b, c])
    algo.workers = type("W", (), {"remote_workers": staticmethod(lambda: live)})()
    algo.on_recovery("workers")
    assert algo._sample_manager.workers() == [a, c, d]
    algo.on_recovery("workers")
    assert algo._sample_manager.workers() == [a, c, d]


def test_monitor_thread_stop_joins():
    fleet, _ = _controller([], fleet_interval_s=0.05)
    assert fleet._thread.daemon and fleet._thread.is_alive()
    fleet.stop()
    assert not fleet._thread.is_alive()


# -- the elastic PPO run --------------------------------------------------------------


def _elastic_ppo(elastic, fault_injection=None):
    cfg = (PPOConfig().environment("CartPole-v1")
           .rollouts(num_rollout_workers=2, rollout_fragment_length=32)
           .update_from_dict({"observation_filter": "MeanStdFilter"})
           .training(train_batch_size=64, sgd_minibatch_size=32, num_sgd_iter=1, lr=3e-4)
           .fault_tolerance(recreate_failed_workers=True, max_failures=10,
                            fault_injection=fault_injection or {})
           .debugging(seed=1).resources(device="cpu"))
    if elastic:
        cfg.fault_tolerance(elastic=True, min_workers=1, max_workers=4, drain_grace_s=120.0,
                            fleet_interval_s=0.2)
    return cfg.build()


def _copy_weights(algo):
    return {k: v.copy() for k, v in algo.get_policy().get_weights().items()}


def _filter_state(f):
    return (f.rs.num, f.rs.mean_.tobytes(), f.rs.s.tobytes())


def test_elastic_run_stable_phase_bitwise_then_drain_kill_and_join():
    core.shutdown()
    ref = _elastic_ppo(elastic=False)
    try:
        ref_r1 = ref.train()
        ref_w = _copy_weights(ref)
        ref_f = _filter_state(ref.workers.local_worker().filters["default_policy"])
    finally:
        ref.stop()
    algo = _elastic_ppo(elastic=True, fault_injection={
        "preempt_worker": [{"worker_index": 2, "on_call": 2, "grace_s": 120.0}],
        "kill_worker": [{"worker_index": 1, "on_call": 3}],
    })
    try:
        r1 = algo.train()  # the stable phase: one sample round, no churn
        assert (r1["info"]["learner"]["default_policy"]["total_loss"]
                == ref_r1["info"]["learner"]["default_policy"]["total_loss"])
        w1 = _copy_weights(algo)
        assert all(w1[k].tobytes() == ref_w[k].tobytes() for k in ref_w)
        assert _filter_state(algo.workers.local_worker().filters["default_policy"]) == ref_f
        last = r1
        for _ in range(40):
            last = algo.train()
            rec = last["info"]["recovery"]
            if rec["preemptions_drained"] and rec["recoveries"]:
                break
            time.sleep(0.05)
        rec = last["info"]["recovery"]
        assert rec["preemptions_drained"] == 1 and rec["preemptions_lost"] == 0
        assert rec["failures"] == 1 and rec["recoveries"] == {"workers": 1}
        # the scale-up's joiner holds the learner's weights and filters
        # before anything else reaches it
        algo._fleet.request_scale(+1)
        algo._fleet.reconcile()
        joiner = algo.workers.remote_workers()[-1]
        local = algo.workers.local_worker()
        got_w = core.get(joiner.apply.remote(policy_weights), timeout=120)
        got_f = core.get(joiner.get_filters.remote(), timeout=120)
        want_w = local.get_weights()["default_policy"]
        assert all(got_w[k].tobytes() == want_w[k].tobytes() for k in want_w)
        assert _filter_state(got_f["default_policy"]) == _filter_state(local.filters["default_policy"])
        last = algo.train()
        fleet = last["info"]["recovery"]["fleet"]
        assert fleet["min_workers"] <= algo.workers.num_remote_workers() <= fleet["max_workers"]
        assert fleet["scale_ups"] >= 1 and fleet["preemptions_drained"] == 1
        assert np.isfinite(last["info"]["learner"]["default_policy"]["total_loss"])
    finally:
        algo.stop()
        core.shutdown()
    assert not algo._fleet._thread.is_alive()
