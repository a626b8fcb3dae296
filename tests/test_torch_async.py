"""The port's asynchronous plane, on the CPU: request manager, device
feeder, learner thread and PPO's prefetch path.

- ``AsyncRequestsManager`` on the port's runtime, the four cases of
  ``tests/test_parallel_requests.py``: the per-worker in-flight cap,
  completion-order harvest (a slow worker does not gate a fast one),
  dead workers dropped and reported once, and the poll round of
  ``asynchronous_parallel_requests``; besides, ``wait_asynchronous_requests``
  and harvested results leave no shared-memory segment behind.
- ``DeviceFeeder`` (on the CPU: the same thread, no stream): stop is
  race-free and idempotent and unblocks a producer blocked on a full
  pipeline (``tests/test_learner_thread.py``), and a batch arrives as
  tensors equal to its arrays.
- ``LearnerThread``: a batch learned through the thread (prepare, the
  feeder, the deferred-stats learn) gives bitwise the parameters and
  stats of the synchronous ``learn_on_batch`` of a second policy of the
  same seed (PPO on a pooled pixel batch, IMPALA on pooled unrolls); the
  stats have the reference's keys; a policy that overrides
  ``learn_on_batch`` learns through it.
- PPO's prefetch path with 2 remote workers on PongLite-v0: its first
  step's learner stats equal the synchronous path's bitwise (both start
  from the same weights and assemble the same batch); it keeps
  training; ``stop`` joins its threads; ``superstep`` K > 1 raises; with
  no remote worker it is the synchronous path.

One runtime (one task worker) serves the module; the remote stand-in
sampler is ``tests/_torch_actor_probe.StandInSampler``, whose module
imports only the standard library, so a worker loads it at once.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from _torch_actor_probe import StandInSampler
from ray_tpu_torch import core
from ray_tpu_torch.algorithms.impala.impala import ImpalaTorchPolicy
from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig, PPOTorchPolicy
from ray_tpu_torch.core import object_store
from ray_tpu_torch.data.sample_batch import SampleBatch, concat_samples
from ray_tpu_torch.env.spaces import Box, Discrete
from ray_tpu_torch.execution.device_feed import DeviceFeeder
from ray_tpu_torch.execution.learner_thread import LearnerThread
from ray_tpu_torch.execution.parallel_requests import (
    AsyncRequestsManager,
    asynchronous_parallel_requests,
    wait_asynchronous_requests,
)
from ray_tpu_torch.ops import framestack as fs

SMALL_CNN = {"dtype": "float32", "conv_filters": [[8, [8, 8], [4, 4]], [8, [4, 4], [2, 2]]],
             "post_fcnet_hiddens": [32]}
PONG_CFG = {"rallies": 1, "max_steps": 25}
_Sampler = core.remote(StandInSampler)


@pytest.fixture(scope="module")
def runtime():
    core.shutdown()
    core.init(num_cpus=1)
    yield
    core.shutdown()


def _workers(specs, **kw):
    return [_Sampler.remote(wid, d, **kw) for wid, d in specs]


# -- AsyncRequestsManager --------------------------------------------------------


def test_in_flight_cap_respected(runtime):
    (w,) = _workers([("a", 0.2)])
    mgr = AsyncRequestsManager([w], max_remote_requests_in_flight_per_worker=2)
    assert mgr.submit(worker=w) and mgr.submit(worker=w)
    assert not mgr.submit(worker=w) and not mgr.submit()
    assert mgr.in_flight(w) == 2 and mgr.in_flight() == 2
    assert mgr.submit_available() == 0
    got = mgr.get_ready(timeout=30.0)
    n_done = sum(len(v) for v in got.values())
    assert n_done >= 1 and mgr.in_flight(w) == 2 - n_done
    assert mgr.submit_available() == n_done and mgr.in_flight(w) == 2
    core.kill(w)


def test_harvest_in_completion_order(runtime):
    slow, fast = _workers([("slow", 1.5), ("fast", 0.0)])
    mgr = AsyncRequestsManager([slow, fast], max_remote_requests_in_flight_per_worker=1)
    mgr.submit_available()
    got = mgr.get_ready(timeout=30.0)
    assert fast in got and got[fast] == [("fast", 1)]
    assert slow not in got and mgr.in_flight(slow) == 1
    assert mgr.get_ready(timeout=30.0) == {slow: [("slow", 1)]}
    assert mgr.num_completed == 2
    for w in (slow, fast):
        core.kill(w)


def test_dead_worker_dropped_and_reported(runtime):
    victim, survivor = _workers([("victim", 0.0), ("ok", 0.0)])
    mgr = AsyncRequestsManager([victim, survivor], max_remote_requests_in_flight_per_worker=1)
    victim.die.remote()
    time.sleep(0.3)
    mgr.submit_available()
    deadline = time.time() + 30
    results = []
    while time.time() < deadline and mgr.in_flight():
        for v in mgr.get_ready(timeout=1.0).values():
            results.extend(v)
    assert ("ok", 1) in results
    assert mgr.take_dead_workers() == [victim]
    assert mgr.take_dead_workers() == []  # reported once
    assert victim not in mgr.workers() and mgr.num_dropped >= 1
    mgr.submit_available()
    assert mgr.in_flight(victim) == 0 and mgr.in_flight(survivor) == 1
    core.kill(survivor)


def test_asynchronous_parallel_requests_round(runtime):
    workers = _workers([("a", 0.0), ("b", 0.0)])
    mgr = AsyncRequestsManager(workers, max_remote_requests_in_flight_per_worker=2)
    total = 0
    deadline = time.time() + 30
    while total < 6 and time.time() < deadline:
        total += sum(len(v) for v in asynchronous_parallel_requests(mgr, timeout=1.0).values())
    assert total >= 6
    s = mgr.stats()
    assert s["num_completed"] >= 6 and s["num_live_workers"] == 2
    got = wait_asynchronous_requests(mgr, deadline_s=30.0, min_results=mgr.in_flight())
    assert sum(len(v) for v in got.values()) >= 1 and mgr.in_flight() == 0
    for w in workers:
        core.kill(w)


def test_harvested_refs_free_their_segments(runtime):
    (w,) = _workers([("big", 0.3)], payload=1 << 20)  # above the inline limit
    mgr = AsyncRequestsManager([w], max_remote_requests_in_flight_per_worker=2)
    assert mgr.submit_available() == 2
    got = mgr.get_ready(timeout=30.0, min_results=2)
    assert [int(a[0]) for a in got[w]] == [1, 2]
    del got
    core.kill(w)
    assert object_store.leftover_segments(core.api._runtime.session) == []


# -- DeviceFeeder ------------------------------------------------------------------


def test_device_feeder_stop_is_race_free_and_idempotent():
    feeder = DeviceFeeder("cpu", capacity=1)
    feeder.put({"x": np.zeros(4, np.float32)}, 0)
    feeder.put({"x": np.zeros(4, np.float32)}, 1)
    feeder.stop(join_timeout=10.0)
    assert not feeder._thread.is_alive()
    with pytest.raises(RuntimeError):
        feeder.put({"x": np.zeros(4, np.float32)}, 2)
    assert feeder._in.qsize() == 0 and feeder._out.qsize() == 0
    feeder.stop(join_timeout=1.0)


def test_device_feeder_stop_unblocks_pending_producer():
    feeder = DeviceFeeder("cpu", capacity=1)
    for i in range(3):  # the outqueue, the thread and the inqueue full
        feeder.put({"x": np.zeros(4, np.float32)}, i)
    time.sleep(0.3)
    errs = []

    def producer():
        try:
            feeder.put({"x": np.zeros(4, np.float32)}, 99)
        except RuntimeError as e:
            errs.append(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    time.sleep(0.3)
    feeder.stop(join_timeout=10.0)
    t.join(timeout=10.0)
    assert not t.is_alive() and len(errs) == 1


def test_device_feeder_delivers_the_arrays_in_order():
    feeder = DeviceFeeder("cpu", capacity=2)
    rng = np.random.default_rng(0)
    trees = [{"a": rng.integers(0, 255, (7, 5), dtype=np.uint8), "b": rng.standard_normal(3)}
             for _ in range(4)]
    try:
        for i, t in enumerate(trees[:2]):
            feeder.put(t, i)
        for i, want in enumerate(trees):
            dev, meta = feeder.get(timeout=10)
            assert meta == i and set(dev) == {"a", "b"}
            for k in want:
                assert isinstance(dev[k], torch.Tensor) and np.array_equal(dev[k].numpy(), want[k])
            if i + 2 < len(trees):
                feeder.put(trees[i + 2], i + 2)
        assert feeder.num_batches == 4 and feeder.bytes_total == sum(
            v.nbytes for t in trees for v in t.values())
        assert [c["bytes"] for c in feeder.copies] == [35 + 24] * 4
    finally:
        feeder.stop()


# -- LearnerThread ------------------------------------------------------------------


def _stream_stacks(rng, n, k=4, hw=(24, 24)):
    stream = rng.integers(0, 255, (n + k - 1,) + hw + (1,), dtype=np.uint8)
    return fs.materialize_stacks_np(stream, np.arange(n), k)


def _pooled_batch(policy, seed, n_frags=4, T=8):
    """Fragments of T pixel steps as a worker ships them, concatenated."""
    rng = np.random.default_rng(seed)
    frags = []
    for i in range(n_frags):
        s = _stream_stacks(rng, T + 1)
        frags.append(policy.compress_for_shipping(SampleBatch({
            "obs": s[:T], "new_obs": s[1:], "dones": np.zeros(T, bool),
            "truncateds": np.zeros(T, bool), "actions": rng.integers(0, 3, T),
            "rewards": rng.standard_normal(T).astype(np.float32),
            "action_logp": np.full(T, -1.1, np.float32),
            "action_dist_inputs": rng.standard_normal((T, 3)).astype(np.float32),
            "advantages": rng.standard_normal(T).astype(np.float32),
            "value_targets": rng.standard_normal(T).astype(np.float32),
            "eps_id": np.full(T, i, np.int64), "unroll_id": np.full(T, i, np.int64),
        })))
    batch = concat_samples(frags)
    assert fs.FRAMES in batch
    return batch


KINDS = {
    "ppo": (PPOTorchPolicy, {"train_batch_size": 32, "sgd_minibatch_size": 8, "num_sgd_iter": 2}),
    "impala": (ImpalaTorchPolicy, {"rollout_fragment_length": 8, "train_batch_size": 16,
                                   "_fixed_unrolls": True}),
}


def _pair(kind):
    cls, cfg = KINDS[kind]
    cfg = {"model": SMALL_CNN, "seed": 3, "lr": 1e-3, **cfg}
    return [cls(Box(0, 255, (24, 24, 4), np.uint8), Discrete(3), dict(cfg), device="cpu")
            for _ in range(2)]


def _run_thread(lt, batches, timeout_s=60):
    lt.start()
    for b in batches:
        assert lt.add_batch(b)
    deadline = time.time() + timeout_s
    while lt.num_steps < len(batches) and time.time() < deadline:
        time.sleep(0.02)
    lt.stop()
    assert not lt.is_alive() and lt.error is None


@pytest.mark.parametrize("kind", ["ppo", "impala"])
def test_learner_thread_learn_equals_sync_learn(kind):
    threaded, sync = _pair(kind)
    batches = [_pooled_batch(sync, seed) for seed in range(3)]
    lt = LearnerThread(threaded, publish_weights_every=2)
    assert lt._pipelined and lt._defer == (kind == "impala")
    _run_thread(lt, batches)
    infos = []
    while not lt.outqueue.empty():
        infos.append(lt.outqueue.get_nowait())
    want = [sync.learn_on_batch(b) for b in batches]
    assert [steps for steps, _ in infos] == [b.count for b in batches]
    assert [info for _, info in infos] == want
    for (name, a), b in zip(threaded.get_weights().items(), sync.get_weights().values()):
        assert np.array_equal(a, b), name
    ver, published = lt.published_weights()
    assert ver == 1 and set(published) == set(sync.get_weights())
    assert lt._in_flight == 0 and lt.feeder.num_batches == 3


def test_learner_thread_stats_keys():
    policy, _ = _pair("impala")
    lt = LearnerThread(policy)
    _run_thread(lt, [_pooled_batch(policy, 0)])
    stats = lt.stats()
    assert set(stats) == {"learner_queue_size", "num_steps_trained_this_thread",
                          "queue_wait_time_s", "grad_time_s", "weight_publish_time_s"}
    assert stats["num_steps_trained_this_thread"] == 1 and stats["grad_time_s"] > 0
    assert stats["weight_publish_time_s"] == 0.0  # publishing off


class _OwnLearn(PPOTorchPolicy):
    def learn_on_batch(self, samples, perms=None):
        return {"own": float(samples.count)}


def test_learner_thread_uses_an_overridden_learn_on_batch():
    policy = _OwnLearn(Box(-1, 1, (4,), np.float32), Discrete(2), {}, device="cpu")
    lt = LearnerThread(policy)
    assert not lt._pipelined
    batch = SampleBatch({"obs": np.zeros((5, 4), np.float32)})
    _run_thread(lt, [batch, batch])
    assert lt.learner_info == {"own": 5.0} and lt.feeder is None


def test_learner_thread_parks_its_error():
    policy, _ = _pair("impala")
    lt = LearnerThread(policy)
    lt.start()
    lt.add_batch(SampleBatch({"obs": np.zeros((3, 2), np.float32)}))  # not a train batch
    deadline = time.time() + 30
    while lt.is_alive() and time.time() < deadline:
        time.sleep(0.02)
    assert not lt.healthy() and isinstance(lt.error, KeyError)


# -- PPO's prefetch path ----------------------------------------------------------


def _ppo(**over):
    cfg = PPOConfig().update_from_dict({
        "seed": 0, "num_workers": 2, "num_envs_per_worker": 2, "rollout_fragment_length": 16,
        "train_batch_size": 64, "sgd_minibatch_size": 32, "num_sgd_iter": 2, "lr": 1e-3,
        "device": "cpu", "model": SMALL_CNN, "env_config": dict(PONG_CFG), **over,
    })
    cfg.env = "PongLite-v0"
    return cfg.build()


def test_ppo_prefetch_first_step_equals_sync_path(runtime):
    sync = _ppo()
    try:
        r_sync = sync.train()
    finally:
        sync.stop()
    algo = _ppo(sample_prefetch=1)
    try:
        assert algo._use_sample_prefetch()
        r_pre = algo.train()
        assert r_pre["info"]["learner"]["default_policy"] == r_sync["info"]["learner"]["default_policy"]
        assert r_pre["num_env_steps_sampled"] == r_sync["num_env_steps_sampled"] == 64
        for _ in range(2):
            r = algo.train()
        assert all(np.isfinite(v) for v in r["info"]["learner"]["default_policy"].values())
        assert r["num_env_steps_trained"] == 3 * 64
        assert set(r["timers"]) == {"prefetch_wait_s", "learn_s", "sync_weights_s"}
        pipe, feeder = algo._sample_pipeline, algo._prefetch_feeder
        assert pipe.healthy() and pipe.stats()["num_train_batches"] >= 3
        assert feeder.num_batches >= 3
        algo._teardown_pipeline()
        assert not pipe._thread.is_alive() and not feeder._thread.is_alive()
        # the superstep over prefetched batches is a later slice
        algo.config["superstep"] = 2
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            algo.train()
    finally:
        algo.stop()


def test_ppo_prefetch_needs_remote_workers(runtime):
    algo = _ppo(num_workers=0, sample_prefetch=2)
    try:
        assert not algo._use_sample_prefetch()
        assert algo.train()["timesteps_total"] == 64  # the synchronous path
    finally:
        algo.stop()
