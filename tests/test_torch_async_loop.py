"""The asynchronous actor-learner loop of the port, on the CPU.

- ``AsyncSampler`` (``sample_async``): at fixed weights its stream is
  the ``SyncSampler``'s and the reference's ``AsyncSampler``'s, bitwise
  (PongLite-v0 under the scripted policy of
  ``tests/test_torch_actor_lane.py``); ``stop()`` ends its thread; an
  error raised in the thread comes back on the next ``sample()``; weight
  swaps are atomic towards the thread: every row's ``action_logp`` is
  the one of a whole weight set (a remote-style worker whose weights
  swap between two sets while it samples).
- The one-round-stale off-policy round (DQN and SAC with one remote
  worker and ``sample_async``): round r inserts the fragment requested
  in round r - 1, and ``stop()`` and a restore drop the pending request;
  the local worker as the learner refuses ``sample_async``.
- The learner thread's fused superstep: K = 2 queued flat batches of
  IMPALA and APPO learned by one stacked ``learn_superstep`` equal two
  sequential ``learn_on_device_batch`` calls on the trimmed batches,
  bitwise in the stats (each update's stats its own outqueue entry) and
  the parameters; ``_trim_fixed`` gives the reference's rows and sizes
  (IMPALA's unrolls, flat rows, recurrent chunks, short batches) and
  demotes a frame pool as the reference's does; a frame-pool batch
  demotes the thread to one update a step.
- PPO's prefetch at K = 2 (two remote workers, CartPole-v1): one step's
  fused superstep equals two sequential learns of the same prefetched
  batches, bitwise, with the KL coefficient adapted on each update's
  stats in the reference's order.
- IMPALA's aggregation actors: ``AggregatorWorker`` concatenates to the
  reference's ``concat_samples`` of the same fragments, bitwise, and
  IMPALA with two remote workers and one aggregator trains, drops a
  killed worker and goes on.

On the CPU every path runs the kernels' plain versions, and
``superstep`` is given as an int ("auto" is 1 here). One runtime serves
the module; no test starts more than two rollout workers.
"""

from __future__ import annotations

import copy
import random
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ray_tpu.data.sample_batch import SampleBatch as RefSampleBatch
from ray_tpu.data.sample_batch import concat_samples as ref_concat
from ray_tpu.env import registry as ref_registry
from ray_tpu.env.vector_env import VectorEnv as RefVectorEnv
from ray_tpu.evaluation import postprocessing as ref_post
from ray_tpu.evaluation.sampler import AsyncSampler as RefAsyncSampler
from ray_tpu.execution.learner_thread import LearnerThread as RefLearnerThread
from ray_tpu.ops import framestack as ref_fs
from ray_tpu_torch import core
from ray_tpu_torch.algorithms.appo.appo import APPOTorchPolicy
from ray_tpu_torch.algorithms.dqn.dqn import DQNConfig
from ray_tpu_torch.algorithms.impala.impala import AggregatorWorker, IMPALAConfig, ImpalaTorchPolicy
from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig, PPOTorchPolicy
from ray_tpu_torch.algorithms.sac.sac import SACConfig
from ray_tpu_torch.data.sample_batch import SampleBatch, concat_samples
from ray_tpu_torch.env import registry
from ray_tpu_torch.env.spaces import Box, Discrete
from ray_tpu_torch.env.vector_env import VectorEnv
from ray_tpu_torch.evaluation import postprocessing as post
from ray_tpu_torch.evaluation.rollout_worker import RolloutWorker
from ray_tpu_torch.evaluation.sampler import AsyncSampler, SyncSampler
from ray_tpu_torch.execution.learner_thread import LearnerThread
from ray_tpu_torch.ops import framestack as fs
from test_torch_actor_lane import PONG_CFG, ScriptedPolicy, _assert_batches_equal
from test_torch_async import _pair, _pooled_batch, _run_thread


@pytest.fixture(scope="module")
def runtime():
    core.init(num_cpus=1)
    yield
    core.shutdown()


# -- AsyncSampler ------------------------------------------------------------------


def _scripted_sampler(package, sampler_cls, policy_cls=ScriptedPolicy):
    if package == "port":
        make, vec = registry.get_env_creator("PongLite-v0"), VectorEnv
        policy = policy_cls(post.compute_gae_for_sample_batch, fs.compress_fragment_obs)
    else:
        make, vec = ref_registry.get_env_creator("PongLite-v0"), RefVectorEnv
        policy = policy_cls(ref_post.compute_gae_for_sample_batch, ref_fs.compress_fragment_obs)
    random.seed(0)  # episode ids
    envs = vec.vectorize_gym_envs(lambda i: make(dict(PONG_CFG)), 2, seed=4)
    return sampler_cls(vector_env=envs, policy=policy, rollout_fragment_length=32)


def _first_fragments(sampler, n=2):
    try:
        return [sampler.sample() for _ in range(n)]
    finally:
        if hasattr(sampler, "stop"):
            sampler.stop()


def test_async_sampler_stream_equals_sync_and_reference():
    """One sampler at a time (episode ids come from the global
    ``random``, which only the sampling thread draws from)."""
    sync = _first_fragments(_scripted_sampler("port", SyncSampler))
    port = _first_fragments(_scripted_sampler("port", AsyncSampler))
    ref = _first_fragments(_scripted_sampler("reference", RefAsyncSampler))
    for p, s, r in zip(port, sync, ref):
        _assert_batches_equal(p, s)
        _assert_batches_equal(p, r)
        assert p.count == 64
    assert fs.FRAMES in port[0] and port[0]["dones"].any()


def test_async_sampler_stop_and_thread_error():
    sampler = _scripted_sampler("port", AsyncSampler)
    assert sampler.sample().count == 64 and sampler._thread.is_alive()
    sampler.stop()
    assert not sampler._thread.is_alive()

    class Failing(ScriptedPolicy):
        calls = 0

        def compute_actions(self, *args, **kwargs):
            Failing.calls += 1
            if Failing.calls > 40:
                raise ValueError("boom in the sampling thread")
            return super().compute_actions(*args, **kwargs)

    sampler = _scripted_sampler("port", AsyncSampler, Failing)
    try:
        assert sampler.sample().count == 64  # 32 steps, before the error
        with pytest.raises(ValueError, match="boom in the sampling thread"):
            sampler.sample()
        assert not sampler._thread.is_alive()
    finally:
        sampler.stop()


def _logp(policy, weights, obs, actions):
    policy.set_weights(weights)
    with torch.no_grad():
        dist = policy.dist_class(policy.model_forward(torch.as_tensor(obs))[0])
        return dist.logp(torch.as_tensor(actions)).numpy()


def test_weight_swaps_are_atomic_towards_the_sampling_thread():
    """A worker (index 1, as a remote one) samples on its thread while
    the main thread swaps its weights between two sets as fast as it can:
    every row's ``action_logp`` is the logp of one whole set, never of a
    half-copied net. Rows where the two sets agree within 1e-4 tell
    nothing and are not counted."""
    threads = torch.get_num_threads()
    cfg = {"sample_async": True, "rollout_fragment_length": 16, "num_envs_per_worker": 2,
           "model": {"fcnet_hiddens": [64, 64]}, "seed": 1}
    worker = RolloutWorker(env_creator=registry.get_env_creator("CartPole-v1"),
                           policy_cls=PPOTorchPolicy, config=cfg, worker_index=1, num_workers=1)
    try:
        assert isinstance(worker.sampler, AsyncSampler)
        a = {k: v.copy() for k, v in worker.get_weights()["default_policy"].items()}
        b = {k: -1.5 * v for k, v in a.items()}
        frags, stop = [], threading.Event()

        def swap():
            while not stop.is_set():
                for w in (a, b):
                    worker.set_weights({"default_policy": w})

        swapper = threading.Thread(target=swap)
        swapper.start()
        try:
            for _ in range(12):
                frags.append(worker.sample())
        finally:
            stop.set()
            swapper.join()
    finally:
        worker.stop()
        torch.set_num_threads(threads)
    batch = concat_samples(frags)
    probe = PPOTorchPolicy(worker.policy().observation_space, worker.policy().action_space,
                           cfg, device="cpu")
    obs, act = batch["obs"], batch["actions"]
    la, lb = _logp(probe, a, obs, act), _logp(probe, b, obs, act)
    got = batch["action_logp"]
    telling = np.abs(la - lb) > 1e-4
    whole = (np.abs(got - la) < 1e-5) | (np.abs(got - lb) < 1e-5)
    assert telling.sum() >= 32
    assert whole[telling].all(), np.flatnonzero(telling & ~whole)
    # both sets acted
    assert (np.abs(got - la) < 1e-5)[telling].any() and (np.abs(got - lb) < 1e-5)[telling].any()


# -- the one-round-stale off-policy round -----------------------------------------


def _stale_round_algo(config_cls, env):
    return (config_cls().environment(env)
            .rollouts(num_rollout_workers=1, rollout_fragment_length=8)
            .training(train_batch_size=16, num_steps_sampled_before_learning_starts=16,
                      sample_async=True)
            .debugging(seed=2).resources(device="cpu").build())


@pytest.mark.parametrize("config_cls,env", [(DQNConfig, "CartPole-v1"), (SACConfig, "Pendulum-v1")])
def test_one_round_stale_round_inserts_last_rounds_request(runtime, config_cls, env):
    algo = _stale_round_algo(config_cls, env)
    try:
        inserted = []
        add = algo.local_replay_buffer.add

        def recording_add(batch, policy_id="default_policy"):
            inserted.append(batch)
            return add(batch, policy_id)

        algo.local_replay_buffer.add = recording_add
        requested = []
        for _ in range(5):
            algo.training_step()
            (ref,) = algo._pending_sample_refs
            requested.append(core.get(ref))  # the next round's fragment
        assert [b.count for b in inserted] == [8] * 5
        # round r inserts what was requested in round r - 1 (obs before the
        # n-step fold, which DQN's default n_step 1 leaves as it is)
        for want, got in zip(requested[:-1], inserted[1:]):
            np.testing.assert_array_equal(got["obs"], want["obs"])
            np.testing.assert_array_equal(got["eps_id"], want["eps_id"])
        assert algo._counters["num_env_steps_sampled"] == 40
        assert algo._counters["num_env_steps_trained"] > 0
        worker = algo.workers.remote_workers()[0]
        assert core.get(worker.apply.remote(lambda w: type(w.sampler).__name__)) == "AsyncSampler"
        state = algo.__getstate__()
        algo.__setstate__(state)
        assert algo._pending_sample_refs is None  # a restore drops the stale request
        algo.training_step()
        assert algo._pending_sample_refs is not None
    finally:
        algo.stop()
    assert algo._pending_sample_refs is None


def test_sample_async_refused_on_the_learners_own_worker():
    cfg = (DQNConfig().environment("CartPole-v1").rollouts(num_rollout_workers=0)
           .training(sample_async=True).resources(device="cpu"))
    with pytest.raises(ValueError, match="sample_async needs remote rollout workers"):
        cfg.build()


# -- the learner thread's fused superstep -------------------------------------------

T_UNROLL, B_TRAIN = 8, 32
FLAT_CFG = {"rollout_fragment_length": T_UNROLL, "train_batch_size": B_TRAIN,
            "_fixed_unrolls": True, "superstep": 2, "model": {"fcnet_hiddens": [16]},
            "seed": 3, "lr": 1e-3}


def _flat_unrolls(seed, unrolls=6):
    """Fixed unrolls of CartPole-shaped rows (episode ends inside)."""
    rng = np.random.default_rng(seed)
    n = unrolls * T_UNROLL
    obs = rng.standard_normal((n + 1, 4)).astype(np.float32)
    dones = rng.random(n) < 0.1
    return SampleBatch({
        SampleBatch.OBS: obs[:-1], SampleBatch.NEXT_OBS: obs[1:],
        SampleBatch.ACTIONS: rng.integers(0, 2, n),
        SampleBatch.REWARDS: rng.standard_normal(n).astype(np.float32),
        SampleBatch.TERMINATEDS: dones, SampleBatch.TRUNCATEDS: np.zeros(n, bool),
        SampleBatch.ACTION_LOGP: np.full(n, -0.69, np.float32),
        SampleBatch.EPS_ID: np.cumsum(dones).astype(np.int64),
    })


@pytest.mark.parametrize("cls", [ImpalaTorchPolicy, APPOTorchPolicy])
def test_fused_learner_steps_equal_sequential_learns(cls):
    """Four queued batches of six unrolls, trimmed to the train batch's
    four: two fused supersteps of K = 2, each update's stats out on its
    own, bitwise the sequential learns of the trimmed batches."""
    space, act = Box(-10.0, 10.0, (4,), np.float32), Discrete(2)
    threaded, sync = (cls(space, act, dict(FLAT_CFG), device="cpu") for _ in range(2))
    assert threaded.supports_superstep
    batches = [_flat_unrolls(s) for s in range(4)]
    lt = LearnerThread(threaded, publish_weights_every=2)
    assert lt._superstep_k == 2 and lt._defer
    for b in batches:  # queued before the thread starts: a backlog of K
        assert lt.add_batch(b)
    lt.start()
    deadline = time.time() + 60
    while lt.num_steps < 4 and time.time() < deadline:
        time.sleep(0.02)
    lt.stop()
    assert lt.error is None and lt.num_steps == 4 and lt.num_supersteps == 2
    got = [lt.outqueue.get_nowait() for _ in range(4)]
    want = []
    for b in batches:
        tree, bsize = sync.prepare_batch(b)
        assert bsize == 6
        dev = {k: torch.as_tensor(v[:4]) for k, v in tree.items()}
        want.append(sync.learn_on_device_batch(dev, 4))
    assert [steps for steps, _ in got] == [48] * 4  # each update counts its batch
    assert [info for _, info in got] == want
    for (name, a), b in zip(threaded.get_weights().items(), sync.get_weights().values()):
        assert np.array_equal(a, b), name
    assert threaded.opt_state.count == sync.opt_state.count == 4
    (runner,) = threaded._superstep_runners.values()
    assert runner.k_max == 2 and runner.drains == 2


def test_deferred_stats_hold_no_autograd_graph():
    """A deferred learn's stats are detached: they do not keep the
    update's graph (and the gradient nodes of the parameters, tied to the
    stream they were made on, which a later graph capture on another
    stream must not meet) alive until they are read."""
    policy = ImpalaTorchPolicy(Box(-10.0, 10.0, (4,), np.float32), Discrete(2), dict(FLAT_CFG),
                               device="cpu")
    tree, bsize = policy.prepare_batch(_flat_unrolls(0))
    stats = policy.learn_on_device_batch({k: torch.as_tensor(v) for k, v in tree.items()}, bsize,
                                         defer_stats=True)
    assert not stats._host.requires_grad and stats._host.grad_fn is None
    assert all(np.isfinite(v) for v in stats.result().values())


def _trim(thread_cls, policy, tree, bsize, k=2):
    fake = SimpleNamespace(policy=policy, _superstep_k=k)
    out, size = thread_cls._trim_fixed(fake, dict(tree), bsize)
    return {c: np.asarray(v) for c, v in out.items()}, size, fake._superstep_k


@pytest.mark.parametrize("case", ["unrolls", "rows", "recurrent", "short", "frames"])
def test_trim_fixed_matches_reference(case):
    rng = np.random.default_rng(0)
    unroll_len, unroll_T, target, bsize = {
        "unrolls": (8, 1, 32, 6), "rows": (0, 1, 30, 40), "recurrent": (0, 4, 30, 40),
        "short": (0, 1, 30, 20), "frames": (0, 1, 30, 40)}[case]
    tree = {"obs": rng.standard_normal((bsize, 3)).astype(np.float32),
            "actions": rng.integers(0, 2, bsize)}
    if case == "recurrent":
        tree["__chunk__state_in_0"] = rng.standard_normal((bsize // unroll_T, 5)).astype(np.float32)
    if case == "frames":
        tree[fs.FRAMES] = rng.integers(0, 255, (7, 2, 2, 1), dtype=np.uint8)
    policy = SimpleNamespace(config={"train_batch_size": target}, unroll_len=unroll_len,
                             n_shards=1, _unroll_T=unroll_T)
    p_tree, p_size, p_k = _trim(LearnerThread, policy, tree, bsize)
    r_tree, r_size, r_k = _trim(RefLearnerThread, policy, tree, bsize)
    assert (p_size, p_k) == (r_size, r_k)
    assert set(p_tree) == set(r_tree)
    for c in r_tree:
        assert p_tree[c].dtype == r_tree[c].dtype and np.array_equal(p_tree[c], r_tree[c]), c
    assert p_k == (1 if case == "frames" else 2)


def test_frame_pool_batches_demote_the_thread_to_one_update_a_step():
    threaded, sync = _pair("impala")
    threaded.config["superstep"] = sync.config["superstep"] = 2
    lt = LearnerThread(threaded)
    assert lt._superstep_k == 2
    batches = [_pooled_batch(sync, seed) for seed in range(3)]
    _run_thread(lt, batches)
    assert lt._superstep_k == 1 and lt.num_supersteps == 0 and lt.num_steps == 3
    infos = [lt.outqueue.get_nowait()[1] for _ in range(3)]
    assert infos == [sync.learn_on_batch(b) for b in batches]


# -- PPO's prefetch at K = 2 ----------------------------------------------------------


def test_ppo_prefetch_superstep_equals_two_sequential_learns(runtime):
    cfg = PPOConfig().update_from_dict({
        "seed": 0, "num_workers": 2, "num_envs_per_worker": 2, "rollout_fragment_length": 16,
        "train_batch_size": 64, "sgd_minibatch_size": 32, "num_sgd_iter": 2, "lr": 1e-3,
        "kl_coeff": 0.2, "kl_target": 1e-4, "device": "cpu", "model": {"fcnet_hiddens": [16]},
        "sample_prefetch": 2, "superstep": 2,
    })
    cfg.env = "CartPole-v1"
    algo = cfg.build()
    try:
        policy = algo.get_policy()
        # (CPU arrays of get_state share memory with the parameters)
        state = copy.deepcopy(policy.get_state())
        perm_state = policy.perm_generator.get_state()
        taken = []
        real_next = algo._next_prefetched

        def recording_next():
            dev, meta = real_next()
            taken.append(({k: v.clone() for k, v in dev.items()}, meta))
            return dev, meta

        algo._next_prefetched = recording_next
        r = algo.train()
        assert len(taken) == 2 and algo._counters["num_prefetch_supersteps"] == 1
        assert r["num_env_steps_trained"] == sum(m[1] for _, m in taken)
        seq = PPOTorchPolicy(policy.observation_space, policy.action_space, policy.config,
                             device="cpu")
        seq.set_state(state)
        seq.perm_generator.set_state(perm_state)
        kl = seq.coeff_values["kl_coeff"]
        outs = []
        for dev, (bsize, _, _) in taken:
            seq.coeff_values["kl_coeff"] = kl  # the superstep reads it once
            out = seq.learn_on_device_batch(dev, bsize)
            out.pop("cur_kl_coeff")
            outs.append(out)
        seq.coeff_values["kl_coeff"] = kl
        for out in outs:  # then the KL reaction, update by update
            out.update(seq.after_learn_on_batch(out))
        assert r["info"]["learner"]["default_policy"] == outs[-1]
        assert seq.coeff_values["kl_coeff"] == policy.coeff_values["kl_coeff"] != kl
        for (name, a), b in zip(policy.get_weights().items(), seq.get_weights().values()):
            assert np.array_equal(a, b), name
    finally:
        algo.stop()


# -- IMPALA's aggregation actors ------------------------------------------------------


def test_aggregator_concat_equals_reference():
    frags = [_flat_unrolls(s, unrolls=2) for s in range(5)]  # 16 steps each
    agg = AggregatorWorker(40)
    out = [agg.aggregate(f) for f in frags]
    assert [o is None for o in out] == [True, True, False, True, True]
    want = ref_concat([RefSampleBatch(dict(f)) for f in frags[:3]])
    _assert_batches_equal(out[2], want)
    assert agg._steps == 32 and len(agg._buf) == 2


def test_impala_with_an_aggregator_trains_and_drops_a_dead_worker(runtime):
    cfg = IMPALAConfig().update_from_dict({
        "device": "cpu", "num_workers": 2, "rollout_fragment_length": 16, "train_batch_size": 64,
        "model": {"fcnet_hiddens": [16]}, "seed": 0, "superstep": 2,
        "num_aggregation_workers": 1, "min_time_s_per_iteration": 0.5,
    })
    cfg.env = "CartPole-v1"
    algo = cfg.build()
    try:
        assert len(algo._aggregators) == 1 and algo._sample_manager._return_refs
        deadline = time.time() + 60
        while algo.num_aggregated_batches < 3 and time.time() < deadline:
            r = algo.train()
        assert algo.num_aggregated_batches >= 3
        assert r["num_env_steps_sampled"] >= 3 * 64
        core.kill(algo.workers.remote_workers()[1])
        deadline = time.time() + 60
        while algo._counters["num_dead_rollout_workers"] == 0 and time.time() < deadline:
            algo.train()
        assert algo._counters["num_dead_rollout_workers"] == 1
        assert algo.workers.num_remote_workers() == 1
        before = algo.num_aggregated_batches
        while algo.num_aggregated_batches == before and time.time() < deadline:
            r = algo.train()
        assert algo.num_aggregated_batches > before
        assert all(np.isfinite(v) for v in r["info"]["learner"]["default_policy"].values())
        assert algo._learner_thread.healthy()
    finally:
        algo.stop()
    assert algo._aggregators == []
