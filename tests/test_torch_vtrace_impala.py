"""V-trace, IMPALA and APPO of the port against the reference's, on the CPU.

Contracts:

- V-trace: within 1e-5 relative (and 1e-6 absolute) of
  ``ray_tpu.ops.vtrace`` and of a sequential numpy transcription, with
  episode resets inside the fragment, both clip thresholds set, moved
  and None. The port scans by doubling, the reference by
  ``lax.associative_scan``: the same recurrence in another float32
  rounding order.
- bitwise: the train trees of ``ImpalaTorchPolicy`` and
  ``APPOTorchPolicy`` against ``ImpalaJaxPolicy`` and ``APPOJaxPolicy``
  (flat obs, stacked pixels with and without the unroll dedup, and
  worker-pooled fixed unrolls); the fixed-unroll ``SyncSampler`` on
  PongLite-v0 under one scripted policy that both samplers drive.
- the PPO learn test's tolerance: one learn call of both policies on a
  pooled pixel batch (24x24x4, float32 model, 6 unrolls of 8 steps,
  2 minibatches), the port started from the reference's weights and
  handed its permutations: stats within 1e-4 relative, parameters within
  1e-5 relative plus 5e-5 absolute (Adam turns float32 noise in a
  near-zero gradient into a visible part of the step).

And end to end: APPO's target refresh is taken between two learner
steps (a copy from the main thread mid-step would tear);
``IMPALA.train()`` and ``APPO.train()`` with ``num_workers: 0`` and with
2 remote workers on PongLite-v0 (IMPALA then loses one worker and
samples on with the other); the configs that need a later slice
raise; the slow tests run ``cartpole-impala.yaml`` and
``cartpole-appo.yaml`` as written to the reference tests' bar (best
``episode_reward_mean`` >= 100).
"""

from __future__ import annotations

import pathlib
import random
import threading
import time

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.algorithms.appo.appo import APPOJaxPolicy
from ray_tpu.algorithms.impala.impala import ImpalaJaxPolicy
from ray_tpu.data.sample_batch import SampleBatch as RefSampleBatch
from ray_tpu.data.sample_batch import concat_samples as ref_concat
from ray_tpu.env import registry as ref_registry
from ray_tpu.env.vector_env import VectorEnv as RefVectorEnv
from ray_tpu.evaluation.sampler import SyncSampler as RefSyncSampler
from ray_tpu.ops import framestack as ref_fs
from ray_tpu.ops import vtrace as ref_vtrace
from ray_tpu.sharding import get_mesh
from ray_tpu_torch import core
from ray_tpu_torch.algorithms.appo.appo import APPOConfig, APPOTorchPolicy
from ray_tpu_torch.algorithms.impala.impala import IMPALAConfig, ImpalaTorchPolicy
from ray_tpu_torch.algorithms.registry import get_algorithm_class
from ray_tpu_torch.data.sample_batch import SampleBatch, concat_samples
from ray_tpu_torch.env import registry
from ray_tpu_torch.env.spaces import Box, Discrete
from ray_tpu_torch.env.vector_env import VectorEnv
from ray_tpu_torch.evaluation.sampler import SyncSampler
from ray_tpu_torch.ops import framestack as fs
from ray_tpu_torch.ops import vtrace
from ray_tpu_torch.utils.jax_params import flax_to_state_dict, from_jax_params
from ray_tpu_torch.utils.tuned_example import build_tuned_example

REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL_CNN = {"dtype": "float32", "conv_filters": [[8, [8, 8], [4, 4]], [8, [4, 4], [2, 2]]],
             "post_fcnet_hiddens": [32]}
PONG_CFG = {"rallies": 1, "max_steps": 25}  # episodes end inside the unrolls
T, A = 8, 3
POLICIES = [(ImpalaTorchPolicy, ImpalaJaxPolicy), (APPOTorchPolicy, APPOJaxPolicy)]


def _assert_same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b), what


def _assert_trees_equal(port, ref):
    assert set(port) == set(ref), (sorted(port), sorted(ref))
    for k in ref:
        _assert_same(port[k], ref[k], k)


# -- V-trace -------------------------------------------------------------------


def _vtrace_np(log_rhos, discounts, rewards, values, bootstrap_value, clip_rho, clip_pg_rho):
    """Sequential numpy transcription (``tests/test_gae_vtrace.py``)."""
    B, n = rewards.shape
    rhos = np.exp(log_rhos)
    clipped = rhos if clip_rho is None else np.minimum(clip_rho, rhos)
    cs = np.minimum(1.0, rhos)
    values_tp1 = np.concatenate([values[:, 1:], bootstrap_value[:, None]], 1)
    deltas = clipped * (rewards + discounts * values_tp1 - values)
    acc = np.zeros(B)
    vs_minus_v = np.zeros_like(values)
    for t in range(n - 1, -1, -1):
        acc = deltas[:, t] + discounts[:, t] * cs[:, t] * acc
        vs_minus_v[:, t] = acc
    vs = vs_minus_v + values
    vs_tp1 = np.concatenate([vs[:, 1:], bootstrap_value[:, None]], 1)
    clipped_pg = rhos if clip_pg_rho is None else np.minimum(clip_pg_rho, rhos)
    return vs, clipped_pg * (rewards + discounts * vs_tp1 - values)


def _vtrace_inputs(seed, B, n):
    rng = np.random.default_rng(seed)
    dones = (rng.random((B, n)) < 0.1).astype(np.float32)
    return (
        (rng.standard_normal((B, n)) * 0.5).astype(np.float32),
        (0.99 * (1.0 - dones)).astype(np.float32),
        rng.standard_normal((B, n)).astype(np.float32),
        rng.standard_normal((B, n)).astype(np.float32),
        rng.standard_normal(B).astype(np.float32),
    )


@pytest.mark.parametrize("B,n", [(4, 30), (3, 1), (2, 64), (5, 17)])
@pytest.mark.parametrize("clip_rho,clip_pg_rho", [(1.0, 1.0), (2.0, 0.5), (None, None)])
def test_vtrace_matches_reference_and_numpy(B, n, clip_rho, clip_pg_rho):
    args = _vtrace_inputs(B * 100 + n, B, n)
    got = vtrace.vtrace_from_importance_weights(*map(torch.as_tensor, args), clip_rho, clip_pg_rho)
    ref = ref_vtrace.vtrace_from_importance_weights(*map(jnp.asarray, args), clip_rho, clip_pg_rho)
    vs_np, pg_np = _vtrace_np(*args, clip_rho, clip_pg_rho)
    for name, want in (("vs", np.asarray(ref.vs)), ("pg_advantages", np.asarray(ref.pg_advantages))):
        np.testing.assert_allclose(getattr(got, name).numpy(), want, rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(got.vs.numpy(), vs_np, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.pg_advantages.numpy(), pg_np, rtol=1e-5, atol=1e-6)


def test_vtrace_from_logits_matches_reference_and_detaches():
    log_rhos, discounts, rewards, values, bootstrap = _vtrace_inputs(7, 3, 12)
    behaviour = np.full_like(log_rhos, -1.1)
    target = behaviour + log_rhos
    t_target = torch.as_tensor(target, dtype=torch.float32).requires_grad_()
    t_values = torch.as_tensor(values).requires_grad_()
    got = vtrace.vtrace_from_logits(torch.as_tensor(behaviour), t_target, torch.as_tensor(discounts),
                                    torch.as_tensor(rewards), t_values, torch.as_tensor(bootstrap))
    ref = ref_vtrace.vtrace_from_logits(*map(jnp.asarray, (behaviour, target, discounts, rewards,
                                                           values, bootstrap)))
    np.testing.assert_allclose(got.vs.numpy(), np.asarray(ref.vs), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.pg_advantages.numpy(), np.asarray(ref.pg_advantages),
                               rtol=1e-5, atol=1e-6)
    assert not got.vs.requires_grad and not got.pg_advantages.requires_grad


def test_linear_recurrence_takes_log_depth_rounds():
    calls = []
    real = vtrace._shift_left
    vtrace._shift_left = lambda x, s: calls.append(s) or real(x, s)
    try:
        y = vtrace.linear_recurrence_reverse(torch.full((2, 100), 0.5), torch.ones(2, 100))
    finally:
        vtrace._shift_left = real
    assert sorted(set(calls)) == [1, 2, 4, 8, 16, 32, 64] and len(calls) == 14
    np.testing.assert_allclose(y[0, -1].item(), 1.0)
    np.testing.assert_allclose(y[0, 0].item(), 2.0, rtol=1e-6)


# -- train trees -----------------------------------------------------------------


def _stream_stacks(rng, n, k=4, hw=(24, 24)):
    stream = rng.integers(0, 255, (n + k - 1,) + hw + (1,), dtype=np.uint8)
    return ref_fs.materialize_stacks_np(stream, np.arange(n), k)


def _unroll(rng, unroll_id, reset_at=None):
    """A fixed unroll of T pixel steps; with ``reset_at`` an episode ends
    at that row and a fresh window starts after it (its next obs is the
    terminal stack, which slides)."""
    if reset_at is None:
        s = _stream_stacks(rng, T + 1)
        obs, nxt = s[:T], s[1:]
    else:
        a, b = _stream_stacks(rng, reset_at + 1), _stream_stacks(rng, T - reset_at + 1)
        obs = np.concatenate([a[:reset_at], b[:T - reset_at]])
        nxt = np.concatenate([a[1:], b[1:]])
    dones = np.zeros(T, bool)
    truncs = np.zeros(T, bool)
    if reset_at is not None:
        (truncs if unroll_id % 2 else dones)[reset_at - 1] = True
    return {
        "obs": obs, "new_obs": nxt, "dones": dones, "truncateds": truncs,
        "actions": rng.integers(0, A, T).astype(np.int64),
        "rewards": rng.standard_normal(T).astype(np.float32),
        "action_logp": (-1.1 + 0.1 * rng.standard_normal(T)).astype(np.float32),
        "eps_id": np.full(T, unroll_id, np.int64), "unroll_id": np.full(T, unroll_id, np.int64),
        "agent_index": np.zeros(T, np.int64), "t": np.arange(T, dtype=np.int64),
    }


def _unrolls(seed, n=6):
    rng = np.random.default_rng(seed)
    return [_unroll(rng, i, reset_at=(None, 3, 1, None, 7, 5)[i % 6]) for i in range(n)]


def _policies(cls_pair, cfg=None, obs_shape=(24, 24, 4)):
    port_cls, ref_cls = cls_pair
    cfg = {"model": SMALL_CNN, "seed": 0, "rollout_fragment_length": T, "train_batch_size": 3 * T,
           "lr": 1e-3, "_fixed_unrolls": True, **(cfg or {})}
    dtype = np.uint8 if len(obs_shape) == 3 else np.float32
    lo, hi = (0, 255) if dtype == np.uint8 else (-1, 1)
    port = port_cls(Box(lo, hi, obs_shape, dtype), Discrete(A), cfg, device="cpu")
    ref = ref_cls(gym.spaces.Box(lo, hi, obs_shape, dtype), gym.spaces.Discrete(A),
                  {**cfg, "_mesh": get_mesh(devices=jax.devices()[:1])})
    return port, ref


@pytest.mark.parametrize("cls_pair", POLICIES, ids=["impala", "appo"])
@pytest.mark.parametrize("case", ["flat_obs", "stacked", "unroll_dedup", "pooled"])
def test_train_tree_matches_reference(cls_pair, case):
    frags = _unrolls(1)
    if case == "flat_obs":
        port, ref = _policies(cls_pair, {"model": {"dtype": "float32"}}, obs_shape=(5,))
        rng = np.random.default_rng(2)
        for f in frags:
            f["obs"] = rng.standard_normal((T, 5)).astype(np.float32)
            f["new_obs"] = rng.standard_normal((T, 5)).astype(np.float32)
    else:
        cfg = {"dedup_framestack_min_bytes": 0} if case == "unroll_dedup" else {}
        port, ref = _policies(cls_pair, cfg)
    if case == "pooled":
        p_batch = concat_samples([port.compress_for_shipping(SampleBatch(dict(f))) for f in frags])
        r_batch = ref_concat([ref.compress_for_shipping(RefSampleBatch(dict(f))) for f in frags])
        assert fs.FRAMES in p_batch
        _assert_trees_equal(p_batch, r_batch)
    else:
        p_batch = concat_samples([SampleBatch(dict(f)) for f in frags])
        r_batch = RefSampleBatch(dict(p_batch))
    p, r = port._batch_to_train_tree(p_batch), ref._batch_to_train_tree(r_batch)
    _assert_trees_equal(p, r)
    assert (fs.FRAMES in p) == (case in ("unroll_dedup", "pooled"))
    if fs.FRAMES in p:
        assert p[fs.FRAME_IDX].shape == (6, T + 1)
    assert p["dones"].sum() == 4  # two terminations, two truncations
    tree, bsize = port.prepare_batch(p_batch)
    assert bsize == 6 and set(tree) == set(p)


def test_rebuilt_unrolls_equal_the_stacked_batch():
    port, _ = _policies(POLICIES[0])
    frags = _unrolls(3)
    pooled = port._batch_to_train_tree(
        concat_samples([port.compress_for_shipping(SampleBatch(dict(f))) for f in frags]))
    stacked = port._batch_to_train_tree(concat_samples([SampleBatch(dict(f)) for f in frags]))
    rebuilt = port._with_stacks({k: torch.as_tensor(v) for k, v in pooled.items()})
    _assert_same(rebuilt["obs"].numpy(), stacked["obs"], "obs")
    _assert_same(rebuilt["bootstrap_obs"].numpy(), stacked["bootstrap_obs"], "bootstrap_obs")


@pytest.mark.parametrize("cls_pair", POLICIES, ids=["impala", "appo"])
def test_pooled_learn_equals_host_materialized_learn(cls_pair):
    """A pooled round learned as shipped, and the same round rebuilt into
    stacks on the host (``materialize_fragment``; the dedup off), by two
    fresh policies on the same permutations: bitwise the same stats and
    parameters (the chip smoke's impala_parity holds the card to this)."""
    pooled_p, _ = _policies(cls_pair)
    stacked_p, _ = _policies(cls_pair, {"dedup_framestack": False})
    pooled = concat_samples([pooled_p.compress_for_shipping(SampleBatch(dict(f)))
                             for f in _unrolls(4)])
    stacked = SampleBatch(fs.materialize_fragment(dict(pooled), 4))
    assert fs.FRAMES in pooled and fs.FRAMES not in stacked
    perms = pooled_p.draw_permutations(pooled_p.prepare_batch(pooled)[1])
    s_pooled = pooled_p.learn_on_batch(pooled, perms=perms)
    s_stacked = stacked_p.learn_on_batch(stacked, perms=perms)
    assert pooled_p.last_learn_timers["learn_frame_pool"] == 1.0
    assert stacked_p.last_learn_timers["learn_frame_pool"] == 0.0
    assert s_pooled == s_stacked
    for (name, a), b in zip(pooled_p.get_weights().items(), stacked_p.get_weights().values()):
        _assert_same(a, b, name)


# -- one learn call against the reference ------------------------------------------------


def _reference_perms(key, batch_size, iters=1):
    """The permutations ``JaxPolicy``'s nest draws on shard 0 (as in
    ``tests/test_torch_ppo.py``)."""
    _, rng = jax.random.split(key)
    rng = jax.random.fold_in(rng, 0)
    return np.stack([
        np.asarray(jax.random.permutation(jax.random.split(r)[0], batch_size))
        for r in jax.random.split(rng, iters)
    ])


@pytest.mark.parametrize("cls_pair", POLICIES, ids=["impala", "appo"])
def test_one_learn_call_matches_reference(cls_pair):
    port, ref = _policies(cls_pair, {"entropy_coeff": 0.01, "grad_clip": 40.0})
    from_jax_params(jax.device_get(ref.params), port.model)
    if hasattr(port, "update_target"):
        port.update_target()
    frags = _unrolls(4)
    batch = concat_samples([port.compress_for_shipping(SampleBatch(dict(f))) for f in frags])
    perms = _reference_perms(ref._rng, 6)

    ref_stats = ref.learn_on_batch(RefSampleBatch(dict(batch)))
    stats = port.learn_on_batch(batch, perms=torch.as_tensor(perms))

    assert set(stats) == set(ref_stats)
    for k, v in ref_stats.items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-4, atol=1e-7, err_msg=k)
    assert port.opt_state.count == 2  # 6 unrolls in minibatches of 3
    got = port.get_weights()
    for name, r in flax_to_state_dict(jax.device_get(ref.params)).items():
        np.testing.assert_allclose(got[name], r, rtol=1e-5, atol=5e-5, err_msg=name)


# -- the fixed-unroll sampler ------------------------------------------------------


class ScriptedPolicy:
    """One policy both packages' samplers drive: actions from a seeded
    stream, no postprocessing, and the given package's fragment
    compression (the fixed-unroll shipping rule)."""

    is_recurrent = False

    def __init__(self, compress):
        self.config = {}
        self._rng = np.random.default_rng(5)
        self._compress = compress

    def get_initial_state(self):
        return []

    def compute_actions(self, obs, state_batches=None, explore=True, **kwargs):
        n = len(obs)
        return self._rng.integers(0, 3, n), [], {"action_logp": np.full(n, -1.0986, np.float32)}

    def postprocess_trajectory(self, batch, other_agent_batches=None, episode=None):
        return batch

    def compress_for_shipping(self, batch):
        dones = np.asarray(batch["dones"]) | np.asarray(batch["truncateds"])
        dec = self._compress(batch["obs"], batch["new_obs"], dones)
        if dec is None:
            return batch
        cols = {k: v for k, v in batch.items() if k not in ("obs", "new_obs")}
        cols[fs.FRAMES], cols[fs.FRAME_IDX] = dec
        return type(batch)(cols)


def _fixed_samples(package):
    if package == "port":
        make, vec, sampler_cls = registry.get_env_creator("PongLite-v0"), VectorEnv, SyncSampler
        policy = ScriptedPolicy(fs.compress_fragment_obs)
    else:
        make, vec, sampler_cls = ref_registry.get_env_creator("PongLite-v0"), RefVectorEnv, RefSyncSampler
        policy = ScriptedPolicy(ref_fs.compress_fragment_obs)
    random.seed(0)  # episode ids
    envs = vec.vectorize_gym_envs(lambda i: make(dict(PONG_CFG)), 2, seed=4)
    sampler = sampler_cls(vector_env=envs, policy=policy, rollout_fragment_length=32,
                          flush_on_episode_end=False)
    return [sampler.sample() for _ in range(2)], sampler.get_metrics()


def test_fixed_unroll_sampler_matches_reference():
    port, port_eps = _fixed_samples("port")
    ref, ref_eps = _fixed_samples("reference")
    for p, r in zip(port, ref):
        _assert_trees_equal(p, r)
        assert p.count == 64
        # two unrolls of exactly 32 steps, episodes ending inside them
        assert list(np.bincount(p["unroll_id"] - p["unroll_id"].min())) == [32, 32]
        assert (p["dones"] | p["truncateds"]).any()
        assert fs.FRAMES in p and len(p[fs.FRAME_IDX]) == 64
    assert [(e.episode_length, e.episode_reward) for e in port_eps] == [
        (e.episode_length, e.episode_reward) for e in ref_eps]
    assert len(port_eps) >= 4


def test_fixed_unrolls_need_truncate_episodes():
    envs = VectorEnv.vectorize_gym_envs(
        lambda i: registry.get_env_creator("PongLite-v0")(dict(PONG_CFG)), 1, seed=0)
    with pytest.raises(ValueError, match="truncate_episodes"):
        SyncSampler(vector_env=envs, policy=ScriptedPolicy(fs.compress_fragment_obs),
                    batch_mode="complete_episodes", flush_on_episode_end=False)


# -- the algorithms ------------------------------------------------------------------


@pytest.fixture(scope="module")
def runtime():
    core.shutdown()
    core.init(num_cpus=1)
    yield
    core.shutdown()


def _algo(config_cls, **over):
    cfg = config_cls().update_from_dict({
        "seed": 0, "num_workers": 2, "num_envs_per_worker": 2, "rollout_fragment_length": 16,
        "train_batch_size": 64, "lr": 1e-3, "device": "cpu", "model": SMALL_CNN,
        "env_config": dict(PONG_CFG), "min_time_s_per_iteration": 0, **over,
    })
    cfg.env = "PongLite-v0"
    return cfg.build()


def _train_until_trained(algo, steps, timeout_s=120):
    deadline = time.time() + timeout_s
    r = algo.train()
    while r["num_env_steps_trained"] < steps and time.time() < deadline:
        r = algo.train()
    return r


def _drop_a_worker(algo):
    """Kill one of two remote workers: the loop drops it from the
    rotation and the worker set, counts it, and samples on with the
    other."""
    victim = algo.workers.remote_workers()[1]
    core.kill(victim)
    deadline = time.time() + 60
    while algo.workers.num_remote_workers() == 2 and time.time() < deadline:
        algo.train()
    assert algo.workers.remote_workers() == algo._sample_manager.workers()
    assert algo.workers.num_remote_workers() == 1
    assert algo._counters["num_dead_rollout_workers"] == 1
    before = algo._counters["num_env_steps_sampled"]
    while algo._counters["num_env_steps_sampled"] == before and time.time() < deadline:
        algo.train()
    assert algo._counters["num_env_steps_sampled"] > before


@pytest.mark.parametrize("config_cls", [IMPALAConfig, APPOConfig], ids=["impala", "appo"])
@pytest.mark.parametrize("num_workers", [0, 2])
def test_train_on_ponglite(runtime, config_cls, num_workers):
    algo = _algo(config_cls, num_workers=num_workers)
    try:
        procs = [w._worker.process for w in algo.workers.remote_workers()]
        r = _train_until_trained(algo, 128)
        lt = algo._learner_thread
        assert r["num_env_steps_trained"] >= 128 and lt.healthy()
        assert r["num_env_steps_sampled"] >= r["num_env_steps_trained"]
        stats = lt.learner_info
        assert {"policy_loss", "vf_loss", "entropy", "total_loss", "grad_gnorm", "cur_lr"} <= set(stats)
        assert all(np.isfinite(v) for v in stats.values())
        # every learn went through the feeder, which may have copied ahead
        assert lt.feeder.num_batches >= lt.num_steps >= 2
        if num_workers:
            assert r["info"]["learner"]["sample_manager"]["num_live_workers"] == 2
            pub = lt.published_weights()
            assert pub is not None and pub[0] >= 1
        if config_cls is APPOConfig:
            assert algo._counters["num_target_updates"] >= 1 and "mean_is_ratio" in stats
        elif num_workers:
            _drop_a_worker(algo)
    finally:
        algo.stop()
    assert not lt.is_alive()
    assert all(not p.is_alive() for p in procs)


class _SlowStepAPPO(APPOTorchPolicy):
    """Moves each parameter by one, one at a time, with a pause between,
    so a learner step is seen half done from another thread."""

    mid_step = None

    def _sgd_nest_device(self, batch, batch_size, perms, coeffs):
        with torch.no_grad():
            for i, p in enumerate(self.params):
                p.add_(1.0)
                if i == 0:
                    self.mid_step.set()
                time.sleep(0.02)
        return ("total_loss",), torch.zeros(1)


def test_appo_target_refresh_is_taken_between_learner_steps():
    from ray_tpu_torch.algorithms.appo.appo import APPO

    class SlowAPPO(APPO):
        _default_policy_class = _SlowStepAPPO

    cfg = APPOConfig().update_from_dict({"num_workers": 0, "device": "cpu", "seed": 0,
                                         "rollout_fragment_length": 8, "train_batch_size": 16,
                                         "min_time_s_per_iteration": 0})
    cfg.env = "CartPole-v1"
    cfg.algo_class = SlowAPPO
    algo = cfg.build()
    policy = algo.get_policy()
    policy.mid_step = threading.Event()
    before = [p.detach().clone() for p in policy.params]
    try:
        algo.train()  # one train batch to the learner thread
        assert policy.mid_step.wait(30)
        # the main thread's refresh lands while the step is half done
        algo._refresh_target(kl=None)
        target = algo.get_policy().aux_state["target_params"]
        moved = [bool(torch.equal(t, b + 1.0)) for t, b in zip(target, before)]
        assert all(moved), moved  # the whole step, never a torn part of it
        # without the step lock the same copy tears: its first parameter
        # is after the next step, its last before it
        policy.mid_step.clear()
        algo.train()
        assert policy.mid_step.wait(30)
        policy.update_target()
        with algo._learner_thread.lock:
            after = [p.detach().clone() for p in policy.params]
        assert torch.equal(target[0], after[0]) and torch.equal(target[-1], after[-1] - 1.0)
    finally:
        algo.stop()


def test_later_slices_raise():
    """What IMPALA refuses: ``env_backend='jax'`` (the port's own: the
    reference's IMPALA ignores the key). The fleet and recovery hooks are
    ported (``tests/test_torch_stream.py``): a fleet change with nobody
    added is a no-op, a restore's recovery starts a new learner thread,
    and replacing no worker starts none. The aggregation actors and an
    explicit ``superstep`` are ported (``tests/test_torch_async_loop.py``):
    at ``num_workers: 0`` they build, with no aggregator (the local
    worker's batches are whole) and the learner thread at K = 2."""
    with pytest.raises(ValueError, match="the port refuses env_backend='jax'"):
        _algo(IMPALAConfig, num_workers=0, env_backend="jax")
    for cls in (IMPALAConfig, APPOConfig):
        fused = _algo(cls, num_workers=0, num_aggregation_workers=1, superstep=2)
        try:
            assert fused._aggregators == [] and fused._learner_thread._superstep_k == 2
            assert fused.train()["timesteps_total"] > 0
        finally:
            fused.stop()
    algo = _algo(IMPALAConfig, num_workers=0)
    try:
        algo.on_fleet_change([], [])
        old = algo._learner_thread
        algo.on_recovery("restore")
        assert algo._learner_thread is not old and algo._learner_thread.is_alive()
        assert not old.is_alive()
        assert algo.workers.replace_failed_workers([]) == []
        assert algo.train()["timesteps_total"] > 0
    finally:
        algo.stop()


def test_registry_resolves_the_ported_algorithms():
    for name in ("PPO", "DQN", "IMPALA", "APPO", "SAC", "DDPG", "TD3"):
        assert get_algorithm_class(name).__name__ == name
    assert get_algorithm_class("APEX").__name__ == "ApexDQN"
    assert get_algorithm_class("APEX_DDPG").__name__ == "ApexDDPG"
    with pytest.raises(NotImplementedError, match="not ported yet"):
        get_algorithm_class("Dreamer")
    algo, stop = build_tuned_example(REPO / "tuned_examples" / "impala" / "cartpole-impala.yaml",
                                     device="cpu")
    try:
        assert type(algo).__name__ == "IMPALA" and stop == {"episode_reward_mean": 150,
                                                            "timesteps_total": 200000}
        assert algo.config["rollout_fragment_length"] == 64 and algo.config["lr"] == 0.0005
        assert algo.get_policy().minibatch_size == 512 // 64
    finally:
        algo.stop()


def _learns_to(path, bar, budget_s):
    algo, stop = build_tuned_example(path, device="cpu")
    best, curve = -np.inf, []
    t0 = time.time()
    try:
        while time.time() - t0 < budget_s:
            r = algo.train()
            if np.isfinite(r["episode_reward_mean"]):
                best = max(best, r["episode_reward_mean"])
            curve.append((r["timesteps_total"], round(float(r["episode_reward_mean"]), 2)))
            if best >= bar or r["timesteps_total"] >= stop["timesteps_total"]:
                break
    finally:
        algo.stop()
    print(path.name, "curve", curve)
    return best, curve


@pytest.mark.slow
def test_cartpole_impala_yaml_reaches_its_bar():
    best, curve = _learns_to(REPO / "tuned_examples" / "impala" / "cartpole-impala.yaml", 100.0, 240)
    assert best >= 100.0, curve


@pytest.mark.slow
def test_cartpole_appo_yaml_reaches_its_bar(runtime):
    best, curve = _learns_to(REPO / "tuned_examples" / "appo" / "cartpole-appo.yaml", 100.0, 240)
    assert best >= 100.0, curve
