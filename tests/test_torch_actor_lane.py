"""The actor lane of the port against the reference's, on the CPU.

Contracts:

- bitwise: host GAE (``compute_advantages`` and
  ``compute_gae_for_sample_batch`` given the bootstrap value); the
  frame-pool format's host side (``decompose_*``, ``compress_*_obs``,
  ``materialize_fragment``, the policy's ``_maybe_dedup_framestack``
  and ``compress_for_shipping``) and ``concat_samples`` on a mix of
  pooled and stacked fragments; ``SyncSampler`` on PongLite-v0 (2 envs,
  fragment 32) under one scripted policy that both samplers drive (its
  actions from a seeded stream, its values a fixed function of the obs,
  its postprocessing and compression each package's own): obs, actions,
  rewards, dones, episode ids, advantages and frame pools;
- bitwise: a pooled batch and its stacked original learn the same
  parameters and stats on the same permutations;
- float32 tolerance (1e-5 relative, 1e-6 absolute): the GAE of a
  truncated fragment whose bootstrap value comes from the reference's
  FCNet weights carried into the port's (two frameworks' float32
  matmuls sum in other orders).

And the lane end to end: PPO with two remote rollout workers on
PongLite-v0 (device "cpu", fragment 16, 2 envs each) for 2 iterations:
the workers' policies are on the CPU with CUDA hidden and uninitialized,
their weights equal the learner's bitwise after ``sync_weights``, and
``stop()`` leaves no worker process. Configs that need a later slice
raise (a recurrent policy under the multi-agent sampler, which carries no state;
multi-agent policies on a single-agent env raise for want of a
MultiAgentEnv). The slow test runs ``tuned_examples/ppo/cartpole-ppo.yaml`` as
written to its bar (150 within 100,000 env steps).
"""

from __future__ import annotations

import pathlib
import random

import gymnasium as gym
import jax
import numpy as np
import pytest

from _torch_actor_probe import device_report, policy_weights
from ray_tpu.algorithms.ppo.ppo import PPOJaxPolicy
from ray_tpu.data.sample_batch import SampleBatch as RefSampleBatch
from ray_tpu.data.sample_batch import concat_samples as ref_concat
from ray_tpu.env import registry as ref_registry
from ray_tpu.env.vector_env import VectorEnv as RefVectorEnv
from ray_tpu.evaluation import postprocessing as ref_post
from ray_tpu.evaluation.sampler import SyncSampler as RefSyncSampler
from ray_tpu.ops import framestack as ref_fs
from ray_tpu.sharding import get_mesh
from ray_tpu_torch import core
from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig, PPOTorchPolicy
from ray_tpu_torch.data.sample_batch import SampleBatch, concat_samples
from ray_tpu_torch.env import registry
from ray_tpu_torch.env.spaces import Box, Discrete
from ray_tpu_torch.env.vector_env import VectorEnv
from ray_tpu_torch.evaluation import postprocessing as post
from ray_tpu_torch.evaluation.multi_agent_sampler import MultiAgentSyncSampler
from ray_tpu_torch.evaluation.sampler import SyncSampler
from ray_tpu_torch.execution.rollout_ops import synchronous_parallel_sample
from ray_tpu_torch.execution.train_ops import train_one_step
from ray_tpu_torch.ops import framestack as fs
from ray_tpu_torch.utils.jax_params import from_jax_params
from ray_tpu_torch.utils.tuned_example import load_tuned_example

REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL_CNN = {"dtype": "float32", "conv_filters": [[8, [8, 8], [4, 4]], [8, [4, 4], [2, 2]]],
             "post_fcnet_hiddens": [32]}
PONG_CFG = {"rallies": 1, "max_steps": 25}  # episodes end inside 32-step fragments


def _assert_same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b), what


def _assert_batches_equal(port, ref):
    assert set(port) == set(ref), (sorted(port), sorted(ref))
    for k in ref:
        _assert_same(port[k], ref[k], k)


# -- host GAE ----------------------------------------------------------------


def _fragment(seed, n=37, terminated=False, truncated=False):
    rng = np.random.default_rng(seed)
    cols = {
        "rewards": rng.standard_normal(n).astype(np.float32),
        "vf_preds": rng.standard_normal(n).astype(np.float32),
        "dones": np.zeros(n, bool),
        "truncateds": np.zeros(n, bool),
        "new_obs": rng.standard_normal((n, 4)).astype(np.float32),
    }
    cols["dones"][-1] = terminated
    cols["truncateds"][-1] = truncated
    return cols


@pytest.mark.parametrize("use_gae,use_critic", [(True, True), (False, True), (False, False)])
@pytest.mark.parametrize("gamma,lam", [(0.99, 0.95), (0.9, 1.0)])
def test_compute_advantages_matches_reference(use_gae, use_critic, gamma, lam):
    for seed, last_r in ((0, 0.0), (1, 1.2345)):
        cols = _fragment(seed)
        p = post.compute_advantages(SampleBatch(dict(cols)), last_r, gamma, lam, use_gae, use_critic)
        r = ref_post.compute_advantages(RefSampleBatch(dict(cols)), last_r, gamma, lam,
                                        use_gae, use_critic)
        _assert_same(p["advantages"], r["advantages"], "advantages")
        _assert_same(p["value_targets"], r["value_targets"], "value_targets")
    _assert_same(post.discount_cumsum(cols["rewards"], 0.97),
                 ref_post.discount_cumsum(cols["rewards"], 0.97), "discount_cumsum")


class _FixedValue:
    """The bootstrap value as a given number, for both packages."""

    is_recurrent = False

    def __init__(self, value):
        self.value = value
        self.config = {"gamma": 0.99, "lambda": 0.95}
        self.seen = []

    def get_initial_state(self):
        return []

    def value_batch(self, obs, state=None):
        self.seen.append(np.asarray(obs).copy())
        return np.array([self.value], np.float32)


@pytest.mark.parametrize("end", ["cut", "terminated", "truncated"])
def test_gae_for_sample_batch_matches_reference(end):
    cols = _fragment(2, terminated=end == "terminated", truncated=end == "truncated")
    pp, rp = _FixedValue(0.75), _FixedValue(0.75)
    p = post.compute_gae_for_sample_batch(pp, SampleBatch(dict(cols)))
    r = ref_post.compute_gae_for_sample_batch(rp, RefSampleBatch(dict(cols)))
    _assert_same(p["advantages"], r["advantages"], "advantages")
    _assert_same(p["value_targets"], r["value_targets"], "value_targets")
    assert len(pp.seen) == len(rp.seen) == (0 if end == "terminated" else 1)
    for a, b in zip(pp.seen, rp.seen):
        _assert_same(a, b, "bootstrap obs")


def test_gae_bootstrap_with_carried_weights():
    obs_space = gym.spaces.Box(-1, 1, (4,), np.float32)
    cfg = {"model": {"fcnet_hiddens": [32, 32]}, "gamma": 0.99, "lambda": 0.95, "seed": 1}
    ref = PPOJaxPolicy(obs_space, gym.spaces.Discrete(2),
                       {**cfg, "_mesh": get_mesh(devices=jax.devices()[:1])})
    port = PPOTorchPolicy(Box(-1, 1, (4,), np.float32), Discrete(2), cfg, device="cpu")
    from_jax_params(jax.device_get(ref.params), port.model)
    cols = _fragment(3, truncated=True)
    np.testing.assert_allclose(port.value_batch(cols["new_obs"]), ref.value_batch(cols["new_obs"]),
                               rtol=1e-5, atol=1e-6)
    p = port.postprocess_trajectory(SampleBatch(dict(cols)))
    r = ref.postprocess_trajectory(RefSampleBatch(dict(cols)))
    for k in ("advantages", "value_targets"):
        np.testing.assert_allclose(p[k], r[k], rtol=1e-5, atol=1e-6, err_msg=k)


# -- the frame-pool format -----------------------------------------------------


def _stream_stacks(rng, n, k=4, hw=(24, 24)):
    """(n, H, W, k) stacks of one sliding window over a random stream."""
    stream = rng.integers(0, 255, (n + k - 1,) + hw + (1,), dtype=np.uint8)
    return ref_fs.materialize_stacks_np(stream, np.arange(n), k)


def _segmented(rng, lens, k=4):
    return np.concatenate([_stream_stacks(rng, n, k) for n in lens])


def test_decompositions_match_reference():
    rng = np.random.default_rng(0)
    one = _stream_stacks(rng, 9)
    for p, r in ((fs.decompose_stacked_obs(one), ref_fs.decompose_stacked_obs(one)),):
        for a, b in zip(p, r):
            _assert_same(a, b, "stacked")
    obs = _segmented(rng, [5, 1, 7, 3])
    seg = np.zeros(len(obs), bool)
    seg[[0, 5, 6, 13]] = True
    for a, b in zip(fs.decompose_segmented_obs(obs, seg), ref_fs.decompose_segmented_obs(obs, seg)):
        _assert_same(a, b, "segmented")
    broken = obs.copy()
    broken[3, 0, 0, 0] ^= 1
    assert fs.decompose_segmented_obs(broken, seg) is None
    assert ref_fs.decompose_segmented_obs(broken, seg) is None
    assert fs.decompose_stacked_obs(obs) is None and ref_fs.decompose_stacked_obs(obs) is None


@pytest.mark.parametrize("fn", ["compress_fragment_obs", "compress_replay_obs"])
def test_fragment_compression_matches_reference(fn):
    rng = np.random.default_rng(1)
    for lens in ([12], [4, 9], [1, 5, 1]):
        # rows of episodes back to back; next_obs slides, and each
        # episode's last next_obs is a terminal stack of its own
        obs = _segmented(rng, lens)
        nxt = np.concatenate([obs[1:], obs[-1:]])
        dones = np.zeros(len(obs), bool)
        ends = np.cumsum(lens) - 1
        dones[ends[:-1]] = True
        for e in ends:
            nxt[e] = rng.integers(0, 255, obs.shape[1:], dtype=np.uint8)
            nxt[e, ..., :-1] = obs[e, ..., 1:]
        p, r = getattr(fs, fn)(obs, nxt, dones), getattr(ref_fs, fn)(obs, nxt, dones)
        for a, b in zip(p, r):
            _assert_same(a, b, f"{fn} {lens}")
        cols = {fs.FRAMES: p[0], fs.FRAME_IDX: p[1], "rewards": np.ones(len(obs), np.float32)}
        mp, mr = fs.materialize_fragment(cols, 4), ref_fs.materialize_fragment(dict(cols), 4)
        _assert_batches_equal(mp, mr)
        _assert_same(mp["obs"], obs, "materialized obs")
        if fn == "compress_replay_obs":
            _assert_same(mp["new_obs"], nxt, "materialized next_obs")


def _pixel_fragment(rng, n, eps_id, k=4, sliding=True):
    obs = _stream_stacks(rng, n + 1, k)
    if not sliding:
        obs[n // 2, 0, 0, 0] ^= 1
    return {
        "obs": obs[:n], "new_obs": obs[1:],
        "rewards": rng.standard_normal(n).astype(np.float32),
        "dones": np.zeros(n, bool), "truncateds": np.zeros(n, bool),
        "eps_id": np.full(n, eps_id, np.int64), "t": np.arange(n, dtype=np.int64),
        "unroll_id": np.full(n, eps_id, np.int64),
        "agent_index": np.zeros(n, np.int64),
        "advantages": rng.standard_normal(n).astype(np.float32),
    }


def _pixel_policies(cfg=None):
    cfg = {"model": SMALL_CNN, "seed": 0, **(cfg or {})}
    space = Box(0, 255, (24, 24, 4), np.uint8)
    port = PPOTorchPolicy(space, Discrete(3), cfg, device="cpu")
    ref = PPOJaxPolicy(gym.spaces.Box(0, 255, (24, 24, 4), np.uint8), gym.spaces.Discrete(3),
                       {**cfg, "_mesh": get_mesh(devices=jax.devices()[:1])})
    return port, ref


def test_mixed_concat_and_shipping_match_reference():
    rng = np.random.default_rng(2)
    port, ref = _pixel_policies()
    frags = [_pixel_fragment(rng, n, i, sliding=i != 1) for i, n in enumerate((9, 7, 5))]
    pb = [port.compress_for_shipping(SampleBatch(dict(f))) for f in frags]
    rb = [ref.compress_for_shipping(RefSampleBatch(dict(f))) for f in frags]
    assert [fs.FRAMES in b for b in pb] == [True, False, True]  # the middle one cannot pool
    for a, b in zip(pb, rb):
        _assert_batches_equal(a, b)
    _assert_batches_equal(concat_samples(pb), ref_concat(rb))
    pooled = [b for b in pb if fs.FRAMES in b]
    _assert_batches_equal(concat_samples(pooled), ref_concat([b for b in rb if fs.FRAMES in b]))


def test_dedup_framestack_matches_reference():
    rng = np.random.default_rng(3)
    frags = [_pixel_fragment(rng, n, i) for i, n in enumerate((40, 25, 33))]
    stacked = concat_samples([SampleBatch(f) for f in frags])
    for cfg in ({"dedup_framestack_min_bytes": 0}, {}, {"dedup_framestack": False,
                                                        "dedup_framestack_min_bytes": 0}):
        port, ref = _pixel_policies(cfg)
        p = port._batch_to_train_tree(stacked)
        r = ref._batch_to_train_tree(RefSampleBatch(dict(stacked)))
        _assert_batches_equal(p, r)
        assert (fs.FRAMES in p) == (cfg.get("dedup_framestack_min_bytes") == 0
                                    and cfg.get("dedup_framestack", True))


# -- the sampler ---------------------------------------------------------------


class ScriptedPolicy:
    """One policy both packages' samplers can drive: actions from a
    seeded stream, values a fixed function of the obs, and the given
    package's GAE and shipping compression."""

    is_recurrent = False

    def __init__(self, gae, compress):
        self.config = {"gamma": 0.99, "lambda": 0.95}
        self._rng = np.random.default_rng(5)
        self._gae = gae
        self._compress = compress

    def get_initial_state(self):
        return []

    @staticmethod
    def _values(obs):
        obs = np.asarray(obs)
        return (obs.reshape(len(obs), -1).mean(axis=1) / 255.0).astype(np.float32)

    def compute_actions(self, obs, state_batches=None, explore=True, **kwargs):
        n = len(obs)
        return self._rng.integers(0, 3, n), [], {
            "vf_preds": self._values(obs), "action_logp": np.full(n, -1.0986, np.float32),
        }

    def value_batch(self, obs, state=None):
        return self._values(obs)

    def postprocess_trajectory(self, batch, other_agent_batches=None, episode=None):
        return self._gae(self, batch)

    def compress_for_shipping(self, batch):
        dones = np.asarray(batch["dones"]) | np.asarray(batch["truncateds"])
        dec = self._compress(batch["obs"], batch["new_obs"], dones)
        if dec is None:
            return batch
        cols = {k: v for k, v in batch.items() if k not in ("obs", "new_obs")}
        cols[fs.FRAMES], cols[fs.FRAME_IDX] = dec
        return type(batch)(cols)


def _samples(package):
    if package == "port":
        make, vec, sampler_cls = registry.get_env_creator("PongLite-v0"), VectorEnv, SyncSampler
        policy = ScriptedPolicy(post.compute_gae_for_sample_batch, fs.compress_fragment_obs)
    else:
        make, vec, sampler_cls = ref_registry.get_env_creator("PongLite-v0"), RefVectorEnv, RefSyncSampler
        policy = ScriptedPolicy(ref_post.compute_gae_for_sample_batch, ref_fs.compress_fragment_obs)
    random.seed(0)  # episode ids
    envs = vec.vectorize_gym_envs(lambda i: make(dict(PONG_CFG)), 2, seed=4)
    sampler = sampler_cls(vector_env=envs, policy=policy, rollout_fragment_length=32)
    return [sampler.sample() for _ in range(2)], sampler.get_metrics()


def test_sync_sampler_matches_reference():
    port, port_eps = _samples("port")
    ref, ref_eps = _samples("reference")
    for p, r in zip(port, ref):
        _assert_batches_equal(p, r)
        assert p.count == r.count == 64
    assert fs.FRAMES in port[0] and port[0]["dones"].any() and port[0]["truncateds"].any()
    assert [(e.episode_length, e.episode_reward) for e in port_eps] == [
        (e.episode_length, e.episode_reward) for e in ref_eps]
    assert len(port_eps) >= 4


def test_pooled_and_stacked_learn_bitwise():
    rng = np.random.default_rng(4)
    shipper = PPOTorchPolicy(Box(0, 255, (24, 24, 4), np.uint8), Discrete(3), {"model": SMALL_CNN},
                             device="cpu")
    pooled = concat_samples([
        shipper.compress_for_shipping(SampleBatch({
            **f, "action_logp": np.full(n, -1.1, np.float32), "actions": rng.integers(0, 3, n),
            "action_dist_inputs": rng.standard_normal((n, 3)).astype(np.float32),
            "value_targets": rng.standard_normal(n).astype(np.float32)}))
        for n, f in ((n, _pixel_fragment(rng, n, i)) for i, n in enumerate((20, 12)))
    ])
    assert fs.FRAMES in pooled
    stacked = SampleBatch(fs.materialize_fragment(dict(pooled), 4))
    cfg = {"model": SMALL_CNN, "seed": 0, "train_batch_size": 32, "sgd_minibatch_size": 8,
           "num_sgd_iter": 2, "lr": 1e-3, "dedup_framestack": False}
    a, b = (PPOTorchPolicy(Box(0, 255, (24, 24, 4), np.uint8), Discrete(3), cfg, device="cpu")
            for _ in range(2))
    assert fs.FRAMES in a.prepare_batch(pooled)[0] and fs.FRAMES not in b.prepare_batch(stacked)[0]
    perms = a.draw_permutations(32)
    assert a.learn_on_batch(pooled, perms=perms) == b.learn_on_batch(stacked, perms=perms)
    for (n, wa), wb in zip(a.get_weights().items(), b.get_weights().values()):
        _assert_same(wa, wb, n)
    assert a.last_learn_timers["learn_transfer_bytes"] < b.last_learn_timers["learn_transfer_bytes"]


# -- PPO on the actor lane -----------------------------------------------------


@pytest.fixture(scope="module")
def runtime():
    core.shutdown()
    core.init(num_cpus=1)
    yield
    core.shutdown()


def _ppo(**over):
    cfg = PPOConfig().update_from_dict({
        "seed": 0, "num_workers": 2, "num_envs_per_worker": 2, "rollout_fragment_length": 16,
        "train_batch_size": 64, "sgd_minibatch_size": 32, "num_sgd_iter": 1, "lr": 1e-3,
        "device": "cpu", "model": SMALL_CNN, "env_config": dict(PONG_CFG), **over,
    })
    cfg.env = "PongLite-v0"
    return cfg.build()


def test_ppo_two_remote_workers(runtime):
    algo = _ppo()
    procs = [w._worker.process for w in algo.workers.remote_workers()]
    results = [algo.train() for _ in range(2)]
    assert [r["timesteps_total"] for r in results] == [64, 128]
    assert sum(r["episodes_this_iter"] for r in results) >= 4
    stats = results[-1]["info"]["learner"]["default_policy"]
    assert all(np.isfinite(v) for v in stats.values())
    assert results[-1]["info"]["timers"]["default_policy"]["learn_transfer_bytes"] > 0
    assert set(results[-1]["timers"]) == {"sample_s", "concat_s", "learn_on_batch_s", "sync_weights_s"}
    learner = algo.get_policy().get_weights()
    reports = algo.workers.foreach_worker(device_report)
    assert [r["worker_index"] for r in reports] == [0, 1, 2]
    for r in reports[1:]:
        assert r["policy_device"] == "cpu" and r["cuda_visible_devices"] == ""
        assert r["cuda_initialized"] is False
    for weights in algo.workers.foreach_worker(policy_weights)[1:]:
        assert set(weights) == set(learner)
        for name, w in weights.items():
            _assert_same(w, learner[name], name)
    assert algo.get_policy().global_timestep == 128
    # a dead worker fails the round after the healthy worker's batch is in
    core.kill(algo.workers.remote_workers()[1])
    with pytest.raises(core.RayActorError, match="died"):
        synchronous_parallel_sample(worker_set=algo.workers, max_env_steps=64)
    algo.stop()
    assert all(not p.is_alive() and p.exitcode is not None for p in procs)
    assert algo.workers.num_remote_workers() == 0


def test_ppo_local_worker_and_later_slices():
    algo = _ppo(num_workers=0)
    r = algo.train()
    assert r["timesteps_total"] == 64 and algo.workers.num_remote_workers() == 0
    # prefetch needs remote workers; without them the round is synchronous
    algo.config["sample_prefetch"] = 2
    assert algo.train()["timesteps_total"] == 128
    # the fault injector is ported (tests/test_torch_resilience.py): a
    # spec aimed at remote worker 1 leaves the local worker (index 0) be;
    # output writers are ported (their shards: tests/test_torch_offline.py),
    # and open at the first sample
    armed = _ppo(num_workers=0, fault_injection={"kill_worker": [{"worker_index": 1, "on_call": 1}]})
    assert armed.train()["timesteps_total"] == 64
    assert armed.workers.local_worker()._num_sample_calls == 2  # 64 steps of 32
    armed.stop()
    _ppo(num_workers=0, output="/nonexistent").stop()
    # a sampling thread needs a remote worker: the local worker's policy is
    # the learner (the AsyncSampler itself: tests/test_torch_async_loop.py)
    with pytest.raises(ValueError, match="sample_async needs remote rollout workers"):
        _ppo(num_workers=0, sample_async=True)
    # multi-agent policies need a MultiAgentEnv; PongLite is not one
    with pytest.raises(ValueError, match="need a MultiAgentEnv"):
        _ppo(num_workers=0, policies={"a": None})
    # a tensor env on the actor lane runs through the adapter, with the
    # device lane's draws (tests/test_torch_lane_interleave.py)
    cfg = PPOConfig().update_from_dict({"device": "cpu", "num_workers": 0,
                                        "rollout_fragment_length": 8, "model": SMALL_CNN})
    cfg.env = "PongLiteJax-v0"
    tensor = cfg.build()
    try:
        worker = tensor.workers.local_worker()
        assert type(worker.vector_env).__name__ == "TensorVectorEnvAdapter"
        assert worker.sample().count == 8
    finally:
        tensor.stop()
    # shifted views run through the ViewCollector; recurrent state does
    # not run through the multi-agent sampler
    shifted = PPOTorchPolicy(Box(0, 255, (24, 24, 4), np.uint8), Discrete(3),
                             {"model": {**SMALL_CNN, "use_prev_action": True}}, device="cpu")
    assert SampleBatch.PREV_ACTIONS in shifted.view_requirements
    shifted.get_initial_state = lambda: [np.zeros(4, np.float32)]
    with pytest.raises(NotImplementedError, match="carries no recurrent state"):
        MultiAgentSyncSampler(env=None, policy_map={"default_policy": shifted},
                              policy_mapping_fn=lambda a: "default_policy", preprocessors={},
                              obs_filters={})


def test_train_one_step_skips_a_non_finite_batch():
    algo = _ppo(num_workers=0, nan_guard=True)
    batch = algo.workers.local_worker().sample()
    batch["advantages"][3] = np.nan
    before = algo.get_policy().get_weights()
    assert train_one_step(algo, batch) == {}
    assert algo._counters["num_nan_batches_skipped"] == 1
    for name, w in algo.get_policy().get_weights().items():
        _assert_same(w, before[name], name)
    batch["advantages"][3] = 0.0
    assert np.isfinite(train_one_step(algo, batch)["default_policy"]["total_loss"])
    assert algo._counters["num_env_steps_trained"] == batch.count


@pytest.mark.slow
def test_cartpole_ppo_yaml_reaches_its_bar():
    """tuned_examples/ppo/cartpole-ppo.yaml as written, on the CPU: the
    reference's parity row, 150 within 100,000 env steps."""
    (exp,) = load_tuned_example(REPO / "tuned_examples" / "ppo" / "cartpole-ppo.yaml").values()
    cfg = PPOConfig().update_from_dict({**exp["config"], "device": "cpu"})
    cfg.env = exp["env"]
    algo = cfg.build()
    curve = []
    while True:
        r = algo.train()
        curve.append((r["timesteps_total"], round(float(r["episode_reward_mean"]), 2)))
        if r["episode_reward_mean"] >= 150 or r["timesteps_total"] >= 100_000:
            break
    algo.stop()
    print("cartpole-ppo curve", curve)
    assert curve[-1][1] >= 150 and curve[-1][0] <= 100_000, curve
