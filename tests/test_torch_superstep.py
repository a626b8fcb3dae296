"""The K-update superstep of the port, on the CPU.

On the CPU a superstep runs its slot body eagerly k times (on CUDA the
same body is one captured graph, replayed; ``tests/test_torch_cuda.py``
holds graphed against eager there). The reference's contract
(``ray_tpu/sharding/superstep.py``): k slots are bitwise k sequential
single updates on the same draws, with the coefficients read once per
superstep and the host's reactions (PPO's KL coefficient) applied to
the drained stats in order. Here the sequential side is the port's own
eager path, ``DeviceRolloutEngine.rollout`` + ``learn_on_device_batch``
(K = 1), with the permutations drawn from a twin policy's generator and
the KL coefficient held at its superstep value.

Checked bitwise: parameters, Adam moments and count, the env carry, the
three generators' states, the stacked stats and the episode metrics,
for the PPO lane on CartPole and on PongLite, and for DQN with
prioritized replay at K = 2 and 4 (plus the sum tree's leaves and the
max priority) and with uniform replay; k < K_max under one runner; the nan guard's skip of
exactly the poisoned slot; one drain per superstep; and
``resolve_superstep``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ray_tpu_torch.algorithms.dqn.dqn import DQNConfig
from ray_tpu_torch.algorithms.ppo.ppo import PPOTorchPolicy
from ray_tpu_torch.env.control_tensor import CartPoleTensor
from ray_tpu_torch.env.spaces import Box, Discrete
from ray_tpu_torch.execution.device_rollout import DeviceRolloutEngine
from ray_tpu_torch.execution.train_ops import superstep_train_replay
from ray_tpu_torch.sharding.superstep import SKIP_KEY, batch_finite, resolve_superstep

PONG_MODEL = {"conv_filters": [[4, [8, 8], [4, 4]], [8, [4, 4], [2, 2]]],
              "post_fcnet_hiddens": [16], "dtype": "float32"}


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _assert_policy_equal(p, q):
    assert _same(p.params, q.params)
    assert _same(p.opt_state.mu, q.opt_state.mu)
    assert _same(p.opt_state.nu, q.opt_state.nu)
    assert p.opt_state.count == q.opt_state.count
    assert p.num_grad_updates == q.num_grad_updates
    assert torch.equal(p.action_generator.get_state(), q.action_generator.get_state())
    assert torch.equal(p.perm_generator.get_state(), q.perm_generator.get_state())


def _assert_engine_equal(e, f):
    for k in e.carry["env"]:
        assert torch.equal(e.carry["env"][k], f.carry["env"][k]), k
    for k in ("obs", "ep_ret", "ep_len"):
        assert torch.equal(e.carry[k], f.carry[k]), k
    assert torch.equal(e.env_generator.get_state(), f.env_generator.get_state())
    a = [(m.episode_length, m.episode_reward) for m in e.get_metrics()]
    b = [(m.episode_length, m.episode_reward) for m in f.get_metrics()]
    assert a == b


def test_resolve_superstep():
    assert resolve_superstep({}, "cpu") == 1
    assert resolve_superstep({"superstep": "auto"}, torch.device("cpu")) == 1
    assert resolve_superstep({"superstep": "auto"}, torch.device("cuda")) == 8
    assert resolve_superstep({}, "cuda:0") == 8
    assert resolve_superstep({"superstep": 3}, "cpu") == 3
    assert resolve_superstep({"superstep": 5}, "cuda") == 5
    for off in (None, False, 0, 1):
        assert resolve_superstep({"superstep": off}, "cuda") == 1


def test_batch_finite_reads_float_columns_only():
    batch = {"a": torch.zeros(3), "i": torch.arange(3)}
    assert float(batch_finite(batch)) == 1.0
    batch["b"] = torch.tensor([1.0, float("inf")])
    assert float(batch_finite(batch)) == 0.0
    assert float(batch_finite({"i": torch.arange(2)})) == 1.0


def _lane(env, model, n, t, mb, iters, seed=0, **over):
    cfg = {"seed": seed, "model": model, "gamma": 0.99, "lambda": 0.95, "lr": 3e-3,
           "train_batch_size": n * t, "sgd_minibatch_size": mb, "num_sgd_iter": iters,
           "entropy_coeff": 0.01, "kl_coeff": 0.2, "kl_target": 0.01, **over}
    policy = PPOTorchPolicy(env.observation_space, env.action_space, cfg, device="cpu")
    return policy, DeviceRolloutEngine(policy, env, n, t, seed=seed + 1)


def _sequential_lane(policy, eng, k):
    """k eager slots with the coefficients held for the superstep, then
    the KL reaction on each update's stats in order."""
    kl = policy.coeff_values["kl_coeff"]
    outs = []
    for _ in range(k):
        policy.coeff_values["kl_coeff"] = kl
        batch, bsize = eng.rollout()
        out = policy.learn_on_device_batch(eng.learn_batch(batch), bsize)
        out.pop("cur_kl_coeff")
        outs.append(out)
    policy.coeff_values["kl_coeff"] = kl
    for out in outs:
        out.update(policy.after_learn_on_batch(out))
    return outs


def _superstep_lane(policy, eng, k, k_max=None):
    infos, carry, metrics, skipped = policy.learn_rollout_superstep(
        k, eng.batch_size, eng.superstep_feed(), k_max=k_max)
    eng.advance(carry, metrics)
    for info in infos:
        info.update(policy.after_learn_on_batch(info))
    assert skipped == [False] * k
    assert metrics.shape == (k, eng.T, 3, eng.N)
    return infos


@pytest.mark.parametrize("case", ["cartpole", "ponglite"])
def test_rollout_superstep_equals_sequential_updates(case):
    if case == "cartpole":
        make = lambda: _lane(CartPoleTensor({"max_steps": 12}), {"fcnet_hiddens": [16, 16]},
                             n=4, t=16, mb=16, iters=2)
        k = 3
    else:
        from ray_tpu_torch.env.pong_lite_tensor import PongLiteTensor

        make = lambda: _lane(PongLiteTensor({"max_steps": 10, "rallies": 2}), PONG_MODEL,
                             n=2, t=8, mb=8, iters=2)
        k = 2
    (p1, e1), (p2, e2) = make(), make()
    for _ in range(2):  # a second call chains from the first one's state
        seq = _sequential_lane(p1, e1, k)
        sup = _superstep_lane(p2, e2, k)
        assert sup == seq
        _assert_policy_equal(p1, p2)
        _assert_engine_equal(e1, e2)
        assert p1.coeff_values == p2.coeff_values


def test_fewer_slots_than_k_max_equal_k():
    make = lambda: _lane(CartPoleTensor({"max_steps": 12}), {"fcnet_hiddens": [16]},
                         n=4, t=8, mb=16, iters=2)
    (p1, e1), (p2, e2) = make(), make()
    a = _superstep_lane(p1, e1, 2, k_max=2)
    b = _superstep_lane(p2, e2, 2, k_max=4)
    b += _superstep_lane(p2, e2, 1, k_max=4)
    a += _superstep_lane(p1, e1, 1, k_max=2)
    assert a == b
    _assert_policy_equal(p1, p2)
    _assert_engine_equal(e1, e2)
    # one runner (one graph on CUDA) serves every k <= k_max
    assert len(p2._superstep_runners) == 1


def test_one_drain_per_superstep(monkeypatch):
    policy, eng = _lane(CartPoleTensor(), {"fcnet_hiddens": [8]}, n=2, t=4, mb=8, iters=1)
    calls = []
    real_cpu = torch.Tensor.cpu

    def counting_cpu(self, *a, **kw):
        calls.append(tuple(self.shape))
        return real_cpu(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    for k in (3, 1, 2):
        calls.clear()
        _superstep_lane(policy, eng, k, k_max=3)
        assert len(calls) == 1, calls
    (runner,) = policy._superstep_runners.values()
    assert runner.drains == 3


def test_a_grown_correction_table_drops_captured_graphs():
    """More optimizer steps a superstep than Adam's table holds grow it
    into a new tensor; every runner's graph read the old one and must
    capture again."""
    policy, eng = _lane(CartPoleTensor(), {"fcnet_hiddens": [8]}, n=2, t=4, mb=8, iters=1)
    _superstep_lane(policy, eng, 1)
    (runner,) = policy._superstep_runners.values()
    runner.graph = "captured"  # stands in for a CUDA graph on the CPU
    table = policy.opt_state.table
    policy._load_corrections(policy.opt_state.TABLE_STEPS)
    assert runner.graph == "captured" and policy.opt_state.table is table
    policy._load_corrections(policy.opt_state.TABLE_STEPS + 1)
    assert runner.graph is None and policy.opt_state.table is not table
    assert policy.opt_state.table.shape == (2, policy.opt_state.TABLE_STEPS + 1)


def _stacked_batches(k, b, rng):
    obs = rng.standard_normal((k, b, 4)).astype(np.float32)
    return {
        "obs": torch.as_tensor(obs),
        "actions": torch.as_tensor(rng.integers(0, 2, (k, b))),
        "action_logp": torch.full((k, b), -0.69),
        "action_dist_inputs": torch.as_tensor(rng.standard_normal((k, b, 2)).astype(np.float32)),
        "advantages": torch.as_tensor(rng.standard_normal((k, b)).astype(np.float32)),
        "value_targets": torch.as_tensor(rng.standard_normal((k, b)).astype(np.float32)),
    }


def _flat_policy(seed=0, **over):
    cfg = {"seed": seed, "model": {"fcnet_hiddens": [16]}, "lr": 1e-2, "train_batch_size": 32,
           "sgd_minibatch_size": 16, "num_sgd_iter": 2, "kl_coeff": 0.0, **over}
    return PPOTorchPolicy(Box(-10, 10, (4,), np.float32), Discrete(2), cfg, device="cpu")


def test_stacked_superstep_equals_learn_on_device_batch():
    k, b = 3, 32
    stacked = _stacked_batches(k, b, np.random.default_rng(0))
    p1, p2 = _flat_policy(), _flat_policy()
    seq = [p1.learn_on_device_batch({c: v[i] for c, v in stacked.items()}, b) for i in range(k)]
    infos, pri, skipped = p2.learn_superstep(k, b, stacked=stacked, k_max=4)
    assert pri is None and skipped == [False] * k
    for s, i in zip(seq, infos):
        s.pop("cur_kl_coeff")
        assert s == i
    _assert_policy_equal(p1, p2)


def test_nan_guard_skips_exactly_the_poisoned_slot():
    k, b = 3, 32
    rng = np.random.default_rng(1)
    clean = _stacked_batches(k, b, rng)
    poisoned = {c: v.clone() for c, v in clean.items()}
    poisoned["obs"][1, 3, 1] = float("nan")
    p1, p2 = _flat_policy(nan_guard=True), _flat_policy(nan_guard=True)
    # the reference: the two clean updates, with slot 1's permutations
    # drawn and thrown away, as the superstep draws them
    for i in range(k):
        perms = p1.draw_permutations(b)
        if i != 1:
            p1.learn_on_device_batch({c: v[i] for c, v in clean.items()}, b, perms=perms)
    infos, _, skipped = p2.learn_superstep(k, b, stacked=poisoned)
    assert skipped == [False, True, False]
    assert SKIP_KEY not in infos[0]
    assert _same(p1.params, p2.params)
    assert _same(p1.opt_state.mu, p2.opt_state.mu) and _same(p1.opt_state.nu, p2.opt_state.nu)
    assert p1.opt_state.count == p2.opt_state.count == 2 * 2 * 2
    assert all(np.isfinite(v) for v in infos[0].values())


# -- DQN prioritized replay ------------------------------------------------

ENV_CFG = {"max_steps": 20, "rallies": 2}
RB = {"capacity": 64, "prioritized_replay": True}


def _dqn(seed=3, **over):
    cfg = (
        DQNConfig()
        .environment("PongLiteJax-v0", env_config=ENV_CFG, env_backend="jax")
        .rollouts(num_envs_per_worker=2, rollout_fragment_length=4)
        .training(replay_buffer_config=RB, model={"conv_filters": PONG_FILTERS_DQN,
                                                  "post_fcnet_hiddens": [16]},
                  train_batch_size=8, num_steps_sampled_before_learning_starts=16,
                  target_network_update_freq=16)
        .debugging(seed=seed).resources(device="cpu")
    )
    cfg.update_from_dict(over)
    return cfg.build()


PONG_FILTERS_DQN = [[4, [8, 8], [4, 4]], [8, [4, 4], [2, 2]]]


def _filled_pair(**over):
    a, b = _dqn(**over), _dqn(**over)
    for algo in (a, b):
        for _ in range(6):
            algo._jax_rollout_fill()
        buf = algo.local_replay_buffer.buffers["default_policy"]
        if hasattr(buf, "update_priorities"):
            buf.update_priorities(np.arange(16), np.linspace(1.0, 5.0, 16))
    return a, b


@pytest.mark.parametrize("k", [2, 4])
def test_dqn_prioritized_superstep_equals_sequential_updates(k):
    a, b = _filled_pair()
    bs = 8
    for _ in range(2):  # the second superstep draws from the refreshed tree
        pa, ba = a.get_policy(), a.local_replay_buffer.buffers["default_policy"]
        # sequential: the k sets drawn up front on the frozen tree, then
        # learn -> |td| -> refresh per update, in update order
        idx, weights = ba.draw_prioritized_sets_device(k, k, bs, 0.4)
        seq = []
        for i in range(k):
            tree = ba._gather_columns(idx[i])
            tree["weights"] = weights[i]
            seq.append(pa.learn_on_device_batch(tree, bs))
            with torch.no_grad():
                td = np.abs(pa._td_error(tree, pa.aux_state)[0].numpy())
            ba.update_priorities(idx[i], td + 1e-6)
        pb, bb = b.get_policy(), b.local_replay_buffer.buffers["default_policy"]
        info = superstep_train_replay(b, pb, bb, k, k, bs, prioritized=True, beta=0.4)
        seq[-1].pop("cur_kl_coeff", None)
        assert info == seq[-1]
        _assert_policy_equal(pa, pb)
        assert _same(pa.aux_state["target_params"], pb.aux_state["target_params"])
        assert torch.equal(ba._dtree.sum_value, bb._dtree.sum_value)
        assert torch.equal(ba._dtree.min_value, bb._dtree.min_value)
        assert ba._max_priority == bb._max_priority
        assert ba._rng.bit_generator.state == bb._rng.bit_generator.state
        pb.update_target()
        pa.update_target()


def test_dqn_uniform_superstep_equals_sequential_updates():
    a, b = _filled_pair(replay_buffer_config={"capacity": 64, "prioritized_replay": False})
    k, bs = 3, 8
    pa, ba = a.get_policy(), a.local_replay_buffer.buffers["default_policy"]
    pb, bb = b.get_policy(), b.local_replay_buffer.buffers["default_policy"]
    for _ in range(2):
        seq = [pa.learn_on_device_batch(dict(ba.sample(bs).tree), bs) for _ in range(k)]
        info = superstep_train_replay(b, pb, bb, k, k, bs)
        assert info == seq[-1]
        _assert_policy_equal(pa, pb)
        assert ba._rng.bit_generator.state == bb._rng.bit_generator.state


def test_dqn_train_runs_supersteps_with_training_intensity():
    """8 sampled steps a round at intensity 2 owe 2 updates of 8 rows a
    round once learning starts (16 steps): one superstep of K = 2. At
    K = 1, prioritized replay takes no debt and makes 1 update a round,
    as in the reference."""
    rounds = 8
    fused, single = _dqn(superstep=2, training_intensity=2), _dqn(superstep=1, training_intensity=2)
    rf = [fused.train() for _ in range(rounds)]
    rs = [single.train() for _ in range(rounds)]
    learning_rounds = rounds - 1
    assert rf[-1]["info"]["num_env_steps_trained"] == learning_rounds * 2 * 8
    assert rs[-1]["info"]["num_env_steps_trained"] == learning_rounds * 8
    (runner,) = fused.get_policy()._superstep_runners.values()
    assert runner.k_max == 2 and runner.drains == learning_rounds
    assert not single.get_policy()._superstep_runners
    assert rf[-1]["info"]["num_target_updates"] >= 1
    learner = rf[-1]["info"]["learner"]["default_policy"]
    assert all(np.isfinite(v) for v in learner.values())


def test_ppo_train_fused_and_unfused_lanes_agree():
    """PPO.train at K = 2: the fused superstep and ``jax_fused_rollout =
    False`` (K eager rollout-then-learn rounds) give the same run under a
    fixed KL coefficient of 0, and the counters advance by K · batch."""
    from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig

    def build(fused):
        cfg = PPOConfig().update_from_dict({
            "env": "CartPoleJax-v0", "env_backend": "jax", "num_envs_per_worker": 4,
            "rollout_fragment_length": 16, "train_batch_size": 64, "sgd_minibatch_size": 32,
            "num_sgd_iter": 2, "kl_coeff": 0.0, "lr": 3e-3, "model": {"fcnet_hiddens": [16]},
            "seed": 2, "superstep": 2, "jax_fused_rollout": fused, "device": "cpu",
        })
        return cfg.build()

    fused, unfused = build(True), build(False)
    for _ in range(2):
        rf, ru = fused.train(), unfused.train()
        assert rf["timesteps_total"] == ru["timesteps_total"]
        assert rf["info"]["learner"] == ru["info"]["learner"]
        assert rf["episode_reward_mean"] == ru["episode_reward_mean"] or (
            np.isnan(rf["episode_reward_mean"]) and np.isnan(ru["episode_reward_mean"]))
    assert rf["timesteps_total"] == 2 * 2 * 64
    _assert_policy_equal(fused.get_policy(), unfused.get_policy())
    _assert_engine_equal(fused._rollout_engine, unfused._rollout_engine)
    assert not unfused.get_policy()._superstep_runners
