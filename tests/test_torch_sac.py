"""SAC and the off-policy actor lane of the port against the reference's,
on the CPU.

Contracts:

- the action distributions against ``ray_tpu/models/distributions.py``
  on the same inputs and the same standard normals: ``DiagGaussian``
  (``logp``, ``sampled_action_logp``, ``entropy``, ``kl``) within 1e-6
  relative plus 1e-6 absolute; ``SquashedGaussian`` the same, plus the
  reference's float32 ``tanh``: XLA's is off float64 by up to 2.1e-7
  (torch's by 3e-8), which ``log(1 - tanh^2 + 1e-6)`` divides by
  ``1 - tanh^2 + 1e-6``, so the bound adds ``2 * 5e-7 / (1 - tanh^2 +
  1e-6)`` per action dimension (at a saturated dimension the two
  frameworks' log-probabilities part by up to 0.3);
- the SAC nets through ``from_jax_sac_state`` within 1e-5 relative;
- one ``SACTorchPolicy`` update from the reference's state, against
  ``SACJaxPolicy``'s update on a one-shard mesh with the same batch and
  the reference's two normal draws injected: every parameter, the
  target critic and the three Adam states within 1e-6 absolute plus
  1e-5 relative (the PPO learn's 1.5e-5 holds with room; 1.5e-8 was
  measured), the stats within 1e-5 relative plus 1e-6 absolute; and
  ``compute_td_error`` with the reference's draw within 1e-5;
- bitwise: K eager superstep slots against K sequential updates on the
  same pre-drawn rows and draws (uniform and prioritized replay, the
  priorities and the sum tree included), and a round's one update as a
  superstep slot at k = 1 against the eager round;
- the port's fixed-seed runs repeat bitwise; state round trips;
- one actor-lane ``DQN`` round on gymnasium's CartPole-v1 against the
  reference's: the port is handed the rows the reference sampled and
  the reference's permutation, and draws the same replay rows from the
  same seed: the replay rings bitwise, the counters and the timestep
  equal, the learner stats within 1e-5 and the parameters within 1.5e-5;
- ``sync_weights(inference_only=True)`` ships SAC's actor alone;
- ``SAC.train()`` on the port's Pendulum-v1 at a small size.

The slow tests run ``pendulum-sac.yaml`` as written on the CPU against
its bar and the reference's run (neither reaches the bar's 100-episode
mean by 20,000 steps; see the test), and one SAC iteration with two
remote workers.
"""

from __future__ import annotations

import pathlib

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_actor_probe import policy_weights
from ray_tpu.algorithms.dqn.dqn import DQNConfig as JDQNConfig
from ray_tpu.algorithms.sac.sac import SACConfig as JSACConfig
from ray_tpu.algorithms.sac.sac import SACJaxPolicy
from ray_tpu.data.sample_batch import SampleBatch as JSampleBatch
from ray_tpu.models import distributions as jdists
from ray_tpu.sharding import get_mesh
from ray_tpu_torch import core
from ray_tpu_torch.algorithms.dqn.dqn import DQNConfig
from ray_tpu_torch.algorithms.registry import get_algorithm_class
from ray_tpu_torch.algorithms.sac.sac import SAC, SAC_STATS, SACConfig, SACTorchPolicy
from ray_tpu_torch.data.sample_batch import SampleBatch
from ray_tpu_torch.env.spaces import Box
from ray_tpu_torch.evaluation.rollout_worker import RolloutWorker
from ray_tpu_torch.evaluation.worker_set import WorkerSet
from ray_tpu_torch.execution import replay_buffer
from ray_tpu_torch.execution.replay_buffer import (
    DevicePrioritizedReplayBuffer,
    DeviceReplayBuffer,
    MultiAgentReplayBuffer,
)
from ray_tpu_torch.execution.train_ops import superstep_train_replay
from ray_tpu_torch.models import distributions as tdists
from ray_tpu_torch.ops import segment_tree
from ray_tpu_torch.utils.jax_params import (
    flax_to_state_dict,
    from_jax_adam_state,
    from_jax_params,
    from_jax_sac_state,
)
from ray_tpu_torch.utils.tuned_example import build_tuned_example

REPO = pathlib.Path(__file__).resolve().parents[1]
SAC_YAML = REPO / "tuned_examples" / "sac" / "pendulum-sac.yaml"


def _one_shard():
    return get_mesh(devices=jax.devices()[:1])


# -- the distributions ---------------------------------------------------------------

TANH_ERR = 5e-7  # both frameworks' float32 tanh against float64, summed


def _close(port, ref, extra=0.0):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    bound = 1e-6 * np.abs(ref) + 1e-6 + extra
    assert port.shape == ref.shape and (np.abs(port - ref) <= bound).all(), (
        np.max(np.abs(port - ref) - bound))


def _tanh_budget(raw, low, high):
    """Per-row bound the reference's float32 tanh adds to a squashed
    log-probability (the Jacobian term), and per element to an action."""
    t2 = np.tanh(np.asarray(raw, np.float64)) ** 2
    return (2 * TANH_ERR / (1 - t2 + 1e-6)).sum(-1), TANH_ERR * (high - low) / 2


@pytest.mark.parametrize("seed,dim,scale", [(0, 1, 0.5), (1, 6, 1.0), (2, 17, 2.0)])
def test_diag_gaussian_matches_reference(seed, dim, scale):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((64, 2 * dim)) * scale).astype(np.float32)
    y = (rng.standard_normal((64, 2 * dim)) * scale).astype(np.float32)
    a = (rng.standard_normal((64, dim)) * 2).astype(np.float32)
    jd, td = jdists.DiagGaussian(jnp.asarray(x)), tdists.DiagGaussian(torch.as_tensor(x))
    _close(td.logp(torch.as_tensor(a)), jd.logp(jnp.asarray(a)))
    _close(td.entropy(), jd.entropy())
    _close(td.kl(tdists.DiagGaussian(torch.as_tensor(y))), jd.kl(jdists.DiagGaussian(jnp.asarray(y))))
    _close(td.deterministic_sample(), jd.deterministic_sample())
    key = jax.random.PRNGKey(seed)
    ja, jl = jd.sampled_action_logp(key)
    eps = torch.as_tensor(np.array(jax.random.normal(key, (64, dim), jnp.float32)))
    ta, tl = td.sampled_action_logp(None, eps)
    _close(ta, ja)
    _close(tl, jl)
    assert tdists.DiagGaussian.required_model_output_shape(Box(-1, 1, (dim,))) == 2 * dim


@pytest.mark.parametrize("seed,dim,low,high,scale", [
    (0, 1, -2.0, 2.0, 0.5), (1, 6, -1.0, 1.0, 1.0), (2, 3, -1.0, 1.0, 3.0),
])
def test_squashed_gaussian_matches_reference(seed, dim, low, high, scale):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((64, 2 * dim)) * scale).astype(np.float32)
    a = rng.uniform(low, high, (64, dim)).astype(np.float32)
    jd = jdists.SquashedGaussian(jnp.asarray(x), low=low, high=high)
    td = tdists.SquashedGaussian(torch.as_tensor(x), low=low, high=high)
    _close(td.entropy(), jd.entropy())
    raw = np.arctanh(np.clip((a - low) / (high - low) * 2 - 1, -1 + 1e-6, 1 - 1e-6))
    row_budget, _ = _tanh_budget(raw, low, high)
    _close(td.logp(torch.as_tensor(a)), jd.logp(jnp.asarray(a)), row_budget)
    key = jax.random.PRNGKey(seed + 10)
    ja, jl = jd.sampled_action_logp(key)
    n = np.array(jax.random.normal(key, (64, dim), jnp.float32))
    ta, tl = td.sampled_action_logp(None, torch.as_tensor(n))
    raw = np.asarray(jd.mean) + np.asarray(jd.std) * n
    row_budget, elem = _tanh_budget(raw, low, high)
    _close(ta, ja, elem)
    _close(tl, jl, row_budget)
    _close(td.deterministic_sample(), jd.deterministic_sample(), elem)
    assert (td.log_std.max() <= 2.0) and (td.log_std.min() >= -20.0)
    # a drawn sample stays inside the bounds and repeats from one seed
    g = torch.Generator().manual_seed(4)
    s1 = td.sample(g)
    s2 = td.sample(torch.Generator().manual_seed(4))
    assert torch.equal(s1, s2) and s1.min() >= low and s1.max() <= high


# -- one update ------------------------------------------------------------------------

B, OBS = 16, 5
HIDDEN = {"policy_model_config": {"fcnet_hiddens": [32, 32]},
          "q_model_config": {"fcnet_hiddens": [24, 24]}}


def _sac_config(**over):
    cfg = {**JSACConfig().to_dict(), **HIDDEN, "seed": 3, "train_batch_size": B, "gamma": 0.97,
           "initial_alpha": 0.7, "tau": 0.05, **over}
    cfg.pop("env", None)
    return cfg


def _sac_batch(rng, act, low=-2.0, high=2.0, n=B, obs_scale=1.0):
    return {
        "obs": (rng.standard_normal((n, OBS)) * obs_scale).astype(np.float32),
        "new_obs": (rng.standard_normal((n, OBS)) * obs_scale).astype(np.float32),
        "actions": rng.uniform(low, high, (n, act)).astype(np.float32),
        "rewards": rng.standard_normal(n).astype(np.float32),
        "dones": rng.random(n) < 0.25,
    }


def _pair(act, low, high, **over):
    """A reference policy two updates in (a target unlike the critic,
    Adam counts past 1) and a port policy carrying its state."""
    cfg = _sac_config(**over)
    ref = SACJaxPolicy(gym.spaces.Box(-1, 1, (OBS,), np.float32),
                       gym.spaces.Box(low, high, (act,), np.float32), {**cfg, "_mesh": _one_shard()})
    rng = np.random.default_rng(0)
    for _ in range(2):
        ref.learn_on_batch(JSampleBatch(_sac_batch(rng, act, low, high)))
    port = SACTorchPolicy(Box(-1, 1, (OBS,)), Box(low, high, (act,)), cfg, device="cpu")
    from_jax_sac_state(port, jax.device_get(ref.params), jax.device_get(ref.aux_state),
                       jax.device_get(ref.opt_state))
    return ref, port, rng


def _reference_normals(key, act, n=B):
    """The two normals ``SACJaxPolicy``'s update draws on shard 0 from the
    policy key ``key`` (learn_on_device_batch splits it, the update folds
    in the shard index and splits into the next action's and the policy
    action's keys)."""
    _, rng = jax.random.split(key)
    rng_t, rng_a = jax.random.split(jax.random.fold_in(rng, 0))
    return tuple(torch.as_tensor(np.array(jax.random.normal(r, (n, act), jnp.float32)))
                 for r in (rng_t, rng_a))


def _assert_sac_state_close(port, ref, atol=1e-6, groups=("actor", "critic"), nu_rtol=1e-5):
    got = port.get_state()
    for group in groups:
        want = flax_to_state_dict(jax.device_get(ref.params[group]))
        for k, v in want.items():
            np.testing.assert_allclose(got["weights"][f"{group}.{k}"], v, rtol=1e-5, atol=atol,
                                       err_msg=k)
        count, mu, nu = from_jax_adam_state(jax.device_get(ref.opt_state[group]))
        assert got["opt_state"][group]["count"] == count
        for k in want:
            np.testing.assert_allclose(got["opt_state"][group]["mu"][f"{group}.{k}"], mu[k],
                                       rtol=1e-5, atol=atol, err_msg=k)
            np.testing.assert_allclose(got["opt_state"][group]["nu"][f"{group}.{k}"], nu[k],
                                       rtol=nu_rtol, atol=atol * 1e-3, err_msg=k)
    if "actor" in groups:
        np.testing.assert_allclose(got["weights"]["log_alpha"], np.asarray(ref.params["log_alpha"]),
                                   rtol=1e-5, atol=atol)
    target = flax_to_state_dict(jax.device_get(ref.aux_state["target_critic"]))
    for k, v in target.items():
        np.testing.assert_allclose(got["target_weights"][k], v, rtol=1e-5, atol=atol, err_msg=k)


def test_sac_nets_carried_from_reference():
    ref, port, rng = _pair(2, -2.0, 2.0)
    b = _sac_batch(rng, 2)
    obs, act = jnp.asarray(b["obs"]), jnp.asarray(b["actions"])
    with torch.no_grad():
        np.testing.assert_allclose(port.actor(torch.as_tensor(b["obs"])).numpy(),
                                   np.asarray(ref.actor.apply(ref.params["actor"], obs)),
                                   rtol=1e-5, atol=1e-6)
        q = port.critic(torch.as_tensor(b["obs"]), torch.as_tensor(b["actions"]))
        rq = ref.critic.apply(ref.params["critic"], obs, act)
        for p, r in zip(q, rq):
            np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)
    _assert_sac_state_close(port, ref, atol=0.0)
    assert port.target_entropy == ref.target_entropy == -2.0
    assert (port.low, port.high) == (ref.low, ref.high)


SAC_CASES = [
    (1, -2.0, 2.0, {}),
    (3, -1.0, 1.0, {"target_entropy": -1.5, "optimization": {"actor_learning_rate": 1e-3,
                                                             "critic_learning_rate": 5e-4,
                                                             "entropy_learning_rate": 2e-3}}),
]


def _raw_samples(port, obs, eps):
    with torch.no_grad():
        d = port._dist(torch.as_tensor(obs))
        return (d.mean + d.std * eps).numpy()


def _update_pair(act, low, high, over, obs_scale):
    """A reference and a port update on one batch with the reference's
    draws: (ref stats, port stats, ref, port, per-row tanh budgets of the
    policy action's and the next action's log-probabilities)."""
    ref, port, rng = _pair(act, low, high, **over)
    b = _sac_batch(rng, act, low, high, obs_scale=obs_scale)
    normals = _reference_normals(ref._rng, act)
    budget_t, _ = _tanh_budget(_raw_samples(port, b["new_obs"], normals[0]), low, high)
    budget_a, _ = _tanh_budget(_raw_samples(port, b["obs"], normals[1]), low, high)
    alpha = float(np.exp(port.get_weights()["log_alpha"]))
    log_alpha = abs(float(port.get_weights()["log_alpha"]))
    ref_stats = ref.learn_on_batch(JSampleBatch(dict(b)))
    stats = port.learn_on_batch(SampleBatch(dict(b)), normals=normals)
    assert tuple(stats) == SAC_STATS and set(stats) == set(ref_stats)
    # the tanh budget carried into each stat: the policy action's logp
    # (actor and alpha losses), the next action's through the TD target
    # (critic loss: 2 * 2 * mean(|q - target| * d_target) for the twin)
    d_target = port.gamma * alpha * budget_t
    extra = {
        "actor_loss": alpha * budget_a.mean(), "alpha_loss": log_alpha * budget_a.mean(),
        "critic_loss": 4 * (np.abs(b["rewards"]).mean() + 10) * d_target.mean() + 2 * (d_target ** 2).mean(),
        "alpha_value": 0.0, "mean_q": 0.0,
    }
    extra["total_loss"] = extra["actor_loss"] + extra["alpha_loss"] + extra["critic_loss"]
    for k, v in ref_stats.items():
        assert abs(stats[k] - v) <= 1e-5 * abs(v) + 1e-6 + extra[k], (k, stats[k], v, extra[k])
    return ref, port, np.maximum(budget_a, budget_t)


@pytest.mark.parametrize("act,low,high,over", SAC_CASES)
def test_one_sac_update_matches_reference(act, low, high, over):
    """Observations at half scale keep every squashed sample off the
    tanh's flat ends (asserted), where float32 holds the Jacobian term
    well: every parameter, moment and the target within 1e-6."""
    ref, port, budget = _update_pair(act, low, high, over, obs_scale=0.5)
    assert budget.max() < 2e-4, budget.max()  # no sample near saturation
    _assert_sac_state_close(port, ref)
    assert port.num_grad_updates == 1


def test_sac_update_at_saturated_samples():
    """At full-scale observations some squashed samples sit where
    ``1 - tanh^2`` is about 2e-5: a float32 tanh's last bit moves the
    Jacobian term by about 1e-2 in either framework. The stats agree
    within the tanh budget, the critic and the target within 1e-6, and
    the actor within 1e-4, a tenth of one Adam step at its lr of 1e-3
    (2.3e-5 was measured); the critic's second moment within 1e-4
    relative (1.8e-5 measured: its gradient reads the next action's
    log-probability through the TD target)."""
    act, low, high, over = SAC_CASES[1]
    ref, port, budget = _update_pair(act, low, high, over, obs_scale=1.0)
    assert budget.max() > 1e-2  # the case is saturated
    _assert_sac_state_close(port, ref, groups=("critic",), nu_rtol=1e-4)
    got = port.get_weights()
    for k, v in flax_to_state_dict(jax.device_get(ref.params["actor"])).items():
        np.testing.assert_allclose(got[f"actor.{k}"], v, rtol=0, atol=1e-4, err_msg=k)


def test_compute_td_error_matches_reference():
    ref, port, rng = _pair(2, -2.0, 2.0)
    b = _sac_batch(rng, 2)
    _, key = jax.random.split(ref._rng)
    normal = torch.as_tensor(np.array(jax.random.normal(key, (B, 2), jnp.float32)))
    want = ref.compute_td_error(JSampleBatch(dict(b)))
    got = port.compute_td_error(SampleBatch(dict(b)), normal=normal)
    assert got.dtype == np.float32 and got.shape == (B,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # a device batch is read in place; a draw from the generator repeats
    dev = {k: torch.as_tensor(v) for k, v in port._train_columns(SampleBatch(dict(b))).items()}
    g = port.action_generator.get_state()
    first = port.compute_td_error(type("S", (), {"is_device_resident": True, "tree": dev})())
    port.action_generator.set_state(g)
    assert np.array_equal(first, port.compute_td_error(SampleBatch(dict(b))))


# -- the superstep -----------------------------------------------------------------------

ACT = 2


def _filled(buf_cls, seed=5, rows=48, **kw):
    buf = buf_cls(64, seed=seed, device="cpu", **kw)
    rng = np.random.default_rng(seed)
    buf.add_device_tree(_sac_batch(rng, ACT, n=rows))
    if isinstance(buf, DevicePrioritizedReplayBuffer):
        buf.update_priorities(np.arange(rows), rng.random(rows) + 0.1)
    return buf


def _port_policy(seed=7, **over):
    return SACTorchPolicy(Box(-1, 1, (OBS,)), Box(-2, 2, (ACT,)),
                          {**_sac_config(**over), "seed": seed}, device="cpu")


def _assert_policies_equal(a, b):
    sa, sb = a.get_state(), b.get_state()
    for k in ("weights", "target_weights"):
        for n in sa[k]:
            assert sa[k][n].tobytes() == sb[k][n].tobytes(), n
    for g, s in sa["opt_state"].items():
        assert s["count"] == sb["opt_state"][g]["count"]
        for m in ("mu", "nu"):
            for n, v in s[m].items():
                assert v.tobytes() == sb["opt_state"][g][m][n].tobytes(), (g, m, n)
    assert torch.equal(a.action_generator.get_state(), b.action_generator.get_state())


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("prioritized", [False, True])
def test_sac_superstep_equals_sequential_updates(k, prioritized):
    cls = DevicePrioritizedReplayBuffer if prioritized else DeviceReplayBuffer
    pa, pb = _port_policy(), _port_policy()
    ba, bb = _filled(cls), _filled(cls)
    bs = 8
    for _ in range(2):  # the second superstep reuses the runner
        if prioritized:
            idx, weights = bb.draw_prioritized_sets_device(k, k, bs, 0.4)
        else:
            idx = torch.as_tensor(bb.draw_index_sets(k, bs))
        seq = []
        for i in range(k):
            tree = bb._gather_columns(idx[i])
            if prioritized:
                tree["weights"] = weights[i]
            seq.append(pb.learn_on_device_batch(tree, bs))
            if prioritized:
                td = torch.abs(pb._td_error(tree, pb.aux_state)[0]).numpy()
                bb.update_priorities(idx[i], td + 1e-6)
        info = superstep_train_replay(None, pa, ba, k, k, bs, prioritized=prioritized, beta=0.4)
        assert info == seq[-1]
    _assert_policies_equal(pa, pb)
    assert pa.num_grad_updates == pb.num_grad_updates == 2 * k
    if prioritized:
        assert torch.equal(ba._dtree.sum_value, bb._dtree.sum_value)
        assert torch.equal(ba._dtree.min_value, bb._dtree.min_value)
        assert ba._max_priority == bb._max_priority


def test_sac_superstep_nan_guard_skips_the_update():
    pa = _port_policy(nan_guard=True)
    before = pa.get_state()
    buf = DeviceReplayBuffer(64, seed=1, device="cpu")
    rows = _sac_batch(np.random.default_rng(2), ACT, n=8)
    rows["rewards"][3] = np.nan
    buf.add_device_tree(rows)
    infos, _, skipped = pa.learn_superstep(2, 8, rings=buf.superstep_feed(2, 2, 8), k_max=2)
    assert skipped == [True, True] and len(infos) == 2
    after = pa.get_state()
    for n, v in before["weights"].items():
        assert v.tobytes() == after["weights"][n].tobytes()
    assert all(after["opt_state"][g]["count"] == 0 for g in after["opt_state"])


# -- repeatability and state ------------------------------------------------------------


def test_sac_fixed_seed_repeats_and_state_roundtrip():
    rng = np.random.default_rng(3)
    batches = [_sac_batch(rng, ACT) for _ in range(3)]
    a, b = _port_policy(seed=2), _port_policy(seed=2)
    for x in batches:
        assert a.learn_on_batch(SampleBatch(dict(x))) == b.learn_on_batch(SampleBatch(dict(x)))
    _assert_policies_equal(a, b)
    c = _port_policy(seed=9)
    c.set_state(a.get_state())
    c.action_generator.set_state(a.action_generator.get_state())
    x = _sac_batch(rng, ACT)
    assert c.learn_on_batch(SampleBatch(dict(x))) == a.learn_on_batch(SampleBatch(dict(x)))
    assert [st.count for st in c._adam_states()] == [4, 4, 4]
    a.update_target()  # a no-op
    _assert_policies_equal(a, c)
    acts, state, extra = a.compute_actions(x["obs"])
    assert acts.shape == (B, ACT) and state == [] and set(extra) == {"action_logp"}
    assert np.abs(acts).max() <= 2.0
    det, _, _ = a.compute_actions(x["obs"], explore=False)
    det2, _, _ = a.compute_actions(x["obs"], explore=False)
    assert np.array_equal(det, det2)


@pytest.mark.parametrize("typ,item", [("GaussianNoise", "item 4b"),
                                      ("OrnsteinUhlenbeckNoise", "item 4b"), ("Curiosity", "item 9")])
def test_unported_explorations_name_their_item(typ, item):
    from ray_tpu_torch.utils.exploration import exploration_from_config

    with pytest.raises(NotImplementedError, match=item):
        exploration_from_config({"exploration_config": {"type": typ}}, Box(-1, 1, (1,)))


def test_sac_config_defaults_match_reference():
    port, ref = SACConfig().to_dict(), JSACConfig().to_dict()
    for key in ("twin_q", "tau", "initial_alpha", "target_entropy", "optimization",
                "train_batch_size", "rollout_fragment_length",
                "num_steps_sampled_before_learning_starts", "target_network_update_freq",
                "q_model_config", "policy_model_config", "n_step", "grad_clip",
                "replay_buffer_config"):
        assert port[key] == ref[key], key
    cfg = SACConfig().training(tau=0.01, optimization={"actor_learning_rate": 1e-3})
    assert cfg.tau == 0.01 and cfg.optimization["critic_learning_rate"] == 3e-4
    assert get_algorithm_class("SAC") is SAC


def test_inference_only_sync_ships_the_actor(monkeypatch):
    from ray_tpu_torch.core import api
    from ray_tpu_torch.env import registry

    ws = WorkerSet(env_creator=registry.get_env_creator("Pendulum-v1"), policy_cls=SACTorchPolicy,
                   config={**_sac_config(), "device": "cpu"}, num_workers=0, device="cpu")
    sent = []

    class Handle:
        class set_weights:
            @staticmethod
            def remote(ref, global_vars):
                sent.append((ref, global_vars))

    monkeypatch.setattr(api, "put", lambda x: x)
    ws._remote_workers = [Handle()]
    local = ws.local_worker()
    ws.sync_weights(global_vars={"timestep": 5}, inference_only=True)
    ws.sync_weights()
    (actor_only, gv), (full, _) = sent
    assert gv == {"timestep": 5} and local.policy().global_timestep == 5
    policy = local.policy()
    assert set(actor_only["default_policy"]) == {n for n in policy.param_names if n.startswith("actor.")}
    assert set(full["default_policy"]) == set(policy.param_names)
    assert "log_alpha" in full["default_policy"]
    ws._remote_workers = []
    # a worker that only acts takes the partial weights
    w = RolloutWorker(env_creator=registry.get_env_creator("Pendulum-v1"), policy_cls=SACTorchPolicy,
                      config=_sac_config(seed=11), device="cpu")
    w.set_weights(actor_only)
    obs = np.zeros((1, 3), np.float32)
    assert np.array_equal(w.policy().compute_actions(obs, explore=False)[0],
                          policy.compute_actions(obs, explore=False)[0])


# -- SAC.train() -------------------------------------------------------------------------


def _tiny_sac(seed=0, **over):
    cfg = SACConfig().environment("Pendulum-v1").resources(device="cpu").debugging(seed=seed)
    cfg.update_from_dict({
        **HIDDEN, "train_batch_size": 32, "num_steps_sampled_before_learning_starts": 64,
        "min_sample_timesteps_per_iteration": 48, **over,
    })
    return cfg.build()


def _count_calls(monkeypatch, module, name, counts):
    """Count the calls of ``module.name`` (on the CPU a kernel wrapper
    runs its plain version and counts no launch)."""
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        counts[name] = counts.get(name, 0) + 1
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)


def test_sac_train_on_pendulum(monkeypatch):
    counts = {}
    for name in ("gather_rows", "scatter_rows"):
        _count_calls(monkeypatch, replay_buffer, name, counts)
    algo = _tiny_sac()
    results = [algo.train() for _ in range(2)]
    r = results[-1]
    assert r["timesteps_total"] == 96 and r["num_env_steps_trained"] == 33 * 32
    info = r["info"]
    # the reference's round with target_network_update_freq 0: update_target every round
    assert info["num_target_updates"] == 33
    learner = info["learner"]["default_policy"]
    assert set(learner) == set(SAC_STATS) and all(np.isfinite(v) for v in learner.values())
    assert learner["alpha_value"] > 0
    # five replay columns: a scatter each per insert, a gather each per update
    assert counts == {"scatter_rows": 5 * 96, "gather_rows": 5 * 33}
    buf = algo.local_replay_buffer.buffers["default_policy"]
    assert set(buf._store) == {"obs", "new_obs", "actions", "rewards", "dones"}
    assert buf._store["actions"].dtype == torch.float32 and len(buf) == 96
    assert set(r["timers"]) >= {"sample_s", "insert_s", "update_s", "sync_weights_s"}
    again = _tiny_sac()
    assert [again.train() for _ in range(2)][-1]["info"] == info
    with pytest.raises(NotImplementedError, match="actor lane"):
        _tiny_sac(env_backend="jax").train()


def test_sac_prioritized_train_and_yaml_config(monkeypatch):
    counts = {}
    _count_calls(monkeypatch, segment_tree, "find_prefixsum", counts)
    algo = _tiny_sac(replay_buffer_config={"prioritized_replay": True, "capacity": 1000},
                     training_intensity=64, superstep=2,
                     num_steps_sampled_before_learning_starts=32)
    r = algo.train()
    # from learning starts on, each step owes 64 / 32 = 2 updates: one
    # superstep window of 2, one prefix descent per slot
    assert r["num_env_steps_trained"] == 17 * 2 * 32
    assert counts["find_prefixsum"] == 17 * 2
    assert all(np.isfinite(v) for v in r["info"]["learner"]["default_policy"].values())
    algo, stop = build_tuned_example(SAC_YAML, device="cpu")
    assert stop == {"episode_reward_mean": -300, "timesteps_total": 20000}
    cfg = algo.config
    assert (cfg["tau"], cfg["initial_alpha"], cfg["train_batch_size"],
            cfg["num_steps_sampled_before_learning_starts"]) == (0.005, 1.0, 256, 1000)
    assert algo.get_policy().target_entropy == -1.0


@pytest.mark.parametrize("prioritized", [False, True])
def test_single_updates_as_superstep_slots_equal_eager(prioritized):
    """Under a superstep (K = 2 forced here; the card's default is 8) a
    round's one update is one run of the superstep's slot at k = 1: the
    same draws and the same update as the eager round, bitwise."""
    rb = {"prioritized_replay": prioritized, "capacity": 1000}
    runs = [_tiny_sac(seed=4, superstep=k, replay_buffer_config=rb,
                      num_steps_sampled_before_learning_starts=40) for k in (1, 2)]
    results = [[a.train() for _ in range(2)] for a in runs]
    assert results[0][-1]["info"] == results[1][-1]["info"]
    assert results[1][-1]["num_env_steps_trained"] == 57 * 32
    _assert_policies_equal(runs[0].get_policy(), runs[1].get_policy())
    (runner,) = runs[1].get_policy()._superstep_runners.values()
    assert runner.k_max == 2
    if prioritized:
        trees = [a.local_replay_buffer.buffers["default_policy"]._dtree for a in runs]
        assert torch.equal(trees[0].sum_value, trees[1].sum_value)


# -- DQN on the actor lane -----------------------------------------------------------------

DQN_COMMON = {"train_batch_size": 8, "lr": 5e-4, "model": {"fcnet_hiddens": [16, 16]}}


def test_dqn_actor_lane_round_matches_reference(monkeypatch):
    import ray_tpu.algorithms.dqn.dqn as jdqn
    import ray_tpu_torch.algorithms.dqn.dqn as tdqn

    jcfg = (JDQNConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=2, rollout_fragment_length=4)
            .training(replay_device_resident=True, **DQN_COMMON)
            .debugging(seed=3).resources(learner_devices=1))
    jcfg.num_steps_sampled_before_learning_starts = 8
    jcfg.target_network_update_freq = 16
    jcfg.replay_buffer_config.update({"capacity": 64})
    ref = jcfg.build()
    port = (DQNConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=2, rollout_fragment_length=4)
            .training(num_steps_sampled_before_learning_starts=8, target_network_update_freq=16,
                      replay_buffer_config={"capacity": 64}, **DQN_COMMON)
            .debugging(seed=3).resources(device="cpu").build())
    try:
        rp, pp = ref.get_policy(), port.get_policy()
        from_jax_params(jax.device_get(rp.params), pp.model)
        pp.update_target()
        sampled, keys = [], []
        real_sample = jdqn.synchronous_parallel_sample

        def record(**kw):
            batch = real_sample(**kw)
            sampled.append({k: np.asarray(v) for k, v in batch.items()
                            if isinstance(v, np.ndarray) and v.dtype != object})
            return batch

        monkeypatch.setattr(jdqn, "synchronous_parallel_sample", record)
        real_learn = rp.learn_on_device_batch

        def learn(*args, **kw):
            keys.append(rp._rng)
            return real_learn(*args, **kw)

        monkeypatch.setattr(rp, "learn_on_device_batch", learn)
        ref_info = [ref.training_step() for _ in range(3)]

        feed = iter(sampled)
        monkeypatch.setattr(tdqn, "synchronous_parallel_sample",
                            lambda **kw: SampleBatch(dict(next(feed))))
        perms = iter(keys)

        def reference_perm(batch_size):
            _, rng = jax.random.split(next(perms))
            (r,) = jax.random.split(jax.random.fold_in(rng, 0), 1)
            return torch.as_tensor(np.asarray(jax.random.permutation(jax.random.split(r)[0],
                                                                     batch_size)))[None]

        monkeypatch.setattr(pp, "draw_permutations", reference_perm)
        port_info = [port.training_step() for _ in range(3)]
        assert len(keys) == 3 and sum(len(s["obs"]) for s in sampled) == 24
        for key in ("num_env_steps_sampled", "num_env_steps_trained", "num_target_updates"):
            assert port._counters[key] == ref._counters[key], key
        assert pp.global_timestep == rp.global_timestep == 24
        ps = port.local_replay_buffer.get_state()["default_policy"]
        rs = ref.local_replay_buffer.buffers["default_policy"].get_state()
        assert set(ps["cols"]) == set(rs["cols"]) and (ps["idx"], ps["size"]) == (rs["idx"], rs["size"])
        for k, v in rs["cols"].items():
            assert ps["cols"][k].dtype == np.asarray(v).dtype and ps["cols"][k].tobytes() == np.asarray(v).tobytes(), k
        for p, r in zip(port_info, ref_info):
            for k, v in r["default_policy"].items():
                np.testing.assert_allclose(p["default_policy"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)
        got = pp.get_weights()
        for name, r in flax_to_state_dict(jax.device_get(rp.params)).items():
            np.testing.assert_allclose(got[name], r, rtol=1e-5, atol=1.5e-5, err_msg=name)
    finally:
        ref.cleanup()
        port.stop()


def test_dqn_actor_lane_refusals():
    base = (DQNConfig().environment("CartPole-v1").resources(device="cpu")
            .training(**DQN_COMMON))
    algo = base.training(n_step=3).build()
    with pytest.raises(NotImplementedError, match="item 4b"):
        algo.training_step()
    cfg = DQNConfig().environment("CartPole-v1").resources(device="cpu")
    cfg.sample_async = True
    with pytest.raises(NotImplementedError, match="item 5"):
        cfg.build()
    pixel = (DQNConfig().environment("PongLite-v0", env_config={"max_steps": 8, "rallies": 1})
             .rollouts(rollout_fragment_length=8)
             .training(model={"conv_filters": [[4, [8, 8], [4, 4]], [8, [4, 4], [2, 2]]],
                              "post_fcnet_hiddens": [16]})
             .resources(device="cpu").build())
    with pytest.raises(NotImplementedError, match="item 4b"):
        pixel.training_step()


def test_replay_add_uses_policy_columns(monkeypatch):
    counts = {}
    _count_calls(monkeypatch, replay_buffer, "scatter_rows", counts)
    rng = np.random.default_rng(0)
    buf = MultiAgentReplayBuffer(16, seed=0, device="cpu",
                                 replay_columns_fn=lambda pid, sb: {"obs": sb["obs"].astype(np.float32)})
    batch = SampleBatch({"obs": rng.standard_normal((4, 3)), "t": np.arange(4)})
    buf.add(batch)
    assert set(buf.buffers["default_policy"]._store) == {"obs"}
    assert counts == {"scatter_rows": 1}
    plain = MultiAgentReplayBuffer(16, seed=0, device="cpu")
    plain.add(batch)
    ring = plain.buffers["default_policy"]._store
    assert ring["obs"].dtype == torch.float32 and ring["t"].dtype == torch.int32


# -- slow ----------------------------------------------------------------------------------


def _train_to(algo, steps, bar):
    """Train until ``timesteps_total`` reaches ``steps`` or the reward
    mean reaches ``bar``: (last result, best reward mean)."""
    best, result = -np.inf, {}
    while result.get("timesteps_total", 0) < steps:
        result = algo.train()
        if np.isfinite(result["episode_reward_mean"]):
            best = max(best, result["episode_reward_mean"])
        if best >= bar:
            break
    return result, best


@pytest.mark.slow
def test_pendulum_sac_yaml_against_its_bar_and_the_reference():
    """pendulum-sac.yaml as written, the port and the reference, each
    for the yaml's 20,000 env steps or until its bar (-300). The bar is
    the mean over the last 100 episodes (the default smoothing window),
    which at 20,000 steps still holds the first episodes, before and
    just after learning starts: neither package reaches it on the CPU
    (the reference -374.33 and the port -376.65 at 20,224 steps).
    Held here: the port's mean at the end within 75 of the reference's
    (their curves agree within 70 at every 1,024 steps, different random
    streams), and the port's last 10 episodes at or above the bar."""
    from ray_tpu.algorithms.sac.sac import SACConfig as RefSACConfig
    from ray_tpu_torch.utils.tuned_example import load_tuned_example

    algo, stop = build_tuned_example(SAC_YAML, device="cpu")
    port, port_best = _train_to(algo, stop["timesteps_total"], stop["episode_reward_mean"])
    last = [m.episode_reward for m in algo._episode_history[-10:]]
    (exp,) = load_tuned_example(SAC_YAML).values()
    cfg = RefSACConfig().update_from_dict(dict(exp["config"])).resources(learner_devices=1)
    cfg.env = exp["env"]
    ref_algo = cfg.build()
    try:
        ref, ref_best = _train_to(ref_algo, stop["timesteps_total"], stop["episode_reward_mean"])
    finally:
        ref_algo.cleanup()
    assert port_best >= ref_best - 75, (port_best, ref_best)
    assert np.mean(last) >= stop["episode_reward_mean"], last


@pytest.fixture
def runtime():
    core.shutdown()
    core.init(num_cpus=1)
    yield
    core.shutdown()


@pytest.mark.slow
def test_sac_two_remote_workers_iteration(runtime):
    algo = _tiny_sac(num_workers=2, num_steps_sampled_before_learning_starts=16,
                     min_sample_timesteps_per_iteration=32)
    try:
        r = algo.train()
        assert r["timesteps_total"] == 32 and r["num_env_steps_trained"] > 0
        learner = algo.get_policy().get_weights()
        for weights in algo.workers.foreach_worker(policy_weights)[1:]:
            for name, w in weights.items():
                if name.startswith("actor."):
                    assert w.tobytes() == learner[name].tobytes(), name
            # the temperature learned on the learner never ships
            assert weights["log_alpha"] != learner["log_alpha"]
    finally:
        algo.stop()
