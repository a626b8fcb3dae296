"""DDPG and TD3 of the port against the JAX package's, on the CPU.

- ``Deterministic`` against the reference's; ``GaussianNoise`` and
  ``OrnsteinUhlenbeckNoise`` bitwise given the same standard normals
  (the reference's ``jax.random`` draws, injected), OU over several
  steps of carried state, the scale schedule and the bounds;
- the nets carried from the reference (``from_jax_ddpg_state``) and
  their forwards within 1e-5 relative;
- a window of ``2 * policy_delay`` learn calls (DDPG: 2, TD3: 4, so the
  delayed actor step is masked and applied) from the reference's state
  with its smoothing draws injected: parameters, Adam moments, targets
  within 1.5e-5 (the repo's Adam tolerance), Adam counts and the update
  step exactly; TD3's ``compute_td_error`` within 1e-5;
- the K-update superstep (eager slots on the CPU) bitwise against K
  sequential updates, across both parities of TD3's step;
- checkpoint round trips of DDPG (OU state carried) and TD3 (its step)
  bitwise, and a reference TD3 checkpoint loaded into the port;
- pendulum-ddpg.yaml and pendulum-td3.yaml building and training with
  no refusal, and the registry's names;
- serving: DDPG with OU noise takes the server's sequential fallback;
  DDPG with Gaussian noise and Rainbow DQN are served in exact mode,
  bitwise against sequential ``compute_actions`` under any split (the
  reference's gate admits both).
"""

from __future__ import annotations

import os
import pathlib
import pickle

import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.algorithms.ddpg.ddpg import DDPGConfig as JDDPGConfig
from ray_tpu.algorithms.ddpg.ddpg import DDPGJaxPolicy
from ray_tpu.algorithms.ddpg.ddpg import TD3Config as JTD3Config
from ray_tpu.data.sample_batch import SampleBatch as JSampleBatch
from ray_tpu.models.distributions import Deterministic as JDeterministic
from ray_tpu.sharding import get_mesh
from ray_tpu.utils.exploration import exploration as jexp
from ray_tpu_torch.algorithms.algorithm import Algorithm
from ray_tpu_torch.algorithms.ddpg.ddpg import (
    DDPG_STATS,
    DDPGConfig,
    DDPGTorchPolicy,
    TD3Config,
)
from ray_tpu_torch.algorithms.dqn.dqn import DQNTorchPolicy
from ray_tpu_torch.algorithms.registry import get_algorithm_class
from ray_tpu_torch.data.sample_batch import SampleBatch
from ray_tpu_torch.env.spaces import Box, Discrete
from ray_tpu_torch.execution.replay_buffer import DeviceReplayBuffer
from ray_tpu_torch.execution.train_ops import superstep_train_replay
from ray_tpu_torch.models.distributions import Deterministic
from ray_tpu_torch.serve.policy_server import BatchedPolicyServer
from ray_tpu_torch.utils import exploration as texp
from ray_tpu_torch.utils.jax_params import (
    flax_to_state_dict,
    from_jax_adam_state,
    from_jax_algorithm_state,
    from_jax_ddpg_state,
)
from ray_tpu_torch.utils.tuned_example import build_tuned_example

REPO = pathlib.Path(__file__).resolve().parents[1]
DDPG_YAML = REPO / "tuned_examples" / "ddpg" / "pendulum-ddpg.yaml"
TD3_YAML = REPO / "tuned_examples" / "td3" / "pendulum-td3.yaml"


def _one_shard():
    return get_mesh(devices=jax.devices()[:1])


def _normal(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


# -- the distribution and the noises -------------------------------------------------


def test_deterministic_matches_reference():
    x = np.random.default_rng(0).standard_normal((5, 3)).astype(np.float32)
    jd, td = JDeterministic(jnp.asarray(x)), Deterministic(torch.as_tensor(x))
    assert td.sample(None).numpy().tobytes() == np.asarray(jd.sample(jax.random.PRNGKey(0))).tobytes()
    assert td.deterministic_sample().numpy().tobytes() == x.tobytes()
    for name in ("logp", "entropy"):
        args = (td.inputs,) if name == "logp" else ()
        jargs = (jd.inputs,) if name == "logp" else ()
        assert np.array_equal(getattr(td, name)(*args).numpy(), np.asarray(getattr(jd, name)(*jargs)))
    assert td.kl(td).shape == (5,)


NOISE_CFGS = {
    "GaussianNoise": {"stddev": 0.3, "initial_scale": 1.0, "final_scale": 0.2,
                      "scale_timesteps": 100},
    "OrnsteinUhlenbeckNoise": {"scale_timesteps": 10000, "initial_scale": 1.0, "final_scale": 0.02,
                               "ou_base_scale": 0.1, "ou_theta": 0.15, "ou_sigma": 0.2},
}


@pytest.mark.parametrize("typ", sorted(NOISE_CFGS))
def test_noise_explorations_bitwise_given_the_same_normals(typ):
    """Five act steps over 3 slots (OU's state carried from step to
    step) at timesteps across the scale schedule, from the reference's
    normals; the actions near the bounds are clipped alike."""
    low, high = np.array([-2.0, -1.0], np.float32), np.array([2.0, 0.5], np.float32)
    cfg = {"exploration_config": {"type": typ, **NOISE_CFGS[typ]}}
    ref = jexp.exploration_from_config(cfg, gym.spaces.Box(low, high, (2,), np.float32))
    port = texp.exploration_from_config(cfg, Box(low, high, (2,), np.float32))
    assert type(port).__name__ == typ and port.init_coeffs() == ref.init_coeffs()
    jstate, tstate = ref.initial_state(3), port.initial_state(3)
    assert np.array_equal(np.asarray(jstate[0] if jstate else 0), tstate[0].numpy() if tstate else 0)
    rng = np.random.default_rng(1)
    for step, t in enumerate((0, 40, 99, 5000, 20000)):
        jc, tc = {}, {}
        ref.update_coeffs(jc, t)
        port.update_coeffs(tc, t)
        assert jc == tc
        det = (rng.standard_normal((3, 2)) * 1.5).astype(np.float32)
        key = jax.random.PRNGKey(step)
        ja, jlogp, jstate = ref.sample_fn(JDeterministic(jnp.asarray(det)), key, True,
                                          {"noise_scale": jnp.float32(jc["noise_scale"])}, jstate)
        ta, tlogp, tstate = port.sample_fn(
            Deterministic(torch.as_tensor(det)), None, True, tc, tstate,
            (torch.as_tensor(_normal(key, (3, 2))),),
        )
        assert ta.numpy().tobytes() == np.asarray(ja).tobytes(), (typ, t)
        assert np.array_equal(tlogp.numpy(), np.asarray(jlogp))
        if jstate:
            assert tstate[0].numpy().tobytes() == np.asarray(jstate[0]).tobytes()
        greedy, _, _ = port.sample_fn(Deterministic(torch.as_tensor(det)), None, False, tc, tstate)
        assert greedy.numpy().tobytes() == det.tobytes()


# -- one learn window ------------------------------------------------------------------

B, OBS, ACT = 16, 3, 1
HIDDEN = {"actor_hiddens": [32, 24], "critic_hiddens": [24, 32]}


def _config(cls, **over):
    cfg = {**cls().to_dict(), **HIDDEN, "seed": 3, "train_batch_size": B, "gamma": 0.97,
           "tau": 0.05, **over}
    cfg.pop("env", None)
    return cfg


def _batch(rng, n=B):
    return {
        "obs": rng.standard_normal((n, OBS)).astype(np.float32),
        "new_obs": rng.standard_normal((n, OBS)).astype(np.float32),
        "actions": rng.uniform(-2, 2, (n, ACT)).astype(np.float32),
        "rewards": rng.standard_normal(n).astype(np.float32),
        "dones": rng.random(n) < 0.25,
        "n_steps": rng.integers(1, 4, n).astype(np.float32),
    }


def _pair(td3, **over):
    """A reference policy one update in (targets unlike the nets, Adam
    counts past 0) and a port policy carrying its state."""
    cfg = _config(JTD3Config if td3 else JDDPGConfig, **over)
    space, act = gym.spaces.Box(-1, 1, (OBS,), np.float32), gym.spaces.Box(-2, 2, (ACT,), np.float32)
    ref = DDPGJaxPolicy(space, act, {**cfg, "_mesh": _one_shard()})
    rng = np.random.default_rng(0)
    ref.learn_on_batch(JSampleBatch(_batch(rng)))
    port = DDPGTorchPolicy(Box(-1, 1, (OBS,)), Box(-2, 2, (ACT,)), cfg, device="cpu")
    from_jax_ddpg_state(port, jax.device_get(ref.params), jax.device_get(ref.aux_state),
                        jax.device_get(ref.opt_state))
    return ref, port, rng


def _learn_normal(key, n=B):
    """The smoothing normal ``DDPGJaxPolicy``'s update draws on shard 0
    from the policy key (split, then the shard index folded in)."""
    _, rng = jax.random.split(key)
    return torch.as_tensor(_normal(jax.random.fold_in(rng, 0), (n, ACT)))


def _assert_state_close(port, ref, atol=1.5e-5):
    got = port.get_state()
    for group in ("actor", "critic"):
        want = flax_to_state_dict(jax.device_get(ref.params[group]))
        count, mu, nu = from_jax_adam_state(jax.device_get(ref.opt_state[group]))
        assert got["opt_state"][group]["count"] == count, group
        for k, v in want.items():
            name = f"{group}.{k}"
            np.testing.assert_allclose(got["weights"][name], v, rtol=1e-5, atol=atol, err_msg=name)
            np.testing.assert_allclose(got["opt_state"][group]["mu"][name], mu[k], rtol=1e-5,
                                       atol=atol, err_msg=name)
            np.testing.assert_allclose(got["opt_state"][group]["nu"][name], nu[k], rtol=1e-5,
                                       atol=atol * 1e-3, err_msg=name)
        target = flax_to_state_dict(jax.device_get(ref.aux_state[f"target_{group}"]))
        for k, v in target.items():
            np.testing.assert_allclose(got["aux_state"][f"target_{group}"][k], v, rtol=1e-5,
                                       atol=atol, err_msg=k)
    assert got["aux_state"]["step"] == int(ref.aux_state["step"]) == port.num_updates


def test_nets_carried_from_reference():
    ref, port, rng = _pair(td3=True)
    b = _batch(rng)
    obs, act = jnp.asarray(b["obs"]), jnp.asarray(b["actions"])
    with torch.no_grad():
        np.testing.assert_allclose(port.actor(torch.as_tensor(b["obs"])).numpy(),
                                   np.asarray(ref.actor.apply(ref.params["actor"], obs)),
                                   rtol=1e-5, atol=1e-6)
        for p, r in zip(port.critic(torch.as_tensor(b["obs"]), torch.as_tensor(b["actions"])),
                        ref.critic.apply(ref.params["critic"], obs, act)):
            np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)
    _assert_state_close(port, ref, atol=0.0)


@pytest.mark.parametrize("td3,over", [
    (False, {}),
    (True, {}),
    (False, {"twin_q": True, "use_huber": True, "l2_reg": 1e-3}),
    (True, {"policy_delay": 3, "target_noise": 0.4, "target_noise_clip": 0.3}),
])
def test_learn_window_matches_reference(td3, over):
    ref, port, rng = _pair(td3, **over)
    delay = int(ref.policy_delay)
    for _ in range(2 * delay):
        b = _batch(rng)
        normal = _learn_normal(ref._rng)
        ref_stats = ref.learn_on_batch(JSampleBatch(dict(b)))
        stats = port.learn_on_batch(SampleBatch(dict(b)), normals=normal)
        assert tuple(stats) == DDPG_STATS and set(stats) == set(ref_stats)
        for k, v in ref_stats.items():
            np.testing.assert_allclose(stats[k], v, rtol=1e-5, atol=1e-5, err_msg=k)
    _assert_state_close(port, ref)
    # the delayed actor stepped at updates 0, delay and 2 delay of the 2 delay + 1
    assert port.opt_states["actor"].count == 3
    assert port.opt_states["critic"].count == 2 * delay + 1
    if td3:
        b = _batch(rng)
        key = jax.random.split(ref._rng)[1]
        want = ref.compute_td_error(JSampleBatch(dict(b)))
        got = port.compute_td_error(b, normal=torch.as_tensor(_normal(key, (B, ACT))))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# -- the superstep -----------------------------------------------------------------


def _port(td3, seed=7, **over):
    cls = TD3Config if td3 else DDPGConfig
    return DDPGTorchPolicy(Box(-1, 1, (OBS,)), Box(-2, 2, (ACT,)),
                           {**_config(cls, **over), "seed": seed}, device="cpu")


def _assert_policies_equal(a, b):
    sa, sb = a.get_state(), b.get_state()
    for n in sa["weights"]:
        assert sa["weights"][n].tobytes() == sb["weights"][n].tobytes(), n
    for key in ("target_actor", "target_critic"):
        for n, v in sa["aux_state"][key].items():
            assert v.tobytes() == sb["aux_state"][key][n].tobytes(), (key, n)
    assert sa["aux_state"]["step"] == sb["aux_state"]["step"]
    for g, s in sa["opt_state"].items():
        assert s["count"] == sb["opt_state"][g]["count"], g
        for m in ("mu", "nu"):
            for n, v in s[m].items():
                assert v.tobytes() == sb["opt_state"][g][m][n].tobytes(), (g, m, n)
    assert torch.equal(a.action_generator.get_state(), b.action_generator.get_state())


@pytest.mark.parametrize("td3,k", [(False, 2), (True, 3), (True, 4)])
def test_superstep_equals_sequential_updates(td3, k):
    """Eager slots (the CPU's superstep) against ``k`` sequential
    updates; two supersteps, so TD3's window spans both parities."""
    pa, pb = _port(td3), _port(td3)
    ba, bb = (DeviceReplayBuffer(64, seed=5, device="cpu") for _ in range(2))
    for buf in (ba, bb):
        buf.add_device_tree(_batch(np.random.default_rng(5), n=48))
    for _ in range(2):
        idx = torch.as_tensor(bb.draw_index_sets(k, 8))
        seq = [pb.learn_on_device_batch(bb._gather_columns(idx[i]), 8) for i in range(k)]
        info = superstep_train_replay(None, pa, ba, k, k, 8)
        assert info == seq[-1]
    _assert_policies_equal(pa, pb)
    assert pa.num_updates == pb.num_updates == 2 * k


# -- state ---------------------------------------------------------------------------


@pytest.mark.parametrize("td3", [False, True])
def test_policy_state_roundtrip_is_bitwise(td3):
    a = _port(td3)
    rng = np.random.default_rng(2)
    for _ in range(3):
        a.learn_on_batch(_batch(rng))
    obs = rng.standard_normal((4, OBS)).astype(np.float32)
    a.global_timestep = 700
    a.compute_actions(obs)  # OU: the carried state moves off zero
    b = _port(td3, seed=11)
    b.set_state(a.get_state())
    _assert_policies_equal_but_generators(a, b)
    if not td3:
        assert a._expl_state[0].abs().sum() > 0
        assert torch.equal(a._expl_state[0], b._expl_state[0]) and b._expl_state_batch == 4
    b.action_generator.set_state(a.action_generator.get_state())
    assert np.array_equal(a.compute_actions(obs)[0], b.compute_actions(obs)[0])
    batch = _batch(rng)
    assert a.learn_on_batch(dict(batch)) == b.learn_on_batch(dict(batch))
    _assert_policies_equal(a, b)


def _assert_policies_equal_but_generators(a, b):
    b_gen = b.action_generator.get_state()
    b.action_generator.set_state(a.action_generator.get_state())
    _assert_policies_equal(a, b)
    b.action_generator.set_state(b_gen)


def test_algorithm_checkpoint_roundtrip(tmp_path):
    algo, _ = build_tuned_example(TD3_YAML, device="cpu",
                                  num_steps_sampled_before_learning_starts=16,
                                  train_batch_size=16)
    try:
        for _ in range(24):
            algo.train()
        path = algo.save(str(tmp_path / "ck"))
        back = Algorithm.from_checkpoint(path, device="cpu")
        try:
            assert type(back).__name__ == "TD3"
            _assert_policies_equal_but_generators(algo.get_policy(), back.get_policy())
            assert back.get_policy().num_updates == algo.get_policy().num_updates > 0
        finally:
            back.stop()
    finally:
        algo.stop()


def test_reference_td3_checkpoint_loads_into_the_port(tmp_path):
    over = dict(num_steps_sampled_before_learning_starts=16, train_batch_size=16,
                actor_hiddens=[16, 16], critic_hiddens=[16, 16])
    jcfg = JTD3Config().environment("Pendulum-v1").rollouts(num_rollout_workers=0)
    jcfg = jcfg.training(**over).debugging(seed=1).resources(learner_devices=1)
    ref = jcfg.build()
    port = (TD3Config().environment("Pendulum-v1").rollouts(num_rollout_workers=0)
            .training(**over).debugging(seed=1).resources(device="cpu").build())
    try:
        for _ in range(20):  # one env step an iteration: 5 updates after the warmup
            ref.train()
        path = ref.save(str(tmp_path / "ref_ckpt"))
        with open(os.path.join(path, "algorithm_state.pkl"), "rb") as f:
            state = pickle.load(f)
        from_jax_algorithm_state(port, state)
        rp, pp = ref.get_policy(), port.get_policy()
        _assert_state_close(pp, rp, atol=0.0)
        assert pp.opt_states["actor"].count < pp.opt_states["critic"].count  # the delay
        assert port._counters["num_env_steps_sampled"] == ref._counters["num_env_steps_sampled"]
        rng = np.random.default_rng(9)
        b = _batch(rng)
        normal = _learn_normal(rp._rng)
        ref_stats = rp.learn_on_batch(JSampleBatch(dict(b)))
        stats = pp.learn_on_batch(SampleBatch(dict(b)), normals=normal)
        for k, v in ref_stats.items():
            np.testing.assert_allclose(stats[k], v, rtol=1e-5, atol=1e-5, err_msg=k)
        _assert_state_close(pp, rp)
    finally:
        ref.cleanup()
        port.stop()


# -- the actor lane ------------------------------------------------------------------


@pytest.mark.parametrize("path,name,explore,first", [
    (DDPG_YAML, "DDPG", "OrnsteinUhlenbeckNoise", 64),  # learning starts at 64 rows
    (TD3_YAML, "TD3", "GaussianNoise", 100),  # a batch of 100 rows
])
def test_yaml_trains_on_the_actor_lane(path, name, explore, first):
    assert get_algorithm_class(name).__name__ == name
    algo, stop = build_tuned_example(path, device="cpu", num_steps_sampled_before_learning_starts=64)
    try:
        policy = algo.get_policy()
        assert type(policy.exploration).__name__ == explore and stop["timesteps_total"]
        results = [algo.train() for _ in range(first + 16)]  # one env step an iteration
        learner = results[-1]["info"]["learner"]["default_policy"]
        assert tuple(learner) == DDPG_STATS and np.isfinite(list(learner.values())).all()
        assert policy.num_updates == 17 and results[-1]["num_env_steps_sampled"] == first + 16
        if name == "TD3":
            assert policy.opt_states["actor"].count == (policy.num_updates + 1) // 2
    finally:
        algo.stop()


# -- serving ----------------------------------------------------------------------


def _serve_policy(kind):
    if kind == "rainbow":
        cfg = {"num_atoms": 11, "v_min": 0.0, "v_max": 10.0, "noisy": True, "n_step": 3,
               "model": {"fcnet_hiddens": [16, 16]}, "seed": 2,
               "exploration_config": {"initial_epsilon": 0.3, "final_epsilon": 0.3,
                                      "epsilon_timesteps": 1}}
        return DQNTorchPolicy(Box(-1, 1, (OBS,), np.float32), Discrete(3), cfg, device="cpu")
    explore = "GaussianNoise" if kind == "gaussian" else "OrnsteinUhlenbeckNoise"
    cfg = _config(DDPGConfig, exploration_config={"type": explore, "stddev": 0.5})
    return DDPGTorchPolicy(Box(-1, 1, (OBS,)), Box(-2, 2, (ACT,)), cfg, device="cpu")


def test_ou_policy_takes_the_sequential_fallback():
    policy = _serve_policy("ou")
    assert not policy.supports_batched_serve
    server = BatchedPolicyServer(policy, start=False, explore=True)
    assert not server.fused and server.warmup() == 0
    obs = np.random.default_rng(0).standard_normal((3, OBS)).astype(np.float32)
    actions, _ = server.forward_padded(obs)
    assert actions.shape == (3, ACT) and np.isfinite(actions).all()
    assert policy._expl_state_batch == 1  # one compute_actions a request


@pytest.mark.parametrize("kind", ["gaussian", "rainbow"])
@pytest.mark.parametrize("split", [(1, 1, 1, 1, 1, 1), (2, 4), (6,), (3, 1, 2)])
def test_exact_serving_is_sequential_compute_actions(kind, split):
    """The reference's gate admits both (stateless exploration, a
    feed-forward model): served in exact mode under any split, bitwise
    the same stream as sequential ``compute_actions``."""
    served, sequential = _serve_policy(kind), _serve_policy(kind)
    assert served.supports_batched_serve
    server = BatchedPolicyServer(served, start=False, explore=True, max_batch_size=8)
    assert server.fused
    server.warmup()
    obs = np.random.default_rng(1).standard_normal((6, OBS)).astype(np.float32)
    got, at = [], 0
    for n in split:
        actions, _ = server.forward_padded(obs[at:at + n])
        got.append(actions)
        at += n
    want = np.concatenate([sequential.compute_actions(obs[i:i + 1])[0] for i in range(6)])
    assert np.concatenate(got).tobytes() == want.tobytes()
