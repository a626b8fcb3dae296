"""The model surface's rest, the port against the reference on the CPU:
``MultiCategorical`` and ``Bernoulli`` (logp, entropy, KL and the
deterministic samples within 1e-6; samples from the reference's draws
bitwise), the catalog's action-distribution sizes for gymnasium's spaces
and the port's, one PPO ``learn_on_batch`` over ``MultiDiscrete`` and
``MultiBinary`` (the reference's permutations injected, weights carried
across; the PPO test's tolerances), a custom model and a custom action
distribution (a small MLP written in both frameworks here) through PPO
and DQN, Curiosity's and RND's intrinsic rewards (1e-5 relative) and one
update of their nets (1.5e-5) from the reference's state carried by
``from_jax_exploration_state``, and the reference's own exploration
contracts (``tests/test_exploration.py``) on the port. One intra-op
thread for the module: its learns are small.
"""

from __future__ import annotations

import functools
import types

import flax.linen as fnn
import gymnasium as gym
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.algorithms.dqn.dqn import DQNJaxPolicy
from ray_tpu.algorithms.ppo.ppo import PPOJaxPolicy
from ray_tpu.data.sample_batch import SampleBatch as JSampleBatch
from ray_tpu.models import distributions as jdists
from ray_tpu.models.base import RTModel
from ray_tpu.models.catalog import ModelCatalog as RefCatalog
from ray_tpu.sharding import get_mesh
from ray_tpu.utils.exploration.curiosity import Curiosity as RefCuriosity
from ray_tpu.utils.exploration.rnd import RND as RefRND
from ray_tpu_torch.algorithms.dqn.dqn import DQNTorchPolicy
from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig, PPOTorchPolicy
from ray_tpu_torch.data.sample_batch import SampleBatch
from ray_tpu_torch.env.spaces import Box, Discrete, MultiBinary, MultiDiscrete
from ray_tpu_torch.models import distributions as tdists
from ray_tpu_torch.models.base import Dense, TorchModel
from ray_tpu_torch.models.catalog import ModelCatalog
from ray_tpu_torch.utils.exploration import RND, Curiosity
from ray_tpu_torch.utils.exploration.exploration import exploration_from_config
from ray_tpu_torch.utils.jax_params import (
    flax_to_state_dict,
    from_jax_adam_state,
    from_jax_exploration_state,
    from_jax_params,
)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _one_shard():
    return get_mesh(devices=jax.devices()[:1])


# -- distributions -------------------------------------------------------------

LENS = (3, 4, 5)


def _close(a, b, tol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def test_multi_categorical_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((11, sum(LENS))).astype(np.float32) * 2
    y = rng.standard_normal((11, sum(LENS))).astype(np.float32)
    acts = np.stack([rng.integers(0, n, 11) for n in LENS], -1)
    jd = jdists.MultiCategorical(jnp.asarray(x), LENS)
    jo = jdists.MultiCategorical(jnp.asarray(y), LENS)
    cls = tdists.MultiCategorical.with_lens(LENS)
    assert tdists.MultiCategorical.with_lens(list(LENS)) is cls
    td, to = cls(torch.as_tensor(x)), cls(torch.as_tensor(y))
    _close(td.logp(torch.as_tensor(acts)), jd.logp(jnp.asarray(acts)))
    _close(td.entropy(), jd.entropy())
    _close(td.kl(to), jd.kl(jo))
    det = td.deterministic_sample()
    assert det.dtype == torch.int64 and det.shape == (11, 3)
    np.testing.assert_array_equal(det.numpy(), np.asarray(jd.deterministic_sample()))
    # a sample from the reference's draws: each component's key of the
    # split, uniforms as jax.random.categorical draws them
    key = jax.random.PRNGKey(4)
    tiny = np.finfo(np.float32).tiny
    u = np.concatenate([
        np.asarray(jax.random.uniform(k, (11, n), minval=tiny, maxval=1.0))
        for k, n in zip(jax.random.split(key, len(LENS)), LENS)], -1)
    np.testing.assert_array_equal(td.sample(None, torch.as_tensor(u)).numpy(),
                                  np.asarray(jd.sample(key)))
    a, logp = td.sampled_action_logp(torch.Generator().manual_seed(1))
    b, _ = td.sampled_action_logp(torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and torch.allclose(logp, td.logp(a))
    assert all(((a[:, i] >= 0) & (a[:, i] < n)).all() for i, n in enumerate(LENS))


def test_bernoulli_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((13, 6)).astype(np.float32) * 3
    y = rng.standard_normal((13, 6)).astype(np.float32)
    acts = rng.integers(0, 2, (13, 6))
    jd, jo = jdists.Bernoulli(jnp.asarray(x)), jdists.Bernoulli(jnp.asarray(y))
    td, to = tdists.Bernoulli(torch.as_tensor(x)), tdists.Bernoulli(torch.as_tensor(y))
    _close(td.logp(torch.as_tensor(acts)), jd.logp(jnp.asarray(acts)))
    _close(td.entropy(), jd.entropy())
    _close(td.kl(to), jd.kl(jo))
    np.testing.assert_array_equal(td.deterministic_sample().numpy(),
                                  np.asarray(jd.deterministic_sample()))
    key = jax.random.PRNGKey(7)
    u = np.array(jax.random.uniform(key, (13, 6)))
    got = td.sample(None, torch.as_tensor(u))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(jd.sample(key)))
    assert tdists.Bernoulli.required_model_output_shape(MultiBinary(6)) == 6


@pytest.mark.parametrize("which", ["gymnasium", "port"])
def test_action_dist_sizes_match_the_reference(which):
    spaces = {
        "gymnasium": [gym.spaces.Discrete(4), gym.spaces.Box(-1, 1, (3,)),
                      gym.spaces.MultiDiscrete([3, 4, 5]), gym.spaces.MultiBinary(6)],
        "port": [Discrete(4), Box(-1, 1, (3,)), MultiDiscrete([3, 4, 5]), MultiBinary(6)],
    }[which]
    ref_spaces = [gym.spaces.Discrete(4), gym.spaces.Box(-1, 1, (3,)),
                  gym.spaces.MultiDiscrete([3, 4, 5]), gym.spaces.MultiBinary(6)]
    kinds = [tdists.Categorical, tdists.DiagGaussian, tdists.MultiCategorical, tdists.Bernoulli]
    for space, ref_space, kind in zip(spaces, ref_spaces, kinds):
        cls, size = ModelCatalog.get_action_dist(space)
        assert size == RefCatalog.get_action_dist(ref_space)[1]
        assert issubclass(cls, kind)


# -- PPO over the new spaces -----------------------------------------------------

B, MB, ITERS, OBS = 32, 16, 2, 5
PPO_CONFIG = {
    "train_batch_size": B, "sgd_minibatch_size": MB, "num_sgd_iter": ITERS, "lr": 5e-4,
    "kl_coeff": 0.2, "entropy_coeff": 0.01, "grad_clip": 40.0, "seed": 3,
    "model": {"fcnet_hiddens": [16, 16]},
}


class _RefMultiCategorical(jdists.MultiCategorical):
    """The reference's ``MultiCategorical`` with its split points from
    numpy: ``jnp.split`` at a ``jnp.cumsum`` fails under jit."""

    def __init__(self, inputs, input_lens):
        jdists.ActionDistribution.__init__(self, inputs)
        self.input_lens = tuple(int(x) for x in input_lens)
        splits = np.cumsum(self.input_lens)[:-1].tolist()
        self.cats = [jdists.Categorical(x) for x in jnp.split(inputs, splits, axis=-1)]


def _reference_perms(key, n=B, iters=ITERS):
    _, rng = jax.random.split(key)
    rng = jax.random.fold_in(rng, 0)
    return np.stack([np.asarray(jax.random.permutation(jax.random.split(r)[0], n))
                     for r in jax.random.split(rng, iters)])


def _ppo_batch(actions, width, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.standard_normal((B, OBS)).astype(np.float32),
        "actions": actions,
        "action_logp": np.full(B, -3.1, np.float32),
        "action_dist_inputs": rng.standard_normal((B, width)).astype(np.float32),
        "advantages": rng.standard_normal(B).astype(np.float32),
        "value_targets": rng.standard_normal(B).astype(np.float32),
    }


def _assert_learn_matches(ref, port, batch):
    perms = _reference_perms(ref._rng)
    ref_stats = ref.learn_on_batch(batch)
    stats = port.learn_on_batch(batch, perms=torch.as_tensor(perms))
    assert set(stats) == set(ref_stats)
    for k, v in ref_stats.items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    ref_params = flax_to_state_dict(jax.device_get(ref.params))
    got = port.get_weights()
    for name, r in ref_params.items():
        np.testing.assert_allclose(got[name], r, rtol=1e-5, atol=1.5e-5, err_msg=name)
    count, mu, _ = from_jax_adam_state(jax.device_get(ref.opt_state))
    assert port.get_state()["opt_state"]["count"] == count
    for name in ref_params:
        np.testing.assert_allclose(port.get_state()["opt_state"]["mu"][name], mu[name],
                                   rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("space", ["multi_discrete", "multi_binary"])
def test_ppo_learns_over_the_space_like_the_reference(space):
    rng = np.random.default_rng(2)
    if space == "multi_discrete":
        ref_space, port_space = gym.spaces.MultiDiscrete(list(LENS)), MultiDiscrete(LENS)
        acts, width = np.stack([rng.integers(0, n, B) for n in LENS], -1), sum(LENS)
    else:
        ref_space, port_space = gym.spaces.MultiBinary(6), MultiBinary(6)
        acts, width = rng.integers(0, 2, (B, 6)), 6
    obs_space = gym.spaces.Box(-1, 1, (OBS,), np.float32)
    ref = PPOJaxPolicy(obs_space, ref_space, {**PPO_CONFIG, "_mesh": _one_shard()})
    if space == "multi_discrete":
        # the reference's MultiCategorical splits its inputs at a traced
        # cumsum, which jit refuses (ROADMAP queue 3): the same class with
        # its split points computed on the host
        ref.dist_class = functools.partial(_RefMultiCategorical, input_lens=LENS)
    port = PPOTorchPolicy(Box(-1, 1, (OBS,), np.float32), port_space, PPO_CONFIG, device="cpu")
    from_jax_params(jax.device_get(ref.params), port.model)
    batch = _ppo_batch(acts.astype(np.int64), width)
    # acting: greedy actions equal the reference's, sampled ones are in
    # range, with the reference's shapes and int64
    greedy = port.compute_actions(batch["obs"], explore=False)[0]
    ref_greedy = ref.compute_actions(batch["obs"], explore=False)[0]
    np.testing.assert_array_equal(greedy, np.asarray(ref_greedy))
    sampled, _, extra = port.compute_actions(batch["obs"])
    assert sampled.shape == np.asarray(ref_greedy).shape and sampled.dtype == np.int64
    assert extra["action_dist_inputs"].shape == (B, width)
    _assert_learn_matches(ref, port, batch)


# -- custom models and action distributions -------------------------------------


class RefSurfaceMLP(RTModel):
    num_outputs: int
    hidden: int = 16

    @fnn.compact
    def __call__(self, obs, state=(), seq_lens=None):
        x = obs.reshape(obs.shape[0], -1).astype(jnp.float32)
        h = jnp.tanh(fnn.Dense(self.hidden, name="torso")(x))
        logits = fnn.Dense(self.num_outputs, name="head")(h)
        value = fnn.Dense(1, name="vf")(h)
        return logits, value.squeeze(-1), ()


class PortSurfaceMLP(TorchModel):
    def __init__(self, obs_shape, num_outputs, generator=None, hidden=16):
        super().__init__()
        n = int(np.prod(obs_shape))
        self.torso = Dense(n, hidden, generator=generator)
        self.head = Dense(hidden, num_outputs, generator=generator)
        self.vf = Dense(hidden, 1, generator=generator)

    def forward(self, obs):
        h = torch.tanh(self.torso(obs.reshape(obs.shape[0], -1).float()))
        return self.head(h), self.vf(h).squeeze(-1), ()


class RefTempered(jdists.Categorical):
    def __init__(self, inputs):
        super().__init__(inputs * 0.5)


class PortTempered(tdists.Categorical):
    def __init__(self, inputs):
        super().__init__(inputs * 0.5)


RefCatalog.register_custom_model("surface_mlp", RefSurfaceMLP)
RefCatalog.register_custom_action_dist("tempered", RefTempered)
ModelCatalog.register_custom_model("surface_mlp", PortSurfaceMLP)
ModelCatalog.register_custom_action_dist("tempered", PortTempered)


@pytest.mark.parametrize("by", ["name", "class"])
def test_custom_model_and_action_dist_through_ppo(by):
    port_model = {"custom_model": "surface_mlp" if by == "name" else PortSurfaceMLP,
                  "custom_model_config": {"hidden": 12},
                  "custom_action_dist": "tempered" if by == "name" else PortTempered}
    ref_model = {"custom_model": "surface_mlp", "custom_model_config": {"hidden": 12},
                 "custom_action_dist": "tempered"}
    obs_space = gym.spaces.Box(-1, 1, (OBS,), np.float32)
    ref = PPOJaxPolicy(obs_space, gym.spaces.Discrete(3),
                       {**PPO_CONFIG, "model": ref_model, "_mesh": _one_shard()})
    port = PPOTorchPolicy(Box(-1, 1, (OBS,), np.float32), Discrete(3),
                          {**PPO_CONFIG, "model": port_model}, device="cpu")
    assert isinstance(port.model, PortSurfaceMLP) and port.dist_class is PortTempered
    assert port.model.torso.weight.shape == (12, OBS)
    from_jax_params(jax.device_get(ref.params), port.model)
    rng = np.random.default_rng(5)
    batch = _ppo_batch(rng.integers(0, 3, B).astype(np.int64), 3)
    obs = batch["obs"]
    _, _, extra = port.compute_actions(obs, explore=False)
    _, _, ref_extra = ref.compute_actions(obs, explore=False)
    _close(extra["action_logp"], ref_extra["action_logp"], 1e-5)
    _assert_learn_matches(ref, port, batch)


def test_custom_model_through_dqn():
    cfg = {"train_batch_size": 16, "lr": 5e-4, "grad_clip": 40.0, "gamma": 0.99, "seed": 3,
           "model": {"custom_model": "surface_mlp", "custom_model_config": {"hidden": 12}}}
    obs_space = gym.spaces.Box(-1, 1, (OBS,), np.float32)
    ref = DQNJaxPolicy(obs_space, gym.spaces.Discrete(3), {**cfg, "_mesh": _one_shard()})
    port = DQNTorchPolicy(Box(-1, 1, (OBS,), np.float32), Discrete(3), cfg, device="cpu")
    assert isinstance(port.model, PortSurfaceMLP) and not port._uses_dqn_model
    from_jax_params(jax.device_get(ref.params), port.model)
    port.aux_state = {"target_params": [p.detach().clone() for p in port.params]}
    rng = np.random.default_rng(6)
    n = 16
    batch = {
        "obs": rng.standard_normal((n, OBS)).astype(np.float32),
        "new_obs": rng.standard_normal((n, OBS)).astype(np.float32),
        "actions": rng.integers(0, 3, n).astype(np.int32),
        "rewards": rng.standard_normal(n).astype(np.float32),
        "dones": rng.random(n) < 0.25,
        "weights": (rng.random(n) + 0.5).astype(np.float32),
    }
    np.testing.assert_allclose(port.compute_td_error(batch),
                               ref.compute_td_error(JSampleBatch(dict(batch))),
                               rtol=1e-5, atol=1e-5)
    perm = _reference_perms(ref._rng, n, 1)
    ref_stats = ref.learn_on_batch(JSampleBatch(dict(batch)))
    stats = port.learn_on_batch(batch, perms=torch.as_tensor(perm))
    for k, v in ref_stats.items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    got = port.get_weights()
    for name, r in flax_to_state_dict(jax.device_get(ref.params)).items():
        np.testing.assert_allclose(got[name], r, rtol=1e-5, atol=1.5e-5, err_msg=name)
    for bad in ({"num_atoms": 51}, {"noisy": True}):
        with pytest.raises(ValueError, match="custom_model"):
            DQNTorchPolicy(Box(-1, 1, (OBS,), np.float32), Discrete(3), {**cfg, **bad},
                           device="cpu")


def test_custom_model_must_be_a_torch_model():
    with pytest.raises(TypeError, match="TorchModel"):
        ModelCatalog.get_model(Box(-1, 1, (OBS,)), Discrete(2), 2, {"custom_model": dict})
    with pytest.raises(ValueError, match="no custom action distribution registered"):
        ModelCatalog.get_action_dist(Discrete(2), {"custom_action_dist": "nope"})


# -- Curiosity and RND -----------------------------------------------------------

_CPU = types.SimpleNamespace(device=torch.device("cpu"), config={"seed": 0})


def _transitions(n=24, seed=0):
    rng = np.random.default_rng(seed)
    return {
        SampleBatch.OBS: rng.standard_normal((n, 4)).astype(np.float32),
        SampleBatch.NEXT_OBS: rng.standard_normal((n, 4)).astype(np.float32),
        SampleBatch.ACTIONS: rng.integers(0, 2, n),
        SampleBatch.REWARDS: rng.standard_normal(n).astype(np.float32),
    }


def _states_close(got, want, tol=1.5e-5):
    for key in ("params", "target_params", "predictor_params"):
        if key in want:
            assert set(got[key]) == set(want[key])
            for n in want[key]:
                np.testing.assert_allclose(got[key][n], want[key][n], rtol=tol, atol=tol,
                                           err_msg=f"{key}.{n}")
    assert got["opt_state"]["count"] == want["opt_state"]["count"]
    # the moments' absolute floors are the PPO test's: 1e-6 and 1e-9
    for part, floor in (("mu", 1e-6), ("nu", 1e-9)):
        for n, v in want["opt_state"][part].items():
            np.testing.assert_allclose(got["opt_state"][part][n], v, rtol=tol,
                                       atol=floor if tol else 0.0, err_msg=f"{part}.{n}")


@pytest.mark.parametrize("kind", ["curiosity", "rnd"])
def test_intrinsic_rewards_and_updates_match_the_reference(kind):
    if kind == "curiosity":
        cfg = {"feature_dim": 8, "eta": 0.3, "beta": 0.2, "lr": 1e-3,
               "feature_net_hiddens": [16], "inverse_net_hiddens": [16],
               "forward_net_hiddens": [16]}
        ref, port = RefCuriosity(gym.spaces.Discrete(2), cfg), Curiosity(Discrete(2), cfg)
    else:
        cfg = {"embed_dim": 8, "intrinsic_reward_coeff": 0.5, "lr": 1e-3, "hiddens": [16]}
        ref, port = RefRND(gym.spaces.Discrete(2), cfg), RND(Discrete(2), cfg)
    first = _transitions()
    ref._init_params(first[SampleBatch.OBS])
    port.set_state(from_jax_exploration_state(jax.device_get(ref.get_state())))
    for step in range(3):
        batch = _transitions(seed=step)
        want = ref.postprocess_trajectory(None, JSampleBatch(
            {k: v.copy() for k, v in batch.items()}))
        got = port.postprocess_trajectory(_CPU, SampleBatch(
            {k: v.copy() for k, v in batch.items()}))
        intrinsic = got[SampleBatch.REWARDS] - batch[SampleBatch.REWARDS]
        ref_intrinsic = np.asarray(want[SampleBatch.REWARDS]) - batch[SampleBatch.REWARDS]
        assert (intrinsic > 0).all()
        np.testing.assert_allclose(intrinsic, ref_intrinsic, rtol=1e-5, atol=1e-7)
        _states_close(port.get_state(), from_jax_exploration_state(jax.device_get(
            ref.get_state())))
    if kind == "rnd":
        # the float64 normaliser over the float32 errors: the rewards' 1e-5
        np.testing.assert_allclose(port.get_state()["norm"], ref.get_state()["norm"],
                                   rtol=1e-5)


@pytest.mark.parametrize("kind", ["Curiosity", "RND"])
def test_exploration_state_round_trips_and_resumes(kind):
    cfg = {"type": kind, "feature_dim": 8, "embed_dim": 8}
    a = exploration_from_config({"exploration_config": cfg}, Discrete(2))
    b = exploration_from_config({"exploration_config": cfg}, Discrete(2))
    assert a.get_state() == {}
    a.postprocess_trajectory(_CPU, SampleBatch(_transitions(seed=1)))
    state = a.get_state()
    b.set_state(state)  # pending: built at the next fragment
    assert b.get_state() is not state
    for key in state:
        assert str(b.get_state()[key]) == str(state[key])
    ra = a.postprocess_trajectory(_CPU, SampleBatch(_transitions(seed=2)))
    rb = b.postprocess_trajectory(_CPU, SampleBatch(_transitions(seed=2)))
    np.testing.assert_array_equal(ra[SampleBatch.REWARDS], rb[SampleBatch.REWARDS])
    _states_close(b.get_state(), a.get_state(), tol=0.0)


def test_the_device_lane_refuses_an_exploration_that_postprocesses():
    from ray_tpu_torch.env.control_tensor import CartPoleTensor
    from ray_tpu_torch.execution.device_rollout import DeviceRolloutEngine

    pol = PPOTorchPolicy(Box(-1, 1, (4,), np.float32), Discrete(2),
                         {"exploration_config": {"type": "RND"}}, device="cpu")
    with pytest.raises(ValueError, match="postprocess_trajectory"):
        DeviceRolloutEngine(pol, CartPoleTensor(), 2, 4)


# the reference's own contracts (tests/test_exploration.py)


def _ppo_algo(**expl):
    config = (PPOConfig().environment("CartPole-v1")
              .rollouts(num_rollout_workers=0, rollout_fragment_length=32)
              .training(train_batch_size=64, sgd_minibatch_size=32)
              .resources(device="cpu"))
    if expl:
        config.exploration(exploration_config=expl)
    return config.build()


def test_curiosity_adds_intrinsic_reward_and_learns():
    algo = _ppo_algo(type="Curiosity", feature_dim=16, eta=0.1)
    pol = algo.get_policy()
    assert isinstance(pol.exploration, Curiosity)
    rng = np.random.default_rng(0)
    batch = SampleBatch({
        SampleBatch.OBS: rng.standard_normal((32, 4)).astype(np.float32),
        SampleBatch.NEXT_OBS: rng.standard_normal((32, 4)).astype(np.float32),
        SampleBatch.ACTIONS: rng.integers(0, 2, 32),
        SampleBatch.REWARDS: np.zeros(32, np.float32),
    })
    out = pol.exploration.postprocess_trajectory(pol, batch)
    r1 = out[SampleBatch.REWARDS].copy()
    assert (r1 > 0).any()
    for _ in range(60):  # repeated updates on the same transitions shrink the surprise
        batch[SampleBatch.REWARDS] = np.zeros(32, np.float32)
        out = pol.exploration.postprocess_trajectory(pol, batch)
    assert out[SampleBatch.REWARDS].mean() < r1.mean()
    algo.train()  # the sampler runs it on every fragment
    assert pol.exploration.get_state()["opt_state"]["count"] > 61
    algo.stop()


def test_rnd_intrinsic_reward_normalized_and_checkpointed():
    algo = _ppo_algo(type="RND", embed_dim=8)
    pol = algo.get_policy()
    rng = np.random.default_rng(0)
    batch = SampleBatch({SampleBatch.OBS: rng.standard_normal((64, 4)).astype(np.float32),
                         SampleBatch.REWARDS: np.zeros(64, np.float32)})
    out = pol.exploration.postprocess_trajectory(pol, batch)
    assert out[SampleBatch.REWARDS].std() > 0
    state = pol.get_state()
    assert "exploration_state" in state
    algo2 = _ppo_algo(type="RND", embed_dim=8)
    pol2 = algo2.get_policy()
    pol2.set_state(state)
    assert pol2.exploration.get_state()["target_params"] is not None
    algo.stop()
    algo2.stop()
