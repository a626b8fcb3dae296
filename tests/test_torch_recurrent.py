"""Recurrent models and the recurrent act path of the port against the
reference's, on the CPU (the learn path and the algorithms:
``tests/test_torch_recurrent_algos.py``).

Sizes: the LSTM has cell 16 and hiddens [16]; GTrXL has dim 16, two
heads of 8, MLP 16 and memory 4 or 10. Inputs come from a numpy seed,
and the port takes the reference's weights through
``utils/jax_params.py``. Contracts:

- float32, 1e-5 relative (1e-6 absolute): each model's forward against
  the reference's, with and without ``resets``, with
  ``prev_actions``/``prev_rewards`` for the LSTM, and the states out;
  GTrXL's act step (T = 1 against S = M + 1 keys, the flash path: the
  plain version here) against the reference model's, and the port's
  ``flash_attention`` at GTrXL's act shapes against the reference's
  Pallas kernel in interpret mode; the unroll forward against
  per-episode forwards and the stored-state learn forward against the
  rollout mid-episode (1e-5 absolute, the reference test's).
- bitwise: the sampler's ``state_in_k`` columns and ``last_state_out``
  under a scripted recurrent policy that both packages' samplers drive
  (and the same rows when that policy reuses its output arrays), and the
  recurrent GAE bootstrap; ``compute_single_action`` with a state
  against a batch-1 ``compute_actions``, and the sequential serve
  fallback's answers against ``compute_actions`` from the initial state
  on a policy of the same seed; a reference policy's state and a
  worker's weights of either model through ``from_jax_policy_state`` and
  ``from_jax_policy_weights``.

And the catalog's recurrent defaults, and the paths the reference
refuses for a recurrent policy, refused with its reasons: the device
lane, DQN and SAC (R2D2 / RNNSAC), the multi-agent sampler (no recurrent state, as the reference's).
"""

from __future__ import annotations

import random

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

from ray_tpu.algorithms.ppo.ppo import PPOJaxPolicy
from ray_tpu.data.sample_batch import SampleBatch as RefSampleBatch
from ray_tpu.env import registry as ref_registry
from ray_tpu.env.vector_env import VectorEnv as RefVectorEnv
from ray_tpu.evaluation import postprocessing as ref_post
from ray_tpu.evaluation.sampler import SyncSampler as RefSyncSampler
from ray_tpu.models.attention import GTrXLNet as RefGTrXL
from ray_tpu.models.rnn import LSTMWrapper as RefLSTM
from ray_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from ray_tpu.sharding import get_mesh
from ray_tpu_torch.algorithms.dqn.dqn import DQNTorchPolicy
from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig, PPOTorchPolicy
from ray_tpu_torch.algorithms.sac.sac import SACTorchPolicy
from ray_tpu_torch.data.sample_batch import SampleBatch
from ray_tpu_torch.env import registry
from ray_tpu_torch.env.spaces import Box, Discrete
from ray_tpu_torch.env.vector_env import VectorEnv
from ray_tpu_torch.evaluation import postprocessing as post
from ray_tpu_torch.evaluation.multi_agent_sampler import MultiAgentSyncSampler
from ray_tpu_torch.evaluation.sampler import SyncSampler
from ray_tpu_torch.models.attention import GTrXLNet
from ray_tpu_torch.models.catalog import ModelCatalog
from ray_tpu_torch.models.rnn import LSTMWrapper
from ray_tpu_torch.ops.flash_attention import flash_attention
from ray_tpu_torch.serve.policy_server import BatchedPolicyServer
from ray_tpu_torch.utils.jax_params import (
    flax_to_state_dict,
    from_jax_params,
    from_jax_policy_state,
    from_jax_policy_weights,
)

OBS = 3
LSTM = {"use_lstm": True, "lstm_cell_size": 16, "max_seq_len": 5, "fcnet_hiddens": [16]}
GTRXL = {"use_attention": True, "max_seq_len": 5, "attention_dim": 16,
         "attention_num_transformer_units": 1, "attention_num_heads": 2,
         "attention_head_dim": 8, "attention_memory_training": 4,
         "attention_position_wise_mlp_dim": 16}


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, what, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _assert_same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


def _random_params(ref, seed, *args, **kwargs):
    """A parameter tree of the reference module's structure (from
    ``jax.eval_shape`` of its init, which compiles nothing), drawn from
    ``seed``: kernels N(0, 1/fan_in), every other leaf moved off its
    initial value (zero biases, unit scales, the gates' bias of 2), so
    that each mapped leaf matters."""
    shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(0), *args, **kwargs)
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        if len(x.shape) == 2:
            return (rng.standard_normal(x.shape) / np.sqrt(x.shape[0])).astype(np.float32)
        name = jax.tree_util.keystr(path)
        base = 1.0 if "scale" in name else 2.0 if "bz" in name else 0.0
        return (base + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _inputs(seed, B=3, T=6):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, OBS)).astype(np.float32),
            (rng.random((B, T)) < 0.3).astype(np.float32),
            rng.integers(0, 2, (B, T)).astype(np.int64),
            rng.standard_normal((B, T)).astype(np.float32), rng)


# -- the models ----------------------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "resets", "prev_inputs"])
def test_lstm_forward_matches_reference(case):
    obs, resets, pa, pr, rng = _inputs(0)
    prev = case == "prev_inputs"
    ref = RefLSTM(num_outputs=2, cell_size=16, hiddens=(16,), use_prev_action=prev,
                  use_prev_reward=prev)
    state = tuple(rng.standard_normal((3, 16)).astype(np.float32) for _ in range(2))
    kw = {"resets": resets} if case != "plain" else {}
    if prev:
        kw.update(prev_actions=pa, prev_rewards=pr)
    params = _random_params(ref, 1, obs, state, **kw)
    port = LSTMWrapper(OBS + 2 * prev, 2, 16, (16,), use_prev_action=prev, use_prev_reward=prev)
    from_jax_params(jax.device_get(params), port)
    want = ref.apply(params, obs, state, **kw)
    got = port(_t(obs), tuple(map(_t, state)), **{k: _t(v) for k, v in kw.items()})
    _close(got[0], want[0], "logits")
    _close(got[1], want[1], "value")
    for i, (g, w) in enumerate(zip(got[2], want[2])):
        _close(g, w, f"state {i}")  # (h, c), as the reference returns it


@pytest.mark.parametrize("memory", [4, 10])
@pytest.mark.parametrize("case", ["act_path", "resets"])
def test_gtrxl_forward_matches_reference(memory, case):
    obs, resets, _, _, rng = _inputs(1)
    ref = RefGTrXL(num_outputs=2, attention_dim=16, num_heads=2, head_dim=8, memory_len=memory,
                   position_wise_mlp_dim=16)
    state = (rng.standard_normal((3, memory, 16)).astype(np.float32),)
    kw = {"resets": resets} if case == "resets" else {}
    params = _random_params(ref, 2, obs, state)
    port = GTrXLNet(OBS, 2, 16, 1, 2, 8, memory, 16)
    from_jax_params(jax.device_get(params), port)
    want = ref.apply(params, obs, state, **kw)
    got = port(_t(obs), (_t(state[0]),), **{k: _t(v) for k, v in kw.items()})
    _close(got[0], want[0], "logits")
    _close(got[1], want[1], "value")
    _assert_same(got[2][0].detach().numpy(), np.asarray(want[2][0]), "memory out")


def test_gtrxl_act_step_matches_reference():
    """The act step at the catalog's widths (T = 1 query row against the
    M + 1 = 51 keys of a 50-step memory, 4 envs), and the attention op at
    the sampler's and the single action's shapes against the reference's
    Pallas kernel in interpret mode."""
    rng = np.random.default_rng(4)
    ref = RefGTrXL(num_outputs=2, attention_dim=64, num_heads=2, head_dim=32, memory_len=50,
                   position_wise_mlp_dim=32)
    obs = rng.standard_normal((4, 1, OBS)).astype(np.float32)
    state = (rng.standard_normal((4, 50, 64)).astype(np.float32),)
    params = _random_params(ref, 4, obs, state)
    port = GTrXLNet(OBS, 2)
    from_jax_params(jax.device_get(params), port)
    want = ref.apply(params, obs, state)
    got = port(_t(obs), (_t(state[0]),))
    _close(got[0], want[0], "logits")
    _close(got[1], want[1], "value")
    for batch in (4, 1):
        q = rng.standard_normal((batch, 2, 1, 32)).astype(np.float32)
        k, v = (rng.standard_normal((batch, 2, 51, 32)).astype(np.float32) for _ in range(2))
        _close(flash_attention(_t(q), _t(k), _t(v), causal_offset=50),
               jax_flash_attention(q, k, v, causal_offset=50, interpret=True), f"flash B={batch}")


def test_catalog_builds_recurrent_models_at_the_reference_defaults():
    space, act = Box(-1, 1, (OBS,), np.float32), Discrete(2)
    lstm = ModelCatalog.get_model(space, act, 2, {"use_lstm": True})
    assert isinstance(lstm, LSTMWrapper) and lstm.is_recurrent and lstm.supports_stored_train_state
    assert lstm.cell_size == 256 and lstm.fc_0.weight.shape == (256, OBS)
    assert lstm.fc_1.weight.shape == (256, 256) and lstm.logits.weight.shape == (2, 256)
    prev = ModelCatalog.get_model(space, Box(-1, 1, (2,), np.float32), 4, {
        "use_lstm": True, "lstm_use_prev_action": True, "lstm_use_prev_reward": True})
    assert prev.fc_0.weight.shape == (256, OBS + 2 + 1)
    att = ModelCatalog.get_model(space, act, 2, {"use_attention": True})
    assert isinstance(att, GTrXLNet) and not att.supports_stored_train_state
    assert (att.attention_dim, att.num_heads, att.head_dim, att.memory_len) == (64, 2, 32, 50)
    assert att.num_transformer_units == 1 and att.mlp0_0.weight.shape == (32, 64)
    assert float(att.gate_attn_0.bz.detach()[0]) == 2.0 and att.ln_q_0.eps == 1e-6
    assert [s.shape for s in att.initial_state(3)] == [(3, 50, 64)]
    with pytest.raises(ValueError, match="no custom model registered as 'x'"):
        ModelCatalog.get_model(space, act, 2, {"custom_model": "x"})


# -- policies --------------------------------------------------------------------


def _config(model, **cfg):
    return {"model": model, "train_batch_size": 20, "sgd_minibatch_size": 10, "num_sgd_iter": 2,
            "seed": 0, "lr": 1e-3, "entropy_coeff": 0.01, "grad_clip": 40.0, **cfg}


def _port(model, **cfg):
    return PPOTorchPolicy(Box(-1.0, 1.0, (OBS,), np.float32), Discrete(2), _config(model, **cfg),
                          device="cpu")


def _ppo_pair(model, **cfg):
    ref = PPOJaxPolicy(gym.spaces.Box(-1.0, 1.0, (OBS,), np.float32), gym.spaces.Discrete(2),
                       {**_config(model, **cfg), "_mesh": get_mesh(devices=jax.devices()[:1])})
    port = _port(model, **cfg)
    from_jax_params(jax.device_get(ref.params), port.model)
    return port, ref


_PAIRS = {}


def _shared_pair(model: str):
    """One (port, reference) pair a model for the tests that change
    neither policy's weights (the reference's construction compiles)."""
    if model not in _PAIRS:
        _PAIRS[model] = _ppo_pair(LSTM if model == "lstm" else GTRXL)
    return _PAIRS[model]


def _rows(n, eps, ts, seed=0, states=None):
    rng = np.random.default_rng(seed)
    cols = {
        "obs": rng.standard_normal((n, OBS)).astype(np.float32),
        "actions": rng.integers(0, 2, n).astype(np.int64),
        "action_logp": np.full(n, -0.69, np.float32),
        "action_dist_inputs": rng.standard_normal((n, 2)).astype(np.float32),
        "advantages": rng.standard_normal(n).astype(np.float32),
        "value_targets": rng.standard_normal(n).astype(np.float32),
        "eps_id": np.asarray(eps, np.int64),
        "t": np.asarray(ts, np.int64),
    }
    for k, width in enumerate(states or ()):
        cols[f"state_in_{k}"] = rng.standard_normal((n, width)).astype(np.float32)
    return cols


# -- the act surface -----------------------------------------------------------------


@pytest.mark.parametrize("model", ["lstm", "gtrxl"])
def test_compute_single_action_with_state(model):
    port, ref = _shared_pair(model)
    obs = np.random.default_rng(3).standard_normal(OBS).astype(np.float32)
    state = [s + 0.5 for s in port.get_initial_state()]
    port.action_generator.manual_seed(11)
    action, state_out, extra = port.compute_single_action(obs, state, explore=True)
    port.action_generator.manual_seed(11)
    actions, states, extras = port.compute_actions(obs[None], [s[None] for s in state])
    assert action == actions[0]
    for a, b in zip(state_out, states):
        _assert_same(a, b[0], "state out")
    for k in extras:
        _assert_same(extra[k], extras[k][0], k)
    # the same step as the reference's, from the same state and weights
    _, ref_states, ref_extra = ref.compute_actions(obs[None], [s[None] for s in state],
                                                   explore=False)
    for a, b in zip(state_out, ref_states):
        _close(a, b[0], "state out vs reference")
    _close(extra["action_dist_inputs"], ref_extra["action_dist_inputs"][0], "dist inputs")
    _close(port.value_batch(obs[None], [s[None] for s in state]),
           ref.value_batch(obs[None], [s[None] for s in state]), "value")


@pytest.mark.parametrize("model", ["lstm", "gtrxl"])
def test_reference_policy_state_and_weights_load(model):
    """A reference policy's state and a worker's weights of either model
    load through ``from_jax_policy_state`` / ``from_jax_policy_weights``,
    every leaf bitwise (the LSTM cell's and GTrXL's gates' nested trees,
    the layer norms, the gates' bias)."""
    _, ref = _shared_pair(model)
    want = flax_to_state_dict(jax.device_get(ref.params))
    a, b = _port(LSTM if model == "lstm" else GTRXL, seed=5), _port(
        LSTM if model == "lstm" else GTRXL, seed=6)
    from_jax_policy_state(a, jax.device_get(ref.get_state()))
    from_jax_policy_weights({"default_policy": jax.device_get(ref.params)}, {"default_policy": b})
    assert set(want) == set(a.param_names)
    for port in (a, b):
        got = port.get_weights()
        for name, w in want.items():
            _assert_same(got[name], w, name)
    assert a.opt_state.count == 0


# -- the sampler and GAE's bootstrap ----------------------------------------------------


class ScriptedRecurrent:
    """A recurrent policy both packages' samplers drive: actions from a
    seeded stream, a numpy state update, and the fragments'
    ``last_state_out`` recorded at postprocessing. ``reuse_buffers``
    writes each step's state out into the arrays it returned the step
    before, as a policy with static output buffers would."""

    is_recurrent = True

    def __init__(self, reuse_buffers=False):
        self.config = {"gamma": 0.99, "lambda": 0.95}
        self._rng = np.random.default_rng(5)
        self._reuse = reuse_buffers
        self._out = None
        self.last_states = []

    def get_initial_state(self):
        return [np.zeros(3, np.float32), np.ones((2, 2), np.float32)]

    def compute_actions(self, obs, state_batches=None, explore=True, **kwargs):
        h, c = state_batches
        obs = np.asarray(obs, np.float32)
        n = len(obs)
        out = [(np.float32(0.5) * h + obs[:, :3]).astype(np.float32),
               (c * np.float32(1.5)).astype(np.float32)]
        if self._reuse:
            if self._out is None:
                self._out = [np.empty_like(x) for x in out]
            for buf, x in zip(self._out, out):
                buf[...] = x
            out = self._out
        return self._rng.integers(0, 2, n), out, {"action_logp": np.full(n, -0.6931, np.float32)}

    def postprocess_trajectory(self, batch, other_agent_batches=None, episode=None):
        self.last_states.append([s.copy() for s in batch.last_state_out])
        return batch


def _recurrent_samples(package, reuse_buffers=False):
    if package == "port":
        make, vec, sampler_cls = registry.get_env_creator("CartPole-v1"), VectorEnv, SyncSampler
    else:
        make, vec, sampler_cls = ref_registry.get_env_creator("CartPole-v1"), RefVectorEnv, RefSyncSampler
    random.seed(0)  # episode ids
    policy = ScriptedRecurrent(reuse_buffers)
    envs = vec.vectorize_gym_envs(lambda i: make({}), 2, seed=4)
    sampler = sampler_cls(vector_env=envs, policy=policy, rollout_fragment_length=40)
    return [sampler.sample() for _ in range(2)], policy.last_states


def test_sampler_state_columns_match_reference():
    port, port_last = _recurrent_samples("port")
    ref, ref_last = _recurrent_samples("reference")
    for p, r in zip(port, ref):
        assert set(p) == set(r) and {"state_in_0", "state_in_1"} <= set(p)
        for k in r:
            _assert_same(p[k], r[k], k)
    assert len(port_last) == len(ref_last) > 4  # episode ends and cut fragments
    for a, b in zip(port_last, ref_last):
        for x, y in zip(a, b):
            _assert_same(x, y, "last_state_out")
    # an episode starts from the initial state
    starts = port[0]["t"] == 0
    assert starts.any() and (port[0]["state_in_1"][starts] == 1.0).all()
    # the slots' states are copies: a policy that reuses its output
    # arrays gives the same rows
    reused, reused_last = _recurrent_samples("port", reuse_buffers=True)
    for p, q in zip(port, reused):
        for k in p:
            _assert_same(q[k], p[k], k)
    for a, b in zip(reused_last, port_last):
        for x, y in zip(a, b):
            _assert_same(x, y, "last_state_out")


class _StateValue:
    """A recurrent bootstrap: the value is the sum of the state it gets."""

    is_recurrent = True

    def __init__(self):
        self.config = {"gamma": 0.99, "lambda": 0.95}

    def get_initial_state(self):
        return [np.full(2, 0.25, np.float32)]

    def value_batch(self, obs, state=None):
        return np.array([state[0].sum()], np.float32)


@pytest.mark.parametrize("source", ["last_state_out", "state_out_column", "initial"])
def test_recurrent_gae_bootstrap_matches_reference(source):
    rng = np.random.default_rng(1)
    cols = {SampleBatch.OBS: rng.standard_normal((6, OBS)).astype(np.float32),
            SampleBatch.NEXT_OBS: rng.standard_normal((6, OBS)).astype(np.float32),
            SampleBatch.REWARDS: rng.standard_normal(6).astype(np.float32),
            SampleBatch.VF_PREDS: rng.standard_normal(6).astype(np.float32),
            SampleBatch.TERMINATEDS: np.zeros(6, bool),
            SampleBatch.TRUNCATEDS: np.zeros(6, bool)}
    if source == "state_out_column":
        cols["state_out_0"] = rng.standard_normal((6, 2)).astype(np.float32)
    p, r = SampleBatch(dict(cols)), RefSampleBatch(dict(cols))
    if source == "last_state_out":
        p.last_state_out = r.last_state_out = [np.array([1.0, 2.0], np.float32)]
    p = post.compute_gae_for_sample_batch(_StateValue(), p)
    r = ref_post.compute_gae_for_sample_batch(_StateValue(), r)
    for k in ("advantages", "value_targets"):
        _assert_same(p[k], r[k], k)


# -- serving and the refusals -----------------------------------------------------------


def test_recurrent_policy_served_one_request_at_a_time():
    served, twin = _port(GTRXL), _port(GTRXL)
    server = BatchedPolicyServer(served, explore=True, start=False)
    assert not server.fused and server.warmup() == 0
    rows = np.random.default_rng(2).standard_normal((6, OBS)).astype(np.float32)
    server.start()
    try:
        answers = [f.result() for f in server.submit_many(list(rows))]
    finally:
        server.stop()
    init = [s[None] for s in twin.get_initial_state()]
    for row, (action, extra) in zip(rows, answers):
        want, _, want_extra = twin.compute_actions(row[None], init, explore=True)
        _assert_same(action, want[0], "action")
        for k, v in want_extra.items():
            _assert_same(extra[k], v[0], k)
    st = server.stats()
    assert st["fused"] is False and st["captures"] == 0 and st["batch_fill_fraction"] == 1.0


@pytest.mark.parametrize("path", ["device_lane", "dqn", "sac", "multi_agent"])
def test_paths_the_reference_refuses_still_raise(path):
    box = Box(-1.0, 1.0, (OBS,), np.float32)
    if path == "device_lane":
        algo = (PPOConfig().environment("CartPoleJax-v0", env_backend="jax")
                .rollouts(num_rollout_workers=0, num_envs_per_worker=2, rollout_fragment_length=8)
                .training(train_batch_size=16, model=LSTM).resources(device="cpu").build())
        try:
            with pytest.raises(ValueError, match="device rollout lane is unavailable.*recurrent"):
                algo.train()
        finally:
            algo.stop()
    elif path == "dqn":
        for key in ("use_lstm", "use_attention"):
            with pytest.raises(ValueError, match="R2D2"):
                DQNTorchPolicy(box, Discrete(2), {"model": {key: True}}, device="cpu")
    elif path == "sac":
        for key in ("model", "policy_model_config", "q_model_config"):
            with pytest.raises(ValueError, match="RNNSAC.*R2D2"):
                SACTorchPolicy(box, Box(-1.0, 1.0, (1,), np.float32), {key: {"use_lstm": True}},
                               device="cpu")
    else:
        with pytest.raises(NotImplementedError, match="carries no recurrent state"):
            MultiAgentSyncSampler(env=None, policy_map={"p": _port(LSTM)},
                                  policy_mapping_fn=lambda aid: "p", preprocessors={},
                                  obs_filters={})
