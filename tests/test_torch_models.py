"""Models and distributions of the port against flax, on the CPU.

The flax model is initialised by the reference; ``from_jax_params``
carries its weights into the port's module; both see the same
observations. Tolerances:

- float32 models: 1e-5 relative, 1e-6 absolute (the same float32 ops,
  summed in other orders by XLA's and PyTorch's CPU convolutions);
- bfloat16 models: 2e-2 absolute on outputs of order 0.1-1 (a few bf16
  ulps: each framework rounds to bf16 after other operations);
- Categorical logp / entropy / kl: 1e-6.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import distributions as jdists
from ray_tpu.models.cnn import NATURE_FILTERS, VisionNet as JVisionNet
from ray_tpu.models.fcnet import FCNet as JFCNet
from ray_tpu_torch.env.spaces import Box, Discrete
from ray_tpu_torch.models import distributions as tdists
from ray_tpu_torch.models.catalog import ModelCatalog
from ray_tpu_torch.models.cnn import VisionNet
from ray_tpu_torch.models.fcnet import FCNet
from ray_tpu_torch.utils.jax_params import flax_to_state_dict, from_jax_params

SMALL_FILTERS = ((8, (8, 8), (4, 4)), (16, (4, 4), (2, 2)))


def _obs(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _pair(jmodel, tmodel, obs):
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(obs)))
    from_jax_params(params, tmodel)
    ref = jmodel.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        got = tmodel(torch.as_tensor(obs))
    return [np.asarray(x) for x in ref[:2]], [x.numpy() for x in got[:2]]


@pytest.mark.parametrize("vf_share", [True, False])
def test_visionnet_f32_matches_flax(vf_share):
    obs = _obs((5, 84, 84, 4))
    ref, got = _pair(
        JVisionNet(num_outputs=6, vf_share_layers=vf_share, dtype_="float32"),
        VisionNet((84, 84, 4), 6, vf_share_layers=vf_share, dtype="float32"),
        obs,
    )
    for r, g in zip(ref, got):
        assert g.dtype == np.float32 and g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6)


def test_visionnet_bf16_matches_flax():
    obs = _obs((5, 84, 84, 4), seed=1)
    ref, got = _pair(
        JVisionNet(num_outputs=6),
        VisionNet((84, 84, 4), 6),
        obs,
    )
    for r, g in zip(ref, got):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, r, rtol=0, atol=2e-2)


def test_visionnet_custom_filters_f32():
    obs = _obs((3, 42, 42, 1), seed=2)
    ref, got = _pair(
        JVisionNet(num_outputs=3, conv_filters=SMALL_FILTERS,
                   post_fcnet_hiddens=(32,), dtype_="float32"),
        VisionNet((42, 42, 1), 3, conv_filters=SMALL_FILTERS,
                  post_fcnet_hiddens=(32,), dtype="float32"),
        obs,
    )
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("vf_share", [True, False])
@pytest.mark.parametrize("activation", ["tanh", "relu"])
def test_fcnet_matches_flax(vf_share, activation):
    obs = np.random.default_rng(3).standard_normal((7, 4, 3)).astype(np.float32)
    ref, got = _pair(
        JFCNet(num_outputs=4, hiddens=(32, 16), activation=activation,
               vf_share_layers=vf_share),
        FCNet(12, 4, hiddens=(32, 16), activation=activation,
              vf_share_layers=vf_share),
        obs,
    )
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6)


def test_from_jax_params_layouts_and_mismatch():
    jm = JVisionNet(num_outputs=6, dtype_="float32")
    params = jax.device_get(jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 84, 84, 4), jnp.uint8)))
    sd = flax_to_state_dict(params)
    assert sd["conv_0.weight"].shape == (32, 4, 8, 8)  # HWIO → OIHW
    assert sd["post_fc_0.weight"].shape == (512, 7 * 7 * 64)  # (in, out) → (out, in)
    tm = VisionNet((84, 84, 4), 6, dtype="float32")
    from_jax_params(params, tm)
    np.testing.assert_array_equal(
        tm.conv_0.weight.detach().numpy(),
        np.transpose(params["params"]["conv_0"]["kernel"], (3, 2, 0, 1)),
    )
    with pytest.raises(ValueError, match="disagree"):
        from_jax_params(params, FCNet(4, 6))


def test_catalog_models_and_dists():
    gen = torch.Generator().manual_seed(0)
    image = ModelCatalog.get_model(Box(0, 255, (84, 84, 4), np.uint8), Discrete(6), 6, {}, gen)
    assert isinstance(image, VisionNet) and image.dtype == torch.bfloat16
    assert image.vf_share_layers
    f32 = ModelCatalog.get_model(
        Box(0, 255, (84, 84, 4), np.uint8), Discrete(6), 6, {"dtype": "float32"}, gen
    )
    assert f32.dtype == torch.float32
    flat = ModelCatalog.get_model(Box(-1, 1, (5,)), Discrete(2), 2, {"fcnet_hiddens": [8]}, gen)
    assert isinstance(flat, FCNet) and flat.fc_0.weight.shape == (8, 5)
    assert ModelCatalog.get_action_dist(Discrete(6)) == (tdists.Categorical, 6)
    assert ModelCatalog.get_action_dist(Box(-1, 1, (2,))) == (tdists.DiagGaussian, 4)

    class MultiDiscrete:  # neither Discrete nor Box
        shape, nvec = (2,), (3, 4)

    with pytest.raises(NotImplementedError, match="item 9"):
        ModelCatalog.get_action_dist(MultiDiscrete())
    with pytest.raises(NotImplementedError):
        ModelCatalog.get_model(Box(-1, 1, (5,)), Discrete(2), 2, {"use_lstm": True})


def test_catalog_init_is_seeded():
    space, act = Box(-1, 1, (5,)), Discrete(3)
    a = ModelCatalog.get_model(space, act, 3, {}, torch.Generator().manual_seed(4))
    b = ModelCatalog.get_model(space, act, 3, {}, torch.Generator().manual_seed(4))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)
    # flax's LeCun-normal spread: std sqrt(1/fan_in), truncated at 2 std
    w = ModelCatalog.get_model(
        Box(-1, 1, (400,)), act, 3, {"fcnet_hiddens": [300]},
        torch.Generator().manual_seed(0),
    ).fc_0.weight.detach().numpy()
    assert abs(w.std() - np.sqrt(1 / 400)) < 0.1 * np.sqrt(1 / 400)
    assert np.abs(w).max() <= 2 * np.sqrt(1 / 400) / 0.87962566103423978 + 1e-6


def test_categorical_matches_reference():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((9, 6)).astype(np.float32) * 3
    other = rng.standard_normal((9, 6)).astype(np.float32)
    actions = rng.integers(0, 6, 9)
    jd, jo = jdists.Categorical(jnp.asarray(logits)), jdists.Categorical(jnp.asarray(other))
    td, to = tdists.Categorical(torch.as_tensor(logits)), tdists.Categorical(torch.as_tensor(other))
    np.testing.assert_allclose(
        td.logp(torch.as_tensor(actions)).numpy(),
        np.asarray(jd.logp(jnp.asarray(actions))), rtol=1e-6, atol=1e-6,
    )
    np.testing.assert_allclose(td.entropy().numpy(), np.asarray(jd.entropy()), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(td.kl(to).numpy(), np.asarray(jd.kl(jo)), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        td.deterministic_sample().numpy(), np.asarray(jd.deterministic_sample())
    )


def test_categorical_sampling_from_generator():
    logits = torch.tensor([[0.0, 2.0, -1.0]] * 4000)
    a = tdists.Categorical(logits).sample(torch.Generator().manual_seed(7))
    b = tdists.Categorical(logits).sample(torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
    freq = torch.bincount(a, minlength=3).float() / len(a)
    expect = torch.softmax(logits[0], -1)
    assert torch.allclose(freq, expect, atol=0.03)
