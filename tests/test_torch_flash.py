"""The port's attention against the JAX package's, on the CPU.

Same numpy inputs through ``ray_tpu.ops.flash_attention.flash_attention``
(the Pallas kernel in interpret mode, and the XLA reference with
``use_pallas=False``) and through the port's ``flash_attention``, whose
CPU forward is its plain version ``reference_attention``. The shapes and
offsets are the reference test's (``tests/test_flash_attention.py``).

Tolerances: float32 within 2e-5 abs/rel (the Pallas kernel scales q
before the product and sums over key blocks; the plain versions scale
the scores after), rows that see no key exactly 0, bfloat16 within 3e-2
(the two frameworks round to bf16 at other places); gradients through
the port's ``autograd.Function`` against ``jax.grad`` within 1e-4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from ray_tpu_torch.ops.flash_attention import flash_attention, reference_attention

CASES = [
    (24, 40, None, 16),  # full attention, uneven shapes
    (24, 40, 16, 16),  # GTrXL's band
    (32, 32, 0, 16),  # causal self-attention
    (130, 200, 7, 16),  # past the reference's 128 block
    (8, 8, -3, 16),  # queries 0..2 see no key
    (8, 8, 0, 32),  # the decoder torso's heads
]


def _qkv(seed, B=2, H=2, T=24, S=40, D=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, H, T, D), (B, H, S, D), (B, H, S, D))]


def _torch(x, layout):
    """A numpy (B, H, n, D) array as a torch tensor: contiguous, or a
    (B, H, n, D) view over (B, n, H, D) memory, as the torso's
    projections come."""
    if layout == "contiguous":
        return torch.as_tensor(x)
    return torch.as_tensor(np.ascontiguousarray(x.transpose(0, 2, 1, 3))).transpose(1, 2)


@pytest.mark.parametrize("layout", ["contiguous", "bthd"])
@pytest.mark.parametrize("path", ["interpret", "xla"])
@pytest.mark.parametrize("t,s,offset,d", CASES)
def test_forward_matches_reference(t, s, offset, d, path, layout):
    q, k, v = _qkv(t + s, T=t, S=s, D=d)
    kw = {"interpret": True} if path == "interpret" else {"use_pallas": False}
    ref = np.asarray(jax_flash_attention(*map(jnp.asarray, (q, k, v)), causal_offset=offset, **kw))
    tq, tk, tv = (_torch(x, layout) for x in (q, k, v))
    assert tq.is_contiguous() == (layout == "contiguous")
    got = flash_attention(tq, tk, tv, causal_offset=offset)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=2e-5)
    if offset is not None and offset < 0:
        assert not got[:, :, :-offset].any()
        assert got[:, :, -offset:].abs().max() > 0


def test_bf16_matches_reference():
    q, k, v = _qkv(3, T=16, S=16)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ref = jax_flash_attention(jq, jk, jv, interpret=True)
    tq, tk, tv = (torch.as_tensor(x).bfloat16() for x in (q, k, v))
    got = flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), atol=3e-2, rtol=3e-2)


def test_gradients_match_jax_grad():
    q, k, v = _qkv(2, T=16, S=16, D=8)

    def loss(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, causal_offset=0, interpret=True) ** 2)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    (flash_attention(tq, tk, tv, causal_offset=0) ** 2).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_reference_attention_is_the_plain_version():
    """The port's CPU forward is reference_attention on (B·H, T, D)
    views, and the CPU path launches nothing."""
    q, k, v = (torch.as_tensor(x) for x in _qkv(4, T=8, S=12))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal_offset=2)
    assert flash_attention.launches == before
    want = reference_attention(q.reshape(4, 8, 16), k.reshape(4, 12, 16), v.reshape(4, 12, 16), 2)
    assert torch.equal(got, want.reshape(2, 2, 8, 16))
