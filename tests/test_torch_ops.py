"""Parity of the port's ops with the JAX package's, on the CPU.

The JAX side runs its row-gather Pallas kernel in interpret mode (its
own CPU parity path) and its GAE kernel's arithmetic as a jnp scan; the
port's wrappers run their plain PyTorch versions, which is what they do
for CPU tensors. Contracts:

- row gather and ``build_stacks``: bitwise (pure data movement);
- ``compute_gae_fragment``: see its tests for the tolerances, against the
  reference kernel's sequential order, the XLA scan and the numpy golden
  ``compute_gae_np``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import framestack as jfs
from ray_tpu.ops import gae as jgae
from ray_tpu_torch.ops import framestack as tfs
from ray_tpu_torch.ops import gae as tgae


def _gae_inputs(n, t, seed, truncations=True):
    rng = np.random.default_rng(seed)
    rewards = rng.standard_normal((n, t)).astype(np.float32)
    values = rng.standard_normal((n, t)).astype(np.float32)
    next_values = rng.standard_normal((n, t)).astype(np.float32)
    term = rng.random((n, t)) < 0.1
    trunc = (rng.random((n, t)) < 0.1) if truncations else np.zeros((n, t), bool)
    return rewards, values, next_values, term, term | trunc


def _pallas_order_reference(rewards, values, next_values, term, dones, gamma, lam):
    """``ray_tpu.ops.gae.compute_gae_fragment(use_pallas=True)`` with the
    body of ``_gae_scan_kernel`` (run = d + c * run, walking T from the
    end) written as a jnp scan. The Pallas path itself no longer traces
    on this JAX (``pl.load``/``pl.store`` were removed; the reference's
    own ``test_gae_fragment_pallas_tolerance`` fails the same way)."""
    rewards = rewards.astype(jnp.float32)
    values = values.astype(jnp.float32)
    not_term = 1.0 - term.astype(jnp.float32)
    not_done = 1.0 - dones.astype(jnp.float32)
    deltas = rewards + gamma * next_values * not_term - values
    coeffs = gamma * lam * not_done

    def body(run, dc):
        run = dc[0] + dc[1] * run
        return run, run

    _, adv = jax.lax.scan(
        body, jnp.zeros(deltas.shape[0], jnp.float32),
        (deltas.T, coeffs.T), reverse=True,
    )
    return adv.T, adv.T + values


@pytest.mark.parametrize("n,t", [(16, 128), (1, 1), (3, 1), (5, 7), (9, 33)])
def test_gae_fragment_vs_reference_kernel_order(n, t):
    """Within 2 float32 ulp (rtol 2.4e-7) plus 1e-6 abs of the reference
    kernel's sequential order: XLA on the CPU fuses the multiply-adds,
    PyTorch's CPU ops round each operation. Within 1e-5 abs of the
    reference's default XLA associative scan (a reassociated sum; the
    reference documents < 1e-4 between its two paths)."""
    args = _gae_inputs(n, t, seed=100 * n + t)
    jargs = [jnp.asarray(a) for a in args]
    ref_adv, ref_vt = jax.jit(_pallas_order_reference, static_argnums=(5, 6))(
        *jargs, 0.99, 0.95
    )
    xla_adv, xla_vt = jgae.compute_gae_fragment(*jargs, 0.99, 0.95, use_pallas=False)
    adv, vt = tgae.compute_gae_fragment(*(torch.as_tensor(a) for a in args), 0.99, 0.95)
    assert adv.dtype == vt.dtype == torch.float32
    for got, seq, xla in ((adv, ref_adv, xla_adv), (vt, ref_vt, xla_vt)):
        np.testing.assert_allclose(got.numpy(), np.asarray(seq), rtol=2.4e-7, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), np.asarray(xla), rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gae_fragment_vs_numpy_golden(seed):
    """Without truncations, each row is one trajectory for
    ``compute_gae_np`` with ``next_values`` = values shifted by one and
    the last one the bootstrap."""
    n, t = 4, 25
    rewards, values, _, term, dones = _gae_inputs(n, t, seed, truncations=False)
    boot = np.random.default_rng(seed + 7).standard_normal(n).astype(np.float32)
    next_values = np.concatenate([values[:, 1:], boot[:, None]], axis=1)
    adv, vt = tgae.compute_gae_fragment(
        *(torch.as_tensor(a) for a in (rewards, values, next_values, term, dones)),
        0.99, 0.95,
    )
    for i in range(n):
        g_adv, g_vt = tgae.compute_gae_np(
            rewards[i], values[i], dones[i], boot[i], 0.99, 0.95
        )
        r_adv, r_vt = jgae.compute_gae_np(
            rewards[i], values[i], dones[i], boot[i], 0.99, 0.95
        )
        np.testing.assert_array_equal(g_adv, r_adv)
        np.testing.assert_allclose(adv[i].numpy(), g_adv, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(vt[i].numpy(), g_vt, rtol=1e-6, atol=1e-6)


def test_discount_cumsum_copy_matches_reference():
    x = np.random.default_rng(3).standard_normal(40).astype(np.float32)
    np.testing.assert_array_equal(
        tgae.discount_cumsum_np(x, 0.97), jgae.discount_cumsum_np(x, 0.97)
    )


def test_standardize_matches_reference():
    x = np.random.default_rng(4).standard_normal(300).astype(np.float32) * 3 + 1
    np.testing.assert_allclose(
        tgae.standardize(torch.as_tensor(x)).numpy(),
        np.asarray(jgae.standardize(jnp.asarray(x))),
        rtol=1e-5, atol=1e-6,
    )


def _pool(dtype, m, h, w, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, (m, h, w, 1), dtype=np.uint8)
    return rng.standard_normal((m, h, w, 1)).astype(dtype)


@pytest.mark.parametrize(
    "dtype,hw",
    [(np.uint8, (8, 8)), (np.uint8, (84, 84)), (np.uint8, (5, 5)), (np.float32, (6, 7))],
)
def test_build_stacks_bitwise_vs_pallas_interpret(dtype, hw):
    k, n, m = 4, 11, 20
    frames = _pool(dtype, m, *hw, seed=hw[0])
    idx = np.random.default_rng(1).integers(0, m - k + 1, n).astype(np.int32)
    ref = np.asarray(jfs.build_stacks(
        jnp.asarray(frames), jnp.asarray(idx), k, use_pallas=True, interpret=True,
    ))
    got = tfs.build_stacks(torch.as_tensor(frames), torch.as_tensor(idx), k).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape == (n, *hw, k)
    assert got.tobytes() == ref.tobytes()
    assert got.tobytes() == tfs.materialize_stacks_np(frames, idx, k).tobytes()


@pytest.mark.parametrize("idx_shape", [(7,), (3, 5)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.int32])
def test_gather_rows_bitwise_vs_pallas_interpret(idx_shape, dtype):
    rng = np.random.default_rng(5)
    src = (rng.standard_normal((13, 4, 6)) * 50).astype(dtype)
    idx = rng.integers(0, 13, idx_shape).astype(np.int32)
    ref = np.asarray(jfs.gather_rows(
        jnp.asarray(src), jnp.asarray(idx), use_pallas=True, interpret=True
    ))
    got = tfs.gather_rows(torch.as_tensor(src), torch.as_tensor(idx)).numpy()
    assert got.shape == ref.shape and got.tobytes() == ref.tobytes()


def test_gather_rows_cpu_raises_on_bad_index():
    src = torch.zeros((5, 3), dtype=torch.int32)
    with pytest.raises(IndexError):
        tfs.gather_rows(src, torch.tensor([0, 5]))


def test_frame_stream_columns_match_reference():
    frames = _pool(np.uint8, 10, 4, 4, seed=9)
    ref = jfs.frame_stream_columns(frames, 7, 4)
    got = tfs.frame_stream_columns(frames, 7, 4)
    assert set(got) == set(ref) == {tfs.FRAMES, tfs.FRAME_IDX}
    for key in ref:
        assert got[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(got[key], ref[key])
    with pytest.raises(ValueError):
        tfs.frame_stream_columns(frames, 8, 4)


def test_sample_batch_concat_and_slice_match_reference():
    from ray_tpu.data import sample_batch as jsb
    from ray_tpu_torch.data import sample_batch as tsb

    rng = np.random.default_rng(6)

    def cols(n):
        return {
            tsb.OBS_FRAMES: _pool(np.uint8, n + 3, 4, 4, seed=n),
            tsb.OBS_FRAME_IDX: np.arange(n, dtype=np.int32),
            tsb.ACTIONS: rng.integers(0, 3, n),
            tsb.REWARDS: rng.standard_normal(n).astype(np.float32),
        }

    parts = [cols(5), cols(3)]
    ref = jsb.concat_samples([jsb.SampleBatch(c) for c in parts])
    got = tsb.concat_samples([tsb.SampleBatch(c) for c in parts])
    assert set(got) == set(ref) and got.count == ref.count == 8
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    # tensor columns concatenate the same way
    tgot = tsb.concat_samples([
        tsb.SampleBatch({k: torch.as_tensor(v) for k, v in c.items()}) for c in parts
    ])
    for k in ref:
        np.testing.assert_array_equal(tgot[k].numpy(), ref[k])
    plain = {k: v for k, v in parts[0].items() if k not in (tsb.OBS_FRAMES, tsb.OBS_FRAME_IDX)}
    np.testing.assert_array_equal(
        tsb.SampleBatch(plain)[1:4][tsb.REWARDS], jsb.SampleBatch(plain)[1:4][jsb.REWARDS]
    )
    with pytest.raises(ValueError):
        got.slice(0, 2)
    with pytest.raises(ValueError):
        tsb.SampleBatch({tsb.ACTIONS: np.zeros(3), tsb.REWARDS: np.zeros(4)})
    for name in ("OBS", "NEXT_OBS", "ACTIONS", "TERMINATEDS", "TRUNCATEDS", "VF_PREDS",
                 "ADVANTAGES", "VALUE_TARGETS", "ACTION_LOGP", "ACTION_DIST_INPUTS"):
        assert getattr(tsb.SampleBatch, name) == getattr(jsb.SampleBatch, name)
    assert (tsb.OBS_FRAMES, tsb.OBS_FRAME_IDX) == (jfs.FRAMES, jfs.FRAME_IDX)


@pytest.mark.parametrize("spec", [None, 3e-4, [[0, 1e-3], [100, 1e-4], [300, 0.0]]])
def test_schedules_copy_matches_reference(spec):
    from ray_tpu.utils.schedules import make_schedule as jmake
    from ray_tpu_torch.utils.schedules import make_schedule as tmake

    for t in (0, 50, 100, 250, 1000):
        assert tmake(spec, 5e-5)(t) == jmake(spec, 5e-5)(t)
