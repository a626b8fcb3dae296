"""The port's replay plane against the JAX package's, on the CPU.

Same numpy inputs through both packages. Contracts, all bitwise:

- ``scatter_rows_plain`` against the reference's ``scatter_rows`` in
  Pallas interpret mode and against ``ring.at[pos].set`` (last write
  wins on a repeated position);
- ``find_prefixsum_plain``, ``reduce_range_body`` and ``draw_body``
  against the reference's f64 bodies with x64 on (the reference's own
  ``DeviceSumTree`` and Pallas descent do not run on JAX 0.9) and against the host ``SumSegmentTree``/``MinSegmentTree``:
  indices, sampled priorities and IS weights bitwise (the weights'
  f64 ``pow`` runs in PyTorch and in numpy; the float32 cast has agreed
  bitwise on every draw here);
- ``DeviceSumTree.set_powered`` with repeated indices in one write:
  leaves and every internal node bitwise against the host trees;
- the port's device buffers (``device="cpu"``, so the kernels' plain
  versions run) against the reference's ``DeviceReplayBuffer`` and
  ``DevicePrioritizedReplayBuffer(device_tree=False)`` (its host sum
  tree, the oracle's code; the port's priorities are on the device):
  sampled rows, indices and weights, the max priority and the
  generator state, and checkpoints moved from one package to the other.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.data.sample_batch import SampleBatch as JSampleBatch
from ray_tpu.execution import replay_buffer as jrb
from ray_tpu.ops import framestack as jfs
from ray_tpu.ops import segment_tree as jst
from ray_tpu_torch.data.sample_batch import SampleBatch
from ray_tpu_torch.execution import replay_buffer as trb
from ray_tpu_torch.ops import framestack as tfs
from ray_tpu_torch.ops import segment_tree as tst


def _x64():
    """The x64 context manager: ``jax.enable_x64`` where this JAX has it
    at top level, else the older ``jax.experimental.enable_x64``."""
    enable = getattr(jax, "enable_x64", None)
    if enable is None:
        from jax.experimental import enable_x64 as enable
    return enable(True)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- row scatter ---------------------------------------------------------------

_SCATTER_CASES = {
    # name: (ring rows, dtype) -- uint8 pixels ride as 4-byte words
    "packed_uint8": ((16, 16, 1), np.uint8),
    "bool": ((), np.bool_),
    "int32": ((), np.int32),
    "f32_rows": ((3,), np.float32),
    "odd_uint8": ((5,), np.uint8),
}


def _rows(rng, n, shape, dtype):
    if dtype == np.bool_:
        return rng.random((n,) + shape) < 0.5
    if dtype == np.float32:
        return rng.standard_normal((n,) + shape).astype(np.float32)
    if dtype == np.int32:
        return rng.integers(-2**31, 2**31 - 1, (n,) + shape, dtype=np.int32)
    return rng.integers(0, 256, (n,) + shape, dtype=np.uint8)


def _as_stored(x, dtype):
    """Packed uint8 rows as the rings store them: 4-byte words."""
    if dtype == np.uint8 and x.shape[1:] and np.prod(x.shape[1:]) % 4 == 0:
        return np.ascontiguousarray(x).reshape(x.shape[0], -1).view(np.int32)
    return x


@pytest.mark.parametrize("positions", ["wrapping", "duplicates"])
@pytest.mark.parametrize("case", sorted(_SCATTER_CASES))
def test_scatter_rows_plain_bitwise_vs_reference(case, positions):
    shape, dtype = _SCATTER_CASES[case]
    rng = np.random.default_rng(len(case))
    m, r = 12, 7
    ring = _as_stored(_rows(rng, m, shape, dtype), dtype)
    vals = _as_stored(_rows(rng, r, shape, dtype), dtype)
    if positions == "wrapping":
        pos = (9 + np.arange(r)) % m
    else:
        pos = np.array([3, 11, 3, 0, 11, 11, 5])
    pos = pos.astype(np.int32)
    ref_pallas = np.asarray(jfs.scatter_rows(
        jnp.asarray(ring), jnp.asarray(pos), jnp.asarray(vals),
        use_pallas=True, interpret=True,
    ))
    ref_xla = np.asarray(jnp.asarray(ring).at[pos].set(jnp.asarray(vals)))
    t_ring = torch.as_tensor(ring.copy())
    out = tfs.scatter_rows(t_ring, torch.as_tensor(pos), torch.as_tensor(vals))
    assert out is t_ring  # in place
    got = t_ring.numpy()
    assert got.dtype == ref_pallas.dtype and got.tobytes() == ref_pallas.tobytes()
    assert got.tobytes() == ref_xla.tobytes()
    # numpy's fancy assignment (the host rings' insert) agrees too
    host = ring.copy()
    host[pos] = vals
    assert got.tobytes() == host.tobytes()


def test_scatter_rows_checks():
    ring = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(IndexError):
        tfs.scatter_rows(ring, torch.tensor([0, 4]), torch.ones((2, 2), dtype=torch.int32))
    with pytest.raises(TypeError):
        tfs.scatter_rows(ring, torch.tensor([0]), torch.ones((1, 2)))
    with pytest.raises(ValueError):
        tfs.scatter_rows(ring, torch.tensor([0, 1]), torch.ones((1, 2), dtype=torch.int32))
    meta = torch.empty((4, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfs.scatter_rows(meta, torch.zeros(1, dtype=torch.int64, device="meta"),
                         torch.empty((1, 2), device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        tst.find_prefixsum(torch.empty(4, dtype=torch.float64, device="meta"),
                           torch.empty(3, dtype=torch.float64, device="meta"), 2)
    # an empty scatter leaves the ring alone
    before = ring.clone()
    tfs.scatter_rows(ring, torch.zeros(0, dtype=torch.int64), torch.zeros((0, 2), dtype=torch.int32))
    assert torch.equal(ring, before)


# -- segment trees and the f64 draw ------------------------------------------


def _trees(cap, size, seed, alpha=0.6):
    """Host trees with ``size`` powered random leaves, zeros after."""
    rng = np.random.default_rng(seed)
    pri = rng.random(size) * 3
    pri[rng.random(size) < 0.2] = 0.0  # zero-priority leaves inside the range
    powered, _ = trb.powered_priorities(pri, alpha)
    powered[pri == 0.0] = 0.0
    hs, hm = tst.SumSegmentTree(cap), tst.MinSegmentTree(cap)
    if size:
        hs.set_items(np.arange(size), powered)
        hm.set_items(np.arange(size), powered)
    return hs, hm


def _masses(hs, size, rng):
    total = hs.sum(0, size)
    bounds = np.cumsum(hs.value[hs.capacity: hs.capacity + size])  # node boundaries
    return np.concatenate([
        rng.random(9) * total, bounds, [0.0, total, total * 1.5, np.nextafter(total, np.inf)],
    ])


@pytest.mark.parametrize("cap,size", [(1, 1), (2, 1), (2, 2), (8, 5), (64, 64), (1024, 700)])
def test_prefix_descent_and_reduce_bitwise(cap, size):
    hs, hm = _trees(cap, size, seed=cap + size)
    mass = _masses(hs, size, np.random.default_rng(cap))
    want = hs.find_prefixsum_idx(mass)
    got = tst.find_prefixsum(torch.as_tensor(hs.value), torch.as_tensor(mass), cap)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tst.find_prefixsum_plain(torch.as_tensor(hs.value), torch.as_tensor(mass), cap).numpy(), want
    )
    with _x64():
        ref = np.asarray(jst.find_prefixsum_body(jnp.asarray(hs.value), jnp.asarray(mass), cap))
        np.testing.assert_array_equal(got.numpy(), ref)
        for s in sorted({0, 1, size // 2, size - 1, size}):
            for tree, op, top, neutral in (
                (hs, torch.add, jnp.add, 0.0),
                (hm, torch.minimum, jnp.minimum, float("inf")),
            ):
                g = tst.reduce_range_body(torch.as_tensor(tree.value), s, op, neutral, cap)
                r = jst.reduce_range_body(jnp.asarray(tree.value), s, top, neutral, cap)
                assert g.dtype == torch.float64
                assert np.float64(g.item()).tobytes() == np.float64(r).tobytes()
                assert g.item() == tree.reduce(0, s)
    # the host tree copy is the reference's
    rs, rm = jst.SumSegmentTree(cap), jst.MinSegmentTree(cap)
    rs.set_items(np.arange(size), hs.value[cap: cap + size])
    rm.set_items(np.arange(size), hm.value[cap: cap + size])
    assert rs.value.tobytes() == hs.value.tobytes() and rm.value.tobytes() == hm.value.tobytes()


@pytest.mark.parametrize("cap,size,n,beta", [(16, 11, 8, 0.4), (64, 64, 32, 0.4), (1024, 777, 32, 1.0)])
def test_draw_body_bitwise_vs_reference_and_host(cap, size, n, beta):
    hs, hm = _trees(cap, size, seed=size)
    hs.set_items(np.array([0]), np.array([0.7]))  # no zero leaf at the p_min end
    hm.set_items(np.array([0]), np.array([0.7]))
    nonzero = hs.value[cap: cap + size] > 0
    hm.set_items(np.arange(size)[~nonzero], np.full((~nonzero).sum(), 0.05))
    hs.set_items(np.arange(size)[~nonzero], np.full((~nonzero).sum(), 0.05))
    rand = np.random.default_rng(n).random(n)
    idx, w, p = tst.draw_body(
        torch.as_tensor(hs.value), torch.as_tensor(hm.value), torch.as_tensor(rand), size, beta, cap
    )
    with _x64():
        ridx, rw, rp = jst.draw_body(
            jnp.asarray(hs.value), jnp.asarray(hm.value), jnp.asarray(rand),
            size, beta, cap, use_pallas=False,
        )
        ridx, rw, rp = np.asarray(ridx), np.asarray(rw), np.asarray(rp)
    np.testing.assert_array_equal(idx.numpy(), ridx)
    assert p.numpy().tobytes() == rp.tobytes()
    assert w.dtype == torch.float32 and w.numpy().tobytes() == rw.tobytes()
    # the host oracle's arithmetic (_PrioritySampling._draw_prioritized)
    total = hs.sum(0, size)
    mass = (rand + np.arange(n)) / n * total
    hidx = np.clip(hs.find_prefixsum_idx(mass), 0, size - 1)
    max_w = (hm.min(0, size) / total * size) ** (-beta)
    hw = ((hs[hidx] / total * size) ** (-beta) / max_w).astype(np.float32)
    np.testing.assert_array_equal(idx.numpy(), hidx)
    assert w.numpy().tobytes() == hw.tobytes()


def test_device_sum_tree_duplicate_writes_bitwise():
    """A write that names one leaf several times keeps its last value,
    as numpy's fancy assignment in the host trees does; leaves and every
    internal node agree bitwise, over a stream with ring wraparound."""
    cap = 32
    rng = np.random.default_rng(0)
    hs, hm = tst.SumSegmentTree(cap), tst.MinSegmentTree(cap)
    dt = tst.DeviceSumTree(cap, "cpu")
    size, ptr = 0, 0
    for step in range(40):
        n = int(rng.integers(1, 9))
        pos = (ptr + np.arange(n)) % cap
        ptr, size = (ptr + n) % cap, min(size + n, cap)
        pv, _ = trb.powered_priorities(np.full(n, 1.0 + step), 0.6)
        for t in (hs, hm):
            t.set_items(pos, pv)
        dt.set_powered(pos, pv)
        uidx = rng.integers(0, size, 12)  # repeats inside one write
        uidx[-1] = uidx[0]
        pv2, _ = trb.powered_priorities(rng.random(12) * 3, 0.6)
        for t in (hs, hm):
            t.set_items(uidx, pv2)
        dt.set_powered(torch.as_tensor(uidx), pv2)
        assert dt.sum_value.numpy().tobytes() == hs.value.tobytes(), step
        assert dt.min_value.numpy().tobytes() == hm.value.tobytes(), step
    assert dt.leaf_values(size).tobytes() == hs.value[cap: cap + size].tobytes()
    idx, w = dt.draw(rng.random(8), size, 0.4)
    assert idx.dtype == torch.int64 and w.dtype == torch.float32


# -- buffers -------------------------------------------------------------------


def _fragment(n, base, rng):
    """A replay fragment in the device lane's columns: packed 8x8 pixels,
    int64 actions (canonicalised to int32), bool dones, f32 rows."""
    return {
        "obs": rng.integers(0, 256, (n, 8, 8, 1), dtype=np.uint8),
        "new_obs": rng.integers(0, 256, (n, 8, 8, 1), dtype=np.uint8),
        "actions": rng.integers(0, 3, n).astype(np.int64),
        "rewards": (np.arange(n) + base).astype(np.float32),
        "dones": rng.random(n) < 0.3,
        "action_dist_inputs": rng.standard_normal((n, 3)).astype(np.float32),
    }


def _assert_rows_equal(port_tree, ref_tree, keys):
    for k in keys:
        r = np.asarray(jax.device_get(ref_tree[k]))
        g = _np(port_tree[k])
        assert g.shape == r.shape, k
        assert g.tobytes() == r.astype(g.dtype).tobytes(), k


def test_uniform_device_buffer_matches_reference():
    rng = np.random.default_rng(1)
    ref = jrb.DeviceReplayBuffer(capacity=24, seed=9)
    port = trb.DeviceReplayBuffer(capacity=24, seed=9, device="cpu")
    for i in range(6):
        t = _fragment(7, 10 * i, rng)
        ref.add_tree(dict(t))
        port.add_device_tree(dict(t))
        assert (len(port), port._idx, port.num_added) == (len(ref), ref._idx, ref.num_added)
        if len(ref) >= 8:
            rs, ps = ref.sample(8), port.sample(8)
            np.testing.assert_array_equal(ps.indices, rs.indices)
            _assert_rows_equal(ps.tree, rs.tree, t)
    assert port._store["obs"].dtype == torch.int32 and port._store["obs"].shape == (24, 16)
    assert port._store["actions"].dtype == torch.int32
    # checkpoints move both ways and keep the ring layout
    state = ref.get_state()
    moved = trb.DeviceReplayBuffer(capacity=24, seed=9, device="cpu")
    moved.set_state(state)
    mine = port.get_state()
    for k, v in state["cols"].items():
        assert mine["cols"][k].dtype == v.dtype and mine["cols"][k].tobytes() == v.tobytes(), k
    back = jrb.DeviceReplayBuffer(capacity=24, seed=9)
    back.set_state(mine)
    idx = np.arange(24)
    _assert_rows_equal(moved.gather(idx).tree, back.gather(idx).tree, state["cols"])
    assert (moved._idx, len(moved), moved.num_added) == (ref._idx, len(ref), ref.num_added)


@pytest.mark.parametrize("capacity,alpha", [(40, 0.6), (27, 1.0)])
def test_prioritized_buffer_matches_reference(capacity, alpha):
    """Same inserts, priority updates (repeated indices included) and
    seed: the same rows, indices and weights, max priority and generator
    state; then the reference's checkpoint restored into the port draws
    the same next samples. The second case wraps a ring whose capacity
    is not a power of two."""
    rng = np.random.default_rng(2)
    ref = jrb.DevicePrioritizedReplayBuffer(
        capacity=capacity, alpha=alpha, seed=4, device_tree=False
    )
    port = trb.DevicePrioritizedReplayBuffer(capacity=capacity, alpha=alpha, seed=4, device="cpu")
    cols = list(_fragment(1, 0, rng))
    for i in range(9):
        t = _fragment(6, i, rng)
        ref.add_tree(dict(t))
        port.add_device_tree(dict(t))
        if len(ref) < 8:
            continue
        rs, ps = ref.sample(8, beta=0.4), port.sample(8, beta=0.4)
        np.testing.assert_array_equal(_np(ps.indices), rs.indices)
        _assert_rows_equal(ps.tree, rs.tree, cols + ["weights"])
        td = np.abs(np.random.default_rng(i).standard_normal(8)).astype(np.float32)
        td[-1] = 4.0 + i  # raises the max priority
        ref.update_priorities(rs.indices, td + 1e-6)
        port.update_priorities(ps.indices, td + 1e-6)
        assert port._max_priority == ref._max_priority
    assert port._rng.bit_generator.state == ref._rng.bit_generator.state
    assert port.get_state()["priorities"]["leaf_values"].tobytes() == (
        ref.get_state()["priorities"]["leaf_values"].tobytes()
    )
    moved = trb.DevicePrioritizedReplayBuffer(capacity=capacity, alpha=alpha, seed=4, device="cpu")
    moved.set_state(ref.get_state())
    moved._rng.bit_generator.state = ref._rng.bit_generator.state
    for _ in range(3):
        rs, ps = ref.sample(16, beta=0.6), moved.sample(16, beta=0.6)
        np.testing.assert_array_equal(_np(ps.indices), rs.indices)
        _assert_rows_equal(ps.tree, rs.tree, cols + ["weights"])


def test_host_rings_match_reference():
    rng = np.random.default_rng(3)
    pairs = [
        (trb.ReplayBuffer(20, seed=1), jrb.ReplayBuffer(20, seed=1)),
        (trb.PrioritizedReplayBuffer(20, 0.6, seed=1), jrb.PrioritizedReplayBuffer(20, 0.6, seed=1)),
    ]
    for i in range(4):
        t = _fragment(7, i, rng)
        for port, ref in pairs:
            port.add(SampleBatch(dict(t)))
            ref.add(JSampleBatch(dict(t)))
    for port, ref in pairs:
        ps, rs = port.sample(6), ref.sample(6)
        for k in rs:
            assert np.asarray(ps[k]).tobytes() == np.asarray(rs[k]).tobytes(), k
        ps_state, rs_state = port.get_state(), ref.get_state()
        for k in rs_state["cols"]:
            assert ps_state["cols"][k].tobytes() == rs_state["cols"][k].tobytes()


def test_multi_agent_buffer_knobs_and_memory_cap():
    assert trb.resolve_device_resident({}) and trb.resolve_device_tree({})
    assert not trb.resolve_device_resident({"replay_device_resident": False})
    assert not trb.resolve_device_tree({"replay_device_resident": False})
    assert not trb.resolve_device_tree({"replay_device_tree": False})
    assert trb.resolve_device_tree({"replay_device_tree": True})
    ma = trb.MultiAgentReplayBuffer(16, prioritized=True, seed=0, device="cpu")
    rng = np.random.default_rng(4)
    ma.add_device_tree({k: torch.as_tensor(v) for k, v in _fragment(6, 0, rng).items()})
    assert len(ma) == 6 and ma.sample(8) == {}
    out = ma.sample(4, beta=0.4)
    assert set(out) == {"default_policy"} and out["default_policy"].count == 4
    state = ma.get_state()
    ma2 = trb.MultiAgentReplayBuffer(16, prioritized=True, seed=0, device="cpu")
    ma2.set_state(state)
    assert len(ma2) == 6
    small = trb.DeviceReplayBuffer(capacity=1000, device="cpu", memory_cap_bytes=10_000)
    small.add_device_tree(_fragment(2, 0, rng))
    assert small.spilled and len(small) == 2 and small.stats()["device_resident"] is False
    host = trb.MultiAgentReplayBuffer(16, prioritized=True, seed=0, device_resident=False)
    with pytest.raises(TypeError, match="device rings"):
        host.add_device_tree(_fragment(2, 0, rng))
    host.add(SampleBatch(_fragment(6, 0, np.random.default_rng(4))))
    assert type(host.buffers["default_policy"]).__name__ == "PrioritizedReplayBuffer"
    assert host.sample(4, beta=0.4)["default_policy"].count == 4
