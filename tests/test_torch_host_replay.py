"""Host rings, host trees beside device rows and the memory-cap spill,
against the JAX package's, on the CPU.

Every contract here is bitwise (tolerance 0):

- the host ``ReplayBuffer`` and ``PrioritizedReplayBuffer``: one seeded
  stream of inserts, draws and priority updates through the port's and
  the reference's gives the same indices, IS weights, rows, leaf values,
  max priority and generator state; ``draw_index_sets`` and
  ``draw_prioritized_sets`` are k ``sample`` calls;
- ``DevicePrioritizedReplayBuffer(device_tree=False)`` (rows as CPU
  tensors, the kernels' plain versions) against the reference's
  ``DevicePrioritizedReplayBuffer(device_tree=False)`` and against the
  port's device tree at the same seed: indices, weights, rows;
- the spill: a buffer over ``memory_cap_bytes`` draws the stream of one
  under it; a column that tips the projection over later moves the
  resident rows into the host ring; a spilled state round-trips, a
  restore onto a smaller budget lands in the spill ring, the reference's
  spilled state restores into the port, and states move between the
  tree planes both ways (``from_jax_replay_state``);
- the superstep's host stacked path: k slots from a host ring (uniform
  and prioritized) and from a host tree equal k sequential updates on
  the same draws, the priorities refreshed in update order.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from ray_tpu.data.sample_batch import SampleBatch as JSampleBatch
from ray_tpu.execution import replay_buffer as jrb
from ray_tpu_torch.algorithms.dqn.dqn import DQNConfig
from ray_tpu_torch.data.sample_batch import SampleBatch
from ray_tpu_torch.execution import replay_buffer as trb
from ray_tpu_torch.execution.train_ops import superstep_train_replay
from ray_tpu_torch.utils.jax_params import from_jax_replay_state


def _rows(n, base, rng):
    return {
        "obs": rng.standard_normal((n, 4)).astype(np.float32) + base,
        "pix": rng.integers(0, 256, (n, 4, 4, 1), dtype=np.uint8),
        "actions": rng.integers(0, 2, n).astype(np.int32),
        "rewards": (np.arange(n) + base).astype(np.float32),
        "dones": rng.random(n) < 0.3,
    }


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_state(a, b):
    assert (a["idx"], a["size"], a["num_added"]) == (b["idx"], b["size"], b["num_added"])
    assert set(a["cols"]) == set(b["cols"])
    for k in a["cols"]:
        assert np.array_equal(np.asarray(a["cols"][k]), np.asarray(b["cols"][k])), k
    if "priorities" in a or "priorities" in b:
        pa, pb = a["priorities"], b["priorities"]
        assert _np(pa["leaf_values"]).tobytes() == _np(pb["leaf_values"]).tobytes()
        assert pa["max_priority"] == pb["max_priority"]


@pytest.mark.parametrize("prioritized", [False, True])
def test_host_rings_match_reference_stream(prioritized):
    rng = np.random.default_rng(0)
    if prioritized:
        port, ref = trb.PrioritizedReplayBuffer(24, 0.6, seed=5), jrb.PrioritizedReplayBuffer(24, 0.6, seed=5)
    else:
        port, ref = trb.ReplayBuffer(24, seed=5), jrb.ReplayBuffer(24, seed=5)
    for step in range(10):
        rows = _rows(int(rng.integers(3, 9)), float(step), rng)
        port.add(SampleBatch({k: v.copy() for k, v in rows.items()}))
        ref.add(JSampleBatch({k: v.copy() for k, v in rows.items()}))
        if prioritized:
            a, b = port.sample(6, beta=0.4 + 0.05 * step), ref.sample(6, beta=0.4 + 0.05 * step)
            assert a["weights"].tobytes() == b["weights"].tobytes()
            pri = rng.random(6) * 3
            port.update_priorities(a["batch_indexes"], pri)
            ref.update_priorities(b["batch_indexes"], pri)
            i1, w1 = port.draw_prioritized_sets(3, 5, 0.4)
            i2, w2 = ref.draw_prioritized_sets(3, 5, 0.4)
            assert np.array_equal(i1, i2) and w1.tobytes() == w2.tobytes()
        else:
            a, b = port.sample(6), ref.sample(6)
            assert np.array_equal(port.draw_index_sets(3, 5), ref.draw_index_sets(3, 5))
        for k in rows:
            assert np.array_equal(a[k], b[k]), k
    assert port.stats() == ref.stats()
    assert port._rng.bit_generator.state == ref._rng.bit_generator.state
    _same_state(port.get_state(), ref.get_state())


def test_host_tree_beside_device_rows_matches_reference_and_device_tree():
    rng = np.random.default_rng(1)
    host = trb.DevicePrioritizedReplayBuffer(32, 0.6, seed=7, device="cpu", device_tree=False)
    dev = trb.DevicePrioritizedReplayBuffer(32, 0.6, seed=7, device="cpu")
    ref = jrb.DevicePrioritizedReplayBuffer(32, 0.6, seed=7, device_tree=False)
    assert (host.tree_plane, dev.tree_plane, ref.tree_plane) == ("host", "device", "host")
    for step in range(8):
        rows = _rows(int(rng.integers(3, 9)), float(step), rng)
        for buf in (host, dev):
            buf.add_device_tree({k: v.copy() for k, v in rows.items()})
        ref.add_tree({k: v.copy() for k, v in rows.items()})
        beta = 0.4 + 0.05 * step
        h, d, r = host.sample(6, beta=beta), dev.sample(6, beta=beta), ref.sample(6, beta=beta)
        assert isinstance(h.indices, np.ndarray)
        assert np.array_equal(h.indices, _np(d.indices)) and np.array_equal(h.indices, r.indices)
        rt = jax.device_get(r.tree)
        for k in list(rows) + ["weights"]:
            assert _np(h.tree[k]).tobytes() == _np(d.tree[k]).tobytes() == np.asarray(rt[k]).tobytes(), k
        pri = rng.random(6) * 3
        host.update_priorities(h.indices, pri)
        dev.update_priorities(d.indices, pri)
        ref.update_priorities(r.indices, pri)
    _same_state(host.get_state(), from_jax_replay_state(ref.get_state()))
    _same_state(host.get_state(), dev.get_state())


def test_spill_draws_the_unspilled_stream_and_round_trips():
    rng = np.random.default_rng(3)
    ref = trb.DevicePrioritizedReplayBuffer(64, 0.6, seed=11, device="cpu")
    sp = trb.DevicePrioritizedReplayBuffer(64, 0.6, seed=11, device="cpu", memory_cap_bytes=500)
    for step in range(6):
        rows = _rows(8, float(step), rng)
        ref.add_device_tree({k: v.copy() for k, v in rows.items()})
        sp.add_device_tree({k: v.copy() for k, v in rows.items()})
        a, b = sp.sample(5, beta=0.4), ref.sample(5, beta=0.4)
        assert isinstance(a, SampleBatch)
        assert np.array_equal(a["batch_indexes"], _np(b.indices))
        for k in list(rows) + ["weights"]:
            assert np.asarray(a[k]).tobytes() == _np(b.tree[k]).tobytes(), k
        pri = rng.random(5) * 2
        sp.update_priorities(a["batch_indexes"], pri)
        ref.update_priorities(b.indices, pri)
    assert sp.spilled and not ref.spilled and sp.tree_plane == "host"
    assert sp.stats()["device_resident"] is False and sp.storage_bytes == 0
    assert np.array_equal(sp.draw_index_sets(2, 4), ref.draw_index_sets(2, 4))
    with pytest.raises(RuntimeError, match="host stacked path"):
        sp.superstep_feed(2, 2, 4)
    state = sp.get_state()
    assert state["spilled"]
    _same_state({k: v for k, v in state.items()}, ref.get_state())
    again = trb.DevicePrioritizedReplayBuffer(64, 0.6, seed=0, device="cpu")
    again.set_state(state)
    assert again.spilled and len(again) == len(sp)
    _same_state(again.get_state(), state)
    # an unspilled state restored under a smaller budget lands in the spill ring
    small = trb.DevicePrioritizedReplayBuffer(64, 0.6, seed=0, device="cpu", memory_cap_bytes=500)
    small.set_state(ref.get_state())
    assert small.spilled
    _same_state(small.get_state(), ref.get_state())
    # and the reference's spilled state restores into the port
    jsp = jrb.DeviceReplayBuffer(64, seed=11, memory_cap_bytes=500)
    jsp.add_tree({k: v.copy() for k, v in _rows(8, 0.0, rng).items()})
    port = trb.DeviceReplayBuffer(64, seed=11, device="cpu")
    port.set_state(from_jax_replay_state(jsp.get_state()))
    assert port.spilled and jsp.spilled
    _same_state(port.get_state(), jax.device_get(jsp.get_state()))


def test_a_later_column_tipping_the_cap_moves_the_resident_rows():
    rng = np.random.default_rng(4)
    rows = _rows(6, 0.0, rng)
    small = {"obs": rows["obs"], "rewards": rows["rewards"]}
    buf = trb.DeviceReplayBuffer(16, seed=2, device="cpu", memory_cap_bytes=16 * 24)
    ref = trb.DeviceReplayBuffer(16, seed=2, device="cpu")
    buf.add_device_tree(dict(small))
    ref.add_device_tree(dict(small))
    assert not buf.spilled and buf.storage_bytes == 16 * 20
    buf.add_device_tree(dict(rows))  # pix, actions, dones do not fit
    ref.add_device_tree(dict(rows))
    assert buf.spilled and len(buf) == 12 and buf.num_added == 12
    got, want = buf.get_state(), ref.get_state()
    for k in small:  # the resident rows moved over
        assert np.array_equal(got["cols"][k], want["cols"][k]), k
    for k in ("pix", "actions", "dones"):
        assert np.array_equal(got["cols"][k][6:], want["cols"][k][6:]), k
    a, b = buf.sample(4), ref.sample(4)
    assert np.array_equal(a["obs"], b.tree["obs"].numpy())


def test_tree_planes_exchange_states():
    rng = np.random.default_rng(6)
    rows = _rows(8, 0.0, rng)
    ref_host = jrb.DevicePrioritizedReplayBuffer(64, 0.6, seed=11, device_tree=False)
    ref_host.add_tree(dict(rows))
    ref_host.update_priorities(np.arange(4), np.linspace(0.2, 2.0, 4))
    d2 = trb.DevicePrioritizedReplayBuffer(64, 0.6, seed=77, device="cpu")
    d2.set_state(from_jax_replay_state(ref_host.get_state()))
    assert d2.tree_plane == "device"
    assert (d2._priority_state()["leaf_values"].view(np.uint64).tobytes()
            == ref_host._priority_state()["leaf_values"].view(np.uint64).tobytes())
    assert d2._max_priority == ref_host._max_priority
    h2 = trb.DevicePrioritizedReplayBuffer(64, 0.6, seed=77, device="cpu", device_tree=False)
    h2.set_state(d2.get_state())
    ring = trb.PrioritizedReplayBuffer(64, 0.6, seed=77)
    ring.set_state(h2.get_state())
    _same_state(ring.get_state(), d2.get_state())
    a, b, c = h2.sample(6), d2.sample(6), ring.sample(6)
    assert np.array_equal(a.indices, _np(b.indices))
    assert np.array_equal(c["batch_indexes"], a.indices)
    assert c["weights"].tobytes() == _np(a.tree["weights"]).tobytes() == _np(b.tree["weights"]).tobytes()


# -- the superstep's host stacked path --------------------------------------------------


def _dqn(seed=3, **over):
    cfg = (
        DQNConfig()
        .environment("CartPoleJax-v0", env_backend="jax")
        .rollouts(num_envs_per_worker=4, rollout_fragment_length=4)
        .training(replay_buffer_config={"capacity": 64, "prioritized_replay": True},
                  model={"fcnet_hiddens": [16]}, train_batch_size=8,
                  num_steps_sampled_before_learning_starts=16, target_network_update_freq=16)
        .debugging(seed=seed).resources(device="cpu")
    )
    cfg.update_from_dict(over)
    return cfg.build()


def _filled_pair(**over):
    a, b = _dqn(**over), _dqn(**over)
    for algo in (a, b):
        for _ in range(4):
            algo._jax_rollout_fill()
        buf = algo.local_replay_buffer.buffers["default_policy"]
        if hasattr(buf, "update_priorities"):
            buf.update_priorities(np.arange(16), np.linspace(1.0, 5.0, 16))
    return a, b


def _same_policy(p, q):
    assert all(torch.equal(x, y) for x, y in zip(p.params, q.params))
    assert all(torch.equal(x, y) for x, y in zip(p.opt_state.mu, q.opt_state.mu))
    assert p.opt_state.count == q.opt_state.count


@pytest.mark.parametrize("case", ["host_uniform", "host_prioritized", "host_tree"])
def test_host_superstep_equals_sequential_updates(case):
    over = {"replay_device_resident": case == "host_tree", "replay_device_tree": False}
    if case == "host_uniform":
        over["replay_buffer_config"] = {"capacity": 64, "prioritized_replay": False}
    prioritized = case != "host_uniform"
    a, b = _filled_pair(**over)
    k, bs = 3, 8
    pa, ba = a.get_policy(), a.local_replay_buffer.buffers["default_policy"]
    pb, bb = b.get_policy(), b.local_replay_buffer.buffers["default_policy"]
    assert isinstance(ba, trb.DevicePrioritizedReplayBuffer) == (case == "host_tree")
    for _ in range(2):  # the second superstep draws from the refreshed trees
        if prioritized:
            idx, weights = ba.draw_prioritized_sets(k, bs, 0.4)
        else:
            idx = ba.draw_index_sets(k, bs)
        seq = []
        for i in range(k):
            if case == "host_tree":
                batch = ba.gather(idx[i])
                batch.tree["weights"] = torch.from_numpy(weights[i])
                seq.append(pa.learn_on_device_batch(dict(batch.tree), bs))
            else:
                batch = ba._make_batch(idx[i])
                if prioritized:
                    batch["weights"] = weights[i]
                seq.append(pa.learn_on_batch(batch))
            if prioritized:
                ba.update_priorities(idx[i], pa.compute_td_error(batch) + 1e-6)
        info = superstep_train_replay(b, pb, bb, k, k, bs, prioritized=prioritized, beta=0.4)
        assert info == {k_: v for k_, v in seq[-1].items() if k_ in info}
        _same_policy(pa, pb)
        assert ba._rng.bit_generator.state == bb._rng.bit_generator.state
        if prioritized:
            assert ba._sum_tree.value.tobytes() == bb._sum_tree.value.tobytes()
            assert ba._max_priority == bb._max_priority
