"""The checkpoint stream of the port (``resilience/streamer.py``) and the
stream half of discovery, on the CPU.

- a snapshot is bitwise the state at its superstep, also when it is
  written while training goes on (the writer held inside its pull while
  two more supersteps update the parameters in place, the second
  capture replacing the first pending one in the other buffer);
- a training run started again on the same root restores the stream tail and
  loses at most one superstep: weights, Adam state and counters bitwise;
- an injected ``crash_learner`` restores PPO from the tail, and an
  injected ``crash_learner_thread`` restores IMPALA from it, into a new
  learner thread: the parameters right after the restore are the
  snapshot's, bitwise; a crash in PPO's prefetch ``deliver`` restores
  and the pipeline is built anew;
- ``pick_restore_target`` and ``discover`` make the reference's choice
  over a table of (periodic, tail) pairs, a torn tail included;
- a snapshot the reference's ``CheckpointStreamer`` wrote, carried in by
  ``from_jax_stream_snapshot``: the weights bitwise (after layout), the
  Adam moments bitwise, the counters equal, and the forward within 1e-5
  relative of the reference's on 64 seeded observations; the serving
  plane reads it as a stream target.
"""

from __future__ import annotations

import os
import pickle
import threading

import numpy as np
import pytest
import torch

from ray_tpu.resilience import discovery as ref_discovery
from ray_tpu_torch.algorithms.impala.impala import IMPALAConfig
from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig
from ray_tpu_torch.resilience import InjectedCrash, discovery, streamer as streamer_mod
from ray_tpu_torch.resilience.streamer import CheckpointStreamer, load_payload
from ray_tpu_torch.serve.policy_server import load_policy_state
from ray_tpu_torch.utils.jax_params import flax_to_state_dict, from_jax_stream_snapshot


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU learns: beside
    other test processes on the same cores, torch's thread pool spins
    for far longer than these learns compute."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _assert_same(a, b, path="state"):
    """Bitwise equality of two state trees."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), f"{path}: {sorted(a)} != {sorted(b)}"
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        assert a.tobytes() == b.tobytes(), f"{path}: values differ"
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


def _copy(state):
    return pickle.loads(pickle.dumps(state))


def _stream_ppo(root, **ft):
    return (PPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, rollout_fragment_length=64)
            .training(train_batch_size=128, sgd_minibatch_size=64, num_sgd_iter=2, lr=3e-4)
            .fault_tolerance(checkpoint_streaming=True, checkpoint_root=root,
                             restore_on_failure=True, **ft)
            .debugging(seed=1).resources(device="cpu").build())


def _snapshot(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_snapshot_is_the_state_at_its_superstep_while_training_goes_on(tmp_path, monkeypatch):
    gate = threading.Event()
    entered = threading.Event()
    real_pull = streamer_mod._Buffer.pull

    def held_pull(self, stream):
        entered.set()
        assert gate.wait(60)
        return real_pull(self, stream)

    monkeypatch.setattr(streamer_mod._Buffer, "pull", held_pull)
    algo = _stream_ppo(str(tmp_path))
    st = algo._ckpt_streamer
    try:
        states = {}
        for superstep in (1, 2, 3):
            algo.train()  # one round: one offer, after the round's update
            states[superstep] = _copy(algo.get_policy().get_state())
            if superstep == 1:
                assert entered.wait(30)  # the writer is inside buffer A's pull
                # both buffers are made at the first capture: the memory
                # stays level from there on
                assert all(len(b.dev) == len(st._buffers[0].dev) > 0 for b in st._buffers)
        # A is being read, B holds capture 3 (it replaced capture 2)
        assert [b.state for b in st._buffers] == ["reading", "pending"]
        gate.set()
        assert st.flush(30) and st.error is None
        assert st.stats()["snapshots_written"] == 2 and st.stats()["lag_supersteps"] == 0
        names = sorted(os.listdir(st.root))
        assert names == ["snapshot_0000000001.pkl", "snapshot_0000000003.pkl"]
        for superstep in (1, 3):
            payload = _snapshot(os.path.join(st.root, f"snapshot_{superstep:010d}.pkl"))
            assert payload["superstep"] == superstep and payload["iteration"] == superstep - 1
            _assert_same(payload["policy_states"]["default_policy"], states[superstep])
        assert payload["counters"] == dict(algo._counters)
        assert st.stats()["capture_ms_mean"] > 0.0
    finally:
        gate.set()
        algo.stop()


def test_restore_from_the_tail_loses_at_most_one_superstep(tmp_path):
    root = str(tmp_path / "root")
    a1 = _stream_ppo(root)
    try:
        for _ in range(3):
            a1.train()
        head = a1._ckpt_streamer._superstep
        assert a1._ckpt_streamer.flush(30)
        state = _copy(a1.get_policy().get_state())
        counters = dict(a1._counters)
    finally:
        a1.stop()  # the run is gone
    a2 = _stream_ppo(root)
    try:
        path = a2._recovery.restore_latest()
        assert path is not None and os.path.dirname(path).endswith("stream")
        assert head - CheckpointStreamer.peek(path)["superstep"] <= 1
        _assert_same(a2.get_policy().get_state(), state)
        assert dict(a2._counters) == counters and a2.iteration == 2
        assert np.isfinite(a2.train()["info"]["learner"]["default_policy"]["total_loss"])
    finally:
        a2.stop()


def test_crash_learner_restores_ppo_from_the_tail(tmp_path):
    algo = _stream_ppo(str(tmp_path), max_failures=3,
                       fault_injection={"crash_learner": {"on_learn_call": 2}})
    try:
        algo.train()
        assert algo._ckpt_streamer.flush(30)
        tail_state = _snapshot(algo._ckpt_streamer.latest_path)["policy_states"]["default_policy"]
        seen = []
        real = algo.on_recovery
        algo.on_recovery = lambda kind: (seen.append(_copy(algo.get_policy().get_state())), real(kind))
        r2 = algo.train()
        rec = r2["info"]["recovery"]
        assert rec["recoveries"] == {"restore": 1} and rec["failures"] == 1
        assert rec["stream"]["snapshots_written"] >= 1
        _assert_same(seen[0], tail_state)
        assert np.isfinite(r2["info"]["learner"]["default_policy"]["total_loss"])
    finally:
        algo.stop()


def test_crash_learner_thread_restores_impala_from_the_tail(tmp_path):
    cfg = (IMPALAConfig().environment("CartPole-v1")
           .rollouts(num_rollout_workers=0, rollout_fragment_length=16)
           .training(train_batch_size=64, lr=1e-3)
           .fault_tolerance(checkpoint_streaming=True, checkpoint_root=str(tmp_path),
                            restore_on_failure=True, max_failures=3,
                            fault_injection={"crash_learner_thread": {"on_step": 2}})
           .update_from_dict({"min_time_s_per_iteration": 0})
           .debugging(seed=1).resources(device="cpu"))
    algo = cfg.build()
    try:
        old = algo._learner_thread
        seen = []
        real = algo.on_recovery

        def on_recovery(kind):
            seen.append(_copy(algo.get_policy().get_state()))
            real(kind)

        algo.on_recovery = on_recovery
        rec = {}
        for _ in range(30):
            r = algo.train()
            assert algo._ckpt_streamer.flush(30)
            rec = r["info"]["recovery"]
            if rec["recoveries"]:
                break
        assert rec["recoveries"] == {"restore": 1}
        assert isinstance(old.error, InjectedCrash) and not old.is_alive()
        new = algo._learner_thread
        assert new is not old and new.is_alive() and new.feeder is not old.feeder
        # the tail the restore read: the newest snapshot before the crash
        restored = [p for p in [rec["stream"]["latest"]] if p]
        assert restored
        snaps = sorted(os.listdir(os.path.join(str(tmp_path), "stream")))
        candidates = [_snapshot(os.path.join(str(tmp_path), "stream", n)) for n in snaps]
        assert any(_same_state(c["policy_states"]["default_policy"], seen[0]) for c in candidates)
        # the new thread learns on
        steps = new.num_steps
        for _ in range(5):
            algo.train()
            if new.num_steps > steps:
                break
        assert new.num_steps > steps and new.error is None
    finally:
        algo.stop()


def _same_state(a, b):
    try:
        _assert_same(a, b)
        return True
    except AssertionError:
        return False


# -- discovery -------------------------------------------------------------------------


def _write_tail(root, superstep, iteration):
    d = os.path.join(root, "stream")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"snapshot_{superstep:010d}.pkl")
    with open(path, "wb") as f:
        pickle.dump({"superstep": superstep, "iteration": iteration, "policy_states": {}}, f)
    return path


@pytest.mark.parametrize("periodic,tail", [
    (None, None), (3, None), (None, (5, 2)), (3, (9, 3)), (3, (9, 2)), (4, (1, 7)),
    (3, "torn"), (None, "torn"), (12, (40, 12)),
])
def test_pick_restore_target_matches_reference(tmp_path, periodic, tail):
    root = str(tmp_path)
    p = None
    if periodic is not None:
        p = os.path.join(root, f"checkpoint_{periodic:06d}")
        os.makedirs(p)
    t = None
    if tail == "torn":
        os.makedirs(os.path.join(root, "stream"))
        t = os.path.join(root, "stream", "snapshot_0000000004.pkl")
        with open(t, "wb") as f:
            f.write(b"\x80\x04torn")
    elif tail is not None:
        t = _write_tail(root, *tail)
    assert discovery.pick_restore_target(p, t) == ref_discovery.pick_restore_target(p, t)
    assert discovery.discover(root) == ref_discovery.discover(root)
    assert discovery.latest_stream_tail(root) == ref_discovery.latest_stream_tail(root)
    kind, path = discovery.discover(root)
    if path is not None and tail != "torn":
        assert discovery.target_version(kind, path) == ref_discovery.target_version(kind, path)


# -- a reference snapshot in the port ---------------------------------------------------


def test_reference_snapshot_carried_into_the_port(tmp_path):
    from ray_tpu.algorithms.ppo import PPOConfig as RefPPOConfig

    common = dict(train_batch_size=128, sgd_minibatch_size=64, num_sgd_iter=2, lr=3e-4)
    ref = (RefPPOConfig().environment("CartPole-v1")
           .rollouts(num_rollout_workers=0, rollout_fragment_length=64)
           .training(**common)
           .fault_tolerance(checkpoint_streaming=True, checkpoint_root=str(tmp_path / "ref"))
           .debugging(seed=1).resources(learner_devices=1).build())
    port = (PPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, rollout_fragment_length=64).training(**common)
            .debugging(seed=2).resources(device="cpu").build())
    try:
        ref.train()
        assert ref._ckpt_streamer.flush(30)
        path = ref._ckpt_streamer.latest_path
        payload = _snapshot(path)
        load_payload(port, from_jax_stream_snapshot(payload))
        ps = payload["policy_states"]["default_policy"]
        pol, rpol = port.get_policy(), ref.get_policy()
        _assert_same(pol.get_weights(), flax_to_state_dict(ps["weights"]))
        own = pol.get_state()["opt_state"]
        assert own["count"] == int(np.asarray(ps["opt_state"][0].count)) == 2 * 2
        assert dict(port._counters) == {k: int(v) for k, v in payload["counters"].items()}
        assert port.iteration == payload["iteration"]
        obs = np.random.default_rng(0).uniform(-0.2, 0.2, (64, 4)).astype(np.float32)
        for o in obs:
            got = pol.compute_single_action(o, explore=False)[2]
            want = rpol.compute_single_action(o, explore=False)[2]
            np.testing.assert_allclose(got["action_dist_inputs"],
                                       np.asarray(want["action_dist_inputs"]), rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(got["vf_preds"], np.asarray(want["vf_preds"]),
                                       rtol=1e-5, atol=1e-7)
        # the serving plane reads the same target as a stream snapshot
        state = load_policy_state("stream", path)
        _assert_same(flax_to_state_dict(state["weights"]), pol.get_weights())
        ref_kind, ref_path = ref_discovery.discover(str(tmp_path / "ref"))
        assert discovery.discover(str(tmp_path / "ref")) == (ref_kind, ref_path) == ("stream", path)
    finally:
        ref.cleanup()
        port.stop()


def test_crash_in_the_prefetch_deliver_restores_and_rebuilds_the_pipeline(tmp_path):
    """PPO's prefetch path: ``crash_learner`` fires in the pipeline's
    ``deliver`` (its thread dies), the step raises, the stream tail is
    restored, ``on_recovery`` tears the pipeline down, and the next step
    builds a new one that learns on."""
    from ray_tpu_torch import core

    core.shutdown()
    algo = (PPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=2, rollout_fragment_length=32, sample_prefetch=1)
            .training(train_batch_size=64, sgd_minibatch_size=32, num_sgd_iter=1, lr=3e-4)
            .fault_tolerance(checkpoint_streaming=True, checkpoint_root=str(tmp_path),
                             restore_on_failure=True, max_failures=3,
                             fault_injection={"crash_learner": {"on_learn_call": 3}})
            .debugging(seed=1).resources(device="cpu").build())
    try:
        algo.train()
        assert algo._ckpt_streamer.flush(30)
        first = algo._sample_pipeline
        rec = {}
        for _ in range(10):
            r = algo.train()
            rec = r["info"]["recovery"]
            if rec["recoveries"]:
                break
        assert rec["recoveries"] == {"restore": 1}
        assert isinstance(first.error, InjectedCrash) and not first.healthy()
        assert algo._sample_pipeline is not None and algo._sample_pipeline is not first
        assert algo._sample_pipeline.healthy()
        assert np.isfinite(r["info"]["learner"]["default_policy"]["total_loss"])
    finally:
        algo.stop()
        core.shutdown()
