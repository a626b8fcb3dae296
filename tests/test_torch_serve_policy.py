"""The port's batched policy server (``ray_tpu_torch/serve/policy_server.py``)
against the reference's and against its own contracts, on the CPU.

- greedy parity with the reference: the same weights
  (``from_jax_policy_weights``) and observation stream through the
  reference's ``BatchedPolicyServer`` (1-shard mesh) and the port's:
  actions equal, extras (logits, ``vf_preds``, ``action_logp``) within
  1e-5 relative (1e-7 absolute);
- checkpoint parity: a reference PPO checkpoint (``MeanStdFilter``) read
  by both packages' ``restore_policy``: equal greedy actions on 32
  observations through the restored filters, logits within 1e-5
  relative, and the filter statistics bitwise;
- the port's explore contract, bitwise: 13 requests split into batches
  in several ways give exactly what sequential batch-1 ``compute_actions``
  on a policy of the same seed gives, for PPO's ``Categorical`` and DQN's
  ``EpsilonGreedy``, in exact mode; warmup leaves the generator's state
  unchanged;
- host modules, exact: ``default_buckets``, ``TrailingWindow``'s
  percentiles and ``discovery`` on the same directory trees give what the
  reference's give;
- the reference's serve tests as port counterparts: no program built
  after warmup at any occupancy, the timeout and full-bucket flush, fill
  and queue-wait observability, hot reload mid-traffic (no drops, no
  blends, monotone versions; the parameters' storage kept), the closed
  train → save → serve → reload loop on the port's ``CartPole-v1``, the
  provider notice; vectorized mode within 1e-5 relative of the exact one;
- refusals: ``aot_cache`` (item 6.3), a stream root (item 3d); a policy
  without batched serving (a recurrent model) is no longer refused: it
  takes the reference's sequential fallback, with no program built.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.algorithms.dqn.dqn import DQNConfig, DQNTorchPolicy
from ray_tpu_torch.algorithms.ppo.ppo import PPO, PPOConfig, PPOTorchPolicy
from ray_tpu_torch.env.spaces import Box, Discrete
from ray_tpu_torch.resilience import discovery, provider_notice
from ray_tpu_torch.serve.policy_server import (
    BatchedPolicyServer,
    PolicyDeployment,
    TrailingWindow,
    default_buckets,
    restore_policy,
)
from ray_tpu_torch.utils.jax_params import from_jax_policy_weights

OBS = Box(-1.0, 1.0, (4,), np.float32)
ACT = Discrete(2)
RTOL, ATOL = 1e-5, 1e-7


def _ppo(seed=7, **over):
    cfg = PPOConfig().to_dict()
    cfg.update(seed=seed, model={"fcnet_hiddens": [16, 16]}, **over)
    return PPOTorchPolicy(OBS, ACT, cfg, device="cpu")


def _dqn(seed=7):
    cfg = DQNConfig().to_dict()
    cfg.update(seed=seed, model={"fcnet_hiddens": [16, 16]},
               exploration_config={"type": "EpsilonGreedy", "initial_epsilon": 0.5,
                                   "final_epsilon": 0.5})
    return DQNTorchPolicy(OBS, Discrete(3), cfg, device="cpu")


def _server(policy, **kw):
    kw.setdefault("max_batch_size", 8)
    srv = BatchedPolicyServer(policy, start=False, **kw)
    srv.warmup()
    return srv


def _obs(n, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 4)).astype(np.float32)


def _sequential(policy, obs, explore):
    return [policy.compute_actions(o[None], explore=explore) for o in obs]


def _assert_bitwise(outs, refs):
    for i, ((a, ex), (a_ref, _, ex_ref)) in enumerate(zip(outs, refs)):
        assert a.tobytes() == a_ref[0].tobytes(), i
        assert set(ex) == set(ex_ref), i
        for k, v in ex_ref.items():
            assert ex[k].tobytes() == v[0].tobytes(), (i, k)


# -- parity with the reference --------------------------------------------------------


def _ref_policy(seed=7):
    import jax

    from ray_tpu import sharding as sharding_lib
    from ray_tpu.algorithms.ppo.ppo import PPOConfig as RefPPOConfig, PPOJaxPolicy
    import gymnasium as gym

    cfg = RefPPOConfig().to_dict()
    cfg.update(seed=seed, num_workers=0, train_batch_size=64, sgd_minibatch_size=32,
               num_sgd_iter=1, lr=3e-4, model={"fcnet_hiddens": [16, 16]},
               _mesh=sharding_lib.get_mesh(devices=jax.devices()[:1]))
    return PPOJaxPolicy(gym.spaces.Box(-1.0, 1.0, (4,), np.float32), gym.spaces.Discrete(2), cfg)


def test_greedy_parity_with_the_reference_server():
    from ray_tpu.serve.policy_server import BatchedPolicyServer as RefServer

    ref_pol = _ref_policy()
    port_pol = _ppo()
    from_jax_policy_weights({"default_policy": ref_pol.get_weights()},
                            {"default_policy": port_pol})
    obs = _obs(24, seed=3)
    ref = RefServer(ref_pol, max_batch_size=8, explore=False, start=False)
    ref.warmup()
    port = _server(port_pol, explore=False)
    # the same splits on both: 1, 3, 8, 5, 7 rows
    i = 0
    for n in (1, 3, 8, 5, 7):
        a_ref, ex_ref = ref.forward_padded(obs[i:i + n], explore=False)
        a, ex = port.forward_padded(obs[i:i + n], explore=False)
        i += n
        np.testing.assert_array_equal(a, np.asarray(a_ref))
        assert set(ex) == set(ex_ref)
        for k, v in ex_ref.items():
            np.testing.assert_allclose(ex[k], np.asarray(v), rtol=RTOL, atol=ATOL, err_msg=k)
    ref.stop()


def test_reference_checkpoint_restores_alike_in_both_packages(tmp_path):
    import jax

    from ray_tpu import sharding as sharding_lib
    from ray_tpu.algorithms.ppo import PPOConfig as RefPPOConfig
    from ray_tpu.serve.policy_server import restore_policy as ref_restore

    algo = (RefPPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, rollout_fragment_length=64)
            .training(train_batch_size=64, sgd_minibatch_size=32, num_sgd_iter=1,
                      model={"fcnet_hiddens": [16, 16]})
            .debugging(seed=1).resources(learner_devices=1))
    algo.observation_filter = "MeanStdFilter"
    algo = algo.build()
    try:
        algo.train()
        root = str(tmp_path / "ckpts")
        algo.save(os.path.join(root, "checkpoint_000001"))
    finally:
        algo.cleanup()
    r_pol, _, r_filt, r_info = ref_restore(
        root, mesh=sharding_lib.get_mesh(devices=jax.devices()[:1]))
    p_pol, _, p_filt, p_info = restore_policy(root, device="cpu")
    assert p_info["checkpoint"] == r_info["checkpoint"]
    assert p_info["algorithm"] == r_info["algorithm"] == "PPO"
    for name in ("rs", "buffer"):
        x, y = getattr(r_filt, name), getattr(p_filt, name)
        assert x.num == y.num > 0
        assert np.asarray(x.mean_).tobytes() == y.mean_.tobytes()
        assert np.asarray(x.s).tobytes() == y.s.tobytes()
    raw = np.random.default_rng(4).uniform(-0.3, 0.3, (32, 4)).astype(np.float32)
    for o in raw:
        fo = p_filt(o, update=False)
        assert fo.tobytes() == np.asarray(r_filt(o, update=False), np.float32).tobytes()
        a, _, ex = p_pol.compute_actions(fo[None], explore=False)
        a_ref, _, ex_ref = r_pol.compute_actions(fo[None], explore=False)
        assert int(a[0]) == int(np.asarray(a_ref)[0])
        np.testing.assert_allclose(ex["action_dist_inputs"], np.asarray(ex_ref["action_dist_inputs"]),
                                   rtol=RTOL, atol=ATOL)


# -- the explore contract ---------------------------------------------------------------


@pytest.mark.parametrize("make", [_ppo, _dqn], ids=["ppo_categorical", "dqn_epsilon_greedy"])
@pytest.mark.parametrize("splits", [[13], [1] * 13, [5, 3, 5], [8, 1, 4], [2, 7, 2, 2]],
                         ids=lambda s: "-".join(map(str, s)))
def test_explore_stream_is_bitwise_sequential_under_any_split(make, splits):
    """Exact mode: each split of the same 13 requests equals 13
    sequential batch-1 compute_actions on a policy of the same seed."""
    obs = _obs(13, seed=11)
    refs = _sequential(make(), obs, explore=True)
    server = _server(make(), max_batch_size=8 if max(splits) <= 8 else 16, explore=True)
    outs, i = [], 0
    for n in splits:
        a, ex = server.forward_padded(obs[i:i + n], explore=True)
        outs += [(a[j], {k: v[j] for k, v in ex.items()}) for j in range(n)]
        i += n
    refs = [(a, s, ex) for a, s, ex in refs]
    _assert_bitwise([(np.asarray(a), {k: np.asarray(v) for k, v in ex.items()}) for a, ex in outs],
                    refs)


def test_explore_stream_through_the_batcher_thread():
    """submit() from the caller, batches cut by the batcher's timeout:
    still the sequential stream, and fewer batches than requests."""
    obs = _obs(13, seed=12)
    refs = _sequential(_ppo(), obs, explore=True)
    server = _server(_ppo(), batch_wait_timeout_s=0.005, explore=True)
    server.start()
    try:
        futs = [server.submit(o) for o in obs]
        outs = [f.result(30.0) for f in futs]
    finally:
        server.stop()
    _assert_bitwise(outs, refs)
    assert server.batches_total < len(obs)


@pytest.mark.parametrize("make", [_ppo, _dqn], ids=["ppo", "dqn"])
def test_warmup_leaves_the_generator_untouched(make):
    policy = make()
    before = policy.action_generator.get_state().clone()
    server = BatchedPolicyServer(policy, max_batch_size=8, explore=True, start=False)
    assert server.warmup() == 4
    server.warmup(explore=False)
    assert torch.equal(policy.action_generator.get_state(), before)
    assert server.captures == 8


def test_no_program_built_after_warmup_at_any_occupancy():
    server = _server(_ppo(), batch_wait_timeout_s=0.001, explore=True)
    assert server.stats()["captures"] == 4
    server.start()
    try:
        for n in (1, 2, 3, 5, 8, 8, 4, 1, 7, 6):
            acts, _ = server.compute_actions(_obs(n, seed=n))
            assert acts.shape[0] == n
    finally:
        server.stop()
    st = server.stats()
    assert st["captures"] == 4 and st["captures_after_warmup"] == 0


def test_vectorized_mode_within_tolerance_of_exact():
    obs = _obs(32, seed=5)
    exact = _server(_ppo(), max_batch_size=32, explore=False)
    vec = _server(_ppo(), max_batch_size=32, explore=False, vectorized=True)
    for n in (32, 7):
        a_e, ex_e = exact.forward_padded(obs[:n], explore=False)
        a_v, ex_v = vec.forward_padded(obs[:n], explore=False)
        for k in ex_e:
            np.testing.assert_allclose(ex_v[k], ex_e[k], rtol=RTOL, atol=ATOL, err_msg=k)
        logits = np.sort(ex_e["action_dist_inputs"], axis=-1)
        clear = (logits[:, -1] - logits[:, -2]) > RTOL * np.abs(logits[:, -1]) + ATOL
        np.testing.assert_array_equal(a_v[clear], a_e[clear])


# -- host modules against the reference ------------------------------------------------


def test_default_buckets_and_trailing_window_equal_the_reference():
    from ray_tpu.serve import policy_server as ref

    for m in (1, 2, 3, 8, 12, 32, 33, 100):
        assert default_buckets(m) == ref.default_buckets(m)
    vals = np.random.default_rng(1).uniform(0.0, 1.0, 101)
    now = time.perf_counter()
    mine, theirs = TrailingWindow(30.0), ref.TrailingWindow(30.0)
    for i, v in enumerate(vals):
        t = now - 40.0 if i < 10 else now - 1.0  # the first ten decayed out
        mine.observe(float(v), t=t)
        theirs.observe(float(v), t=t)
    assert mine.snapshot() == theirs.snapshot()
    assert mine.snapshot()["n"] == 91
    for q in (0, 50, 90, 99, 100):
        assert mine.pct(q) == theirs.pct(q)
    assert TrailingWindow(0.01).pct(50) is None


def test_discovery_equals_the_reference_on_periodic_roots(tmp_path):
    from ray_tpu.resilience import discovery as ref

    root = str(tmp_path)
    assert discovery.discover(root) == ref.discover(root) == ("checkpoint", None)
    assert discovery.latest_periodic(str(tmp_path / "missing")) is None
    for it in (2, 10, 3):
        os.makedirs(os.path.join(root, f"checkpoint_{it:06d}"))
        assert discovery.discover(root) == ref.discover(root)
        assert discovery.latest_periodic(root) == ref.latest_periodic(root)
    latest = discovery.latest_periodic(root)
    assert latest.endswith("checkpoint_000010")
    assert discovery.target_version("checkpoint", latest) == ref.target_version(
        "checkpoint", latest) == (10, 0)
    for p in (latest, "x/checkpoint_abc", None):
        assert discovery.periodic_iteration(p) == ref.periodic_iteration(p)
    with pytest.raises(ValueError):
        discovery.target_version("checkpoint", "x/checkpoint_abc")
    # a stream tail is the reference's streamer's: the port refuses it
    os.makedirs(os.path.join(root, "stream"))
    with pytest.raises(NotImplementedError, match="item 3d"):
        discovery.discover(root)


def test_provider_notice_probe(tmp_path, monkeypatch):
    for env in (provider_notice.NOTICE_ENV, provider_notice.NOTICE_FILE_ENV,
                provider_notice.NOTICE_DIR_ENV):
        monkeypatch.delenv(env, raising=False)
    assert provider_notice.probe() is None
    monkeypatch.setenv(provider_notice.NOTICE_ENV, "12.5")
    assert provider_notice.probe() == 12.5
    monkeypatch.delenv(provider_notice.NOTICE_ENV)
    notice = tmp_path / "notice"
    monkeypatch.setenv(provider_notice.NOTICE_FILE_ENV, str(notice))
    assert provider_notice.probe() is None
    notice.write_text("3.0")
    assert provider_notice.probe() == 3.0
    notice.write_text("")
    assert provider_notice.probe() == 0.0
    assert PolicyDeployment.preemption_notice(object.__new__(PolicyDeployment)) == 0.0
    monkeypatch.delenv(provider_notice.NOTICE_FILE_ENV)
    monkeypatch.setenv(provider_notice.NOTICE_DIR_ENV, str(tmp_path))
    (tmp_path / "host1").write_text("7")
    assert provider_notice.probe(host="host1") == 7.0
    assert provider_notice.probe(host="host2") is None


# -- the serve contracts ---------------------------------------------------------------


def test_timeout_flush_and_full_bucket_flush():
    server = BatchedPolicyServer(_ppo(), max_batch_size=4, batch_wait_timeout_s=0.25)
    try:
        t0 = time.perf_counter()
        for f in [server.submit(o) for o in _obs(3)]:
            f.result(30.0)
        # a partial batch: one flush, after the wait window
        assert server.batches_total == 1 and server.batch_rows_total == 3
        assert time.perf_counter() - t0 >= 0.2
        # a full bucket flushes at once
        t0 = time.perf_counter()
        for f in [server.submit(o) for o in _obs(4, seed=1)]:
            f.result(30.0)
        assert time.perf_counter() - t0 < 0.2
        assert server.batches_total == 2
    finally:
        server.stop()


def test_batch_fill_fraction_and_queue_wait_observability():
    server = BatchedPolicyServer(_ppo(), max_batch_size=4, batch_wait_timeout_s=0.05)
    try:
        for f in [server.submit(o) for o in _obs(3)]:
            f.result(30.0)
        st = server.stats()
        assert st["batch_fill_fraction"] == pytest.approx(3 / 4)
        assert st["queue_wait_p50_s"] is not None
        assert server.queue_wait_window()["n"] == 3
        assert st["device"] is None  # a CPU policy reports no device memory
        for f in [server.submit(o) for o in _obs(4, seed=1)]:
            f.result(30.0)
        st = server.stats()
        assert st["batch_fill_fraction"] == pytest.approx(7 / 8)
        assert st["mean_batch_rows"] == pytest.approx(3.5)
        assert st["padded_rows_total"] == 1
    finally:
        server.stop()


def test_device_summary_honours_the_headroom_override(monkeypatch):
    from ray_tpu_torch.serve.policy_server import device_ledger_summary

    monkeypatch.setenv("RAY_TPU_HBM_HEADROOM", "0.33")
    assert device_ledger_summary("cpu") == {"mfu": None, "hbm_headroom": pytest.approx(0.33)}
    monkeypatch.delenv("RAY_TPU_HBM_HEADROOM")
    assert device_ledger_summary("cpu") is None


def test_hot_reload_mid_traffic_no_drops_no_blends():
    """Every response is entirely one version's output, versions are
    monotone in FIFO order, nothing is dropped, and the reload writes
    into the parameters the programs read (their storage is kept)."""
    policy = _ppo()
    w1 = policy.get_weights()
    w2 = {k: -v for k, v in w1.items()}
    obs = _obs(120, seed=9)
    ref = _ppo()
    exp1 = _sequential(ref, obs, explore=False)
    ref.set_weights(w2)
    exp2 = _sequential(ref, obs, explore=False)
    ptrs = [p.data_ptr() for p in policy.params]

    server = _server(policy, max_batch_size=4, batch_wait_timeout_s=0.001, explore=False)
    server.start()
    futs = []
    try:
        for i, o in enumerate(obs):
            futs.append(server.submit(o))
            if i == 40:
                futs[7].result(30.0)
                server.update_params({"weights": w2})
            if i % 16 == 0:
                time.sleep(0.002)
        outs = [f.result(60.0) for f in futs]
    finally:
        server.stop()
    versions = [f.params_version for f in futs]
    assert versions == sorted(versions)
    assert versions[0] == 1 and versions[-1] == 2
    for i, (a, ex) in enumerate(outs):
        exp = exp1[i] if versions[i] == 1 else exp2[i]
        assert a.tobytes() == exp[0][0].tobytes(), i
        assert ex["action_logp"].tobytes() == exp[2]["action_logp"][0].tobytes(), i
    assert [p.data_ptr() for p in policy.params] == ptrs
    assert server.stats()["captures_after_warmup"] == 0


def test_refusals_name_their_roadmap_items(tmp_path):
    with pytest.raises(NotImplementedError, match="item 6.3"):
        BatchedPolicyServer(_ppo(), aot_cache=str(tmp_path), start=False)
    os.makedirs(tmp_path / "stream")
    with pytest.raises(NotImplementedError, match="item 3d"):
        discovery.latest_stream_tail(str(tmp_path))

    recurrent = PPOTorchPolicy(OBS, ACT, {**PPOConfig().to_dict(), "model": {
        "use_lstm": True, "lstm_cell_size": 8, "fcnet_hiddens": [8]}}, device="cpu")
    assert not recurrent.supports_batched_serve
    server = BatchedPolicyServer(recurrent, start=False)
    assert not server.fused and server.warmup() == 0 and server.captures == 0


def test_restore_policy_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    algo = (PPOConfig().environment("CartPole-v1").rollouts(num_rollout_workers=0)
            .training(train_batch_size=64, model={"fcnet_hiddens": [8]})
            .resources(device="cpu").build())
    try:
        path = algo.save(str(tmp_path / "checkpoint_000001"))
    finally:
        algo.stop()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore_policy(path)
    with pytest.raises(ValueError, match="no checkpoint"):
        restore_policy(str(tmp_path / "empty"), device="cpu")


# -- the closed loop -------------------------------------------------------------------


def test_train_save_serve_hot_reload_cartpole(tmp_path):
    """train → checkpoint → serve → train more → the watcher reloads:
    the replica ends up with the trainer's exact weights, and answers
    with the new version."""
    algo = (PPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, rollout_fragment_length=32)
            .training(train_batch_size=128, sgd_minibatch_size=64, num_sgd_iter=2,
                      model={"fcnet_hiddens": [16, 16]})
            .debugging(seed=3).resources(device="cpu").build())
    root = str(tmp_path / "ckpts")
    try:
        algo.train()
        algo.save(os.path.join(root, "checkpoint_000001"))
        dep = PolicyDeployment(root, name="cartpole", max_batch_size=4,
                               batch_wait_timeout_s=0.005, poll_interval_s=0.1, device="cpu")
        try:
            obs = [0.01, 0.02, 0.03, 0.04]
            out = dep({"obs": obs})
            assert out["params_version"] == 1 and out["action"] in (0, 1)
            assert "logp" in out
            ptrs = [p.data_ptr() for p in dep.server.policy.params]
            algo.train()
            algo.save(os.path.join(root, "checkpoint_000002"))
            deadline = time.time() + 30
            while time.time() < deadline and dep.server.params_version < 2:
                time.sleep(0.05)
            out2 = dep({"obs": obs})
            assert out2["params_version"] == 2
            assert dep.watcher.num_reloads == 1
            served = dep.server.policy.get_weights()
            for k, v in algo.get_policy().get_weights().items():
                assert served[k].tobytes() == v.tobytes(), k
            assert [p.data_ptr() for p in dep.server.policy.params] == ptrs
            rows = dep.handle_rows([obs, obs], explore=False)
            assert [r["params_version"] for r in rows] == [2, 2]
            assert rows[0]["action"] == out2["action"]
            st = dep.stats()
            assert st["requests_total"] >= 4
            assert st["latency_p50_s"] is not None
            assert st["reload"]["num_reloads"] == 1
            assert st["checkpoint_root"] == root
            # a pushed checkpoint (reconfigure) reloads at once
            dep.reconfigure({"checkpoint": os.path.join(root, "checkpoint_000001")})
            deadline = time.time() + 30
            while time.time() < deadline and dep.server.params_version < 3:
                time.sleep(0.05)
            assert dep({"obs": obs})["params_version"] == 3
        finally:
            dep.stop()
    finally:
        algo.stop()


def test_watcher_skips_torn_and_older_targets(tmp_path):
    from ray_tpu_torch.serve.policy_server import CheckpointWatcher

    applied = []
    root = str(tmp_path)
    w = CheckpointWatcher(root, lambda s, i: applied.append(i["version"]), start=False,
                          initial_version=(1, 0))
    assert not w.poll_once()  # nothing there
    os.makedirs(os.path.join(root, "checkpoint_000001"))
    with open(os.path.join(root, "checkpoint_000001", "algorithm_state.pkl"), "wb") as f:
        pickle.dump({"worker": {"policy_states": {"default_policy": {}}}}, f)
    assert not w.poll_once()  # not newer than what was loaded
    os.makedirs(os.path.join(root, "checkpoint_000002"))
    with open(os.path.join(root, "checkpoint_000002", "algorithm_state.pkl"), "wb") as f:
        f.write(b"torn")
    assert not w.poll_once()  # torn: retried next round
    with open(os.path.join(root, "checkpoint_000002", "algorithm_state.pkl"), "wb") as f:
        pickle.dump({"worker": {"policy_states": {"default_policy": {"weights": {}}}}}, f)
    assert w.poll_once()
    assert applied == [(2, 0)] and w.stats()["num_reloads"] == 1


def test_torso_policy_exact_and_vectorized_on_the_cpu():
    """A transformer-torso policy (the flash kernel's plain version on
    the CPU): exact mode bitwise against sequential calls, exploring;
    vectorized mode within 1e-5 relative of it, greedy."""
    torso = {"use_transformer": True, "transformer_dim": 64, "transformer_num_layers": 2,
             "transformer_num_heads": 2, "transformer_ff_dim": 128, "transformer_seq_len": 8}

    def make():
        cfg = PPOConfig().to_dict()
        cfg.update(seed=5, model=torso)
        return PPOTorchPolicy(Box(-1, 1, (16,), np.float32), Discrete(5), cfg, device="cpu")

    obs = np.random.default_rng(2).uniform(-1, 1, (11, 16)).astype(np.float32)
    refs = _sequential(make(), obs, explore=True)
    server = _server(make(), explore=True)
    outs, i = [], 0
    for n in (4, 7):
        a, ex = server.forward_padded(obs[i:i + n], explore=True)
        outs += [(a[j], {k: v[j] for k, v in ex.items()}) for j in range(n)]
        i += n
    _assert_bitwise(outs, refs)
    exact = _server(make(), explore=False)
    vec = _server(make(), explore=False, vectorized=True)
    _, ex_e = exact.forward_padded(obs[:8], explore=False)
    _, ex_v = vec.forward_padded(obs[:8], explore=False)
    for k in ex_e:
        np.testing.assert_allclose(ex_v[k], ex_e[k], rtol=RTOL, atol=ATOL, err_msg=k)
