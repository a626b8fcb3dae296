"""The resilience layer of the port (``ray_tpu_torch/resilience``) held
against the reference's (``ray_tpu/resilience``), on the CPU.

- ``RetryPolicy``: ``schedule()`` and ``delay()`` bitwise the reference's
  over a table of policies (seeded jitter included), and ``call``'s
  retry, exhaustion and non-retryable paths;
- ``_parse_env_spec``: equal dicts over a table of spec strings; the
  injector fires once, at the same calls, as the reference's (learn
  calls, learner-thread steps, sample calls); ``_corrupt`` poisons the
  same column and leaves a uint8 frame pool clean; the KV family raises,
  naming item 7;
- the ``RecoveryManager``'s bookkeeping equals the reference's over one
  sequence of failures (worker deaths, restores, skipped batches,
  preemptions, the budget);
- the nan guard: a poisoned learn batch leaves the parameters and Adam
  moments bitwise unchanged on the host path (``train_one_step``) and in
  a superstep slot (the slot's masked no-op, eager on the CPU), and
  without the guard the poison spreads;
- periodic checkpoints: an injected crash restores the newest one, the
  others are pruned to ``keep_checkpoints_num``; with none yet, the
  crash propagates;
- chaos PPO: CartPole-v1 with 4 remote workers, 2 of them killed and one
  NaN batch; the run finishes, the fleet is back to 4, the replacements
  do not die, no ``/dev/shm`` payload is left after ``shutdown``, and
  ``info/recovery`` holds the counts the reference's run of the same spec
  reports (its live run, whose workers each start JAX, is the ``-m slow``
  twin below).
"""

from __future__ import annotations

import os
import random

import numpy as np
import pytest
import torch

from _torch_actor_probe import device_report
from ray_tpu.resilience import faults as ref_faults
from ray_tpu.resilience import recovery as ref_recovery
from ray_tpu.resilience import retry as ref_retry
from ray_tpu_torch import core
from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig, PPOTorchPolicy
from ray_tpu_torch.core import object_store
from ray_tpu_torch.data.sample_batch import SampleBatch
from ray_tpu_torch.env.spaces import Box, Discrete
from ray_tpu_torch.resilience import (
    FaultInjector,
    InjectedCrash,
    RecoveryManager,
    RetryPolicy,
    batch_is_finite,
)
from ray_tpu_torch.resilience.faults import _parse_env_spec


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU learns: beside
    other test processes on the same cores, torch's thread pool spins
    for far longer than these learns compute."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- RetryPolicy ---------------------------------------------------------------

RETRY_TABLE = [
    dict(max_attempts=5, backoff_s=0.1, backoff_mult=2.0, max_backoff_s=0.5, jitter=0.0),
    dict(max_attempts=3, backoff_s=0.1, jitter=0.5, seed=7),
    dict(max_attempts=6, backoff_s=0.05, backoff_mult=3.0, max_backoff_s=2.0, jitter=0.1, seed=0),
    dict(max_attempts=1, seed=3),
    dict(),
]


@pytest.mark.parametrize("kw", RETRY_TABLE)
def test_retry_schedule_and_delay_match_reference(kw):
    mine, theirs = RetryPolicy(**kw), ref_retry.RetryPolicy(**kw)
    if kw.get("seed") is not None or kw.get("jitter") == 0.0:
        assert mine.schedule() == theirs.schedule()
        assert mine.schedule() == mine.schedule()  # seeded: repeatable
    for attempt in range(4):
        assert mine.delay(attempt, random.Random(11)) == theirs.delay(attempt, random.Random(11))
    cfg = {"retry_max_attempts": 4, "retry_timeout_s": 3.0, "retry_backoff_s": 0.2,
           "retry_jitter": 0.3, "seed": 5}
    assert (RetryPolicy.from_config(cfg).schedule()
            == ref_retry.RetryPolicy.from_config(cfg).schedule())


def test_retry_call_retries_then_succeeds_then_raises():
    p = RetryPolicy(max_attempts=3, backoff_s=0.001, jitter=0.0)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise TimeoutError("transient")
        return "ok"

    assert p.call(flaky) == "ok" and calls["n"] == 3
    with pytest.raises(TimeoutError):
        p.call(lambda: (_ for _ in ()).throw(TimeoutError("always")))
    calls["n"] = 0

    def fatal():
        calls["n"] += 1
        raise ValueError("bug")

    with pytest.raises(ValueError):
        p.call(fatal)
    assert calls["n"] == 1
    # the deadline bounds the whole schedule: no attempt after it
    slow = RetryPolicy(max_attempts=5, backoff_s=10.0, jitter=0.0)
    with pytest.raises(TimeoutError):
        slow.call(lambda: (_ for _ in ()).throw(TimeoutError("x")), deadline_s=1.0)


# -- the fault injector ----------------------------------------------------------

SPEC_TABLE = [
    "kill_worker:2@3,4@1;nan_batch:@2;delay_sample:1@2x0.5;crash_learner:@7",
    "preempt_worker:2@3x5,4@1;kill_worker:1@2",
    "crash_learner_thread:@4",
    "nan_batch:;crash_learner:",
    " kill_worker:3 ; ;delay_sample:2@",
    "kv_drop:put@3,@5;kv_delay:250@2;partition_host:h1@4x1.5,h2@1;kill_coordinator:@9",
    "unknown:1@2",
    "",
]


@pytest.mark.parametrize("text", SPEC_TABLE)
def test_parse_env_spec_matches_reference(text):
    assert _parse_env_spec(text) == ref_faults._parse_env_spec(text)


def _events(inj, n_learn=6, n_steps=5):
    """What an injector does over ``n_learn`` learn calls and
    ``n_steps`` learner-thread steps."""
    out = []
    for i in range(n_learn):
        b = {"adv": np.ones(4, np.float32), "t": np.arange(4)}
        try:
            inj.on_learn(b)
            out.append(("learn", i, bool(batch_is_finite(b))))
        except Exception as e:
            out.append(("learn", i, type(e).__name__))
    for i in range(n_steps):
        try:
            inj.on_learner_thread_step()
            out.append(("step", i, "ok"))
        except Exception as e:
            out.append(("step", i, type(e).__name__))
    return out


@pytest.mark.parametrize("spec", [
    {"nan_batch": {"on_learn_call": 2}, "crash_learner": {"on_learn_call": 4}},
    {"nan_batch": {"on_learn_call": 1, "value": "inf"}, "crash_learner_thread": {"on_step": 3}},
    {"crash_learner": {"on_learn_call": 1}, "crash_learner_thread": {"on_step": 1}},
])
def test_injector_fires_once_at_the_same_calls(spec):
    mine, theirs = _events(FaultInjector(spec)), _events(ref_faults.FaultInjector(spec))
    assert mine == theirs
    assert sum(e[2] == "InjectedCrash" for e in mine) == ("crash_learner" in spec) + (
        "crash_learner_thread" in spec)


def test_sample_faults_delay_and_notice_match_reference(monkeypatch):
    armed = {"mine": [], "ref": []}
    from ray_tpu_torch.resilience import faults as my_faults

    monkeypatch.setattr(my_faults, "_arm_exit_timer", lambda g: armed["mine"].append(g))
    monkeypatch.setattr(ref_faults, "_arm_exit_timer", lambda g: armed["ref"].append(g))
    slept = {"mine": [], "ref": []}
    spec = {"delay_sample": [{"worker_index": 1, "on_call": 2, "delay_s": 0.01}],
            "preempt_worker": [{"worker_index": 2, "on_call": 1, "grace_s": 300.0}]}
    for key, inj in (("mine", FaultInjector(spec)), ("ref", ref_faults.FaultInjector(spec))):
        real_sleep = ref_faults.time.sleep
        monkeypatch.setattr(ref_faults.time, "sleep", lambda s, k=key: slept[k].append(s))
        for call in (1, 2, 3, 2):
            for w in (1, 2):
                inj.on_sample(w, call)
        monkeypatch.setattr(ref_faults.time, "sleep", real_sleep)
        assert inj.preemption_notice() is not None
    assert armed["mine"] == armed["ref"] == [300.0]
    assert slept["mine"] == slept["ref"] == [0.01]


def test_corrupt_poisons_the_first_float_column_only():
    rng = np.random.default_rng(0)
    cols = {"frames": rng.integers(0, 255, (6, 8, 8, 1), dtype=np.uint8),
            "actions": np.arange(6), "advantages": rng.standard_normal(6).astype(np.float32),
            "obs": rng.standard_normal((6, 3)).astype(np.float32)}
    mine = SampleBatch({k: v.copy() for k, v in cols.items()})
    theirs = {k: v.copy() for k, v in cols.items()}
    held = mine["advantages"]
    FaultInjector._corrupt(mine, "nan")
    ref_faults.FaultInjector._corrupt(theirs, "nan")
    for k in cols:
        assert mine[k].tobytes() == theirs[k].tobytes(), k
    assert np.isnan(mine["advantages"][0]) and np.isfinite(held).all()  # a copy
    assert mine["frames"].tobytes() == cols["frames"].tobytes()


def test_the_kv_family_names_item_7(monkeypatch):
    from ray_tpu_torch.resilience import faults as my_faults

    for spec in ({"kv_drop": [{"kv_op": "", "on_call": 1}]}, {"kill_coordinator": {"on_write": 1}}):
        with pytest.raises(NotImplementedError, match="item 7"):
            FaultInjector(spec)
    monkeypatch.setenv("RAY_TPU_FAULTS", "partition_host:h@1")
    with pytest.raises(NotImplementedError, match="item 7"):
        my_faults.from_config({})
    # an empty spec disarms the variable (the replacements' config)
    assert my_faults.from_config({"fault_injection": {}}) is None
    monkeypatch.setenv("RAY_TPU_FAULTS", "nan_batch:@3")
    assert my_faults.from_config({}).spec == ref_faults.from_config({}).spec


# -- the recovery manager's bookkeeping ---------------------------------------------


class _StubWorkers:
    def __init__(self):
        self.recreated = 0

    def recreate_failed_workers(self):
        self.recreated += 1
        return 1

    def probe_unhealthy_workers(self):
        return []

    def remote_workers(self):
        return []

    def remove_workers(self, ws):
        pass


class _StubAlgo:
    def __init__(self, config, root):
        self.config = config
        self.workers = _StubWorkers()
        self.iteration = 0
        self.logdir = root
        self.hooks = []
        self.restored = []

    def on_recovery(self, kind):
        self.hooks.append(kind)

    def restore(self, path):
        self.restored.append(path)

    def save(self, path):
        os.makedirs(path, exist_ok=True)
        return path


@pytest.mark.parametrize("max_failures", [-1, 3])
def test_recovery_bookkeeping_matches_reference(tmp_path, max_failures):
    """One sequence of failures through both managers: the same
    absorb-or-raise answers, hooks, restores and ``stats()`` counts."""
    ref_dead = ref_recovery.ACTOR_DEAD_ERRORS[0]
    out = {}
    for key, mgr_cls, dead_cls in (("mine", RecoveryManager, core.RayActorError),
                                   ("ref", ref_recovery.RecoveryManager, ref_dead)):
        root = str(tmp_path / key)
        cfg = {"recreate_failed_workers": True, "max_failures": max_failures,
               "checkpoint_frequency": 2, "checkpoint_root": root, "restore_on_failure": True}
        algo = _StubAlgo(cfg, root)
        mgr = mgr_cls(algo)
        answers = [mgr.handle_failure(RuntimeError("no checkpoint yet"))]
        for it in range(4):
            mgr.begin_iteration()
            answers.append(mgr.handle_failure(dead_cls("worker died")))
            if it == 1:
                mgr.note_skipped_batch()
                mgr.note_preemption(drained=True)
            answers.append(bool(mgr.maybe_checkpoint()))
            algo.iteration += 1
        answers.append(mgr.handle_failure(InjectedCrash("crash")))
        answers.append(mgr.handle_failure(KeyboardInterrupt()))
        mgr.note_preemption(drained=False)
        stats = mgr.stats()
        stats["latest_checkpoint"] = os.path.basename(stats["latest_checkpoint"])
        for k in ("time_lost_s", "time_lost_s_this_iter"):
            stats.pop(k)
        out[key] = (answers, algo.hooks, [os.path.basename(p) for p in algo.restored], stats,
                    algo.workers.recreated)
    assert out["mine"] == out["ref"]


# -- the nan guard ------------------------------------------------------------------


def _local_ppo(**ft):
    return (PPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, rollout_fragment_length=64)
            .training(train_batch_size=128, sgd_minibatch_size=64, num_sgd_iter=2, lr=3e-4)
            .fault_tolerance(**ft).debugging(seed=1).resources(device="cpu").build())


def _learner_state(policy):
    return [t.detach().clone() for t in policy._learner_tensors()]


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_nan_guard_host_path_leaves_the_learner_bitwise():
    algo = _local_ppo(nan_guard=True, fault_injection={"nan_batch": {"on_learn_call": 2}})
    try:
        algo.train()
        before = _learner_state(algo.get_policy())
        count = algo.get_policy().opt_state.count
        r2 = algo.train()
        assert r2["info"]["recovery"]["skipped_batches"] == 1
        assert r2["info"]["num_nan_batches_skipped"] == 1
        assert _same(before, _learner_state(algo.get_policy()))
        assert algo.get_policy().opt_state.count == count
        r3 = algo.train()
        assert r3["info"]["recovery"]["skipped_batches"] == 1
        assert not _same(before, _learner_state(algo.get_policy()))
    finally:
        algo.stop()
    # without the guard the same batch drives the loss and the weights non-finite
    algo = _local_ppo(nan_guard=False, fault_injection={"nan_batch": {"on_learn_call": 1}})
    try:
        r = algo.train()
        assert not np.isfinite(r["info"]["learner"]["default_policy"]["total_loss"])
        assert not all(torch.isfinite(p).all() for p in algo.get_policy().params)
    finally:
        algo.stop()


def _sampled_batches(n):
    """``n`` CartPole-v1 train trees of 64 rows, sampled by a local PPO."""
    algo = _local_ppo()
    try:
        batches = []
        for _ in range(n):
            b = algo.workers.local_worker().sample()
            b["advantages"] = b["advantages"].astype(np.float32)
            batches.append(b)
        return batches
    finally:
        algo.stop()


@pytest.mark.parametrize("guard", [True, False])
def test_nan_guard_in_a_superstep_slot(guard):
    """The injector poisons the second host batch; stacked with the first
    into a K = 2 superstep, the guarded slot is a masked no-op: the
    parameters and moments equal one clean update's, bitwise (slot 1's
    permutations drawn and dropped, as the superstep draws them).
    Unguarded, the poison reaches the parameters."""
    batches = _sampled_batches(2)
    inj = FaultInjector({"nan_batch": {"on_learn_call": 2}})
    for b in batches:
        inj.on_learn(b)
    assert batch_is_finite(batches[0]) and not batch_is_finite(batches[1])
    cfg = {"seed": 0, "model": {"fcnet_hiddens": [16]}, "lr": 1e-2, "train_batch_size": 64,
           "sgd_minibatch_size": 32, "num_sgd_iter": 2, "kl_coeff": 0.0, "nan_guard": guard}
    obs_space, act_space = Box(-10, 10, (4,), np.float32), Discrete(2)
    p1 = PPOTorchPolicy(obs_space, act_space, cfg, device="cpu")
    p2 = PPOTorchPolicy(obs_space, act_space, cfg, device="cpu")
    trees = []
    for b in batches:
        tree, bsize = p2.prepare_batch(b)
        trees.append({c: torch.as_tensor(np.asarray(v)) for c, v in tree.items()})
    stacked = {c: torch.stack([t[c] for t in trees]) for c in trees[0]}
    infos, _, skipped = p2.learn_superstep(2, bsize, stacked=stacked)
    if not guard:
        assert skipped == [False, False]
        assert not all(torch.isfinite(p).all() for p in p2.params)
        return
    assert skipped == [False, True]
    perms = p1.draw_permutations(bsize)
    p1.learn_on_device_batch(trees[0], bsize, perms=perms)
    p1.draw_permutations(bsize)
    assert _same(_learner_state(p1)[: len(p1.params)], _learner_state(p2)[: len(p2.params)])
    assert _same(p1.opt_state.mu, p2.opt_state.mu) and _same(p1.opt_state.nu, p2.opt_state.nu)
    assert all(np.isfinite(v) for v in infos[0].values())


# -- periodic checkpoints ------------------------------------------------------------


def test_auto_restore_from_checkpoint_and_prune(tmp_path):
    root = str(tmp_path / "ckpts")
    algo = _local_ppo(checkpoint_frequency=1, checkpoint_root=root, keep_checkpoints_num=2,
                      restore_on_failure=True, max_failures=3,
                      fault_injection={"crash_learner": {"on_learn_call": 3}})
    try:
        algo.train()
        algo.train()
        saved = _learner_state(algo.get_policy())
        counters = dict(algo._counters)
        # the restore lands the checkpoint of iteration 2 in place; the
        # retried step then learns from it
        restored = []
        real = algo.restore
        algo.restore = lambda p: (real(p), restored.append(_learner_state(algo.get_policy())))
        r3 = algo.train()
        rec = r3["info"]["recovery"]
        assert rec["recoveries"] == {"restore": 1} and rec["failures"] == 1
        assert rec["time_lost_s_this_iter"] > 0.0
        assert _same(restored[0], saved)
        assert r3["info"]["num_env_steps_sampled"] == counters["num_env_steps_sampled"] + 128
        assert np.isfinite(r3["info"]["learner"]["default_policy"]["total_loss"])
        # the restore rewinds the iteration to the checkpoint's (its
        # metadata records the iteration before the one it ends, as the
        # reference's), so this iteration saves checkpoint_000002 again;
        # two are kept
        assert r3["training_iteration"] == 2
        assert sorted(d for d in os.listdir(root) if d.startswith("checkpoint_")) == [
            "checkpoint_000001", "checkpoint_000002"]
        assert os.path.isdir(rec["latest_checkpoint"])
    finally:
        algo.stop()


def test_restore_without_checkpoint_propagates():
    algo = _local_ppo(restore_on_failure=True, checkpoint_frequency=5,
                      fault_injection={"crash_learner": {"on_learn_call": 1}})
    try:
        with pytest.raises(InjectedCrash):
            algo.train()
    finally:
        algo.stop()


# -- chaos PPO ------------------------------------------------------------------------

CHAOS = {
    "kill_worker": [{"worker_index": 2, "on_call": 2}, {"worker_index": 3, "on_call": 3}],
    "nan_batch": {"on_learn_call": 2},
}
# info/recovery of the reference's run of CHAOS (test_chaos_ppo_counts_equal_the_reference_run)
REFERENCE_CHAOS_COUNTS = {"failures": 2, "worker_restarts": 2, "recoveries": {"workers": 2},
                          "skipped_batches": 1, "preemptions_drained": 0, "preemptions_lost": 0}
# both killed at one sample call, as chip_smoke.py's chaos_ppo does: one
# recovery replaces the two together
CHAOS_SAME_CALL = {
    "kill_worker": [{"worker_index": 2, "on_call": 2}, {"worker_index": 3, "on_call": 2}],
    "nan_batch": {"on_learn_call": 2},
}
REFERENCE_SAME_CALL_COUNTS = {**REFERENCE_CHAOS_COUNTS, "failures": 1, "recoveries": {"workers": 1}}


def _chaos_config(cls, spec=CHAOS):
    return (cls().environment("CartPole-v1")
            .rollouts(num_rollout_workers=4, rollout_fragment_length=32)
            .training(train_batch_size=128, sgd_minibatch_size=64, num_sgd_iter=2, lr=3e-4)
            .fault_tolerance(recreate_failed_workers=True, nan_guard=True, max_failures=10,
                             worker_health_probe_timeout_s=10.0, fault_injection=spec)
            .debugging(seed=1))


def _counts(rec):
    return {k: rec[k] for k in REFERENCE_CHAOS_COUNTS}


def _chaos_counts_of_the_port(iterations=3, spec=CHAOS):
    core.shutdown()
    algo = _chaos_config(PPOConfig, spec).resources(device="cpu").build()
    session = core.api._runtime.session
    try:
        for _ in range(iterations):
            last = algo.train()
        ws = algo.workers.remote_workers()
        # the replacements sample on (disarmed): a round more, nobody dies
        assert algo.workers.num_remote_workers() == 4
        assert algo.workers.probe_unhealthy_workers() == []
        indices = [r["worker_index"] for r in core.get([w.apply.remote(device_report) for w in ws])]
        last = algo.train()
        assert algo.workers.remote_workers() == ws
        assert np.isfinite(last["info"]["learner"]["default_policy"]["total_loss"])
        assert last["info"]["recovery"]["time_lost_s"] > 0.0
    finally:
        algo.stop()
        core.shutdown()
    # a killed worker's payloads go with the runtime's shutdown
    assert object_store.leftover_segments(session) == []
    return _counts(last["info"]["recovery"]), indices


def test_chaos_ppo_kills_two_of_four_and_a_nan_batch():
    counts, indices = _chaos_counts_of_the_port()
    assert counts == REFERENCE_CHAOS_COUNTS
    # the survivors 1 and 4, and the replacements with their dead workers'
    # indices, so that no two live workers share a seed
    assert sorted(indices[:2]) == [1, 4] and sorted(indices[2:]) == [2, 3]


@pytest.mark.slow  # the reference's run starts six JAX worker processes (about 50 s here)
@pytest.mark.parametrize("spec,want", [(CHAOS, REFERENCE_CHAOS_COUNTS),
                                       (CHAOS_SAME_CALL, REFERENCE_SAME_CALL_COUNTS)],
                         ids=["calls_2_and_3", "same_call"])
def test_chaos_ppo_counts_equal_the_reference_run(spec, want):
    import ray_tpu
    from ray_tpu.algorithms.ppo import PPOConfig as RefPPOConfig

    algo = _chaos_config(RefPPOConfig, spec).build()
    try:
        for _ in range(3):
            last = algo.train()
        assert algo.workers.num_remote_workers() == 4
    finally:
        algo.cleanup()
        ray_tpu.shutdown()
    assert _counts(last["info"]["recovery"]) == want
    assert _chaos_counts_of_the_port(spec=spec)[0] == want
