"""The port's device ledger (``ray_tpu_torch/telemetry/device.py``) on
the CPU, against the reference's (``ray_tpu/telemetry/device.py``).

- ``signature_of``, ``diff_signatures`` and ``cause_string`` on numpy
  leaves (nested dicts, lists, namedtuples, None, scalars, statics):
  equal to the reference's;
- ``snapshot()``'s keys, its totals' and a program row's: the
  reference's, the reference's row built by its ``sharded_jit``;
- a labelled ``SuperstepRunner``: its first run is the analysis call
  (a trace, its first slot counted), later runs are executions; a
  second runner of the label at a new shape records the recompile
  cause, and the recompile event rides the trace;
- the counting mode's FLOPs and bytes against hand counts, and the
  kernel wrappers' formulas (``band_pairs``) against a mask count;
- the device lanes and the report CLI over a trace and a ledger dump;
- params after two ``train()`` calls bitwise with telemetry and a
  ``torch.profiler`` capture on, and with them off (the device lane,
  K = 2, and the eager learn nest on the actor lane);
- off: nothing recorded.
"""

import collections
import json

import numpy as np
import pytest
import torch

from ray_tpu.telemetry import device as ref_ledger
from ray_tpu_torch import telemetry
from ray_tpu_torch.sharding.superstep import SuperstepRunner
from ray_tpu_torch.telemetry import device as device_ledger
from ray_tpu_torch.util import tracing


@pytest.fixture(autouse=True)
def _clean():
    torch.set_num_threads(1)
    for led in (device_ledger, ref_ledger):
        led.enable(analyze=True)  # a light ledger's setting outlives it
        led.disable()
        led.clear()
    tracing.disable()
    tracing.clear()
    yield
    rt = telemetry.runtime()
    if rt is not None:
        rt.shutdown()
    for led in (device_ledger, ref_ledger):
        led.disable()
        led.clear()
    device_ledger.set_peak_flops(None)
    tracing.disable()
    tracing.clear()


NT = collections.namedtuple("NT", "obs extra")

TREES = [
    (({"obs": np.zeros((4, 8), np.float32)},), {}),
    (({"obs": np.zeros((4, 8), np.float32), "extra": np.zeros((4,), np.float32)},), {}),
    (({"obs": np.zeros((8, 8), np.float32)},), {}),
    (({"obs": np.zeros((4, 8), np.int32)},), {}),
    (([np.zeros(3, np.int64), None, 3, np.zeros((), np.bool_)], NT(np.zeros(1), 2.0)),
     {"k": np.zeros(2, np.uint8), "b": 1}),
    (((np.float32(1.0), "abc", {3: 1, 1: (2,)}, (), {}),), {"b": 2}),
]


def test_signatures_diffs_and_causes_equal_the_reference():
    statics = ("b",)
    sigs = []
    for args, kwargs in TREES:
        port = device_ledger.signature_of(args, kwargs, statics)
        assert port == ref_ledger.signature_of(args, kwargs, statics)
        sigs.append(port)
    for a in sigs:
        for b in sigs:
            diff = device_ledger.diff_signatures(a, b)
            assert diff == ref_ledger.diff_signatures(a, b)
            for limit in (1, 6):
                assert device_ledger.cause_string(diff, limit) == ref_ledger.cause_string(diff, limit)
    cause = device_ledger.cause_string(device_ledger.diff_signatures(sigs[0], sigs[2]))
    assert cause == "[0][0]['obs']: float32[4,8] -> float32[8,8]"
    # a torch leaf reads as the numpy leaf of its dtype
    t = device_ledger.signature_of(({"obs": torch.zeros(4, 8)},), {})
    assert t == sigs[0]


def _ref_snapshot():
    from ray_tpu.sharding.compile import sharded_jit

    ref_ledger.enable(analyze=True)
    fn = sharded_jit(lambda x: (x @ x.T).sum(), label="keys_probe")
    for _ in range(3):
        fn(np.ones((8, 8), np.float32))
    ref_ledger.drain_point()
    return ref_ledger.snapshot()


def _runner(label, width=4, k_max=2):
    w = torch.ones((width, width), requires_grad=True)
    runner = SuperstepRunner("cpu", k_max, None, label=label)
    runner.stacked = {"x": torch.arange(k_max * width * width, dtype=torch.float32)
                      .reshape(k_max, width, width) / 10}

    def slot(r):
        x = r.stacked["x"].index_select(0, r.slot)[0]
        loss = (x @ w).relu().sum()
        (g,) = torch.autograd.grad(loss, w)
        with torch.no_grad():
            w.sub_(0.01 * g)
        r.write("loss", loss.detach().reshape(1))

    runner.slot_fn = slot
    runner.sig_inputs = {"params": [w]}
    return runner, w


def test_snapshot_keys_are_the_reference():
    ref = _ref_snapshot()
    device_ledger.enable()
    runner, _ = _runner("superstep[Probe:4x2]")
    for _ in range(3):
        runner.run(2)
    port = device_ledger.snapshot()
    assert set(port) == set(ref)
    assert set(port["totals"]) == set(ref["totals"])
    (row,) = port["programs"]
    (ref_row,) = ref["programs"]
    assert set(row) == set(ref_row)
    assert set(row["memory"]) == set(ref_row["memory"])
    assert port["device_kind"] == "cpu" and port["analyzed"] is True


def test_runner_ledger_trace_executions_cost_and_recompile():
    device_ledger.enable()
    tracing.enable()
    device_ledger.set_peak_flops(1e9)
    runner, _ = _runner("superstep[Probe:4x2]")
    for k in (2, 1, 2):
        out = runner.run(k)
        assert out["loss"].shape == (k, 1)
    assert runner.runs == 3 and runner.captures == 1
    (row,) = device_ledger.snapshot()["programs"]
    assert row["traces"] == 1 and row["recompiles"] == 0 and row["executions"] == 2
    assert row["device_time_s"] > 0 and row["compile_time_s"] > 0
    # one slot: x @ w (2·4·4·4), its gradient (2·4·4·4), and nothing else
    # multiplies; a run of k slots costs k slots: (1 + 2) / 2 a run
    assert row["flops"] == pytest.approx(256 * 1.5)
    assert row["bytes_accessed"] > 0
    assert row["mfu"] == pytest.approx(256 * 3 / (row["device_time_s"] * 1e9), rel=1e-3)
    assert row["memory"]["argument_bytes"] == 2 * 16 * 4 + 8  # stacked + slot (no perms)
    assert row["memory"]["output_bytes"] == 2 * 4 and row["memory"]["temp_bytes"] is None
    # a second runner of the label at a new shape: a recompile with its cause
    other, _ = _runner("superstep[Probe:4x2]", width=6)
    other.run(1)
    snap = device_ledger.snapshot()
    (row,) = snap["programs"]
    assert row["traces"] == 2 and row["recompiles"] == 1
    cause = row["recompile_causes"][0]
    assert "float32[2,4,4] -> float32[2,6,6]" in cause and "float32[4,4] -> float32[6,6]" in cause
    assert snap["recompile_causes"] == {"superstep[Probe:4x2]": [{"cause": cause, "count": 1}]}
    events = [s for s in tracing.get_spans() if s["name"] == "jit:recompile"]
    assert [e["attributes"] for e in events] == [{"label": "superstep[Probe:4x2]", "cause": cause}]
    lanes = [s for s in tracing.get_spans() if s["name"] == "device:superstep[Probe:4x2]"]
    assert len(lanes) == 2 and all(s["end"] >= s["start"] for s in lanes)
    assert len({s["tid"] for s in lanes}) == 1


def test_light_ledger_counts_nothing_and_off_is_inert():
    runner, _ = _runner("superstep[Off:4x2]")
    runner.run(2)
    runner.run(2)
    assert device_ledger.snapshot()["programs"] == []
    device_ledger.enable(analyze=False)
    light, _ = _runner("superstep[Light:4x2]")
    light.run(2)
    light.run(2)
    (row,) = device_ledger.snapshot()["programs"]
    assert row["executions"] == 1 and row["flops"] is None and row["mfu"] is None
    device_ledger.set_peak_flops(123.0)
    assert device_ledger.peak_flops_per_device() == 123.0


def test_counting_mode_and_kernel_formulas():
    device_ledger.enable()
    a = torch.ones(8, 16)
    b = torch.ones(16, 4)
    with device_ledger.count_costs() as cost:
        y = a @ b
        y.view(-1)  # a view moves nothing
        assert device_ledger.counting()
        device_ledger.add_kernel_cost(10, 20)
    assert not device_ledger.counting()
    device_ledger.add_kernel_cost(1e9, 1e9)  # outside a count: nothing
    assert cost.flops == 2 * 8 * 16 * 4 + 10
    assert cost.bytes == a.nbytes + b.nbytes + y.nbytes + 20
    assert torch.equal(y, torch.full((8, 4), 16.0))
    for t, s, off in ((8, 8, None), (8, 8, 0), (5, 9, 2), (4, 4, -2), (3, 50, 100)):
        i = np.arange(t)[:, None]
        j = np.arange(s)[None, :]
        want = t * s if off is None else int((j <= i + off).sum())
        assert device_ledger.band_pairs(t, s, off) == want


def test_device_lanes_and_report_cli(tmp_path, capsys):
    from ray_tpu_torch.telemetry import report

    device_ledger.enable()
    tracing.enable()
    with tracing.start_span("train:iteration"):
        runner, _ = _runner("superstep[Report:4x2]")
        for _ in range(3):
            runner.run(2)
        other, _ = _runner("superstep[Report:4x2]", width=5)
        other.run(1)
    trace = tracing.export_chrome_trace(str(tmp_path / "trace.json"))
    ledger = device_ledger.dump(str(tmp_path / "ledger.json"))
    events = json.load(open(trace))["traceEvents"]
    lanes = {e["args"]["name"] for e in events if e["ph"] == "M"}
    assert "device:superstep[Report:4x2]" in lanes
    assert report.main([trace, "--ledger", ledger]) == 0
    text = capsys.readouterr().out
    assert "top programs by device time" in text and "superstep[Report:4x2]" in text
    assert "float32[2,4,4] -> float32[2,5,5]" in text
    assert report.main([trace, "--ledger", ledger, "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["programs"][0]["label"] == "superstep[Report:4x2]"
    assert rep["programs"][0]["executions"] == 2 and rep["programs"][0]["flops"] > 0
    assert rep["recompiles"][0]["label"] == "superstep[Report:4x2]"


def _lane_ppo(telemetry_on: bool, tmp_path):
    from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig

    cfg = PPOConfig().environment("CartPoleJax-v0", env_backend="jax")
    cfg.rollouts(num_rollout_workers=0, num_envs_per_worker=4, rollout_fragment_length=8)
    cfg.training(train_batch_size=32, sgd_minibatch_size=16, num_sgd_iter=2, lr=3e-4,
                 superstep=2, model={"fcnet_hiddens": [16], "dtype": "float32"})
    if telemetry_on:
        cfg.telemetry(trace=True, device_ledger=True, profile_iters=1)
    algo = cfg.debugging(seed=3).resources(device="cpu").build()
    algo._logdir = str(tmp_path)
    results = [algo.train() for _ in range(2)]
    params = [p.detach().clone() for p in algo.get_policy().params]
    algo.stop()
    return results, params


def _actor_ppo(telemetry_on: bool):
    from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig

    cfg = PPOConfig().environment("CartPole-v1").rollouts(num_rollout_workers=0,
                                                          rollout_fragment_length=32)
    cfg.training(train_batch_size=32, sgd_minibatch_size=16, num_sgd_iter=2,
                 model={"fcnet_hiddens": [16], "dtype": "float32"})
    if telemetry_on:
        cfg.telemetry(trace=True)
    algo = cfg.debugging(seed=3).resources(device="cpu").build()
    results = [algo.train() for _ in range(2)]
    params = [p.detach().clone() for p in algo.get_policy().params]
    algo.stop()
    return results, params


def test_params_bitwise_with_telemetry_on_and_off(tmp_path):
    _, off = _lane_ppo(False, tmp_path)
    assert not tracing.is_enabled() and not device_ledger.enabled()
    results, on = _lane_ppo(True, tmp_path)
    assert all(torch.equal(a, b) for a, b in zip(on, off))
    assert (tmp_path / "torch_profile" / "trace.json").exists()
    ledger = results[-1]["info"]["device_ledger"]
    lane = next(p for p in ledger["programs"] if p["label"].startswith("rollout_superstep["))
    assert lane["label"] == "rollout_superstep[PPOTorchPolicy:32x2]"
    assert lane["traces"] == 1 and lane["executions"] == 1 and lane["flops"] > 0
    tel = results[-1]["info"]["telemetry"]
    assert tel["superstep"]["updates"] == 2 and tel["rollout_lane"]["backend"] == "jax"
    assert tel["device_s"] > 0 and tel["learn_s"] > 0
    telemetry.runtime().shutdown()
    device_ledger.clear()

    _, off = _actor_ppo(False)
    results, on = _actor_ppo(True)
    assert all(torch.equal(a, b) for a, b in zip(on, off))
    labels = {p["label"] for p in results[-1]["info"]["device_ledger"]["programs"]}
    assert {"learn[PPOTorchPolicy:32]", "act[PPOTorchPolicy:1]"} <= labels
