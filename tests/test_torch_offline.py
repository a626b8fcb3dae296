"""Offline data of the port against the reference's, on the CPU.

Contracts:

- the JSON format both ways, bitwise: shards of the reference's
  ``JsonWriter`` read by the port's ``JsonReader``, and the port's shards
  read by the reference's reader, for a ``SampleBatch`` and for a
  ``MultiAgentBatch`` (written as its policy batches, without their ids):
  every column's bytes and dtype;
- the reader's order: several shards (a small ``max_file_size``) read
  through both readers in the same shuffled order over two passes, the
  same ``read_all()``, a reference-style line (metadata beside plain-list
  columns), a glob;
- a PPO worker with ``output`` mirrors every ``sample()`` into its shards
  (the reference's ``test_output_config_writes_shards``, and each batch
  read back bitwise against the batch the worker returned);
- ``sample_offline_batch`` bitwise the reference's for the same reader
  and seed;
- IS and WIS estimates of a PPO policy carried from the reference's,
  within 1e-6 relative plus 1e-6 absolute on the same batch (float32
  log-likelihoods differ by a few ulp between the frameworks, then go
  through a float64 ``exp``/``cumprod``), and ``v_gain`` 1 where the
  target is the behaviour policy;
- a Data-layer dataset as input raises, naming item 9; the device lane
  refuses ``input`` and ``output``; the fault injector's KV family
  raises, naming item 7.
"""

from __future__ import annotations

import json

import gymnasium as gym
import jax
import numpy as np
import pytest

from ray_tpu.algorithms.ppo.ppo import PPOJaxPolicy
from ray_tpu.data.sample_batch import MultiAgentBatch as JMultiAgentBatch
from ray_tpu.data.sample_batch import SampleBatch as JSampleBatch
from ray_tpu.offline import ImportanceSampling as JIS
from ray_tpu.offline import JsonReader as JJsonReader
from ray_tpu.offline import JsonWriter as JJsonWriter
from ray_tpu.offline import WeightedImportanceSampling as JWIS
from ray_tpu.offline.offline_ops import sample_offline_batch as j_sample_offline_batch
from ray_tpu.sharding import get_mesh
from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig, PPOTorchPolicy
from ray_tpu_torch.data.sample_batch import MultiAgentBatch, SampleBatch
from ray_tpu_torch.env.spaces import Box, Discrete
from ray_tpu_torch.evaluation.rollout_worker import RolloutWorker
from ray_tpu_torch.offline import (
    ImportanceSampling,
    JsonReader,
    JsonWriter,
    WeightedImportanceSampling,
)
from ray_tpu_torch.offline.offline_ops import sample_offline_batch, setup_offline_reader
from ray_tpu_torch.utils.jax_params import from_jax_params


def _columns(n, seed, eps_len=None):
    """Columns of several dtypes and ranks, as a sampler writes them."""
    rng = np.random.default_rng(seed)
    eps_len = eps_len or n
    return {
        "obs": rng.standard_normal((n, 4)).astype(np.float32),
        "new_obs": rng.standard_normal((n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n).astype(np.int64),
        "rewards": rng.random(n).astype(np.float32),
        "dones": rng.random(n) < 0.2,
        "action_logp": rng.uniform(-1.5, -0.1, n).astype(np.float32),
        "action_dist_inputs": rng.standard_normal((n, 2)).astype(np.float32),
        "eps_id": (seed * 1000 + np.arange(n) // eps_len).astype(np.int64),
        "t": (np.arange(n) % eps_len).astype(np.int32),
        "pixels": rng.integers(0, 255, (n, 3, 3, 2), dtype=np.uint8),
        "advantages": rng.standard_normal(n).astype(np.float64),
    }


def _assert_same_columns(got, want):
    assert set(got.keys()) == set(want.keys())
    for k in want.keys():
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("kind", ["single", "multi"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_json_round_trip_across_packages(tmp_path, writer, kind):
    """One package writes, the other reads: the same bytes."""
    cols = [_columns(9, s) for s in range(3)]
    if writer == "reference":
        w, sb, mab, reader_cls = JJsonWriter(str(tmp_path)), JSampleBatch, JMultiAgentBatch, JsonReader
    else:
        w, sb, mab, reader_cls = JsonWriter(str(tmp_path)), SampleBatch, MultiAgentBatch, JJsonReader
    if kind == "single":
        for c in cols:
            w.write(sb(dict(c)))
    else:
        w.write(mab({"p0": sb(dict(cols[0])), "p1": sb(dict(cols[1]))}, 9))
        w.write(sb(dict(cols[2])))
    w.close()
    reader = reader_cls(str(tmp_path), shuffle=False)
    for c in cols:
        _assert_same_columns(reader.next(), c)


def test_reader_order_and_read_all_match_reference(tmp_path):
    """Shards from both writers in one directory, read through both
    readers: the same shuffled line order over two passes, the same
    ``read_all``; a reference-style line and a glob read the same."""
    cols = [_columns(5 + s, s) for s in range(7)]
    port_w = JsonWriter(str(tmp_path / "d"), max_file_size=4000)
    ref_w = JJsonWriter(str(tmp_path / "d"), max_file_size=4000)
    for i, c in enumerate(cols):
        (port_w if i % 2 else ref_w).write(SampleBatch(dict(c)) if i % 2 else JSampleBatch(dict(c)))
    port_w.close()
    ref_w.close()
    assert len(list((tmp_path / "d").glob("*.json"))) >= 4  # shards rolled over
    line = {"type": "SampleBatch", "count": 3, "obs": [[0.0] * 4, [1.0] * 4, [2.0] * 4],
            "actions": [0, 1, 0], "rewards": [1.0, 1.0, 1.0]}
    (tmp_path / "plain").mkdir()
    (tmp_path / "plain" / "ref.json").write_text(json.dumps(line) + "\n")
    for inputs in (str(tmp_path / "d"), str(tmp_path / "d" / "*.json"), str(tmp_path / "plain")):
        port, ref = JsonReader(inputs), JJsonReader(inputs)
        assert port.files == ref.files
        for _ in range(2 * len(port._lines)):
            _assert_same_columns(port.next(), ref.next())
        _assert_same_columns(port.read_all(), ref.read_all())
    plain = JsonReader(str(tmp_path / "plain" / "ref.json")).next()
    assert plain.count == 3 and "type" not in plain and "count" not in plain
    np.testing.assert_array_equal(plain["actions"], [0, 1, 0])
    with pytest.raises(ValueError, match="No offline data files"):
        JsonReader(str(tmp_path / "none"))


def test_output_config_writes_shards(tmp_path):
    """A PPO worker with ``output`` writes each sampled batch; the shards
    read back bitwise as the batches the worker returned (the object
    ``infos`` column is dropped, as in the reference)."""
    out_dir = str(tmp_path / "out")
    algo = (PPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, rollout_fragment_length=64)
            .training(train_batch_size=128, sgd_minibatch_size=64, num_sgd_iter=2,
                      model={"fcnet_hiddens": [16]})
            .offline_data(output=out_dir).debugging(seed=0).resources(device="cpu").build())
    worker = algo.workers.local_worker()
    seen = []
    sample = worker.sampler.sample
    worker.sampler.sample = lambda: seen.append(sample()) or seen[-1]
    algo.train()
    algo.stop()
    reader = JsonReader(out_dir, shuffle=False)
    full = reader.read_all()
    assert full.count >= 128 and SampleBatch.ACTION_LOGP in full
    assert len(reader._lines) == len(seen) == 2
    for batch in seen:
        want = {k: v for k, v in batch.items() if np.asarray(v).dtype != object}
        _assert_same_columns(reader.next(), want)


def test_sample_offline_batch_matches_reference(tmp_path):
    w = JsonWriter(str(tmp_path))
    for s in range(6):
        w.write(SampleBatch(_columns(7, s)))
    w.close()
    port, ref = JsonReader(str(tmp_path)), JJsonReader(str(tmp_path))
    for seed in range(4):
        got = sample_offline_batch(port, 16, require_next_obs=True, seed=seed)
        want = j_sample_offline_batch(ref, 16, require_next_obs=True, seed=seed)
        assert got.count == 16
        _assert_same_columns(got, want)
    assert isinstance(setup_offline_reader({"input": str(tmp_path)}), JsonReader)
    assert setup_offline_reader({"input": "sampler"}) is None
    no_next = JsonWriter(str(tmp_path / "no_next"))
    no_next.write(SampleBatch({k: v for k, v in _columns(3, 0).items() if k != "new_obs"}))
    no_next.close()
    with pytest.raises(ValueError, match="NEXT_OBS"):
        sample_offline_batch(JsonReader(str(tmp_path / "no_next")), 2, require_next_obs=True)


def _estimator_batch():
    """Five episodes of 6 to 10 steps, behaviour log-probabilities near
    the target's."""
    rng = np.random.default_rng(4)
    parts = []
    for e, n in enumerate((6, 8, 10, 7, 9)):
        parts.append({
            "obs": rng.standard_normal((n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n).astype(np.int64),
            "rewards": rng.random(n).astype(np.float32),
            "action_logp": rng.uniform(-0.9, -0.5, n).astype(np.float32),
            "eps_id": np.full(n, e, np.int64),
        })
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def test_estimators_match_reference():
    cfg = {"model": {"fcnet_hiddens": [16, 16], "dtype": "float32"}, "seed": 2}
    ref = PPOJaxPolicy(gym.spaces.Box(-10, 10, (4,), np.float32), gym.spaces.Discrete(2),
                       {**cfg, "_mesh": get_mesh(devices=jax.devices()[:1])})
    port = PPOTorchPolicy(Box(-10, 10, (4,)), Discrete(2), cfg, device="cpu")
    from_jax_params(jax.device_get(ref.params), port.model)
    cols = _estimator_batch()
    np.testing.assert_allclose(port.compute_log_likelihoods(cols["actions"], cols["obs"]),
                               ref.compute_log_likelihoods(cols["actions"], cols["obs"]),
                               rtol=1e-6, atol=1e-6)
    for port_cls, ref_cls in ((ImportanceSampling, JIS), (WeightedImportanceSampling, JWIS)):
        got = port_cls(port, gamma=0.97).estimate(SampleBatch(dict(cols)))
        want = ref_cls(ref, gamma=0.97).estimate(JSampleBatch(dict(cols)))
        assert set(got) == set(want) == {"v_behavior", "v_target", "v_gain"}
        for k, v in want.items():
            assert abs(got[k] - v) <= 1e-6 * abs(v) + 1e-6, (port_cls.__name__, k, got[k], v)

    class _Behaviour:
        def compute_log_likelihoods(self, actions, obs):
            return np.full(len(actions), -0.69, np.float32)

    same = SampleBatch({**cols, "action_logp": np.full(len(cols["obs"]), -0.69, np.float32)})
    for port_cls in (ImportanceSampling, WeightedImportanceSampling):
        out = port_cls(_Behaviour(), gamma=0.97).estimate(same)
        assert out["v_gain"] == pytest.approx(1.0, abs=1e-12)


def test_refusals_of_the_offline_layer(tmp_path):
    from ray_tpu.data.dataset import Dataset

    rows = [{"obs": np.zeros(4, np.float32), "actions": 0, "rewards": 1.0} for _ in range(4)]
    with pytest.raises(NotImplementedError, match="item 9"):
        setup_offline_reader({"input": Dataset.from_items(rows, parallelism=2)})
    for key in ("input", "output"):
        with pytest.raises(ValueError, match="device lane"):
            (PPOConfig().environment("CartPoleJax-v0", env_backend="jax")
             .rollouts(num_envs_per_worker=2, rollout_fragment_length=8)
             .training(train_batch_size=16).update_from_dict({key: str(tmp_path)})
             .resources(device="cpu").build())
    # the fault injector is ported; its KV family arms the learner fleet's
    # control plane, which is not
    with pytest.raises(NotImplementedError, match="item 7"):
        RolloutWorker(config={"fault_injection": {"kv_drop": [{"kv_op": "put", "on_call": 1}]}})
