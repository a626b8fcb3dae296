"""The offline training loop's helpers: the reader of ``config["input"]``,
the fixed-size batch draw and one offline train step.

Copy of ``ray_tpu/offline/offline_ops.py``. MARWIL, BC, CQL and CRR
build their reader with :func:`setup_offline_reader`; CQL and CRR train
with :func:`offline_training_step` (draw, ``learn_on_batch``, count).
The draw subsamples with ``np.random.default_rng(seed).permutation``,
bitwise the reference's. A dataset of the Data layer as input (the
reference's ``DatasetReader``) needs ``ray_tpu/data/dataset.py``, which
is not ported: it raises, naming ``ROADMAP.md`` queue 1 item 9.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ray_tpu_torch.data.sample_batch import DEFAULT_POLICY_ID, SampleBatch, concat_samples


def setup_offline_reader(config: Dict):
    """The offline input of ``config["input"]`` (None when training from
    the sampler): a JSON shard path or glob (``JsonReader``), or any
    object with ``next() -> SampleBatch``."""
    inp = config.get("input")
    if inp is None or inp == "sampler":
        return None
    from ray_tpu_torch.offline.json_reader import JsonReader

    if isinstance(inp, str):
        return JsonReader(inp)
    if hasattr(inp, "next"):
        return inp
    if hasattr(inp, "take_all"):
        raise NotImplementedError(
            f"a {type(inp).__name__} as offline input (the reference's DatasetReader over "
            "its Data layer) is not ported yet: ROADMAP.md queue 1 item 9"
        )
    raise ValueError(f"unsupported offline input: {type(inp)}")


def sample_offline_batch(reader, target: int, *, require_next_obs: bool = False,
                         seed: int = 0) -> SampleBatch:
    """At least ``target`` rows from the reader, then exactly ``target``
    of them, subsampled uniformly without replacement."""
    out, steps = [], 0
    while steps < target:
        b = reader.next()
        if require_next_obs and SampleBatch.NEXT_OBS not in b:
            raise ValueError("offline data requires NEXT_OBS columns for TD learning")
        out.append(b)
        steps += b.count
    batch = concat_samples(out)
    idx = np.random.default_rng(seed).permutation(batch.count)[:target]
    return SampleBatch({k: np.asarray(v)[idx] for k, v in batch.items()})


def offline_training_step(algo) -> Dict:
    """One offline train step: draw ``train_batch_size`` rows (seeded by
    the count of draws so far), learn, count the rows trained."""
    from ray_tpu_torch.algorithms.algorithm import NUM_ENV_STEPS_TRAINED

    target = int(algo.config.get("train_batch_size", 256))
    batch = sample_offline_batch(algo._reader, target, require_next_obs=True,
                                 seed=algo._counters["offline_draws"])
    algo._counters["offline_draws"] += 1
    info = algo.get_policy().learn_on_batch(batch)
    algo._counters[NUM_ENV_STEPS_TRAINED] += batch.count
    return {DEFAULT_POLICY_ID: info}
