"""Offline data: the JSON writer and reader, the offline batch draw and
the off-policy estimators. Counterpart of ``ray_tpu/offline``; the
reference's ``DatasetReader`` needs the Data layer
(``ray_tpu/data/dataset.py``), which is not ported
(``offline_ops.setup_offline_reader`` refuses a dataset input)."""

from ray_tpu_torch.offline.json_reader import JsonReader
from ray_tpu_torch.offline.json_writer import JsonWriter
from ray_tpu_torch.offline.off_policy_estimator import (
    ImportanceSampling,
    OffPolicyEstimator,
    WeightedImportanceSampling,
)

__all__ = [
    "JsonReader",
    "JsonWriter",
    "OffPolicyEstimator",
    "ImportanceSampling",
    "WeightedImportanceSampling",
]
