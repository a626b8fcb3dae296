"""JSON-lines SampleBatch writer.

Copy of ``ray_tpu/offline/json_writer.py``, the reference's format: one
JSON object a line, ``{"type": "SampleBatch", "count": n, "columns":
{...}}``, each numpy column ``{"__np__": true, "dtype", "shape",
"data"}`` where ``data`` is the base64 of the column's bytes
zlib-compressed at level 3, so a write/read round trip is bit-identical
and either package reads the other's files. Object columns (``infos``)
are dropped. A ``MultiAgentBatch`` is written as its policy batches, one
line each and without their policy ids, as the reference writes it. A
new shard (``output-<time>_<pid>_<ns>.json``) starts when the next line
would pass ``max_file_size`` bytes.
"""

from __future__ import annotations

import base64
import json
import os
import time
import zlib
from typing import Any, Dict

import numpy as np

from ray_tpu_torch.data.sample_batch import MultiAgentBatch, SampleBatch


def _encode_col(v: Any):
    v = np.asarray(v)
    if v.dtype == object:
        return None  # an unsupported column (the infos dicts): dropped
    return {
        "__np__": True,
        "dtype": str(v.dtype),
        "shape": list(v.shape),
        "data": base64.b64encode(
            zlib.compress(np.ascontiguousarray(v).tobytes(), 3)
        ).decode("ascii"),
    }


def batch_to_json(batch: SampleBatch) -> Dict:
    cols = {}
    for k, v in batch.items():
        enc = _encode_col(v)
        if enc is not None:
            cols[k] = enc
    return {"type": "SampleBatch", "count": batch.count, "columns": cols}


class JsonWriter:
    """Writes batches to ``<path>/output-<ts>_<pid>_<ns>.json`` shards,
    starting a new one at ``max_file_size`` bytes."""

    def __init__(self, path: str, max_file_size: int = 64 * 1024 * 1024):
        self.path = path
        self.max_file_size = max_file_size
        os.makedirs(path, exist_ok=True)
        self._f = None
        self._bytes = 0

    def _open(self) -> None:
        name = (f"output-{time.strftime('%Y-%m-%d_%H-%M-%S')}_{os.getpid()}_"
                f"{int(time.time_ns() % 1_000_000)}.json")
        self._f = open(os.path.join(self.path, name), "w")
        self._bytes = 0

    def write(self, batch) -> None:
        if isinstance(batch, MultiAgentBatch):
            for b in batch.policy_batches.values():
                self.write(b)
            return
        line = json.dumps(batch_to_json(batch))
        if self._f is None or self._bytes + len(line) > self.max_file_size:
            if self._f:
                self._f.close()
            self._open()
        self._f.write(line + "\n")
        self._f.flush()
        self._bytes += len(line) + 1

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None
