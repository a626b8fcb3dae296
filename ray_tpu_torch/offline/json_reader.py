"""JSON-lines SampleBatch reader.

Copy of ``ray_tpu/offline/json_reader.py``: reads the shards of
:class:`~ray_tpu_torch.offline.json_writer.JsonWriter` (or the
reference's, which are the same format) bit for bit, and reference-style
lines that keep ``type`` and ``count`` beside plain-list columns instead
of under a ``"columns"`` key. ``inputs`` are files, directories (their
``*.json``, sorted) or glob patterns. The lines of all shards are read
at once and shuffled with ``random.Random(0)``, so the port reads them
in the reference's order; ``next()`` cycles, shuffling again on each
pass, and ``read_all()`` concatenates the current pass.
"""

from __future__ import annotations

import base64
import glob
import json
import os
import random
import zlib
from typing import Dict, List

import numpy as np

from ray_tpu_torch.data.sample_batch import SampleBatch, concat_samples

_META_KEYS = ("type", "count")


def _decode_col(v):
    if isinstance(v, dict) and v.get("__np__"):
        raw = zlib.decompress(base64.b64decode(v["data"]))
        return np.frombuffer(raw, np.dtype(v["dtype"])).reshape(v["shape"]).copy()
    return np.asarray(v)


def json_to_batch(obj: Dict) -> SampleBatch:
    raw = obj.get("columns", obj)
    return SampleBatch({k: _decode_col(v) for k, v in raw.items() if k not in _META_KEYS})


class JsonReader:
    def __init__(self, inputs, shuffle: bool = True):
        if isinstance(inputs, str):
            inputs = [inputs]
        files: List[str] = []
        for p in inputs:
            p = os.path.expanduser(p)
            if os.path.isdir(p):
                files += sorted(glob.glob(os.path.join(p, "*.json")))
            else:
                files += sorted(glob.glob(p))
        if not files:
            raise ValueError(f"No offline data files found in {inputs}")
        self.files = files
        self.shuffle = shuffle
        self._rng = random.Random(0)
        self._lines: List[str] = []
        self._cursor = 0
        self._load_pass()

    def _load_pass(self) -> None:
        lines = []
        for f in self.files:
            with open(f) as fh:
                lines += [ln for ln in fh if ln.strip()]
        if self.shuffle:
            self._rng.shuffle(lines)
        self._lines = lines
        self._cursor = 0

    def next(self) -> SampleBatch:
        """The next batch, cycling through all shards forever."""
        if self._cursor >= len(self._lines):
            self._load_pass()
        line = self._lines[self._cursor]
        self._cursor += 1
        return json_to_batch(json.loads(line))

    def read_all(self) -> SampleBatch:
        """The whole pass as one concatenated batch."""
        return concat_samples([json_to_batch(json.loads(ln)) for ln in self._lines])
