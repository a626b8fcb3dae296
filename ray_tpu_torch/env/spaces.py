"""Minimal observation and action spaces.

The port does not depend on gymnasium. These two classes carry what the
catalog and the envs read (``shape``, ``dtype``, ``low``/``high``,
``n``); the catalog duck-types, so gymnasium's spaces work too.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class Box:
    def __init__(self, low, high, shape: Sequence[int], dtype=np.float32):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.low = np.full(self.shape, low, self.dtype)
        self.high = np.full(self.shape, high, self.dtype)

    def __repr__(self):
        return f"Box({self.shape}, {self.dtype})"


class Discrete:
    def __init__(self, n: int):
        self.n = int(n)
        self.shape = ()
        self.dtype = np.dtype(np.int64)

    def __repr__(self):
        return f"Discrete({self.n})"
