"""Minimal observation and action spaces.

The port does not depend on gymnasium. These two classes carry what the
catalog, the sampler and the envs read (``shape``, ``dtype``,
``low``/``high``, ``n``); the catalog duck-types, so gymnasium's spaces
work too.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class Box:
    """``low``/``high`` are scalars or arrays, as gymnasium's ``Box``
    takes them: with no ``shape`` the arrays give it, and a scalar
    bound fills the shape."""

    def __init__(self, low, high, shape: Optional[Sequence[int]] = None, dtype=np.float32):
        self.dtype = np.dtype(dtype)
        if shape is None:
            shape = np.shape(low) if np.ndim(low) else np.shape(high)
        self.shape = tuple(int(s) for s in shape)
        self.low = np.broadcast_to(np.asarray(low).astype(self.dtype), self.shape).copy()
        self.high = np.broadcast_to(np.asarray(high).astype(self.dtype), self.shape).copy()

    def __repr__(self):
        return f"Box({self.shape}, {self.dtype})"


class Discrete:
    def __init__(self, n: int):
        self.n = int(n)
        self.shape = ()
        self.dtype = np.dtype(np.int64)

    def __repr__(self):
        return f"Discrete({self.n})"
