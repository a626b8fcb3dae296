"""Minimal observation and action spaces.

The port does not depend on gymnasium. These classes carry what the
catalog, the preprocessors, the sampler and the envs read (``shape``,
``dtype``, ``low``/``high``, ``n``, a composite space's ``spaces``);
the catalog and the preprocessors duck-type, so gymnasium's spaces work
too. :class:`Dict` holds its sub-spaces under sorted keys, as
gymnasium's ``Dict`` does when given a plain dict.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

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


class Dict:
    """Named sub-spaces (``spaces``: a dict in sorted key order)."""

    def __init__(self, spaces: Mapping):
        self.spaces = {k: spaces[k] for k in sorted(spaces)}
        self.shape = None
        self.dtype = None

    def __getitem__(self, key):
        return self.spaces[key]

    def __repr__(self):
        return f"Dict({self.spaces})"


class Tuple:
    """Ordered sub-spaces (``spaces``: a tuple)."""

    def __init__(self, spaces: Sequence):
        self.spaces = tuple(spaces)
        self.shape = None
        self.dtype = None

    def __getitem__(self, i):
        return self.spaces[i]

    def __len__(self):
        return len(self.spaces)

    def __repr__(self):
        return f"Tuple({self.spaces})"
