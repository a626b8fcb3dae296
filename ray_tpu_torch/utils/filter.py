"""Running-statistics observation filters (host numpy).

Copy of ``ray_tpu/utils/filter.py``: filters run on the rollout workers;
their statistics sync through the worker set (``sync_filters``).
``__call__`` takes (obs_dim,) or (batch, obs_dim).
"""

from __future__ import annotations

import numpy as np


class Filter:
    """No-op base filter."""

    is_concurrent = False

    def __call__(self, x, update: bool = True):
        return x

    def apply_changes(self, other: "Filter", with_buffer: bool = False):
        pass

    def copy(self) -> "Filter":
        return Filter()

    def sync(self, other: "Filter"):
        pass

    def clear_buffer(self):
        pass

    def as_serializable(self) -> "Filter":
        return self


class NoFilter(Filter):
    def copy(self) -> "NoFilter":
        return NoFilter()


class RunningStat:
    """Welford's online mean and variance, over batches."""

    def __init__(self, shape=()):
        self.num = 0
        self.mean_ = np.zeros(shape, dtype=np.float64)
        self.s = np.zeros(shape, dtype=np.float64)

    def push_batch(self, x: np.ndarray):
        x = np.asarray(x, dtype=np.float64)
        if x.ndim == len(self.mean_.shape):
            x = x[None]
        n_b = x.shape[0]
        if n_b == 0:
            return
        mean_b = x.mean(axis=0)
        s_b = ((x - mean_b) ** 2).sum(axis=0)
        n_a = self.num
        if n_a == 0:
            self.mean_ = mean_b
            self.s = s_b
        else:
            delta = mean_b - self.mean_
            tot = n_a + n_b
            self.mean_ = self.mean_ + delta * n_b / tot
            self.s = self.s + s_b + delta**2 * n_a * n_b / tot
        self.num += n_b

    def push(self, x):
        self.push_batch(np.asarray(x)[None])

    def update(self, other: "RunningStat"):
        n1, n2 = self.num, other.num
        if n2 == 0:
            return
        if n1 == 0:
            self.num = other.num
            self.mean_ = other.mean_.copy()
            self.s = other.s.copy()
            return
        delta = other.mean_ - self.mean_
        tot = n1 + n2
        self.s = self.s + other.s + delta**2 * n1 * n2 / tot
        self.mean_ = self.mean_ + delta * n2 / tot
        self.num = tot

    @property
    def n(self):
        return self.num

    @property
    def mean(self):
        return self.mean_

    @property
    def var(self):
        return self.s / (self.num - 1) if self.num > 1 else np.square(self.mean_)

    @property
    def std(self):
        return np.sqrt(self.var)

    def copy(self):
        out = RunningStat()
        out.num = self.num
        out.mean_ = self.mean_.copy()
        out.s = self.s.copy()
        return out


class MeanStdFilter(Filter):
    """Normalizes by the running mean and std. ``buffer`` holds the
    statistics gathered since the last sync, which a central copy adds
    up from many workers (``apply_changes``)."""

    def __init__(self, shape, demean: bool = True, destd: bool = True,
                 clip: float | None = 10.0):
        self.shape = shape
        self.demean = demean
        self.destd = destd
        self.clip = clip
        self.rs = RunningStat(shape)
        self.buffer = RunningStat(shape)

    def clear_buffer(self):
        self.buffer = RunningStat(self.shape)

    def apply_changes(self, other: "MeanStdFilter", with_buffer: bool = False):
        self.rs.update(other.buffer)
        if with_buffer:
            self.buffer = other.buffer.copy()

    def copy(self) -> "MeanStdFilter":
        out = MeanStdFilter(self.shape, self.demean, self.destd, self.clip)
        out.sync(self)
        return out

    def as_serializable(self) -> "MeanStdFilter":
        return self.copy()

    def sync(self, other: "MeanStdFilter"):
        self.demean = other.demean
        self.destd = other.destd
        self.clip = other.clip
        self.rs = other.rs.copy()
        self.buffer = other.buffer.copy()

    def __call__(self, x, update: bool = True):
        x = np.asarray(x, dtype=np.float64)
        if update:
            self.rs.push_batch(x)
            self.buffer.push_batch(x)
        if self.demean:
            x = x - self.rs.mean
        if self.destd:
            x = x / (self.rs.std + 1e-8)
        if self.clip:
            x = np.clip(x, -self.clip, self.clip)
        return x.astype(np.float32)

    def __repr__(self):
        return f"MeanStdFilter(shape={self.shape}, n={self.rs.n})"


def get_filter(filter_config, shape) -> Filter:
    """A filter by its config name (or a callable of the shape)."""
    if filter_config in ("MeanStdFilter", "ConcurrentMeanStdFilter"):
        return MeanStdFilter(shape)
    elif filter_config == "NoFilter" or filter_config is None:
        return NoFilter()
    elif callable(filter_config):
        return filter_config(shape)
    raise ValueError(f"Unknown observation_filter: {filter_config}")
