"""User-defined metrics: Counter / Gauge / Histogram.

Counterpart of ``ray_tpu/utils/metrics.py``, kept as the port's own
copy (it holds no JAX): a process-local registry with the reference's
buckets, tag-key ordering (series keyed by the sorted tag items) and
locking (one lock for the registry, one per metric), exported as
Prometheus text by :mod:`ray_tpu_torch.utils.metrics_exporter`."""

from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_REGISTRY_LOCK = threading.Lock()
_REGISTRY: Dict[str, "Metric"] = {}


def _tag_key(tags: Optional[Dict[str, str]]) -> Tuple:
    return tuple(sorted((tags or {}).items()))


class Metric:
    kind = "untyped"

    def __init__(
        self,
        name: str,
        description: str = "",
        tag_keys: Optional[Sequence[str]] = None,
    ):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys or ())
        self._lock = threading.Lock()
        self._series: Dict[Tuple, float] = {}
        with _REGISTRY_LOCK:
            _REGISTRY[name] = self

    def series(self) -> List[Tuple[Tuple, float]]:
        with self._lock:
            return list(self._series.items())


class Counter(Metric):
    """Monotonic counter (reference metrics.py:155)."""

    kind = "counter"

    def inc(self, value: float = 1.0, tags: Optional[Dict] = None):
        if value < 0:
            raise ValueError("counters only increase")
        k = _tag_key(tags)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + value


class Gauge(Metric):
    """Point-in-time value (reference metrics.py:288)."""

    kind = "gauge"

    def set(self, value: float, tags: Optional[Dict] = None):
        with self._lock:
            self._series[_tag_key(tags)] = float(value)


class Histogram(Metric):
    """Bucketed observations (reference metrics.py:220)."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        description: str = "",
        boundaries: Optional[Sequence[float]] = None,
        tag_keys: Optional[Sequence[str]] = None,
    ):
        super().__init__(name, description, tag_keys)
        self.boundaries = list(
            boundaries or (0.005, 0.05, 0.5, 5.0, 50.0)
        )
        self._buckets: Dict[Tuple, List[float]] = {}
        self._sums: Dict[Tuple, float] = {}
        self._counts: Dict[Tuple, int] = {}

    def observe(self, value: float, tags: Optional[Dict] = None):
        k = _tag_key(tags)
        with self._lock:
            counts = self._buckets.setdefault(
                k, [0.0] * (len(self.boundaries) + 1)
            )
            counts[bisect.bisect_left(self.boundaries, value)] += 1
            self._sums[k] = self._sums.get(k, 0.0) + float(value)
            self._counts[k] = self._counts.get(k, 0) + 1

    def series(self):
        with self._lock:
            return [
                (
                    k,
                    {
                        "buckets": list(self._buckets.get(k, [])),
                        "sum": self._sums.get(k, 0.0),
                        "count": self._counts.get(k, 0),
                    },
                )
                for k in self._counts
            ]


def get_metric(name: str) -> Optional[Metric]:
    with _REGISTRY_LOCK:
        return _REGISTRY.get(name)


# sub-ms..minutes buckets: device transfers sit in the low
# milliseconds, a CUDA graph capture or a kernel build in seconds
_TIMER_BOUNDARIES = (
    0.0005, 0.002, 0.01, 0.05, 0.2, 1.0, 5.0, 30.0, 120.0,
)


def timer_histogram(name: str, description: str = "") -> Histogram:
    """Get-or-create a latency Histogram (idempotent accessor for the
    per-stage learner timers: transfer / step — see
    ``TorchPolicy.last_learn_timers``)."""
    m = get_metric(name)
    if isinstance(m, Histogram):
        return m
    return Histogram(
        name, description, boundaries=_TIMER_BOUNDARIES
    )


def all_metrics() -> List[Metric]:
    with _REGISTRY_LOCK:
        return list(_REGISTRY.values())


def clear_registry() -> None:
    with _REGISTRY_LOCK:
        _REGISTRY.clear()
