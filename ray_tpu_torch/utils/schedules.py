"""Parameter schedules (lr, entropy coefficient).

Copy of ``ray_tpu/utils/schedules.py``: pure functions of a timestep,
evaluated on the host.
"""

from __future__ import annotations

import bisect
from typing import List, Sequence, Tuple, Union

import numpy as np


class Schedule:
    def value(self, t):
        raise NotImplementedError

    def __call__(self, t):
        return self.value(t)


class ConstantSchedule(Schedule):
    def __init__(self, value: float):
        self._v = value

    def value(self, t):
        return self._v


class LinearSchedule(Schedule):
    """Linear interpolation from initial_p to final_p over schedule_timesteps."""

    def __init__(self, schedule_timesteps: int, final_p: float,
                 initial_p: float = 1.0):
        self.schedule_timesteps = schedule_timesteps
        self.final_p = final_p
        self.initial_p = initial_p

    def value(self, t):
        frac = np.minimum(np.asarray(t, dtype=np.float64)
                          / self.schedule_timesteps, 1.0)
        return self.initial_p + frac * (self.final_p - self.initial_p)


class PiecewiseSchedule(Schedule):
    """Piecewise-linear over (t, value) endpoints."""

    def __init__(self, endpoints: Sequence[Tuple[int, float]],
                 outside_value: float | None = None):
        endpoints = sorted(endpoints)
        self.ts = [e[0] for e in endpoints]
        self.vs = [e[1] for e in endpoints]
        self.outside_value = outside_value

    def value(self, t):
        t = float(t)
        if t <= self.ts[0]:
            return self.vs[0]
        if t >= self.ts[-1]:
            return (self.outside_value
                    if self.outside_value is not None else self.vs[-1])
        i = bisect.bisect_right(self.ts, t) - 1
        frac = (t - self.ts[i]) / (self.ts[i + 1] - self.ts[i])
        return self.vs[i] + frac * (self.vs[i + 1] - self.vs[i])


def make_schedule(
    spec: Union[None, float, Schedule, List[List[float]]],
    default: float = 0.0,
) -> Schedule:
    """RLlib-style schedule spec: None | float | [[t, v], ...]."""
    if spec is None:
        return ConstantSchedule(default)
    if isinstance(spec, Schedule):
        return spec
    if isinstance(spec, (int, float)):
        return ConstantSchedule(float(spec))
    return PiecewiseSchedule([(int(t), float(v)) for t, v in spec])
