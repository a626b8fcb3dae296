"""The algorithm registry: a tuned example's ``run`` name → its class.

Counterpart of ``ray_tpu/algorithms/registry.py``, cut to the
algorithms the port has. Each class is imported when it is asked for.
"""

from __future__ import annotations

import importlib

ALGORITHMS = {
    "PPO": "ray_tpu_torch.algorithms.ppo.ppo:PPO",
    "DQN": "ray_tpu_torch.algorithms.dqn.dqn:DQN",
    "IMPALA": "ray_tpu_torch.algorithms.impala.impala:IMPALA",
    "APPO": "ray_tpu_torch.algorithms.appo.appo:APPO",
    "SAC": "ray_tpu_torch.algorithms.sac.sac:SAC",
}


def get_algorithm_class(name: str):
    """The class registered as ``name``; raises for any other name."""
    try:
        module, cls = ALGORITHMS[name].split(":")
    except KeyError:
        raise NotImplementedError(
            f"algorithm {name!r} is not ported yet (ported: {sorted(ALGORITHMS)}): "
            "ROADMAP.md queue 1"
        ) from None
    return getattr(importlib.import_module(module), cls)
