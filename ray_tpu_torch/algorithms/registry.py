"""The algorithm registry: a tuned example's ``run`` name → its class.

Counterpart of ``ray_tpu/algorithms/registry.py``, cut to the
algorithms the port has. Each class is imported when it is asked for,
and records the name (``_registry_name``), which a checkpoint's
metadata keeps for ``Algorithm.from_checkpoint``.
"""

from __future__ import annotations

import importlib

ALGORITHMS = {
    "APEX": "ray_tpu_torch.algorithms.apex_dqn.apex_dqn:ApexDQN",
    "APEX_DDPG": "ray_tpu_torch.algorithms.apex_dqn.apex_dqn:ApexDDPG",
    "PPO": "ray_tpu_torch.algorithms.ppo.ppo:PPO",
    "DQN": "ray_tpu_torch.algorithms.dqn.dqn:DQN",
    "IMPALA": "ray_tpu_torch.algorithms.impala.impala:IMPALA",
    "APPO": "ray_tpu_torch.algorithms.appo.appo:APPO",
    "SAC": "ray_tpu_torch.algorithms.sac.sac:SAC",
    "DDPG": "ray_tpu_torch.algorithms.ddpg.ddpg:DDPG",
    "TD3": "ray_tpu_torch.algorithms.ddpg.ddpg:TD3",
    "MARWIL": "ray_tpu_torch.algorithms.marwil.marwil:MARWIL",
    "BC": "ray_tpu_torch.algorithms.marwil.marwil:BC",
    "CQL": "ray_tpu_torch.algorithms.cql.cql:CQL",
    "CRR": "ray_tpu_torch.algorithms.crr.crr:CRR",
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
    algo_cls = getattr(importlib.import_module(module), cls)
    algo_cls._registry_name = name
    return algo_cls
