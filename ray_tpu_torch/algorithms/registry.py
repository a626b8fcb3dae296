"""The algorithm registry: a tuned example's ``run`` name → its class.

Counterpart of ``ray_tpu/algorithms/registry.py``, over the same names.
Each class is imported when it is asked for, and records the name
(``_registry_name``), which a checkpoint's metadata keeps for
``Algorithm.from_checkpoint``. ``register_algorithm(name, loader)`` adds
a name (``loader()`` returns the class), ahead of the built-in ones, as
in the reference.

A name the reference knows and the port has not ported raises
``NotImplementedError`` naming its ROADMAP.md item (:data:`NOT_PORTED`);
a name neither package knows raises the reference's ``ValueError``.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict

_ALGORITHMS: Dict[str, Callable] = {}

ALGORITHMS = {
    "APEX": "ray_tpu_torch.algorithms.apex_dqn.apex_dqn:ApexDQN",
    "ApexDQN": "ray_tpu_torch.algorithms.apex_dqn.apex_dqn:ApexDQN",
    "APEX_DDPG": "ray_tpu_torch.algorithms.apex_dqn.apex_dqn:ApexDDPG",
    "ApexDDPG": "ray_tpu_torch.algorithms.apex_dqn.apex_dqn:ApexDDPG",
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
    "PG": "ray_tpu_torch.algorithms.pg.pg:PG",
    "A2C": "ray_tpu_torch.algorithms.a2c.a2c:A2C",
    "A3C": "ray_tpu_torch.algorithms.a2c.a2c:A3C",
    "SimpleQ": "ray_tpu_torch.algorithms.dqn.dqn:SimpleQ",
    "R2D2": "ray_tpu_torch.algorithms.r2d2.r2d2:R2D2",
    "RNNSAC": "ray_tpu_torch.algorithms.sac.rnnsac:RNNSAC",
    "ES": "ray_tpu_torch.algorithms.es.es:ES",
    "ARS": "ray_tpu_torch.algorithms.es.es:ARS",
    "BanditLinUCB": "ray_tpu_torch.algorithms.bandit.bandit:BanditLinUCB",
    "BanditLinTS": "ray_tpu_torch.algorithms.bandit.bandit:BanditLinTS",
    "MADDPG": "ray_tpu_torch.algorithms.maddpg.maddpg:MADDPG",
    "QMIX": "ray_tpu_torch.algorithms.qmix.qmix:QMIX",
    "SlateQ": "ray_tpu_torch.algorithms.slateq.slateq:SlateQ",
}

# the reference's names the port has not ported yet, with their item
NOT_PORTED = {
    "DDPPO": "7",
    **{name: "9" for name in ("AlphaStar", "AlphaZero", "Dreamer", "MAML", "MBMPO")},
}


def register_algorithm(name: str, loader: Callable) -> None:
    """``name`` resolves to ``loader()`` (over a built-in of that name)."""
    _ALGORITHMS[name] = loader


def get_algorithm_class(name: str):
    """The class registered as ``name``."""
    if name in _ALGORITHMS:
        algo_cls = _ALGORITHMS[name]()
    elif name in ALGORITHMS:
        module, cls = ALGORITHMS[name].split(":")
        algo_cls = getattr(importlib.import_module(module), cls)
    elif name in NOT_PORTED:
        raise NotImplementedError(
            f"algorithm {name!r} is not ported yet: ROADMAP.md queue 1 item {NOT_PORTED[name]}"
        )
    else:
        raise ValueError(
            f"Unknown algorithm {name!r}; known: "
            f"{sorted(set(_ALGORITHMS) | set(ALGORITHMS) | set(NOT_PORTED))}"
        )
    algo_cls._registry_name = name
    return algo_cls
