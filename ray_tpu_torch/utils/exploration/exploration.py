"""Exploration strategy API and stochastic sampling.

Counterpart of ``ray_tpu/utils/exploration/exploration.py``; this slice
ports :class:`StochasticSampling`, the default of the PPO family. A
strategy's ``sample_fn`` turns an action distribution into actions and
their log-probabilities, drawing from the caller's generator.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


class Exploration:
    """Base strategy: sample when exploring, take the mode otherwise."""

    def __init__(self, action_space, config: Dict, model_config=None):
        self.action_space = action_space
        self.config = dict(config or {})
        self.model_config = dict(model_config or {})

    def sample_fn(
        self,
        dist,
        generator: Optional[torch.Generator],
        explore: bool,
        coeffs: Dict[str, float],
        state: Tuple,
    ):
        """→ (actions, logp, new_state)."""
        if explore:
            actions, logp = dist.sampled_action_logp(generator)
        else:
            actions = dist.deterministic_sample()
            logp = dist.logp(actions)
        return actions, logp, state

    def init_coeffs(self) -> Dict[str, float]:
        return {}

    def update_coeffs(self, coeff_values: Dict, timestep: int) -> None:
        """Advance schedules (host side)."""


class StochasticSampling(Exploration):
    """Sample from the action distribution when exploring, its mode
    otherwise (the base-class behaviour, named for config symmetry)."""


_REGISTRY = {"StochasticSampling": StochasticSampling}


def exploration_from_config(
    config: Dict,
    action_space,
    model_config=None,
    default: str = "StochasticSampling",
) -> Exploration:
    """Build the strategy from ``config["exploration_config"]``."""
    ec = dict(config.get("exploration_config") or {})
    typ = ec.pop("type", default)
    if isinstance(typ, type):
        return typ(action_space, ec, model_config)
    cls = _REGISTRY.get(typ)
    if cls is None:
        raise NotImplementedError(
            f"exploration type {typ!r} is not ported yet; "
            f"ported: {sorted(_REGISTRY)}"
        )
    return cls(action_space, ec, model_config)
