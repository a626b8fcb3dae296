"""Exploration strategy API and stochastic sampling.

Counterpart of ``ray_tpu/utils/exploration/exploration.py``; ported:
:class:`StochasticSampling`, the default of the PPO family, and
:class:`EpsilonGreedy`, the DQN family's. A strategy's ``sample_fn``
turns an action distribution into actions and their log-probabilities,
drawing from the caller's generator; scheduled knobs (epsilon) live in
the policy's ``coeff_values`` and advance on the host.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ray_tpu_torch.utils.schedules import PiecewiseSchedule


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

    def postprocess_trajectory(self, policy, sample_batch):
        """A fragment's host postprocessing before the policy's own (the
        actor lane's sampler calls it); the ported strategies add
        nothing."""
        return sample_batch


class StochasticSampling(Exploration):
    """Sample from the action distribution when exploring, its mode
    otherwise (the base-class behaviour, named for config symmetry)."""


class EpsilonGreedy(Exploration):
    """Epsilon-greedy over the distribution's greedy action, with epsilon
    annealed linearly from ``initial_epsilon`` to ``final_epsilon`` over
    ``epsilon_timesteps`` (``coeffs["epsilon"]``). Exploring, each row
    takes a uniform random action with probability epsilon; the draws
    (a uniform action, then a uniform [0, 1) decision, per row) come
    from the caller's generator, so they are not the reference's
    ``jax.random`` draws."""

    def __init__(self, action_space, config, model_config=None):
        super().__init__(action_space, config, model_config)
        cfg = self.config
        self.schedule = PiecewiseSchedule([
            (0, float(cfg.get("initial_epsilon", 1.0))),
            (int(cfg.get("epsilon_timesteps", 10000)), float(cfg.get("final_epsilon", 0.02))),
        ])

    def init_coeffs(self) -> Dict[str, float]:
        return {"epsilon": float(self.schedule(0))}

    def update_coeffs(self, coeff_values: Dict, timestep: int) -> None:
        coeff_values["epsilon"] = float(self.schedule(timestep))

    def sample_fn(self, dist, generator, explore, coeffs, state):
        greedy = dist.deterministic_sample()
        if not explore:
            return greedy, dist.logp(greedy), state
        num_actions = dist.inputs.shape[-1]
        device = dist.inputs.device
        random_actions = torch.randint(
            0, num_actions, greedy.shape, generator=generator, device=device
        )
        use_random = (
            torch.rand(greedy.shape, generator=generator, device=device)
            < coeffs["epsilon"]
        )
        actions = torch.where(use_random, random_actions, greedy)
        return actions, dist.logp(actions), state


_REGISTRY = {"StochasticSampling": StochasticSampling, "EpsilonGreedy": EpsilonGreedy}


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
        # the noise strategies' only users are DDPG and TD3
        item = "item 4b" if typ in ("GaussianNoise", "OrnsteinUhlenbeckNoise") else "item 9"
        raise NotImplementedError(
            f"exploration type {typ!r} is not ported yet (ROADMAP.md queue 1 {item}); "
            f"ported: {sorted(_REGISTRY)}"
        )
    return cls(action_space, ec, model_config)
