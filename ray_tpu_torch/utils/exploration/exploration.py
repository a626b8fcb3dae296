"""Exploration strategy API and stochastic sampling.

Counterpart of ``ray_tpu/utils/exploration/exploration.py``; ported:
:class:`StochasticSampling`, the default of the PPO family, and
:class:`EpsilonGreedy`, the DQN family's. A strategy's ``sample_fn``
turns an action distribution into actions and their log-probabilities,
drawing from the caller's generator; scheduled knobs (epsilon) live in
the policy's ``coeff_values`` and advance on the host. :meth:`Exploration.draws`
takes ahead, from the same generator and in the same order, the random
tensors that one ``sample_fn`` call would draw, and ``sample_fn`` takes
them back as ``draws``: the serving plane's CUDA graphs read their draws
from static buffers this way, and a batch of requests draws exactly what
the same requests would draw one at a time.
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
        draws: Tuple = (),
    ):
        """→ (actions, logp, new_state). ``draws``: what :meth:`draws`
        took ahead, used in place of drawing from ``generator``."""
        if explore:
            actions, logp = dist.sampled_action_logp(generator, *draws)
        else:
            actions = dist.deterministic_sample()
            logp = dist.logp(actions)
        return actions, logp, state

    def draws(self, dist_class, shape, dtype, device, generator, explore: bool) -> Tuple:
        """The random tensors one :meth:`sample_fn` call over
        distribution inputs of ``shape`` and ``dtype`` draws from
        ``generator``, in its order (none when not exploring)."""
        if not explore:
            return ()
        return (dist_class.draw(shape, dtype, device, generator),)

    def initial_state(self, batch_size: int = 1) -> Tuple:
        """Per-stream exploration state: none for the ported strategies
        (the serving plane coalesces only stateless strategies)."""
        return ()

    def init_coeffs(self) -> Dict[str, float]:
        return {}

    def update_coeffs(self, coeff_values: Dict, timestep: int) -> None:
        """Advance schedules (host side)."""

    def postprocess_trajectory(self, policy, sample_batch):
        """A fragment's host postprocessing before the policy's own (the
        actor lane's sampler calls it); the ported strategies add
        nothing."""
        return sample_batch

    def get_state(self) -> Dict:
        """The strategy's own state for a checkpoint (the policy's
        ``exploration_state``); the ported strategies keep theirs in
        ``coeff_values`` and have none."""
        return {}

    def set_state(self, state: Dict) -> None:
        pass


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

    def draws(self, dist_class, shape, dtype, device, generator, explore):
        """A uniform action, then a uniform [0, 1) decision, per row."""
        if not explore:
            return ()
        rows = tuple(shape[:-1])
        return (
            torch.randint(0, shape[-1], rows, generator=generator, device=device),
            torch.rand(rows, generator=generator, device=device),
        )

    def sample_fn(self, dist, generator, explore, coeffs, state, draws=()):
        greedy = dist.deterministic_sample()
        if not explore:
            return greedy, dist.logp(greedy), state
        if not draws:
            draws = self.draws(None, dist.inputs.shape, dist.inputs.dtype, dist.inputs.device,
                               generator, True)
        random_actions, u = draws
        actions = torch.where(u < coeffs["epsilon"], random_actions, greedy)
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
