"""Exploration strategy API and the distribution- and noise-based
strategies.

Counterpart of ``ray_tpu/utils/exploration/exploration.py``; ported:
:class:`StochasticSampling`, the default of the PPO family,
:class:`EpsilonGreedy`, the DQN family's, :class:`GaussianNoise` and
:class:`OrnsteinUhlenbeckNoise`, TD3's and DDPG's, and the strategies
with learners of their own, ``Curiosity`` (``curiosity.py``) and ``RND``
(``rnd.py``), which register themselves (:func:`register_exploration`)
and train in ``postprocess_trajectory``. The OU process is
stateful: its per-slot ``x`` is carried state (:meth:`Exploration.initial_state`),
which ``sample_fn`` takes and returns, so the serving plane sends such a
policy to its sequential fallback. A strategy's ``sample_fn``
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

import numpy as np
import torch

from ray_tpu_torch.utils.schedules import PiecewiseSchedule, make_schedule


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

    def initial_state(self, batch_size: int = 1, device=None) -> Tuple:
        """Per-stream exploration state for ``batch_size`` slots: none for
        a stateless strategy (the serving plane coalesces only those)."""
        return ()

    def init_coeffs(self) -> Dict[str, float]:
        return {}

    def update_coeffs(self, coeff_values: Dict, timestep: int) -> None:
        """Advance schedules (host side)."""

    def postprocess_trajectory(self, policy, sample_batch):
        """A fragment's host postprocessing before the policy's own (the
        actor lane's sampler calls it; the device lane runs none, so it
        refuses a strategy that overrides this). Curiosity and RND add
        their intrinsic rewards here; the others add nothing."""
        return sample_batch

    def get_state(self) -> Dict:
        """The strategy's own state for a checkpoint (the policy's
        ``exploration_state``): Curiosity's and RND's nets and Adam
        states; the others keep theirs in ``coeff_values`` and have
        none."""
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


class GaussianNoise(Exploration):
    """The deterministic action plus ``noise_scale * stddev * N(0, 1)``,
    clipped to the action space's bounds; ``noise_scale`` follows
    ``scale_schedule``, or goes linearly from ``initial_scale`` to
    ``final_scale`` over ``scale_timesteps`` (``coeffs["noise_scale"]``).
    One standard normal per action dimension and row, from the caller's
    generator (or ``draws``)."""

    def __init__(self, action_space, config, model_config=None):
        super().__init__(action_space, config, model_config)
        cfg = self.config
        self.stddev = float(cfg.get("stddev", 0.1))
        self.scale_schedule = make_schedule(
            cfg.get("scale_schedule"), float(cfg.get("initial_scale", 1.0))
        )
        if cfg.get("scale_schedule") is None and cfg.get("scale_timesteps"):
            self.scale_schedule = PiecewiseSchedule([
                (0, float(cfg.get("initial_scale", 1.0))),
                (int(cfg["scale_timesteps"]), float(cfg.get("final_scale", 1.0))),
            ])
        self.low = np.asarray(action_space.low, np.float32)
        self.high = np.asarray(action_space.high, np.float32)
        # the bounds as tensors, per device, made outside any graph
        self._bounds: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def init_coeffs(self) -> Dict[str, float]:
        return {"noise_scale": float(self.scale_schedule(0))}

    def update_coeffs(self, coeff_values: Dict, timestep: int) -> None:
        coeff_values["noise_scale"] = float(self.scale_schedule(timestep))

    def draws(self, dist_class, shape, dtype, device, generator, explore):
        if not explore:
            return ()
        return (torch.randn(tuple(shape), generator=generator, device=device),)

    def bounds(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        device = torch.device(device)
        out = self._bounds.get(device)
        if out is None:
            out = self._bounds[device] = (torch.as_tensor(self.low, device=device),
                                          torch.as_tensor(self.high, device=device))
        return out

    def _noise(self, normal: torch.Tensor, det: torch.Tensor, state: Tuple):
        return self.stddev * normal, state

    def sample_fn(self, dist, generator, explore, coeffs, state, draws=()):
        det = dist.deterministic_sample()
        logp = torch.zeros(det.shape[:1], dtype=det.dtype, device=det.device)
        if not explore:
            return det, logp, state
        normal = draws[0] if draws else torch.randn(
            det.shape, generator=generator, device=det.device)
        noise, state = self._noise(normal, det, state)
        low, high = self.bounds(det.device)
        actions = torch.clamp(det + coeffs["noise_scale"] * noise, low, high)
        return actions, logp, state


class OrnsteinUhlenbeckNoise(GaussianNoise):
    """Temporally correlated noise: per slot, ``x <- x + ou_theta * (0 -
    x) + ou_sigma * N(0, 1)``, and the action's noise is ``ou_base_scale
    * x`` (then scaled and clipped as :class:`GaussianNoise`). ``x`` is
    carried state, (batch, action dim) float32 zeros at the start; the
    policy starts it afresh whenever its batch size changes, as the
    reference's does."""

    def __init__(self, action_space, config, model_config=None):
        super().__init__(action_space, config, model_config)
        cfg = self.config
        self.theta = float(cfg.get("ou_theta", 0.15))
        self.sigma = float(cfg.get("ou_sigma", 0.2))
        self.base_scale = float(cfg.get("ou_base_scale", 0.1))

    def initial_state(self, batch_size: int = 1, device=None) -> Tuple:
        dim = int(np.prod(self.action_space.shape))
        return (torch.zeros((batch_size, dim), dtype=torch.float32, device=device),)

    def _noise(self, normal, det, state):
        (x,) = state
        x = x + self.theta * (0.0 - x) + self.sigma * normal.reshape(x.shape)
        return self.base_scale * x.reshape(det.shape), (x,)


_REGISTRY = {
    "StochasticSampling": StochasticSampling,
    "EpsilonGreedy": EpsilonGreedy,
    "GaussianNoise": GaussianNoise,
    "OrnsteinUhlenbeckNoise": OrnsteinUhlenbeckNoise,
}


def register_exploration(name: str, cls) -> None:
    _REGISTRY[name] = cls


def postprocesses(exploration) -> bool:
    """Whether ``exploration`` does work of its own in
    ``postprocess_trajectory`` (Curiosity, RND)."""
    return type(exploration).postprocess_trajectory is not Exploration.postprocess_trajectory


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
            f"exploration type {typ!r} is not ported yet (ROADMAP.md queue 1 item 9); "
            f"ported: {sorted(_REGISTRY)}"
        )
    return cls(action_space, ec, model_config)
