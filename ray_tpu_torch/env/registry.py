"""Env registry and creation.

Counterpart of ``ray_tpu/env/registry.py``. The port's envs register
under the reference's names, so the reference's tuned-example configs
run unchanged: the host envs ``PongLite-v0`` and ``PongLiteFlat-v0``
(``env/pong_lite.py``, the actor lane's), ``Pendulum-v1`` and
``CartPole-v1`` (``env/pendulum.py``, ``env/cartpole.py``: gymnasium's
dynamics written out, so the card's machine, which has no gymnasium,
runs the Pendulum and CartPole configs), and the
tensor envs ``PongLiteJax-v0``, ``CartPoleJax-v0`` and
``GridRoomsJax-v0`` (the device lane's; ``-Jax`` in a name means "runs
on the device" here), and ``SyntheticFast-v0`` (``env/synthetic_env.py``,
a near-free host env).

A name nobody registered is taken for a gymnasium id, as in the
reference: the creator imports gymnasium when it makes the env, and
nothing else in the port needs gymnasium. Gymnasium's spaces pass as
they are: the catalog, the preprocessors and the sampler read spaces by
their attributes (``shape``, ``dtype``, ``n``, ``low``/``high``), not by
class.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

_env_registry: Dict[str, Callable[[Dict], Any]] = {}

# in-repo env names → the module that registers them on import
_IN_REPO = {
    "PongLite-v0": "ray_tpu_torch.env.pong_lite",
    "PongLiteFlat-v0": "ray_tpu_torch.env.pong_lite",
    "Pendulum-v1": "ray_tpu_torch.env.pendulum",
    "CartPole-v1": "ray_tpu_torch.env.cartpole",
    "PongLiteJax-v0": "ray_tpu_torch.env.pong_lite_tensor",
    "CartPoleJax-v0": "ray_tpu_torch.env.control_tensor",
    "GridRoomsJax-v0": "ray_tpu_torch.env.control_tensor",
    "SyntheticFast-v0": "ray_tpu_torch.env.synthetic_env",
}
_IN_REPO_PREFIXES = ("PongLite", "CartPoleJax", "GridRoomsJax", "SyntheticFast")


def register_env(name: str, creator: Callable[[Dict], Any]) -> None:
    _env_registry[name] = creator


class GymCreator:
    """Creator of a gymnasium env by id (picklable, so a rollout worker
    process can be handed it)."""

    def __init__(self, env_id: str):
        self.env_id = env_id

    def __call__(self, cfg):
        import gymnasium as gym

        return gym.make(
            self.env_id, **{k: v for k, v in dict(cfg or {}).items() if k != "render_mode"}
        )


def get_env_creator(env_spec) -> Callable[[Dict], Any]:
    """env_spec: a registered name, a gymnasium id, an env class, or a
    callable."""
    if callable(env_spec) and not isinstance(env_spec, str):
        return env_spec
    if env_spec not in _env_registry and env_spec in _IN_REPO:
        import importlib

        importlib.import_module(_IN_REPO[env_spec])
    if env_spec in _env_registry:
        return _env_registry[env_spec]
    if isinstance(env_spec, str) and env_spec.startswith(_IN_REPO_PREFIXES):
        # an in-repo prefix with no such env: fail here, with the real
        # names, not as a gymnasium error inside every worker
        raise ValueError(
            f"unknown in-repo env {env_spec!r}; in-repo: {sorted(_IN_REPO)}"
        )
    return GymCreator(env_spec)
