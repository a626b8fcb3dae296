"""Env registry and creation.

Counterpart of ``ray_tpu/env/registry.py``. The port's tensor envs
register under the reference's names (``PongLiteJax-v0``,
``CartPoleJax-v0``, ``GridRoomsJax-v0``), so the
reference's tuned-example configs run unchanged; ``-Jax`` in a name
means "runs on the device" here.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

_env_registry: Dict[str, Callable[[Dict], Any]] = {}


def register_env(name: str, creator: Callable[[Dict], Any]) -> None:
    _env_registry[name] = creator


def get_env_creator(env_spec) -> Callable[[Dict], Any]:
    """env_spec: a registered name, an env class, or a callable."""
    if callable(env_spec) and not isinstance(env_spec, str):
        return env_spec
    if env_spec not in _env_registry:
        # in-repo envs register on import
        if str(env_spec).startswith("PongLite"):
            import ray_tpu_torch.env.pong_lite_tensor  # noqa: F401
        elif str(env_spec).startswith(("CartPoleJax", "GridRoomsJax")):
            import ray_tpu_torch.env.control_tensor  # noqa: F401
    try:
        return _env_registry[env_spec]
    except KeyError:
        raise ValueError(
            f"unknown env {env_spec!r}; registered: {sorted(_env_registry)}"
        ) from None
