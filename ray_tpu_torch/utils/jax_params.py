"""Load the JAX package's parameters and Adam state into the port.

Takes plain numpy trees (what ``jax.device_get`` returns; nothing here
imports JAX) and maps flax's layouts onto the port's:

- ``{"params": {"conv_0": {"kernel", "bias"}, ...}}`` → the module's
  parameters of the same layer name (``conv_0.weight``, ...);
- conv kernels HWIO → OIHW;
- dense kernels (in, out) → (out, in).

Flax flattens its last conv map in (H, W, C) order. The port's
``VisionNet`` flattens its NCHW map in that same (H, W, C) order, so
``post_fc_0``'s rows need no permutation: the kernel is only transposed.

Layer names pass through unchanged, except the flax ``DQNModel``'s
private ones (:data:`FLAX_RENAMES`): ``_convs_i`` → ``conv_i``,
``_fcs_i`` → ``fc_i``, ``_adv_head`` → ``adv_head``, ``_value_head`` →
``value_head``.

Models that are not flax modules (the transformer torso) keep a plain
nested dict with no ``"params"`` collection; the port's module keeps
their names and layouts, so such a tree maps leaf for leaf, its path
joined with dots (:func:`plain_to_state_dict`).
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn


# (flax layer-name pattern, port layer name)
FLAX_RENAMES = (
    (re.compile(r"^_convs_(\d+)$"), r"conv_\1"),
    (re.compile(r"^_fcs_(\d+)$"), r"fc_\1"),
    (re.compile(r"^_adv_head$"), "adv_head"),
    (re.compile(r"^_value_head$"), "value_head"),
)


def port_layer_name(flax_name: str) -> str:
    for pattern, repl in FLAX_RENAMES:
        if pattern.match(flax_name):
            return pattern.sub(repl, flax_name)
    return flax_name


def flax_to_state_dict(tree) -> Dict[str, np.ndarray]:
    """Flax param tree → ``{"layer.weight" | "layer.bias": array}`` in
    PyTorch layouts and the port's layer names."""
    params = tree.get("params", tree)
    out = {}
    for flax_layer, leaves in params.items():
        layer = port_layer_name(flax_layer)
        kernel = np.asarray(leaves["kernel"])
        if kernel.ndim == 4:  # HWIO → OIHW
            out[f"{layer}.weight"] = np.transpose(kernel, (3, 2, 0, 1))
        elif kernel.ndim == 2:  # (in, out) → (out, in)
            out[f"{layer}.weight"] = kernel.T
        else:
            raise ValueError(f"{layer}: unexpected kernel rank {kernel.ndim}")
        out[f"{layer}.bias"] = np.asarray(leaves["bias"])
    return out


def plain_to_state_dict(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A plain nested-dict param tree → ``{"a.b.leaf": array}``, layouts
    unchanged."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(plain_to_state_dict(value, name + "."))
        else:
            out[name] = np.asarray(value)
    return out


def to_state_dict(tree) -> Dict[str, np.ndarray]:
    """A flax tree (a ``"params"`` collection) through
    :func:`flax_to_state_dict`, any other nested dict through
    :func:`plain_to_state_dict`."""
    if "params" in tree:
        return flax_to_state_dict(tree)
    return plain_to_state_dict(tree)


def from_jax_params(tree, module: nn.Module) -> nn.Module:
    """Copy a reference param tree into ``module`` in place; every
    parameter of the module must be covered, with matching shapes."""
    sd = to_state_dict(tree)
    own = dict(module.named_parameters())
    if set(sd) != set(own):
        raise ValueError(
            "flax tree and module disagree: missing "
            f"{sorted(set(own) - set(sd))}, extra {sorted(set(sd) - set(own))}"
        )
    with torch.no_grad():
        for name, p in own.items():
            src = torch.tensor(np.asarray(sd[name]))
            if src.shape != p.shape:
                raise ValueError(f"{name}: {tuple(src.shape)} != {tuple(p.shape)}")
            p.copy_(src)
    return module


def _find_adam(opt_state):
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _find_adam(s)
            if found is not None:
                return found
    return None


def from_jax_adam_state(opt_state) -> Tuple[int, Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """optax chain state (numpy leaves) → ``(count, mu, nu)`` with the
    moments keyed and laid out like :func:`to_state_dict`."""
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no scale_by_adam state in the optax state")
    return (
        int(np.asarray(adam.count)),
        to_state_dict(adam.mu),
        to_state_dict(adam.nu),
    )
