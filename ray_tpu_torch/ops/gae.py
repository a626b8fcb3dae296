"""Generalized Advantage Estimation over fixed (N, T) fragments.

Counterpart of ``ray_tpu/ops/gae.py``. :func:`compute_gae_fragment` is
the device rollout lane's postprocess: on CUDA tensors it is one launch
of the hand-written kernel in ``csrc/gae_scan.cu``; on CPU tensors it
runs :func:`compute_gae_fragment_plain`, the same sequential recurrence
in plain PyTorch, with the same operation order (so the two agree
bitwise on the card). A CUDA tensor launches the kernel or raises.

The numpy golden versions ``discount_cumsum_np`` and ``compute_gae_np``
are copies of the JAX package's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ray_tpu_torch.ops import _kernels
from ray_tpu_torch.telemetry import device as device_ledger


def discount_cumsum_np(x: np.ndarray, gamma: float) -> np.ndarray:
    """y[t] = sum_{k>=t} gamma^(k-t) x[k] (host/numpy golden version)."""
    out = np.zeros_like(x, dtype=np.float32)
    run = 0.0
    for t in range(len(x) - 1, -1, -1):
        run = x[t] + gamma * run
        out[t] = run
    return out


def compute_gae_np(
    rewards: np.ndarray,
    values: np.ndarray,
    dones: np.ndarray,
    bootstrap_value: float,
    gamma: float = 0.99,
    lambda_: float = 1.0,
):
    """Host/numpy GAE over a single trajectory (golden version): if the
    trajectory was terminated, ``bootstrap_value`` should be 0; if
    truncated, it is V(s_T)."""
    T = len(rewards)
    values_tp1 = np.append(values[1:], bootstrap_value)
    not_done = 1.0 - dones.astype(np.float32)
    deltas = rewards + gamma * values_tp1 * not_done - values
    adv = np.zeros(T, dtype=np.float32)
    run = 0.0
    for t in range(T - 1, -1, -1):
        run = deltas[t] + gamma * lambda_ * not_done[t] * run
        adv[t] = run
    value_targets = adv + values
    return adv.astype(np.float32), value_targets.astype(np.float32)


def compute_gae_fragment_plain(
    rewards: torch.Tensor,
    values: torch.Tensor,
    next_values: torch.Tensor,
    terminateds: torch.Tensor,
    dones: torch.Tensor,
    gamma: float = 0.99,
    lambda_: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch :func:`compute_gae_fragment`: the reverse recurrence
    as a loop over T, every operation rounded on its own."""
    rewards = rewards.float()
    values = values.float()
    not_term = 1.0 - terminateds.float()
    not_done = 1.0 - dones.float()
    deltas = rewards + gamma * next_values.float() * not_term - values
    coeffs = gamma * lambda_ * not_done
    adv = torch.empty_like(deltas)
    run = torch.zeros_like(deltas[:, 0])
    for t in range(deltas.shape[1] - 1, -1, -1):
        run = deltas[:, t] + coeffs[:, t] * run
        adv[:, t] = run
    return adv, adv + values


def compute_gae_fragment(
    rewards: torch.Tensor,
    values: torch.Tensor,
    next_values: torch.Tensor,
    terminateds: torch.Tensor,
    dones: torch.Tensor,
    gamma: float = 0.99,
    lambda_: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAE over (N, T) fragments with the host lane's truncation
    semantics: bootstrap 0 across a *terminated* step, ``next_values``
    (V of the final, pre-reset observation) across a *truncated* one,
    and stop the advantage accumulation at every episode boundary.

    rewards/values/next_values: (N, T) float; terminateds/dones: (N, T)
    bool with ``dones = terminateds | truncateds``. Returns
    ``(advantages, value_targets)``, both (N, T) float32."""
    if rewards.device.type == "cpu":
        return compute_gae_fragment_plain(
            rewards, values, next_values, terminateds, dones, gamma, lambda_
        )
    dev = rewards.device
    if dev.type != "cuda":
        raise ValueError(f"compute_gae_fragment: unsupported device {dev}")
    n, t = rewards.shape
    # copied or converted only where the kernel needs it: contiguous
    # float32 values and contiguous bool flags
    floats = [x if x.dtype == torch.float32 and x.is_contiguous() else x.float().contiguous()
              for x in (rewards, values, next_values)]
    flags = [x if x.dtype == torch.bool and x.is_contiguous() else x.to(torch.bool).contiguous()
             for x in (terminateds, dones)]
    for x in floats + flags:
        if x.shape != (n, t) or x.device != dev:
            raise ValueError(
                "compute_gae_fragment: all inputs must be (N, T) on "
                f"{dev}; got {tuple(x.shape)} on {x.device}"
            )
    adv = torch.empty((n, t), dtype=torch.float32, device=dev)
    vt = torch.empty((n, t), dtype=torch.float32, device=dev)
    lib = _kernels.library("gae_scan")
    rc = _kernels.launch(
        lib.gae_fragment_launch, dev,
        *(x.data_ptr() for x in floats + flags), adv.data_ptr(), vt.data_ptr(), n, t,
        float(gamma), float(gamma * lambda_),
    )
    if rc:
        _kernels.check(rc, lib, "gae_fragment_error_string", "gae_scan")
    compute_gae_fragment.launches += 1
    # three float inputs and two flags read once, two outputs written
    # once; seven operations an element (the delta's four, the
    # recurrence's two, the value target's one) (device ledger)
    if device_ledger.counting():
        device_ledger.add_kernel_cost(7 * n * t, 3 * n * t * 4 + 2 * n * t + 2 * n * t * 4)
    return adv, vt


compute_gae_fragment.launches = 0


def standardize(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Zero-mean unit-variance normalisation with the population
    standard deviation floored at ``eps``."""
    return (x - x.mean()) / torch.clamp_min(x.std(unbiased=False), eps)
