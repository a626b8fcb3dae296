"""V-trace off-policy correction (IMPALA, APPO) on batch-major (B, T) tensors.

Counterpart of ``ray_tpu/ops/vtrace.py``. The backward recurrence

    y[t] = delta[t] + discount[t] * c[t] * y[t + 1]

is first-order linear, so it runs as a reverse doubling scan over T:
after round j every element holds the recurrence over its next 2^j
steps, so ceil(log2 T) rounds of four elementwise ops cover the
fragment, where a Python loop would launch T rounds. The reference
scans with ``lax.associative_scan``, which combines in another tree
order, so the two agree to float32 rounding (the tests hold 1e-5
relative), not bitwise. The reference has no Pallas kernel here and the
port has no CUDA kernel either: this is plain PyTorch on whatever
device its inputs are on.

``vs`` and ``pg_advantages`` come back detached, as the reference's
``stop_gradient``; :func:`vtrace_from_logits` detaches its log ratios.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


class VTraceReturns(NamedTuple):
    vs: torch.Tensor  # (B, T) V-trace value targets
    pg_advantages: torch.Tensor  # (B, T) policy-gradient advantages


def _shift_left(x: torch.Tensor, s: int) -> torch.Tensor:
    """``x[..., t + s]``, zero past the end."""
    return F.pad(x[..., s:], (0, s))


def linear_recurrence_reverse(coeffs: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """``y[t] = deltas[t] + coeffs[t] * y[t + 1]`` along the last axis,
    ``y[T] = 0``, in ceil(log2 T) doubling rounds: (a, b) at t stands
    for ``y[t] = b[t] + a[t] * y[t + s]``, and a round substitutes the
    same relation at t + s, doubling s."""
    a, b = coeffs, deltas
    s, T = 1, deltas.shape[-1]
    while s < T:
        b = b + a * _shift_left(b, s)
        a = a * _shift_left(a, s)
        s *= 2
    return b


def vtrace_from_importance_weights(
    log_rhos: torch.Tensor,
    discounts: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    clip_rho_threshold: Optional[float] = 1.0,
    clip_pg_rho_threshold: Optional[float] = 1.0,
) -> VTraceReturns:
    """V-trace from log importance weights: ``log_rhos``, ``discounts``
    (gamma * (1 - done)), ``rewards`` and ``values`` are (B, T);
    ``bootstrap_value`` is the (B,) value after the last step."""
    rhos = torch.exp(log_rhos)
    clipped_rhos = rhos if clip_rho_threshold is None else torch.clamp(rhos, max=clip_rho_threshold)
    cs = torch.clamp(rhos, max=1.0)
    values_tp1 = torch.cat([values[:, 1:], bootstrap_value[:, None]], dim=1)
    deltas = clipped_rhos * (rewards + discounts * values_tp1 - values)

    vs = linear_recurrence_reverse(discounts * cs, deltas) + values

    vs_tp1 = torch.cat([vs[:, 1:], bootstrap_value[:, None]], dim=1)
    clipped_pg_rhos = (
        rhos if clip_pg_rho_threshold is None else torch.clamp(rhos, max=clip_pg_rho_threshold)
    )
    pg_advantages = clipped_pg_rhos * (rewards + discounts * vs_tp1 - values)
    return VTraceReturns(vs=vs.detach(), pg_advantages=pg_advantages.detach())


def vtrace_from_logits(
    behaviour_action_log_probs: torch.Tensor,
    target_action_log_probs: torch.Tensor,
    discounts: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    bootstrap_value: torch.Tensor,
    clip_rho_threshold: Optional[float] = 1.0,
    clip_pg_rho_threshold: Optional[float] = 1.0,
) -> VTraceReturns:
    """V-trace from the behaviour and target policies' log-probabilities
    of the taken actions, each (B, T)."""
    log_rhos = (target_action_log_probs - behaviour_action_log_probs).detach()
    return vtrace_from_importance_weights(
        log_rhos=log_rhos,
        discounts=discounts,
        rewards=rewards,
        values=values,
        bootstrap_value=bootstrap_value,
        clip_rho_threshold=clip_rho_threshold,
        clip_pg_rho_threshold=clip_pg_rho_threshold,
    )
