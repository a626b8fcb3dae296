"""Dueling, distributional and noisy Q-network for the DQN family.

Counterpart of ``ray_tpu/algorithms/dqn/dqn_model.py`` (``DQNModel``,
``NoisyDense``, ``categorical_projection``): a trunk (the Nature CNN for
image observations, an MLP otherwise), then hidden float32 layers and
the Q heads. Image trunks compute in bfloat16 (the reference's
``conv_dtype``) after casting uint8 pixels and dividing by 255, and
flatten their last map in (H, W, C) order as flax does; the hidden
layers and heads run in float32, as the reference's ``nn.Dense`` on a
float32 input.

- **Dueling** combines per atom: ``support = V + A - mean_a(A)``.
- **C51** (``num_atoms > 1``): the heads give (B, A, atoms) support
  logits; Q is ``sum(softmax(logits) * z)`` over the fixed support
  ``z`` (:func:`c51_support`, the reference's float32 ``linspace``).
- **NoisyNet** (``noisy=True``): both heads are :class:`NoisyDense`
  layers. Their noise is explicit: :meth:`DQNModel.draw_noise` takes one
  forward's standard normals from a generator, in the reference's
  order (advantage head's ε_in, ε_out, then the value head's), and
  ``q_dist(obs, noise)`` reads them, so tests can inject the
  reference's draws; ``noise=None`` uses the mean weights (evaluation).

``forward(obs, noise=None)`` returns ``(q_values, max_a q, ())``, the
model contract of the port, so the action path (Categorical over Q,
EpsilonGreedy) works unchanged. Layer names map onto the flax module's
(``_convs_i`` → ``conv_i``, ``_fcs_i`` → ``fc_i``, ``_adv_head``,
``_value_head``; a noisy head keeps flax's ``w_mu``, ``w_sigma``,
``b_mu`` and ``b_sigma`` in flax's (in, out) layout; see
``utils/jax_params.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.models.base import Conv, Dense, TorchModel, get_activation
from ray_tpu_torch.models.cnn import get_filter_config

Noise = Tuple[torch.Tensor, ...]


def c51_support(v_min: float, v_max: float, num_atoms: int) -> np.ndarray:
    """The reference's ``jnp.linspace(v_min, v_max, num_atoms)`` in
    float32, bitwise, as XLA compiles it: ``v_min * (1 - i * r) + i *
    (v_max * r)`` with ``r = 1 / (num_atoms - 1)``, the last product
    fused into the sum (one rounding), and ``v_max`` itself at the end."""
    f32, f64 = np.float32, np.float64
    if num_atoms == 1:
        return np.array([v_min], f32)
    div = num_atoms - 1
    it = np.arange(div, dtype=f32)
    r = f32(1.0) / f32(div)
    head = f32(v_min) * (f32(1.0) - it * r)
    fused = it.astype(f64) * f64(f32(v_max) * r) + head.astype(f64)
    return np.concatenate([fused.astype(f32), np.array([v_max], f32)])


def _f(eps: torch.Tensor) -> torch.Tensor:
    return torch.sign(eps) * torch.sqrt(torch.abs(eps))


class NoisyDense(nn.Module):
    """Factorised-Gaussian noisy linear layer: ``w = μ_w + σ_w ·
    (f(ε_in) f(ε_out)ᵀ)``, ``b = μ_b + σ_b · f(ε_out)``, ``f(x) =
    sign(x)·√|x|``. μ_w is flax's ``variance_scaling(1/3, "fan_in",
    "uniform")``, σ starts at ``sigma0 / √fan_in`` and μ_b at 0."""

    def __init__(self, in_features: int, features: int, sigma0: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features, self.features = int(in_features), int(features)
        limit = math.sqrt(1.0 / in_features)  # sqrt(3 * (1/3) / fan_in)
        w_mu = torch.empty(in_features, features)
        with torch.no_grad():
            w_mu.uniform_(-limit, limit, generator=generator)
        sigma_init = sigma0 / np.sqrt(in_features)
        self.w_mu = nn.Parameter(w_mu)
        self.w_sigma = nn.Parameter(torch.full((in_features, features), float(sigma_init)))
        self.b_mu = nn.Parameter(torch.zeros(features))
        self.b_sigma = nn.Parameter(torch.full((features,), float(sigma_init)))

    def noise_shapes(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """One forward's (ε_in, ε_out) shapes, with a leading dim of 1."""
        return (1, self.in_features, 1), (1, 1, self.features)

    def forward(self, x: torch.Tensor, eps: Optional[Noise] = None) -> torch.Tensor:
        """``eps``: (ε_in, ε_out) standard normals of shapes (N, in, 1)
        and (N, 1, features); N = 1 is one noise for the whole batch (the
        reference's layer), N = len(x) one per row (a vectorized serve
        bucket of single requests). None: the mean weights."""
        if eps is None:
            return x @ self.w_mu + self.b_mu
        e_in, e_out = _f(eps[0]), _f(eps[1])
        if e_in.shape[0] == 1:
            w = self.w_mu + self.w_sigma * (e_in[0] * e_out[0])
            b = self.b_mu + self.b_sigma * e_out[0, 0]
            return x @ w + b
        w = self.w_mu + self.w_sigma * (e_in * e_out)
        b = self.b_mu + self.b_sigma * e_out[:, 0]
        return torch.bmm(x[:, None, :], w)[:, 0] + b


class DQNModel(TorchModel):
    def __init__(
        self,
        obs_shape: Sequence[int],
        num_outputs: int,
        hiddens: Sequence[int] = (256, 256),
        activation: str = "tanh",
        use_conv: bool = False,
        conv_filters: Optional[Tuple] = None,
        conv_activation: str = "relu",
        conv_dtype: str = "bfloat16",
        num_atoms: int = 1,
        v_min: float = -10.0,
        v_max: float = 10.0,
        dueling: bool = True,
        noisy: bool = False,
        sigma0: float = 0.5,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.num_outputs = int(num_outputs)
        self.num_atoms = int(num_atoms)
        self.use_conv = use_conv
        self.dueling = dueling
        self.noisy = bool(noisy)
        self.conv_dtype = getattr(torch, conv_dtype)
        self.act = get_activation(activation)
        self.conv_act = get_activation(conv_activation)
        if use_conv:
            filters = conv_filters or get_filter_config((84, 84, 4))
            h, w, c = obs_shape
            self.num_convs = len(filters)
            for i, (out_ch, kernel, stride) in enumerate(filters):
                setattr(self, f"conv_{i}", Conv(
                    c, out_ch, kernel, stride, self.conv_dtype, generator
                ))
                h = (h - kernel[0]) // stride[0] + 1
                w = (w - kernel[1]) // stride[1] + 1
                c = out_ch
            flat = h * w * c
        else:
            self.num_convs = 0
            flat = int(np.prod(obs_shape))
        sizes = [flat, *hiddens]
        self.num_fcs = len(hiddens)
        for i in range(self.num_fcs):
            setattr(self, f"fc_{i}", Dense(
                sizes[i], sizes[i + 1], torch.float32, generator=generator
            ))

        def head(n):
            if self.noisy:
                return NoisyDense(sizes[-1], n, sigma0, generator)
            return Dense(sizes[-1], n, torch.float32, generator=generator)

        self.adv_head = head(self.num_outputs * self.num_atoms)
        if dueling:
            self.value_head = head(self.num_atoms)
        # the C51 support, a buffer so it follows the model's device
        self.v_min, self.v_max = float(v_min), float(v_max)
        self.register_buffer(
            "support", torch.from_numpy(c51_support(v_min, v_max, self.num_atoms)),
            persistent=False,
        )
        # the projection's bin width (see categorical_projection)
        self.register_buffer(
            "dz", torch.tensor((v_max - v_min) / max(1, self.num_atoms - 1), dtype=torch.float32),
            persistent=False,
        )

    # -- noise ---------------------------------------------------------------

    def noise_shapes(self) -> Tuple[Tuple[int, ...], ...]:
        """The shapes of one forward's normals, in draw order (none
        without ``noisy``)."""
        if not self.noisy:
            return ()
        heads = [self.adv_head] + ([self.value_head] if self.dueling else [])
        return tuple(s for h in heads for s in h.noise_shapes())

    def draw_noise(self, generator: Optional[torch.Generator], device=None) -> Noise:
        """One forward's standard normals from ``generator``, in the
        reference's order: the advantage head's ε_in and ε_out, then the
        value head's."""
        device = device or self.support.device
        return tuple(torch.randn(s, generator=generator, device=device)
                     for s in self.noise_shapes())

    def _head(self, layer, x, noise: Optional[Noise]):
        return layer(x) if noise is None else layer(x, noise)

    # -- forward -------------------------------------------------------------

    def features(self, obs: torch.Tensor) -> torch.Tensor:
        if self.use_conv:
            x = obs.to(self.conv_dtype)
            if obs.dtype == torch.uint8:
                x = x / 255.0
            x = x.permute(0, 3, 1, 2)
            for i in range(self.num_convs):
                x = self.conv_act(getattr(self, f"conv_{i}")(x))
            # flatten in (H, W, C) order, as flax flattens NHWC
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).float()
        else:
            x = obs.float().reshape(obs.shape[0], -1)
        for i in range(self.num_fcs):
            x = self.act(getattr(self, f"fc_{i}")(x))
        return x

    def q_dist(self, obs: torch.Tensor, noise: Optional[Noise] = None):
        """``(q (B, A), support logits (B, A, atoms), probs (B, A, atoms)
        or None when num_atoms == 1)``. ``noise``: :meth:`draw_noise`'s
        tensors (the noisy heads' ε), or None for the mean weights."""
        feat = self.features(obs)
        adv_noise = value_noise = None
        if noise is not None and self.noisy:
            adv_noise, value_noise = noise[:2], noise[2:4]
        adv = self._head(self.adv_head, feat, adv_noise).reshape(
            -1, self.num_outputs, self.num_atoms
        )
        if self.dueling:
            value = self._head(self.value_head, feat, value_noise).reshape(-1, 1, self.num_atoms)
            support = value + adv - adv.mean(dim=1, keepdim=True)
        else:
            support = adv
        if self.num_atoms > 1:
            probs = torch.softmax(support, dim=-1)
            q = torch.sum(probs * self.support, dim=-1)
            return q, support, probs
        return support[..., 0], support, None

    def q_values(self, obs: torch.Tensor, noise: Optional[Noise] = None) -> torch.Tensor:
        """(B, num_actions) Q values."""
        return self.q_dist(obs, noise)[0]

    def forward(self, obs: torch.Tensor, noise: Optional[Noise] = None, full: bool = False):
        """``(q, max_a q, ())``; with ``full``, :meth:`q_dist`'s triple
        (so ``functional_call`` reaches it with other parameters)."""
        if full:
            return self.q_dist(obs, noise)
        q = self.q_values(obs, noise)
        return q, q.max(dim=-1).values, ()


def categorical_projection(
    next_probs: torch.Tensor,
    rewards: torch.Tensor,
    bootstrap_discount: torch.Tensor,
    not_done: torch.Tensor,
    v_min: float,
    v_max: float,
    support: Optional[torch.Tensor] = None,
    dz: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The C51 Bellman projection: shift the support by the n-step
    Bellman operator, clip it to ``[v_min, v_max]`` and split each
    atom's mass between its two neighbouring bins (all of it to one when
    it lands on a bin). ``next_probs``: (B, atoms) target probabilities
    of the chosen next action; returns the projected (B, atoms).

    The reference contracts one-hot matrices (``einsum("ba,bax->bx")``),
    which its CPU sums over the source atoms in ascending order. Here
    each bin takes its sources' masses in that same order, one atom at a
    time, so the sums are the reference's bitwise on the CPU, and fixed
    in order (not an atomic scatter) on the card. ``support`` and the
    0-d float32 bin width ``dz`` are made here when not given (a caller
    inside a captured graph passes its own: a graph cannot copy from the
    host); dividing by a device tensor divides, where CUDA would
    multiply by the reciprocal of a Python number."""
    num_atoms = next_probs.shape[-1]
    if support is None:
        support = torch.from_numpy(c51_support(v_min, v_max, num_atoms)).to(next_probs.device)
    if dz is None:
        dz = torch.tensor((v_max - v_min) / (num_atoms - 1), dtype=torch.float32,
                          device=next_probs.device)
    tz = rewards[:, None] + (bootstrap_discount * not_done)[:, None] * support[None, :]
    tz = torch.clamp(tz, v_min, v_max)
    b = (tz - v_min) / dz
    low = torch.floor(b)
    high = torch.ceil(b)
    w_low = (high - b) + (low == high).to(b.dtype)
    w_high = b - low
    bins = torch.arange(num_atoms, device=next_probs.device, dtype=b.dtype)

    def spread(mass, index):
        out = torch.zeros_like(mass)
        for a in range(num_atoms):
            out = out + mass[:, a, None] * (index[:, a, None] == bins).to(mass.dtype)
        return out

    return spread(next_probs * w_low, low) + spread(next_probs * w_high, high)
