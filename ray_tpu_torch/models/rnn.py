"""Recurrent models: the LSTM wrapper and flax's GRU cell.

Counterpart of ``ray_tpu/models/rnn.py``'s ``LSTMWrapper``
(``model_config["use_lstm"]``): dense ``fc_i`` layers, then an LSTM cell
stepped over T, then the ``logits`` and ``value`` heads in float32.

The cell is flax's ``OptimizedLSTMCell``, with its parameter names:
input projections ``ii``, ``if``, ``ig``, ``io`` without bias, hidden
projections ``hi``, ``hf``, ``hg``, ``ho`` with bias; ``i, f, o = σ(·)``,
``g = tanh(·)``, ``c' = f·c + i·g`` and ``h' = o·tanh(c')``. The input
projections of all T steps are one product before the loop (they do not
depend on the carry); each step adds the hidden projection, bias
included, to its slice, in flax's order (hidden + input).

The loop is Python over torch operations. cuDNN's ``nn.LSTM`` cannot
restart the carry inside a sequence, which the per-step ``resets`` mask
does here: it multiplies the carry before the step, so episode
boundaries inside an unroll need no re-chopping. The reference runs no
Pallas kernel here either.

Call contract: obs (B, T, ...); state ``(h, c)``, each (B, cell) — the
carry inside is ``(c, h)``, as flax's; returns logits (B·T,
num_outputs), value (B·T,) and the state after the last step.
``prev_actions`` enter as the raw action cast to float and reshaped to
(B, T, -1) (a Discrete action is its index, not a one-hot) and
``prev_rewards`` as (B, T, 1), when the model was built to read them.

:class:`GRUCell` is flax's ``nn.GRUCell`` (QMIX's agent net), with its
parameter names: input projections ``ir``, ``iz``, ``in`` with bias,
hidden projections ``hr`` and ``hz`` without, ``hn`` with; ``r =
σ(ir(x) + hr(h))``, ``z = σ(iz(x) + hz(h))``, ``n = tanh(in(x) + r ·
hn(h))``, ``h' = (1 - z) · n + z · h``. ``torch.nn.GRUCell`` has biases
on ``hr`` and ``hz`` too, so the cell is written out, and
:func:`gru_unroll` steps it over T as :func:`lstm_unroll` steps the LSTM.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ray_tpu_torch.models.base import Dense, TorchModel, get_activation

GATES = ("i", "f", "g", "o")
GRU_GATES = ("r", "z", "n")


class OptimizedLSTMCell(nn.Module):
    def __init__(self, in_features: int, cell_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        for gate in GATES:
            # flax: LeCun-normal input kernels, orthogonal hidden ones
            setattr(self, f"i{gate}", Dense(in_features, cell_size, generator=generator,
                                            use_bias=False))
            hidden = Dense(cell_size, cell_size, generator=generator)
            with torch.no_grad():
                nn.init.orthogonal_(hidden.weight, generator=generator)
            setattr(self, f"h{gate}", hidden)

    def input_weight(self) -> torch.Tensor:
        """(4·cell, in): the four input kernels stacked in gate order."""
        return torch.cat([getattr(self, f"i{g}").weight for g in GATES])

    def hidden_weight_bias(self):
        return (torch.cat([getattr(self, f"h{g}").weight for g in GATES]),
                torch.cat([getattr(self, f"h{g}").bias for g in GATES]))


class LSTMWrapper(TorchModel):
    def __init__(
        self,
        in_size: int,
        num_outputs: int,
        cell_size: int = 256,
        hiddens: Sequence[int] = (256,),
        activation: str = "tanh",
        use_prev_action: bool = False,
        use_prev_reward: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        """``in_size``: the observation's flat size, plus the action's
        when ``use_prev_action`` and 1 when ``use_prev_reward``."""
        super().__init__()
        self.cell_size = int(cell_size)
        self.act = get_activation(activation)
        self.use_prev_action = bool(use_prev_action)
        self.use_prev_reward = bool(use_prev_reward)
        self.num_hiddens = len(hiddens)
        sizes = [int(in_size), *hiddens]
        for i in range(self.num_hiddens):
            setattr(self, f"fc_{i}", Dense(sizes[i], sizes[i + 1], generator=generator))
        self.OptimizedLSTMCell_0 = OptimizedLSTMCell(sizes[-1], self.cell_size, generator)
        self.logits = Dense(self.cell_size, num_outputs, kernel_scale=0.01, generator=generator)
        self.value = Dense(self.cell_size, 1, generator=generator)

    @property
    def is_recurrent(self) -> bool:
        return True

    @property
    def supports_stored_train_state(self) -> bool:
        return True

    def initial_state(self, batch_size: int = 1, device=None):
        return tuple(torch.zeros((batch_size, self.cell_size), device=device) for _ in range(2))

    def forward(self, obs, state, resets=None, prev_actions=None, prev_rewards=None):
        B, T = obs.shape[0], obs.shape[1]
        x = obs.float().reshape(B, T, -1)
        extras = []
        if self.use_prev_action and prev_actions is not None:
            extras.append(prev_actions.float().reshape(B, T, -1))
        if self.use_prev_reward and prev_rewards is not None:
            extras.append(prev_rewards.float().reshape(B, T, 1))
        if extras:
            x = torch.cat([x] + extras, dim=-1)
        for i in range(self.num_hiddens):
            x = self.act(getattr(self, f"fc_{i}")(x))

        y, (h, c) = lstm_unroll(self.OptimizedLSTMCell_0, x, state[0], state[1], resets)
        y = y.reshape(B * T, self.cell_size)
        return self.logits(y), self.value(y).squeeze(-1), (h, c)


def lstm_unroll(cell: OptimizedLSTMCell, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                resets: Optional[torch.Tensor] = None):
    """``cell`` stepped over x (B, T, in) from ``(h, c)``, each (B,
    cell), the carry multiplied by ``1 - resets[:, t]`` before step t:
    ``(y (B, T, cell), (h, c) after the last step)``."""
    T = x.shape[1]
    xi = torch.nn.functional.linear(x, cell.input_weight())  # (B, T, 4·cell)
    w_h, b_h = cell.hidden_weight_bias()
    keep = None if resets is None else 1.0 - resets.float()
    h, c = h.float(), c.float()
    ys = []
    for t in range(T):
        if keep is not None:
            k = keep[:, t, None]
            c, h = c * k, h * k
        gates = torch.nn.functional.linear(h, w_h, b_h) + xi[:, t]
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys, dim=1), (h, c)


class GRUCell(nn.Module):
    """flax's ``nn.GRUCell``: LeCun-normal input kernels, orthogonal
    hidden kernels, zero biases."""

    def __init__(self, in_features: int, cell_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cell_size = int(cell_size)
        for gate in GRU_GATES:
            setattr(self, f"i{gate}", Dense(in_features, cell_size, generator=generator))
            hidden = Dense(cell_size, cell_size, generator=generator, use_bias=gate == "n")
            with torch.no_grad():
                nn.init.orthogonal_(hidden.weight, generator=generator)
            setattr(self, f"h{gate}", hidden)

    def input_projection(self, x: torch.Tensor) -> torch.Tensor:
        """(..., 3·cell): ``ir(x)``, ``iz(x)``, ``in(x)`` side by side."""
        w = torch.cat([getattr(self, f"i{g}").weight for g in GRU_GATES])
        b = torch.cat([getattr(self, f"i{g}").bias for g in GRU_GATES])
        return torch.nn.functional.linear(x, w, b)

    def step(self, xi: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """One step from the input projection ``xi`` (B, 3·cell) and the
        carry ``h`` (B, cell): the new carry."""
        w_h = torch.cat([getattr(self, f"h{g}").weight for g in GRU_GATES])
        hh = torch.nn.functional.linear(h, w_h)
        x_r, x_z, x_n = xi.chunk(3, dim=-1)
        h_r, h_z, h_n = hh.chunk(3, dim=-1)
        r = torch.sigmoid(x_r + h_r)
        z = torch.sigmoid(x_z + h_z)
        n = torch.tanh(x_n + r * (h_n + self.hn.bias))
        return (1.0 - z) * n + z * h

    def forward(self, h: torch.Tensor, x: torch.Tensor):
        """flax's call: ``(carry, inputs) -> (new carry, output)``."""
        h = self.step(self.input_projection(x), h)
        return h, h


def gru_unroll(cell: GRUCell, x: torch.Tensor, h: torch.Tensor,
               resets: Optional[torch.Tensor] = None):
    """``cell`` stepped over x (B, T, in) from ``h`` (B, cell), the carry
    multiplied by ``1 - resets[:, t]`` before step t: ``(y (B, T,
    cell), h after the last step)``. The input projections of all T
    steps are one product before the loop."""
    xi = cell.input_projection(x)
    keep = None if resets is None else 1.0 - resets.float()
    h = h.float()
    ys = []
    for t in range(x.shape[1]):
        if keep is not None:
            h = h * keep[:, t, None]
        h = cell.step(xi[:, t], h)
        ys.append(h)
    return torch.stack(ys, dim=1), h
