"""Recurrent (LSTM) model wrapper.

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
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ray_tpu_torch.models.base import Dense, TorchModel, get_activation

GATES = ("i", "f", "g", "o")


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
