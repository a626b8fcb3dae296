"""GTrXL attention network (gated transformer-XL for RL).

Counterpart of ``ray_tpu/models/attention.py``'s ``GTrXLNet``
(``model_config["use_attention"]``), with its parameter names
(``embed``, ``ln_{q,kv,mlp}_l``, ``{q,k,v,proj}_l``,
``gate_{attn,mlp}_l.{wr,ur,wz,uz,wg,ug,bz}``, ``mlp{0,1}_l``, ``logits``,
``value``). The memory of a unit is a (B, M, D) state tensor: the new
memory is ``concat([mem, x])[:, -M:]``, ``x`` the unit's input. The
relative positional embedding (descending positions, sin then cos) is
added to the keys' input only. Layer norms are flax's (epsilon 1e-6).

Attention over the [memory | fragment] window:

- act path (no ``resets``): query t sees every memory key and the
  fragment keys up to t, which is ``flash_attention(q, k, v,
  causal_offset=M)``, the hand-written kernel on the card, reading the
  (B, H, T, D) views of the projections where they are;
- learn path (``resets`` given): plain torch, as the reference computes
  it in XLA outside any Pallas kernel. Memory keys are always visible,
  fragment keys only within a segment (``cumsum(resets)``), and masked
  scores are ``-1e9`` (a row's softmax over masked keys stays finite).

The learn path trains from zero memory (``supports_stored_train_state``
False): the reference's documented approximation. Rollouts act with the
carried memory, so for a chunk that starts mid-episode the stored
``action_logp`` came from another memory than the train-time forward's.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models.base import Dense, LayerNorm, TorchModel
from ray_tpu_torch.ops.flash_attention import flash_attention

MASKED = -1e9  # the reference's fill for scores the learn path hides


class _GRUGate(nn.Module):
    def __init__(self, dim: int, init_bias: float = 2.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        for name in ("wr", "ur", "wz", "uz", "wg", "ug"):
            setattr(self, name, Dense(dim, dim, generator=generator, use_bias=False))
        self.bz = nn.Parameter(torch.full((dim,), float(init_bias)))

    def forward(self, x, y):
        """``x`` the residual input, ``y`` the transformed branch."""
        r = torch.sigmoid(self.wr(y) + self.ur(x))
        z = torch.sigmoid(self.wz(y) + self.uz(x) - self.bz)
        h = torch.tanh(self.wg(y) + self.ug(r * x))
        return (1.0 - z) * x + z * h


def _rel_positional_embedding(seq_len: int, dim: int, device=None) -> torch.Tensor:
    pos = torch.arange(seq_len - 1, -1, -1, dtype=torch.float32, device=device)
    inv_freq = 1.0 / (10000 ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    inp = pos[:, None] * inv_freq[None, :]
    return torch.cat([torch.sin(inp), torch.cos(inp)], dim=-1)


class GTrXLNet(TorchModel):
    def __init__(
        self,
        obs_size: int,
        num_outputs: int,
        attention_dim: int = 64,
        num_transformer_units: int = 1,
        num_heads: int = 2,
        head_dim: int = 32,
        memory_len: int = 50,
        position_wise_mlp_dim: int = 32,
        init_gru_gate_bias: float = 2.0,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        D, H, Dh = int(attention_dim), int(num_heads), int(head_dim)
        self.attention_dim, self.num_heads, self.head_dim = D, H, Dh
        self.num_transformer_units = int(num_transformer_units)
        self.memory_len = int(memory_len)
        self.embed = Dense(int(obs_size), D, generator=generator)
        for i in range(self.num_transformer_units):
            setattr(self, f"ln_q_{i}", LayerNorm(D))
            setattr(self, f"ln_kv_{i}", LayerNorm(D))
            for name in ("q", "k", "v"):
                setattr(self, f"{name}_{i}", Dense(D, H * Dh, generator=generator))
            setattr(self, f"proj_{i}", Dense(H * Dh, D, generator=generator))
            setattr(self, f"gate_attn_{i}", _GRUGate(D, init_gru_gate_bias, generator))
            setattr(self, f"ln_mlp_{i}", LayerNorm(D))
            setattr(self, f"mlp0_{i}", Dense(D, int(position_wise_mlp_dim), generator=generator))
            setattr(self, f"mlp1_{i}", Dense(int(position_wise_mlp_dim), D, generator=generator))
            setattr(self, f"gate_mlp_{i}", _GRUGate(D, init_gru_gate_bias, generator))
        self.logits = Dense(D, num_outputs, kernel_scale=0.01, generator=generator)
        self.value = Dense(D, 1, generator=generator)
        self._pos_cache: Dict = {}

    @property
    def is_recurrent(self) -> bool:
        return True

    def initial_state(self, batch_size: int = 1, device=None):
        return tuple(
            torch.zeros((batch_size, self.memory_len, self.attention_dim), device=device)
            for _ in range(self.num_transformer_units)
        )

    def _pos(self, seq_len: int, device) -> torch.Tensor:
        key = (seq_len, str(device))
        pos = self._pos_cache.get(key)
        if pos is None:
            pos = self._pos_cache[key] = _rel_positional_embedding(
                seq_len, self.attention_dim, device)
        return pos

    def _masked_attention(self, q, k, v, resets):
        """The learn path's attention: (B, H, T, Dh) queries against the
        (B, H, M + T, Dh) window, memory keys always visible and fragment
        keys within the query's segment and at or before it."""
        B, T, M = q.shape[0], q.shape[2], self.memory_len
        S = M + T
        dev = q.device
        seg = torch.cumsum(resets.to(torch.int32), dim=1)  # (B, T)
        band = torch.arange(S, device=dev)[None, :] - M <= torch.arange(T, device=dev)[:, None]
        frag_ok = seg[:, :, None] == seg[:, None, :]  # (B, T, T)
        mem_ok = torch.ones((B, T, M), dtype=torch.bool, device=dev)
        full_mask = band[None] & torch.cat([mem_ok, frag_ok], dim=-1)  # (B, T, S)
        scores = torch.einsum("bhtd,bhsd->bhts", q, k) / math.sqrt(self.head_dim)
        scores = torch.where(full_mask[:, None], scores, MASKED)
        return torch.einsum("bhts,bhsd->bhtd", torch.softmax(scores, dim=-1), v)

    def forward(self, obs, state, resets=None, prev_actions=None, prev_rewards=None):
        B, T = obs.shape[0], obs.shape[1]
        x = self.embed(obs.reshape(B, T, -1).float())
        M, H, Dh = self.memory_len, self.num_heads, self.head_dim
        S = M + T
        pos = self._pos(S, x.device)
        new_state = []
        for i in range(self.num_transformer_units):
            kv_in = torch.cat([state[i].float(), x], dim=1)  # (B, S, D)
            new_state.append(kv_in[:, -M:])
            ln_x = getattr(self, f"ln_q_{i}")(x)
            ln_kv = getattr(self, f"ln_kv_{i}")(kv_in)
            # (B, H, n, Dh) views over (B, n, H, Dh) memory
            q = getattr(self, f"q_{i}")(ln_x).reshape(B, T, H, Dh).transpose(1, 2)
            k = getattr(self, f"k_{i}")(ln_kv + pos).reshape(B, S, H, Dh).transpose(1, 2)
            v = getattr(self, f"v_{i}")(ln_kv).reshape(B, S, H, Dh).transpose(1, 2)
            if resets is None:
                out = flash_attention(q, k, v, causal_offset=M)
            else:
                out = self._masked_attention(q, k, v, resets)
            out = getattr(self, f"proj_{i}")(out.transpose(1, 2).reshape(B, T, H * Dh))
            x = getattr(self, f"gate_attn_{i}")(x, F.relu(out))
            mlp = F.relu(getattr(self, f"mlp0_{i}")(getattr(self, f"ln_mlp_{i}")(x)))
            mlp = getattr(self, f"mlp1_{i}")(mlp)
            x = getattr(self, f"gate_mlp_{i}")(x, F.relu(mlp))
        y = x.reshape(B * T, self.attention_dim)
        return self.logits(y), self.value(y).squeeze(-1), tuple(new_state)
