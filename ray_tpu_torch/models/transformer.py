"""Decoder-style transformer policy torso on one device.

Counterpart of ``ray_tpu/models/transformer.py``'s
``TransformerPolicyNet`` (``model_config["use_transformer"]``): the flat
observation is cut into ``seq_len`` tokens, projected to ``d_model``,
given a learned position embedding, run through pre-LN causal decoder
blocks (attention through :func:`~ray_tpu_torch.ops.flash_attention.flash_attention`,
the hand-written kernel on the card) and read out at the last token
into policy logits and a value.

Parameters keep the reference's names and layouts, so a reference
parameter tree maps onto the module leaf for leaf
(``utils/jax_params.py``): ``in_proj.kernel`` (tok, D), ``pos`` (S, D),
``layer_i.attn.wq|wk|wv`` (D, H, Dh), ``bq|bk|bv`` (H, Dh), ``wo``
(H, Dh, D), ``bo``, ``layer_i.ln1|ln2`` and ``ln_f`` (``scale``,
``bias``), ``layer_i.mlp.w_up|b_up|w_down|b_down``, ``logits`` and
``value`` (``kernel`` (in, out), ``bias``).

The reference's tensor-parallel regime (Megatron f/g collectives inside
a ``shard_map`` over the mesh's ``model`` axis, ``partition_rules``)
emits no collective on one device; it waits for the port's distributed
layer (ROADMAP queue 1, item 7).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models.base import TorchModel, variance_scaling_
from ray_tpu_torch.ops.flash_attention import flash_attention


class ParamGroup(nn.Module):
    """One dict of the reference's parameter tree: named tensors."""

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        for name, t in tensors.items():
            setattr(self, name, nn.Parameter(t))


def _layer_norm(x: torch.Tensor, p: ParamGroup, eps: float = 1e-5) -> torch.Tensor:
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p.scale + p.bias


class TransformerPolicyNet(TorchModel):
    def __init__(
        self,
        obs_size: int,
        num_outputs: int,
        d_model: int = 64,
        num_layers: int = 2,
        num_heads: int = 4,
        head_dim: Optional[int] = None,
        ff_dim: Optional[int] = None,
        seq_len: int = 8,
        dtype: str = "float32",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.num_outputs = int(num_outputs)
        self.d_model = int(d_model)
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim or self.d_model // self.num_heads)
        self.ff_dim = int(ff_dim or 4 * self.d_model)
        self.seq_len = int(seq_len)
        self.dtype = getattr(torch, dtype)
        self.tok = -(-int(obs_size) // self.seq_len)
        D, H, Dh, FF = self.d_model, self.num_heads, self.head_dim, self.ff_dim

        def init(shape, fan_in, scale=1.0):
            w = torch.empty(shape)
            return variance_scaling_(w, scale, fan_in, generator)

        def ln():
            return ParamGroup(scale=torch.ones(D), bias=torch.zeros(D))

        # drawn in the reference's key order
        self.in_proj = ParamGroup(
            kernel=init((self.tok, D), self.tok), bias=torch.zeros(D)
        )
        self.pos = nn.Parameter(init((self.seq_len, D), self.seq_len, 0.01))
        for i in range(self.num_layers):
            layer = nn.Module()
            layer.ln1 = ln()
            wq, wk, wv = (init((D, H * Dh), D).reshape(D, H, Dh) for _ in range(3))
            layer.attn = ParamGroup(
                wq=wq, wk=wk, wv=wv,
                bq=torch.zeros(H, Dh), bk=torch.zeros(H, Dh), bv=torch.zeros(H, Dh),
                wo=init((H * Dh, D), H * Dh).reshape(H, Dh, D),
                bo=torch.zeros(D),
            )
            layer.ln2 = ln()
            layer.mlp = ParamGroup(
                w_up=init((D, FF), D), b_up=torch.zeros(FF),
                w_down=init((FF, D), FF), b_down=torch.zeros(D),
            )
            setattr(self, f"layer_{i}", layer)
        self.ln_f = ln()
        self.logits = ParamGroup(
            kernel=init((D, self.num_outputs), D, 0.01),
            bias=torch.zeros(self.num_outputs),
        )
        self.value = ParamGroup(kernel=init((D, 1), D), bias=torch.zeros(1))

    def _tokens(self, x: torch.Tensor) -> torch.Tensor:
        """Chunk flat (B, F) rows into (B, S, ceil(F/S)) tokens, the tail
        zero-padded."""
        b, f = x.shape
        if self.seq_len * self.tok != f:
            x = F.pad(x, (0, self.seq_len * self.tok - f))
        return x.reshape(b, self.seq_len, self.tok)

    def _attn(self, ap: ParamGroup, x: torch.Tensor) -> torch.Tensor:
        q = torch.einsum("bsd,dhk->bhsk", x, ap.wq) + ap.bq[None, :, None, :]
        k = torch.einsum("bsd,dhk->bhsk", x, ap.wk) + ap.bk[None, :, None, :]
        v = torch.einsum("bsd,dhk->bhsk", x, ap.wv) + ap.bv[None, :, None, :]
        # (B, H, S, K) views over (B, S, H, K) memory: the kernel reads
        # them where they are, and o takes q's layout
        o = flash_attention(q, k, v, causal_offset=0)
        return torch.einsum("bhsk,hkd->bsd", o, ap.wo) + ap.bo

    def _mlp(self, mp: ParamGroup, x: torch.Tensor) -> torch.Tensor:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ mp.w_up + mp.b_up, approximate="tanh")
        return h @ mp.w_down + mp.b_down

    def forward(self, obs: torch.Tensor):
        x = obs.to(self.dtype).reshape(obs.shape[0], -1)
        # the parameters are float32, and JAX promotes a narrower input
        # to float32 at the first product
        t = self._tokens(x).float()
        h = t @ self.in_proj.kernel + self.in_proj.bias + self.pos
        for i in range(self.num_layers):
            layer = getattr(self, f"layer_{i}")
            h = h + self._attn(layer.attn, _layer_norm(h, layer.ln1))
            h = h + self._mlp(layer.mlp, _layer_norm(h, layer.ln2))
        feat = _layer_norm(h, self.ln_f)[:, -1]
        logits = feat @ self.logits.kernel + self.logits.bias
        value = (feat @ self.value.kernel + self.value.bias).squeeze(-1)
        return logits.float(), value.float(), ()

    def num_params(self) -> int:
        """The reference's static parameter count at this geometry (as
        there, it leaves out ``in_proj``, whose width depends on the
        observation)."""
        D, H, Dh, FF, S = (
            self.d_model, self.num_heads, self.head_dim, self.ff_dim, self.seq_len,
        )
        per_layer = (
            3 * (D * H * Dh + H * Dh)  # qkv
            + H * Dh * D + D  # out proj
            + D * FF + FF + FF * D + D  # mlp
            + 4 * D  # 2 layernorms
        )
        return (
            self.num_layers * per_layer
            + S * D + 2 * D  # pos + final ln
            + D * self.num_outputs + self.num_outputs
            + D + 1  # value head
        )
