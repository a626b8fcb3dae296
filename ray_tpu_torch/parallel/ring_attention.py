"""Ring attention: exact attention over a sequence split across ranks.

Counterpart of ``ray_tpu/parallel/ring_attention.py`` (``_merge`` :68,
``ring_attention_local`` :81, ``ring_attention`` :150,
``full_attention_reference`` :213; Liu et al., "Ring Attention with
Blockwise Transformers", 2023). The sequence is split along time over a
mesh axis; each rank holds a Q/K/V block, the K/V blocks go once round
the ring, and each hop's block statistics are merged with the
flash-attention merge, so the result is exact. As in the reference,
the sequence stays sharded: :func:`ring_attention` takes each rank's
block and returns each rank's rows of the output.

Each hop is :func:`ray_tpu_torch.ops.flash_attention.
flash_block_attention_stats`: one launch of ``csrc/flash_block.cu`` on
CUDA tensors, the plain version on CPU tensors (the device of q
decides; there is no other switch). The K/V rotation is
:func:`ray_tpu_torch.parallel.collectives.send_recv_shift` over the
axis's process group, whose transport follows the group's backend (NCCL
moves CUDA tensors directly; gloo stages them through host memory, the
ring of several ranks on one card). The port rotates K and V as one
stacked buffer after each hop's kernel, and skips the reference's last
rotation, whose result is never read: n - 1 exchanges for n hops. The
exchange does not overlap the kernel (the reference's does, ``:12-14``):
ROADMAP queue 1 item 8.3 lists that overlap.

Forward only. The reference differentiates its Pallas ring through the
XLA ring (a custom VJP, ``:197-209``); that reverse ring is ROADMAP
queue 1 item 8.3, and :func:`ring_attention` raises when autograd would
need it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ray_tpu_torch.ops.flash_attention import flash_block_attention_stats
from ray_tpu_torch.parallel import collectives
from ray_tpu_torch.parallel.mesh import Mesh

NEG_INF = -1e30


def _merge(o1, m1, l1, o2, m2, l2):
    """Combine two partial softmax accumulators (the flash merge): o is
    (N, T, D), m and l are (N, T)."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return o1 * a1[..., None] + o2 * a2[..., None], m, l1 * a1 + l2 * a2


def _refuse_grad(*xs: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise NotImplementedError(
            "ring_attention is forward-only: its gradient (the reverse ring, "
            "reference ray_tpu/parallel/ring_attention.py:197-209) is ROADMAP "
            "queue 1 item 8.3; call it under torch.no_grad() or on detached inputs"
        )


def ring_attention_local(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, group, causal: bool = False
) -> torch.Tensor:
    """The per-rank body on this rank's (B, T_local, H, D) blocks, the
    rank's position in ``group`` being its position in the sequence.
    Returns this rank's rows of the attention output, exact over the
    whole sequence, in q's type."""
    _refuse_grad(q, k, v)
    n = torch.distributed.get_world_size(group)
    my = torch.distributed.get_rank(group)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    # (B·H, T, D) once; K and V travel together as one (2, B·H, Tk, D) buffer
    qf = q.transpose(1, 2).reshape(b * h, tq, d).contiguous()
    kv = torch.stack([k, v]).transpose(2, 3).reshape(2, b * h, tk, d).contiguous()
    o = torch.zeros((b * h, tq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b * h, tq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b * h, tq), dtype=torch.float32, device=q.device)
    for step in range(n):
        src = (my - step) % n  # whose K/V block this rank now holds
        # j <= i + offset  <=>  src*Tk + j <= my*Tq + i
        offset = my * tq - src * tk if causal else tk
        o, m, l = _merge(o, m, l, *flash_block_attention_stats(qf, kv[0], kv[1], offset))
        if step < n - 1:
            kv = collectives.send_recv_shift(kv, group)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype).reshape(b, h, tq, d).transpose(1, 2)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh: Mesh,
    *,
    axis_name: str = "sp",
    causal: bool = False,
) -> torch.Tensor:
    """The entry point on shards, as the reference's ``shard_map`` with
    ``P(None, axis_name)`` in and out (``:183-188``): every rank along
    ``axis_name`` passes its own (B, T / n, H, D) blocks, the rank's
    index along the axis being the block's place in the sequence, and
    gets its (B, T / n, H, D) rows of the exact output back. No rank
    holds the whole sequence and nothing is gathered: memory per rank is
    O(T / n). :func:`shard_sequence` and :func:`gather_sequence` cut a
    whole array into this rank's rows and join the rows again, for
    callers that hold whole arrays."""
    return ring_attention_local(q, k, v, group=mesh.group(axis_name), causal=causal)


def shard_sequence(x: torch.Tensor, mesh: Mesh, axis_name: str = "sp") -> torch.Tensor:
    """This rank's block of a whole (B, T, ...) array: rows ``r·T/n`` to
    ``(r+1)·T/n`` of T for the rank's index r along ``axis_name``, as a
    tensor of its own (the whole array can then be freed). T must
    divide by the axis size."""
    n, t = mesh.size(axis_name), x.shape[1]
    if t % n:
        raise ValueError(f"shard_sequence: T = {t} does not divide by the {n} ranks of {axis_name!r}")
    rows = t // n
    start = mesh.index(axis_name) * rows
    return x[:, start:start + rows].clone(memory_format=torch.contiguous_format)


def gather_sequence(x: torch.Tensor, mesh: Mesh, axis_name: str = "sp") -> torch.Tensor:
    """The whole (B, T, ...) array from every rank's block along
    ``axis_name``, on every rank: the allgather along T."""
    return collectives.allgather(x, mesh.group(axis_name), axis=1)


def full_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    *,
    query_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Single-device exact attention on (B, T, H, D) (the golden of the
    tests), as the reference computes it: scores in the input type, then
    float32; the probabilities in v's type. ``query_chunk`` computes
    that many query rows at a time, to bound the (T, S) scores."""
    t = q.shape[1]
    step = t if query_chunk is None else query_chunk
    scale = float(np.float32(1.0) / np.sqrt(np.float32(q.shape[-1])))
    out = []
    for start in range(0, t, step):
        qc = q[:, start:start + step]
        scores = torch.einsum("bqhd,bkhd->bhqk", qc, k).float() * scale
        if causal:
            i = torch.arange(start, start + qc.shape[1], device=q.device)[:, None]
            j = torch.arange(k.shape[1], device=q.device)[None, :]
            scores = torch.where(j <= i, scores, NEG_INF)
        p = torch.softmax(scores, dim=-1)
        out.append(torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v))
    return torch.cat(out, dim=1)
