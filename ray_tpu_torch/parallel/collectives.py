"""Device-plane collectives over a process group.

Counterpart of ``ray_tpu/parallel/collectives.py:33-77``: the same verbs
(``allreduce`` sum/mean/max/min, ``allgather`` and ``reducescatter``
tiled along an axis, ``broadcast``, ``send_recv_shift``, ``barrier``),
each taking the process group of a mesh axis
(:meth:`ray_tpu_torch.parallel.mesh.Mesh.group`) where the reference
takes an axis name inside ``shard_map``. Every verb returns a new tensor
and leaves its input as it is, as the reference's do.

The transport of ``send_recv_shift``, the ring's hop, follows the
group's backend and is fixed by it, never chosen after a failure:

- NCCL group: ``batch_isend_irecv`` on CUDA tensors, directly. A CPU
  tensor raises.
- gloo group: CPU tensors go directly. gloo's point-to-point transfers
  hand the tensor's pointer to gloo as a host address (a CUDA tensor's
  send fails in gloo's socket write with "Bad address" and aborts the
  process, on torch 2.11), so a CUDA tensor is copied to a pinned host
  buffer (kept and reused for that shape), exchanged, and copied back to
  the card on the current stream. That is the transport of several ranks
  on one card, which NCCL refuses: staged by design, not as a fallback.
  ``send_recv_shift.staged`` counts these exchanges.
- A group of one: no exchange (torch refuses a transfer to its own
  rank), the input comes back.

On gloo, ``allgather`` has run with CUDA tensors (the one-card ring's
check gathers the output's rows with it, ``ring_attention.
gather_sequence``); the other verbs have run on gloo with CPU tensors
only. The reference's ``HostGroup`` (``:92``), a group of actor
handles reduced in the calling process, waits for the actor runtime.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist

_REDUCE_OPS = {
    "sum": dist.ReduceOp.SUM,
    "mean": dist.ReduceOp.SUM,  # divided by the group size after
    "max": dist.ReduceOp.MAX,
    "min": dist.ReduceOp.MIN,
}


def allreduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Every rank gets the reduction of every rank's ``x`` (psum, pmean,
    pmax, pmin)."""
    if op not in _REDUCE_OPS:
        raise ValueError(f"unknown op {op}")
    out = x.clone()
    dist.all_reduce(out, _REDUCE_OPS[op], group=group)
    if op == "mean":
        out = out / dist.get_world_size(group)
    return out


def allgather(x: torch.Tensor, group, axis: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``axis``, in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=axis)


def reducescatter(x: torch.Tensor, group, scatter_axis: int = 0) -> torch.Tensor:
    """The sum over ranks of ``x``, cut into equal pieces along
    ``scatter_axis``; rank r keeps piece r."""
    n = dist.get_world_size(group)
    if x.shape[scatter_axis] % n:
        raise ValueError(
            f"reducescatter: axis {scatter_axis} of {tuple(x.shape)} does not divide by {n}"
        )
    whole = x.movedim(scatter_axis, 0).contiguous()
    out = whole.new_empty((whole.shape[0] // n,) + tuple(whole.shape[1:]))
    dist.reduce_scatter_tensor(out, whole, group=group)
    return out.movedim(0, scatter_axis)


def broadcast(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """Every rank gets the ``x`` of the group's rank ``src``."""
    out = x.clone().contiguous()
    dist.broadcast(out, dist.get_global_rank(group, src), group=group)
    return out


class _Staging:
    """Pinned host buffers of one shape and type for the gloo hop."""

    def __init__(self, like: torch.Tensor):
        self.send = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        self.recv = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)


_staging: Dict[Tuple, _Staging] = {}


def _exchange(send: torch.Tensor, recv: torch.Tensor, dst: int, src: int, group) -> None:
    for work in dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, dst, group),
        dist.P2POp(dist.irecv, recv, src, group),
    ]):
        work.wait()


def send_recv_shift(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Rank r sends ``x`` to rank ``(r + shift) % n`` of the group and
    returns what rank ``(r - shift) % n`` sent (the ring's ppermute)."""
    n = dist.get_world_size(group)
    if shift % n == 0:
        return x
    backend = str(dist.get_backend(group))
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"send_recv_shift: unsupported backend {backend}")
    if backend == "nccl" and x.device.type != "cuda":
        raise ValueError(
            f"send_recv_shift: a NCCL group moves CUDA tensors, got one on {x.device}"
        )
    rank = dist.get_rank(group)
    dst = dist.get_global_rank(group, (rank + shift) % n)
    src = dist.get_global_rank(group, (rank - shift) % n)
    x = x.contiguous()
    out = torch.empty_like(x)
    if backend == "nccl" or x.device.type == "cpu":
        _exchange(x, out, dst, src, group)
        return out
    key = (tuple(x.shape), x.dtype)
    buf = _staging.get(key)
    if buf is None:
        buf = _staging[key] = _Staging(x)
    buf.send.copy_(x)  # waits for the card: gloo reads the buffer at once
    _exchange(buf.send, buf.recv, dst, src, group)
    out.copy_(buf.recv)  # synchronous, so the next hop may refill buf.recv
    send_recv_shift.staged += 1
    return out


send_recv_shift.staged = 0


def barrier(group) -> torch.Tensor:
    """The reference's barrier: the sum of a 1 from every rank (the group
    size), which no rank has before every rank has joined; on the card
    for a NCCL group, else on the CPU."""
    nccl = str(dist.get_backend(group)) == "nccl"
    return allreduce(torch.ones((), device="cuda" if nccl else "cpu"), group)
