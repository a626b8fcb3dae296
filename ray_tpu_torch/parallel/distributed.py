"""Process-group bring-up for several ranks.

Counterpart of ``ray_tpu/parallel/distributed.py:39-140``
(``initialize``, ``process_index``, ``process_count``, ``global_mesh``,
``broadcast_weights``, ``sync_global``). The reference joins the
multi-controller JAX runtime; here every rank is one process that joins
a ``torch.distributed`` process group through a ``tcp://`` rendezvous.
The arguments default to the same variables: ``RAY_TPU_COORDINATOR``
(``host:port`` or a URL), ``RAY_TPU_NUM_PROCESSES`` and
``RAY_TPU_PROCESS_ID``, so every rank runs the same script. Without a
coordinator and with one process the group is a world of one over an
in-process store.

The backend is chosen when the configuration is read: NCCL when the
rank's tensors live on a card, gloo for ``device="cpu"``, or whatever the
caller names. ``backend="gloo"`` with a CUDA device is the ring of
several ranks on one card: NCCL refuses two ranks on one card at
communicator set-up ("Duplicate GPU detected"), so those ranks talk
over gloo, whose point-to-point transfers read host memory, and
:func:`~ray_tpu_torch.parallel.collectives.send_recv_shift` stages their
CUDA tensors through host buffers by design (see that module).

The reference's KV store, heartbeat and fleet re-exports (``:21-30``)
belong to the fleet port and are not here.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Union

import torch
import torch.distributed as dist

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.parallel.mesh import Mesh, make_mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: Optional[Union[str, torch.device]] = None,
    backend: Optional[str] = None,
) -> torch.device:
    """Join the default process group and return this rank's device.

    ``device=None`` is a card: ``cuda:(rank % cards)`` (raises without a
    CUDA device); ``"cpu"`` the CPU. ``backend`` defaults to ``"nccl"``
    on a card and ``"gloo"`` on the CPU. A second call in a process that
    has already joined returns the device and changes nothing."""
    coordinator = coordinator_address or os.environ.get("RAY_TPU_COORDINATOR")
    n = int(num_processes if num_processes is not None
            else os.environ.get("RAY_TPU_NUM_PROCESSES", 1))
    rank = int(process_id if process_id is not None
               else os.environ.get("RAY_TPU_PROCESS_ID", 0))
    dev = resolve_device(device)
    if dev.type == "cuda" and (device is None or torch.device(device).index is None):
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if coordinator is None:
        if n != 1:
            raise ValueError(
                f"{n} processes need a coordinator address "
                "(coordinator_address= or RAY_TPU_COORDINATOR)"
            )
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    else:
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        dist.init_process_group(backend, init_method=url, world_size=n, rank=rank)
    return dev


def shutdown() -> None:
    """Leave the default process group (no-op when not joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh(device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """The 1-D ``("data",)`` mesh over every rank."""
    return make_mesh(device=device)


def broadcast_weights(tree: Any, src: int = 0) -> Any:
    """Every rank returns rank ``src``'s tensors: a dict, list or tuple
    tree of tensors, copied (the inputs are left as they are) and
    broadcast over the default group, leaf by leaf in tree order."""
    if isinstance(tree, dict):
        return {k: broadcast_weights(v, src) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(broadcast_weights(v, src) for v in tree)
    out = tree.detach().clone().contiguous()
    dist.broadcast(out, src)
    return out


def sync_global(name: str = "barrier") -> None:
    """A barrier over every rank (``name`` is kept for the reference's
    signature; a process group needs no label)."""
    del name
    dist.barrier()
