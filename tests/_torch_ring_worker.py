"""One rank of the port's ring-attention tests (``tests/test_torch_ring.py``
and, on a card, ``tests/test_torch_cuda.py``).

    RAY_TPU_COORDINATOR=127.0.0.1:PORT RAY_TPU_NUM_PROCESSES=N \\
    RAY_TPU_PROCESS_ID=R python tests/_torch_ring_worker.py OUT_DIR [cpu|cuda]

Imports numpy, torch and ``ray_tpu_torch`` only; :func:`run_ranks` starts
the ranks. Joins a gloo group of N ranks (on the CPU, or with CUDA
tensors: the ring of several ranks on one card), runs every case in one
process and writes ``OUT_DIR/rankR.npz``. Every rank makes each case's
whole seeded arrays, keeps its own block of them (``shard_sequence``),
runs ``ring_attention`` on the blocks, and records its rows of the
output, the hops and the gathers of that call, and the rows gathered
back afterwards (``gather_sequence``). On the CPU the cases are the
reference test's ring cases, the dryrun's ring, a ring on each axis of
two 2-D meshes (a ring of one among them) and a T that does not divide,
then the mesh helpers, the collectives with the reference test's inputs
and the weight broadcast; on a card, the ring cases with the kernel
launches and staged exchanges of each call.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

# (name, (B, T, H, D), causal): the reference test's ring cases
# (tests/test_parallel.py:118-166) and the dryrun's (__graft_entry__.py:253)
RING_CASES = [
    ("full", (2, 64, 4, 16), False),
    ("full_causal", (2, 64, 4, 16), True),
    ("long_sequence_causal", (1, 256, 2, 8), True),
    ("pallas_blocks", (2, 64, 2, 16), False),
    ("pallas_blocks_causal", (2, 64, 2, 16), True),
]
DRYRUN_SHAPE = (1, 16, 2, 8)
MESH_2D_SHAPE = (2, 64, 4, 16)
REPO = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_ranks(n, out_dir, device="cpu", timeout_s=120):
    """Run this file as ``n`` gloo ranks on one host and return each
    rank's results. A rank that fails or outlives ``timeout_s`` fails the
    caller; every rank is killed before this returns."""
    env = {
        **os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1",
        "RAY_TPU_COORDINATOR": f"127.0.0.1:{_free_port()}", "RAY_TPU_NUM_PROCESSES": str(n),
    }
    procs = [
        subprocess.Popen([sys.executable, __file__, str(out_dir), device],
                         env={**env, "RAY_TPU_PROCESS_ID": str(r)}, cwd=REPO,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)
    ]
    deadline = time.monotonic() + timeout_s
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            p.kill()
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    assert not bad, bad
    return [dict(np.load(Path(out_dir) / f"rank{r}.npz")) for r in range(n)]


def ring_inputs(shape, seed):
    """q, k, v for one case: float32 normal draws from numpy."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _count_exchanges():
    """Wrap ``dist.batch_isend_irecv`` to count the hops that ran."""
    calls = []
    launch = dist.batch_isend_irecv

    def counted(ops):
        calls.append(len(ops))
        return launch(ops)

    dist.batch_isend_irecv = counted
    return calls


def _count_gathers():
    """Wrap ``dist.all_gather`` and ``dist.all_gather_into_tensor`` (what
    ``collectives.allgather`` and any other gather reach) to count the
    gathers that ran."""
    calls = []
    for name in ("all_gather", "all_gather_into_tensor"):
        def counted(*args, _launch=getattr(dist, name), **kwargs):
            calls.append(name)
            return _launch(*args, **kwargs)

        setattr(dist, name, counted)
    return calls


def _cpu_cases(rank, n, out):
    from ray_tpu_torch.ops.flash_attention import flash_block_attention_stats
    from ray_tpu_torch.parallel import collectives as coll
    from ray_tpu_torch.parallel import mesh as mesh_rt
    from ray_tpu_torch.parallel.distributed import (
        broadcast_weights, global_mesh, process_count, process_index, sync_global,
    )
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.ring_attention import gather_sequence, ring_attention, shard_sequence

    exchanges, gathers = _count_exchanges(), _count_gathers()

    def ring(name, shape, seed, mesh, axis, causal):
        """This rank's rows of one case (``ring/``), the hops and gathers of
        the ring call alone, and the rows gathered back (``gathered/``)."""
        q, k, v = (shard_sequence(torch.as_tensor(a), mesh, axis) for a in ring_inputs(shape, seed))
        exchanges.clear()
        gathers.clear()
        rows = ring_attention(q, k, v, mesh, axis_name=axis, causal=causal)
        out[f"exchanges/{name}"] = np.array(len(exchanges))
        out[f"gathers/{name}"] = np.array(len(gathers))
        out[f"ring/{name}"] = rows.numpy()
        out[f"index/{name}"] = np.array(mesh.index(axis))
        out[f"gathered/{name}"] = gather_sequence(rows, mesh, axis).numpy()

    sp = make_mesh([("sp", n)], device="cpu")
    for seed, (name, shape, causal) in enumerate(RING_CASES):
        ring(name, shape, seed, sp, "sp", causal)
    ring("dryrun", DRYRUN_SHAPE, 10, make_mesh(device="cpu"), "data", False)
    ring("mesh_4x2_causal", MESH_2D_SHAPE, 11, make_mesh([("data", n // 4), ("sp", 4)], device="cpu"),
         "sp", True)
    ring("mesh_1_causal", MESH_2D_SHAPE, 11, make_mesh([("data", n), ("sp", 1)], device="cpu"),
         "sp", True)
    q, k, v = (torch.as_tensor(a).transpose(1, 2).reshape(-1, a.shape[1], a.shape[3]).contiguous()
               for a in ring_inputs(MESH_2D_SHAPE, 11))
    acc, _, l = flash_block_attention_stats(q, k, v, 0)  # the ring of one's only block
    out["block/mesh_1_causal"] = (acc / l.clamp(min=1e-30)[..., None]).reshape(
        MESH_2D_SHAPE[0], MESH_2D_SHAPE[2], MESH_2D_SHAPE[1], MESH_2D_SHAPE[3]).transpose(1, 2).numpy()
    try:
        ring("t12", (1, 12, 2, 8), 12, sp, "sp", False)
    except ValueError as e:
        out["t12_refused"] = np.array(str(e))

    # the mesh helpers on a 2-D (batch, model) mesh, on the default mesh
    # and on the global mesh; this process's place among the ranks
    for name, m in (("batch_model", make_mesh([("batch", n // 2), ("model", 2)], device="cpu")),
                    ("default", make_mesh(device="cpu")), ("global", global_mesh(device="cpu"))):
        out[f"mesh/{name}"] = np.array([str(x) for x in (
            m.axis_names, m.shape, mesh_rt.data_axis(m), mesh_rt.num_shards(m),
            mesh_rt.num_data_shards(m), mesh_rt.model_axis(m), mesh_rt.model_shards(m))])
        out[f"mesh_index/{name}"] = np.array([m.index(axis) for axis in m.axis_names])
    out["process"] = np.array([process_index(), process_count()])

    # the reference test's collective inputs (tests/test_parallel.py:36-86):
    # rank r holds x[r] of arange(8), and row r of tile(arange(8), (8, 1))
    g = sp.group("sp")
    x = torch.arange(8.0)[rank:rank + 1]
    for op in ("sum", "mean", "max", "min"):
        out[f"allreduce/{op}"] = coll.allreduce(x, g, op=op).numpy()
    out["allgather"] = coll.allgather(x, g).numpy()
    out["reducescatter"] = coll.reducescatter(torch.arange(8.0), g).numpy()
    out["broadcast"] = coll.broadcast(x, g, src=3).numpy()
    out["send_recv_shift"] = coll.send_recv_shift(x, g, 1).numpy()
    out["barrier"] = coll.barrier(g).numpy()
    tree = broadcast_weights({"w": torch.full((3,), float(rank)), "b": [torch.arange(2.0) + rank]})
    out["broadcast_weights/w"] = tree["w"].numpy()
    out["broadcast_weights/b"] = tree["b"][0].numpy()
    sync_global()


def _cuda_cases(dev, out):
    from ray_tpu_torch.ops.flash_attention import flash_block_attention_stats
    from ray_tpu_torch.parallel import collectives as coll
    from ray_tpu_torch.parallel.mesh import make_mesh
    from ray_tpu_torch.parallel.ring_attention import gather_sequence, ring_attention, shard_sequence

    gathers = _count_gathers()
    mesh = make_mesh([("sp", dist.get_world_size())])
    for seed, (name, shape, causal) in enumerate(RING_CASES):
        q, k, v = (shard_sequence(torch.as_tensor(a), mesh, "sp").to(dev) for a in ring_inputs(shape, seed))
        flash_block_attention_stats.launches = 0
        coll.send_recv_shift.staged = 0
        gathers.clear()
        rows = ring_attention(q, k, v, mesh, axis_name="sp", causal=causal)
        torch.cuda.synchronize()
        out[f"launches/{name}"] = np.array(flash_block_attention_stats.launches)
        out[f"staged/{name}"] = np.array(coll.send_recv_shift.staged)
        out[f"gathers/{name}"] = np.array(len(gathers))
        out[f"ring/{name}"] = rows.cpu().numpy()
        out[f"gathered/{name}"] = gather_sequence(rows, mesh, "sp").cpu().numpy()


def main() -> int:
    from ray_tpu_torch.parallel.distributed import initialize, shutdown

    out_dir, device = Path(sys.argv[1]), (sys.argv[2] if len(sys.argv) > 2 else "cpu")
    torch.set_num_threads(1)
    dev = initialize(device=device, backend="gloo")
    rank, n = dist.get_rank(), dist.get_world_size()
    out = {}
    if dev.type == "cpu":
        _cpu_cases(rank, n, out)
    else:
        _cuda_cases(dev, out)
    np.savez(out_dir / f"rank{rank}.npz", **out)
    shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
