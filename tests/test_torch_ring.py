"""The port's ring attention and its distributed layer against the JAX
package's, on the CPU.

- Block statistics: the port's ``flash_block_attention_stats`` (its
  plain version on CPU tensors) against the reference's Pallas
  ``_block_kernel`` in interpret mode, within 2e-5 abs/rel on acc, m and
  l in float32 (the kernel scales q before the product, the plain
  version the scores after), 3e-2 in bfloat16; rows that see no key are
  exactly (acc, m, l) = (0, -1e30, 0) in both.
- The ring: 8 gloo ranks, one process each (``tests/_torch_ring_worker.py``,
  importing only ``ray_tpu_torch``), started once for the module, each
  with its own timeout. Each rank passes its own block of T and gets
  its own (B, T / n, H, D) rows back, with no allgather in the call, as
  the reference's ``shard_map`` with ``P(None, axis)``. Their rows,
  joined along T, against the reference's
  ``ring_attention`` on the conftest's 8 virtual CPU devices (the Pallas
  blocks in interpret mode for the reference test's two Pallas cases,
  the XLA blocks for the rest) within 2e-5, and against
  ``full_attention_reference`` at the reference test's tolerances; the
  collectives against the reference's ``shard_map`` results, exactly.
- Refusals: gradients, a T that does not divide (``shard_sequence``),
  no CUDA device without ``device="cpu"``, a CPU tensor on a NCCL group.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from _torch_ring_worker import DRYRUN_SHAPE, MESH_2D_SHAPE, RING_CASES, ring_inputs, run_ranks
from ray_tpu.ops.flash_attention import flash_block_attention_stats as jax_block_stats
from ray_tpu.parallel import collectives as jax_coll
from ray_tpu.parallel import distributed as jax_distributed
from ray_tpu.parallel import mesh as jax_parallel_mesh
from ray_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ray_tpu.sharding import mesh as jax_sharding_mesh
from ray_tpu.parallel.ring_attention import (
    full_attention_reference as jax_full_attention,
    ring_attention as jax_ring_attention,
)
from ray_tpu_torch.ops.flash_attention import (
    flash_block_attention_stats,
    reference_block_attention_stats,
)
from ray_tpu_torch.parallel import collectives, distributed, mesh as port_mesh
from ray_tpu_torch.parallel.ring_attention import (
    full_attention_reference,
    gather_sequence,
    ring_attention,
    ring_attention_local,
    shard_sequence,
)

RANKS = 8
NEG_INF32 = np.float32(-1e30)

BLOCK_SHAPES = [(4, 16, 16, 8), (4, 24, 40, 16), (2, 130, 200, 16)]


def _block_inputs(n, t, s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in ((n, t, d), (n, s, d), (n, s, d))]


@pytest.mark.parametrize("offset_of", ["-S-3", "-5", "0", "7", "S"])
@pytest.mark.parametrize("n,t,s,d", BLOCK_SHAPES)
def test_block_stats_match_pallas_kernel(n, t, s, d, offset_of):
    offset = {"-S-3": -s - 3, "-5": -5, "0": 0, "7": 7, "S": s}[offset_of]
    q, k, v = _block_inputs(n, t, s, d, n + t + s + d)
    want = [np.asarray(x) for x in jax_block_stats(q, k, v, offset, interpret=True)]
    got = [x.numpy() for x in flash_block_attention_stats(*map(torch.as_tensor, (q, k, v)), offset)]
    for name, g, w in zip(("acc", "m", "l"), got, want):
        assert g.dtype == np.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=2e-5, rtol=2e-5, err_msg=name)
    acc, m, l = got
    blind = np.arange(t) + offset < 0  # rows that see no key
    assert (m[:, blind] == NEG_INF32).all() and (l[:, blind] == 0).all() and (acc[:, blind] == 0).all()
    assert (want[1][:, blind] == NEG_INF32).all() and (want[2][:, blind] == 0).all()
    assert (l[:, ~blind] > 0).all()


def test_block_stats_bf16_match_pallas_kernel():
    q, k, v = _block_inputs(4, 24, 40, 16, 3)
    want = jax_block_stats(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), 7, interpret=True)
    got = flash_block_attention_stats(*(torch.as_tensor(x).bfloat16() for x in (q, k, v)), 7)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-2, rtol=3e-2)


def test_block_stats_cpu_is_the_plain_version():
    q, k, v = map(torch.as_tensor, _block_inputs(2, 8, 12, 16, 4))
    before = flash_block_attention_stats.launches
    got = flash_block_attention_stats(q, k, v, 2)
    assert flash_block_attention_stats.launches == before
    for g, w in zip(got, reference_block_attention_stats(q, k, v, 2)):
        assert torch.equal(g, w)


# ---------------- the ring on 8 gloo ranks ----------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(RANKS, tmp_path_factory.mktemp("ring"))


@pytest.fixture(scope="module")
def mesh8():
    return jax_make_mesh([("sp", 8)])


def _jax_ring(shape, seed, mesh, axis, causal, pallas):
    q, k, v = (jnp.asarray(x) for x in ring_inputs(shape, seed))
    kw = {"use_pallas": True, "interpret": True} if pallas else {"use_pallas": False}
    ring = jax_ring_attention(q, k, v, mesh, axis_name=axis, causal=causal, **kw)
    return np.asarray(ring), np.asarray(jax_full_attention(q, k, v, causal=causal))


def _joined(ring_ranks, name, shape):
    """The rows of one ring's ranks, joined along T in their order on the
    ring's axis: after checking that each rank holds its (B, T / n, H, D)
    rows only, that the ``ring_attention`` call gathered nothing, and
    that ``gather_sequence`` joins the same rows on every rank."""
    n = len(ring_ranks)
    b, t, h, d = shape
    ordered = sorted(ring_ranks, key=lambda r: int(r[f"index/{name}"]))
    assert [int(r[f"index/{name}"]) for r in ordered] == list(range(n))
    for r in ordered:
        assert r[f"ring/{name}"].shape == (b, t // n, h, d)
        assert int(r[f"gathers/{name}"]) == 0
    whole = np.concatenate([r[f"ring/{name}"] for r in ordered], axis=1)
    for r in ordered:
        assert np.array_equal(r[f"gathered/{name}"], whole)
    return whole


# (case name, shape, the rings as lists of ranks)
RINGS = [(name, shape, [list(range(RANKS))]) for name, shape, _ in RING_CASES] + [
    ("dryrun", DRYRUN_SHAPE, [list(range(RANKS))]),
    ("mesh_4x2_causal", MESH_2D_SHAPE, [list(range(4)), list(range(4, 8))]),
    ("mesh_1_causal", MESH_2D_SHAPE, [[r] for r in range(RANKS)]),
]


@pytest.mark.parametrize("name,shape,rings", RINGS, ids=[c[0] for c in RINGS])
def test_each_rank_holds_only_its_rows(ranks, name, shape, rings):
    """The entry point works on shards, as the reference's ``shard_map``
    with ``P(None, axis)``: each rank's output is its (B, T / n, H, D)
    rows, and the call makes no allgather."""
    for ring in rings:
        _joined([ranks[r] for r in ring], name, shape)


@pytest.mark.parametrize("seed,case", list(enumerate(RING_CASES)), ids=[c[0] for c in RING_CASES])
def test_ring_matches_reference_ring(ranks, mesh8, seed, case):
    name, shape, causal = case
    got = _joined(ranks, name, shape)
    want_ring, want_full = _jax_ring(shape, seed, mesh8, "sp", causal, name.startswith("pallas"))
    assert got.shape == shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want_ring, atol=2e-5, rtol=2e-5)  # measured max 6.0e-7
    tol = 5e-4 if name == "long_sequence_causal" else 2e-4  # the reference test's
    np.testing.assert_allclose(got, want_full, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, full_attention_reference(*map(torch.as_tensor, ring_inputs(shape, seed)),
                                                             causal=causal).numpy(), atol=tol, rtol=tol)
    assert int(ranks[0][f"exchanges/{name}"]) == RANKS - 1  # the last rotation is skipped


def test_ring_dryrun_case(ranks):
    """The dryrun's ring (``__graft_entry__.py:253-261``): axis "data" of
    the default mesh, non-causal, 2 of the 16 rows on each rank."""
    want_ring, want_full = _jax_ring(DRYRUN_SHAPE, 10, jax_make_mesh(), "data", False, False)
    got = _joined(ranks, "dryrun", DRYRUN_SHAPE)
    np.testing.assert_allclose(got, want_ring, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, want_full, atol=1e-4)


def test_ring_on_a_2d_mesh_axis(ranks):
    """``[("data", 2), ("sp", 4)]``: two rings of 4 ranks, 3 exchanges each."""
    q, k, v = map(torch.as_tensor, ring_inputs(MESH_2D_SHAPE, 11))
    want = full_attention_reference(q, k, v, causal=True).numpy()
    for ring in (range(4), range(4, 8)):
        got = _joined([ranks[r] for r in ring], "mesh_4x2_causal", MESH_2D_SHAPE)
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)
    for r in ranks:
        assert int(r["exchanges/mesh_4x2_causal"]) == 3


def test_ring_of_one_is_one_block(ranks):
    """``[("data", 8), ("sp", 1)]``: no exchange, and the output is its
    one block's acc / l, bitwise (computed in the same rank)."""
    for r in ranks:
        assert int(r["exchanges/mesh_1_causal"]) == 0
        assert np.array_equal(_joined([r], "mesh_1_causal", MESH_2D_SHAPE), r["block/mesh_1_causal"])


def test_ring_refuses_t_that_does_not_divide(ranks):
    """``shard_sequence`` refuses T = 12 over 8 ranks."""
    for r in ranks:
        assert "does not divide by the 8 ranks" in str(r["t12_refused"])


def _smap(fn, mesh, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False))


def test_collectives_match_reference(ranks, mesh8):
    """The reference test's inputs (``tests/test_parallel.py:36-86``)
    through the reference's verbs under ``shard_map`` and the port's over
    the 8 gloo ranks: equal, exactly."""
    x = np.arange(8.0, dtype=np.float32)
    rows = np.tile(x, (8, 1))
    want = {
        f"allreduce/{op}": _smap(lambda a, op=op: jax_coll.allreduce(a, "sp", op), mesh8, P("sp"), P("sp"))(x)
        for op in ("sum", "mean", "max", "min")
    }
    want["allgather"] = _smap(lambda a: jax_coll.allgather(a, "sp"), mesh8, P("sp"), P(None))(x)
    want["reducescatter"] = _smap(lambda a: jax_coll.reducescatter(a.reshape(-1), "sp"), mesh8,
                                  P("sp", None), P("sp"))(rows)
    want["broadcast"] = _smap(lambda a: jax_coll.broadcast(a, "sp", src=3), mesh8, P("sp"), P("sp"))(x)
    want["send_recv_shift"] = _smap(lambda a: jax_coll.send_recv_shift(a, "sp", 1), mesh8, P("sp"), P("sp"))(x)
    want["barrier"] = _smap(lambda a: jax_coll.barrier("sp") + 0 * a, mesh8, P("sp"), P("sp"))(x)
    for key, ref in want.items():
        ref = np.asarray(ref)
        if key == "allgather":  # replicated: every rank holds the whole vector
            got = [r[key] for r in ranks]
            assert all(np.array_equal(g, ref) for g in got), key
            continue
        got = np.concatenate([np.atleast_1d(r[key]) for r in ranks])
        assert np.array_equal(got, ref), (key, got, ref)


@pytest.mark.parametrize("name,reference_mesh", [
    ("batch_model", lambda: jax_make_mesh([("batch", 4), ("model", 2)])),
    ("default", jax_make_mesh),
    ("global", jax_distributed.global_mesh),
])
def test_mesh_helpers_match_reference(ranks, name, reference_mesh):
    """The axis names and shape, ``data_axis``, ``num_shards``,
    ``num_data_shards``, ``model_axis`` and ``model_shards`` of the 8-rank
    mesh (``make_mesh`` or ``global_mesh``) equal the reference's on the
    8-device mesh, and rank r sits where device r does."""
    jm = reference_mesh()
    want = [str(x) for x in (tuple(jm.axis_names), dict(jm.shape), jax_sharding_mesh.data_axis(jm),
                             jax_sharding_mesh.num_shards(jm), jax_parallel_mesh.num_data_shards(jm),
                             jax_sharding_mesh.model_axis(jm), jax_sharding_mesh.model_shards(jm))]
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r, res in enumerate(ranks):
        assert res[f"mesh/{name}"].tolist() == want
        assert res[f"mesh_index/{name}"].tolist() == np.argwhere(ids == r)[0].tolist()


def test_process_index_and_count_are_the_rank_and_world(ranks):
    for r, res in enumerate(ranks):
        assert res["process"].tolist() == [r, RANKS]


def test_axis_names_match_reference():
    assert port_mesh.DATA_AXIS == jax_parallel_mesh.DATA_AXIS
    assert port_mesh.BATCH_AXIS == jax_sharding_mesh.BATCH_AXIS
    assert port_mesh.MODEL_AXIS == jax_parallel_mesh.MODEL_AXIS == jax_sharding_mesh.MODEL_AXIS


def test_broadcast_weights_gives_rank0s_tree(ranks):
    for r in ranks:
        assert np.array_equal(r["broadcast_weights/w"], np.zeros(3, np.float32))
        assert np.array_equal(r["broadcast_weights/b"], np.arange(2.0, dtype=np.float32))


# ---------------- refusals ----------------


@pytest.fixture
def world_of_one():
    dev = distributed.initialize(device="cpu")
    try:
        yield port_mesh.make_mesh([("sp", 1)], device=dev)
    finally:
        distributed.shutdown()


def test_ring_refuses_gradients(world_of_one):
    q, k, v = (torch.randn(1, 8, 2, 8, requires_grad=True) for _ in range(3))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8.3"):
        ring_attention(q, k, v, world_of_one)
    with pytest.raises(NotImplementedError, match="forward-only"):
        ring_attention_local(q, k, v, group=world_of_one.group("sp"))
    with torch.no_grad():
        out = ring_attention(q, k, v, world_of_one, causal=True)
    assert out.shape == q.shape and distributed.process_count() == 1


def test_shard_and_gather_sequence_on_a_world_of_one(world_of_one):
    """A ring of one keeps every row: the shard is the whole array, in a
    tensor of its own, and the gather gives it back."""
    x = torch.randn(2, 12, 3, 4)
    shard = shard_sequence(x, world_of_one, "sp")
    assert torch.equal(shard, x) and shard.data_ptr() != x.data_ptr()
    assert torch.equal(gather_sequence(shard, world_of_one, "sp"), x)


def test_initialize_and_mesh_refuse_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distributed.initialize()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_mesh.make_mesh()
    assert not dist.is_initialized()


def test_nccl_group_refuses_cpu_tensors(monkeypatch):
    class NcclGroup:  # stands in for a NCCL process group of two ranks
        pass

    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(ValueError, match="NCCL group moves CUDA tensors"):
        collectives.send_recv_shift(torch.zeros(3), NcclGroup())
