"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: the kernels have no CPU mode, so these tests skip
without a CUDA device. Run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Contracts: bitwise for the data-movement and scan kernels (the row
gather and the row scatter are data movement; the GAE kernel and the f64
prefix descent round every operation in the plain version's order: the
GAE kernel at several tiles, T = 1, ragged rows, rows done at every step
and unaligned inputs; the descent at 0-17 levels, a NaN mass and one
query). The
device sum tree's whole draw agrees with the host trees bitwise in its
indices; its IS weights within 1 float32 ulp (host and card round the
f64 ``pow`` apart). The flash-attention kernel sums in another order
than the plain version (a softmax per chunk of keys, or online key by
key, q scaled before the product): within 2e-5 abs/rel in float32 and
3e-2 in bfloat16, rows that see no key exactly 0, on contiguous inputs
and on the torso's (B, H, T, D) views over (B, T, H, D) memory, with
the output in q's layout; a torso forward launches no copy kernel. The flash block kernel of ring attention
on acc, m and l against the plain version on float64 copies of its
inputs, in float32 and in bfloat16 (whose inputs float64 holds exactly):
within 2e-5, and 1e-4 over the ring hop's 4096 keys, where a float32
running sum drifts further (the plain version in float32 needs up to
4.1e-5 there); rows that see no key exactly (0, -1e30, 0); and a ring
of two gloo ranks on the one card against the full attention within the
reference test's tolerances. The actor-learner's plane: the feeder's
pinned side-stream copy bitwise, intact after the host arrays are
overwritten and while a delayed read on the consumer's stream races a
same-sized copy; learner-thread learns bitwise equal to synchronous ones
(PPO and IMPALA, one row-gather launch a learn). The serving plane: one
CUDA graph per (bucket, explore) at warmup and none after traffic at
every occupancy from 1 to 32; exact mode bitwise against sequential
batch-1 calls (PPO, DQN's epsilon-greedy and the torso, exploring and
greedy); a replay after a hot reload reads the new weights; the torso
server's flash launches, layers x bucket a replay (exact) or layers
(vectorized). GTrXL's act step (T = 1 against S = 51) through the
kernel against the same policy's CPU run within 1e-5.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import flash_attention as fa, framestack, gae, segment_tree

pytestmark = pytest.mark.cuda


@contextlib.contextmanager
def _profiled(pad_s=0.1):
    """torch.profiler over the CPU and the card, its window reaching
    ``pad_s`` past the work on both sides: the profiler drops device
    records outside its window, and its device timestamps can lie
    milliseconds off the host's."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        yield prof
        torch.cuda.synchronize()
        time.sleep(pad_s)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("m,d,r", [(4099, 1764, 16384), (1000, 1763, 500), (9, 1, 40), (64, 3, 7)])
def test_row_gather_kernel_bitwise(cuda, m, d, r):
    gen = torch.Generator(device=cuda).manual_seed(m + d)
    src = torch.randint(-2**31, 2**31 - 1, (m, d), dtype=torch.int32, device=cuda, generator=gen)
    idx = torch.randint(0, m, (r,), device=cuda, generator=gen)
    before = framestack.gather_rows.launches
    got = framestack.gather_rows(src, idx)
    assert framestack.gather_rows.launches == before + 1
    assert torch.equal(got, framestack.gather_rows_plain(src, idx))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_build_stacks_kernel_bitwise(cuda, dtype):
    rng = np.random.default_rng(0)
    frames = torch.as_tensor(rng.integers(0, 256, (40, 84, 84, 1))).to(dtype).to(cuda)
    idx = torch.as_tensor(rng.integers(0, 37, 20), device=cuda)
    got = framestack.build_stacks(frames, idx, 4)
    want = frames[idx[:, None] + torch.arange(4, device=cuda)][..., 0].movedim(1, -1)
    assert got.shape == (20, 84, 84, 4) and torch.equal(got, want)


def test_row_gather_refuses_what_it_cannot_copy(cuda):
    src = torch.zeros((8, 6), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        framestack.gather_rows(src.t(), torch.zeros(2, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="idx on"):
        framestack.gather_rows(src, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(TypeError, match="integer idx"):
        framestack.gather_rows(src, torch.zeros(2, device=cuda))


# rows that are not whole 4-byte words take the kernel's byte path
BYTE_ROWS = [
    (torch.bool, ()), (torch.uint8, ()), (torch.uint8, (3,)), (torch.uint8, (7056 + 1,)),
    (torch.int16, ()), (torch.float16, (5,)), (torch.bfloat16, (3, 3)),
]


def _rand_rows(shape, dtype, gen, device):
    raw = torch.randint(0, 2 if dtype == torch.bool else 127, shape, device=device, generator=gen)
    return raw.to(dtype)


@pytest.mark.parametrize("dtype,row", BYTE_ROWS)
def test_row_gather_byte_rows_bitwise(cuda, dtype, row):
    gen = torch.Generator(device=cuda).manual_seed(len(row))
    src = _rand_rows((5000,) + row, dtype, gen, cuda)
    idx = torch.randint(0, 5000, (32, 3), device=cuda, generator=gen)
    before = framestack.gather_rows.launches
    got = framestack.gather_rows(src, idx)
    assert framestack.gather_rows.launches == before + 1
    assert got.dtype == dtype and torch.equal(got, framestack.gather_rows_plain(src, idx))


SCATTER_ROWS = [(torch.int32, (1764,)), (torch.int32, (7,))] + BYTE_ROWS + [(torch.float64, (1,))]


@pytest.mark.parametrize("positions", ["wrapping", "duplicates", "whole_ring"])
@pytest.mark.parametrize("dtype,row", SCATTER_ROWS)
def test_scatter_rows_kernel_bitwise(cuda, dtype, row, positions):
    gen = torch.Generator(device=cuda).manual_seed(7)
    m = 3000
    if positions == "wrapping":
        pos = (m - 20 + torch.arange(64, device=cuda)) % m
    elif positions == "duplicates":
        pos = torch.randint(0, 200, (640,), device=cuda, generator=gen)
    else:
        pos = torch.randperm(m, device=cuda, generator=gen)
    ring = _rand_rows((m,) + row, dtype, gen, cuda)
    vals = _rand_rows((pos.shape[0],) + row, dtype, gen, cuda)
    want = framestack.scatter_rows_plain(ring.clone(), pos, vals)
    before = framestack.scatter_rows.launches
    got = framestack.scatter_rows(ring, pos.to(torch.int32), vals)
    assert framestack.scatter_rows.launches == before + 1
    assert got is ring and torch.equal(ring, want)


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("past_limit", [0, 1])
@pytest.mark.parametrize("dtype,row", [(torch.int32, (1764,)), (torch.bool, ()), (torch.float64, (1,))])
def test_scatter_rows_at_the_one_launch_limit(cuda, dtype, row, past_limit, index_dtype):
    """R at the kernel's one-launch limit (one launch) and one past it
    (the three-launch path), with repeated positions, bitwise."""
    from ray_tpu_torch.ops import _kernels

    r = _kernels.library("row_scatter").row_scatter_one_launch_rows() + past_limit
    gen = torch.Generator(device=cuda).manual_seed(r)
    m = 3 * r
    pos = torch.randint(0, m, (r,), device=cuda, generator=gen)
    pos[1::9] = pos[0]
    ring = _rand_rows((m,) + row, dtype, gen, cuda)
    vals = _rand_rows((r,) + row, dtype, gen, cuda)
    want = framestack.scatter_rows_plain(ring.clone(), pos, vals)
    before = framestack.scatter_rows.launches
    got = framestack.scatter_rows(ring, pos.to(index_dtype), vals)
    assert framestack.scatter_rows.launches == before + 1
    assert got is ring and torch.equal(ring, want)


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
def test_scatter_rows_insert_is_one_kernel(cuda, index_dtype):
    """One scatter_rows call at the replay insert (64 rows of 1764 words)
    runs exactly one CUDA kernel: no cast, no scratch, no second pass."""
    ring = torch.zeros((50000, 1764), dtype=torch.int32, device=cuda)
    vals = torch.ones((64, 1764), dtype=torch.int32, device=cuda)
    pos = ((49980 + torch.arange(64, device=cuda)) % 50000).to(index_dtype)
    framestack.scatter_rows(ring, pos, vals)  # builds and loads the kernel
    torch.cuda.synchronize()
    with _profiled() as prof:
        framestack.scatter_rows(ring, pos, vals)
    device = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(device) == 1, device
    assert bool((ring[pos.long()] == 1).all())


def test_scatter_rows_refuses_out_of_range(cuda):
    ring = torch.zeros((8, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="vals on"):
        framestack.scatter_rows(ring, torch.zeros(1, dtype=torch.int64, device=cuda),
                                torch.zeros((1, 4), dtype=torch.int32))
    with pytest.raises(TypeError, match="integer idx"):
        framestack.scatter_rows(ring, torch.zeros(1, device=cuda),
                                torch.zeros((1, 4), dtype=torch.int32, device=cuda))


def _host_tree(cap, size, seed):
    from ray_tpu_torch.execution.replay_buffer import powered_priorities

    rng = np.random.default_rng(seed)
    host = segment_tree.SumSegmentTree(cap)
    powered, _ = powered_priorities(rng.random(size) * 3, 0.6)
    powered[rng.random(size) < 0.1] = 0.0
    host.set_items(np.arange(size), powered)
    return host, rng


# capacities 1-131072: 0-17 levels, several not a multiple of the kernel's
# 8-level chunk (1, 5, 6, 10, 11, 17)
@pytest.mark.parametrize("cap,size,n", [(1, 1, 8), (2, 2, 8), (32, 20, 32), (64, 64, 32), (1024, 700, 32),
                                        (2048, 1500, 32), (65536, 50000, 1), (65536, 50000, 32),
                                        (65536, 50000, 4096), (131072, 100000, 32)])
def test_find_prefixsum_kernel_bitwise(cuda, cap, size, n):
    host, rng = _host_tree(cap, size, cap + n)
    total = host.sum(0, size)
    mass = np.concatenate([
        (rng.random(n) + np.arange(n)) / n * total,
        [host.value[1 << k] for k in range(cap.bit_length())],
        [0.0, total, np.nextafter(total, np.inf), 2 * total, np.nan],
    ])
    tree = torch.as_tensor(host.value, device=cuda)
    m = torch.as_tensor(mass, device=cuda)
    before = segment_tree.find_prefixsum.launches
    got = segment_tree.find_prefixsum(tree, m, cap)
    assert segment_tree.find_prefixsum.launches == before + 1
    assert torch.equal(got, segment_tree.find_prefixsum_plain(tree, m, cap))
    np.testing.assert_array_equal(got.cpu().numpy(), host.find_prefixsum_idx(mass))
    assert got[-1] == 0  # a NaN mass lands on leaf 0
    one = segment_tree.find_prefixsum(tree, m[:1], cap)  # a single query
    assert one.shape == (1,) and one[0] == got[0]


def test_device_sum_tree_on_card_matches_host(cuda):
    """Leaf writes with repeated indices, the rebuild and the whole f64
    draw on the card: bitwise the host trees' (weights within 1 f32 ulp)."""
    from ray_tpu_torch.execution.replay_buffer import powered_priorities

    cap, size = 4096, 3000
    rng = np.random.default_rng(0)
    hs, hm = segment_tree.SumSegmentTree(cap), segment_tree.MinSegmentTree(cap)
    dt = segment_tree.DeviceSumTree(cap, cuda)
    for step in range(5):
        idx = rng.integers(0, size, 64)
        idx[1::5] = idx[0]
        pv, _ = powered_priorities(rng.random(64) * 3 + 0.01, 0.6)
        if step == 0:
            idx, pv = np.arange(size), powered_priorities(rng.random(size) + 0.01, 0.6)[0]
        for t in (hs, hm):
            t.set_items(idx, pv)
        dt.set_powered(torch.as_tensor(idx, device=cuda), pv)
        assert dt.sum_value.cpu().numpy().tobytes() == hs.value.tobytes()
        assert dt.min_value.cpu().numpy().tobytes() == hm.value.tobytes()
        rand = rng.random(32)
        got_idx, w = dt.draw(rand, size, 0.4)
        total = hs.sum(0, size)
        want = np.clip(hs.find_prefixsum_idx((rand + np.arange(32)) / 32 * total), 0, size - 1)
        np.testing.assert_array_equal(got_idx.cpu().numpy(), want)
        hw = ((hs[want] / total * size) ** -0.4 / (hm.min(0, size) / total * size) ** -0.4)
        ulps = np.abs(w.cpu().numpy().view(np.int32) - hw.astype(np.float32).view(np.int32))
        assert ulps.max() <= 1


def _gae_args(n, t, device):
    gen = torch.Generator(device=device).manual_seed(n * t)
    r, v, nv = (torch.randn(n, t, device=device, generator=gen) for _ in range(3))
    term = torch.rand(n, t, device=device, generator=gen) < 0.05
    done = term | (torch.rand(n, t, device=device, generator=gen) < 0.05)
    done[0] = True  # a row that is done at every step
    return r, v, nv, term, done


@pytest.mark.parametrize("gamma,lam", [(0.99, 0.95), (0.9, 1.0)])
@pytest.mark.parametrize("n,t", [(16, 128), (1, 1), (3, 1), (5, 7), (33, 300), (257, 64), (1, 129),
                                 (16, 256)])
def test_gae_kernel_bitwise(cuda, n, t, gamma, lam):
    args = _gae_args(n, t, cuda)
    before = gae.compute_gae_fragment.launches
    adv, vt = gae.compute_gae_fragment(*args, gamma, lam)
    assert gae.compute_gae_fragment.launches == before + 1
    p_adv, p_vt = gae.compute_gae_fragment_plain(*args, gamma, lam)
    assert torch.equal(adv, p_adv) and torch.equal(vt, p_vt)


@pytest.mark.parametrize("n,t", [(16, 128), (5, 8)])
def test_gae_kernel_bitwise_on_unaligned_inputs(cuda, n, t):
    """Contiguous inputs 4 bytes off a 16-byte boundary (and flags 1 byte
    off 4) take the kernel's element-wise staging even where T % 4 == 0."""
    args = []
    for x in _gae_args(n, t, cuda):
        base = torch.zeros(n * t + 1, dtype=x.dtype, device=cuda)
        base[1:] = x.reshape(-1)
        args.append(base[1:].view(n, t))
    adv, vt = gae.compute_gae_fragment(*args, 0.99, 0.95)
    p_adv, p_vt = gae.compute_gae_fragment_plain(*args, 0.99, 0.95)
    assert torch.equal(adv, p_adv) and torch.equal(vt, p_vt)


def _flash_qkv(gen, b, h, t, s, d, layout, dtype=torch.float32):
    """q (B, H, T, D), k and v (B, H, S, D): contiguous ("bhtd"), or
    (B, H, n, D) views over (B, n, H, D) memory ("bthd"), as the torso's
    projections come."""
    def one(n):
        if layout == "bhtd":
            return torch.randn(b, h, n, d, device="cuda", generator=gen).to(dtype)
        return torch.randn(b, n, h, d, device="cuda", generator=gen).to(dtype).transpose(1, 2)

    return one(t), one(s), one(s)


# (B, H, T, S, D, offset, layout): the torso's four path shapes (B·H =
# 2048, 4096, 128, 256) contiguous and in the torso's layout, the
# reference test's shapes and offsets, the head widths (D > 64 takes the
# warp-per-row stream), then the query row per thread at its edges: T of
# 1, 3, 17 and 32, D of 1, 33 and 64, heads not a multiple of a warp's
# (32 / bq), offsets -3, 0, 5 and None, S past a chunk (the chunk merge)
FLASH_CASES = [
    (1, 2048, 8, 8, 32, 0, "bhtd"), (1, 4096, 8, 8, 32, 0, "bhtd"),
    (1, 128, 8, 8, 32, 0, "bhtd"), (1, 256, 8, 8, 32, 0, "bhtd"),
    (256, 8, 8, 8, 32, 0, "bthd"), (512, 8, 8, 8, 32, 0, "bthd"),
    (16, 8, 8, 8, 32, 0, "bthd"), (32, 8, 8, 8, 32, 0, "bthd"),
    (1, 4, 24, 40, 16, None, "bhtd"), (1, 4, 24, 40, 16, 16, "bhtd"), (1, 4, 32, 32, 16, 0, "bhtd"),
    (1, 4, 130, 200, 16, 7, "bhtd"), (1, 4, 8, 8, 16, -3, "bhtd"), (1, 6, 8, 8, 16, 40, "bhtd"),
    (1, 64, 16, 16, 16, 0, "bhtd"), (1, 64, 16, 16, 64, 0, "bhtd"), (1, 64, 16, 16, 128, 0, "bhtd"),
    (1, 64, 8, 24, 100, 5, "bhtd"),
    (3, 5, 1, 9, 32, None, "bthd"), (2, 7, 3, 3, 32, 0, "bthd"), (3, 3, 3, 5, 1, -3, "bhtd"),
    (2, 5, 17, 40, 16, 5, "bthd"), (1, 3, 17, 17, 33, 0, "bthd"), (2, 3, 32, 32, 64, -3, "bthd"),
    (1, 3, 32, 70, 64, 5, "bthd"), (1, 9, 8, 100, 32, None, "bthd"), (1, 5, 8, 8, 33, -3, "bhtd"),
    (1, 2, 1, 1, 1, 0, "bhtd"), (4, 3, 32, 33, 8, None, "bthd"),
    # GTrXL's act step: one query row against its 50-step memory and
    # itself, every key visible (4 envs of the sampler; a single action)
    (4, 2, 1, 51, 32, 50, "bthd"), (1, 2, 1, 51, 32, 50, "bthd"),
    (4, 2, 1, 51, 32, 50, "bhtd"), (1, 2, 1, 51, 32, 50, "bhtd"),
]


@pytest.mark.parametrize("b,h,t,s,d,offset,layout", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, b, h, t, s, d, offset, layout):
    gen = torch.Generator(device=cuda).manual_seed(b + h + t + s + d)
    q, k, v = _flash_qkv(gen, b, h, t, s, d, layout)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal_offset=offset)
    assert fa.flash_attention.launches == before + 1
    assert got.stride() == q.stride()  # the output takes q's layout
    want = fa.reference_attention(q, k, v, offset)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    if offset is not None and offset < 0:  # rows 0 .. -offset - 1 see no key
        assert torch.equal(got[:, :, :-offset], torch.zeros_like(got[:, :, :-offset]))
        assert -offset >= t or got[:, :, -offset:].abs().max() > 0


@pytest.mark.parametrize("b,h,t,s,d,offset,layout", [(2, 2, 16, 16, 16, None, "bhtd"),
                                                      (64, 8, 8, 8, 32, 0, "bthd"),
                                                      (2, 3, 17, 40, 24, 5, "bthd")])
def test_flash_attention_kernel_bf16(cuda, b, h, t, s, d, offset, layout):
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = _flash_qkv(gen, b, h, t, s, d, layout, torch.bfloat16)
    got = fa.flash_attention(q, k, v, causal_offset=offset)
    assert got.dtype == torch.bfloat16 and got.stride() == q.stride()
    want = fa.reference_attention(q, k, v, offset)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("layout", ["bhtd", "bthd"])
def test_flash_attention_gradient_through_kernel(cuda, layout):
    gen = torch.Generator(device=cuda).manual_seed(2)
    qkv = [x.detach().requires_grad_() for x in _flash_qkv(gen, 2, 2, 16, 16, 8, layout)]
    before = fa.flash_attention.launches
    (fa.flash_attention(*qkv, causal_offset=0) ** 2).sum().backward()
    assert fa.flash_attention.launches == before + 1
    got = [x.grad.clone() for x in qkv]
    plain = [x.detach().clone().requires_grad_() for x in qkv]
    (fa.reference_attention(*plain, 0) ** 2).sum().backward()
    for g, p in zip(got, plain):
        torch.testing.assert_close(g, p.grad, atol=1e-4, rtol=1e-4)


def test_flash_attention_without_grad_launches_directly(cuda):
    """Under no_grad (the act path, the target forwards) the kernel runs
    outside autograd: same values, no graph."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    q, k, v = (x.requires_grad_() for x in _flash_qkv(gen, 4, 8, 8, 8, 32, "bhtd"))
    with torch.no_grad():
        got = fa.flash_attention(q, k, v, causal_offset=0)
    assert got.grad_fn is None and not got.requires_grad
    torch.testing.assert_close(got, fa.flash_attention(q, k, v, causal_offset=0).detach(),
                               atol=0, rtol=0)


def test_torso_forward_launches_no_copy_for_qkv(cuda):
    """A torso forward on the card reads the projections where they are:
    its attention launches no copy kernel (by the profiler's list), and
    each layer one short-head flash kernel (by the wrapper's count, the
    profiler naming the kernel). A first forward builds and loads the
    kernel before the profiler starts."""
    from ray_tpu_torch.env.spaces import Box, Discrete
    from ray_tpu_torch.models.catalog import ModelCatalog

    cfg = {"use_transformer": True, "transformer_dim": 64, "transformer_num_layers": 2,
           "transformer_num_heads": 2, "transformer_ff_dim": 128, "transformer_seq_len": 8}
    model = ModelCatalog.get_model(Box(-1, 1, (32,), np.float32), Discrete(4), 4, cfg).to(cuda)
    obs = torch.randn(64, 32, device=cuda)
    forwards = 4
    with torch.no_grad():
        model(obs)
        torch.cuda.synchronize()
        before = fa.flash_attention.launches
        with _profiled() as prof:
            for _ in range(forwards):
                model(obs)
    assert fa.flash_attention.launches == before + 2 * forwards
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any("flash_rows_kernel" in n for n in names), names
    assert not [n for n in names if "flash_fwd_kernel" in n or "copy" in n.lower()], names


@pytest.mark.parametrize("batch", [4, 1])
def test_gtrxl_act_step_on_the_card_matches_its_cpu_run(cuda, batch):
    """GTrXL's act step at the catalog's widths (dim 64, 2 heads of 32,
    a 50-step memory): the card's forward, one short-head flash kernel a
    unit, against the same weights on the CPU (the plain version) within
    1e-5, the memory out included."""
    from ray_tpu_torch.algorithms.ppo.ppo import PPOTorchPolicy
    from ray_tpu_torch.env.spaces import Box, Discrete

    cfg = {"model": {"use_attention": True}, "seed": 0}
    space = Box(-1.0, 1.0, (4,), np.float32)
    card = PPOTorchPolicy(space, Discrete(2), cfg, device=cuda)
    host = PPOTorchPolicy(space, Discrete(2), cfg, device="cpu")
    host.set_weights(card.get_weights())
    gen = torch.Generator().manual_seed(batch)
    obs = torch.randn(batch, 4, generator=gen)
    mem = torch.randn(batch, 50, 64, generator=gen)
    before = fa.flash_attention.launches
    with torch.no_grad():
        got = card._act_forward(obs.to(cuda), [mem.to(cuda)])
        want = host._act_forward(obs, [mem])
    assert fa.flash_attention.launches == before + 1
    for g, w in zip((got[0], got[1], *got[2]), (want[0], want[1], *want[2])):
        torch.testing.assert_close(g.cpu(), w, atol=1e-5, rtol=1e-5)


def test_flash_attention_refusals(cuda):
    q = torch.randn(1, 2, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        wide = torch.randn(1, 2, 8, 129, device=cuda)
        fa.flash_attention(wide, wide, wide)
    with pytest.raises(ValueError, match="k on"):
        fa.flash_attention(q, q.cpu(), q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError, match="v is"):
        fa.flash_attention(q, q, q.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.randn(1, 2, 32, 8, device=cuda).transpose(2, 3)
        fa.flash_attention(t, q, q)


def _block_tol(s):
    """The flash block kernel's abs/rel tolerance against float64 over
    ``s`` keys (the 4096-key ring hop or a few hundred)."""
    return 1e-4 if s >= 4096 else 2e-5


# (B·H, T, S, D, offset): the ring's hop at its four kinds of offset (the
# diagonal, one and three shards behind, one ahead), the torso's shape,
# the reference test's shard, ragged T and S, the head widths
FLASH_BLOCK_CASES = [
    (8, 4096, 4096, 32, 0), (8, 4096, 4096, 32, 4096), (8, 4096, 4096, 32, 12288),
    (8, 4096, 4096, 32, -4096), (2048, 8, 8, 32, 0), (4, 8, 8, 16, 0), (4, 8, 8, 16, -8),
    (4, 130, 200, 16, 7), (4, 130, 200, 16, -150),
    (64, 16, 16, 16, 0), (64, 16, 16, 32, 0), (64, 16, 16, 64, 0), (64, 16, 16, 128, 3),
    # the tile's edges (64 query rows, 64 keys): D short of the mma's
    # depth or not a multiple of it, T and S beside a tile edge, offsets
    # on and beside it
    (4, 63, 65, 8, 0), (4, 64, 64, 40, 0), (4, 65, 63, 40, 1), (4, 129, 129, 16, 63),
    (4, 129, 129, 16, 64), (4, 129, 129, 16, 65), (4, 65, 129, 8, -1), (4, 129, 65, 40, -64),
    (4, 64, 64, 16, -63), (4, 65, 129, 7, 2), (3, 129, 64, 100, 127),
    # the query row per thread (T <= 32, D <= 64): ragged heads and rows,
    # the chunk merge past 32 and 16 keys, D of 1, 33 and 64, blind rows,
    # a block that sees no key at all
    (3, 17, 40, 16, -5), (2, 32, 70, 64, 3), (9, 3, 5, 1, 0), (5, 8, 8, 33, -2),
    (7, 32, 33, 8, -40), (11, 1, 9, 32, 4), (2, 32, 32, 64, 31),
]


@pytest.mark.parametrize("n,t,s,d,offset", FLASH_BLOCK_CASES)
def test_flash_block_kernel_matches_plain(cuda, n, t, s, d, offset):
    gen = torch.Generator(device=cuda).manual_seed(n + t + s + d)
    q, k, v = (torch.randn(n, x, d, device=cuda, generator=gen) for x in (t, s, s))
    before = fa.flash_block_attention_stats.launches
    got = fa.flash_block_attention_stats(q, k, v, offset)
    assert fa.flash_block_attention_stats.launches == before + 1
    # the plain version on float64 copies: the kernel's own float32 error
    want = fa.reference_block_attention_stats(q.double(), k.double(), v.double(), offset)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g.double(), w, atol=_block_tol(s), rtol=_block_tol(s))
    blind = torch.arange(t, device=cuda) + offset < 0  # rows that see no key
    acc, m, l = got
    assert bool((m[:, blind] == -1e30).all()) and bool((l[:, blind] == 0).all())
    assert bool((acc[:, blind] == 0).all()) and bool((l[:, ~blind] > 0).all())


@pytest.mark.parametrize("n,t,s,d,offset", [(8, 4096, 4096, 32, 0), (8, 4096, 4096, 32, 4096),
                                             (4, 130, 130, 16, 7), (4, 129, 129, 40, 63),
                                             (4, 65, 63, 8, 1), (4, 65, 129, 7, 2),
                                             (64, 8, 8, 32, -2), (3, 17, 40, 16, 5)])
def test_flash_block_kernel_bf16(cuda, n, t, s, d, offset):
    """bf16 in, float32 out: held like float32 against float64 copies,
    which hold the bf16 inputs exactly."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn(n, x, d, device=cuda, generator=gen).bfloat16() for x in (t, s, s))
    got = fa.flash_block_attention_stats(q, k, v, offset)
    want = fa.reference_block_attention_stats(q.double(), k.double(), v.double(), offset)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g.double(), w, atol=_block_tol(s), rtol=_block_tol(s))


def test_flash_block_refusals(cuda):
    q = torch.randn(2, 8, 32, device=cuda)
    with pytest.raises(ValueError, match=r"q \(N, T, D\)"):
        fa.flash_block_attention_stats(q[None], q[None], q[None], 0)
    with pytest.raises(ValueError, match="head dim"):
        wide = torch.randn(2, 8, 129, device=cuda)
        fa.flash_block_attention_stats(wide, wide, wide, 0)
    with pytest.raises(ValueError, match="k on"):
        fa.flash_block_attention_stats(q, q.cpu(), q, 0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_block_attention_stats(q.half(), q.half(), q.half(), 0)


def test_ring_of_two_gloo_ranks_on_one_card(cuda, tmp_path):
    """Two ranks on the card over gloo, each on its own block of T: each
    returns its (B, T / 2, H, D) rows with no gather in the call, each
    hop launches the kernel, and the one exchange of each call is staged
    through host memory; the rows joined along T match the full
    attention."""
    from _torch_ring_worker import RING_CASES, ring_inputs, run_ranks

    from ray_tpu_torch.parallel.ring_attention import full_attention_reference

    ranks = run_ranks(2, tmp_path, device="cuda", timeout_s=300)
    for seed, (name, shape, causal) in enumerate(RING_CASES):
        want = full_attention_reference(*map(torch.as_tensor, ring_inputs(shape, seed)), causal=causal)
        tol = 5e-4 if name == "long_sequence_causal" else 2e-4
        b, t, h, d = shape
        got = np.concatenate([r[f"ring/{name}"] for r in ranks], axis=1)
        np.testing.assert_allclose(got, want.numpy(), atol=tol, rtol=tol)
        for r in ranks:
            assert r[f"ring/{name}"].shape == (b, t // 2, h, d) and int(r[f"gathers/{name}"]) == 0
            assert np.array_equal(r[f"gathered/{name}"], got)
            assert int(r[f"launches/{name}"]) == 2 and int(r[f"staged/{name}"]) == 1


# -- the superstep as CUDA graphs ---------------------------------------------


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _ppo_lane(device, seed=0):
    from ray_tpu_torch.algorithms.ppo.ppo import PPOTorchPolicy
    from ray_tpu_torch.env.pong_lite_tensor import PongLiteTensor
    from ray_tpu_torch.execution.device_rollout import DeviceRolloutEngine

    env = PongLiteTensor({"max_steps": 40, "rallies": 3})
    cfg = {"seed": seed, "gamma": 0.99, "lambda": 0.95, "lr": 1e-3, "train_batch_size": 256,
           "sgd_minibatch_size": 64, "num_sgd_iter": 2, "entropy_coeff": 0.01,
           "kl_coeff": 0.2, "grad_clip": 0.5}
    policy = PPOTorchPolicy(env.observation_space, env.action_space, cfg, device=device)
    return policy, DeviceRolloutEngine(policy, env, 8, 32, seed=seed + 1)


def test_graphed_ppo_lane_slots_equal_eager_slots(cuda):
    """3 slots (the first eager, 2 replays) of one captured rollout +
    GAE + nest slot, then 3 more replays, against 6 eager rollout-then-
    learn rounds with the coefficients held per superstep: bitwise in
    params, Adam state, env carry, generator states, stats and episode
    metrics."""
    (p1, e1), (p2, e2) = _ppo_lane(cuda), _ppo_lane(cuda)
    for _ in range(2):
        kl = p1.coeff_values["kl_coeff"]
        seq = []
        for _ in range(3):
            p1.coeff_values["kl_coeff"] = kl
            batch, bsize = e1.rollout()
            out = p1.learn_on_device_batch(e1.learn_batch(batch), bsize)
            out.pop("cur_kl_coeff")
            seq.append(out)
        p1.coeff_values["kl_coeff"] = kl
        for out in seq:
            out.update(p1.after_learn_on_batch(out))
        infos, carry, metrics, skipped = p2.learn_rollout_superstep(3, 256, e2.superstep_feed())
        e2.advance(carry, metrics)
        for info in infos:
            info.update(p2.after_learn_on_batch(info))
        assert infos == seq and skipped == [False] * 3
        assert _same(p1.params, p2.params)
        assert _same(p1.opt_state.mu, p2.opt_state.mu) and _same(p1.opt_state.nu, p2.opt_state.nu)
        assert p1.opt_state.count == p2.opt_state.count
        for k in e1.carry["env"]:
            assert torch.equal(e1.carry["env"][k], e2.carry["env"][k]), k
        for k in ("obs", "ep_ret", "ep_len"):
            assert torch.equal(e1.carry[k], e2.carry[k]), k
        for g1, g2 in ((p1.action_generator, p2.action_generator),
                       (e1.env_generator, e2.env_generator),
                       (p1.perm_generator, p2.perm_generator)):
            assert torch.equal(g1.get_state(), g2.get_state())
        assert ([(m.episode_length, m.episode_reward) for m in e1.get_metrics()]
                == [(m.episode_length, m.episode_reward) for m in e2.get_metrics()])
    (runner,) = p2._superstep_runners.values()
    assert runner.graph is not None and runner.replays == 5 and runner.drains == 2


def _dqn_pair(device):
    from ray_tpu_torch.algorithms.dqn.dqn import DQNConfig

    def make():
        cfg = (
            DQNConfig()
            .environment("PongLiteJax-v0", env_config={"max_steps": 30, "rallies": 2},
                         env_backend="jax")
            .rollouts(num_envs_per_worker=8, rollout_fragment_length=4)
            .training(replay_buffer_config={"capacity": 512, "prioritized_replay": True},
                      train_batch_size=32)
            .debugging(seed=4).resources(device=device)
        )
        algo = cfg.build()
        for _ in range(8):
            algo._jax_rollout_fill()
        return algo

    return make(), make()


def test_graphed_dqn_replay_slots_equal_eager_updates(cuda):
    """3 prioritized replay slots (draw, gather, update, |TD|) as one
    captured graph against the eager updates on the same pre-drawn
    sets: bitwise in params, Adam state, the sum tree and the stats;
    the descent and gather launches count the replays."""
    from ray_tpu_torch.execution.train_ops import superstep_train_replay

    a, b = _dqn_pair(cuda)
    for _ in range(2):
        pa, ba = a.get_policy(), a.local_replay_buffer.buffers["default_policy"]
        idx, weights = ba.draw_prioritized_sets_device(3, 3, 32, 0.4)
        seq = []
        for i in range(3):
            tree = ba._gather_columns(idx[i])
            tree["weights"] = weights[i]
            seq.append(pa.learn_on_device_batch(tree, 32))
            with torch.no_grad():
                td = torch.abs(pa._td_error(tree, pa.aux_state)[0]).cpu().numpy()
            ba.update_priorities(idx[i], td + 1e-6)
        pb, bb = b.get_policy(), b.local_replay_buffer.buffers["default_policy"]
        before = (segment_tree.find_prefixsum.launches, framestack.gather_rows.launches)
        info = superstep_train_replay(b, pb, bb, 3, 3, 32, prioritized=True, beta=0.4)
        launched = (segment_tree.find_prefixsum.launches - before[0],
                    framestack.gather_rows.launches - before[1])
        assert launched == (3, 3 * len(bb._store)), launched
        assert info == seq[-1]
        assert _same(pa.params, pb.params)
        assert _same(pa.opt_state.mu, pb.opt_state.mu) and _same(pa.opt_state.nu, pb.opt_state.nu)
        assert torch.equal(ba._dtree.sum_value, bb._dtree.sum_value)
        assert ba._max_priority == bb._max_priority


def test_replayed_generator_draws_equal_eager_draws(cuda):
    from ray_tpu_torch.sharding.superstep import SuperstepRunner

    g1 = torch.Generator(device=cuda).manual_seed(5)
    g2 = torch.Generator(device=cuda).manual_seed(5)

    def slot(runner):
        runner.write("u", torch.rand(7, generator=g1, device=cuda))
        runner.write("n", torch.randn(5, generator=g1, device=cuda))
        runner.write("i", torch.randint(0, 9, (3,), generator=g1, device=cuda))

    runner = SuperstepRunner(cuda, 4, slot, generators=(g1,))
    got = [runner.run(4), runner.run(3)]
    for out, k in zip(got, (4, 3)):
        for j in range(k):
            want = (torch.rand(7, generator=g2, device=cuda), torch.randn(5, generator=g2, device=cuda),
                    torch.randint(0, 9, (3,), generator=g2, device=cuda))
            for name, w in zip("uni", want):
                assert torch.equal(torch.as_tensor(out[name][j], device=cuda), w.float()), (name, j)
    assert torch.equal(g1.get_state(), g2.get_state())


def test_launch_counters_count_replays(cuda):
    from ray_tpu_torch.sharding.superstep import SuperstepRunner

    args = _gae_args(4, 16, cuda)
    src = torch.arange(40, dtype=torch.float32, device=cuda).reshape(10, 4)
    idx = torch.tensor([3, 1, 4], device=cuda)

    def slot(runner):
        adv, _ = gae.compute_gae_fragment(*args, 0.99, 0.95)
        runner.write("adv", adv.sum().reshape(1))
        for _ in range(2):
            runner.write("rows", framestack.gather_rows(src, idx).sum().reshape(1))

    runner = SuperstepRunner(cuda, 3, slot)
    for k in (3, 2, 1):
        before = (gae.compute_gae_fragment.launches, framestack.gather_rows.launches)
        out = runner.run(k)
        assert (gae.compute_gae_fragment.launches - before[0],
                framestack.gather_rows.launches - before[1]) == (k, 2 * k)
        assert out["adv"].shape == (k, 1)


def test_capture_survives_a_graph_collected_during_it(cuda):
    """A captured graph that becomes cyclic garbage while another slot
    is being captured is not collected during the capture (its
    destructor would invalidate the capture)."""
    import gc

    from ray_tpu_torch.sharding.superstep import SuperstepRunner

    x = torch.zeros(4, device=cuda)
    old = SuperstepRunner(cuda, 2, lambda r: r.write("y", x * 2))
    old.run(2)
    old.cycle = old  # reachable from here on only through the holder
    holder = {"old": old}
    del old

    def slot(runner):
        if torch.cuda.is_current_stream_capturing():
            holder.pop("old", None)
        acc = x
        for _ in range(64):
            acc = acc + 1
        runner.write("x", acc)

    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        out = SuperstepRunner(cuda, 3, slot).run(3)
    finally:
        gc.set_threshold(*threshold)
    assert not holder
    assert np.array_equal(out["x"], np.full((3, 4), 64.0, np.float32))


def _actor_lane_batches(rng, frags=4, n=128):
    """A pooled train batch as the actor lane's workers ship it (one
    ``compress_for_shipping`` per fragment, then the main process's concat) at
    the 84x84x4 geometry, and its stacked original."""
    from ray_tpu_torch.algorithms.ppo.ppo import PPOTorchPolicy
    from ray_tpu_torch.data.sample_batch import SampleBatch, concat_samples
    from ray_tpu_torch.env.spaces import Box, Discrete

    shipper = PPOTorchPolicy(Box(0, 255, (84, 84, 4), np.uint8), Discrete(3), {}, device="cpu")
    shipped = []
    for i in range(frags):
        stream = rng.integers(0, 256, (n + 4, 84, 84, 1), dtype=np.uint8)
        obs = framestack.materialize_stacks_np(stream, np.arange(n + 1), 4)
        shipped.append(shipper.compress_for_shipping(SampleBatch({
            "obs": obs[:n], "new_obs": obs[1:], "dones": np.zeros(n, bool),
            "truncateds": np.zeros(n, bool), "actions": rng.integers(0, 3, n),
            "action_logp": np.full(n, -1.1, np.float32),
            "action_dist_inputs": rng.standard_normal((n, 3)).astype(np.float32),
            "advantages": rng.standard_normal(n).astype(np.float32),
            "value_targets": rng.standard_normal(n).astype(np.float32),
            "eps_id": np.full(n, i, np.int64), "unroll_id": np.full(n, i, np.int64),
        })))
    pooled = concat_samples(shipped)
    assert framestack.FRAMES in pooled
    return pooled, SampleBatch(framestack.materialize_fragment(dict(pooled), 4))


def test_pooled_learn_equals_stacked_learn_on_card(cuda):
    """The actor lane's pooled batch (stacks rebuilt by the row-gather
    kernel) and its stacked original learn bitwise the same parameters
    and stats on the same permutations, with the default bf16 VisionNet;
    one gather launch per pooled learn call, none for the stacked one."""
    from ray_tpu_torch.algorithms.ppo.ppo import PPOTorchPolicy
    from ray_tpu_torch.env.spaces import Box, Discrete

    pooled, stacked = _actor_lane_batches(np.random.default_rng(0))
    cfg = {"seed": 0, "train_batch_size": 512, "sgd_minibatch_size": 128, "num_sgd_iter": 2,
           "lr": 2.5e-4, "dedup_framestack": False}
    a, b = (PPOTorchPolicy(Box(0, 255, (84, 84, 4), np.uint8), Discrete(3), cfg, device=cuda)
            for _ in range(2))
    for _ in range(2):
        perms = a.draw_permutations(512)
        before = framestack.gather_rows.launches
        sa = a.learn_on_batch(pooled, perms=perms)
        assert framestack.gather_rows.launches == before + 1
        sb = b.learn_on_batch(stacked, perms=perms)
        assert framestack.gather_rows.launches == before + 1
        assert sa == sb
    for (name, wa), wb in zip(a.get_weights().items(), b.get_weights().values()):
        assert np.array_equal(wa, wb), name
    assert a.last_learn_timers["learn_transfer_bytes"] * 3 < b.last_learn_timers["learn_transfer_bytes"]


def test_device_feeder_copy_survives_host_and_allocator_reuse(cuda):
    """The feeder's pinned side-stream copy is bitwise the host tree; the
    tensors stay intact after the host arrays are overwritten, and a
    batch the consumer's stream still reads (queued behind a delay) is
    not handed to the next copy by the caching allocator once dropped
    (``record_stream``)."""
    from ray_tpu_torch.execution.device_feed import DeviceFeeder

    rng = np.random.default_rng(0)
    host = {"frames": rng.integers(0, 256, (1088, 84, 84, 1), dtype=np.uint8),
            "idx": rng.integers(0, 1024, (16, 65)).astype(np.int32),
            "rewards": rng.standard_normal((16, 64)).astype(np.float32)}
    want = {k: v.copy() for k, v in host.items()}
    want_sum = float(want["frames"].astype(np.float64).sum())
    feeder = DeviceFeeder(cuda, capacity=2)
    try:
        feeder.put(host, 0)
        dev, meta = feeder.get(timeout=60)
        assert meta == 0 and all(t.is_cuda for t in dev.values())
        for v in host.values():
            v[...] = 0
        torch.cuda._sleep(200_000_000)  # hold the consumer stream
        total = dev["frames"].to(torch.float64).sum()
        got = {k: t.cpu() for k, t in dev.items()}  # queued behind the delay too
        del dev
        for i in range(3):  # same-sized copies that could reuse the freed blocks
            feeder.put({k: np.zeros_like(v) for k, v in want.items()}, i + 1)
            feeder.get(timeout=60)
        torch.cuda.synchronize()
        assert total.item() == want_sum
        for k, v in want.items():
            assert np.array_equal(got[k].numpy(), v), k
        assert feeder.num_batches == 4 and all(c["h2d_ms"] > 0 for c in feeder.copies)
    finally:
        feeder.stop()


def _impala_pooled_unrolls(rng, frags=4, T=64):
    """Fixed unrolls at the 84x84x4 geometry as IMPALA's workers ship
    them (frame pools with the bootstrap frame), concatenated."""
    from ray_tpu_torch.algorithms.impala.impala import ImpalaTorchPolicy
    from ray_tpu_torch.data.sample_batch import SampleBatch, concat_samples
    from ray_tpu_torch.env.spaces import Box, Discrete

    shipper = ImpalaTorchPolicy(Box(0, 255, (84, 84, 4), np.uint8), Discrete(3),
                                {"_fixed_unrolls": True, "rollout_fragment_length": T}, device="cpu")
    shipped = []
    for i in range(frags):
        stream = rng.integers(0, 256, (T + 4, 84, 84, 1), dtype=np.uint8)
        obs = framestack.materialize_stacks_np(stream, np.arange(T + 1), 4)
        shipped.append(shipper.compress_for_shipping(SampleBatch({
            "obs": obs[:T], "new_obs": obs[1:], "dones": np.arange(T) == T // 3,
            "truncateds": np.zeros(T, bool), "actions": rng.integers(0, 3, T),
            "rewards": rng.standard_normal(T).astype(np.float32),
            "action_logp": np.full(T, -1.1, np.float32),
        })))
    return concat_samples(shipped)


@pytest.mark.parametrize("kind", ["ppo", "impala"])
def test_learner_thread_equals_sync_learn_on_card(cuda, kind):
    """Batches learned through the learner thread (prepare on the thread,
    the feeder's pinned side-stream copy, deferred stats for IMPALA)
    give bitwise the stats and parameters of the synchronous
    ``learn_on_batch`` of a second policy of the same seed, with the
    default bf16 VisionNet; one row-gather launch per learn call."""
    from ray_tpu_torch.algorithms.impala.impala import ImpalaTorchPolicy
    from ray_tpu_torch.algorithms.ppo.ppo import PPOTorchPolicy
    from ray_tpu_torch.env.spaces import Box, Discrete
    from ray_tpu_torch.execution.learner_thread import LearnerThread

    rng = np.random.default_rng(1)
    if kind == "ppo":
        cls, cfg = PPOTorchPolicy, {"train_batch_size": 512, "sgd_minibatch_size": 128,
                                    "num_sgd_iter": 2}
        batches = [_actor_lane_batches(rng)[0] for _ in range(3)]
    else:
        cls, cfg = ImpalaTorchPolicy, {"train_batch_size": 256, "rollout_fragment_length": 64,
                                       "_fixed_unrolls": True}
        batches = [_impala_pooled_unrolls(rng) for _ in range(3)]
    threaded, sync = (cls(Box(0, 255, (84, 84, 4), np.uint8), Discrete(3),
                          {"seed": 0, "lr": 2.5e-4, **cfg}, device=cuda) for _ in range(2))
    lt = LearnerThread(threaded, publish_weights_every=1)
    before = framestack.gather_rows.launches
    lt.start()
    for b in batches:
        assert lt.add_batch(b)
    deadline = time.time() + 120
    while lt.num_steps < len(batches) and time.time() < deadline:
        time.sleep(0.01)
    lt.stop()
    assert lt.error is None and lt.num_steps == 3
    assert framestack.gather_rows.launches == before + 3
    infos = [lt.outqueue.get_nowait()[1] for _ in range(3)]
    assert infos == [sync.learn_on_batch(b) for b in batches]
    for (name, a), b in zip(threaded.get_weights().items(), sync.get_weights().values()):
        assert np.array_equal(a, b), name
    assert lt.published_weights()[0] == 3
    assert all(c["h2d_ms"] > 0 for c in lt.feeder.copies)


# -- SAC: the graphed replay slot and the replay columns at SAC's widths ----


def _sac_pair(cuda, prioritized):
    """Two SAC policies and two identical device rings (obs 17, act 6,
    64x64 towers) on the card."""
    from ray_tpu_torch.algorithms.sac.sac import SACConfig, SACTorchPolicy
    from ray_tpu_torch.env.spaces import Box
    from ray_tpu_torch.execution.replay_buffer import (
        DevicePrioritizedReplayBuffer,
        DeviceReplayBuffer,
    )

    cfg = SACConfig().training(policy_model_config={"fcnet_hiddens": [64, 64]},
                               q_model_config={"fcnet_hiddens": [64, 64]}).debugging(seed=2)

    def make():
        policy = SACTorchPolicy(Box(-np.inf, np.inf, (17,), np.float64), Box(-1, 1, (6,)),
                                cfg.to_dict(), device=cuda)
        buf = (DevicePrioritizedReplayBuffer(2048, 0.6, 3, device=cuda) if prioritized
               else DeviceReplayBuffer(2048, 3, device=cuda))
        gen = torch.Generator(device=cuda).manual_seed(1)
        buf.add_device_tree({
            "obs": torch.randn((2048, 17), device=cuda, generator=gen),
            "new_obs": torch.randn((2048, 17), device=cuda, generator=gen),
            "actions": torch.rand((2048, 6), device=cuda, generator=gen) * 2 - 1,
            "rewards": torch.randn((2048,), device=cuda, generator=gen),
            "dones": torch.rand((2048,), device=cuda, generator=gen) < 0.01,
        })
        return policy, buf

    return make(), make()


@pytest.mark.parametrize("prioritized", [False, True])
def test_graphed_sac_replay_slots_equal_eager_updates(cuda, prioritized):
    """4 SAC replay slots (draw, gather, the three Adam steps and the
    blend, |TD| at a third draw) as one captured graph, twice, against
    the eager updates on the same pre-drawn rows: bitwise in every
    parameter, Adam moment, the target critic, the registered
    generator, the stats (and the sum tree); the gather and descent
    launches count the replays."""
    from ray_tpu_torch.execution.train_ops import superstep_train_replay

    (pa, ba), (pb, bb) = _sac_pair(cuda, prioritized)
    for _ in range(2):
        if prioritized:
            idx, weights = ba.draw_prioritized_sets_device(4, 4, 64, 0.4)
        else:
            idx = torch.as_tensor(ba.draw_index_sets(4, 64), device=cuda)
        seq = []
        for i in range(4):
            tree = ba._gather_columns(idx[i])
            if prioritized:
                tree["weights"] = weights[i]
            seq.append(pa.learn_on_device_batch(tree, 64))
            if prioritized:
                td = torch.abs(pa._td_error(tree, pa.aux_state)[0]).cpu().numpy()
                ba.update_priorities(idx[i], td + 1e-6)
        before = (segment_tree.find_prefixsum.launches, framestack.gather_rows.launches)
        info = superstep_train_replay(None, pb, bb, 4, 4, 64, prioritized=prioritized, beta=0.4)
        launched = (segment_tree.find_prefixsum.launches - before[0],
                    framestack.gather_rows.launches - before[1])
        assert launched == (4 if prioritized else 0, 4 * 5), launched
        assert info == seq[-1]
    assert _same(pa.params, pb.params)
    for g in pa.opt_states:
        assert pa.opt_states[g].count == pb.opt_states[g].count == 8
        assert _same(pa.opt_states[g].mu, pb.opt_states[g].mu)
        assert _same(pa.opt_states[g].nu, pb.opt_states[g].nu)
    assert _same(pa.aux_state["target_critic"], pb.aux_state["target_critic"])
    assert torch.equal(pa.action_generator.get_state(), pb.action_generator.get_state())
    (runner,) = pb._superstep_runners.values()
    assert runner.graph is not None and runner.replays == 7
    if prioritized:
        assert torch.equal(ba._dtree.sum_value, bb._dtree.sum_value)
        assert ba._max_priority == bb._max_priority


@pytest.mark.parametrize("obs,act", [(3, 1), (17, 6)])
def test_sac_columns_gather_and_scatter_bitwise(cuda, obs, act):
    """SAC's replay columns at Pendulum's (obs 3, act 1) and
    HalfCheetah's (obs 17, act 6) widths: 12-, 4-, 68- and 24-byte float
    rows, float rewards and bool dones, through both kernels against
    ``index_select`` and ``index_copy_``."""
    gen = torch.Generator(device=cuda).manual_seed(obs)
    cap = 5000
    cols = {
        "obs": torch.randn((cap, obs), device=cuda, generator=gen),
        "actions": torch.randn((cap, act), device=cuda, generator=gen),
        "rewards": torch.randn((cap,), device=cuda, generator=gen),
        "dones": torch.rand((cap,), device=cuda, generator=gen) < 0.5,
    }
    idx = torch.randint(0, cap, (256,), device=cuda, generator=gen)
    pos = (cap - 100 + torch.arange(700, device=cuda)) % cap
    for name, ring in cols.items():
        before = (framestack.gather_rows.launches, framestack.scatter_rows.launches)
        assert torch.equal(framestack.gather_rows(ring, idx), ring.index_select(0, idx)), name
        vals = ring[torch.randint(0, cap, (700,), device=cuda, generator=gen)]
        a, b = ring.clone(), ring.clone()
        framestack.scatter_rows(a, pos, vals)
        b.index_copy_(0, pos, vals)
        assert torch.equal(a, b), name
        assert (framestack.gather_rows.launches - before[0],
                framestack.scatter_rows.launches - before[1]) == (1, 1)


def test_sac_acts_on_the_card(cuda):
    from ray_tpu_torch.algorithms.sac.sac import SACConfig, SACTorchPolicy
    from ray_tpu_torch.env.spaces import Box

    policy = SACTorchPolicy(Box(-1, 1, (3,)), Box(-2, 2, (1,)), SACConfig().to_dict(), device=cuda)
    obs = np.random.default_rng(0).standard_normal((8, 3)).astype(np.float32)
    actions, state, extra = policy.compute_actions(obs)
    assert actions.dtype == np.float32 and actions.shape == (8, 1) and np.abs(actions).max() <= 2
    assert state == [] and extra["action_logp"].shape == (8,)
    assert all(p.is_cuda for p in policy.params)


def test_multi_agent_ppo_iteration_on_the_card(cuda):
    """One multi-agent PPO iteration (2 CartPole-v1 agents, p0 and p1,
    num_workers 0: the local worker acts with both policies on the
    card): finite stats for each policy, every parameter on the card."""
    from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig
    from ray_tpu_torch.env.multi_agent_env import make_multi_agent
    from ray_tpu_torch.env.registry import register_env
    from ray_tpu_torch.env.spaces import Box, Discrete

    register_env("cuda_multi_cartpole",
                 lambda cfg: make_multi_agent("CartPole-v1")({"num_agents": 2}))
    space, act = Box(-np.inf, np.inf, (4,), np.float64), Discrete(2)
    algo = (PPOConfig().environment("cuda_multi_cartpole")
            .rollouts(num_rollout_workers=0, rollout_fragment_length=64)
            .training(train_batch_size=128, sgd_minibatch_size=64, num_sgd_iter=2,
                      model={"fcnet_hiddens": [32]})
            .multi_agent(policies={"p0": (None, space, act, {}), "p1": (None, space, act, {})},
                         policy_mapping_fn=lambda aid, **kw: f"p{aid % 2}")
            .debugging(seed=0).resources(device=cuda).build())
    try:
        learner = algo.train()["info"]["learner"]
        assert set(learner) == {"p0", "p1"}
        for pid in ("p0", "p1"):
            assert all(np.isfinite(v) for v in learner[pid].values()), learner[pid]
            assert all(p.is_cuda for p in algo.get_policy(pid).params)
    finally:
        algo.stop()


def _same_state(a, b, path="state"):
    """Bitwise equality of two checkpoint state trees."""
    if isinstance(a, dict):
        assert set(a) == set(b), f"{path}: {sorted(a)} != {sorted(b)}"
        for k in a:
            _same_state(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.tobytes() == np.asarray(b).tobytes(), path
    elif hasattr(a, "rs"):
        assert a.rs.num == b.rs.num and a.rs.mean_.tobytes() == b.rs.mean_.tobytes(), path
    elif not hasattr(a, "__call__"):
        assert a == b, f"{path}: {a!r} != {b!r}"


def test_ppo_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """A device-lane PPO saved on the card comes back through
    ``from_checkpoint`` on the card with every state bitwise, and trains
    on."""
    from ray_tpu_torch.algorithms.algorithm import Algorithm
    from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig

    algo = (PPOConfig().environment("CartPoleJax-v0", env_backend="jax")
            .rollouts(num_envs_per_worker=8, rollout_fragment_length=16)
            .training(train_batch_size=128, sgd_minibatch_size=64, num_sgd_iter=2,
                      model={"fcnet_hiddens": [32]})
            .debugging(seed=0).resources(device=cuda).build())
    algo.train()
    path = algo.save(str(tmp_path / "ckpt"))
    back = Algorithm.from_checkpoint(path)
    assert all(p.is_cuda for p in back.get_policy().params)
    _same_state(algo.__getstate__(), back.__getstate__())
    assert back.iteration == 1
    assert all(np.isfinite(v) for v in back.train()["info"]["learner"]["default_policy"].values())


def test_dqn_device_replay_round_trip_on_the_card(cuda, tmp_path):
    """DQN with its prioritized rings and sum tree on the card, graphed
    supersteps captured: restored into itself and into a fresh
    algorithm, rings, leaves, max priority and policies bitwise; both
    train on."""
    from ray_tpu_torch.algorithms.algorithm import Algorithm
    from ray_tpu_torch.algorithms.dqn.dqn import DQNConfig

    algo = (DQNConfig()
            .environment("PongLiteJax-v0", env_config={"max_steps": 20, "rallies": 2},
                         env_backend="jax")
            .rollouts(num_envs_per_worker=4, rollout_fragment_length=4)
            .training(replay_buffer_config={"capacity": 256, "prioritized_replay": True},
                      model={"conv_filters": [[4, [8, 8], [4, 4]], [8, [4, 4], [2, 2]]],
                             "post_fcnet_hiddens": [16]},
                      train_batch_size=16, num_steps_sampled_before_learning_starts=32,
                      target_network_update_freq=64, training_intensity=8)
            .debugging(seed=0).resources(device=cuda).build())
    for _ in range(6):
        algo.train()
    assert algo.get_policy()._superstep_runners
    path = algo.save(str(tmp_path / "ckpt"))
    saved = algo.__getstate__()
    algo.restore(path)
    _same_state(saved, algo.__getstate__())
    back = Algorithm.from_checkpoint(path)
    _same_state(saved, back.__getstate__())
    for a in (algo, back):
        info = a.train()["info"]["learner"]
        assert all(np.isfinite(v) for v in info["default_policy"].values())


# -- fault tolerance on the card ------------------------------------------------------


def test_nan_guard_graphed_slot_on_the_card(cuda):
    """A poisoned batch (the fault injector's) in a replayed superstep
    slot is a masked no-op on the card: parameters and Adam moments
    bitwise an eager run of the clean updates (the poisoned slot's
    permutations drawn and dropped)."""
    from ray_tpu_torch.algorithms.ppo.ppo import PPOTorchPolicy
    from ray_tpu_torch.env.spaces import Box, Discrete
    from ray_tpu_torch.resilience.faults import FaultInjector

    cfg = {"seed": 0, "model": {"fcnet_hiddens": [32]}, "lr": 1e-3, "train_batch_size": 64,
           "sgd_minibatch_size": 32, "num_sgd_iter": 2, "kl_coeff": 0.0, "nan_guard": True}
    space, acts = Box(-10, 10, (4,), np.float32), Discrete(2)
    pg, pe = PPOTorchPolicy(space, acts, cfg, device=cuda), PPOTorchPolicy(space, acts, cfg, device=cuda)
    rng = np.random.default_rng(3)
    batches = [{"obs": rng.standard_normal((64, 4)).astype(np.float32),
                "actions": rng.integers(0, 2, 64), "action_logp": np.full(64, -0.69, np.float32),
                "action_dist_inputs": rng.standard_normal((64, 2)).astype(np.float32),
                "advantages": rng.standard_normal(64).astype(np.float32),
                "value_targets": rng.standard_normal(64).astype(np.float32)} for _ in range(4)]
    inj = FaultInjector({"nan_batch": {"on_learn_call": 4}})
    for b in batches:
        inj.on_learn(b)
    dev = [{c: torch.as_tensor(v).to(cuda) for c, v in b.items()} for b in batches]
    skipped = []
    for pair in (dev[:2], dev[2:]):
        stacked = {c: torch.stack([d[c] for d in pair]) for c in pair[0]}
        skipped += pg.learn_superstep(2, 64, stacked=stacked, k_max=2)[2]
    (runner,) = pg._superstep_runners.values()
    assert runner.graph is not None and skipped == [False, False, False, True]
    for i, d in enumerate(dev):
        perms = pe.draw_permutations(64)
        if i < 3:
            pe.learn_on_device_batch(d, 64, perms=perms)
    for a, b in zip(pg._learner_tensors(), pe._learner_tensors()):
        assert torch.equal(a, b)


def test_stream_snapshot_on_the_card_is_its_superstep(cuda, tmp_path, monkeypatch):
    """The checkpoint stream on the card: the writer held inside its pull
    while two more supersteps update the parameters in place; each
    written snapshot is bitwise the state its capture saw."""
    import pickle
    import threading

    from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig
    from ray_tpu_torch.resilience import streamer as streamer_mod

    gate, entered = threading.Event(), threading.Event()
    real_pull = streamer_mod._Buffer.pull

    def held_pull(self, stream):
        entered.set()
        assert gate.wait(60)
        return real_pull(self, stream)

    monkeypatch.setattr(streamer_mod._Buffer, "pull", held_pull)
    algo = (PPOConfig().environment("CartPoleJax-v0", env_backend="jax")
            .rollouts(num_envs_per_worker=8, rollout_fragment_length=16)
            .training(train_batch_size=128, sgd_minibatch_size=64, num_sgd_iter=2,
                      model={"fcnet_hiddens": [32]})
            .fault_tolerance(checkpoint_streaming=True, checkpoint_root=str(tmp_path))
            .debugging(seed=0).resources(device=cuda).build())
    try:
        st, states = algo._ckpt_streamer, {}
        for superstep in (1, 2, 3):
            algo.train()
            states[superstep] = pickle.loads(pickle.dumps(algo.get_policy().get_state()))
            if superstep == 1:
                assert entered.wait(30)
        assert [b.state for b in st._buffers] == ["reading", "pending"]
        assert all(t.is_cuda for b in st._buffers for t in b.dev)
        gate.set()
        assert st.flush(30) and st.error is None
        for superstep in (1, 3):
            with open(tmp_path / "stream" / f"snapshot_{superstep:010d}.pkl", "rb") as f:
                _same_state(pickle.load(f)["policy_states"]["default_policy"], states[superstep])
    finally:
        gate.set()
        algo.stop()


def test_crash_restores_dqn_in_place_under_its_graph(cuda, tmp_path):
    """Prioritized DQN with periodic checkpoints and ``crash_learner``:
    the restore writes the rings and the sum tree in place (their
    storage unchanged under the captured slot), bitwise the checkpoint's
    state, and the run trains on."""
    import pickle

    from ray_tpu_torch.algorithms.dqn.dqn import DQNConfig

    algo = (DQNConfig()
            .environment("PongLiteJax-v0", env_config={"max_steps": 20, "rallies": 2},
                         env_backend="jax")
            .rollouts(num_envs_per_worker=4, rollout_fragment_length=4)
            .training(replay_buffer_config={"capacity": 256, "prioritized_replay": True},
                      model={"conv_filters": [[4, [8, 8], [4, 4]], [8, [4, 4], [2, 2]]],
                             "post_fcnet_hiddens": [16]},
                      train_batch_size=16, num_steps_sampled_before_learning_starts=32,
                      target_network_update_freq=64, training_intensity=8)
            .fault_tolerance(checkpoint_frequency=1, checkpoint_root=str(tmp_path),
                             keep_checkpoints_num=2, restore_on_failure=True, max_failures=2,
                             fault_injection={"crash_learner": {"on_learn_call": 4}})
            .debugging(seed=0).resources(device=cuda).build())
    try:
        while algo._fault_injector._learn_calls < 3:
            algo.train()
        runners = algo.get_policy()._superstep_runners
        assert any(r.graph is not None for r in runners.values())
        buf = algo.local_replay_buffer.buffers["default_policy"]
        ptrs = {k: v.data_ptr() for k, v in buf._store.items()}
        tree = buf._dtree.sum_value.data_ptr()
        seen = []
        real = algo.on_recovery

        def on_recovery(kind):
            real(kind)
            with open(f"{algo._recovery.latest_checkpoint}/algorithm_state.pkl", "rb") as f:
                _same_state(pickle.load(f), algo.__getstate__())
            seen.append({k: v.data_ptr() for k, v in buf._store.items()} == ptrs
                        and buf._dtree.sum_value.data_ptr() == tree)

        algo.on_recovery = on_recovery
        r = algo.train()
        assert seen == [True] and r["info"]["recovery"]["recoveries"] == {"restore": 1}
        assert all(np.isfinite(v) for v in r["info"]["learner"]["default_policy"].values())
    finally:
        algo.stop()


# -- the serving plane: one CUDA graph a bucket ----------------------------------------

SERVE_TORSO = {"use_transformer": True, "transformer_dim": 64, "transformer_num_layers": 2,
               "transformer_num_heads": 2, "transformer_ff_dim": 128, "transformer_seq_len": 8}


def _serve_policy(cuda, kind="ppo", seed=7):
    from ray_tpu_torch.algorithms.dqn.dqn import DQNConfig, DQNTorchPolicy
    from ray_tpu_torch.algorithms.ppo.ppo import PPOConfig, PPOTorchPolicy
    from ray_tpu_torch.env.spaces import Box, Discrete

    if kind == "dqn":
        cfg = DQNConfig().to_dict()
        cfg.update(seed=seed, model={"fcnet_hiddens": [64, 64]},
                   exploration_config={"type": "EpsilonGreedy", "initial_epsilon": 0.5,
                                       "final_epsilon": 0.5})
        return DQNTorchPolicy(Box(-1, 1, (16,), np.float32), Discrete(5), cfg, device=cuda)
    cfg = PPOConfig().to_dict()
    model = SERVE_TORSO if kind == "torso" else {"fcnet_hiddens": [64, 64]}
    cfg.update(seed=seed, model=model)
    return PPOTorchPolicy(Box(-1, 1, (16,), np.float32), Discrete(5), cfg, device=cuda)


def _serve_obs(n, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 16)).astype(np.float32)


def test_serve_one_graph_a_bucket_and_none_after_warmup(cuda):
    """Warmup captures one graph per (bucket, explore); traffic at every
    occupancy from 1 to 32 captures none; results come from replays."""
    from ray_tpu_torch.serve.policy_server import BatchedPolicyServer

    server = BatchedPolicyServer(_serve_policy(cuda), max_batch_size=32, start=False)
    assert server.warmup(explore=False) == 6 and server.warmup(explore=True) == 6
    assert server.captures == 12
    assert all(p.graph is not None for p in server._programs.values())
    for n in range(1, 33):
        for explore in (False, True):
            a, ex = server.forward_padded(_serve_obs(n, n), explore=explore)
            assert a.shape == (n,) and ex["action_logp"].shape == (n,)
            assert np.isfinite(ex["action_dist_inputs"]).all()
    st = server.stats()
    assert st["captures"] == 12 and st["captures_after_warmup"] == 0
    assert 0.0 <= st["device"]["hbm_headroom"] <= 1.0 and st["device"]["mfu"] is None


@pytest.mark.parametrize("kind", ["ppo", "dqn", "torso"])
def test_serve_exact_mode_bitwise_against_sequential_calls_on_the_card(cuda, kind):
    """Graph replays of batch-1 bodies against sequential batch-1
    compute_actions on a policy of the same seed, exploring (draws taken
    in arrival order) and greedy, under several splits."""
    from ray_tpu_torch.serve.policy_server import BatchedPolicyServer

    obs = _serve_obs(21, seed=4)
    for explore in (True, False):
        ref = _serve_policy(cuda, kind)
        want = [ref.compute_actions(o[None], explore=explore) for o in obs]
        policy = _serve_policy(cuda, kind)
        gen = policy.action_generator.get_state().clone()
        server = BatchedPolicyServer(policy, max_batch_size=8, start=False)
        server.warmup(explore=explore)
        assert torch.equal(policy.action_generator.get_state(), gen)
        i = 0
        for n in (1, 8, 5, 3, 4):
            a, ex = server.forward_padded(obs[i:i + n], explore=explore)
            for j in range(n):
                a_ref, _, ex_ref = want[i + j]
                assert a[j].tobytes() == a_ref[0].tobytes(), (explore, i + j)
                for k, v in ex_ref.items():
                    assert ex[k][j].tobytes() == v[0].tobytes(), (explore, i + j, k)
            i += n
        assert server.stats()["captures_after_warmup"] == 0


def test_serve_replay_after_hot_reload_reads_the_new_weights(cuda):
    from ray_tpu_torch.serve.policy_server import BatchedPolicyServer

    policy = _serve_policy(cuda)
    w2 = {k: -v for k, v in policy.get_weights().items()}
    server = BatchedPolicyServer(policy, max_batch_size=8, batch_wait_timeout_s=0.001,
                                 start=False)
    server.warmup()
    server.start()
    obs = _serve_obs(4, seed=5)
    try:
        before = [server.submit(o).result(30.0) for o in obs]
        server.update_params({"weights": w2})
        deadline = time.time() + 10
        while time.time() < deadline and server.params_version < 2:
            server.submit(obs[0]).result(30.0)
        futs = [server.submit(o) for o in obs]
        after = [f.result(30.0) for f in futs]
    finally:
        server.stop()
    assert [f.params_version for f in futs] == [2] * 4
    ref = _serve_policy(cuda)
    ref.set_weights(w2)
    for o, (a, ex), (_, ex1) in zip(obs, after, before):
        a_ref, _, ex_ref = ref.compute_actions(o[None], explore=False)
        assert a.tobytes() == a_ref[0].tobytes()
        assert ex["action_dist_inputs"].tobytes() == ex_ref["action_dist_inputs"][0].tobytes()
        assert ex["action_dist_inputs"].tobytes() != ex1["action_dist_inputs"].tobytes()
    assert server.stats()["captures_after_warmup"] == 0


@pytest.mark.parametrize("vectorized", [False, True], ids=["exact", "vectorized"])
def test_serve_torso_flash_launches_a_replay(cuda, vectorized):
    """A torso policy's graphs launch the flash kernel layers x bucket
    times a replay in exact mode (one batch-1 body a row) and layers
    times in vectorized mode; the counter counts replays, not the
    capture."""
    from ray_tpu_torch.serve.policy_server import BatchedPolicyServer

    layers = SERVE_TORSO["transformer_num_layers"]
    server = BatchedPolicyServer(_serve_policy(cuda, "torso"), max_batch_size=8,
                                 vectorized=vectorized, start=False)
    before = fa.flash_attention.launches
    server.warmup()
    # the eager run before each capture, and one forward of a zero
    # observation for the policy's act signature (the draws' shapes)
    eager = sum(layers * (1 if vectorized else b) for b in server.buckets) + layers
    assert fa.flash_attention.launches == before + eager
    for n, bucket in ((3, 4), (8, 8), (1, 1)):
        before = fa.flash_attention.launches
        server.forward_padded(_serve_obs(n, n))
        assert fa.flash_attention.launches == before + layers * (1 if vectorized else bucket)
        assert dict(server._programs[(bucket, False)].counts)[fa.flash_attention] == (
            layers * (1 if vectorized else bucket))


# -- the rest of off-policy: Rainbow, DDPG and TD3, per-policy rings ----------------


def _rainbow_pair(cuda):
    """Two Rainbow DQN policies (C51 over 51 atoms, noisy dueling heads,
    double Q, n-step rows) and two identical prioritized rings."""
    from ray_tpu_torch.algorithms.dqn.dqn import DQNConfig, DQNTorchPolicy
    from ray_tpu_torch.env.spaces import Box, Discrete
    from ray_tpu_torch.execution.replay_buffer import DevicePrioritizedReplayBuffer

    cfg = DQNConfig().training(num_atoms=51, v_min=0.0, v_max=500.0, noisy=True, n_step=3,
                               model={"fcnet_hiddens": [256, 256]}).debugging(seed=2).to_dict()

    def make():
        policy = DQNTorchPolicy(Box(-np.inf, np.inf, (4,), np.float64), Discrete(2), cfg,
                                device=cuda)
        buf = DevicePrioritizedReplayBuffer(2048, 0.6, 3, device=cuda)
        gen = torch.Generator(device=cuda).manual_seed(1)
        buf.add_device_tree({
            "obs": torch.randn((2048, 4), device=cuda, generator=gen),
            "new_obs": torch.randn((2048, 4), device=cuda, generator=gen),
            "actions": torch.randint(0, 2, (2048,), device=cuda, generator=gen),
            "rewards": torch.rand((2048,), device=cuda, generator=gen) * 3,
            "dones": torch.rand((2048,), device=cuda, generator=gen) < 0.05,
            "n_steps": torch.randint(1, 4, (2048,), device=cuda, generator=gen).float(),
        })
        return policy, buf

    return make(), make()


def test_graphed_rainbow_replay_slots_equal_eager_updates(cuda):
    """4 Rainbow slots (descent, gather, the noisy C51 update with its
    three noise sets, the priorities at a fourth) as one captured graph,
    twice, against the eager updates on the same pre-drawn rows: bitwise
    in every parameter, Adam moment, the registered generator, the stats
    and the sum tree."""
    from ray_tpu_torch.execution.train_ops import superstep_train_replay

    (pa, ba), (pb, bb) = _rainbow_pair(cuda)
    for _ in range(2):
        idx, weights = ba.draw_prioritized_sets_device(4, 4, 64, 0.4)
        seq = []
        for i in range(4):
            tree = ba._gather_columns(idx[i])
            tree["weights"] = weights[i]
            seq.append(pa.learn_on_device_batch(tree, 64, perms=torch.arange(64, device=cuda)[None]))
            with torch.no_grad():
                td = torch.abs(pa._td_error(tree, pa.aux_state)[0]).cpu().numpy()
            ba.update_priorities(idx[i], td + 1e-6)
        pb.draw_permutations = lambda n: torch.arange(n, device=cuda)[None]
        pb._host_permutations = lambda n: torch.arange(n)[None]
        before = (segment_tree.find_prefixsum.launches, framestack.gather_rows.launches)
        info = superstep_train_replay(None, pb, bb, 4, 4, 64, prioritized=True, beta=0.4)
        launched = (segment_tree.find_prefixsum.launches - before[0],
                    framestack.gather_rows.launches - before[1])
        assert launched == (4, 4 * 6), launched
        assert {k: v for k, v in info.items()} == seq[-1]
    assert _same(pa.params, pb.params)
    assert pa.opt_state.count == pb.opt_state.count == 8 * pa._steps_per_update(64)
    assert _same(pa.opt_state.mu, pb.opt_state.mu) and _same(pa.opt_state.nu, pb.opt_state.nu)
    assert torch.equal(pa.action_generator.get_state(), pb.action_generator.get_state())
    assert torch.equal(ba._dtree.sum_value, bb._dtree.sum_value)


def test_c51_projection_on_the_card_is_the_cpus(cuda):
    """The projection's ordered sum: the card's result is the CPU's,
    bitwise (no atomic scatter)."""
    from ray_tpu_torch.algorithms.dqn.dqn_model import categorical_projection

    rng = np.random.default_rng(0)
    p = rng.random((512, 51)).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    args = (p, rng.uniform(-3, 3, 512).astype(np.float32),
            (0.99 ** rng.integers(1, 4, 512)).astype(np.float32),
            (rng.random(512) > 0.1).astype(np.float32))
    cpu = categorical_projection(*map(torch.as_tensor, args), 0.0, 500.0)
    card = categorical_projection(*(torch.as_tensor(a, device=cuda) for a in args), 0.0, 500.0)
    assert torch.equal(card.cpu(), cpu)


def _td3_pair(cuda, delay):
    from ray_tpu_torch.algorithms.ddpg.ddpg import DDPGTorchPolicy, TD3Config
    from ray_tpu_torch.env.spaces import Box
    from ray_tpu_torch.execution.replay_buffer import DeviceReplayBuffer

    cfg = TD3Config().training(actor_hiddens=[64, 64], critic_hiddens=[64, 64],
                               policy_delay=delay).debugging(seed=2).to_dict()

    def make():
        policy = DDPGTorchPolicy(Box(-8, 8, (3,)), Box(-2, 2, (1,)), cfg, device=cuda)
        buf = DeviceReplayBuffer(2048, 3, device=cuda)
        gen = torch.Generator(device=cuda).manual_seed(1)
        buf.add_device_tree({
            "obs": torch.randn((2048, 3), device=cuda, generator=gen),
            "new_obs": torch.randn((2048, 3), device=cuda, generator=gen),
            "actions": torch.rand((2048, 1), device=cuda, generator=gen) * 4 - 2,
            "rewards": torch.randn((2048,), device=cuda, generator=gen),
            "dones": torch.rand((2048,), device=cuda, generator=gen) < 0.01,
        })
        return policy, buf

    return make(), make()


@pytest.mark.parametrize("delay", [2, 3])
def test_graphed_td3_replay_slots_equal_eager_updates(cuda, delay):
    """TD3's update (the smoothing draw, the critic, the masked actor
    step, the blends) as one captured graph: windows of 4 slots, three
    times (both parities of the step inside a window), against eager
    updates on the same rows: bitwise in every parameter, Adam moment,
    target, the step, the Adam counts and the generator."""
    from ray_tpu_torch.execution.train_ops import superstep_train_replay

    (pa, ba), (pb, bb) = _td3_pair(cuda, delay)
    for _ in range(3):
        idx = torch.as_tensor(ba.draw_index_sets(4, 100), device=cuda)
        seq = [pa.learn_on_device_batch(ba._gather_columns(idx[i]), 100) for i in range(4)]
        info = superstep_train_replay(None, pb, bb, 4, 4, 100)
        assert info == seq[-1]
    assert _same(pa.params, pb.params)
    for g in pa.opt_states:
        assert pa.opt_states[g].count == pb.opt_states[g].count
        assert _same(pa.opt_states[g].mu, pb.opt_states[g].mu)
        assert _same(pa.opt_states[g].nu, pb.opt_states[g].nu)
    assert pa.opt_states["actor"].count == -(-12 // delay)
    for key in ("target_actor", "target_critic"):
        assert _same(pa.aux_state[key], pb.aux_state[key])
    assert int(pa.aux_state["step"]) == int(pb.aux_state["step"]) == 12
    assert torch.equal(pa.action_generator.get_state(), pb.action_generator.get_state())


def test_ddpg_acts_and_trains_on_the_card(cuda):
    """pendulum-ddpg.yaml's DDPG with OU noise on the card: actions in
    bounds, the OU state on the card, updates as graphed slots."""
    from ray_tpu_torch.algorithms.ddpg.ddpg import DDPGConfig

    algo = (DDPGConfig().environment("Pendulum-v1")
            .training(actor_hiddens=[64, 64], critic_hiddens=[64, 64], train_batch_size=64,
                      num_steps_sampled_before_learning_starts=64)
            .debugging(seed=0).resources(device=cuda).build())
    try:
        for _ in range(80):
            result = algo.train()
        policy = algo.get_policy()
        assert policy._expl_state[0].is_cuda and policy.num_updates == 17
        assert all(p.is_cuda for p in policy.params)
        assert np.isfinite(list(result["info"]["learner"]["default_policy"].values())).all()
        (runner,) = policy._superstep_runners.values()
        assert runner.graph is not None
    finally:
        algo.stop()


def test_two_policy_dqn_iteration_on_the_card(cuda):
    """Two DQN policies over two rings on the card, each ring filled by
    the row-scatter kernel and drawn by the gather, both targets synced."""
    from ray_tpu_torch.algorithms.dqn.dqn import DQNConfig
    from ray_tpu_torch.env.multi_agent_env import make_multi_agent
    from ray_tpu_torch.env.registry import register_env
    from ray_tpu_torch.env.spaces import Box, Discrete

    register_env("cuda_ma_dqn", lambda cfg: make_multi_agent("CartPole-v1")({"num_agents": 2}))
    space, act = Box(-np.inf, np.inf, (4,), np.float64), Discrete(2)
    algo = (DQNConfig().environment("cuda_ma_dqn")
            .rollouts(rollout_fragment_length=16)
            .training(train_batch_size=32, num_steps_sampled_before_learning_starts=32,
                      target_network_update_freq=64, model={"fcnet_hiddens": [64]})
            .multi_agent(policies={"p0": (None, space, act, {}), "p1": (None, space, act, {})},
                         policy_mapping_fn=lambda aid, *a, **kw: f"p{aid % 2}")
            .debugging(seed=0).resources(device=cuda).build())
    try:
        before = (framestack.scatter_rows.launches, framestack.gather_rows.launches)
        for _ in range(6):
            learner = algo.train()["info"]["learner"]
        assert set(learner) == {"p0", "p1"}
        assert framestack.scatter_rows.launches > before[0]
        assert framestack.gather_rows.launches > before[1]
        assert algo._counters["num_target_updates"] >= 1
        for buf in algo.local_replay_buffer.buffers.values():
            assert all(t.is_cuda for t in buf._store.values())
    finally:
        algo.stop()


def test_rainbow_served_exact_on_the_card(cuda):
    """Rainbow's noisy act step in exact-mode graphs: bitwise the
    sequential ``compute_actions`` stream (noise drawn per request
    before the exploration's draws)."""
    from ray_tpu_torch.algorithms.dqn.dqn import DQNConfig, DQNTorchPolicy
    from ray_tpu_torch.env.spaces import Box, Discrete
    from ray_tpu_torch.serve.policy_server import BatchedPolicyServer

    cfg = DQNConfig().training(num_atoms=51, v_min=0.0, v_max=500.0, noisy=True,
                               model={"fcnet_hiddens": [64, 64]}).debugging(seed=4).to_dict()
    served, sequential = (DQNTorchPolicy(Box(-1, 1, (16,), np.float32), Discrete(5), cfg,
                                         device=cuda) for _ in range(2))
    server = BatchedPolicyServer(served, max_batch_size=8, explore=True, start=False)
    assert server.fused
    server.warmup()
    obs = _serve_obs(12, 3)
    got = [server.forward_padded(obs[a:b])[0] for a, b in ((0, 5), (5, 6), (6, 12))]
    want = np.concatenate([sequential.compute_actions(obs[i:i + 1])[0] for i in range(12)])
    assert np.concatenate(got).tobytes() == want.tobytes()
    assert server.stats()["captures_after_warmup"] == 0


def _flat_unroll_batches(n, unrolls=6, t=8, seed=0):
    """Fixed CartPole-shaped unrolls as a rollout worker ships them."""
    from ray_tpu_torch.data.sample_batch import SampleBatch

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        rows = unrolls * t
        obs = rng.standard_normal((rows + 1, 4)).astype(np.float32)
        dones = rng.random(rows) < 0.1
        out.append(SampleBatch({
            SampleBatch.OBS: obs[:-1], SampleBatch.NEXT_OBS: obs[1:],
            SampleBatch.ACTIONS: rng.integers(0, 2, rows),
            SampleBatch.REWARDS: rng.standard_normal(rows).astype(np.float32),
            SampleBatch.TERMINATEDS: dones, SampleBatch.TRUNCATEDS: np.zeros(rows, bool),
            SampleBatch.ACTION_LOGP: np.full(rows, -0.69, np.float32),
        }))
    return out


@pytest.mark.parametrize("kind", ["impala", "appo"])
def test_fused_learner_superstep_graph_equals_eager_learns(cuda, kind):
    """The learner thread's fused IMPALA/APPO slot on the card: four
    queued batches (six unrolls each, trimmed to the train batch's four)
    copied by the feeder on its own stream, stacked on the thread's
    stream and learned as two graphed supersteps of K = 2, bitwise the
    eager learns of the same trimmed batches; one capture, three
    replays."""
    from ray_tpu_torch.algorithms.appo.appo import APPOTorchPolicy
    from ray_tpu_torch.algorithms.impala.impala import ImpalaTorchPolicy
    from ray_tpu_torch.env.spaces import Box, Discrete
    from ray_tpu_torch.execution.learner_thread import LearnerThread

    cls = {"impala": ImpalaTorchPolicy, "appo": APPOTorchPolicy}[kind]
    cfg = {"rollout_fragment_length": 8, "train_batch_size": 32, "_fixed_unrolls": True,
           "superstep": 2, "model": {"fcnet_hiddens": [256, 256]}, "seed": 3, "lr": 5e-4}
    space, act = Box(-10.0, 10.0, (4,), np.float32), Discrete(2)
    graphed, eager = (cls(space, act, dict(cfg), device=cuda) for _ in range(2))
    batches = _flat_unroll_batches(4)
    lt = LearnerThread(graphed)
    assert lt._superstep_k == 2
    for b in batches:
        assert lt.add_batch(b)
    lt.start()
    deadline = time.time() + 120
    while lt.num_steps < 4 and time.time() < deadline:
        time.sleep(0.02)
    lt.stop()
    assert lt.error is None and lt.num_supersteps == 2
    got = [lt.outqueue.get_nowait()[1] for _ in range(4)]
    want = []
    for b in batches:
        tree, _ = eager.prepare_batch(b)
        want.append(eager.learn_on_device_batch(
            {k: torch.as_tensor(v[:4]).to(cuda) for k, v in tree.items()}, 4))
    assert got == want
    assert _same(graphed.params, eager.params)
    assert _same(graphed.opt_state.mu, eager.opt_state.mu)
    assert _same(graphed.opt_state.nu, eager.opt_state.nu)
    (runner,) = graphed._superstep_runners.values()
    assert runner.graph is not None and runner.replays == 3


def test_apex_shards_on_the_card(cuda):
    """Ape-X's two shards on the card (K = 2 graphed prioritized updates
    a shard and learn pass): every ring and tree on the card, one prefix
    descent and a row gather per column an update, a row scatter per
    column an insert (and the trees' leaf writes), the target synced."""
    from ray_tpu_torch.algorithms.apex_dqn.apex_dqn import ApexDQNConfig

    algo = (ApexDQNConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, rollout_fragment_length=16)
            .training(train_batch_size=32, num_steps_sampled_before_learning_starts=64,
                      target_network_update_freq=128, replay_buffer_config={"capacity": 2048},
                      model={"fcnet_hiddens": [64]})
            .debugging(seed=0).resources(device=cuda).build())
    algo.config["superstep"] = 2
    try:
        kernels = (framestack.gather_rows, framestack.scatter_rows, segment_tree.find_prefixsum)
        before = [k.launches for k in kernels]
        for _ in range(12):
            algo.train()
        gathers, scatters, descents = (k.launches - b for k, b in zip(kernels, before))
        updates = algo._counters["num_env_steps_trained"] // 32
        cols = len(algo.replay_shards[0]._store)
        assert updates > 0 and updates % 2 == 0
        assert descents == updates and gathers == cols * updates
        assert scatters > cols * 12
        assert algo._counters["num_target_updates"] >= 1
        for shard in algo.replay_shards:
            assert all(t.is_cuda for t in shard._store.values())
            assert shard._dtree.sum_value.is_cuda and len(shard) == 96
    finally:
        algo.stop()
