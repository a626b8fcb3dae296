"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: the kernels have no CPU mode, so these tests skip
without a CUDA device. Run them on the card with

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Contracts: bitwise for both kernels (the row gather is data movement;
the GAE kernel rounds every operation in the plain version's order).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import framestack, gae

pytestmark = pytest.mark.cuda


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
    with pytest.raises(TypeError, match="4-byte words"):
        framestack.gather_rows(
            torch.zeros((8, 3), dtype=torch.uint8, device=cuda),
            torch.zeros(2, dtype=torch.int64, device=cuda),
        )
    with pytest.raises(ValueError, match="idx on"):
        framestack.gather_rows(src, torch.zeros(2, dtype=torch.int64))


@pytest.mark.parametrize("n,t", [(16, 128), (1, 1), (3, 1), (5, 7), (33, 300), (257, 64)])
def test_gae_kernel_bitwise(cuda, n, t):
    gen = torch.Generator(device=cuda).manual_seed(n * t)
    r, v, nv = (torch.randn(n, t, device=cuda, generator=gen) for _ in range(3))
    term = torch.rand(n, t, device=cuda, generator=gen) < 0.05
    done = term | (torch.rand(n, t, device=cuda, generator=gen) < 0.05)
    before = gae.compute_gae_fragment.launches
    adv, vt = gae.compute_gae_fragment(r, v, nv, term, done, 0.99, 0.95)
    assert gae.compute_gae_fragment.launches == before + 1
    p_adv, p_vt = gae.compute_gae_fragment_plain(r, v, nv, term, done, 0.99, 0.95)
    assert torch.equal(adv, p_adv) and torch.equal(vt, p_vt)
