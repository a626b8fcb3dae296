"""Frame-pool rebuild of stacked observations (deduplicated obs transfer).

Counterpart of ``ray_tpu/ops/framestack.py``. Atari-style train batches
are sliding-window framestacks: row n stacks frames [f_n .. f_n+k-1], so
the host ships the unique frame stream (``obs_frames``) plus one
first-frame index per row (``obs_frame_idx``), and the learner rebuilds
the (N, H, W, k) stacks on the device with one row gather.

:func:`gather_rows` launches the hand-written CUDA row-gather kernel
(``csrc/row_gather.cu``) for CUDA tensors and runs its plain PyTorch
version (:func:`gather_rows_plain`) for CPU tensors. :func:`scatter_rows`
does the same with the row-scatter kernel (``csrc/row_scatter.cu``) and
:func:`scatter_rows_plain`: the replay ring's insert. There is no other
choice between a kernel and its plain version: a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ray_tpu_torch.ops import _kernels

# Batch columns of the deduplicated format.
FRAMES = "obs_frames"
FRAME_IDX = "obs_frame_idx"


def gather_rows_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[idx]`` over the leading axis, in plain PyTorch. ``idx`` of
    any integer shape; raises IndexError on an out-of-range index."""
    return src[idx.long()]


def _row_bytes(src: torch.Tensor, what: str) -> int:
    """Bytes per leading-axis row of a contiguous (M, ...) tensor."""
    if not src.is_contiguous():
        raise ValueError(f"{what} needs a contiguous tensor")
    return int(np.prod(src.shape[1:])) * src.element_size()


def _check_cuda_index(src: torch.Tensor, idx: torch.Tensor, what: str) -> None:
    if src.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {src.device}")
    if idx.device != src.device:
        raise ValueError(f"{what}: idx on {idx.device}, src on {src.device}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{what}: integer idx required, got {idx.dtype}")


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[idx]`` over the leading axis. ``src``: (M, ...) contiguous,
    of any dtype and row width; ``idx``: any int shape. CUDA tensors go
    through the row-gather kernel (bitwise equal to the plain version,
    pure data movement; rows of whole 4-byte words take its word path,
    other rows its byte path); CPU tensors through
    :func:`gather_rows_plain`."""
    if src.device.type == "cpu":
        return gather_rows_plain(src, idx)
    _check_cuda_index(src, idx, "gather_rows")
    row_bytes = _row_bytes(src, "gather_rows")
    flat_idx = idx.reshape(-1).to(torch.int64).contiguous()
    out = torch.empty(
        tuple(idx.shape) + tuple(src.shape[1:]), dtype=src.dtype,
        device=src.device,
    )
    lib = _kernels.library("row_gather")
    with torch.cuda.device(src.device):
        rc = lib.row_gather_launch(
            src.data_ptr(), flat_idx.data_ptr(), out.data_ptr(),
            flat_idx.shape[0], src.shape[0], row_bytes,
            torch.cuda.current_stream().cuda_stream,
        )
    _kernels.check(rc, lib, "row_gather_error_string", "row_gather")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def scatter_rows_plain(
    ring: torch.Tensor, pos: torch.Tensor, vals: torch.Tensor
) -> torch.Tensor:
    """``ring[pos[i]] = vals[i]`` over the leading axis, in place, in
    plain PyTorch; returns ``ring``. Where positions repeat, the last
    write wins: ``ring[pos] = vals`` leaves the order of repeated
    indices undefined, so each position's last occurrence is found
    first (a max over row numbers, which any order computes alike) and
    only those rows are written. Raises IndexError on a position
    outside ``[0, M)``."""
    pos = pos.reshape(-1).long()
    if pos.numel() == 0:
        return ring
    m = ring.shape[0]
    if int(pos.min()) < 0 or int(pos.max()) >= m:
        raise IndexError(f"scatter_rows: a position is outside [0, {m})")
    rows = torch.arange(pos.shape[0], device=pos.device)
    owner = torch.full((m,), -1, dtype=torch.int64, device=pos.device)
    owner.scatter_reduce_(0, pos, rows, reduce="amax")
    last = owner[pos] == rows
    ring[pos[last]] = vals.reshape((pos.shape[0],) + tuple(ring.shape[1:]))[last]
    return ring


def scatter_rows(
    ring: torch.Tensor, pos: torch.Tensor, vals: torch.Tensor
) -> torch.Tensor:
    """``ring[pos[i]] = vals[i]`` over the leading axis, **in place**
    (the reference aliased the ring into its output; the port writes
    the ring tensor itself and returns it). ``ring``: (M, ...)
    contiguous; ``pos``: (R,) int; ``vals``: (R, ...) of ring's dtype
    and row shape. Rows no position names keep their contents; where
    positions repeat, the last write wins. CUDA tensors go through the
    row-scatter kernel (bitwise equal to the plain version): one launch
    that reads int32 or int64 positions as given, up to the source's
    one-launch limit of rows (the replay insert, the priority leaf
    write), and three launches with int64 positions and an owner
    scratch above it; CPU tensors through :func:`scatter_rows_plain`."""
    if vals.dtype != ring.dtype:
        raise TypeError(
            f"scatter_rows: vals {vals.dtype} into a {ring.dtype} ring"
        )
    r = int(pos.numel())
    if tuple(vals.shape) != (r,) + tuple(ring.shape[1:]):
        raise ValueError(
            f"scatter_rows: vals {tuple(vals.shape)} for {r} rows of "
            f"{tuple(ring.shape[1:])}"
        )
    if ring.device.type == "cpu":
        return scatter_rows_plain(ring, pos, vals)
    _check_cuda_index(ring, pos, "scatter_rows")
    if vals.device != ring.device:
        raise ValueError(f"scatter_rows: vals on {vals.device}, ring on {ring.device}")
    row_bytes = _row_bytes(ring, "scatter_rows")
    if r >= 2**31:
        raise ValueError(f"scatter_rows: {r} rows (at most 2^31 - 1)")
    vals = vals.contiguous()
    lib = _kernels.library("row_scatter")
    flat_pos = pos.reshape(-1).contiguous()
    owner = None
    if r > lib.row_scatter_one_launch_rows():
        # the three-launch path (set_state's whole ring): int64
        # positions and an owner scratch of one int32 per ring row
        flat_pos = flat_pos.to(torch.int64)
        owner = torch.empty(ring.shape[0], dtype=torch.int32, device=ring.device)
    with torch.cuda.device(ring.device):
        rc = lib.row_scatter_launch(
            vals.data_ptr(), flat_pos.data_ptr(), flat_pos.element_size(),
            ring.data_ptr(), None if owner is None else owner.data_ptr(),
            r, ring.shape[0], row_bytes,
            torch.cuda.current_stream().cuda_stream,
        )
    _kernels.check(rc, lib, "row_scatter_error_string", "row_scatter")
    scatter_rows.launches += 1
    return ring


scatter_rows.launches = 0


def build_stacks(frames: torch.Tensor, idx: torch.Tensor, k: int) -> torch.Tensor:
    """(M, H, W, 1) frame pool + (N,) first-frame indices → (N, H, W, k)
    stacked observations, one row gather.

    uint8 pools with ``H*W % 4 == 0`` gather through a 4-byte-word view
    (the TPU path's uint32-lane bitcast), so the kernel moves words, not
    bytes. The result is a permuted view of the gathered (N, k, H, W)
    block: the move of the stack axis to the end costs no copy here."""
    if frames.shape[-1] != 1:
        raise ValueError(
            "frame pools are single-channel (stack depth k comes from the "
            f"index expansion); got channel dim {frames.shape[-1]}"
        )
    m = frames.shape[0]
    hw = tuple(frames.shape[1:-1])
    inner = int(np.prod(hw))
    rows = idx.reshape(-1, 1).long() + torch.arange(
        k, device=idx.device, dtype=torch.int64
    )
    if frames.dtype == torch.uint8 and inner % 4 == 0:
        packed = frames.reshape(m, inner).view(torch.int32)
        gathered = gather_rows(packed, rows)  # (N, k, inner // 4)
        u8 = gathered.view(torch.uint8).reshape((rows.shape[0], k) + hw)
        return u8.movedim(1, -1)
    gathered = gather_rows(frames.contiguous(), rows)  # (N, k, H, W, 1)
    return gathered[..., 0].movedim(1, -1)


def frame_stream_columns(
    frames: np.ndarray, num_rows: int, k: int
) -> Dict[str, np.ndarray]:
    """Columns for a batch whose row n stacks frames [n .. n+k-1] of a
    contiguous stream. ``frames``: (num_rows + k - 1, H, W, 1)."""
    if frames.shape[0] < num_rows + k - 1 or frames.shape[-1] != 1:
        raise ValueError(
            f"frame stream {frames.shape} cannot cover {num_rows} rows "
            f"of {k} single-channel frames"
        )
    return {
        FRAMES: np.asarray(frames),
        FRAME_IDX: np.arange(num_rows, dtype=np.int32),
    }


def materialize_stacks_np(
    pool: np.ndarray, idx: np.ndarray, k: int
) -> np.ndarray:
    """Host-side :func:`build_stacks`: (M, H, W, 1) pool + (N,) first-
    frame indices → (N, H, W, k) stacked observations."""
    gathered = pool[idx[:, None] + np.arange(k)[None, :]]
    return np.moveaxis(gathered[..., 0], 1, -1)
