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

The host side of the format is numpy, bitwise the reference's: a worker
compresses a fragment's stacks into a pool (:func:`compress_fragment_obs`,
:func:`compress_replay_obs`), a learner pools a stacked batch
(:func:`decompose_segmented_obs`), and :func:`materialize_fragment`
rebuilds the stacks on the host.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.ops import _kernels

# Batch columns of the deduplicated format.
FRAMES = "obs_frames"
FRAME_IDX = "obs_frame_idx"
# the stacked columns a pool stands for (the names of ``data/sample_batch.py``)
OBS = "obs"
NEXT_OBS = "new_obs"


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


def decompose_stacked_obs(obs: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Recover (frame_stream, idx) from a stacked (N, H, W, k) obs
    column if its rows really are a sliding window (consecutive rows
    share k-1 frames); None when they are not."""
    n, h, w, k = obs.shape
    if k <= 1 or n < 2:
        return None
    if not np.array_equal(obs[1:, :, :, : k - 1], obs[:-1, :, :, 1:]):
        return None
    stream = np.concatenate(
        [
            np.moveaxis(obs[0], -1, 0)[..., None],  # (k, H, W, 1)
            obs[1:, :, :, -1][..., None],  # (N-1, H, W, 1)
        ],
        axis=0,
    )
    return stream, np.arange(n, dtype=np.int32)


def decompose_segmented_obs(
    obs: np.ndarray, new_segment: np.ndarray
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """:func:`decompose_stacked_obs` for a batch of several sliding
    windows back to back (fragments of different envs or episodes).

    ``new_segment``: (N,) bool, True where row i does not slide from row
    i-1 (row 0 always starts one). Rows inside a segment are verified to
    slide; any mismatch returns None, so the caller ships the stacks
    unchanged. Returns ``(stream, idx)``; each segment contributes
    k + (len - 1) frames to the stream."""
    n, h, w, k = obs.shape
    if k <= 1 or n == 0:
        return None
    new_segment = np.asarray(new_segment, bool).copy()
    new_segment[0] = True
    slide_rows = np.flatnonzero(~new_segment)
    # verify in row chunks: indexing the whole batch at once would make
    # two more copies of a pixel batch on the host
    for c in range(0, slide_rows.size, 64):
        rows = slide_rows[c : c + 64]
        if not np.array_equal(obs[rows, :, :, : k - 1], obs[rows - 1, :, :, 1:]):
            return None
    starts = np.flatnonzero(new_segment)
    bounds = np.append(starts, n)
    idx = np.empty(n, np.int32)
    pieces = []
    off = 0
    for s, e in zip(bounds[:-1], bounds[1:]):
        seg_len = int(e - s)
        # a segment's first row gives its k frames, later rows 1 new one
        pieces.append(np.moveaxis(obs[s], -1, 0)[..., None])
        if seg_len > 1:
            pieces.append(obs[s + 1 : e, :, :, -1][..., None])
        idx[s:e] = off + np.arange(seg_len, dtype=np.int32)
        off += seg_len + k - 1
    return np.concatenate(pieces, axis=0), idx


def compress_fragment_obs(
    obs: np.ndarray, next_obs: np.ndarray, dones: np.ndarray
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """A rollout fragment's stacked obs columns as a frame pool, on the
    worker, before the fragment ships.

    The pool covers NEXT_OBS by sliding: ``next_obs[t]`` is the stack at
    ``idx[t] + 1``, so only the fragment's last bootstrap frame is
    appended (a pseudo-row). ``dones`` marks episode resets inside the
    fragment: the row after a done starts a new window. Returns ``(pool,
    idx)`` with T indices, or None when the rows are not sliding windows
    (the caller ships the stacks)."""
    T = obs.shape[0]
    if T == 0:
        return None
    ext = np.concatenate([obs, next_obs[-1:]], axis=0)
    seg = np.zeros(T + 1, bool)
    seg[0] = True
    if T > 1:
        seg[1:T] = np.asarray(dones[: T - 1], bool)
    dec = decompose_segmented_obs(ext, seg)
    if dec is None:
        return None
    pool, idx = dec
    return pool, idx[:T]


def compress_replay_obs(
    obs: np.ndarray, next_obs: np.ndarray, dones: np.ndarray
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The replay family's :func:`compress_fragment_obs`: the pool covers
    OBS and NEXT_OBS exactly, each episode's terminal stack included
    (each episode segment adds its final ``next_obs`` as a pseudo-row),
    so ``obs[t] == stack(idx[t])`` and ``next_obs[t] == stack(idx[t] +
    1)`` for every t. None when the rows are not sliding windows."""
    T = obs.shape[0]
    if T == 0:
        return None
    dones = np.asarray(dones[:T], bool)
    # every done row ends a segment; the last row always does
    seg_end = dones.copy()
    seg_end[T - 1] = True
    end_rows = np.flatnonzero(seg_end)
    # each segment's terminal next_obs goes right after its end row
    # (np.insert's indices are positions before the insert)
    ext = np.insert(obs, end_rows + 1, next_obs[end_rows], axis=0)
    n_seg = len(end_rows)
    starts = np.concatenate(([0], end_rows[:-1] + 1))
    new_segment = np.zeros(T + n_seg, bool)
    new_segment[starts + np.arange(n_seg)] = True
    dec = decompose_segmented_obs(ext, new_segment)
    if dec is None:
        return None
    pool, ext_idx = dec
    # obs row t sits at ext position t + (pseudo-rows before its segment)
    seg_id = np.zeros(T, np.int64)
    seg_id[1:] = np.cumsum(dones[:-1])
    return pool, ext_idx[np.arange(T) + seg_id]


def materialize_stacks_np(
    pool: np.ndarray, idx: np.ndarray, k: int
) -> np.ndarray:
    """Host-side :func:`build_stacks`: (M, H, W, 1) pool + (N,) first-
    frame indices → (N, H, W, k) stacked observations."""
    gathered = pool[idx[:, None] + np.arange(k)[None, :]]
    return np.moveaxis(gathered[..., 0], 1, -1)


def materialize_fragment(batch_cols: Dict, k: int) -> Dict:
    """Undo :func:`compress_fragment_obs` on a batch's columns: OBS
    exactly, NEXT_OBS as the ``idx + 1`` stacks. Those are exact within
    segments and at the final bootstrap row; at an episode-reset row
    inside the fragment the terminal next_obs was not pooled, so that
    row gets the following row's reset obs (the on-policy family drops
    the column, and nothing else reads it there)."""
    cols = dict(batch_cols)
    pool = np.asarray(cols.pop(FRAMES))
    idx = np.asarray(cols.pop(FRAME_IDX), np.int64)
    cols[OBS] = materialize_stacks_np(pool, idx, k)
    next_idx = np.minimum(idx + 1, len(pool) - k)
    cols[NEXT_OBS] = materialize_stacks_np(pool, next_idx, k)
    return cols
