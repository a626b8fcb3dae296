"""Frame-pool rebuild of stacked observations (deduplicated obs transfer).

Counterpart of ``ray_tpu/ops/framestack.py``. Atari-style train batches
are sliding-window framestacks: row n stacks frames [f_n .. f_n+k-1], so
the host ships the unique frame stream (``obs_frames``) plus one
first-frame index per row (``obs_frame_idx``), and the learner rebuilds
the (N, H, W, k) stacks on the device with one row gather.

:func:`gather_rows` launches the hand-written CUDA row-gather kernel
(``csrc/row_gather.cu``) for CUDA tensors and runs its plain PyTorch
version (:func:`gather_rows_plain`) for CPU tensors. There is no other
choice between them: a CUDA tensor launches the kernel or raises.
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


def _as_words(src: torch.Tensor) -> torch.Tensor:
    """(M, ...) contiguous store → (M, D) view of 4-byte words."""
    if not src.is_contiguous():
        raise ValueError("gather_rows needs a contiguous source")
    row_bytes = int(np.prod(src.shape[1:])) * src.element_size()
    if row_bytes % 4 == 0:
        return src.reshape(src.shape[0], -1).view(torch.int32)
    raise TypeError(
        f"the row-gather kernel copies 4-byte words; rows of "
        f"{src.dtype} x {tuple(src.shape[1:])} are {row_bytes} bytes"
    )


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src[idx]`` over the leading axis. ``src``: (M, ...) of any
    dtype whose rows are whole 4-byte words on CUDA; ``idx``: any int
    shape. CUDA tensors go through the row-gather kernel (bitwise equal
    to the plain version, pure data movement); CPU tensors through
    :func:`gather_rows_plain`."""
    if src.device.type == "cpu":
        return gather_rows_plain(src, idx)
    if src.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {src.device}")
    if idx.device != src.device:
        raise ValueError(
            f"gather_rows: idx on {idx.device}, src on {src.device}"
        )
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"gather_rows: integer idx required, got {idx.dtype}")
    words = _as_words(src)
    flat_idx = idx.reshape(-1).to(torch.int64).contiguous()
    out = torch.empty(
        (flat_idx.shape[0], words.shape[1]), dtype=words.dtype,
        device=src.device,
    )
    lib = _kernels.library("row_gather")
    with torch.cuda.device(src.device):
        rc = lib.row_gather_launch(
            words.data_ptr(), flat_idx.data_ptr(), out.data_ptr(),
            flat_idx.shape[0], words.shape[0], words.shape[1],
            torch.cuda.current_stream().cuda_stream,
        )
    _kernels.check(rc, lib, "row_gather_error_string", "row_gather")
    gather_rows.launches += 1
    return out.view(src.dtype).reshape(tuple(idx.shape) + tuple(src.shape[1:]))


gather_rows.launches = 0


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
