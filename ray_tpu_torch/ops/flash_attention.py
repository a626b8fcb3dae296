"""Fused attention: ``softmax(q kᵀ / √D + band) v`` without the (T, S) matrix.

Counterpart of ``ray_tpu/ops/flash_attention.py``. On CUDA tensors the
forward is one launch of the hand-written kernel in
``csrc/flash_fwd.cu`` (online softmax over key tiles staged in shared
memory, f32 accumulation, output in q's type); on CPU tensors it is
:func:`reference_attention`, the plain version with the (T, S) scores
materialised. A CUDA tensor launches the kernel or raises.

Masking is the reference's banded-causal form: query i sees key j iff
``j <= i + causal_offset`` (``None``: no mask). A query row that sees no
key at all is defined as zero output, in both versions.

The gradient recomputes the forward through :func:`reference_attention`
under autograd, as the reference's ``custom_vjp`` does: the kernel is
forward-only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ray_tpu_torch.ops import _kernels

NEG_INF = -1e30  # the reference's mask fill
MAX_HEAD_DIM = 128
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reference_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal_offset: Optional[int]
) -> torch.Tensor:
    """Plain attention on (N, T, D) queries and (N, S, D) keys/values,
    in float32, returned in q's type: the scores are scaled after the
    product, masked with ``-1e30``, and rows with no visible key are 0."""
    d = q.shape[-1]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))
    scores = torch.einsum("ntd,nsd->nts", q.float(), k.float()) * scale
    if causal_offset is not None:
        t, s = scores.shape[-2:]
        i = torch.arange(t, device=q.device)[:, None]
        j = torch.arange(s, device=q.device)[None, :]
        valid = j <= i + causal_offset
        scores = torch.where(valid, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        probs = torch.where(valid.any(-1, keepdim=True), probs, 0.0)
    else:
        probs = torch.softmax(scores, dim=-1)
    return torch.einsum("nts,nsd->ntd", probs, v.float()).to(q.dtype)


def _check_kernel_inputs(q, k, v) -> None:
    """Raise on what the kernel does not take."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    for name, x in (("k", k), ("v", v)):
        if x.device != dev:
            raise ValueError(f"flash_attention: {name} on {x.device}, q on {dev}")
        if x.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {x.dtype}, q is {q.dtype}")
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(
            f"flash_attention: the kernel takes float32 or bfloat16, got {q.dtype}"
        )
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(
            "flash_attention: q (B, H, T, D) and k, v (B, H, S, D); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} disagree"
        )
    if not 1 <= q.shape[3] <= MAX_HEAD_DIM:
        raise ValueError(
            f"flash_attention: head dim {q.shape[3]} outside [1, {MAX_HEAD_DIM}]"
        )
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")


def _launch(q, k, v, causal_offset: Optional[int]) -> torch.Tensor:
    """One kernel launch on validated contiguous (N, T, D) / (N, S, D)."""
    n, t, d = q.shape
    out = torch.empty_like(q)
    lib = _kernels.library("flash_fwd")
    with torch.cuda.device(q.device):
        rc = lib.flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            n, t, k.shape[1], d, _KERNEL_DTYPES[q.dtype],
            int(causal_offset is not None),
            0 if causal_offset is None else int(causal_offset),
            torch.cuda.current_stream().cuda_stream,
        )
    _kernels.check(rc, lib, "flash_fwd_error_string", "flash_fwd")
    flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """Kernel (CUDA) or plain (CPU) forward; the backward differentiates
    :func:`reference_attention` on the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal_offset):
        ctx.causal_offset = causal_offset
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return reference_attention(q, k, v, causal_offset)
        return _launch(q, k, v, causal_offset)

    @staticmethod
    def backward(ctx, grad):
        inputs = [x.detach().requires_grad_() for x in ctx.saved_tensors]
        with torch.enable_grad():
            out = reference_attention(*inputs, ctx.causal_offset)
            grads = torch.autograd.grad(out, inputs, grad)
        return (*grads, None)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal_offset: Optional[int] = None,
) -> torch.Tensor:
    """Fused multi-head attention. q: (B, H, T, D); k, v: (B, H, S, D)
    → (B, H, T, D) in q's type. ``causal_offset=M`` hides key j from
    query i unless ``j <= i + M``; ``None`` is full attention."""
    if q.device.type != "cpu":
        _check_kernel_inputs(q, k, v)
    b, h, t, d = q.shape
    s = k.shape[2]
    offset = None if causal_offset is None else int(causal_offset)
    out = _FlashAttention.apply(
        q.reshape(b * h, t, d), k.reshape(b * h, s, d), v.reshape(b * h, s, d), offset
    )
    return out.reshape(b, h, t, d)


flash_attention.launches = 0
