"""Fused attention: ``softmax(q kᵀ / √D + band) v`` without the (T, S) matrix.

Counterpart of ``ray_tpu/ops/flash_attention.py``. On CUDA tensors the
forward is one launch of the hand-written kernel in
``csrc/flash_fwd.cu`` (heads of at most 32 rows and 64 wide: a query row
per thread, ``csrc/flash_rows.cuh``; longer or wider heads: a warp per
row with an online softmax over key tiles, ``csrc/flash_stream.cuh``;
f32 accumulation, output in q's type); on CPU tensors it is
:func:`reference_attention`, the plain version with the (T, S) scores
materialised. A CUDA tensor launches the kernel or raises.

The kernel reads q, k and v where they are: any (B, H, T, D) layout
whose head dim is contiguous, such as the torso's projections, (B, H,
T, D) views over (B, T, H, D) memory. The output takes q's layout
(``torch.empty_like``).

Masking is the reference's banded-causal form: query i sees key j iff
``j <= i + causal_offset`` (``None``: no mask). A query row that sees no
key at all is defined as zero output, in both versions.

The gradient recomputes the forward through :func:`reference_attention`
under autograd, as the reference's ``custom_vjp`` does: the kernel is
forward-only. Without a gradient to take (``no_grad``, as the act path
and the target forwards run, or inputs that need none) the kernel is
launched directly, outside autograd.

:func:`flash_block_attention_stats` is ring attention's block: the same
stream with a band offset known only at run time, returning the
unnormalised accumulator with the row max and row sum so that the ring
can merge blocks exactly. On CUDA tensors it is one launch of
``csrc/flash_block.cu``; on CPU tensors :func:`reference_block_attention_stats`.
It is forward-only, as the reference's (``ray_tpu/ops/flash_attention.py:151``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.ops import _kernels
from ray_tpu_torch.telemetry import device as device_ledger

NEG_INF = -1e30  # the reference's mask fill
MAX_HEAD_DIM = 128
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reference_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal_offset: Optional[int]
) -> torch.Tensor:
    """Plain attention on (..., T, D) queries and (..., S, D) keys/values,
    in float32, returned in q's type: the scores are scaled after the
    product, masked with ``-1e30``, and rows with no visible key are 0."""
    d = q.shape[-1]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))
    scores = torch.einsum("...td,...sd->...ts", q.float(), k.float()) * scale
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
    return torch.einsum("...ts,...sd->...td", probs, v.float()).to(q.dtype)


def _check_kernel_inputs(
    q, k, v, what: str = "flash_attention", lead: str = "B, H", ndim: int = 4,
    contiguous: bool = False,
) -> None:
    """Raise on what the kernel does not take: q (``lead``, T, D) and
    k, v (``lead``, S, D), ``ndim`` dims each, of one CUDA device and
    type, with a contiguous head dim (wholly contiguous if
    ``contiguous``)."""
    dev, dtype = q.device, q.dtype
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    for name, x in (("k", k), ("v", v)):
        if x.device != dev:
            raise ValueError(f"{what}: {name} on {x.device}, q on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{what}: {name} is {x.dtype}, q is {dtype}")
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{what}: the kernel takes float32 or bfloat16, got {dtype}")
    qs, ks = q.shape, k.shape
    if len(qs) != ndim or len(ks) != ndim or ks != v.shape:
        raise ValueError(
            f"{what}: q ({lead}, T, D) and k, v ({lead}, S, D); got "
            f"{tuple(qs)}, {tuple(ks)}, {tuple(v.shape)}"
        )
    d = qs[-1]
    if ks[:-2] != qs[:-2] or ks[-1] != d:
        raise ValueError(f"{what}: q {tuple(qs)} and k {tuple(ks)} disagree")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {d} outside [1, {MAX_HEAD_DIM}]")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if contiguous and not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if d > 1 and x.stride(-1) != 1:
            raise ValueError(
                f"{what}: {name} must be contiguous in its head dim "
                f"(stride {x.stride(-1)})"
            )


def _launch(q, k, v, causal_offset: Optional[int]) -> torch.Tensor:
    """One kernel launch on validated (B, H, T, D) / (B, H, S, D), read
    through their strides; the output takes q's layout."""
    b, h, t, d = q.shape
    out = torch.empty_like(q)
    qs, ks, vs, os_ = q.stride(), k.stride(), v.stride(), out.stride()
    args = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, t, k.shape[2], d,
        qs[0], qs[1], qs[2], ks[0], ks[1], ks[2],
        vs[0], vs[1], vs[2], os_[0], os_[1], os_[2],
        _KERNEL_DTYPES[q.dtype], causal_offset is not None,
        0 if causal_offset is None else causal_offset,
    )
    lib = _kernels.library("flash_fwd")
    rc = _kernels.launch(lib.flash_fwd_launch, q.device, *args)
    if rc:
        _kernels.check(rc, lib, "flash_fwd_error_string", "flash_fwd")
    flash_attention.launches += 1
    # q, k, v read once, o written once; two multiply-adds per visible
    # (query, key) pair and head dim (device ledger)
    if device_ledger.counting():
        device_ledger.add_kernel_cost(
            4 * b * h * device_ledger.band_pairs(t, k.shape[2], causal_offset) * d,
            q.element_size() * b * h * 2 * (t + k.shape[2]) * d,
        )
    return out


class _FlashAttention(torch.autograd.Function):
    """Kernel forward on CUDA tensors; the backward differentiates
    :func:`reference_attention` on the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal_offset):
        ctx.causal_offset = causal_offset
        ctx.save_for_backward(q, k, v)
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
    """Fused multi-head attention. q: (B, H, T, D); k, v: (B, H, S, D),
    in any layout with a contiguous head dim → (B, H, T, D) in q's type
    and layout. ``causal_offset=M`` hides key j from query i unless
    ``j <= i + M``; ``None`` is full attention."""
    offset = None if causal_offset is None else int(causal_offset)
    if q.device.type == "cpu":
        return reference_attention(q, k, v, offset)
    _check_kernel_inputs(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, offset)
    return _launch(q, k, v, offset)


flash_attention.launches = 0


def reference_block_attention_stats(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, offset: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain block statistics on (N, T, D) queries and (N, S, D) keys and
    values: ``m`` is the row max of the scaled scores over the visible
    keys (j <= i + offset), ``l`` the sum of ``exp(s - m)`` over them and
    ``acc`` the unnormalised ``Σ exp(s - m) v``. Masked keys add no mass,
    so a row that sees no key is exactly (acc, m, l) = (0, -1e30, 0), as
    the TPU kernel leaves it. Computed and returned in float32, or in
    float64 for float64 inputs (the card's check of the kernel measures
    its float32 error against float64 copies of its inputs)."""
    work = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = float(np.float32(1.0) / np.sqrt(np.float32(q.shape[-1])))
    scores = torch.einsum("ntd,nsd->nts", q.to(work), k.to(work)) * scale
    t, s = scores.shape[-2:]
    i = torch.arange(t, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    valid = j <= i + int(offset)
    m = torch.where(valid, scores, NEG_INF).amax(-1)
    p = torch.where(valid, torch.exp(scores - m[..., None]), 0.0)
    acc = torch.einsum("nts,nsd->ntd", p, v.to(work))
    return acc, m, p.sum(-1)


def flash_block_attention_stats(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, offset: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One attention block with its running statistics. q: (N, T, D);
    k, v: (N, S, D); ``offset`` a Python int: key j is visible to query
    i iff ``j <= i + offset`` (``S`` or more: no mask). Returns float32
    (acc (N, T, D) unnormalised, m (N, T), l (N, T)). CUDA tensors go
    through the kernel, CPU tensors through
    :func:`reference_block_attention_stats`."""
    offset = int(offset)
    if q.device.type == "cpu":
        return reference_block_attention_stats(q, k, v, offset)
    _check_kernel_inputs(q, k, v, "flash_block_attention_stats", lead="N", ndim=3,
                         contiguous=True)
    n, t, d = q.shape
    acc = torch.empty((n, t, d), dtype=torch.float32, device=q.device)
    m = torch.empty((n, t), dtype=torch.float32, device=q.device)
    l = torch.empty((n, t), dtype=torch.float32, device=q.device)
    lib = _kernels.library("flash_block")
    with torch.cuda.device(q.device):
        rc = lib.flash_block_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(),
            m.data_ptr(), l.data_ptr(), n, t, k.shape[1], d,
            _KERNEL_DTYPES[q.dtype], offset,
            torch.cuda.current_stream().cuda_stream,
        )
    _kernels.check(rc, lib, "flash_block_error_string", "flash_block")
    flash_block_attention_stats.launches += 1
    # q, k, v read once; acc, m, l written once in float32; two
    # multiply-adds per visible pair and head dim (device ledger)
    s = k.shape[1]
    if device_ledger.counting():
        device_ledger.add_kernel_cost(
            4 * d * n * device_ledger.band_pairs(t, s, offset),
            (n * t * d + 2 * n * s * d) * q.element_size() + (n * t * d + 2 * n * t) * 4,
        )
    return acc, m, l


flash_block_attention_stats.launches = 0
