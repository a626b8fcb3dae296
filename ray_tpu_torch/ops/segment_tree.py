"""Segment trees for prioritized replay: the host oracle and the f64
device tree.

Counterpart of ``ray_tpu/ops/segment_tree.py``.

- :class:`SegmentTree`, :class:`SumSegmentTree`, :class:`MinSegmentTree`
  are a copy of the reference's numpy trees: the host oracle of both
  tree planes, and the capacity rounding (a power of two).
- :class:`DeviceSumTree` keeps the sum and min trees as (2·capacity,)
  float64 tensors on the device. A draw (:func:`draw_body`) reduces the
  stored range, descends the sum tree for every query and computes the
  importance weights without leaving the device; a priority write
  (:meth:`DeviceSumTree.set_powered`) scatters the leaves and rebuilds
  the internal levels.

The determinism contract is the reference's: given the same
already-alpha-powered leaves, every op of a draw except the two
beta-powers is one exactly-rounded f64 add, subtract, divide, multiply,
compare or min, so indices and sampled priorities agree bitwise with the
host trees. The alpha-power stays on the host (``powered_priorities``
in ``execution/replay_buffer.py``), because host and device ``pow``
round differently in the last ulp; the IS weights are cast to float32,
which absorbs the beta-power's last f64 ulp in practice.

Two kernels serve the device tree: the prefix descent
(:func:`find_prefixsum`, ``csrc/prefix_descent.cu``; its plain version
is :func:`find_prefixsum_plain` = the reference's
``find_prefixsum_body``) and the leaf write (``scatter_rows``, which
resolves a draw's repeated indices last-write-wins as numpy's fancy
assignment does). Everything else is plain PyTorch f64 on the device,
as it was XLA in the reference. Two details keep it exact:

- a division by a Python number on CUDA multiplies by its reciprocal
  (one ulp off a true division), so every divisor here is a tensor;
- :func:`reduce_range_body` takes ``size`` as a host int: the nodes it
  visits are worked out on the host, in the host tree's order, and
  folded on the device, with no readback.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.ops import _kernels
from ray_tpu_torch.ops.framestack import scatter_rows
from ray_tpu_torch.telemetry import device as device_ledger

F64 = torch.float64


class SegmentTree:
    def __init__(self, capacity: int, operation, neutral_element: float):
        if capacity <= 0 or capacity & (capacity - 1):
            raise ValueError(f"capacity must be a positive power of 2, got {capacity}")
        self.capacity = capacity
        self.operation = operation
        self.neutral_element = neutral_element
        self.value = np.full(2 * capacity, neutral_element, dtype=np.float64)

    def set_items(self, idx: np.ndarray, val: np.ndarray) -> None:
        idx = np.asarray(idx, dtype=np.int64) + self.capacity
        self.value[idx] = val
        idx //= 2
        while np.any(idx >= 1):
            live = idx[idx >= 1]
            self.value[live] = self.operation(
                self.value[2 * live], self.value[2 * live + 1]
            )
            idx //= 2
            idx = idx[idx >= 1]
            if len(idx) == 0:
                break

    def __setitem__(self, idx, val):
        self.set_items(np.atleast_1d(idx), np.atleast_1d(val))

    def __getitem__(self, idx):
        return self.value[self.capacity + idx]

    def reduce(self, start: int = 0, end: Optional[int] = None) -> float:
        if end is None:
            end = self.capacity
        if end < 0:
            end += self.capacity
        result = self.neutral_element
        start += self.capacity
        end += self.capacity
        while start < end:
            if start & 1:
                result = self.operation(result, self.value[start])
                start += 1
            if end & 1:
                end -= 1
                result = self.operation(result, self.value[end])
            start //= 2
            end //= 2
        return result


class SumSegmentTree(SegmentTree):
    def __init__(self, capacity: int):
        super().__init__(capacity, np.add, 0.0)

    def sum(self, start: int = 0, end: Optional[int] = None) -> float:
        return self.reduce(start, end)

    def find_prefixsum_idx(self, prefixsum: np.ndarray) -> np.ndarray:
        """For each p, the highest leaf i with sum(leaves[:i]) <= p; all
        queries descend in lockstep."""
        p = np.asarray(prefixsum, dtype=np.float64).copy()
        idx = np.ones(len(p), dtype=np.int64)
        while idx[0] < self.capacity:
            left = 2 * idx
            left_vals = self.value[left]
            go_right = p > left_vals
            p = np.where(go_right, p - left_vals, p)
            idx = np.where(go_right, left + 1, left)
        return idx - self.capacity


class MinSegmentTree(SegmentTree):
    def __init__(self, capacity: int):
        super().__init__(capacity, np.minimum, float("inf"))

    def min(self, start: int = 0, end: Optional[int] = None) -> float:
        return self.reduce(start, end)


def next_pow2(n: int) -> int:
    """The tree capacity for ``n`` rows: the least power of two >= n."""
    cap = 1
    while cap < n:
        cap *= 2
    return cap


# -- the f64 device tree ---------------------------------------------------


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d f64 tensor on ``like``'s device (a divisor that is a tensor
    divides exactly on CUDA)."""
    return torch.full((), float(x), dtype=F64, device=like.device)


def reduce_nodes(size: int, capacity: int) -> List[int]:
    """The tree nodes ``SegmentTree.reduce(0, size)`` visits, in its
    accumulation order (start-side node first, then end-side, per
    level)."""
    nodes = []
    s, e = capacity, capacity + int(size)
    while s < e:
        if s & 1:
            nodes.append(s)
            s += 1
        if e & 1:
            e -= 1
            nodes.append(e)
        s //= 2
        e //= 2
    return nodes


def reduce_range_body(
    value: torch.Tensor, size: int, op, neutral: float, capacity: int
) -> torch.Tensor:
    """``SegmentTree.reduce(0, size)`` on a device tree: the same nodes,
    folded in the same order with the same f64 op (``torch.add`` or
    ``torch.minimum``), so the result is bitwise the host tree's. A 0-d
    f64 tensor; ``size`` is a host int (the buffer's bookkeeping)."""
    r = _scalar(neutral, value)
    for node in reduce_nodes(size, capacity):
        r = op(r, value[node])
    return r


def find_prefixsum_plain(
    value: torch.Tensor, prefixsum: torch.Tensor, capacity: int
) -> torch.Tensor:
    """The lockstep root→leaf descent in plain PyTorch (the reference's
    ``find_prefixsum_body``): one strict compare and one exact f64
    subtraction per level. int64 leaf indices of ``prefixsum``'s
    shape."""
    p = prefixsum
    idx = torch.ones(p.shape, dtype=torch.int64, device=p.device)
    for _ in range(capacity.bit_length() - 1):
        left = 2 * idx
        left_vals = value[left]
        go_right = p > left_vals
        p = torch.where(go_right, p - left_vals, p)
        idx = torch.where(go_right, left + 1, left)
    return idx - capacity


def find_prefixsum(
    value: torch.Tensor, prefixsum: torch.Tensor, capacity: int
) -> torch.Tensor:
    """The prefix descent: int64 leaf indices, one per mass in
    ``prefixsum`` (any shape, f64). ``value``: the (2·capacity,) f64 sum
    tree. CUDA tensors go through the descent kernel (bitwise equal to
    the plain version); CPU tensors through
    :func:`find_prefixsum_plain`. Unclipped, as the reference's
    descent: :func:`draw_body` clips to the stored range."""
    if value.dtype != F64 or prefixsum.dtype != F64:
        raise TypeError(
            f"find_prefixsum: f64 tree and masses required, got "
            f"{value.dtype} and {prefixsum.dtype}"
        )
    if tuple(value.shape) != (2 * capacity,):
        raise ValueError(
            f"find_prefixsum: tree {tuple(value.shape)} for capacity {capacity}"
        )
    if value.device.type == "cpu":
        return find_prefixsum_plain(value, prefixsum, capacity)
    if value.device.type != "cuda":
        raise ValueError(f"find_prefixsum: unsupported device {value.device}")
    if prefixsum.device != value.device:
        raise ValueError(
            f"find_prefixsum: masses on {prefixsum.device}, tree on {value.device}"
        )
    tree = value if value.is_contiguous() else value.contiguous()
    flat = prefixsum.dim() == 1 and prefixsum.is_contiguous()
    mass = prefixsum if flat else prefixsum.reshape(-1).contiguous()
    n = mass.shape[0]
    out = torch.empty(n, dtype=torch.int64, device=value.device)
    lib = _kernels.library("prefix_descent")
    rc = _kernels.launch(
        lib.prefix_descent_launch, value.device,
        tree.data_ptr(), mass.data_ptr(), out.data_ptr(), n, capacity.bit_length() - 1, capacity,
    )
    if rc:
        _kernels.check(rc, lib, "prefix_descent_error_string", "prefix_descent")
    find_prefixsum.launches += 1
    # a node pair read and a compare-subtract at each level of each
    # descent; the masses read, the leaves written (device ledger)
    levels = capacity.bit_length() - 1
    if device_ledger.counting():
        device_ledger.add_kernel_cost(2 * n * levels, n * levels * 8 + n * 8 + n * 8)
    return out if flat else out.reshape(prefixsum.shape)


find_prefixsum.launches = 0


def draw_scalars(
    sum_value: torch.Tensor,
    min_value: torch.Tensor,
    size: int,
    beta: float,
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The parts of :func:`draw_body` that depend on the tree alone: the
    total mass and the largest IS weight, as 0-d f64 tensors."""
    total = reduce_range_body(sum_value, size, torch.add, 0.0, capacity)
    p_min = (
        reduce_range_body(min_value, size, torch.minimum, float("inf"), capacity)
        / total
    )
    return total, (p_min * size) ** (-beta)


def draw_with(
    sum_value: torch.Tensor,
    rand: torch.Tensor,
    total: torch.Tensor,
    max_weight: torch.Tensor,
    size,
    beta: float,
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The rest of :func:`draw_body`, given :func:`draw_scalars`:
    ``(idx int64, weights float32, p_sample float64)``. ``size`` is a
    host int, or a pair of 0-d device tensors (int64, f64) holding it,
    which a CUDA graph reads afresh on each replay."""
    num_items = rand.shape[-1]
    size_i, size_f = (size, size) if isinstance(size, int) else size
    strata = torch.arange(num_items, dtype=F64, device=rand.device)
    mass = (rand + strata) / _scalar(num_items, rand) * total
    idx = find_prefixsum(sum_value, mass, capacity)
    idx = torch.clamp_min(idx, 0)
    idx = idx.clamp_max(size_i - 1) if isinstance(size_i, int) else torch.minimum(idx, size_i - 1)
    p_sample = sum_value[capacity + idx] / total
    weights = ((p_sample * size_f) ** (-beta) / max_weight).to(torch.float32)
    return idx, weights, p_sample


def draw_body(
    sum_value: torch.Tensor,
    min_value: torch.Tensor,
    rand: torch.Tensor,
    size: int,
    beta: float,
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The stratified proportional draw of
    ``_PrioritySampling._draw_prioritized`` on the device tree: ``rand``
    is the host generator's raw uniform stream (f64, on the tree's
    device), ``size`` the stored row count, ``beta`` the IS exponent.
    Returns ``(idx int64, weights float32, p_sample float64)``, with the
    host's order of operations throughout."""
    total, max_weight = draw_scalars(sum_value, min_value, size, beta, capacity)
    return draw_with(sum_value, rand, total, max_weight, int(size), beta, capacity)


def _rebuild_body(arr: torch.Tensor, op, capacity: int) -> torch.Tensor:
    """Recompute every internal node bottom-up, in place, one level per
    op. Bitwise the host's incremental ancestor updates: each node is
    ``op(left, right)`` of its final children, whatever the order."""
    n = capacity // 2
    while n >= 1:
        op(arr[2 * n: 4 * n: 2], arr[2 * n + 1: 4 * n: 2], out=arr[n: 2 * n])
        n //= 2
    return arr


class DeviceSumTree:
    """The sum and min trees as (2·capacity,) f64 tensors on one device.

    :meth:`set_powered` takes already-alpha-powered leaf values (the
    host keeps the alpha-power); its leaf write goes through
    ``scatter_rows`` on the trees viewed as (2·capacity, 1) rows, so a
    position repeated within one write keeps its last value, as numpy's
    fancy assignment in the host trees does."""

    def __init__(self, capacity: int, device):
        if capacity <= 0 or capacity & (capacity - 1):
            raise ValueError(f"capacity must be a positive power of 2, got {capacity}")
        self.capacity = int(capacity)
        self.device = torch.device(device)
        self.sum_value = torch.zeros(2 * self.capacity, dtype=F64, device=self.device)
        self.min_value = torch.full(
            (2 * self.capacity,), float("inf"), dtype=F64, device=self.device
        )

    def set_powered(self, idx, powered) -> None:
        """Write leaves ``idx`` (host array or device tensor, any int
        dtype) with ``powered`` (f64), then rebuild both trees."""
        pos = torch.as_tensor(idx, device=self.device).reshape(-1).to(torch.int64)
        vals = torch.as_tensor(powered, dtype=F64, device=self.device).reshape(-1, 1)
        pos = pos + self.capacity
        for tree, op in ((self.sum_value, torch.add), (self.min_value, torch.minimum)):
            scatter_rows(tree.view(-1, 1), pos, vals)
            _rebuild_body(tree, op, self.capacity)

    def draw(self, rand, size: int, beta: float) -> Tuple[torch.Tensor, torch.Tensor]:
        """One stratified draw from the host uniform stream ``rand``:
        ``(idx int64, weights float32)`` on the device."""
        r = torch.as_tensor(np.asarray(rand, np.float64), device=self.device)
        idx, weights, _ = draw_body(
            self.sum_value, self.min_value, r, int(size), float(beta), self.capacity
        )
        return idx, weights

    def leaf_values(self, size: int) -> np.ndarray:
        """Host f64 copy of the first ``size`` (already-powered) leaves:
        checkpoint state and tests."""
        cap = self.capacity
        return self.sum_value[cap: cap + int(size)].cpu().numpy().copy()

    def set_leaf_values(self, vals) -> None:
        """A checkpoint's leaves: the first ``len(vals)``, every other
        leaf empty. Both trees are reset in place first, so a graph
        captured before reads the restored tree, and a restore into a
        used tree leaves no stale leaf past the restored rows."""
        self.sum_value.zero_()
        self.min_value.fill_(float("inf"))
        vals = np.asarray(vals, np.float64)
        if len(vals):
            self.set_powered(np.arange(len(vals)), vals)
