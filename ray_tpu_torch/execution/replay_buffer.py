"""Replay buffers: the host oracle rings and the device data plane.

Counterpart of ``ray_tpu/execution/replay_buffer.py``.

- :class:`ReplayBuffer` / :class:`PrioritizedReplayBuffer` are copies of
  the reference's numpy rings; with :class:`_PrioritySampling` and
  :func:`powered_priorities` they are the oracle the device plane is
  held against.
- :class:`DeviceReplayBuffer` / :class:`DevicePrioritizedReplayBuffer`
  keep one ring tensor per column on the policy's device. An insert is
  one ``scatter_rows`` per column (the row-scatter kernel on CUDA); a
  sample is one ``gather_rows`` per column (the row-gather kernel).
  uint8 columns whose rows are whole 4-byte words (pixel obs) are
  stored as int32 words, the reference's uint32 lanes, so both kernels
  move words. Index draws stay on the host, from
  ``np.random.default_rng(seed)`` in the host ring's call order, so a
  fixed seed draws the same rows on every plane.
- :class:`DevicePrioritizedReplayBuffer` keeps the priorities on the
  device too (``ops/segment_tree.DeviceSumTree``): a sample is the f64 draw
  (prefix-descent kernel) → a row gather on every column → the IS
  ``weights`` column, and only the generator's raw uniforms cross to
  the device. A priority update powers |td| on the host (the one
  inexact op, kept where the oracle computes it) and writes the leaves
  on the device.

``get_state``/``set_state`` use the reference's layout (ring rows
``[:size]`` as host arrays in the reference's dtypes, uint8 pixels
unpacked, priorities as ``{"leaf_values", "max_priority"}``), so a
checkpoint moves between the two packages.

The superstep's feed (``superstep_feed`` → :class:`SuperstepRingFeed`):
the k updates' draws are made up front on the host in the sequential
order (``draw_index_sets``; k uniform streams for a prioritized buffer,
whose tree is frozen for the superstep, the reference's documented
within-chain staleness), shipped once into the feed's static device
buffers, and each slot of the superstep draws (the prefix-descent
kernel) and gathers (the row-gather kernel) its rows in place, inside
the slot's CUDA graph. The (k, B) |TD| errors come back in one copy;
``refresh_priorities_stacked`` powers them on the host and writes them
as one stacked tree update, in update order.

Not ported yet (ROADMAP): the reference's memory-cap spill to a host
ring. Where a ring would not fit its memory cap, the port raises with
the numbers; it never moves rows to the host.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.data.sample_batch import DEFAULT_POLICY_ID, SampleBatch
from ray_tpu_torch.ops.framestack import gather_rows, scatter_rows
from ray_tpu_torch.ops.segment_tree import (
    F64,
    DeviceSumTree,
    MinSegmentTree,
    SumSegmentTree,
    draw_body,
    draw_scalars,
    draw_with,
    next_pow2,
)


class ReplayBuffer:
    """Uniform host ring (the reference's ``ReplayBuffer``)."""

    def __init__(self, capacity: int = 10000, seed: Optional[int] = None):
        self.capacity = capacity
        self._cols: Dict[str, np.ndarray] = {}
        self._idx = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)
        self._num_added = 0

    def __len__(self) -> int:
        return self._size

    @property
    def num_added(self) -> int:
        return self._num_added

    def add(self, batch: SampleBatch) -> None:
        n = batch.count
        if n == 0:
            return
        for k, v in batch.items():
            if isinstance(v, np.ndarray) and v.dtype != object and k not in self._cols:
                self._cols[k] = np.zeros((self.capacity,) + v.shape[1:], v.dtype)
        idx = (self._idx + np.arange(n)) % self.capacity
        for k, col in self._cols.items():
            if k in batch:
                col[idx] = batch[k]
        self._idx = int((self._idx + n) % self.capacity)
        self._size = int(min(self._size + n, self.capacity))
        self._num_added += n

    def sample(self, num_items: int) -> SampleBatch:
        idx = self._rng.integers(0, self._size, num_items)
        return self._make_batch(idx)

    def _make_batch(self, idx: np.ndarray) -> SampleBatch:
        return SampleBatch({k: col[idx] for k, col in self._cols.items()})

    def get_state(self) -> Dict:
        return {
            "cols": {k: v[: self._size].copy() for k, v in self._cols.items()},
            "idx": self._idx,
            "size": self._size,
            "num_added": self._num_added,
        }

    def set_state(self, state: Dict) -> None:
        self._size = state["size"]
        self._idx = state["idx"]
        self._num_added = state["num_added"]
        for k, v in state["cols"].items():
            self._cols[k] = np.zeros((self.capacity,) + v.shape[1:], v.dtype)
            self._cols[k][: self._size] = v


def powered_priorities(priorities, alpha: float):
    """The priority → leaf transform of both tree planes: clamp to 1e-6,
    then the alpha-power, in host numpy f64. Returns ``(powered,
    clamped)``; the clamped values feed the max-priority watermark."""
    clamped = np.maximum(np.asarray(priorities, np.float64), 1e-6)
    return clamped**alpha, clamped


class _PrioritySampling:
    """Host proportional-priority machinery (numpy sum/min trees, the
    stratified draw, IS weights, priority updates): the oracle both tree
    planes are held against."""

    def _init_priority_trees(self, capacity: int, alpha: float) -> None:
        if alpha < 0:
            raise ValueError(f"alpha must be >= 0, got {alpha}")
        self._alpha = alpha
        self._tree_capacity = next_pow2(capacity)
        self._sum_tree = SumSegmentTree(self._tree_capacity)
        self._min_tree = MinSegmentTree(self._tree_capacity)
        self._max_priority = 1.0

    def _draw_prioritized(self, num_items: int, beta: float):
        """→ (row indices, IS weights float32) for one stratified
        proportional draw over the current ``self._size`` rows."""
        total = self._sum_tree.sum(0, self._size)
        mass = (self._rng.random(num_items) + np.arange(num_items)) / num_items * total
        idx = self._sum_tree.find_prefixsum_idx(mass)
        idx = np.clip(idx, 0, self._size - 1)
        p_min = self._min_tree.min(0, self._size) / total
        max_weight = (p_min * self._size) ** (-beta)
        p_sample = self._sum_tree[idx] / total
        weights = (p_sample * self._size) ** (-beta) / max_weight
        return idx, weights.astype(np.float32)

    def update_priorities(self, idx, priorities: np.ndarray) -> None:
        powered, clamped = powered_priorities(priorities, self._alpha)
        self._sum_tree.set_items(np.asarray(idx), powered)
        self._min_tree.set_items(np.asarray(idx), powered)
        self._max_priority = max(self._max_priority, float(clamped.max()))

    def _priority_state(self) -> Dict:
        idx = np.arange(self._size)
        return {
            "leaf_values": np.asarray(self._sum_tree[idx], np.float64)
            if self._size
            else np.zeros(0, np.float64),
            "max_priority": self._max_priority,
        }

    def _set_priority_state(self, state: Dict) -> None:
        vals = np.asarray(state["leaf_values"], np.float64)
        if len(vals):
            idx = np.arange(len(vals))
            self._sum_tree.set_items(idx, vals)
            self._min_tree.set_items(idx, vals)
        self._max_priority = float(state.get("max_priority", 1.0))


class PrioritizedReplayBuffer(_PrioritySampling, ReplayBuffer):
    """Proportional prioritized host ring (the reference's)."""

    def __init__(self, capacity: int = 10000, alpha: float = 0.6, seed: Optional[int] = None):
        super().__init__(capacity, seed)
        self._init_priority_trees(capacity, alpha)

    def add(self, batch: SampleBatch) -> None:
        self.add_with_priorities(batch, np.full(batch.count, self._max_priority))

    def add_with_priorities(self, batch: SampleBatch, priorities: np.ndarray) -> None:
        n = batch.count
        if n == 0:
            return
        idx = (self._idx + np.arange(n)) % self.capacity
        ReplayBuffer.add(self, batch)
        self.update_priorities(idx, np.asarray(priorities, np.float64))

    def sample(self, num_items: int, beta: float = 0.4) -> SampleBatch:
        idx, weights = self._draw_prioritized(num_items, beta)
        batch = self._make_batch(idx)
        batch["weights"] = weights
        batch["batch_indexes"] = idx.astype(np.int64)
        return batch

    def get_state(self) -> Dict:
        state = super().get_state()
        state["priorities"] = self._priority_state()
        return state

    def set_state(self, state: Dict) -> None:
        super().set_state(state)
        if "priorities" in state:
            self._set_priority_state(state["priorities"])


def resolve_device_resident(config: Dict) -> bool:
    """The ``replay_device_resident`` knob. ``"auto"`` (the default)
    and ``True`` keep the rings on the policy's device. The reference
    turned "auto" off on its CPU client, where each extra jitted program
    cost a compile; PyTorch compiles nothing, so the port's CPU runs use
    the same tensor rings as the card. ``False`` (host rings, fed by the
    actor lane) is not ported yet and raises."""
    if not config.get("replay_device_resident", "auto"):
        raise ValueError(
            "replay_device_resident=False (host rings fed by the actor "
            "lane) is not ported yet; the device lane inserts device rows"
        )
    return True


def resolve_device_tree(config: Dict) -> bool:
    """The ``replay_device_tree`` knob: ``"auto"`` and ``True`` keep the
    priorities on the device beside the rows. ``False`` (the
    reference's host sum tree beside device rows) raises: it would draw
    on the host while the rows are on the card."""
    resolve_device_resident(config)
    if not config.get("replay_device_tree", "auto"):
        raise ValueError(
            "replay_device_tree=False would keep the priorities in host "
            "trees beside device rows; the port draws on the device only"
        )
    return True


class DeviceTrainBatch:
    """A sampled batch whose columns are device tensors, ready for
    ``TorchPolicy.learn_on_device_batch``. ``indices`` are the drawn
    ring positions (host numpy, or a device int64 tensor under the
    device tree), kept for the priority refresh."""

    is_device_resident = True

    def __init__(self, tree: Dict[str, Any], count: int, indices=None):
        self.tree = tree
        self.count = int(count)
        self.indices = indices


class SuperstepRingFeed:
    """A device buffer's rings as the feed of a superstep
    (``TorchPolicy.learn_superstep(rings=...)``): static device buffers
    of the (k_max, B) pre-drawn schedule, which :meth:`batch` turns into
    a slot's rows inside the slot. Uniform: the (k_max, B) ring
    positions. Prioritized: the (k_max, B) f64 uniforms and the frozen
    tree's total, largest IS weight and size; the slot runs the draw's
    descent and writes its positions into ``idx`` for the refresh."""

    def __init__(self, buf, k_max: int, num_items: int, beta: Optional[float]):
        dev = buf.device
        self.buf = buf
        self.beta = beta
        self.idx = torch.zeros((k_max, num_items), dtype=torch.int64, device=dev)
        if beta is not None:
            self.rand = torch.zeros((k_max, num_items), dtype=F64, device=dev)
            self.total = torch.zeros((), dtype=F64, device=dev)
            self.max_weight = torch.zeros((), dtype=F64, device=dev)
            self.size = (torch.zeros((), dtype=torch.int64, device=dev),
                         torch.zeros((), dtype=F64, device=dev))
        # the slot graph's cache key: these buffers and the rings they read
        self.key = ("rings", id(self), id(buf._store), tuple(sorted(buf._store)))

    def draw(self, rand: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One prioritized draw on the frozen tree: (idx, weights)."""
        tree = self.buf._dtree
        idx, weights, _ = draw_with(
            tree.sum_value, rand, self.total, self.max_weight, self.size, self.beta,
            tree.capacity,
        )
        return idx, weights

    def batch(self, slot: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The rows of slot ``slot`` (a (1,) device index)."""
        if self.beta is None:
            return self.buf._gather_columns(self.idx.index_select(0, slot)[0])
        idx, weights = self.draw(self.rand.index_select(0, slot)[0])
        self.idx.index_copy_(0, slot, idx[None])
        cols = self.buf._gather_columns(idx)
        cols["weights"] = weights
        return cols


# host dtypes the rings store instead (the reference's x64-off canonicalization)
_CANONICAL_NP = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
                 np.dtype(np.uint64): np.uint32}
_CANONICAL_TORCH = {torch.float64: torch.float32, torch.int64: torch.int32}


class DeviceReplayBuffer:
    """Uniform ring whose columns live on ``device`` (default: CUDA;
    ``"cpu"`` runs the same code on CPU tensors with the kernels' plain
    versions).

    - **Insert** scatters the rows of every column at positions
      ``(idx + arange(n)) % capacity`` (``scatter_rows``, in place).
      Rows from the device rollout lane never leave the device; host
      rows cross once, here.
    - **Sample** draws indices on the host from the seeded generator,
      then gathers every column (``gather_rows``).
    - **Memory:** the first insert of a column projects ``capacity`` ×
      row bytes; past ``memory_cap_bytes`` (default: 60% of the card's
      memory, none on the CPU) it raises with the numbers.
    """

    is_device_resident = True

    def __init__(
        self,
        capacity: int = 10000,
        seed: Optional[int] = None,
        *,
        device=None,
        memory_cap_bytes: Optional[int] = None,
        label: str = DEFAULT_POLICY_ID,
    ):
        from ray_tpu_torch.device import resolve_device

        self.capacity = int(capacity)
        self._rng = np.random.default_rng(seed)
        self.device = resolve_device(device)
        self.memory_cap_bytes = memory_cap_bytes
        self.label = label
        self._store: Dict[str, torch.Tensor] = {}
        # name -> (row_shape, dtype, packed as int32 words)
        self._meta: Dict[str, tuple] = {}
        self._idx = 0
        self._size = 0
        self._num_added = 0
        self.storage_bytes = 0

    # -- storage ----------------------------------------------------------

    def _memory_limit(self) -> Optional[int]:
        if self.memory_cap_bytes is not None:
            return int(self.memory_cap_bytes)
        if self.device.type == "cuda":
            total = torch.cuda.get_device_properties(self.device).total_memory
            return int(0.6 * total)
        return None

    @staticmethod
    def _packable(row_shape: tuple, dtype) -> bool:
        inner = int(np.prod(row_shape)) if row_shape else 1
        return dtype == torch.uint8 and len(row_shape) >= 1 and inner % 4 == 0

    def _to_device(self, v) -> torch.Tensor:
        """One column → a canonical tensor on the buffer's device."""
        if isinstance(v, torch.Tensor):
            t = v.to(self.device)
            return t.to(_CANONICAL_TORCH.get(t.dtype, t.dtype))
        v = np.ascontiguousarray(v)
        v = v.astype(_CANONICAL_NP.get(v.dtype, v.dtype), copy=False)
        return torch.from_numpy(v).to(self.device)

    def _ensure_storage(self, tree: Dict[str, torch.Tensor]) -> None:
        new_cols = {k: v for k, v in tree.items() if k not in self._store}
        if not new_cols:
            return
        projected = self.storage_bytes + sum(
            self.capacity * int(np.prod(v.shape[1:])) * v.element_size()
            for v in new_cols.values()
        )
        limit = self._memory_limit()
        if limit is not None and projected > limit:
            raise MemoryError(
                f"replay buffer {self.label!r}: {self.capacity} rows of "
                f"{sorted(new_cols)} would bring the rings to {projected} bytes, "
                f"over the {limit}-byte cap on {self.device}; lower "
                "replay_buffer_config['capacity'] or raise replay_memory_cap_bytes "
                "(spilling to a host ring is not ported)"
            )
        for k, v in new_cols.items():
            row_shape = tuple(v.shape[1:])
            packed = self._packable(row_shape, v.dtype)
            if packed:
                shape = (self.capacity, int(np.prod(row_shape)) // 4)
                ring = torch.zeros(shape, dtype=torch.int32, device=self.device)
            else:
                ring = torch.zeros(
                    (self.capacity,) + row_shape, dtype=v.dtype, device=self.device
                )
            self._store[k] = ring
            self._meta[k] = (row_shape, v.dtype, packed)
            self.storage_bytes += self.capacity * int(np.prod(row_shape)) * v.element_size()

    def _scatter(self, tree: Dict[str, torch.Tensor], pos: torch.Tensor) -> None:
        n = int(pos.shape[0])
        for k, v in tree.items():
            row_shape, dtype, packed = self._meta[k]
            if tuple(v.shape) != (n,) + row_shape or v.dtype != dtype:
                raise ValueError(
                    f"replay column {k!r}: rows {v.dtype} {tuple(v.shape[1:])}, "
                    f"ring {dtype} {row_shape}"
                )
            v = v.contiguous()
            if packed:
                v = v.reshape(n, -1).view(torch.int32)
            scatter_rows(self._store[k], pos, v)

    def _gather_columns(self, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        n = int(idx.shape[0])
        out = {}
        for k, ring in self._store.items():
            row_shape, _, packed = self._meta[k]
            g = gather_rows(ring, idx)
            if packed:
                g = g.view(torch.uint8).reshape((n,) + row_shape)
            out[k] = g
        return out

    # -- ring bookkeeping (the host ring's, exactly) ----------------------

    def __len__(self) -> int:
        return self._size

    @property
    def num_added(self) -> int:
        return self._num_added

    def add_device_tree(self, tree: Dict[str, Any]) -> None:
        """Insert a column tree (equal leading dims): one in-place
        scatter per column. Device rows (the rollout lane's) make no
        host copy; host arrays cross to the device once, here."""
        tree = {k: self._to_device(v) for k, v in tree.items()}
        if not tree:
            return
        n = int(next(iter(tree.values())).shape[0])
        if n == 0:
            return
        self._ensure_storage(tree)
        pos = torch.as_tensor(
            (self._idx + np.arange(n)) % self.capacity, device=self.device
        )
        self._scatter(tree, pos)
        self._idx = int((self._idx + n) % self.capacity)
        self._size = int(min(self._size + n, self.capacity))
        self._num_added += n

    # -- sampling ---------------------------------------------------------

    def sample(self, num_items: int) -> DeviceTrainBatch:
        idx = self._rng.integers(0, self._size, num_items)
        return self.gather(idx)

    def gather(self, idx) -> DeviceTrainBatch:
        """Rows at caller-chosen ring positions (host indices)."""
        idx = np.asarray(idx)
        idx_t = torch.as_tensor(idx.astype(np.int64), device=self.device)
        return DeviceTrainBatch(self._gather_columns(idx_t), len(idx), indices=idx)

    # -- the superstep's feed ---------------------------------------------

    def draw_index_sets(self, k: int, num_items: int) -> np.ndarray:
        """(k, num_items) uniform draws: k sequential generator calls, as
        k ``sample`` calls make them (never one k·n call)."""
        return np.stack([self._rng.integers(0, self._size, num_items) for _ in range(k)])

    def _feed(self, k_max: int, num_items: int, beta: Optional[float]) -> SuperstepRingFeed:
        """The feed's static buffers, one set per (k_max, B, beta), so a
        captured slot reads the same memory on every superstep."""
        feeds = self.__dict__.setdefault("_feeds", {})
        key = (k_max, num_items, beta, id(self._store))
        feed = feeds.get(key)
        if feed is None:
            feed = feeds[key] = SuperstepRingFeed(self, k_max, num_items, beta)
        return feed

    def superstep_feed(self, k: int, k_max: int, num_items: int) -> SuperstepRingFeed:
        """The superstep's schedule: ``draw_index_sets(k, num_items)``,
        shipped in one copy into the feed's (k_max, B) buffer."""
        feed = self._feed(k_max, num_items, None)
        feed.idx[:k].copy_(torch.from_numpy(self.draw_index_sets(k, num_items)))
        return feed

    # -- checkpoint state (the reference's layout) --------------------------

    def get_state(self) -> Dict:
        cols = {}
        for k, ring in self._store.items():
            row_shape, _, packed = self._meta[k]
            host = ring[: self._size].cpu().numpy()
            if packed:
                host = host.view(np.uint8).reshape((self._size,) + row_shape)
            cols[k] = host.copy()
        return {
            "cols": cols,
            "idx": self._idx,
            "size": self._size,
            "num_added": self._num_added,
            "spilled": False,
        }

    def set_state(self, state: Dict) -> None:
        """Restore a state of either package (a reference state saved
        from a spilled host ring has the same layout). The whole ring is
        one scatter of ``capacity`` rows per column."""
        size = int(state["size"])
        full = {}
        for k, v in state["cols"].items():
            v = np.asarray(v)
            v = v.astype(_CANONICAL_NP.get(v.dtype, v.dtype), copy=False)
            ring = np.zeros((self.capacity,) + v.shape[1:], v.dtype)
            ring[:size] = v
            full[k] = self._to_device(ring)
        self._store, self._meta, self.storage_bytes = {}, {}, 0
        self.__dict__.pop("_feeds", None)
        if full:
            self._ensure_storage(full)
            self._scatter(full, torch.arange(self.capacity, device=self.device))
        self._idx = int(state["idx"])
        self._size = size
        self._num_added = int(state["num_added"])


class DevicePrioritizedReplayBuffer(DeviceReplayBuffer):
    """Prioritized replay with the rows and the priorities on the device:
    the priorities live in a :class:`DeviceSumTree`, a sample is draw →
    gather → weights on the device, and ``indices`` is a device int64
    tensor that feeds the priority refresh directly. Only the
    alpha-power runs on the host (``powered_priorities``), as in the
    oracle, whose host trees draw the same rows from the same seed."""

    def __init__(
        self,
        capacity: int = 10000,
        alpha: float = 0.6,
        seed: Optional[int] = None,
        *,
        device=None,
        memory_cap_bytes: Optional[int] = None,
        label: str = DEFAULT_POLICY_ID,
    ):
        super().__init__(
            capacity, seed, device=device, memory_cap_bytes=memory_cap_bytes, label=label
        )
        if alpha < 0:
            raise ValueError(f"alpha must be >= 0, got {alpha}")
        self._alpha = alpha
        self._max_priority = 1.0
        self._dtree = DeviceSumTree(next_pow2(capacity), self.device)

    def update_priorities(self, idx, priorities: np.ndarray) -> None:
        """The host alpha-power, then one leaf write + rebuild on the
        device; ``idx`` may be host indices or the device tensor a sample
        returned."""
        powered, clamped = powered_priorities(priorities, self._alpha)
        self._dtree.set_powered(idx, powered)
        self._max_priority = max(self._max_priority, float(clamped.max()))

    def add_device_tree(self, tree: Dict[str, Any], priorities: Optional[np.ndarray] = None) -> None:
        """Insert with the host priority protocol: new rows enter the
        trees at the max priority (or the caller's)."""
        tree = dict(tree)
        if not tree:
            return
        n = int(next(iter(tree.values())).shape[0])
        if n == 0:
            return
        if priorities is None:
            priorities = np.full(n, self._max_priority)
        idx = (self._idx + np.arange(n)) % self.capacity
        DeviceReplayBuffer.add_device_tree(self, tree)
        self.update_priorities(idx, np.asarray(priorities, np.float64))

    def sample(self, num_items: int, beta: float = 0.4) -> DeviceTrainBatch:
        rand = torch.as_tensor(self._rng.random(num_items), device=self.device)
        tree = self._dtree
        idx, weights, _ = draw_body(
            tree.sum_value, tree.min_value, rand, self._size, beta, tree.capacity
        )
        cols = self._gather_columns(idx)
        cols["weights"] = weights
        return DeviceTrainBatch(cols, num_items, indices=idx)

    def superstep_feed(
        self, k: int, k_max: int, num_items: int, beta: float = 0.4
    ) -> SuperstepRingFeed:
        """The superstep's schedule against the tree as it stands: k
        sequential ``random(num_items)`` calls (the per-update stream
        order) in one copy, and the frozen tree's total, largest IS
        weight and size; each slot's descent runs in the slot."""
        feed = self._feed(k_max, num_items, float(beta))
        rand = np.stack([self._rng.random(num_items) for _ in range(k)])
        feed.rand[:k].copy_(torch.from_numpy(rand))
        tree = self._dtree
        total, max_weight = draw_scalars(
            tree.sum_value, tree.min_value, self._size, float(beta), tree.capacity
        )
        feed.total.copy_(total)
        feed.max_weight.copy_(max_weight)
        for t in feed.size:
            t.fill_(self._size)
        return feed

    def draw_prioritized_sets_device(
        self, k: int, k_max: int, num_items: int, beta: float
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The superstep's pre-drawn schedule, drawn eagerly: (k_max, B)
        device positions and IS weights (rows past k: 0 and 1), each row
        drawn as a superstep slot draws it."""
        feed = self.superstep_feed(k, k_max, num_items, beta)
        idx = torch.zeros((k_max, num_items), dtype=torch.int64, device=self.device)
        weights = torch.ones((k_max, num_items), dtype=torch.float32, device=self.device)
        for i in range(k):
            idx[i], weights[i] = feed.draw(feed.rand[i])
        return idx, weights

    def refresh_priorities_stacked(self, idx: torch.Tensor, abs_td: np.ndarray, active) -> None:
        """A superstep's priority refresh: the (k, B) |TD| errors
        ``+ 1e-6`` (in their float32, as the per-update call site adds
        it) powered on the host, then one tree write of the active
        updates' rows in update order — the per-update
        ``update_priorities(idx[i], td[i] + 1e-6)`` loop, whose repeated
        positions keep the last write."""
        rows = np.flatnonzero(np.asarray(active, bool))
        if not len(rows):
            return
        powered, clamped = powered_priorities(np.asarray(abs_td)[rows] + 1e-6, self._alpha)
        self._dtree.set_powered(idx[torch.as_tensor(rows, device=idx.device)], powered)
        self._max_priority = max(self._max_priority, float(clamped.max()))

    def get_state(self) -> Dict:
        state = super().get_state()
        state["priorities"] = {
            "leaf_values": self._dtree.leaf_values(self._size),
            "max_priority": self._max_priority,
        }
        return state

    def set_state(self, state: Dict) -> None:
        super().set_state(state)
        if "priorities" in state:
            self._dtree.set_leaf_values(state["priorities"]["leaf_values"])
            self._max_priority = float(state["priorities"].get("max_priority", 1.0))


class MultiAgentReplayBuffer:
    """Per-policy device buffers, as the reference's; the port's
    algorithms use one policy. ``sample`` returns ``{policy_id: batch}``
    for every buffer holding at least ``num_items`` rows.
    ``replay_columns_fn(policy_id, SampleBatch) -> {column: array}``
    turns a host fragment into the columns the policy's learn call reads
    (``TorchPolicy.replay_columns``), once, at insert."""

    def __init__(
        self,
        capacity: int = 10000,
        prioritized: bool = False,
        alpha: float = 0.6,
        seed: Optional[int] = None,
        *,
        device=None,
        memory_cap_bytes: Optional[int] = None,
        replay_columns_fn: Optional[Callable[[str, SampleBatch], Dict[str, np.ndarray]]] = None,
    ):
        self.capacity = capacity
        self.prioritized = prioritized
        self.alpha = alpha
        self.seed = seed
        self.device = device
        self.memory_cap_bytes = memory_cap_bytes
        self.replay_columns_fn = replay_columns_fn
        self.buffers: Dict[str, DeviceReplayBuffer] = {}

    def _buffer(self, pid: str) -> DeviceReplayBuffer:
        if pid not in self.buffers:
            kwargs = dict(device=self.device, memory_cap_bytes=self.memory_cap_bytes, label=pid)
            if self.prioritized:
                buf = DevicePrioritizedReplayBuffer(self.capacity, self.alpha, self.seed, **kwargs)
            else:
                buf = DeviceReplayBuffer(self.capacity, self.seed, **kwargs)
            self.buffers[pid] = buf
        return self.buffers[pid]

    def add_device_tree(self, tree: Dict[str, Any], policy_id: str = DEFAULT_POLICY_ID) -> None:
        self._buffer(policy_id).add_device_tree(tree)

    def add(self, batch: SampleBatch, policy_id: str = DEFAULT_POLICY_ID) -> None:
        """A host fragment (the actor lane's): its replay columns (the
        policy's, or every numeric column) cross to the device once each
        and land with one scatter per column (``add_device_tree``)."""
        if self.replay_columns_fn is not None:
            tree = self.replay_columns_fn(policy_id, batch)
        else:
            tree = {
                k: np.asarray(v) for k, v in batch.items()
                if isinstance(v, np.ndarray) and v.dtype != object
            }
        self._buffer(policy_id).add_device_tree(tree)

    def sample(self, num_items: int, **kwargs) -> Dict[str, Any]:
        out = {}
        for pid, buf in self.buffers.items():
            if len(buf) >= num_items:
                out[pid] = buf.sample(num_items, **kwargs)
        return out

    def __len__(self) -> int:
        return max((len(b) for b in self.buffers.values()), default=0)

    def get_state(self) -> Dict:
        return {pid: b.get_state() for pid, b in self.buffers.items()}

    def set_state(self, state: Dict) -> None:
        for pid, s in state.items():
            self._buffer(pid).set_state(s)
