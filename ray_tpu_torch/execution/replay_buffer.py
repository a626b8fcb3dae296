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

Two more placements, as the reference's:

- **Host rings** (``replay_device_resident=False``): the numpy
  :class:`ReplayBuffer` / :class:`PrioritizedReplayBuffer`; an update
  draws on the host and uploads the drawn batch once, and a superstep
  stacks its k draws into one upload (``train_ops``' host stacked path).
- **Host trees beside device rows** (``replay_device_tree=False``):
  :class:`DevicePrioritizedReplayBuffer` keeps the numpy sum and min
  trees of :class:`_PrioritySampling`; a draw runs on the host and only
  the drawn positions and IS weights cross, for the row gather.
- **The memory-cap spill**: the first insert of a column projects
  ``capacity`` x row bytes; past ``memory_cap_bytes`` (default: 60% of
  the card's memory from ``torch.cuda.mem_get_info``, none for CPU
  tensors) the buffer hands everything to a host ring built on the same
  generator object, so the spill changes where rows live, never which
  rows a draw takes. ``spilled`` and ``stats()`` say so.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.data.sample_batch import DEFAULT_POLICY_ID, MultiAgentBatch, SampleBatch
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
from ray_tpu_torch.telemetry import metrics as telemetry_metrics
from ray_tpu_torch.util import tracing


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

    def draw_index_sets(self, k: int, num_items: int) -> np.ndarray:
        """(k, num_items) uniform draws: k sequential generator calls, as
        k ``sample`` calls make them (never one k·n call)."""
        return np.stack([self._rng.integers(0, self._size, num_items) for _ in range(k)])

    def _make_batch(self, idx: np.ndarray) -> SampleBatch:
        return SampleBatch({k: col[idx] for k, col in self._cols.items()})

    def stats(self) -> Dict:
        return {"size": self._size, "num_added": self._num_added}

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

    def _init_priority_trees(self, capacity: int, alpha: float, host_trees: bool = True) -> None:
        """``host_trees=False`` allocates no host sum and min trees (the
        device tree plane never reads them)."""
        if alpha < 0:
            raise ValueError(f"alpha must be >= 0, got {alpha}")
        self._alpha = alpha
        self._tree_capacity = next_pow2(capacity)
        if host_trees:
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
        telemetry_metrics.inc_tree_op("sample", "host")
        return idx, weights.astype(np.float32)

    def draw_prioritized_sets(self, k: int, num_items: int, beta: float):
        """k sequential stratified draws → (k, n) indices and IS weights,
        the trees frozen between them (the superstep's within-chain
        staleness); the generator's calls are k ``sample`` calls'."""
        idx, weights = zip(*(self._draw_prioritized(num_items, beta) for _ in range(k)))
        return np.stack(idx), np.stack(weights)

    def update_priorities(self, idx, priorities: np.ndarray) -> None:
        powered, clamped = powered_priorities(priorities, self._alpha)
        self._sum_tree.set_items(np.asarray(idx), powered)
        self._min_tree.set_items(np.asarray(idx), powered)
        self._max_priority = max(self._max_priority, float(clamped.max()))
        telemetry_metrics.inc_tree_op("update", "host")

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
        with tracing.start_span("replay:sample", n=num_items, tree="host"):
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
    and ``True`` keep the rings on the policy's device; ``False`` keeps
    the reference's numpy host rings. The reference turned "auto" off on
    its CPU client, where each extra jitted program cost a compile;
    PyTorch compiles nothing, so the port's CPU runs use the same tensor
    rings as the card."""
    return bool(config.get("replay_device_resident", "auto"))


def resolve_device_tree(config: Dict) -> bool:
    """The ``replay_device_tree`` knob: ``"auto"`` and ``True`` keep the
    priorities in a device tree beside device rows; ``False``, or host
    rings, keep the host numpy trees (a draw on the host, the drawn rows
    gathered on the device)."""
    return bool(config.get("replay_device_tree", "auto")) and resolve_device_resident(config)


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
    positions. Host tree (``host_weights``): the positions and IS
    weights the host trees drew. Device tree: the (k_max, B) f64
    uniforms and the frozen tree's total, largest IS weight and size;
    the slot runs the draw's descent and writes its positions into
    ``idx`` for the refresh."""

    def __init__(self, buf, k_max: int, num_items: int, beta: Optional[float],
                 host_weights: bool = False):
        dev = buf.device
        self.buf = buf
        self.beta = beta
        self.idx = torch.zeros((k_max, num_items), dtype=torch.int64, device=dev)
        self.weights = (torch.ones((k_max, num_items), dtype=torch.float32, device=dev)
                        if host_weights else None)
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
            cols = self.buf._gather_columns(self.idx.index_select(0, slot)[0])
            if self.weights is not None:
                cols["weights"] = self.weights.index_select(0, slot)[0]
            return cols
        idx, weights = self.draw(self.rand.index_select(0, slot)[0])
        self.idx.index_copy_(0, slot, idx[None])
        cols = self.buf._gather_columns(idx)
        cols["weights"] = weights
        return cols


# host dtypes the rings store instead (the reference's x64-off canonicalization)
_CANONICAL_NP = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
                 np.dtype(np.uint64): np.uint32}
_CANONICAL_TORCH = {torch.float64: torch.float32, torch.int64: torch.int32}


def _canonical(v):
    """One column in the rings' dtypes, where it lies: a tensor stays on
    its device, anything else becomes a contiguous numpy array."""
    if isinstance(v, torch.Tensor):
        return v.to(_CANONICAL_TORCH.get(v.dtype, v.dtype))
    v = np.ascontiguousarray(v)
    return v.astype(_CANONICAL_NP.get(v.dtype, v.dtype), copy=False)


def _torch_dtype(v) -> torch.dtype:
    return v.dtype if isinstance(v, torch.Tensor) else torch.from_numpy(np.empty(0, v.dtype)).dtype


def _host_columns(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v for k, v in tree.items()}


class DeviceReplayBuffer:
    """Uniform ring whose columns live on ``device`` (default: CUDA;
    ``"cpu"`` runs the same code on CPU tensors with the kernels' plain
    versions).

    - **Insert** scatters the rows of every column at positions
      ``(idx + arange(n)) % capacity`` (``scatter_rows``, in place).
      Rows from the device rollout lane never leave the device; host
      rows cross once, here (``add_tree``: a host tree, the reference's
      host insert).
    - **Sample** draws indices on the host from the seeded generator,
      then gathers every column (``gather_rows``).
    - **Spill:** the first insert of a column projects ``capacity`` ×
      row bytes; past ``memory_cap_bytes`` (default: 60% of the card's
      total memory, none for CPU tensors) every call goes to a host
      :class:`ReplayBuffer` on the same generator object, whose rows
      the resident ones are replayed into when a later column tips the
      projection over.
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
        self._host: Optional[ReplayBuffer] = None  # the spill ring

    # -- spill ------------------------------------------------------------

    @property
    def spilled(self) -> bool:
        return self._host is not None

    def _make_host_fallback(self) -> ReplayBuffer:
        buf = ReplayBuffer(self.capacity)
        # the same generator object: a spill moves rows, never the draws
        buf._rng = self._rng
        return buf

    def _memory_limit(self) -> Optional[int]:
        if self.memory_cap_bytes is not None:
            return int(self.memory_cap_bytes)
        if self.device.type == "cuda":
            return int(0.6 * torch.cuda.mem_get_info(self.device)[1])
        return None

    def _reset_storage(self) -> None:
        self._store, self._meta, self.storage_bytes = {}, {}, 0
        self.__dict__.pop("_feeds", None)

    # -- storage ----------------------------------------------------------

    @staticmethod
    def _packable(row_shape: tuple, dtype) -> bool:
        inner = int(np.prod(row_shape)) if row_shape else 1
        return dtype == torch.uint8 and len(row_shape) >= 1 and inner % 4 == 0

    def _to_device(self, v) -> torch.Tensor:
        """One column → a canonical tensor on the buffer's device."""
        v = _canonical(v)
        return v.to(self.device) if isinstance(v, torch.Tensor) else torch.from_numpy(v).to(self.device)

    def _ensure_storage(self, tree: Dict[str, Any]) -> bool:
        """Rings for the tree's new columns (canonical host arrays or
        tensors); False when the buffer has spilled, or spills now."""
        if self._host is not None:
            return False
        new_cols = {k: v for k, v in tree.items() if k not in self._store}
        if not new_cols:
            return True
        row_bytes = {k: int(np.prod(v.shape[1:])) * _torch_dtype(v).itemsize
                     for k, v in new_cols.items()}
        projected = self.storage_bytes + self.capacity * sum(row_bytes.values())
        limit = self._memory_limit()
        if limit is not None and projected > limit:
            # the state before the fallback exists (get_state delegates after)
            prior = self.get_state() if self._store else None
            self._host = self._make_host_fallback()
            self._reset_storage()
            if prior is not None:
                # a later column tipped the projection over: the resident
                # rows move to the host ring
                self._host.set_state({k: prior[k] for k in ("cols", "idx", "size", "num_added")})
            return False
        for k, v in new_cols.items():
            row_shape, dtype = tuple(v.shape[1:]), _torch_dtype(v)
            packed = self._packable(row_shape, dtype)
            if packed:
                shape = (self.capacity, int(np.prod(row_shape)) // 4)
                ring = torch.zeros(shape, dtype=torch.int32, device=self.device)
            else:
                ring = torch.zeros((self.capacity,) + row_shape, dtype=dtype, device=self.device)
            self._store[k] = ring
            self._meta[k] = (row_shape, dtype, packed)
            self.storage_bytes += self.capacity * row_bytes[k]
        return True

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
        return len(self._host) if self._host is not None else self._size

    @property
    def num_added(self) -> int:
        return self._host.num_added if self._host is not None else self._num_added

    def add_device_tree(self, tree: Dict[str, Any]) -> None:
        """Insert a column tree (equal leading dims): one in-place
        scatter per column. Device rows (the rollout lane's) make no
        host copy; host arrays cross to the device once, here. A spilled
        buffer takes the rows into its host ring."""
        tree = {k: _canonical(v) for k, v in tree.items()}
        if not tree:
            return
        n = int(next(iter(tree.values())).shape[0])
        if n == 0:
            return
        if not self._ensure_storage(tree):
            self._host.add(SampleBatch(_host_columns(tree)))
            return
        tree = {k: self._to_device(v) for k, v in tree.items()}
        pos = torch.as_tensor(
            (self._idx + np.arange(n)) % self.capacity, device=self.device
        )
        self._scatter(tree, pos)
        self._idx = int((self._idx + n) % self.capacity)
        self._size = int(min(self._size + n, self.capacity))
        self._num_added += n
        telemetry_metrics.set_replay_occupancy(
            self.label, self._size, self.capacity, self.storage_bytes, device=True
        )

    def add_tree(self, tree: Dict[str, np.ndarray]) -> None:
        """Insert a host column tree (equal leading dims), the reference's
        host insert (QMIX's episode rows): the arrays cross to the device
        once, counted as ``replay_insert`` bytes, then one scatter a
        column (:meth:`add_device_tree`)."""
        tree = {k: _canonical(np.asarray(v)) for k, v in tree.items()}
        if tree and self._host is None and self.device.type == "cuda":
            telemetry_metrics.add_h2d_bytes("replay_insert", sum(v.nbytes for v in tree.values()))
        self.add_device_tree(tree)

    # -- sampling ---------------------------------------------------------

    def sample(self, num_items: int):
        """A :class:`DeviceTrainBatch`; a spilled buffer's host batch."""
        if self._host is not None:
            return self._host.sample(num_items)
        with tracing.start_span("replay:sample", n=num_items):
            idx = self._rng.integers(0, self._size, num_items)
            return self.gather(idx)

    def gather(self, idx) -> DeviceTrainBatch:
        """Rows at caller-chosen ring positions (host indices)."""
        idx = np.asarray(idx)
        idx_t = torch.as_tensor(idx.astype(np.int64), device=self.device)
        return DeviceTrainBatch(self._gather_columns(idx_t), len(idx), indices=idx)

    def stats(self) -> Dict:
        return {"size": len(self), "num_added": self.num_added,
                "device_resident": self._host is None, "storage_bytes": self.storage_bytes}

    # -- the superstep's feed ---------------------------------------------

    def draw_index_sets(self, k: int, num_items: int) -> np.ndarray:
        """(k, num_items) uniform draws: k sequential generator calls, as
        k ``sample`` calls make them (never one k·n call); spilled or
        not, since the spill ring shares the generator."""
        size = len(self)
        return np.stack([self._rng.integers(0, size, num_items) for _ in range(k)])

    def _feed(self, k_max: int, num_items: int, beta: Optional[float],
              host_weights: bool = False) -> SuperstepRingFeed:
        """The feed's static buffers, one set per (k_max, B, beta), so a
        captured slot reads the same memory on every superstep."""
        if self._host is not None:
            raise RuntimeError("superstep_feed on a spilled buffer: use the host stacked path")
        feeds = self.__dict__.setdefault("_feeds", {})
        key = (k_max, num_items, beta, host_weights, id(self._store))
        feed = feeds.get(key)
        if feed is None:
            feed = feeds[key] = SuperstepRingFeed(self, k_max, num_items, beta, host_weights)
        return feed

    def superstep_feed(self, k: int, k_max: int, num_items: int) -> SuperstepRingFeed:
        """The superstep's schedule: ``draw_index_sets(k, num_items)``,
        shipped in one copy into the feed's (k_max, B) buffer."""
        feed = self._feed(k_max, num_items, None)
        feed.idx[:k].copy_(torch.from_numpy(self.draw_index_sets(k, num_items)))
        return feed

    # -- checkpoint state (the reference's layout) --------------------------

    def get_state(self) -> Dict:
        if self._host is not None:
            return {**self._host.get_state(), "spilled": True}
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
        """Restore a state of either package, spilled or not. The whole
        ring is one scatter of ``capacity`` rows per column, into the
        ring tensors the buffer has when the columns match (so a
        superstep slot captured before the restore reads the restored
        rows), into new ones otherwise (which drops the feeds and their
        graphs). A state over this buffer's budget lands in the spill
        ring."""
        if state.get("spilled"):
            self._reset_storage()
            self._host = self._make_host_fallback()
            self._host.set_state(state)
            return
        self._host = None
        size = int(state["size"])
        full = {}
        for k, v in state["cols"].items():
            v = _canonical(np.asarray(v))
            ring = np.zeros((self.capacity,) + v.shape[1:], v.dtype)
            ring[:size] = v
            full[k] = ring
        same = set(full) == set(self._store) and all(
            self._meta[k][:2] == (tuple(v.shape[1:]), _torch_dtype(v)) for k, v in full.items()
        )
        if not same:
            self._reset_storage()
            if full and not self._ensure_storage(full):
                self._host.set_state(state)
                return
        if full:
            self._scatter({k: self._to_device(v) for k, v in full.items()},
                          torch.arange(self.capacity, device=self.device))
        self._idx = int(state["idx"])
        self._size = size
        self._num_added = int(state["num_added"])


class DevicePrioritizedReplayBuffer(_PrioritySampling, DeviceReplayBuffer):
    """Prioritized replay with the rows on the device, on one of the
    reference's two tree planes:

    - ``device_tree=True``: the priorities live in a
      :class:`DeviceSumTree`; a sample is draw → gather → weights on the
      device, and ``indices`` is a device int64 tensor that feeds the
      priority refresh directly. Only the alpha-power runs on the host
      (``powered_priorities``), as in the oracle, whose host trees draw
      the same rows from the same seed.
    - ``device_tree=False``: the sum and min trees and every priority
      write stay in the host code of :class:`_PrioritySampling`; a draw
      runs there and the drawn positions are gathered on the device
      (the row-gather kernel), beside the IS weights.

    A spill hands the rows and the priorities to a host
    :class:`PrioritizedReplayBuffer` (the device tree's leaves are read
    across once), which every later call goes to."""

    def __init__(
        self,
        capacity: int = 10000,
        alpha: float = 0.6,
        seed: Optional[int] = None,
        *,
        device=None,
        memory_cap_bytes: Optional[int] = None,
        label: str = DEFAULT_POLICY_ID,
        device_tree: bool = True,
    ):
        DeviceReplayBuffer.__init__(
            self, capacity, seed, device=device, memory_cap_bytes=memory_cap_bytes, label=label
        )
        self._init_priority_trees(capacity, alpha, host_trees=not device_tree)
        self._device_tree = bool(device_tree)
        self._dtree = DeviceSumTree(self._tree_capacity, self.device) if device_tree else None

    @property
    def tree_plane(self) -> str:
        """Which trees serve the draws now: "device" or "host"."""
        return "device" if self._dtree is not None and self._host is None else "host"

    def _make_host_fallback(self) -> ReplayBuffer:
        buf = PrioritizedReplayBuffer(self.capacity, self._alpha)
        buf._rng = self._rng
        if self._dtree is not None:
            buf._set_priority_state({"leaf_values": self._dtree.leaf_values(self._size),
                                     "max_priority": self._max_priority})
            self._dtree = None
        else:
            buf._sum_tree, buf._min_tree = self._sum_tree, self._min_tree
            buf._max_priority = self._max_priority
        return buf

    def update_priorities(self, idx, priorities: np.ndarray) -> None:
        """The host alpha-power, then the leaf write: on the device tree
        (``idx`` host indices or the device tensor a sample returned),
        the host trees, or the spill ring's."""
        if self._host is not None:
            return self._host.update_priorities(np.asarray(idx), priorities)
        if self._dtree is None:
            return _PrioritySampling.update_priorities(self, np.asarray(idx), priorities)
        powered, clamped = powered_priorities(priorities, self._alpha)
        self._dtree.set_powered(idx, powered)
        self._max_priority = max(self._max_priority, float(clamped.max()))
        telemetry_metrics.inc_tree_op("update", "device")

    def add_device_tree(self, tree: Dict[str, Any], priorities: Optional[np.ndarray] = None) -> None:
        """Insert with the host priority protocol: new rows enter the
        trees at the max priority (or the caller's)."""
        tree = dict(tree)
        if not tree:
            return
        n = int(next(iter(tree.values())).shape[0])
        if n == 0:
            return
        if self._host is not None:
            rows = SampleBatch(_host_columns({k: _canonical(v) for k, v in tree.items()}))
            if priorities is None:
                self._host.add(rows)
            else:
                self._host.add_with_priorities(rows, priorities)
            return
        if priorities is None:
            priorities = np.full(n, self._max_priority)
        idx = (self._idx + np.arange(n)) % self.capacity
        DeviceReplayBuffer.add_device_tree(self, tree)
        # (this insert may have spilled: update_priorities follows the rows)
        self.update_priorities(idx, np.asarray(priorities, np.float64))

    def sample(self, num_items: int, beta: float = 0.4):
        if self._host is not None:
            return self._host.sample(num_items, beta=beta)
        if self._dtree is None:
            idx, weights = self._draw_prioritized(num_items, beta)
            batch = self.gather(idx)
            batch.tree["weights"] = torch.from_numpy(weights).to(self.device)
            return batch
        telemetry_metrics.inc_tree_op("sample", "device")
        with tracing.start_span("replay:sample", n=num_items, tree="device"):
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
        """The superstep's schedule against the trees as they stand: k
        sequential ``random(num_items)`` calls (the per-update stream
        order) in one copy. Device tree: the uniforms and the frozen
        tree's total, largest IS weight and size; each slot's descent
        runs in the slot. Host trees: the k draws made on the host,
        positions and IS weights in one copy each."""
        if self._dtree is None:
            feed = self._feed(k_max, num_items, None, host_weights=True)
            idx, weights = self.draw_prioritized_sets(k, num_items, float(beta))
            feed.idx[:k].copy_(torch.from_numpy(idx))
            feed.weights[:k].copy_(torch.from_numpy(weights))
            return feed
        feed = self._feed(k_max, num_items, float(beta))
        telemetry_metrics.inc_tree_op("sample", "device", k)
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
        it) powered on the host, then the active updates' rows written in
        update order — the per-update ``update_priorities(idx[i], td[i] +
        1e-6)`` loop, whose repeated positions keep the last write; on
        the device tree as one stacked write."""
        rows = np.flatnonzero(np.asarray(active, bool))
        if not len(rows):
            return
        abs_td = np.asarray(abs_td)
        if self._dtree is None:
            host_idx = idx.cpu().numpy() if isinstance(idx, torch.Tensor) else np.asarray(idx)
            for i in rows:
                self.update_priorities(host_idx[i], abs_td[i] + 1e-6)
            return
        powered, clamped = powered_priorities(abs_td[rows] + 1e-6, self._alpha)
        self._dtree.set_powered(idx[torch.as_tensor(rows, device=idx.device)], powered)
        self._max_priority = max(self._max_priority, float(clamped.max()))
        telemetry_metrics.inc_tree_op("update", "device")

    def _priority_state(self) -> Dict:
        if self._dtree is None:
            return _PrioritySampling._priority_state(self)
        return {"leaf_values": self._dtree.leaf_values(self._size),
                "max_priority": self._max_priority}

    def _set_priority_state(self, state: Dict) -> None:
        if not self._device_tree:
            return _PrioritySampling._set_priority_state(self, state)
        if self._dtree is None:  # a spill dropped it
            self._dtree = DeviceSumTree(self._tree_capacity, self.device)
        self._dtree.set_leaf_values(state["leaf_values"])
        self._max_priority = float(state.get("max_priority", 1.0))

    def get_state(self) -> Dict:
        state = DeviceReplayBuffer.get_state(self)
        if self._host is None:
            state["priorities"] = self._priority_state()
        return state

    def set_state(self, state: Dict) -> None:
        """Either package's state, on either tree plane: the priorities
        are leaf values whichever trees wrote them."""
        DeviceReplayBuffer.set_state(self, state)
        if "priorities" in state and self._host is None:
            self._set_priority_state(state["priorities"])


class MultiAgentReplayBuffer:
    """Per-policy buffers, as the reference's: ``add`` of a
    ``MultiAgentBatch`` fills one ring per policy, each with the same
    ``seed``. ``sample`` returns ``{policy_id: batch}`` for every buffer
    holding at least ``num_items`` rows. ``device_resident`` (default)
    gives device rings, on the device tree under ``device_tree``;
    otherwise host rings, which take each policy batch as it is.
    ``replay_columns_fn(policy_id, SampleBatch) -> {column: array}``
    turns a host fragment into the columns the policy's learn call reads
    (``TorchPolicy.replay_columns``), once, at a device ring's insert."""

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
        device_resident: bool = True,
        device_tree: bool = True,
    ):
        self.capacity = capacity
        self.prioritized = prioritized
        self.alpha = alpha
        self.seed = seed
        self.device = device
        self.memory_cap_bytes = memory_cap_bytes
        self.replay_columns_fn = replay_columns_fn
        self.device_resident = device_resident
        self.device_tree = device_tree
        self.buffers: Dict[str, Any] = {}

    def _buffer(self, pid: str):
        if pid not in self.buffers:
            if self.device_resident:
                kwargs = dict(device=self.device, memory_cap_bytes=self.memory_cap_bytes, label=pid)
                if self.prioritized:
                    buf = DevicePrioritizedReplayBuffer(self.capacity, self.alpha, self.seed,
                                                        device_tree=self.device_tree, **kwargs)
                else:
                    buf = DeviceReplayBuffer(self.capacity, self.seed, **kwargs)
            elif self.prioritized:
                buf = PrioritizedReplayBuffer(self.capacity, self.alpha, self.seed)
            else:
                buf = ReplayBuffer(self.capacity, self.seed)
            self.buffers[pid] = buf
        return self.buffers[pid]

    def add_device_tree(self, tree: Dict[str, Any], policy_id: str = DEFAULT_POLICY_ID) -> None:
        buf = self._buffer(policy_id)
        if not isinstance(buf, DeviceReplayBuffer):
            raise TypeError("add_device_tree needs device rings (replay_device_resident)")
        buf.add_device_tree(tree)

    def add(self, batch, policy_id: str = DEFAULT_POLICY_ID) -> None:
        """A host fragment (the actor lane's). Device rings: its replay
        columns (the policy's, or every numeric column) cross to the
        device once each and land with one scatter per column
        (``add_device_tree``). Host rings: the batch as it is. A
        ``MultiAgentBatch`` goes policy batch by policy batch into each
        policy's ring."""
        if isinstance(batch, MultiAgentBatch):
            for pid, sb in batch.policy_batches.items():
                self.add(sb, pid)
            return
        buf = self._buffer(policy_id)
        if not isinstance(buf, DeviceReplayBuffer):
            buf.add(batch)
            return
        if self.replay_columns_fn is not None:
            tree = self.replay_columns_fn(policy_id, batch)
        else:
            tree = {
                k: np.asarray(v) for k, v in batch.items()
                if isinstance(v, np.ndarray) and v.dtype != object
            }
        buf.add_device_tree(tree)

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
