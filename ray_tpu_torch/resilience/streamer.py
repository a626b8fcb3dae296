"""Continuous checkpoint streaming: at most about one superstep of work
lost to a crash, without stopping the training loop for a save.

Counterpart of ``ray_tpu/resilience/streamer.py``. The reference's
capture takes references to the live parameter and optimizer trees,
which jax never changes in place, and pulls them to the host on its
writer thread. The port's Adam (and every graphed superstep) writes the
parameters and moments in place, so a reference would hand the writer a
state torn by the next update. The port's capture copies instead:

- **on the main thread, between training-step rounds**, every
  policy's ``get_state`` is read through a capturing reader: each device
  tensor it names (parameters, Adam ``mu``/``nu``, target networks, the
  aux step) is copied device-to-device, in stream order on the current
  stream, into a preallocated snapshot buffer, and a CUDA event is
  recorded after the copies; the host parts (Adam's count, coefficients,
  counters, filters, exploration state) are copied as they are. The
  learner thread of IMPALA and APPO issues its work on the same (the
  default) stream and updates the parameters under
  ``LearnerThread.lock``, so the capture holds that lock
  (``Algorithm._state_lock``) and lands between two of its steps;
- **on the writer thread**, the copy's stream waits on that event, the
  buffer comes into pinned host memory, and the payload (the reference's
  layout: ``superstep``, ``iteration``, ``counters``,
  ``episodes_total``, ``policy_states`` as ``get_state`` returns them,
  ``filters``) is written with ``atomic_write``, so the tail on disk is
  always a whole snapshot.

**Two buffers.** The reference keeps a depth-1 slot: a new capture
replaces one not yet written. Here a buffer that the writer is reading
is never written by a later capture: the capture takes the other
buffer, which holds at most a pending (unwritten) snapshot, and replaces
it. So the newest capture is never skipped, and the writer never reads
a buffer under a copy. Both buffers are made at the first capture.

The stream keeps the newest ``keep`` snapshots under
``<checkpoint_root>/stream/``; :meth:`latest` finds the tail and
:meth:`restore_into` loads it into an algorithm in place
(``set_state``), so the captured graphs, which read the parameters'
addresses, stay valid. ``stats()`` reports the capture's main-thread
milliseconds (and of them the wait for the state lock) and the lag in
supersteps.
"""

from __future__ import annotations

import collections
import os
import pickle
import threading
import time
from typing import Any, Dict, List, Optional

import torch

from ray_tpu_torch.telemetry import metrics as telemetry_metrics
from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.atomic_io import atomic_write


class _Captured:
    """A place in a captured state that the writer fills with the host
    copy of tensor ``index`` (an int when ``scalar``)."""

    __slots__ = ("index", "scalar")

    def __init__(self, index: int, scalar: bool):
        self.index = index
        self.scalar = scalar


class _CaptureReader:
    """The reader ``get_state(read=)`` is called with: it collects the
    tensors and returns placeholders."""

    def __init__(self):
        self.tensors: List[torch.Tensor] = []

    def __call__(self, t: torch.Tensor, scalar: bool = False) -> _Captured:
        self.tensors.append(t.detach())
        return _Captured(len(self.tensors) - 1, scalar)


def _fill(tree, arrays):
    """``tree`` with every placeholder replaced by its host value."""
    if isinstance(tree, _Captured):
        a = arrays[tree.index]
        return int(a) if tree.scalar else a
    if isinstance(tree, dict):
        return {k: _fill(v, arrays) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(v, arrays) for v in tree)
    return tree


class _Buffer:
    """One snapshot buffer: device copies of the captured tensors, their
    pinned host twins, the event after the copies, and the captured
    header. ``state``: free, capturing, pending or reading."""

    def __init__(self):
        self.state = "free"
        self.dev: List[torch.Tensor] = []
        self.host: List[torch.Tensor] = []
        self.event = None
        self.header: Optional[Dict[str, Any]] = None

    def fits(self, tensors: List[torch.Tensor]) -> bool:
        return len(tensors) == len(self.dev) and all(
            d.shape == t.shape and d.dtype == t.dtype and d.device == t.device
            for d, t in zip(self.dev, tensors)
        )

    def allocate(self, tensors: List[torch.Tensor]) -> None:
        self.dev = [torch.empty_like(t, memory_format=torch.contiguous_format) for t in tensors]
        self.host = [
            torch.empty(t.shape, dtype=t.dtype, pin_memory=True) if t.is_cuda else None
            for t in tensors
        ]

    def copy_from(self, tensors: List[torch.Tensor]) -> None:
        if not self.fits(tensors):
            self.allocate(tensors)
        with torch.no_grad():
            for d, t in zip(self.dev, tensors):
                d.copy_(t)
        if any(t.is_cuda for t in tensors):
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.event = None

    def pull(self, stream) -> List:
        """The host values of the copies (writer thread)."""
        if self.event is not None:
            stream.wait_event(self.event)
            with torch.cuda.stream(stream):
                for h, d in zip(self.host, self.dev):
                    if h is not None:
                        h.copy_(d, non_blocking=True)
            stream.synchronize()
        return [(h if h is not None else d).numpy() for h, d in zip(self.host, self.dev)]


class CheckpointStreamer:
    def __init__(self, algorithm, root: str, *, every: int = 1, keep: int = 2):
        self.algo = algorithm
        self.root = root
        self.every = max(1, int(every))
        self.keep = max(1, int(keep))
        os.makedirs(root, exist_ok=True)
        self._superstep = 0  # supersteps offered so far
        self._last_offered = 0
        self._last_written = 0
        self.num_snapshots = 0
        self.latest_path: Optional[str] = self.latest(root)
        self._buffers = [_Buffer(), _Buffer()]
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._stop = threading.Event()
        self._stream = None  # the writer's copy stream (made on first use)
        # the main thread's ms an offer that captured, and of them the
        # wait for the state lock (a learner thread's step in progress)
        self.capture_ms: "collections.deque" = collections.deque(maxlen=4096)
        self.lock_wait_ms: "collections.deque" = collections.deque(maxlen=4096)
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True, name="ckpt_streamer")
        self._thread.start()

    # -- the main thread ------------------------------------------------

    def offer(self) -> None:
        """End of a superstep (the main thread, between training-step
        rounds): count it and, every ``every`` supersteps, capture."""
        self._superstep += 1
        telemetry_metrics.set_stream_lag(self._superstep - self._last_written)
        if self._superstep - self._last_offered < self.every:
            return
        self._last_offered = self._superstep
        t0 = time.perf_counter()
        with self._lock:
            # a pending (unwritten) capture is replaced; the buffer under
            # the writer's pull is never touched
            buf = next((b for b in self._buffers if b.state == "pending"), None) or next(
                b for b in self._buffers if b.state == "free")
            buf.state = "capturing"
        try:
            with self.algo._state_lock():
                t_locked = time.perf_counter()
                header, tensors = self._capture()
                buf.copy_from(tensors)
            # the other buffer is made at the first capture too, so the
            # card's memory stays level from then on
            with self._lock:
                spare = [b for b in self._buffers if b.state == "free" and not b.fits(tensors)]
            for b in spare:
                b.allocate(tensors)
        except BaseException:
            with self._lock:
                buf.state = "free"
            raise
        buf.header = header
        with self._lock:
            buf.state = "pending"
            self._idle.clear()
        self._wake.set()
        t1 = time.perf_counter()
        self.capture_ms.append((t1 - t0) * 1e3)
        self.lock_wait_ms.append((t_locked - t0) * 1e3)

    def _capture(self):
        """The snapshot's header (placeholders where device tensors go)
        and the tensors it names; under the algorithm's state lock."""
        algo = self.algo
        reader = _CaptureReader()
        policies = {}
        for pid, pol in algo._policy_map().items():
            policies[pid] = pol.get_state(read=reader)
        lw = algo.workers.local_worker() if algo.workers is not None else None
        header = {
            "superstep": self._superstep,
            "iteration": algo.iteration,
            "counters": dict(algo._counters),
            "episodes_total": algo._episodes_total,
            "policy_states": policies,
            "filters": lw.get_filters() if lw is not None else {},
        }
        return header, reader.tensors

    def flush(self, timeout: float = 30.0) -> bool:
        """Wait until the writer has written the pending snapshot (tests
        and shutdown; the training loop never calls it)."""
        return self._idle.wait(timeout=timeout)

    def stats(self) -> Dict[str, Any]:
        ms, wait = list(self.capture_ms), list(self.lock_wait_ms)
        return {
            "supersteps": self._superstep,
            "snapshots_written": self.num_snapshots,
            "lag_supersteps": self._superstep - self._last_written,
            "latest": self.latest_path,
            "capture_ms_mean": sum(ms) / len(ms) if ms else 0.0,
            "capture_ms_last": ms[-1] if ms else 0.0,
            "lock_wait_ms_mean": sum(wait) / len(wait) if wait else 0.0,
        }

    def stop(self, join_timeout: float = 30.0) -> None:
        """Write the pending snapshot, then end the writer thread."""
        self._stop.set()
        self._wake.set()
        if self._thread.is_alive():
            self._thread.join(timeout=join_timeout)

    # -- the writer thread --------------------------------------------------

    def _run(self) -> None:
        try:
            while True:
                self._wake.wait()
                self._wake.clear()
                self._write_pending()
                if self._stop.is_set():
                    return
        except BaseException as e:
            self.error = e
            self._idle.set()

    def _write_pending(self) -> None:
        with self._lock:
            buf = next((b for b in self._buffers if b.state == "pending"), None)
            if buf is None:
                self._idle.set()
                return
            buf.state = "reading"
        try:
            if buf.event is not None and self._stream is None:
                self._stream = torch.cuda.Stream(buf.dev[0].device)
            header = buf.header
            with tracing.start_span("stream:snapshot", superstep=header["superstep"]):
                payload = _fill(header, buf.pull(self._stream))
                path = os.path.join(self.root, f"snapshot_{header['superstep']:010d}.pkl")
                atomic_write(path, lambda f: pickle.dump(payload, f))
        finally:
            with self._lock:
                buf.state = "free"
        self.latest_path = path
        self._last_written = header["superstep"]
        self.num_snapshots += 1
        telemetry_metrics.inc_stream_snapshots()
        telemetry_metrics.set_stream_lag(self._superstep - self._last_written)
        self._prune()
        with self._lock:
            if not any(b.state in ("pending", "capturing") for b in self._buffers):
                self._idle.set()
            else:
                self._wake.set()

    def _prune(self) -> None:
        try:
            snaps = sorted(f for f in os.listdir(self.root)
                           if f.startswith("snapshot_") and f.endswith(".pkl"))
        except OSError:
            return
        for f in snaps[: max(0, len(snaps) - self.keep)]:
            try:
                os.unlink(os.path.join(self.root, f))
            except OSError:
                pass

    # -- the restore side ---------------------------------------------------

    @staticmethod
    def stream_root(checkpoint_root: str) -> str:
        return os.path.join(checkpoint_root, "stream")

    @staticmethod
    def latest(root: str) -> Optional[str]:
        """The newest whole snapshot in ``root`` (zero-padded superstep
        names sort by age), or None."""
        if not root or not os.path.isdir(root):
            return None
        snaps = sorted(f for f in os.listdir(root) if f.startswith("snapshot_") and f.endswith(".pkl"))
        return os.path.join(root, snaps[-1]) if snaps else None

    @staticmethod
    def peek(path: str) -> Dict[str, Any]:
        """A snapshot's iteration and superstep, without restoring it."""
        with open(path, "rb") as f:
            payload = pickle.load(f)
        return {"superstep": payload.get("superstep", 0), "iteration": payload.get("iteration", 0)}

    @staticmethod
    def restore_into(algorithm, path: str) -> int:
        """Load the snapshot at ``path`` into ``algorithm``; returns its
        superstep."""
        with open(path, "rb") as f:
            payload = pickle.load(f)
        return load_payload(algorithm, payload)


def load_payload(algorithm, payload: Dict[str, Any]) -> int:
    """A stream payload into ``algorithm`` in place: each policy's
    ``set_state`` (the tensors keep their addresses, so captured graphs
    stay valid), the filters, the counters, the episode total and the
    iteration, under the algorithm's state lock; then the restored
    weights to the remote workers. Returns the payload's superstep."""
    policies = algorithm._policy_map()
    with algorithm._state_lock():
        for pid, state in payload.get("policy_states", {}).items():
            if pid in policies:
                policies[pid].set_state(state)
        if algorithm.workers is not None:
            algorithm.workers.local_worker().sync_filters(payload.get("filters", {}))
        algorithm._counters = collections.defaultdict(int, payload.get("counters", {}))
        algorithm._episodes_total = payload.get("episodes_total", 0)
        algorithm._iteration = payload.get("iteration", algorithm._iteration)
    if algorithm.workers is not None:
        algorithm.workers.sync_weights()
    return int(payload.get("superstep", 0))
