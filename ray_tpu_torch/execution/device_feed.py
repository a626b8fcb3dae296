"""Asynchronous host-to-device batch feeding (double buffering).

Counterpart of ``ray_tpu/execution/device_feed.py``: a feeder thread
moves host trees (dicts of numpy arrays) onto the learner's device, so
that the copy of batch k + 1 overlaps the SGD nest of batch k.

On CUDA each array is staged in pinned host memory and copied with
``non_blocking=True`` on the feeder's own ``torch.cuda.Stream``; an
event is recorded after the copies. The feeder thread waits for that
event before it hands the batch on, which times the copy and lets the
pinned staging tensors go only once the card has read them. :meth:`get`
makes the consumer's current stream wait on the event and calls
``record_stream`` on every tensor for that stream, so the caching
allocator does not hand the memory of a batch the consumer still reads
back to the feeder's stream. On the CPU the thread makes tensors of the
arrays, with no stream and no pinning.

Stop semantics are the reference's: :meth:`put` blocks while the
pipeline is full and raises once the feeder is stopped (also when
:meth:`stop` lands while it blocks); :meth:`stop` is idempotent, clears
a full inqueue to deliver its sentinel, keeps the outqueue draining so
a thread parked on it reaches the sentinel, and joins with a timeout.

:attr:`copies` keeps each batch's ``bytes``, ``copy_s`` (host clock,
pinning and copy, to the event) and on CUDA ``h2d_ms`` (the copy's
device time by CUDA events), for the last ``STATS_KEPT`` batches.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.telemetry import metrics as telemetry_metrics
from ray_tpu_torch.util import tracing
from ray_tpu_torch.utils.metrics import timer_histogram

STATS_KEPT = 64


class DeviceFeeder:
    def __init__(self, device, capacity: int = 2):
        self.device = torch.device(device)
        self._in: "queue.Queue" = queue.Queue(maxsize=capacity)
        self._out: "queue.Queue" = queue.Queue(maxsize=capacity)
        self._stopped = False
        # guards the stopped flag against a concurrent put(): without it
        # a producer racing stop() could block for good on a full inqueue
        # whose consumer thread has already exited
        self._lock = threading.Lock()
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self.copies: "collections.deque" = collections.deque(maxlen=STATS_KEPT)
        self.num_batches = 0
        self.bytes_total = 0
        self._thread = threading.Thread(target=self._run, daemon=True, name="device_feeder")
        self._thread.start()

    # -- the feeder thread -----------------------------------------------

    def _to_device(self, host: Dict[str, np.ndarray]):
        """The tree on the device and the event after its copies (None
        on the CPU); blocks this thread until the copies are done."""
        nbytes = int(sum(np.asarray(v).nbytes for v in host.values()))
        telemetry_metrics.add_h2d_bytes("feeder", nbytes)
        # nbytes on the span: the timeline's transfer lane and the
        # report CLI read each transfer's payload off it
        with tracing.start_span("feeder:transfer", nbytes=nbytes):
            return self._copy(host, nbytes)

    def _copy(self, host: Dict[str, np.ndarray], nbytes: int):
        t0 = time.perf_counter()
        if self._stream is None:
            dev = {k: torch.as_tensor(np.asarray(v)) for k, v in host.items()}
            self._record(nbytes, time.perf_counter() - t0, None)
            return dev, None
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self._stream):
            pinned = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                      for k, v in host.items()}
            start.record(self._stream)
            dev = {k: p.to(self.device, non_blocking=True) for k, p in pinned.items()}
            done.record(self._stream)
        # the pinned tensors stay referenced until the card has read them
        done.synchronize()
        del pinned
        self._record(nbytes, time.perf_counter() - t0, start.elapsed_time(done))
        return dev, done

    def _record(self, nbytes: int, copy_s: float, h2d_ms: Optional[float]) -> None:
        # the sync path's transfer series (TorchPolicy.learn_on_batch)
        timer_histogram("ray_tpu_learner_transfer_seconds").observe(copy_s)
        entry = {"bytes": nbytes, "copy_s": copy_s}
        if h2d_ms is not None:
            entry["h2d_ms"] = h2d_ms
        self.copies.append(entry)
        self.num_batches += 1
        self.bytes_total += nbytes

    def _run(self) -> None:
        while True:
            # queue wait against transfer: two spans on this thread's
            # lane show whether the feeder starved or moved bytes
            t_wait0 = time.time()
            item = self._in.get()
            tracing.record_span("feeder:queue_wait", t_wait0, time.time())
            if item is None:
                return
            host, meta = item
            telemetry_metrics.set_queue_depth("feeder_in", self._in.qsize())
            try:
                out = (*self._to_device(host), meta)
            except Exception as e:  # surfaced to the consumer, meta intact
                out = (e, None, meta)
            # a bounded put that stays responsive to stop(): a consumer
            # that is gone must not wedge this thread on a full outqueue
            while True:
                with self._lock:
                    if self._stopped:
                        return
                try:
                    self._out.put(out, timeout=0.1)
                    break
                except queue.Full:
                    continue

    # -- producer and consumer -------------------------------------------

    def put(self, host_batch: Dict[str, np.ndarray], meta: Any = None) -> None:
        """Enqueue a host tree for its copy; ``meta`` rides along. Blocks
        while the pipeline is full; raises once the feeder is stopped,
        also when stop() lands while this call blocks."""
        while True:
            # check and insert under one lock: once stop() sets the flag
            # no item slips in behind the drain and the sentinel
            with self._lock:
                if self._stopped:
                    raise RuntimeError("feeder stopped")
                try:
                    self._in.put_nowait((host_batch, meta))
                    return
                except queue.Full:
                    pass
            time.sleep(0.01)

    def get(self, timeout: Optional[float] = None):
        """The next ``(device_tree, meta)`` (blocking), ready for the
        calling thread's current stream. Raises the copy's error if
        that batch failed (``queue.Empty`` after ``timeout``)."""
        dev, event, meta = self._out.get(timeout=timeout)
        telemetry_metrics.set_queue_depth("feeder_out", self._out.qsize())
        if isinstance(dev, Exception):
            raise dev
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in dev.values():
                t.record_stream(consumer)
        return dev, meta

    def qsize(self) -> int:
        return self._out.qsize()

    @staticmethod
    def _drain(q: "queue.Queue") -> None:
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                return

    def stop(self, join_timeout: float = 10.0) -> None:
        """Idempotent shutdown: refuse new puts, deliver the sentinel
        through a full inqueue, keep both queues draining so a blocked
        thread reaches it, and join with a timeout."""
        with self._lock:
            self._stopped = True
        while True:
            try:
                self._in.put_nowait(None)
                break
            except queue.Full:
                self._drain(self._in)
        deadline = time.monotonic() + join_timeout
        while self._thread.is_alive() and time.monotonic() < deadline:
            self._drain(self._out)
            self._thread.join(timeout=0.1)
        self._drain(self._in)
        self._drain(self._out)
