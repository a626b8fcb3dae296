"""The asynchronous learner thread of the actor-learner algorithms.

Counterpart of ``ray_tpu/execution/learner_thread.py``. Rollout batches
queue in (``add_batch``) from the main thread's worker polls; the thread
learns on them and queues ``(env_steps, stats)`` out. For a
:class:`TorchPolicy` that keeps the base ``learn_on_batch`` the path
has two phases: ``prepare_batch`` on this thread, the copy to the card
on a :class:`DeviceFeeder` (pinned memory, its own stream), then
``learn_on_device_batch`` here, with up to ``PIPELINE_DEPTH`` batches
copied ahead. The thread issues its CUDA work from its own thread, on
its current stream, which the feeder's event orders after each copy.

- **Deferred stats.** When the policy keeps the base
  ``after_learn_on_batch`` (no host coefficient update between steps),
  a learn call returns its stats still on the card
  (``defer_stats=True``) and the thread materializes them
  ``STATS_LAG`` steps later, when they have long arrived.
- **Weight publishing.** Every ``publish_weights_every`` steps the
  thread copies the weights off the card (``get_weights``) into a
  versioned slot, which the main thread broadcasts to the workers without
  touching the device.
- **The step lock.** :attr:`lock` is held across each learn call and
  weight publish. Another thread that reads or writes the policy's
  parameters holds it too, and so acts between two steps: the port's
  Adam updates the parameters in place (the reference's arrays are
  immutable), so an unlocked copy could tear mid-step (APPO's target
  refresh; IMPALA's ``num_workers: 0`` sampling on the learner's own
  policy).

- **The fused superstep.** With deferred stats and a policy that keeps
  the base learn composition (``supports_superstep``: IMPALA's and
  APPO's), ``config["superstep"]`` K > 1 (``"auto"``: 8 on the card)
  fuses up to K queued batches: each is trimmed on the host to the
  fixed-row contract (:meth:`_trim_fixed`: ``train_batch_size`` rows,
  or unrolls for the IMPALA family), K of them are stacked on this
  thread's stream (which waits on the feeder's event for each) and
  learned by one ``learn_superstep`` call, one CUDA graph replayed K
  times, with one stats drain. A starved or ragged collection learns
  what it gathered one update at a time. A frame-pool batch (per-batch
  pool sizes) demotes the thread to K = 1 for good, as the reference's.

A policy that overrides ``learn_on_batch`` learns through it, one batch
at a time (:meth:`_step_sync`), the reference's dispatch rule.

The fault injector of the policy's config counts the thread's steps
(``crash_learner_thread``); the exception ends the thread and parks in
:attr:`error`, and IMPALA's recovery builds a new thread. The feeder
goes with the thread that made it: its pinned staging buffers and copy
stream are released when the thread ends (:meth:`run`), so a rebuilt
thread starts a feeder of its own.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Dict, Optional, Tuple

import torch

from ray_tpu_torch.execution.device_feed import DeviceFeeder
from ray_tpu_torch.ops.framestack import FRAMES
from ray_tpu_torch.policy.torch_policy import CHUNK, TorchPolicy
from ray_tpu_torch.resilience import faults
from ray_tpu_torch.sharding.superstep import resolve_superstep

# batches copied ahead of the learn call (2: double buffering)
PIPELINE_DEPTH = 2
# learn calls whose stats may still be on the card before the thread
# materializes the oldest (each also pins its batch on the device)
STATS_LAG = 3
SPANS_KEPT = 4096
# seconds a fused collection waits for a batch already on its way
COLLECT_TIMEOUT_S = 10.0


class LearnerThread(threading.Thread):
    def __init__(
        self,
        policy,
        *,
        inqueue_size: int = 16,
        outqueue_size: int = 64,
        publish_weights_every: int = 0,
    ):
        super().__init__(daemon=True, name="learner_thread")
        self.policy = policy
        self.inqueue: "queue.Queue" = queue.Queue(maxsize=inqueue_size)
        self.outqueue: "queue.Queue" = queue.Queue(maxsize=outqueue_size)
        self.stopped = False
        self.num_steps = 0
        self.learner_info: Dict = {}
        self.queue_timer = 0.0
        self.grad_timer = 0.0
        self.publish_timer = 0.0
        # seconds a step waited for :attr:`lock` (another thread held it)
        self.lock_wait_timer = 0.0
        # (start, end) perf_counter seconds of the latest learn calls, to
        # set beside what other threads did meanwhile
        self.step_spans: "collections.deque" = collections.deque(maxlen=SPANS_KEPT)
        self.lock = threading.Lock()
        self._pipelined = isinstance(policy, TorchPolicy) and (
            type(policy).learn_on_batch is TorchPolicy.learn_on_batch
        )
        self._defer = self._pipelined and (
            type(policy).after_learn_on_batch is TorchPolicy.after_learn_on_batch
        )
        # K of the fused superstep (1: one update a step)
        self._superstep_k = 1
        if self._defer and getattr(policy, "supports_superstep", False):
            self._superstep_k = resolve_superstep(policy.config, policy.device)
        self._depth = max(PIPELINE_DEPTH, self._superstep_k)
        self.num_supersteps = 0  # fused supersteps taken (each K updates)
        self._feeder: Optional[DeviceFeeder] = None
        self._in_flight = 0
        self._lazy: "collections.deque" = collections.deque()
        self._publish_every = int(publish_weights_every)
        self._weights_lock = threading.Lock()
        self._published: Optional[Tuple[int, Dict]] = None
        self._steps_since_publish = 0
        # an exception of the thread parks here (healthy() turns False);
        # the fault injector can raise one on a chosen step
        self.error: Optional[BaseException] = None
        self._fault_injector = faults.from_config(policy.config)

    @property
    def feeder(self) -> Optional[DeviceFeeder]:
        return self._feeder

    def _get_feeder(self) -> DeviceFeeder:
        # built on this thread, on first use
        if self._feeder is None:
            self._feeder = DeviceFeeder(self.policy.device, capacity=self._depth)
        return self._feeder

    def _trim_fixed(self, tree: Dict, bsize: int) -> Tuple[Dict, int]:
        """The fixed-row contract of a stacked superstep (the reference's
        ``_trim_fixed``): a prepared host tree trimmed to the largest
        multiple of the policy's unroll length at or under the config's
        train batch (in rows, or in unrolls for the IMPALA family, whose
        rows are whole ``unroll_len``-step unrolls), so that queued
        batches share one shape. A frame-pool tree demotes the thread to
        K = 1 instead."""
        if FRAMES in tree:
            self._superstep_k = 1
            return tree, bsize
        policy = self.policy
        target = int(policy.config.get("train_batch_size", bsize))
        frag_t = int(getattr(policy, "unroll_len", 0) or 0)
        rows_target = target // frag_t if frag_t else target
        T = max(1, int(getattr(policy, "_unroll_T", 1)))
        fixed = (rows_target // T) * T
        if fixed <= 0 or bsize <= fixed:
            return tree, bsize
        return {c: v[: fixed // T] if c.startswith(CHUNK) else v[:fixed]
                for c, v in tree.items()}, fixed

    def run(self) -> None:
        try:
            while not self.stopped:
                try:
                    self.step()
                except queue.Empty:
                    # idle: everything queued on the card has finished
                    self._drain_lazy(all_of_them=True)
            self._drain_lazy(all_of_them=True)
        except BaseException as e:  # surfaced through healthy() and error
            self.error = e
        finally:
            # the thread owns the feeder: stopping it here, not in stop()
            # on another thread, cannot race a _pump in progress
            if self._feeder is not None:
                self._feeder.stop()

    def _pump(self, block: bool) -> bool:
        """One host batch from the inqueue to the feeder; True if moved."""
        batch = self.inqueue.get(timeout=0.5) if block else self.inqueue.get_nowait()
        if batch is None:
            self.stopped = True
            return False
        tree, bsize = self.policy.prepare_batch(batch)
        if self._superstep_k > 1:
            tree, bsize = self._trim_fixed(tree, bsize)
        self._get_feeder().put(tree, (bsize, batch.env_steps()))
        self._in_flight += 1
        return True

    def _drain_lazy(self, all_of_them: bool = False) -> None:
        """Materialize the deferred stats older than ``STATS_LAG`` steps."""
        keep = 0 if all_of_them else STATS_LAG
        while len(self._lazy) > keep:
            env_steps, stats = self._lazy.popleft()
            info = stats.result()
            self.learner_info = info
            try:
                self.outqueue.put_nowait((env_steps, info))
            except queue.Full:
                pass

    def _maybe_publish(self, steps: int = 1) -> None:
        """Called with :attr:`lock` held, after ``steps`` updates."""
        if not self._publish_every:
            return
        self._steps_since_publish += steps
        if self._steps_since_publish < self._publish_every:
            return
        self.publish()

    def publish(self) -> int:
        """Publish the policy's weights now, as a new version; returns
        it. Called with :attr:`lock` held (by this thread between steps,
        or by a thread that just wrote the weights: a restore)."""
        t0 = time.perf_counter()
        host_w = self.policy.get_weights()
        with self._weights_lock:
            ver = (self._published[0] if self._published else 0) + 1
            self._published = (ver, host_w)
        self._steps_since_publish = 0
        self.publish_timer += time.perf_counter() - t0
        return ver

    def published_weights(self) -> Optional[Tuple[int, Dict]]:
        """The latest ``(version, host weights)`` this thread published,
        or None before the first. Touches no device."""
        with self._weights_lock:
            return self._published

    def healthy(self) -> bool:
        """False once the thread died; the exception is in :attr:`error`."""
        return self.error is None and self.is_alive()

    def step(self) -> None:
        if self._fault_injector is not None:
            self._fault_injector.on_learner_thread_step()
        if not self._pipelined:
            return self._step_sync()
        t0 = time.perf_counter()
        # top up the copy pipeline; block only when nothing is in flight
        if self._in_flight == 0 and not self._pump(block=True):
            return
        self._top_up()
        try:
            dev, (bsize, env_steps) = self._feeder.get()
        finally:
            # a failed copy still used its slot
            self._in_flight -= 1
        if self._defer and self._superstep_k > 1 and FRAMES not in dev:
            return self._step_superstep([(dev, bsize, env_steps)], t0)
        self.queue_timer += time.perf_counter() - t0
        t_wait = time.perf_counter()
        with self.lock:
            # the grad time starts once the lock is held, as the
            # reference's covers the learn call alone; the wait for the
            # lock is a stat of its own
            t0 = time.perf_counter()
            self.lock_wait_timer += t0 - t_wait
            if self._defer:
                self._lazy.append((env_steps, self.policy.learn_on_device_batch(
                    dev, bsize, defer_stats=True)))
            else:
                info = self.policy.learn_on_device_batch(dev, bsize)
            # the grad time stops before the publish, as the reference's
            t1 = time.perf_counter()
            self.num_steps += 1
            self._maybe_publish()
        self.grad_timer += t1 - t0
        self.step_spans.append((t0, t1))
        if self._defer:
            self._drain_lazy()
            return
        self.learner_info = info
        try:
            self.outqueue.put_nowait((env_steps, info))
        except queue.Full:
            pass

    def _top_up(self) -> None:
        """Pump queued batches to the feeder, without blocking, up to the
        pipeline's depth."""
        while self._in_flight < self._depth:
            try:
                if not self._pump(block=False):
                    break
            except queue.Empty:
                break

    def _step_superstep(self, batches, t0: float) -> None:
        """Up to K device batches, the first given: the ones already on
        their way to the card are collected (none is waited for that is
        not); K batches of one size are stacked and learned by one
        ``learn_superstep`` call, and each update's stats go out in
        order; a starved or ragged collection learns its batches one at a
        time, with deferred stats. The collection's wait counts as queue
        wait."""
        k_sup = self._superstep_k
        while len(batches) < k_sup:
            self._top_up()
            if self._in_flight <= 0:
                break
            try:
                dev, (bsize, env_steps) = self._feeder.get(timeout=COLLECT_TIMEOUT_S)
            except queue.Empty:
                break
            except BaseException:
                self._in_flight -= 1  # a failed copy still used its slot
                raise
            self._in_flight -= 1
            batches.append((dev, bsize, env_steps))
        self.queue_timer += time.perf_counter() - t0
        fused = len(batches) == k_sup and len({b for _, b, _ in batches}) == 1
        t_wait = time.perf_counter()
        with self.lock:
            t0 = time.perf_counter()
            self.lock_wait_timer += t0 - t_wait
            if fused:
                # on this thread's stream, which waited on each copy's event
                stacked = {c: torch.stack([d[c] for d, _, _ in batches]) for c in batches[0][0]}
                infos, _, _ = self.policy.learn_superstep(
                    k_sup, batches[0][1], stacked=stacked, k_max=k_sup)
            else:
                for dev, bsize, env_steps in batches:
                    self._lazy.append((env_steps, self.policy.learn_on_device_batch(
                        dev, bsize, defer_stats=True)))
            t1 = time.perf_counter()
            self.num_steps += len(batches)
            self._maybe_publish(steps=len(batches))
        self.grad_timer += t1 - t0
        self.step_spans.append((t0, t1))
        if not fused:
            self._drain_lazy()
            return
        self.num_supersteps += 1
        # earlier updates' stats first, so the outqueue keeps update order
        self._drain_lazy(all_of_them=True)
        for (_, _, env_steps), info in zip(batches, infos):
            self.learner_info = info
            try:
                self.outqueue.put_nowait((env_steps, info))
            except queue.Full:
                pass

    def _step_sync(self) -> None:
        """The policy's own ``learn_on_batch`` on one batch."""
        t0 = time.perf_counter()
        batch = self.inqueue.get(timeout=0.5)
        self.queue_timer += time.perf_counter() - t0
        if batch is None:
            self.stopped = True
            return
        t_wait = time.perf_counter()
        with self.lock:
            t0 = time.perf_counter()
            self.lock_wait_timer += t0 - t_wait
            info = self.policy.learn_on_batch(batch)
            self.grad_timer += time.perf_counter() - t0
            self.num_steps += 1
            self._maybe_publish()
        self.learner_info = info
        try:
            self.outqueue.put_nowait((batch.env_steps(), info))
        except queue.Full:
            pass

    def add_batch(self, batch, block: bool = True) -> bool:
        """Queue a rollout batch; False if it was dropped (queue full)."""
        try:
            self.inqueue.put(batch, block=block, timeout=5.0)
            return True
        except queue.Full:
            return False

    def stop(self, join_timeout: float = 30.0) -> None:
        self.stopped = True
        try:
            self.inqueue.put_nowait(None)
        except queue.Full:
            pass
        # join before the interpreter's teardown: a daemon thread killed
        # inside a CUDA call can abort the process
        if self.is_alive() and threading.current_thread() is not self:
            self.join(timeout=join_timeout)

    def stats(self) -> Dict:
        return {
            "learner_queue_size": self.inqueue.qsize(),
            "num_steps_trained_this_thread": self.num_steps,
            "queue_wait_time_s": self.queue_timer,
            "grad_time_s": self.grad_timer,
            "lock_wait_time_s": self.lock_wait_timer,
            "weight_publish_time_s": self.publish_timer,
        }
