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

A policy that overrides ``learn_on_batch`` learns through it, one batch
at a time (:meth:`_step_sync`), the reference's dispatch rule. The
superstep fusion of queued batches (``_step_superstep``) is not ported
(``ROADMAP.md`` queue 1 item 5): an explicit ``superstep`` above 1
raises; ``"auto"`` runs one update a step, which is what the reference
does with every frame-pool batch.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Dict, Optional, Tuple

from ray_tpu_torch.execution.device_feed import DeviceFeeder
from ray_tpu_torch.policy.torch_policy import TorchPolicy
from ray_tpu_torch.sharding.superstep import resolve_superstep

# batches copied ahead of the learn call (2: double buffering)
PIPELINE_DEPTH = 2
# learn calls whose stats may still be on the card before the thread
# materializes the oldest (each also pins its batch on the device)
STATS_LAG = 3
SPANS_KEPT = 4096

FUSION_WHERE = "on the learner thread (fusing queued batches)"
FUSION_ITEM = "ROADMAP.md queue 1 item 5"


def refuse_fused_superstep(config: Dict, where: str, item: str) -> None:
    """Raise for an explicit ``superstep`` K > 1 on a path that has no
    fused K-update step yet (``where``; ``item``: its ROADMAP.md item);
    ``"auto"`` there means one update a step."""
    mode = config.get("superstep", "auto")
    if mode != "auto" and resolve_superstep(config) > 1:
        raise NotImplementedError(f"superstep={mode!r} {where} is not ported yet: {item}")


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
        refuse_fused_superstep(getattr(policy, "config", None) or {}, FUSION_WHERE, FUSION_ITEM)
        self.policy = policy
        self.inqueue: "queue.Queue" = queue.Queue(maxsize=inqueue_size)
        self.outqueue: "queue.Queue" = queue.Queue(maxsize=outqueue_size)
        self.stopped = False
        self.num_steps = 0
        self.learner_info: Dict = {}
        self.queue_timer = 0.0
        self.grad_timer = 0.0
        self.publish_timer = 0.0
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
        self._feeder: Optional[DeviceFeeder] = None
        self._in_flight = 0
        self._lazy: "collections.deque" = collections.deque()
        self._publish_every = int(publish_weights_every)
        self._weights_lock = threading.Lock()
        self._published: Optional[Tuple[int, Dict]] = None
        self._steps_since_publish = 0
        self.error: Optional[BaseException] = None

    @property
    def feeder(self) -> Optional[DeviceFeeder]:
        return self._feeder

    def _get_feeder(self) -> DeviceFeeder:
        # built on this thread, on first use
        if self._feeder is None:
            self._feeder = DeviceFeeder(self.policy.device, capacity=PIPELINE_DEPTH)
        return self._feeder

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

    def _maybe_publish(self) -> None:
        """Called with :attr:`lock` held."""
        if not self._publish_every:
            return
        self._steps_since_publish += 1
        if self._steps_since_publish < self._publish_every:
            return
        t0 = time.perf_counter()
        host_w = self.policy.get_weights()
        with self._weights_lock:
            ver = (self._published[0] if self._published else 0) + 1
            self._published = (ver, host_w)
        self._steps_since_publish = 0
        self.publish_timer += time.perf_counter() - t0

    def published_weights(self) -> Optional[Tuple[int, Dict]]:
        """The latest ``(version, host weights)`` this thread published,
        or None before the first. Touches no device."""
        with self._weights_lock:
            return self._published

    def healthy(self) -> bool:
        """False once the thread died; the exception is in :attr:`error`."""
        return self.error is None and self.is_alive()

    def step(self) -> None:
        if not self._pipelined:
            return self._step_sync()
        t0 = time.perf_counter()
        # top up the copy pipeline; block only when nothing is in flight
        if self._in_flight == 0 and not self._pump(block=True):
            return
        while self._in_flight < PIPELINE_DEPTH:
            try:
                if not self._pump(block=False):
                    break
            except queue.Empty:
                break
        try:
            dev, (bsize, env_steps) = self._feeder.get()
        finally:
            # a failed copy still used its slot
            self._in_flight -= 1
        self.queue_timer += time.perf_counter() - t0
        t0 = time.perf_counter()
        with self.lock:
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

    def _step_sync(self) -> None:
        """The policy's own ``learn_on_batch`` on one batch."""
        t0 = time.perf_counter()
        batch = self.inqueue.get(timeout=0.5)
        self.queue_timer += time.perf_counter() - t0
        if batch is None:
            self.stopped = True
            return
        t0 = time.perf_counter()
        with self.lock:
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
            "weight_publish_time_s": self.publish_timer,
        }
