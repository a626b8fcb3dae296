"""The port's actor runtime (``ray_tpu_torch/core``), on the CPU.

The cases of ``tests/test_core.py`` that the ported subset covers, run
against the port's runtime: put/get of small and large numpy, tasks
(numpy in and out above the 256 KB inline limit, ref chaining, many in
parallel), exceptions from tasks and actor methods, ``wait`` and its
timeout, actor state and call ordering, ``kill``, and the weight
broadcast of one ``put`` read by several actors. Remote functions and
classes sit at the module's top level: the runtime sends them by name.

Besides: a spawned worker hides the card (``CUDA_VISIBLE_DEVICES=""``)
and has not initialized CUDA; shared-memory segments go away when their
receiver has read them or their last ref is dropped; and ``shutdown``
leaves no worker process and no segment. The module starts one runtime
(two task workers) and the last test shuts it down.
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np
import pytest

from ray_tpu_torch import core as ray
from ray_tpu_torch.core import api, object_store


@ray.remote
def add(a, b):
    return a + b


@ray.remote
def double(x):
    return x * 2


@ray.remote
def inc(x):
    return x + 1


@ray.remote
def square(i):
    return i * i


@ray.remote
def boom():
    raise ValueError("bad")


@ray.remote
def sleep_then(seconds, value):
    time.sleep(seconds)
    return value


@ray.remote
def device_state():
    import torch

    return os.environ.get("CUDA_VISIBLE_DEVICES"), torch.cuda.is_initialized()


@ray.remote
class Counter:
    def __init__(self, start=0):
        self.n = start
        self.log = []

    def inc(self, k=1):
        self.n += k
        return self.n

    def append(self, x):
        self.log.append(x)

    def get_log(self):
        return self.log

    def boom(self):
        raise RuntimeError("actor boom")

    def read_sum(self, w):
        return float(sum(v.sum() for v in w.values()))


@pytest.fixture(scope="module")
def rt():
    ray.shutdown()
    ray.init(num_cpus=2)
    yield api._runtime
    ray.shutdown()


@pytest.mark.parametrize("value", [42, {"a": [1, 2]}, np.arange(10, dtype=np.int64),
                                   np.arange(1_000_000, dtype=np.float32)],
                         ids=["int", "dict", "small_numpy", "large_numpy"])
def test_put_get(rt, value):
    got = ray.get(ray.put(value))
    if isinstance(value, np.ndarray):
        np.testing.assert_array_equal(got, value)
        assert got.dtype == value.dtype and got.flags.writeable
    else:
        assert got == value


@pytest.mark.parametrize("case", ["simple", "numpy_ref_arg", "numpy_large_arg", "chaining", "parallel"])
def test_tasks(rt, case):
    x = np.ones((512, 512), np.float32)  # 1 MiB: above the inline limit
    if case == "simple":
        assert ray.get(add.remote(1, 2)) == 3
    elif case == "numpy_ref_arg":
        np.testing.assert_array_equal(ray.get(double.remote(ray.put(x))), x * 2)
    elif case == "numpy_large_arg":
        out = ray.get(double.remote(x))
        np.testing.assert_array_equal(out, x * 2)
        assert out.flags.writeable
    elif case == "chaining":
        ref = inc.remote(0)
        for _ in range(4):
            ref = inc.remote(ref)
        assert ray.get(ref) == 5
    else:
        assert ray.get([square.remote(i) for i in range(10)]) == [i * i for i in range(10)]


@pytest.mark.parametrize("where", ["task", "actor_method"])
def test_exception_propagates(rt, where):
    if where == "task":
        with pytest.raises(ray.RayTaskError, match="bad"):
            ray.get(boom.remote())
        return
    c = Counter.remote()
    with pytest.raises(ray.RayTaskError, match="actor boom"):
        ray.get(c.boom.remote())
    assert ray.get(c.inc.remote()) == 1  # the actor survives its method's exception
    ray.kill(c)


def test_wait(rt):
    slow = sleep_then.remote(2.0, "slow")
    fast = sleep_then.remote(0.0, "fast")
    ready, not_ready = ray.wait([slow, fast], num_returns=1, timeout=1.5)
    assert len(ready) == 1 and ray.get(ready[0]) == "fast"
    assert not_ready == [slow]
    ready, not_ready = ray.wait([slow], timeout=0.1)
    assert ready == [] and not_ready == [slow]
    with pytest.raises(ray.GetTimeoutError):
        ray.get(slow, timeout=0.1)
    assert ray.get(slow) == "slow"


def test_actor_state_and_ordering(rt):
    c = Counter.remote(10)
    assert ray.get(c.inc.remote()) == 11
    assert ray.get(c.inc.remote(5)) == 16
    for i in range(20):
        c.append.remote(i)
    assert ray.get(c.get_log.remote()) == list(range(20))
    ray.kill(c)


def test_kill_actor(rt):
    c = Counter.remote()
    assert ray.get(c.inc.remote()) == 1
    pending = c.append.remote(1)
    ray.kill(c)
    assert not c._worker.process.is_alive()
    with pytest.raises(ray.RayActorError):
        ray.get(c.inc.remote(), timeout=10)
    with pytest.raises(ray.RayActorError):
        ray.get(pending, timeout=10)


def test_shared_weight_broadcast(rt):
    """One put, read by several actors (the worker set's weight sync)."""
    weights = {f"layer{i}": np.ones((256, 256), np.float32) for i in range(4)}
    ref = ray.put(weights)
    readers = [Counter.remote() for _ in range(2)]
    sums = ray.get([r.read_sum.remote(ref) for r in readers])
    assert sums == [4 * 256 * 256] * 2
    for r in readers:
        ray.kill(r)


def test_worker_hides_the_card(rt):
    assert ray.get(device_state.remote()) == ("", False)


def test_segments_are_freed(rt):
    """A result's segment goes when the main process has mapped it; a put's
    when its last ref is gone."""
    x = np.ones((512, 512), np.float32)
    out = ray.get(double.remote(x))
    assert out.sum() == 2 * x.size
    assert object_store.leftover_segments(rt.session) == []
    ref = ray.put(x)
    assert len(object_store.leftover_segments(rt.session)) == 1
    np.testing.assert_array_equal(ray.get(double.remote(ref)), out)
    del ref
    gc.collect()
    assert object_store.leftover_segments(rt.session) == []


def test_concurrent_submitters_lose_no_reply_and_no_ref(rt):
    """12 threads (more than the host's cores) submit tasks and
    puts and drop their refs at once, with a short switch interval: every
    reply arrives, and the runtime holds no object afterwards."""
    import sys
    import threading

    errors, interval = [], sys.getswitchinterval()

    def submitter(k):
        try:
            for i in range(15):
                ref = add.remote(k, i) if i % 3 else double.remote(ray.put(np.full(70_000, k, np.float32)))
                got = ray.get(ref, timeout=60)
                want = k + i if i % 3 else np.full(70_000, 2 * k, np.float32)
                if not np.array_equal(got, want):
                    errors.append((k, i))
        except Exception as e:  # reported by the assertion below
            errors.append(repr(e))

    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=submitter, args=(k,)) for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and errors == []
    gc.collect()
    assert rt.entries == {} and object_store.leftover_segments(rt.session) == []


def test_shutdown_leaves_no_process_and_no_segment(rt):
    c = Counter.remote()
    keep = ray.put(np.ones((512, 512), np.float32))
    assert ray.get(c.inc.remote()) == 1 and ray.get(square.remote(3)) == 9
    assert object_store.leftover_segments(rt.session)
    procs = [w.process for w in rt.workers]
    assert len(procs) >= 3
    ray.shutdown()
    assert not ray.is_initialized()
    assert all(not p.is_alive() and p.exitcode is not None for p in procs)
    assert object_store.leftover_segments(rt.session) == []
    del keep
