"""The worker process's main loop.

Counterpart of ``ray_tpu/core/worker_proc.py``: a process started with
the ``spawn`` context that runs stateless tasks or hosts one actor,
taking commands over a duplex pipe and returning results inline or in a
shared-memory segment (``object_store.pack``).

Rollout workers never touch the card: it belongs to the learner. So the
first thing :func:`worker_main` does, before anything imports torch, is
set ``CUDA_VISIBLE_DEVICES=""`` (the reference sets
``JAX_PLATFORMS=cpu``); a policy built here must be asked for the CPU
(``device="cpu"``), and the process never creates a CUDA context. The
package's ``__init__`` imports no torch, so nothing before this line
has. A worker whose environment names another platform
(``RAY_TPU_WORKER_PLATFORM``, the reference's key, set through
``init(worker_env=...)`` or an actor's ``runtime_env``) keeps the
card visible: a serving replica on the card.

A reader thread queues the main process's messages, so its sends do not
wait for the call that is running. Calls run one at a time in
arrival order: an actor's methods see each other's effects in the order
they were submitted.
"""

from __future__ import annotations

import os

# the reference's worker-platform key: "cpu" (the default) hides the card
PLATFORM_ENV = "RAY_TPU_WORKER_PLATFORM"


class RefArg:
    """A top-level ObjectRef argument, resolved by the main process: the
    payload of its object."""

    __slots__ = ("payload",)

    def __init__(self, payload):
        self.payload = payload


def _load_args(payload):
    from ray_tpu_torch.core.object_store import unpack

    args, kwargs = unpack(payload)
    args = [unpack(a.payload) if isinstance(a, RefArg) else a for a in args]
    kwargs = {k: unpack(v.payload) if isinstance(v, RefArg) else v for k, v in kwargs.items()}
    return args, kwargs


def worker_main(conn, env):
    env = dict(env or {})
    if env.get(PLATFORM_ENV, "cpu") == "cpu":
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
    os.environ.update(env)

    import queue
    import threading
    import traceback

    from ray_tpu_torch.core.object_store import pack

    inbox: "queue.Queue" = queue.Queue()

    def read():
        while True:
            try:
                inbox.put(conn.recv())
            except (EOFError, OSError):
                inbox.put(None)
                return

    threading.Thread(target=read, daemon=True, name="worker_inbox").start()
    instance = None
    while True:
        msg = inbox.get()
        if msg is None or msg["kind"] == "exit":
            break
        try:
            args, kwargs = _load_args(msg["args"])
            if msg["kind"] == "task":
                value = msg["target"].resolve()(*args, **kwargs)
            elif msg["kind"] == "create":
                instance = msg["target"].resolve()(*args, **kwargs)
                value = None
            else:
                value = getattr(instance, msg["method"])(*args, **kwargs)
            reply = {"task": msg["task"], "ok": True, "value": pack(value)}
        except Exception as e:  # every failure goes back to the caller
            reply = {
                "task": msg["task"], "ok": False, "error_cls": type(e).__name__,
                "traceback": traceback.format_exc(),
            }
        try:
            conn.send(reply)
        except (BrokenPipeError, OSError):
            break
