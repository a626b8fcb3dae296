"""The actor runtime's API, called in the main process.

Counterpart of ``ray_tpu/core/api.py``, cut to what the worker set and
a sampling round use: :func:`init`, :func:`shutdown`,
:func:`is_initialized`, :func:`remote` on functions and classes, actor
handles whose methods have ``.remote``, :func:`get` with ``timeout``,
:func:`wait`, :func:`put` and :func:`kill`.

Every actor is a process of its own; stateless tasks share a pool of up
to ``num_cpus`` processes, started as tasks need them. Processes are
started with the ``spawn`` context (a CUDA context does not survive a
fork) and run ``worker_proc.worker_main``. One reader thread in the
main process takes every reply, maps its payload (``object_store.unpack``)
and completes its ref; a worker whose process ends fails its pending
calls with :class:`RayActorError` (an actor) or
:class:`WorkerCrashedError` (a task worker).

Top-level ObjectRef arguments are resolved before a call is sent: the
call waits for a pending ref in the caller's thread, then ships the
object's payload (a ``put`` object's owned segment as it is, anything
else packed again). A call holds its argument refs until its reply is
in, so an owned segment outlives every read of it.

Worker processes hide the card (``worker_proc.worker_main``) unless
``init(worker_env={"RAY_TPU_WORKER_PLATFORM": "cuda"})`` asks otherwise;
``worker_env`` reaches every worker's environment, and an actor class's
``options(runtime_env={"env_vars": {...}})`` adds variables for the
actors it makes (the serve core's replicas, ``serve/serve.py``).

Left for later (``ROADMAP.md`` queue 1 item 3): the native SPSC ring,
placement groups, named actors, task retries and actor restarts, the
client server, jobs, the rest of ``runtime_env``, the memory and log
monitors and ``cluster.py``.
"""

from __future__ import annotations

import atexit
import logging
import multiprocessing as mp
import multiprocessing.connection
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.core import object_store as store
from ray_tpu_torch.core.object_store import (
    GetTimeoutError,
    ObjectRef,
    RayActorError,
    RayTaskError,
    WorkerCrashedError,
)
from ray_tpu_torch.core.serialization import CodeRef
from ray_tpu_torch.core.worker_proc import RefArg, worker_main

_runtime: Optional["_Runtime"] = None
_init_lock = threading.Lock()
logger = logging.getLogger(__name__)


def _fresh(err: BaseException) -> BaseException:
    """A new instance of a stored error, to raise: raising the stored
    one would tie its traceback's frames (and the refs they hold) to the
    entry for good."""
    return type(err)(*err.args)


class _Entry:
    """One object: a put payload, or a call's reply once it is in."""

    __slots__ = ("done", "value", "error", "payload", "count", "dropped", "callbacks")

    def __init__(self):
        self.callbacks: list = []
        self.done = False
        self.value = None
        self.error: Optional[BaseException] = None
        self.payload: Optional[store.Payload] = None  # put objects
        self.count = 0
        self.dropped = False


class _Worker:
    """A worker process and the calls it owes."""

    def __init__(self, rt: "_Runtime", actor: bool, env_vars: Optional[Dict[str, str]] = None):
        self.id = uuid.uuid4().hex[:12]
        self.actor = actor
        self.conn, child = rt.ctx.Pipe(duplex=True)
        env = {**rt.worker_env, **(env_vars or {}), store.SESSION_ENV: rt.session}
        self.process = rt.ctx.Process(
            target=worker_main, args=(child, env), daemon=True,
            name=f"ray_tpu_torch_worker_{self.id}",
        )
        self.process.start()
        child.close()
        self.pending: Dict[str, Tuple[str, list]] = {}  # task id → (name, pinned refs)
        self.send_lock = threading.Lock()
        self.alive = True
        self.death: Optional[BaseException] = None

    def dead_error(self, what: str) -> BaseException:
        if self.death is not None:
            return self.death
        cls = RayActorError if self.actor else WorkerCrashedError
        return cls(f"the worker process of {what} died (pid {self.process.pid})")


class _Runtime:
    def __init__(self, num_cpus: Optional[int], worker_env: Optional[Dict[str, str]] = None):
        self.session = uuid.uuid4().hex[:12]
        self.worker_env: Dict[str, str] = dict(worker_env or {})
        self.ctx = mp.get_context("spawn")
        self.num_cpus = int(num_cpus or os.cpu_count() or 1)
        self.cond = threading.Condition(threading.RLock())
        self.entries: Dict[str, _Entry] = {}
        self.workers: List[_Worker] = []
        self.task_pool: List[_Worker] = []
        self.stopping = False
        os.environ[store.SESSION_ENV] = self.session
        self.reader = threading.Thread(target=self._read_loop, daemon=True, name="ray_tpu_torch_reader")
        self.reader.start()

    # -- reference counts ------------------------------------------------

    def incref(self, obj_id: str) -> bool:
        with self.cond:
            e = self.entries.get(obj_id)
            if e is None:
                return False
            e.count += 1
            return True

    def decref(self, obj_id: str) -> None:
        with self.cond:
            e = self.entries.get(obj_id)
            if e is None:
                return
            e.count -= 1
            if e.count > 0:
                return
            if e.done:
                self._free(obj_id, e)
            else:
                e.dropped = True  # freed when its reply comes in

    def _free(self, obj_id: str, e: _Entry) -> None:
        self.entries.pop(obj_id, None)
        if e.payload is not None and e.payload.shm is not None:
            store.unlink_segment(e.payload.shm)
        e.value = e.payload = None

    def _new_ref(self) -> ObjectRef:
        obj_id = uuid.uuid4().hex
        with self.cond:
            self.entries[obj_id] = _Entry()
        return ObjectRef(obj_id)

    # -- objects -----------------------------------------------------------

    def put(self, value: Any) -> ObjectRef:
        ref = self._new_ref()
        with self.cond:
            e = self.entries[ref.id]
            e.payload = store.pack(value, transient=False)
            e.done = True
        return ref

    def _entry(self, ref: ObjectRef) -> _Entry:
        e = self.entries.get(ref.id)
        if e is None:
            raise ValueError(f"{ref} is not an object of this runtime")
        return e

    def _wait_done(self, refs: Sequence[ObjectRef], num: int, timeout: Optional[float]):
        deadline = None if timeout is None else time.monotonic() + timeout
        with self.cond:
            while True:
                ready = [r for r in refs if self._entry(r).done]
                if len(ready) >= num:
                    return ready
                left = None if deadline is None else deadline - time.monotonic()
                if left is not None and left <= 0:
                    return ready
                self.cond.wait(left if left is not None else 1.0)

    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float]) -> List[Any]:
        ready = self._wait_done(refs, len(refs), timeout)
        if len(ready) < len(refs):
            raise GetTimeoutError(f"{len(refs) - len(ready)} of {len(refs)} objects not ready "
                                  f"after {timeout} s")
        out = []
        for r in refs:
            e = self._entry(r)
            if e.error is not None:
                raise _fresh(e.error)
            out.append(store.unpack(e.payload) if e.payload is not None else e.value)
        return out

    def wait(self, refs: Sequence[ObjectRef], num_returns: int, timeout: Optional[float]):
        ready = set(self._wait_done(refs, num_returns, timeout))
        done = [r for r in refs if r in ready][:num_returns]
        taken = set(done)
        return done, [r for r in refs if r not in taken]

    def _arg_payload(self, ref: ObjectRef) -> store.Payload:
        """What a call ships for a top-level ref argument: a put
        object's own payload, or the reply's value packed again."""
        self._wait_done([ref], 1, None)
        e = self._entry(ref)
        if e.error is not None:
            raise _fresh(e.error)
        return e.payload if e.payload is not None else store.pack(e.value)

    # -- calls -------------------------------------------------------------

    def on_ready(self, obj_id: str, callback) -> None:
        """Run ``callback(error)`` once the object is done (now, if it
        is): ``error`` is the call's stored error, None on success."""
        with self.cond:
            e = self.entries.get(obj_id)
            if e is not None and not e.done:
                e.callbacks.append(callback)
                return
            error = e.error if e is not None else None
        _run_callbacks((callback,), error)

    def start_worker(self, actor: bool, env_vars: Optional[Dict[str, str]] = None) -> _Worker:
        w = _Worker(self, actor, env_vars)
        with self.cond:
            self.workers.append(w)
        return w

    def _pick_task_worker(self) -> _Worker:
        with self.cond:
            self.task_pool = [w for w in self.task_pool if w.alive]
            idle = [w for w in self.task_pool if not w.pending]
            if idle:
                return idle[0]
            if len(self.task_pool) < self.num_cpus:
                w = self.start_worker(actor=False)
                self.task_pool.append(w)
                return w
            return min(self.task_pool, key=lambda w: len(w.pending))

    def submit(self, w: _Worker, kind: str, name: str, args, kwargs, target=None,
               method: Optional[str] = None) -> ObjectRef:
        pinned = [a for a in list(args) + list(kwargs.values()) if isinstance(a, ObjectRef)]
        args = [RefArg(self._arg_payload(a)) if isinstance(a, ObjectRef) else a for a in args]
        kwargs = {k: RefArg(self._arg_payload(v)) if isinstance(v, ObjectRef) else v
                  for k, v in kwargs.items()}
        ref = self._new_ref()
        msg = {"kind": kind, "task": ref.id, "target": target, "method": method,
               "args": store.pack((args, kwargs))}
        with self.cond:
            if not w.alive or w.death is not None:
                store.discard(msg["args"])
                self._complete(ref.id, error=w.dead_error(name))
                return ref
            w.pending[ref.id] = (name, pinned)
        try:
            with w.send_lock:
                w.conn.send(msg)
        except (BrokenPipeError, OSError):
            store.discard(msg["args"])
            self._worker_died(w)
        return ref

    def _complete(self, obj_id: str, value=None, error=None) -> None:
        callbacks = ()
        with self.cond:
            e = self.entries.get(obj_id)
            if e is not None:
                e.value, e.error, e.done = value, error, True
                callbacks, e.callbacks = e.callbacks, []
                if e.dropped:
                    self._free(obj_id, e)
            self.cond.notify_all()
        _run_callbacks(callbacks, error)

    # -- the reader thread ---------------------------------------------------

    def _on_reply(self, w: _Worker, msg: Dict) -> None:
        with self.cond:
            name, _ = w.pending.pop(msg["task"], ("?", None))
            e = self.entries.get(msg["task"])
            wanted = e is not None and not e.dropped
        if msg["ok"]:
            if not wanted:
                store.discard(msg["value"])
                self._complete(msg["task"])
                return
            self._complete(msg["task"], value=store.unpack(msg["value"]))
            return
        err = RayTaskError(name, msg["traceback"], msg["error_cls"])
        if name.endswith(".__init__"):
            # an actor whose constructor raised is dead to later calls
            w.death = RayActorError(f"{name} raised:\n{msg['traceback']}")
        self._complete(msg["task"], error=err)

    def _worker_died(self, w: _Worker) -> None:
        with self.cond:
            if not w.alive and not w.pending:
                return
            w.alive = False
            pending, w.pending = w.pending, {}
        for task_id, (name, _) in pending.items():
            self._complete(task_id, error=w.dead_error(name))

    def _read_loop(self) -> None:
        while not self.stopping:
            with self.cond:
                live = [w for w in self.workers if w.alive]
            if not live:
                time.sleep(0.02)
                continue
            conns = {w.conn: w for w in live}
            sentinels = {w.process.sentinel: w for w in live}
            try:
                ready = mp.connection.wait(list(conns) + list(sentinels), timeout=0.1)
            except OSError:
                continue
            for r in ready:
                if r in conns:
                    self._drain(conns[r])
            for r in ready:
                if r in sentinels:
                    w = sentinels[r]
                    self._drain(w)
                    self._worker_died(w)

    def _drain(self, w: _Worker) -> None:
        try:
            while w.conn.poll():
                self._on_reply(w, w.conn.recv())
        except (EOFError, OSError):
            self._worker_died(w)

    # -- teardown ------------------------------------------------------------

    def kill(self, w: _Worker) -> None:
        with self.cond:
            w.death = RayActorError(f"the actor was killed (pid {w.process.pid})")
        w.process.kill()
        w.process.join(timeout=10)
        self._worker_died(w)

    def shutdown(self) -> None:
        with self.cond:
            workers = list(self.workers)
        for w in workers:
            if w.alive:
                try:
                    with w.send_lock:
                        w.conn.send({"kind": "exit"})
                except (BrokenPipeError, OSError):
                    pass
        deadline = time.monotonic() + 5.0
        for w in workers:
            w.process.join(timeout=max(0.0, deadline - time.monotonic()))
            if w.process.is_alive():
                w.process.kill()
                w.process.join(timeout=5)
        self.stopping = True
        self.reader.join(timeout=5)
        for w in workers:
            self._worker_died(w)
            w.conn.close()
        with self.cond:
            for obj_id, e in list(self.entries.items()):
                self._free(obj_id, e)
        for path in store.leftover_segments(self.session):
            store.unlink_segment(os.path.basename(path))


def _run_callbacks(callbacks, error: Optional[BaseException]) -> None:
    # on the reader thread, which must outlive a callback that raises
    for fn in callbacks:
        try:
            fn(error)
        except Exception:
            logger.exception("an on_ready callback raised")


# -- public API ---------------------------------------------------------------


def init(num_cpus: Optional[int] = None, worker_env: Optional[Dict[str, str]] = None) -> None:
    """Start the runtime in this (the main) process. ``num_cpus``
    caps the task pool (default: the host's cores). ``worker_env``
    goes into every worker's environment; its
    ``RAY_TPU_WORKER_PLATFORM: "cuda"`` keeps the card visible there
    (the default hides it)."""
    global _runtime
    with _init_lock:
        if _runtime is not None:
            raise RuntimeError("the runtime is already initialized; call shutdown() first")
        _runtime = _Runtime(num_cpus, worker_env)


def is_initialized() -> bool:
    return _runtime is not None


def shutdown() -> None:
    """Stop every worker process and free every object and segment."""
    global _runtime
    with _init_lock:
        rt, _runtime = _runtime, None
    if rt is not None:
        rt.shutdown()


atexit.register(shutdown)


def _require_runtime() -> _Runtime:
    if _runtime is None:
        init()
    return _runtime


def put(value: Any) -> ObjectRef:
    return _require_runtime().put(value)


def get(refs, timeout: Optional[float] = None):
    """The object (or list of objects) of ``refs``; raises the call's
    error, or :class:`GetTimeoutError` after ``timeout`` seconds."""
    rt = _require_runtime()
    if isinstance(refs, ObjectRef):
        return rt.get([refs], timeout)[0]
    return rt.get(list(refs), timeout)


def wait(refs: Sequence[ObjectRef], num_returns: int = 1, timeout: Optional[float] = None):
    """→ (ready, not_ready): the first ``num_returns`` ready refs in the
    order given, once that many are ready or ``timeout`` has passed."""
    refs = list(refs)
    if num_returns > len(refs):
        raise ValueError(f"num_returns={num_returns} > {len(refs)} refs")
    return _require_runtime().wait(refs, num_returns, timeout)


def on_ready(ref: ObjectRef, callback) -> None:
    """Run ``callback(error)`` once ``ref``'s call has completed:
    ``error`` is the error it stored, None if it succeeded. A callback
    that raises is logged and does not stop the others."""
    _require_runtime().on_ready(ref.id, callback)


def kill(actor: "ActorHandle") -> None:
    """End an actor's process at once; its pending and later calls fail
    with :class:`RayActorError`."""
    _require_runtime().kill(actor._worker)


class RemoteFunction:
    def __init__(self, fn):
        self._remote_target = fn
        self._code = CodeRef(fn)
        self.__name__ = getattr(fn, "__name__", "remote_function")
        self.__doc__ = fn.__doc__

    def __call__(self, *args, **kwargs):
        raise TypeError(f"call {self.__name__}.remote(...), not {self.__name__}(...)")

    def remote(self, *args, **kwargs) -> ObjectRef:
        rt = _require_runtime()
        return rt.submit(rt._pick_task_worker(), "task", self._code.qualname, args, kwargs,
                         target=self._code)


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str):
        self._handle = handle
        self._name = name

    def remote(self, *args, **kwargs) -> ObjectRef:
        h = self._handle
        return _require_runtime().submit(
            h._worker, "call", f"{h._class_name}.{self._name}", args, kwargs, method=self._name
        )


class ActorHandle:
    def __init__(self, worker: _Worker, class_name: str):
        self._worker = worker
        self._class_name = class_name

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._worker.id})"


class ActorClass:
    def __init__(self, cls, env_vars: Optional[Dict[str, str]] = None):
        self._remote_target = cls
        self._code = CodeRef(cls)
        self.__name__ = cls.__name__
        self._env_vars = dict(env_vars or {})

    def __call__(self, *args, **kwargs):
        raise TypeError(f"call {self.__name__}.remote(...), not {self.__name__}(...)")

    def options(self, runtime_env: Optional[Dict] = None) -> "ActorClass":
        """This class with ``runtime_env["env_vars"]`` added to the
        environment of the actors it makes (the one key of the
        reference's ``runtime_env`` that is ported)."""
        runtime_env = dict(runtime_env or {})
        env_vars = runtime_env.pop("env_vars", None) or {}
        if runtime_env:
            raise NotImplementedError(
                f"runtime_env keys {sorted(runtime_env)} are not ported (ROADMAP.md queue 1 "
                "item 3); only env_vars is"
            )
        return ActorClass(self._remote_target, {**self._env_vars, **env_vars})

    def remote(self, *args, **kwargs) -> ActorHandle:
        """A new process holding one instance, built from these args."""
        rt = _require_runtime()
        w = rt.start_worker(actor=True, env_vars=self._env_vars)
        rt.submit(w, "create", f"{self.__name__}.__init__", args, kwargs, target=self._code)
        return ActorHandle(w, self.__name__)


def remote(obj):
    """``@remote`` on a module-level function (tasks) or class (actors)."""
    if isinstance(obj, type):
        return ActorClass(obj)
    if callable(obj):
        return RemoteFunction(obj)
    raise TypeError(f"remote() takes a function or a class, not {obj!r}")
