"""The host object plane: ObjectRef, payloads and their segments.

Counterpart of ``ray_tpu/core/object_store.py``, cut to what the worker
set and a sampling round use. An object travels as a :class:`Payload`:
inline bytes up to ``SHM_THRESHOLD`` (256 KB), which ride the control
pipe, and above it a POSIX shared-memory segment under ``/dev/shm``,
which the pipe names. A segment is *transient* (a task's arguments, a
task's result: the receiver maps it and unlinks it at once) or *owned*
(a ``put`` object, which many workers may read: the main process
unlinks it when its last ref there is gone, or at shutdown). The
receiver maps a segment copy-on-write, so the arrays it gets are
writable views of the segment and nobody else sees a write.

Segment names carry the runtime's session (``rtt_<session>_...``);
``shutdown`` unlinks whatever of its session is left, so a worker that
died between writing a result and sending it leaks nothing.

The errors are the reference's: :class:`RayTaskError` (the task raised),
:class:`RayActorError` (the actor's process is gone),
:class:`WorkerCrashedError` (a task worker's process is gone) and
:class:`GetTimeoutError`.
"""

from __future__ import annotations

import glob
import mmap
import os
import sys
import uuid
from typing import Any, Optional

from ray_tpu_torch.core import serialization as ser

SHM_THRESHOLD = 256 * 1024  # bytes
SHM_DIR = "/dev/shm"
SHM_PREFIX = "rtt_"
SESSION_ENV = "RAY_TPU_TORCH_SESSION"


class GetTimeoutError(TimeoutError):
    pass


class RayTaskError(RuntimeError):
    """A remote call raised; carries the remote traceback."""

    def __init__(self, function_name: str, traceback_str: str, cause_cls: str = ""):
        super().__init__(function_name, traceback_str, cause_cls)
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause_cls = cause_cls

    def __str__(self):
        return f"{self.function_name} raised {self.cause_cls}:\n{self.traceback_str}"


class RayActorError(RuntimeError):
    pass


class WorkerCrashedError(RuntimeError):
    pass


def session_prefix(session: Optional[str] = None) -> str:
    return f"{SHM_PREFIX}{session or os.environ.get(SESSION_ENV, 'nosession')}_"


def leftover_segments(session: Optional[str] = None) -> list:
    """Paths of a runtime session's segments still under ``/dev/shm``."""
    return sorted(glob.glob(os.path.join(SHM_DIR, session_prefix(session) + "*")))


def unlink_segment(name: str) -> None:
    try:
        os.unlink(os.path.join(SHM_DIR, name))
    except FileNotFoundError:
        pass


class Payload:
    """An object on the wire: ``inline`` bytes, or the name and size of
    a segment, ``transient`` when its receiver unlinks it."""

    __slots__ = ("inline", "shm", "size", "transient")

    def __init__(self, inline=None, shm=None, size=0, transient=True):
        self.inline = inline
        self.shm = shm
        self.size = size
        self.transient = transient


def pack(obj: Any, transient: bool = True) -> Payload:
    """Serialize ``obj`` inline or into a new segment."""
    meta, buffers = ser.serialize(obj)
    size = ser.serialized_size(meta, buffers)
    if size <= SHM_THRESHOLD:
        buf = bytearray(size)
        ser.write_to_buffer(memoryview(buf), meta, buffers)
        return Payload(inline=bytes(buf), size=size)
    name = session_prefix() + uuid.uuid4().hex
    path = os.path.join(SHM_DIR, name)
    fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
    try:
        os.ftruncate(fd, size)
        mm = mmap.mmap(fd, size)
    except BaseException:
        os.close(fd)
        unlink_segment(name)
        raise
    os.close(fd)
    with memoryview(mm) as view:
        ser.write_to_buffer(view, meta, buffers)
    mm.close()
    return Payload(shm=name, size=size, transient=transient)


def unpack(p: Payload) -> Any:
    """The object of a payload. A segment is mapped copy-on-write (and
    unlinked when transient); its arrays are views of the mapping, which
    lives as long as they do."""
    if p.inline is not None:
        return ser.read_from_buffer(memoryview(bytearray(p.inline)))
    path = os.path.join(SHM_DIR, p.shm)
    fd = os.open(path, os.O_RDONLY)
    try:
        mm = mmap.mmap(fd, p.size, flags=mmap.MAP_PRIVATE,
                       prot=mmap.PROT_READ | mmap.PROT_WRITE)
    finally:
        os.close(fd)
        if p.transient:
            unlink_segment(p.shm)
    return ser.read_from_buffer(memoryview(mm))


def discard(p: Payload) -> None:
    """Drop a transient payload nobody will read."""
    if p.shm is not None and p.transient:
        unlink_segment(p.shm)


class ObjectRef:
    """A handle to a task's result or a ``put`` object. In the main process
    every live handle holds its object (the reference's local reference
    count): when the last one goes, the runtime frees it. Handles pickle
    as their id."""

    __slots__ = ("id", "_counted")

    def __init__(self, id: Optional[str] = None):
        from ray_tpu_torch.core import api

        self.id = id or uuid.uuid4().hex
        rt = api._runtime
        self._counted = rt is not None and rt.incref(self.id)

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and self.id == other.id

    def hex(self) -> str:
        return self.id

    def __repr__(self):
        return f"ObjectRef({self.id[:16]})"

    def __reduce__(self):
        return (ObjectRef, (self.id,))

    def __del__(self):
        if getattr(self, "_counted", False):
            # no import here: this can run while the interpreter exits
            api = sys.modules.get("ray_tpu_torch.core.api")
            rt = getattr(api, "_runtime", None)
            if rt is not None:
                rt.decref(self.id)
