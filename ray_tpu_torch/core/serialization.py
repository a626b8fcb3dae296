"""Serialization for the object plane.

Counterpart of ``ray_tpu/core/serialization.py``: pickle protocol 5
with out-of-band buffers, so numpy arrays (batch columns, weights)
serialize as a small metadata pickle plus raw buffers laid out one after
the other, and come back as views of the memory they were written to.
Plain ``pickle`` (the reference uses cloudpickle): functions and classes
travel by module and name (:class:`CodeRef`), so a remote function or
actor class is defined at a module's top level.

Layout: [u64 meta_len][meta][u64 nbuf]([u64 len_i][buf_i, padded to 8])...
"""

from __future__ import annotations

import importlib
import pickle
import struct
from typing import Any, List, Tuple

_HDR = struct.Struct("<Q")


def serialize(obj: Any) -> Tuple[bytes, List[pickle.PickleBuffer]]:
    """→ (meta, out-of-band buffers)."""
    buffers: List[pickle.PickleBuffer] = []
    meta = pickle.dumps(obj, protocol=5, buffer_callback=buffers.append)
    return meta, buffers


def serialized_size(meta: bytes, buffers: List[pickle.PickleBuffer]) -> int:
    total = _HDR.size * 2 + len(meta)
    for b in buffers:
        n = b.raw().nbytes
        total += _HDR.size + ((n + 7) & ~7)
    return total


def write_to_buffer(view: memoryview, meta: bytes, buffers: List[pickle.PickleBuffer]) -> int:
    """Write the layout into ``view``; returns the bytes written."""
    off = 0
    view[off : off + _HDR.size] = _HDR.pack(len(meta))
    off += _HDR.size
    view[off : off + len(meta)] = meta
    off += len(meta)
    view[off : off + _HDR.size] = _HDR.pack(len(buffers))
    off += _HDR.size
    for b in buffers:
        raw = b.raw()
        n = raw.nbytes
        view[off : off + _HDR.size] = _HDR.pack(n)
        off += _HDR.size
        view[off : off + n] = raw.cast("B")
        off += (n + 7) & ~7
    return off


def read_from_buffer(view: memoryview) -> Any:
    """The object in ``view``; its array buffers are views of ``view``
    (which stays alive as long as they do)."""
    off = 0
    (meta_len,) = _HDR.unpack_from(view, off)
    off += _HDR.size
    meta = bytes(view[off : off + meta_len])
    off += meta_len
    (nbuf,) = _HDR.unpack_from(view, off)
    off += _HDR.size
    buffers = []
    for _ in range(nbuf):
        (n,) = _HDR.unpack_from(view, off)
        off += _HDR.size
        buffers.append(view[off : off + n])
        off += (n + 7) & ~7
    return pickle.loads(meta, buffers=buffers)


class CodeRef:
    """A module-level function or class, sent by module and qualified
    name and imported again on the other side. A name bound to a remote
    wrapper (``@remote``) resolves to the function or class it wraps."""

    __slots__ = ("module", "qualname")

    def __init__(self, obj):
        self.module = obj.__module__
        self.qualname = obj.__qualname__
        if "<locals>" in self.qualname or "<lambda>" in self.qualname:
            raise TypeError(
                f"{self.qualname} is not defined at a module's top level; the "
                "runtime sends functions and classes by name"
            )

    def resolve(self):
        obj = importlib.import_module(self.module)
        for part in self.qualname.split("."):
            obj = getattr(obj, part)
        return getattr(obj, "_remote_target", obj)
