"""The one atomic-write chain of the port.

Copy of ``ray_tpu/util/atomic_io.py``: temp file → flush → ``os.fsync``
→ ``os.replace`` → directory fsync, so a crash mid-save leaves either
the old complete file or the new one, never a truncated one. The
checkpoint writers (``Algorithm.save_checkpoint``,
``Trainable.save``) write through it.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable

__all__ = ["atomic_write", "fsync_dir"]


def atomic_write(path: str, write_fn: Callable, *, sync_dir: bool = True) -> None:
    """Write ``path`` through a same-directory temp file: ``write_fn(f)``
    on the open binary file, flush and fsync, then ``os.replace`` onto
    ``path``, then (unless ``sync_dir=False``) fsync the directory, where
    the rename itself lives. ``sync_dir=False`` is for a caller that
    writes several files and issues one :func:`fsync_dir` at the end."""
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(path) or ".", prefix=os.path.basename(path) + ".tmp."
    )
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if sync_dir:
        fsync_dir(os.path.dirname(path) or ".")


def fsync_dir(path: str) -> None:
    """Flush a directory's entries (renames, unlinks) to disk; a no-op
    where a directory cannot be opened."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
