"""Build and bind the port's hand-written CUDA kernels.

Each source under ``ray_tpu_torch/csrc/`` is compiled by ``nvcc`` into its
own shared library with a plain C interface, for ``sm_90a`` (Hopper),
and loaded with ``ctypes``. Nothing is built when this module is
imported: the first launch of a kernel builds it, and :func:`build`
builds several at once, one ``nvcc`` process per source, all started
together. Libraries land in ``ray_tpu_torch/_build/`` (git-ignored),
named by a digest of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded.

Every pointer and the stream pass as ``c_void_p`` (a bare Python int
would be cut to 32 bits). :func:`launch` hands a C launch function the
current stream of the tensors' card. Each launch returns
``cudaGetLastError()``; :func:`check` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "--resource-usage",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong

# name -> (source file, extra nvcc flags, {C function: (argtypes, restype)})
KERNELS = {
    "row_gather": (
        "row_gather.cu",
        (),
        {
            "row_gather_launch": (
                [_P, _P, _P, _I64, _I64, _I64, _P], ctypes.c_int
            ),
            "row_gather_error_string": ([ctypes.c_int], ctypes.c_char_p),
        },
    ),
    "row_scatter": (
        "row_scatter.cu",
        (),
        {
            "row_scatter_launch": (
                [_P, _P, ctypes.c_int, _P, _P, _I64, _I64, _I64, _P],
                ctypes.c_int,
            ),
            "row_scatter_one_launch_rows": ([], ctypes.c_int),
            "row_scatter_error_string": ([ctypes.c_int], ctypes.c_char_p),
        },
    ),
    "prefix_descent": (
        "prefix_descent.cu",
        ("-fmad=false",),
        {
            "prefix_descent_launch": (
                [_P, _P, _P, _I64, ctypes.c_int, _I64, _P], ctypes.c_int
            ),
            "prefix_descent_error_string": (
                [ctypes.c_int], ctypes.c_char_p
            ),
        },
    ),
    "gae_scan": (
        "gae_scan.cu",
        ("-fmad=false",),
        {
            "gae_fragment_launch": (
                [_P, _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                 ctypes.c_float, ctypes.c_float, _P],
                ctypes.c_int,
            ),
            "gae_fragment_error_string": (
                [ctypes.c_int], ctypes.c_char_p
            ),
        },
    ),
    "flash_fwd": (
        "flash_fwd.cu",
        (),
        {
            # q, k, v, o; B, H, T, S, D; (batch, head, row) strides of
            # q, k, v and o; dtype, banded, offset; stream
            "flash_fwd_launch": (
                [_P, _P, _P, _P, _I64, _I64, _I64, _I64, ctypes.c_int]
                + [_I64] * 12 + [ctypes.c_int, ctypes.c_int, _I64, _P],
                ctypes.c_int,
            ),
            "flash_fwd_error_string": ([ctypes.c_int], ctypes.c_char_p),
        },
    ),
    "flash_block": (
        "flash_block.cu",
        (),
        {
            "flash_block_launch": (
                [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_int,
                 ctypes.c_int, _I64, _P],
                ctypes.c_int,
            ),
            "flash_block_error_string": ([ctypes.c_int], ctypes.c_char_p),
        },
    ),
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else
    ``nvcc`` on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "ray_tpu_torch are built from source at first use"
        )
    return found


def library_path(name: str) -> Path:
    source, extra, _ = KERNELS[name]
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # what a source may include
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + extra).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named kernels (all by default) that are not built
    yet, one ``nvcc`` per source, started together. Returns
    ``{name: {"seconds", "cached", "log"}}``; raises with the compiler's
    output when a build fails."""
    names = list(KERNELS) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, dict] = {}
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        target = library_path(name)
        if target.exists():
            out[name] = {"seconds": 0.0, "cached": True, "log": ""}
            continue
        source, extra, _ = KERNELS[name]
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *extra, "-o", str(tmp),
               str(CSRC / source)]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            target,
        )
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, target)
        out[name] = {
            "seconds": time.perf_counter() - t0,
            "cached": False,
            "log": log,
        }
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (argtypes, restype) in KERNELS[name][2].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _libs[name] = lib
        return lib


def launch(fn, device: torch.device, *args) -> int:
    """``fn(*args, stream)`` with the raw current stream of ``device``, a
    CUDA device: the current device is switched (``torch.cuda.device``)
    only when it is another. Returns ``fn``'s code."""
    index = device.index
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def check(rc: int, lib: ctypes.CDLL, error_fn: str, what: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if rc != 0:
        msg = getattr(lib, error_fn)(rc)
        raise RuntimeError(
            f"{what} launch failed: CUDA error {rc} "
            f"({msg.decode() if msg else 'unknown'})"
        )
