"""Device-plane observability: the program ledger.

The port's counterpart of ``ray_tpu/telemetry/device.py``. The
reference hooks its ledger into the ``sharded_jit`` cache; the port has
no compiler cache, so a *program* here is what the reference would
compile as one:

- each ``SuperstepRunner`` (``sharding/superstep.py``), labelled
  ``superstep[<policy class>:<batch>x<k_max>]`` or
  ``rollout_superstep[...]`` as the reference labels its superstep
  programs: one execution is the k slots of one ``run`` (on the card,
  the k graph replays);
- each serve bucket program (``serve[<name>:<bucket>:<mode>]``), one
  execution a forward;
- the eager learn nest (``learn[<class>:<batch>]``) and the eager act
  step (``act[<class>:<batch>]``) where no graph runs.

Per program the ledger records, under the reference's keys:

- **captures** (``traces``): a CUDA-graph capture is the port's
  compile, and a program's first call at a new signature is its
  analysis call. Neither counts as an execution, as the reference's
  traced calls do not. A capture of a label beyond its first is a
  *recompile*; its cause is the signature diff (leaf path, shape,
  dtype), as strings bitwise the reference's for the same leaves
  (:func:`signature_of`, :func:`diff_signatures`, :func:`cause_string`),
  and rides a ``jit:recompile`` trace event.
- **cost**: FLOPs and bytes of one execution. XLA's ``cost_analysis``
  has no torch counterpart, so the analysis call runs its first slot
  under a counting ``TorchDispatchMode`` that forwards every aten op
  unchanged and counts FLOPs as ``torch.utils.flop_counter`` reckons
  them and bytes as each op's inputs read once and outputs written once
  (XLA's per-instruction ``bytes accessed``; views move nothing). The
  hand-written kernels launch through ``ctypes`` and are invisible to
  the mode, so each wrapper adds its own cost (:func:`add_kernel_cost`)
  by the formulas behind the bounds of ``PERF.md``. A runner's execution
  of k slots costs k slots. ``device_ledger="light"`` skips the count:
  ``flops`` and ``bytes_accessed`` stay None.
- **memory** (``memory_analysis``'s keys): ``temp_bytes`` is the growth
  of the CUDA caching allocator's reserved bytes over the capture (the
  graph's private pool; None on the CPU), ``argument_bytes`` the static
  inputs the program owns (permutations, stacked feed, observation and
  draw buffers), ``output_bytes`` its static outputs.
  ``alias_bytes`` and ``generated_code_bytes`` are None: a graph updates
  the parameters in place and holds no code the port can size.
- **runtime**: executions and device time. On the card a
  ``torch.cuda.Event(enable_timing=True)`` pair is recorded on the
  current stream around each execution (a pool per program, reused);
  ``elapsed_time`` is read at the drain the caller already pays
  (:func:`drain_point`, after the drain's host copy has returned) or, in
  :func:`snapshot`, after waiting on the end event. The ledger never
  synchronizes the device otherwise and adds no ``.item()``. On the CPU
  an execution's time is the host wall from its start to the drain.
- **MFU and bandwidth** against the peak tables (the H100's public dense
  bf16 989e12 FLOP/s and 3.35e12 B/s HBM, keyed by
  ``torch.cuda.get_device_name()``); ``RAY_TPU_PEAK_FLOPS`` /
  ``RAY_TPU_PEAK_HBM_BPS`` and ``telemetry(peak_flops=...)`` override.

Execution spans land in the trace buffer on synthetic ``device:`` lanes
(one per program), so ``Algorithm.export_timeline`` renders driver
threads, worker spans and device programs in one file. A span starts at
the host stamp of its launch and lasts its event time.

Off by default: one flag check per execution. The telemetry runtime
enables it, or ``RAY_TPU_DEVICE_LEDGER=1`` with no config at all.
``n_devices`` is 1 (a program runs on one card), ``source`` is
``"live"``, and ``donate_argnums`` / ``in_shardings`` /
``out_shardings`` are empty: the port has no placement specs.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.util import tracing

# -- activation ---------------------------------------------------------

_LOCK = threading.Lock()
_enabled = os.environ.get("RAY_TPU_DEVICE_LEDGER") == "1"
# count FLOPs and bytes over each analysis call
_analyze = os.environ.get("RAY_TPU_DEVICE_LEDGER_LIGHT") != "1"

# label -> _ProgramEntry, insertion-ordered
_entries: Dict[str, "_ProgramEntry"] = {}
# thread id -> executions launched on it and not yet closed by a drain
_pending: Dict[int, List["_Execution"]] = {}
# process-wide CUDA-graph capture counts, kept whether or not the ledger
# runs (the compile gauges of telemetry/metrics.sample_runtime_gauges)
_captures = {"traces": 0, "recompiles": 0, "compile_time_s": 0.0}
_captured_labels: set = set()

# synthetic chrome-trace lane block for device program spans: far away
# from any real thread id, one sub-lane per program label
_DEVICE_TID_BASE = 0x0DE00000
_span_seq = itertools.count()
_tls = threading.local()


def enable(analyze: Optional[bool] = None) -> None:
    global _enabled, _analyze
    _enabled = True
    if analyze is not None:
        _analyze = bool(analyze)


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def analyzing() -> bool:
    return _enabled and _analyze


def clear() -> None:
    """Drop all ledger state (tests)."""
    with _LOCK:
        _entries.clear()
        _pending.clear()


def capture_stats() -> Dict[str, float]:
    """Process-wide CUDA-graph captures: ``traces``, ``recompiles``
    (captures of a label beyond its first) and their seconds."""
    with _LOCK:
        return dict(_captures)


# -- peak-FLOPs / peak-bandwidth tables ---------------------------------

# peak dense bf16 FLOP/s and HBM bytes/s by device-name substring
# (public specs). The CPU entry is a placeholder a host overrides.
PEAK_FLOPS_TABLE: Tuple[Tuple[str, float], ...] = (
    ("h100", 989e12),
    ("cpu", 5e10),
)
PEAK_HBM_TABLE: Tuple[Tuple[str, float], ...] = (
    ("h100", 3.35e12),
    ("cpu", 20e9),
)

_peak_flops_override: Optional[float] = None
_peak_hbm_override: Optional[float] = None


def set_peak_flops(
    flops: Optional[float], hbm_bytes_per_s: Optional[float] = None
) -> None:
    """Override the per-device peak (``telemetry(peak_flops=...)``)."""
    global _peak_flops_override, _peak_hbm_override
    _peak_flops_override = float(flops) if flops else None
    if hbm_bytes_per_s is not None:
        _peak_hbm_override = float(hbm_bytes_per_s) or None


def device_kind() -> str:
    """``torch.cuda.get_device_name()`` of the current card, or ``"cpu"``
    on a host whose process has not initialized CUDA."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.get_device_name()
    return "cpu"


def _peak(table, env_key: str, override, kind: Optional[str]) -> float:
    env = os.environ.get(env_key)
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    if override:
        return override
    k = (kind or device_kind()).lower()
    for key, peak in table:
        if key in k:
            return peak
    return table[-1][1]


def peak_flops_per_device(kind: Optional[str] = None) -> float:
    return _peak(PEAK_FLOPS_TABLE, "RAY_TPU_PEAK_FLOPS", _peak_flops_override, kind)


def peak_hbm_bytes_per_s(kind: Optional[str] = None) -> float:
    return _peak(PEAK_HBM_TABLE, "RAY_TPU_PEAK_HBM_BPS", _peak_hbm_override, kind)


# -- signatures / forensics ---------------------------------------------


def _leaf_desc(x: Any) -> str:
    """``float32[128,4]``: the reference's descriptor of one leaf (numpy
    dtype names; a torch tensor by its dtype's name)."""
    dtype = getattr(x, "dtype", None)
    shape = getattr(x, "shape", None)
    if dtype is None or shape is None:
        return f"py:{type(x).__name__}={x!r}"[:64]
    name = str(dtype)
    if name.startswith("torch."):
        name = name[len("torch."):]
    return f"{name}[{','.join(str(d) for d in shape)}]"


def _flatten_with_path(tree, path: str, out: List) -> None:
    """(path, leaf) pairs in the reference's pytree order and key
    notation: sequences ``[i]``, dicts ``[repr(key)]`` in sorted key
    order, namedtuples ``.field``; None holds no leaf."""
    if tree is None:
        return
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            _flatten_with_path(v, f"{path}.{name}", out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _flatten_with_path(v, f"{path}[{i}]", out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _flatten_with_path(tree[k], f"{path}[{k!r}]", out)
    else:
        out.append((path, tree))


def signature_of(args, kwargs, static_argnames=()) -> Tuple:
    """(path → shape/dtype) signature of one call, the unit the
    forensics diff operates on. Static kwargs compare by value."""
    statics = {k: kwargs[k] for k in static_argnames if k in kwargs}
    dyn_kwargs = {k: v for k, v in kwargs.items() if k not in statics}
    flat: List = []
    _flatten_with_path((args, dyn_kwargs), "", flat)
    leaves = [(p, _leaf_desc(leaf)) for p, leaf in flat]
    for k in sorted(statics):
        leaves.append((f"static:{k}", repr(statics[k])[:64]))
    return tuple(leaves)


def diff_signatures(old: Tuple, new: Tuple) -> Dict[str, Any]:
    """What changed between two signatures: the leaf paths whose
    shape/dtype differ, plus added/removed paths."""
    a, b = dict(old), dict(new)
    changed = [
        {"path": p, "from": a[p], "to": b[p]}
        for p in a
        if p in b and a[p] != b[p]
    ]
    added = [{"path": p, "to": b[p]} for p in b if p not in a]
    removed = [{"path": p, "from": a[p]} for p in a if p not in b]
    out: Dict[str, Any] = {}
    if changed:
        out["changed"] = changed
    if added:
        out["added"] = added
    if removed:
        out["removed"] = removed
    return out


def cause_string(diff: Dict[str, Any], limit: int = 6) -> str:
    """One-line rendering of a signature diff (what the
    ``jit:recompile`` event carries)."""
    parts = []
    for c in diff.get("changed", ())[:limit]:
        parts.append(f"{c['path']}: {c['from']} -> {c['to']}")
    for c in diff.get("added", ())[:limit]:
        parts.append(f"+{c['path']}: {c['to']}")
    for c in diff.get("removed", ())[:limit]:
        parts.append(f"-{c['path']}: {c['from']}")
    n = sum(len(diff.get(k, ())) for k in ("changed", "added", "removed"))
    if n > limit:
        parts.append(f"(+{n - limit} more)")
    return "; ".join(parts) if parts else "identical abstract signature (static/config retrace)"


# -- the cost count ------------------------------------------------------


class Cost:
    """FLOPs and bytes counted over one analysis call."""

    __slots__ = ("flops", "bytes")

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0


def counting() -> bool:
    """Whether a count runs on this thread (a kernel wrapper computes
    its cost only then)."""
    return getattr(_tls, "cost", None) is not None


def add_kernel_cost(flops: float, nbytes: float) -> None:
    """A hand-written kernel's launch inside a count (the wrappers call
    this where they launch: ``ctypes`` launches are invisible to the
    dispatch mode). No-op outside a count."""
    c = getattr(_tls, "cost", None)
    if c is not None:
        c.flops += float(flops)
        c.bytes += float(nbytes)


def band_pairs(t: int, s: int, offset: Optional[int]) -> int:
    """Visible (query, key) pairs of a T x S block where key j is seen
    by query i iff ``j <= i + offset`` (None: all)."""
    if offset is None:
        return t * s
    return sum(min(s, max(0, i + offset + 1)) for i in range(t))


def tensor_bytes(tree) -> int:
    """Bytes of the tensors in ``tree`` (nested lists, tuples, dicts)."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.nbytes
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(x) for x in tree)
    if isinstance(tree, dict):
        return sum(tensor_bytes(x) for x in tree.values())
    return 0


def _counting_mode(cost: Cost):
    """A ``TorchDispatchMode`` that forwards every op and counts it. Its
    first use in a process imports ``torch._dynamo`` (seconds)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class _Counting(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            fn = flop_registry.get(func.overloadpacket)
            if fn is not None:
                cost.flops += float(fn(*args, **kwargs, out_val=out))
            if not func.is_view:
                cost.bytes += tensor_bytes(args) + tensor_bytes(kwargs) + tensor_bytes(out)
            return out

    return _Counting()


@contextlib.contextmanager
def count_costs():
    """Count the FLOPs and bytes of the ops run inside (yields a
    :class:`Cost`), or yield None when the ledger is off or light."""
    if not analyzing():
        yield None
        return
    cost = Cost()
    _tls.cost = cost
    try:
        with _counting_mode(cost):
            yield cost
    finally:
        _tls.cost = None


# -- the ledger ---------------------------------------------------------


class _ProgramEntry:
    """One program's ledger row."""

    __slots__ = (
        "label",
        "traces",
        "compile_time_s",
        "executions",
        "units",
        "device_time_s",
        "signatures",
        "causes",
        "unit_flops",
        "unit_bytes",
        "memory",
        "tid",
        "events",
    )

    def __init__(self, label: str):
        self.label = label
        self.traces = 0
        self.compile_time_s = 0.0
        self.executions = 0
        self.units = 0  # slots executed (a runner's run of k: k)
        self.device_time_s = 0.0
        self.signatures: List[Tuple] = []
        self.causes: List[Dict[str, Any]] = []
        # cost of one unit (one slot, one forward); None until counted
        self.unit_flops: Optional[float] = None
        self.unit_bytes: Optional[float] = None
        self.memory: Optional[Dict[str, Optional[float]]] = None
        self.tid = _DEVICE_TID_BASE + (zlib.crc32(label.encode()) % 0x10000)
        self.events: List[Tuple] = []  # free CUDA event pairs

    def _per_execution(self, unit: Optional[float]) -> Optional[float]:
        if unit is None:
            return None
        per = self.units / self.executions if self.executions else 1.0
        return unit * per or None

    def to_dict(self) -> Dict[str, Any]:
        flops = self._per_execution(self.unit_flops)
        nbytes = self._per_execution(self.unit_bytes)
        out: Dict[str, Any] = {
            "label": self.label,
            "traces": self.traces,
            "recompiles": max(0, self.traces - 1),
            "compile_time_s": round(self.compile_time_s, 6),
            "executions": self.executions,
            "device_time_s": round(self.device_time_s, 6),
            "donate_argnums": [],
            "in_shardings": None,
            "out_shardings": None,
            "n_devices": 1,
            "source": "live",
            "flops": flops,
            "bytes_accessed": nbytes,
            "memory": self.memory,
            "recompile_causes": [c["cause"] for c in self.causes],
        }
        out["mfu"] = program_mfu(flops, self.executions, self.device_time_s, 1)
        out["bandwidth_util"] = program_bandwidth_util(
            nbytes, self.executions, self.device_time_s, 1
        )
        return out


def program_mfu(
    flops, executions, device_time_s, n_devices, peak=None
) -> Optional[float]:
    """Executed FLOPs over the peak the busy interval could have
    delivered (``flops`` per execution)."""
    if not flops or not executions or device_time_s <= 0:
        return None
    peak = peak or peak_flops_per_device()
    return float(flops) * executions / (device_time_s * peak * max(1, n_devices))


def program_bandwidth_util(
    bytes_accessed, executions, device_time_s, n_devices, peak=None
) -> Optional[float]:
    if not bytes_accessed or not executions or device_time_s <= 0:
        return None
    peak = peak or peak_hbm_bytes_per_s()
    return float(bytes_accessed) * executions / (
        device_time_s * peak * max(1, n_devices)
    )


def _entry(label: str) -> "_ProgramEntry":
    e = _entries.get(label)
    if e is None:
        e = _entries[label] = _ProgramEntry(label)
    return e


def on_capture(
    label: str,
    signature: Optional[Tuple],
    compile_s: float,
    cost: Optional[Cost] = None,
    memory: Optional[Dict[str, Optional[float]]] = None,
    graph: bool = True,
) -> Optional[str]:
    """A capture (``graph=True``) or an eager analysis call of ``label``
    just ran, counting ``cost`` for one unit. Records the signature and,
    beyond a label's first, the recompile cause, which it returns and
    emits as a ``jit:recompile`` event."""
    if graph:
        with _LOCK:
            _captures["traces"] += 1
            _captures["compile_time_s"] += compile_s
            if label in _captured_labels:
                _captures["recompiles"] += 1
            _captured_labels.add(label)
    if not _enabled:
        return None
    cause = None
    with _LOCK:
        entry = _entry(label)
        entry.traces += 1
        entry.compile_time_s += compile_s
        if signature is not None:
            if entry.signatures:
                diff = diff_signatures(entry.signatures[-1], signature)
                cause = cause_string(diff)
                entry.causes.append({"cause": cause, "diff": diff, "ts": time.time()})
            entry.signatures.append(signature)
            del entry.signatures[:-16]
            del entry.causes[:-32]
        if cost is not None:
            entry.unit_flops = cost.flops or None
            entry.unit_bytes = cost.bytes or None
        if memory is not None:
            entry.memory = memory
    if cause is not None:
        tracing.event("jit:recompile", label=label, cause=cause)
    if cost is not None and cost.flops:
        from ray_tpu_torch.telemetry import metrics as tm

        tm.set_program_flops(label, cost.flops)
    return cause


def _known_signature(label: str, signature: Tuple) -> bool:
    """Whether ``label`` already ran an analysis call at ``signature``."""
    with _LOCK:
        e = _entries.get(label)
        return e is not None and signature in e.signatures


class _Execution:
    __slots__ = ("entry", "t_wall", "events", "units")

    def __init__(self, entry, t_wall, events, units):
        self.entry = entry
        self.t_wall = t_wall
        self.events = events
        self.units = units


def begin(label: str, device, units: int = 1) -> Optional[_Execution]:
    """Open one execution of ``label`` on ``device`` (a start event on
    the current stream of a CUDA device). None when the ledger is off."""
    if not _enabled:
        return None
    import torch

    with _LOCK:
        entry = _entry(label)
        events = None
        if torch.device(device).type == "cuda":
            events = entry.events.pop() if entry.events else (
                torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True),
            )
    if events is not None:
        events[0].record(torch.cuda.current_stream(device))
    return _Execution(entry, time.time(), events, units)


def end(execution: Optional[_Execution], device=None) -> None:
    """Close the launch side of an execution: the end event on the
    current stream; its time is read at the next :func:`drain_point`
    of this thread."""
    if execution is None:
        return
    if execution.events is not None:
        import torch

        execution.events[1].record(torch.cuda.current_stream(device))
    with _LOCK:
        execution.entry.executions += 1
        execution.entry.units += execution.units
        _pending.setdefault(threading.get_ident(), []).append(execution)
    from ray_tpu_torch.telemetry import metrics as tm

    tm.inc_program_execution(execution.entry.label)


@contextlib.contextmanager
def eager_program(label: str, device, signature_args):
    """Wrap one eager execution of ``label``: the first call at a new
    signature is its analysis call (counted, recorded as a trace, not
    an execution); the others are executions. Off: one flag check."""
    if not _enabled:
        yield
        return
    sig = signature_of(signature_args, {})
    if _known_signature(label, sig):
        ex = begin(label, device)
        yield
        end(ex, device)
        return
    t0 = time.perf_counter()
    with count_costs() as cost:
        yield
    on_capture(label, sig, time.perf_counter() - t0, cost, graph=False)


def drain_point() -> None:
    """The caller's drain just returned: close this thread's executions
    whose end event has completed (on the CPU: at this instant)."""
    if not _enabled:
        return
    tid = threading.get_ident()
    with _LOCK:
        open_ = _pending.pop(tid, ())
    now = time.time()
    left = []
    for ex in open_:
        if ex.events is not None and not ex.events[1].query():
            left.append(ex)
            continue
        _close(ex, now)
    if left:
        with _LOCK:
            _pending.setdefault(tid, [])[:0] = left


def _close(ex: _Execution, now: float) -> None:
    """Accrue one execution's time and export its span on the program's
    synthetic device lane."""
    entry = ex.entry
    if ex.events is not None:
        dt = ex.events[0].elapsed_time(ex.events[1]) / 1e3
        with _LOCK:
            entry.events.append(ex.events)
    else:
        dt = max(0.0, now - ex.t_wall)
    with _LOCK:
        entry.device_time_s += dt
    from ray_tpu_torch.telemetry import metrics as tm

    tm.add_program_device_seconds(entry.label, dt)
    if tracing.is_enabled():
        tracing.record_spans(
            [
                {
                    "trace_id": "device",
                    "span_id": f"dev-{entry.tid:x}-{next(_span_seq)}",
                    "parent_id": None,
                    "name": f"device:{entry.label}",
                    "start": ex.t_wall,
                    "end": ex.t_wall + dt,
                    "attributes": {"program": entry.label},
                    "pid": os.getpid(),
                    "tid": entry.tid,
                    "thread_name": f"device:{entry.label}",
                }
            ]
        )


# -- reads --------------------------------------------------------------


def _flush_all_pending() -> None:
    """Close every thread's open execution, waiting on each end event
    (a snapshot must not leave busy time parked)."""
    with _LOCK:
        items = list(_pending.values())
        _pending.clear()
    now = time.time()
    for open_ in items:
        for ex in open_:
            if ex.events is not None:
                ex.events[1].synchronize()
            _close(ex, now)


def recompile_causes() -> Dict[str, List[Dict[str, Any]]]:
    """``{label: [{"cause", "count"}...]}`` rollup of every recorded
    signature diff."""
    out: Dict[str, List[Dict[str, Any]]] = {}
    with _LOCK:
        entries = list(_entries.values())
    for e in entries:
        if not e.causes:
            continue
        counts: Dict[str, int] = {}
        for c in e.causes:
            counts[c["cause"]] = counts.get(c["cause"], 0) + 1
        out[e.label] = [{"cause": k, "count": v} for k, v in counts.items()]
    return out


def snapshot() -> Dict[str, Any]:
    """The ``info/device_ledger`` payload: per-program rows plus the
    aggregate MFU/bytes view. Closes open executions first."""
    _flush_all_pending()
    kind = device_kind()
    peak = peak_flops_per_device(kind)
    peak_bw = peak_hbm_bytes_per_s(kind)
    with _LOCK:
        entries = list(_entries.values())
    programs = [e.to_dict() for e in entries]
    flops_total = sum((p["flops"] or 0.0) * p["executions"] for p in programs)
    bytes_total = sum((p["bytes_accessed"] or 0.0) * p["executions"] for p in programs)
    busy = sum(
        p["device_time_s"] for p in programs if p["flops"] is not None and p["executions"]
    )
    totals = {
        "programs": len(programs),
        "executions": sum(p["executions"] for p in programs),
        "device_time_s": round(sum(p["device_time_s"] for p in programs), 6),
        "compile_time_s": round(sum(p["compile_time_s"] for p in programs), 6),
        "recompiles": sum(p["recompiles"] for p in programs),
        "flops_executed": flops_total,
        "bytes_accessed": bytes_total,
        "mfu": flops_total / (busy * peak) if busy > 0 else None,
        "bandwidth_util": bytes_total / (busy * peak_bw) if busy > 0 else None,
    }
    return {
        "device_kind": kind,
        "peak_flops_per_device": peak,
        "peak_hbm_bytes_per_s": peak_bw,
        "analyzed": _analyze,
        "programs": programs,
        "totals": totals,
        "recompile_causes": recompile_causes(),
    }


def dump(path: str) -> str:
    """Write the snapshot as JSON (the report CLI's --ledger input)."""
    with open(path, "w") as f:
        json.dump(snapshot(), f, indent=1)
    return path
