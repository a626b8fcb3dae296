"""The K-update superstep: K learner updates per host call.

Counterpart of ``ray_tpu/sharding/superstep.py``. The reference fuses K
updates into one compiled program (a ``lax.scan`` over a policy's
single-update body, compiled once at K_max with an active mask, so that
every k <= K_max runs one executable). Here a :class:`SuperstepRunner`
runs an update-slot body k times:

- **On CUDA** the slot is captured once as one ``torch.cuda.CUDAGraph``
  and replayed k times; the runner is built once per (batch size,
  K_max, feed), which is the reference's one executable for every
  k <= K_max. One graph holds the whole slot (a rollout of T steps, GAE
  and the epochs x minibatches nest, or a replay draw, gather and
  update), not a step graph replayed T times beside a nest graph: the
  slot needs no host work between its steps once the superstep's draws
  and coefficients are on the card, so one replay is one host call
  whatever the slot does, and the host's share falls by the slot's
  whole launch count instead of by a step's.
- **On the CPU** the same body runs eagerly k times.

The first slot of a runner runs eagerly on the capture stream and is a
real slot: it builds the kernels (``_kernels.library`` compiles at first
use), sets up cuBLAS, cuDNN and autograd on that stream, and allocates
the output buffers. Capture then runs nothing, so no state advances
twice, and slots 2..k replay the graph.

Everything a slot reads that changes from slot to slot is on the card
before the first slot: the slot index (``slot``), the per-update
permutations, Adam's bias-correction table and step index, the
coefficients, the env carry and the replay feed. The policy's and the
engine's CUDA generators are registered with the graph, which advances
them on each replay. Per-slot outputs (stats, episode metrics, |TD|
errors) land in static (K_max, ...) buffers and are drained in one
device->host copy per superstep (:meth:`SuperstepRunner.drain`).

The kernel wrappers' ``launches`` counters are host integers that a
graph would bump once, at capture. The runner sets them back after the
capture and adds the captured counts on each replay, so they count the
launches the card makes.

A runner with a ``label`` is a program of the device ledger
(``telemetry/device.py``): its first ``run`` captures (on the CPU, runs
its first slot as the analysis call) and is recorded as a trace, with
the FLOPs and bytes of the first slot counted and the signature of
``sig_inputs`` diffed against the label's last capture; every later
``run`` is one execution, timed by a CUDA event pair around its
replays and closed at the drain.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ray_tpu_torch.telemetry import device as device_ledger

# stats key of the nan guard's skip flag (1.0: the slot's update was
# suppressed because its batch held a non-finite float)
SKIP_KEY = "superstep_skipped"


def resolve_superstep(config: Dict, device=None) -> int:
    """``config["superstep"]`` (``"auto"`` or an int) → the K fused per
    host call (1 = off). ``"auto"`` gives 8 on a CUDA device, where the
    host's launch stream is what the graphs remove, and 1 on the CPU,
    where every op is a host call either way (the reference resolves
    "auto" off on its CPU client for the same reason). An int forces
    that K anywhere."""
    mode = config.get("superstep", "auto")
    if mode in (None, False, 0, 1):
        return 1
    if mode == "auto":
        return 8 if torch.device(device or "cpu").type == "cuda" else 1
    return max(1, int(mode))


def batch_finite(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """0-d float32 1.0 when every float column of ``batch`` is free of
    NaN and Inf, else 0.0 (float columns only, as the reference)."""
    ok = None
    for v in batch.values():
        if v.is_floating_point():
            f = torch.isfinite(v).all().to(torch.float32)
            ok = f if ok is None else ok * f
    if ok is None:
        return torch.ones((), dtype=torch.float32, device=next(iter(batch.values())).device)
    return ok


def launch_counters() -> tuple:
    """The kernel wrappers whose ``launches`` a graph replay must count."""
    from ray_tpu_torch.ops import flash_attention, framestack, gae, segment_tree

    return (
        framestack.gather_rows,
        framestack.scatter_rows,
        gae.compute_gae_fragment,
        segment_tree.find_prefixsum,
        flash_attention.flash_attention,
        flash_attention.flash_block_attention_stats,
    )


def capture_graph(fn: Callable[[], object], stream, generators: Iterable[torch.Generator] = ()):
    """``fn()`` captured on ``stream`` as one CUDA graph, with
    ``generators`` registered (advanced by each replay) and garbage
    collection off: ``(graph, counts, fn's output)``. ``counts`` holds
    ``(wrapper, launches)`` for each kernel wrapper the capture
    launched; the wrappers' counters are set back, and whoever replays
    the graph adds ``counts`` on each replay. The capture's error mode
    is ``"thread_local"``: other threads (a learner beside a server's
    warmup, the main thread beside a learner thread's superstep) may
    issue CUDA work meanwhile."""
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    counters = launch_counters()
    before = [f.launches for f in counters]
    # no garbage collection during the capture: a collected graph (an
    # old runner in a reference cycle) destroys its executable, which is
    # not permitted while a stream captures and invalidates this
    # capture; torch.cuda.graph collects once before it begins
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
            out = fn()
    finally:
        if collecting:
            gc.enable()
    counts = tuple(
        (f, f.launches - n) for f, n in zip(counters, before) if f.launches != n
    )
    for f, n in zip(counters, before):
        f.launches = n
    return graph, counts, out


class SuperstepRunner:
    """Runs ``slot_fn(runner)`` k <= ``k_max`` times per :meth:`run`.

    A slot reads ``runner.slot`` (a (1,) device int64, the slot's index,
    set to 0 before the first slot and advanced after each) and writes
    its outputs with :meth:`write`. ``generators``: the CUDA generators
    the slot draws from. ``label``: the runner's name in the device
    ledger (None: not a ledger program)."""

    def __init__(
        self,
        device,
        k_max: int,
        slot_fn: Callable[["SuperstepRunner"], None],
        generators: Iterable[torch.Generator] = (),
        label: Optional[str] = None,
    ):
        self.device = torch.device(device)
        self.label = label
        # what the ledger's signature of a capture covers beside the
        # runner's own buffers (the policy's parameters and tables)
        self.sig_inputs: Dict[str, object] = {}
        self.runs = 0
        self.captures = 0
        self.k_max = int(k_max)
        self.slot_fn = slot_fn
        self.generators = tuple(g for g in generators if g.device.type == "cuda")
        self.slot = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.outputs: Dict[str, torch.Tensor] = {}
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.replays = 0
        self.drains = 0
        self._counts = ()
        # the caller's static inputs and output names: the policy sets
        # the (k_max, num_sgd_iter, B) permutations, a stacked feed's
        # (k_max, B, ...) columns and the names of a slot's stats
        self.perms: Optional[torch.Tensor] = None
        self.stacked: Optional[Dict[str, torch.Tensor]] = None
        self.stat_names: tuple = ()

    def write(self, name: str, row: torch.Tensor) -> None:
        """Inside a slot: ``row`` into output ``name`` at this slot's row
        of a static (k_max, ...) float32 buffer (made at the first
        slot, which is eager)."""
        buf = self.outputs.get(name)
        if buf is None:
            buf = self.outputs[name] = torch.zeros(
                (self.k_max,) + tuple(row.shape), dtype=torch.float32, device=self.device
            )
        buf.index_copy_(0, self.slot, row.to(torch.float32)[None])

    def _slot(self) -> None:
        self.slot_fn(self)
        self.slot.add_(1)

    def run(self, k: int, overlap: Optional[Callable[[], None]] = None) -> Dict[str, np.ndarray]:
        """k slots, then ``overlap()`` (host work whose device work may
        run beside the slots', which are launched and not waited for),
        then the drain: ``{name: (k, ...) host array}``."""
        if not 1 <= k <= self.k_max:
            raise ValueError(f"k={k} outside [1, k_max={self.k_max}]")
        self.slot.zero_()
        self.runs += 1
        if self.device.type == "cuda":
            self._run_graph(k)
        else:
            self._run_eager(k)
        if overlap is not None:
            overlap()
        return self.drain(k)

    def _run_eager(self, k: int) -> None:
        first = self.label is not None and self.runs == 1
        if first:  # the CPU's analysis call: its first slot counted
            t0 = time.perf_counter()
            with device_ledger.count_costs() as cost:
                self._slot()
            self.captures += 1
            device_ledger.on_capture(
                self.label, self._signature() if device_ledger.enabled() else None,
                time.perf_counter() - t0, cost, self._memory(None), graph=False,
            )
            k -= 1
        ex = None if first or self.label is None else device_ledger.begin(
            self.label, self.device, k
        )
        for _ in range(k):
            self._slot()
        device_ledger.end(ex, self.device)

    def _run_graph(self, k: int) -> None:
        done, ex = 0, None
        if self.graph is None:
            self._capture()
            done = 1
        elif self.label is not None:
            ex = device_ledger.begin(self.label, self.device, k)
        for _ in range(k - done):
            self.graph.replay()
            self.replays += 1
            for fn, n in self._counts:
                fn.launches += n
        device_ledger.end(ex, self.device)

    def _capture(self) -> None:
        """The eager first slot on the capture stream, then the capture
        (a trace of the device ledger when the runner has a label)."""
        t0 = time.perf_counter()
        reserved = torch.cuda.memory_reserved(self.device)
        current = torch.cuda.current_stream(self.device)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            counting = (device_ledger.count_costs() if self.label is not None
                        else contextlib.nullcontext())
            with counting as cost:
                self._slot()
        self.graph, self._counts, _ = capture_graph(self._slot, stream, self.generators)
        current.wait_stream(stream)
        self.captures += 1
        if self.label is not None:
            grown = torch.cuda.memory_reserved(self.device) - reserved
            device_ledger.on_capture(
                self.label, self._signature() if device_ledger.enabled() else None,
                time.perf_counter() - t0, cost, self._memory(float(max(0, grown))),
            )

    def _static_inputs(self) -> Dict[str, object]:
        return {"perms": self.perms, "slot": self.slot, "stacked": self.stacked}

    def _signature(self):
        return device_ledger.signature_of(
            ({**self._static_inputs(), **self.sig_inputs},), {}
        )

    def _memory(self, temp_bytes: Optional[float]) -> Optional[Dict[str, Optional[float]]]:
        if not device_ledger.enabled():
            return None
        return {
            "argument_bytes": float(device_ledger.tensor_bytes(self._static_inputs())),
            "output_bytes": float(device_ledger.tensor_bytes(self.outputs)),
            "temp_bytes": temp_bytes,
            "alias_bytes": None,
            "generated_code_bytes": None,
        }

    def drain(self, k: int) -> Dict[str, np.ndarray]:
        """Every output's first k rows to the host in one copy."""
        names = list(self.outputs)
        flat = torch.cat([self.outputs[n].reshape(-1) for n in names]).cpu().numpy()
        self.drains += 1
        device_ledger.drain_point()
        out, offset = {}, 0
        for n in names:
            buf = self.outputs[n]
            out[n] = flat[offset: offset + buf.numel()].reshape(buf.shape)[:k]
            offset += buf.numel()
        return out
