"""Continuous-batching policy serving: the inference plane.

Counterpart of ``ray_tpu/serve/policy_server.py``. Concurrent
single-observation requests coalesce into one batched forward, so a
replica's throughput scales with batch rows instead of dispatches.

- :class:`BatchedPolicyServer`: a batcher thread drains up to
  ``max_batch_size`` queued requests (or ``batch_wait_timeout_s`` after
  the first, whichever first), pads them into a small set of static
  **bucket** shapes (powers of two) and runs one program per
  ``(bucket, explore)`` pair. On the card a program is one
  ``torch.cuda.CUDAGraph``, captured at :meth:`BatchedPolicyServer.warmup`
  over static input and output buffers and replayed after that; the
  ``captures`` counter shows that no capture follows the warmup (the
  reference's ``compile_stats``). On the CPU the same body runs eagerly
  and ``captures`` counts the programs built.

  **Determinism contract**: any split of a fixed-seed request stream into
  batches gives bitwise the same actions and extras as sequential
  batch-1 ``compute_actions`` calls on a policy of the same seed. Two
  things make it hold. The random draws: a request's draws are taken
  outside the program, in arrival order, from the policy's
  ``action_generator`` with the shapes of a batch-1 call
  (``TorchPolicy.action_draws``), and copied into the program's static
  draw buffers; padded rows draw nothing, and a warmup draws nothing, so
  the generator advances once per real request. The rounding: the
  default (exact) program holds ``bucket`` batch-1 bodies, each on a
  fresh copy of its row, the ops of a batch-1 call (the reference maps
  the batch-1 body over rows with ``lax.map``). ``vectorized=True`` runs
  one batched body over the bucket instead: the throughput mode, within
  a float32 ulp or so of the exact one (a batched matrix product rounds
  apart).

  A transformer-torso policy runs the flash-attention kernel
  (``csrc/flash_fwd.cu``) inside every program: ``layers x bucket``
  launches a replay in exact mode, ``layers`` in vectorized mode. The
  kernels' launch counters count the card's launches: a capture's
  launches are taken back and added on each replay, as the superstep
  does.

  A policy whose requests may not coalesce (``supports_batched_serve``
  False: a recurrent model, or exploration with state) is served by the
  reference's sequential fallback: one ``compute_actions`` a request,
  from the model's initial state, with no program and no capture
  (``fused`` False).

- **Checkpoint hot-reload**: :class:`CheckpointWatcher` polls a training
  run's ``checkpoint_root`` through ``resilience.discovery`` and stages
  each new policy state on the server's long-poll host. The batcher
  adopts it between batches, writing into the parameters in place, so
  the captured graphs read the new weights; in-flight requests finish
  under the weights they started with, and every response carries the
  ``params_version`` that computed it.

- :class:`PolicyDeployment`: the serve-core deployment wrapper: restores
  a policy from a checkpoint (the port's, or the reference's through
  ``utils/jax_params.py``), owns a server and a watcher, and surfaces
  queue and latency stats for the serve core's autoscaler.

Threads: :meth:`BatchedPolicyServer.warmup` captures on the caller's
thread, on a side stream; the batcher replays on its own thread's
current stream and is the only thread that touches the policy after
``start``. A capture runs with ``capture_error_mode="thread_local"``, so
CUDA work that another thread of the process issues meanwhile (a learner
training the policy that is served) neither fails nor invalidates it.

Not ported: the AOT executable cache (``aot_cache=`` raises, ROADMAP
queue 1 item 6.3, with item 7's ``sharding/aot.py``); the reference's
counters and spans are ``util/telemetry.py``'s no-ops (item 9).
"""

from __future__ import annotations

import collections
import contextlib
import os
import pickle
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch.data.sample_batch import DEFAULT_POLICY_ID
from ray_tpu_torch.resilience import discovery
from ray_tpu_torch.serve.long_poll import LongPollHost
from ray_tpu_torch.util import telemetry


def _no_aot_cache(aot_cache) -> None:
    if aot_cache is not None:
        raise NotImplementedError(
            "the AOT executable cache (the reference's sharding/aot.py) is not ported yet: "
            "ROADMAP.md queue 1 item 6.3, with item 7"
        )


def device_ledger_summary(device=None) -> Optional[Dict[str, Any]]:
    """The device slice of ``stats()``: ``mfu`` (None until the device
    ledger is ported, ROADMAP queue 1 item 9) and the fraction of the
    card's memory still free, from ``torch.cuda.mem_get_info`` on
    ``device`` (the serve autoscaler's ledger signal gates scale-up on
    it). ``RAY_TPU_HBM_HEADROOM`` overrides the headroom. None when
    neither is knowable (a CPU device and no override)."""
    headroom = None
    env = os.environ.get("RAY_TPU_HBM_HEADROOM")
    if env:
        try:
            headroom = float(env)
        except ValueError:
            headroom = None
    if headroom is None and device is not None and torch.device(device).type == "cuda":
        free, total = torch.cuda.mem_get_info(torch.device(device))
        headroom = max(0.0, free / total)
    if headroom is None:
        return None
    return {"mfu": None, "hbm_headroom": headroom}


def default_buckets(max_batch_size: int) -> Tuple[int, ...]:
    """Powers of two up to (and including) ``max_batch_size``: the
    static batch shapes the server builds. log2(B_max)+1 programs cover
    every occupancy with at most 2x padding."""
    out = []
    b = 1
    while b < max_batch_size:
        out.append(b)
        b *= 2
    out.append(max_batch_size)
    return tuple(out)


class TrailingWindow:
    """The trailing-window percentile accessor of the serve plane: the
    server's ``stats()`` (the autoscaler's queue-wait signal), the
    ingress admission controller's shedding decision and the router's
    own wait tracking all read it. Samples older than ``window_s`` decay
    out, so the signal relaxes once load does."""

    def __init__(self, window_s: float = 30.0, maxlen: int = 8192):
        self.window_s = float(window_s)
        self._samples: collections.deque = collections.deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def observe(self, value: float, t: Optional[float] = None) -> None:
        with self._lock:
            self._samples.append((time.perf_counter() if t is None else t, value))

    def values(self) -> List[float]:
        cutoff = time.perf_counter() - self.window_s
        with self._lock:
            return [v for (t, v) in self._samples if t >= cutoff]

    def pct(self, q: float) -> Optional[float]:
        vals = self.values()
        if not vals:
            return None
        return float(np.percentile(np.asarray(vals), q))

    def snapshot(self) -> Dict[str, Any]:
        vals = self.values()
        arr = np.asarray(vals) if vals else None
        return {
            "p50_s": float(np.percentile(arr, 50)) if arr is not None else None,
            "p99_s": float(np.percentile(arr, 99)) if arr is not None else None,
            "n": len(vals),
            "window_s": self.window_s,
        }


class ServeFuture:
    """Per-request future that :meth:`BatchedPolicyServer.submit`
    returns. ``result()`` blocks for ``(action, extra)``;
    ``params_version`` records which weights computed it."""

    __slots__ = ("_event", "_value", "_error", "params_version", "latency_s")

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None
        self.params_version: Optional[int] = None
        self.latency_s: Optional[float] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = 60.0):
        if not self._event.wait(timeout):
            raise TimeoutError("policy-server request did not complete")
        if self._error is not None:
            raise self._error
        return self._value

    def _resolve(self, value, version: int, latency_s: float) -> None:
        self._value = value
        self.params_version = version
        self.latency_s = latency_s
        self._event.set()

    def _reject(self, err: BaseException) -> None:
        self._error = err
        self._event.set()


class _Request:
    __slots__ = ("obs", "explore", "future", "t_submit", "flush")

    def __init__(self, obs, explore, future, t_submit, flush=False):
        self.obs = obs
        self.explore = explore
        self.future = future
        self.t_submit = t_submit
        # flush hint: the tail of a router-coalesced bucket; the batcher
        # drains at once instead of waiting out the batch timeout
        self.flush = flush


class _Program:
    """One ``(bucket, explore)`` program: static device buffers for the
    observations, the draws and the exploration coefficients; the body's
    static outputs; on the card the captured graph and the kernel
    launches it holds, and pinned host buffers for the copies."""

    def __init__(self, server: "BatchedPolicyServer", bucket: int, explore: bool):
        policy = server.policy
        dev = policy.device
        self.bucket = bucket
        self.explore = explore
        self.vectorized = server.vectorized
        self.policy = policy
        self.cuda = dev.type == "cuda"
        self.obs = torch.zeros((bucket,) + server._row_shape, dtype=server._torch_dtype,
                               device=dev)
        # draw shapes from a throwaway generator: the policy's stays put
        probe = policy.action_draws(torch.Generator(device=dev), explore)
        self.draws = tuple(d.expand((bucket,) + tuple(d.shape[1:])).clone() for d in probe)
        self.coeffs = {k: torch.tensor(float(v), dtype=torch.float32, device=dev)
                       for k, v in policy.exploration.init_coeffs().items()}
        self.graph = None
        self.replays = 0  # forwards run (graph replays on the card)
        self.counts: Tuple = ()
        self.outputs: Optional[Dict[str, torch.Tensor]] = None
        self.host_obs = self.host_out = None

    def body(self) -> Dict[str, torch.Tensor]:
        """The program: ``{"actions", <extra>...}`` over the bucket."""
        policy, explore = self.policy, self.explore
        if self.vectorized:
            actions, _, extra = policy._action_step_body(
                self.obs, None, explore, coeffs=self.coeffs, draws=self.draws
            )
            return {"actions": actions, **extra}
        rows = []
        for i in range(self.bucket):
            # a fresh copy of each row, as a batch-1 call's own tensors
            draws = tuple(d[i:i + 1].clone() for d in self.draws)
            actions, _, extra = policy._action_step_body(
                self.obs[i:i + 1].clone(), None, explore, coeffs=self.coeffs, draws=draws
            )
            rows.append({"actions": actions, **extra})
        return {k: torch.cat([r[k] for r in rows]) for k in rows[0]}

    def build(self) -> None:
        """On the card: one eager run on a side stream (kernel builds,
        cuBLAS and cuDNN set-up), then the capture. On the CPU nothing:
        the body runs at each call."""
        if not self.cuda:
            return
        from ray_tpu_torch.sharding.superstep import capture_graph

        current = torch.cuda.current_stream(self.policy.device)
        stream = torch.cuda.Stream(self.policy.device)
        stream.wait_stream(current)
        with torch.no_grad():
            with torch.cuda.stream(stream):
                self.body()
            self.graph, self.counts, self.outputs = capture_graph(self.body, stream)
        current.wait_stream(stream)
        self.host_obs = torch.empty(self.obs.shape, dtype=self.obs.dtype, pin_memory=True)
        self.host_out = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                         for k, v in self.outputs.items()}

    def run(self, obs_rows: np.ndarray, draws: List[Tuple], coeff_values: Dict[str, float]):
        """One forward of ``len(obs_rows)`` rows with their draws:
        ``{name: (n, ...) host array}``."""
        n = obs_rows.shape[0]
        for k, t in self.coeffs.items():
            t.fill_(float(coeff_values[k]))
        if self.cuda:
            self.host_obs[:n].numpy()[...] = obs_rows
            self.obs[:n].copy_(self.host_obs[:n], non_blocking=True)
        else:
            self.obs[:n].copy_(torch.from_numpy(obs_rows))
        if n:
            for j, buf in enumerate(self.draws):
                buf[:n].copy_(torch.cat([d[j] for d in draws]))
        self.replays += 1
        if not self.cuda:
            with torch.no_grad():
                out = self.body()
            return {k: v[:n].numpy().copy() for k, v in out.items()}
        self.graph.replay()
        for fn, count in self.counts:
            fn.launches += count
        for k, v in self.outputs.items():
            self.host_out[k][:n].copy_(v[:n], non_blocking=True)
        torch.cuda.current_stream(self.policy.device).synchronize()
        return {k: v[:n].numpy().copy() for k, v in self.host_out.items()}


class BatchedPolicyServer:
    """Coalesces concurrent single-observation requests into batched
    programs on ``policy``'s device.

    The policy is owned by the batcher thread once it starts: weight
    swaps, coefficient updates and forwards all happen there."""

    def __init__(
        self,
        policy,
        *,
        name: str = "policy",
        max_batch_size: int = 32,
        batch_wait_timeout_s: float = 0.002,
        explore: bool = False,
        buckets: Optional[Sequence[int]] = None,
        vectorized: bool = False,
        obs_filter=None,
        preprocessor=None,
        stats_window_s: float = 30.0,
        aot_cache=None,
        start: bool = True,
    ):
        _no_aot_cache(aot_cache)
        self.policy = policy
        self.fused = bool(policy.supports_batched_serve)
        self.name = name
        self.max_batch_size = int(max_batch_size)
        if self.max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        self.batch_wait_timeout_s = float(batch_wait_timeout_s)
        self.explore = bool(explore)
        self.buckets: Tuple[int, ...] = tuple(
            sorted(set(int(b) for b in buckets)) if buckets
            else default_buckets(self.max_batch_size)
        )
        if self.buckets[-1] < self.max_batch_size:
            raise ValueError("largest bucket must cover max_batch_size")
        self.vectorized = bool(vectorized)
        self.obs_filter = obs_filter
        self.preprocessor = preprocessor
        obs_space = policy.observation_space
        self._row_shape = tuple(obs_space.shape)
        self._row_dtype = np.dtype(obs_space.dtype)
        self._torch_dtype = torch.from_numpy(np.zeros(0, self._row_dtype)).dtype
        self._programs: Dict[Tuple[int, bool], _Program] = {}
        # programs built (on the card: captures); warmup() records how
        # many it built, so stats() shows any built after it
        self.captures = 0
        self.captures_at_warmup: Optional[int] = None

        # hot-reload staging rides a long-poll host: the watcher (any
        # thread) notifies, the batcher adopts between batches
        self._swap_host = LongPollHost()
        self._applied_swap = 0
        self.params_version = 1
        self.reload_info: Optional[Dict[str, Any]] = None
        telemetry.set_serve_params_version(self.name, self.params_version)

        self._queue: "collections.deque[_Request]" = collections.deque()
        self._cv = threading.Condition()
        self._stop = threading.Event()
        self._flush_hints = 0
        self.error: Optional[BaseException] = None

        self.requests_total = 0
        self.batches_total = 0
        self.batch_rows_total = 0
        self.padded_rows_total = 0
        self.stats_window_s = float(stats_window_s)
        self._lat = TrailingWindow(self.stats_window_s)
        self._queue_wait = TrailingWindow(self.stats_window_s)

        self._thread: Optional[threading.Thread] = None
        if start:
            self.start()

    def start(self) -> None:
        """Start the batcher thread (idempotent). A deferred start lets
        a caller warm every bucket before traffic arrives."""
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"serve_batcher_{self.name}",
        )
        self._thread.start()

    # -- client side -----------------------------------------------------

    def _transform_obs(self, obs) -> np.ndarray:
        """Preprocessor, observation filter (``update=False``: serving
        traffic must not move training filter statistics) and shape and
        dtype validation."""
        if self.preprocessor is not None:
            obs = self.preprocessor.transform(obs)
        if self.obs_filter is not None:
            obs = self.obs_filter(obs, update=False)
        obs = np.asarray(obs, dtype=self._row_dtype)
        if obs.shape != self._row_shape:
            raise ValueError(f"obs shape {obs.shape} != policy row shape {self._row_shape}")
        return obs

    def submit(self, obs, explore: Optional[bool] = None) -> ServeFuture:
        """Enqueue ONE observation; returns its future. No flush hint:
        singleton submits rely on the batcher's timeout coalescing."""
        return self._enqueue([obs], explore, flush=False)[0]

    def submit_many(self, obs_rows, explore: Optional[bool] = None) -> List[ServeFuture]:
        """Enqueue a pre-coalesced run of observations atomically (one
        lock acquisition, one batcher wakeup): the ingress router's
        dispatch path. The last request carries a flush hint, so the run
        becomes one forward without waiting out the batch timeout."""
        return self._enqueue(obs_rows, explore, flush=True)

    def _enqueue(self, obs_rows, explore, flush: bool) -> List[ServeFuture]:
        if self._stop.is_set():
            raise RuntimeError("policy server is stopped")
        obs_rows = list(obs_rows)
        if not obs_rows:
            return []
        explore = self.explore if explore is None else bool(explore)
        now = time.perf_counter()
        reqs = [
            _Request(self._transform_obs(obs), explore, ServeFuture(), now,
                     flush=flush and i == len(obs_rows) - 1)
            for i, obs in enumerate(obs_rows)
        ]
        with self._cv:
            self._queue.extend(reqs)
            depth = len(self._queue)
            self.requests_total += len(reqs)
            if flush:
                self._flush_hints += 1
            self._cv.notify_all()
        telemetry.inc_serve_requests(self.name, len(reqs))
        telemetry.set_serve_queue_depth(self.name, depth)
        return [r.future for r in reqs]

    def compute_actions(self, obs_batch, explore: Optional[bool] = None):
        """Blocking convenience: submit every row of ``obs_batch`` and
        gather ``(actions, extras)`` numpy results in order."""
        futs = [self.submit(o, explore=explore) for o in obs_batch]
        outs = [f.result() for f in futs]
        actions = np.stack([a for a, _ in outs])
        extras = {k: np.stack([e[k] for _, e in outs]) for k in (outs[0][1] if outs else {})}
        return actions, extras

    # -- hot reload ------------------------------------------------------

    def update_params(self, state, *, info: Optional[Dict[str, Any]] = None) -> None:
        """Stage a new policy state (a ``get_state`` dict, the port's or
        the reference's, or bare port weights). The batcher adopts it
        between batches; a fresh stage replaces one not yet adopted."""
        self._swap_host.notify("params", (state, info))
        with self._cv:
            self._cv.notify_all()

    def _maybe_apply_params(self) -> None:
        """Batcher thread only: adopt the newest staged state, if any,
        strictly between forwards. Every setter writes into the
        parameters in place, so the captured graphs read the new
        weights."""
        ver, staged = self._swap_host.current("params")
        if ver <= self._applied_swap or staged is None:
            return
        state, info = staged
        _set_policy_state(self.policy, state)
        self._applied_swap = ver
        self.params_version += 1
        self.reload_info = info
        telemetry.set_serve_params_version(self.name, self.params_version)
        telemetry.event("serve:hot_reload", version=self.params_version)

    # -- the programs ----------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _program(self, bucket: int, explore: bool) -> _Program:
        prog = self._programs.get((bucket, explore))
        if prog is None:
            prog = _Program(self, bucket, explore)
            prog.build()
            self._programs[(bucket, explore)] = prog
            self.captures += 1
        return prog

    def forward_padded(self, obs_rows: np.ndarray, explore: Optional[bool] = None):
        """ONE forward for ``len(obs_rows)`` already-transformed rows,
        padded to the smallest covering bucket: the rows' draws are
        taken now, in order, from the policy's generator. Batcher-thread
        API; returns ``(actions, extras)`` of the real rows. Without
        ``fused``, one ``compute_actions`` a row from the initial state."""
        explore = self.explore if explore is None else bool(explore)
        n = int(obs_rows.shape[0])
        policy = self.policy
        if not self.fused:
            init = [s[None] for s in policy.get_initial_state()] or None
            outs = [policy.compute_actions(row[None], init, explore=explore) for row in obs_rows]
            extras = {k: np.concatenate([o[2][k] for o in outs]) for k in outs[0][2]}
            return np.concatenate([o[0] for o in outs]), extras
        policy.exploration.update_coeffs(policy.coeff_values, policy.global_timestep)
        prog = self._program(self._bucket_for(n), explore)
        with torch.no_grad():
            draws = [policy.action_draws(policy.action_generator, explore) for _ in range(n)]
            telemetry.add_h2d_bytes("serve", obs_rows.nbytes)
            with telemetry.span("serve:forward", bucket=prog.bucket, rows=n):
                out = prog.run(obs_rows, draws, policy.coeff_values)
        actions = out.pop("actions")
        return actions, out

    def warmup(self, explore: Optional[bool] = None) -> int:
        """Build every bucket's program for ``explore`` (default: the
        server's flag): on the card each is captured once, on the
        caller's thread. Nothing is drawn, so the request stream is
        independent of warmup. Returns the number of programs built (0
        for the sequential fallback, which has none)."""
        explore = self.explore if explore is None else bool(explore)
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("warm the server before start(): the batcher owns the policy")
        for b in self.buckets if self.fused else ():
            self._program(b, explore)
        self.captures_at_warmup = self.captures
        return len(self.buckets) if self.fused else 0

    # -- batcher thread --------------------------------------------------

    def _run(self) -> None:
        dev = self.policy.device
        try:
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                while True:
                    with self._cv:
                        while (not self._queue and not self._stop.is_set()
                               and not self._swap_pending()):
                            self._cv.wait()
                        if self._stop.is_set() and not self._queue:
                            break
                    self._maybe_apply_params()
                    batch = self._collect_batch()
                    if batch:
                        self._process_batch(batch)
                # adopt a final swap so stop() leaves a coherent version
                self._maybe_apply_params()
        except BaseException as e:
            self.error = e
            with self._cv:
                pending = list(self._queue)
                self._queue.clear()
            for req in pending:
                req.future._reject(e)

    def _swap_pending(self) -> bool:
        ver, _ = self._swap_host.current("params")
        return ver > self._applied_swap

    def _collect_batch(self) -> List[_Request]:
        """Drain up to ``max_batch_size`` same-explore requests, FIFO; a
        partial batch flushes ``batch_wait_timeout_s`` after its FIRST
        request arrived (whichever comes first)."""
        with self._cv:
            if not self._queue:
                return []
            deadline = self._queue[0].t_submit + self.batch_wait_timeout_s
            while (len(self._queue) < self.max_batch_size and not self._stop.is_set()
                   and self._flush_hints == 0):
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            batch: List[_Request] = []
            flag = self._queue[0].explore
            while (self._queue and len(batch) < self.max_batch_size
                   and self._queue[0].explore == flag):
                req = self._queue.popleft()
                if req.flush:
                    self._flush_hints -= 1
                batch.append(req)
            telemetry.set_serve_queue_depth(self.name, len(self._queue))
            return batch

    def _process_batch(self, batch: List[_Request]) -> None:
        t0 = time.perf_counter()
        n = len(batch)
        explore = batch[0].explore
        version = self.params_version
        with telemetry.span("serve:batch", rows=n, version=version):
            try:
                actions, extra = self.forward_padded(np.stack([r.obs for r in batch]),
                                                     explore=explore)
            except BaseException as e:
                for r in batch:
                    r.future._reject(e)
                raise
        results = [(actions[i], {k: v[i] for k, v in extra.items()}) for i in range(n)]
        t1 = time.perf_counter()
        # the sequential fallback runs exactly its rows
        executed = self._bucket_for(n) if self.fused else n
        self.batches_total += 1
        self.batch_rows_total += n
        self.padded_rows_total += executed - n
        telemetry.observe_serve_batch(self.name, n)
        telemetry.set_serve_batch_fill(self.name, n / executed)
        for req, value in zip(batch, results):
            lat = t1 - req.t_submit
            wait = t0 - req.t_submit
            self._lat.observe(lat, t=t1)
            self._queue_wait.observe(wait, t=t1)
            telemetry.observe_serve_latency(self.name, lat)
            telemetry.observe_serve_queue_wait(self.name, wait)
            req.future._resolve(value, version, lat)

    # -- introspection ---------------------------------------------------

    def queue_wait_window(self) -> Dict[str, Any]:
        """THE queue-wait signal: trailing-window percentiles of how long
        requests sat queued before their forward began. ``stats()`` (the
        serve autoscaler's ``queue_wait_p50_s``) and the ingress
        admission controller read this one accessor."""
        return self._queue_wait.snapshot()

    def latency_window(self) -> Dict[str, Any]:
        """Trailing-window end-to-end latency percentiles."""
        return self._lat.snapshot()

    def stats(self) -> Dict[str, Any]:
        """Queue, latency and program surface over the trailing
        ``stats_window_s``: what ``_Replica.stats`` forwards to the
        autoscaler."""
        with self._cv:
            depth = len(self._queue)
        lat = self.latency_window()
        qw = self.queue_wait_window()
        warm = self.captures_at_warmup
        return {
            "queue_depth": depth,
            "requests_total": self.requests_total,
            "batches_total": self.batches_total,
            "mean_batch_rows": (self.batch_rows_total / self.batches_total
                                if self.batches_total else 0.0),
            "padded_rows_total": self.padded_rows_total,
            # of every row the forwards executed, the fraction that was real
            "batch_fill_fraction": (
                self.batch_rows_total / (self.batch_rows_total + self.padded_rows_total)
                if self.batch_rows_total else 0.0
            ),
            "latency_p50_s": lat["p50_s"],
            "latency_p99_s": lat["p99_s"],
            "queue_wait_p50_s": qw["p50_s"],
            "queue_wait_p99_s": qw["p99_s"],
            "params_version": self.params_version,
            "vectorized": self.vectorized,
            "fused": self.fused,
            "captures": self.captures,
            "captures_after_warmup": None if warm is None else self.captures - warm,
            "device": device_ledger_summary(self.policy.device),
            "buckets": list(self.buckets),
        }

    def stop(self, join_timeout: float = 30.0) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=join_timeout)


def _set_policy_state(policy, state) -> None:
    """A staged or restored state into ``policy`` in place: a port
    ``get_state`` dict, a reference one (``utils/jax_params.py``), or
    bare port weights."""
    from ray_tpu_torch.utils.jax_params import from_jax_policy_state, is_jax_policy_state

    if isinstance(state, dict) and "weights" in state:
        if is_jax_policy_state(state):
            from_jax_policy_state(policy, state)
        else:
            policy.set_state(state)
    else:
        policy.set_weights(state)


# -- checkpoint restore / hot-reload sources ----------------------------


def load_policy_state(kind: str, path: str, policy_id: str = DEFAULT_POLICY_ID) -> Dict[str, Any]:
    """Policy state dict out of a restore target: a periodic checkpoint
    directory's ``algorithm_state.pkl`` worker state, or a stream
    snapshot's ``policy_states`` (``resilience/streamer.py``; the
    reference's snapshots too, whose nested trees ``apply_state`` carries
    in). Raises on torn or pruned targets; pollers retry next round."""
    if kind == "stream":
        with open(path, "rb") as f:
            states = pickle.load(f).get("policy_states", {})
    else:
        with open(os.path.join(path, "algorithm_state.pkl"), "rb") as f:
            state = pickle.load(f)
        states = state.get("worker", {}).get("policy_states", {})
    if policy_id not in states:
        raise KeyError(f"policy {policy_id!r} not in {kind} target {path!r} (has {sorted(states)})")
    return states[policy_id]


def restore_policy(
    checkpoint: str,
    *,
    policy_id: str = DEFAULT_POLICY_ID,
    config_overrides: Optional[Dict[str, Any]] = None,
    device=None,
):
    """Build a standalone serving policy from a periodic checkpoint, on
    ``device`` (None: the card; raises without one).

    ``checkpoint`` is a checkpoint directory or a ``checkpoint_root``
    holding ``checkpoint_*`` ones (newest wins). The stored config names
    the algorithm (its default policy class) and the env (the
    observation and action spaces); the stored worker state gives the
    weights and the observation filter's statistics. A reference
    checkpoint (flax param trees, the reference's filters) goes in
    through ``utils/jax_params.py``; unpickling it needs the reference's
    classes importable. Returns ``(policy, preprocessor, obs_filter,
    info)``."""
    path = checkpoint
    if not os.path.exists(os.path.join(path, "algorithm_state.pkl")):
        latest = discovery.latest_periodic(path)
        if latest is None:
            raise ValueError(
                f"no checkpoint under {checkpoint!r} "
                "(expected algorithm_state.pkl or checkpoint_* dirs)"
            )
        path = latest
    import json

    from ray_tpu_torch.algorithms.registry import get_algorithm_class
    from ray_tpu_torch.core import serialization
    from ray_tpu_torch.env.registry import get_env_creator
    from ray_tpu_torch.models.catalog import ModelCatalog
    from ray_tpu_torch.utils.filter import Filter, get_filter
    from ray_tpu_torch.utils.jax_params import from_jax_filter

    with open(os.path.join(path, "rllib_checkpoint.json")) as f:
        meta = json.load(f)
    with open(os.path.join(path, "algorithm_config.pkl"), "rb") as f:
        config = dict(serialization.loads(f.read()))
    config.update(config_overrides or {})
    config["num_workers"] = 0
    config.pop("_mesh", None)

    algo_cls = get_algorithm_class(meta["algorithm_name"])
    # class-level lookup only: no Algorithm (workers, envs) is built
    policy_cls = algo_cls._default_policy_class

    obs_space = config.get("observation_space")
    act_space = config.get("action_space")
    if obs_space is None or act_space is None:
        env = get_env_creator(config["env"])(dict(config.get("env_config") or {}))
        obs_space = obs_space or env.observation_space
        act_space = act_space or env.action_space
        if hasattr(env, "close"):
            try:
                env.close()
            except Exception:
                pass

    prep = ModelCatalog.get_preprocessor_for_space(obs_space)
    eff_obs_space = prep.observation_space
    policy = policy_cls(eff_obs_space, act_space, config, device=device)

    with open(os.path.join(path, "algorithm_state.pkl"), "rb") as f:
        worker_state = pickle.load(f).get("worker", {})
    pol_state = worker_state.get("policy_states", {}).get(policy_id)
    if pol_state is None:
        raise KeyError(f"policy {policy_id!r} not in checkpoint {path!r}")
    _set_policy_state(policy, pol_state)

    obs_filter = get_filter(config.get("observation_filter", "NoFilter"), eff_obs_space.shape)
    saved_filter = worker_state.get("filters", {}).get(policy_id)
    if saved_filter is not None:
        if not isinstance(saved_filter, Filter):
            saved_filter = from_jax_filter(saved_filter)
        obs_filter.sync(saved_filter)
    info = {
        "checkpoint": path,
        "algorithm": meta["algorithm_name"],
        "policy_cls": policy_cls.__name__,
    }
    return policy, prep, obs_filter, info


class CheckpointWatcher:
    """Polls a training run's ``checkpoint_root`` and pushes every new
    restore target into ``apply_fn(state, info)``. Prune-safe: targets
    deleted or torn between discovery and read are skipped and retried
    on the next poll."""

    def __init__(
        self,
        checkpoint_root: str,
        apply_fn: Callable[[Dict, Dict], None],
        *,
        policy_id: str = DEFAULT_POLICY_ID,
        poll_interval_s: float = 0.5,
        initial_version: Tuple[int, int] = (-1, -1),
        start: bool = True,
    ):
        self.checkpoint_root = checkpoint_root
        self.apply_fn = apply_fn
        self.policy_id = policy_id
        self.poll_interval_s = float(poll_interval_s)
        self.version = tuple(initial_version)
        self.num_reloads = 0
        self.last_target: Optional[str] = None
        self.error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="serve_ckpt_watcher")
            self._thread.start()

    def poll_once(self) -> bool:
        """One discovery round; True when a newer target was applied."""
        kind, path = discovery.discover(self.checkpoint_root)
        if path is None:
            return False
        if kind == "checkpoint" and not os.path.exists(os.path.join(path, "algorithm_state.pkl")):
            return False  # save in progress (state lands before meta)
        try:
            ver = discovery.target_version(kind, path)
            if tuple(ver) <= tuple(self.version):
                return False
            state = load_policy_state(kind, path, self.policy_id)
        except NotImplementedError:
            raise
        except Exception:
            return False  # pruned or torn between listdir and read
        self.apply_fn(state, {"kind": kind, "path": path, "version": tuple(ver)})
        self.version = tuple(ver)
        self.last_target = path
        self.num_reloads += 1
        return True

    def _run(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.poll_once()
            except NotImplementedError as e:
                self.error = e  # a root the port cannot follow (stats() shows it)
                return
            except Exception:
                pass  # discovery must never kill the watcher

    def stats(self) -> Dict[str, Any]:
        return {
            "version": tuple(self.version),
            "num_reloads": self.num_reloads,
            "last_target": self.last_target,
            "error": None if self.error is None else str(self.error),
        }

    def stop(self, join_timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=join_timeout)


def _json_row(action, extra, version) -> Dict[str, Any]:
    out = {"action": np.asarray(action).tolist(), "params_version": version}
    logp = extra.get("action_logp")
    if logp is not None:
        out["logp"] = float(np.asarray(logp))
    return out


class PolicyDeployment:
    """The serve-core deployment class for policy serving: restore, then
    batch-serve, then hot-reload. Deploy with :func:`policy_deployment`
    (replica actors behind a DeploymentHandle) or build one in-process.

    Calls take ``{"obs": [...], "explore": bool?}`` (or a bare obs
    array) and return ``{"action", "params_version", "logp"?}`` with
    JSON-friendly types. ``device``: where the policy serves (None: the
    card; a replica actor keeps the card only when the runtime's
    ``worker_env`` asks, so a CPU replica is built with
    ``device="cpu"``)."""

    def __init__(
        self,
        checkpoint: str,
        *,
        policy_id: str = DEFAULT_POLICY_ID,
        name: str = "policy",
        max_batch_size: int = 32,
        batch_wait_timeout_s: float = 0.002,
        explore: bool = False,
        vectorized: bool = False,
        watch: bool = True,
        poll_interval_s: float = 0.5,
        warmup: bool = True,
        aot_cache=None,
        config_overrides: Optional[Dict[str, Any]] = None,
        device=None,
    ):
        _no_aot_cache(aot_cache)
        policy, prep, obs_filter, info = restore_policy(
            checkpoint, policy_id=policy_id, config_overrides=config_overrides, device=device,
        )
        self.info = info
        self.policy_id = policy_id
        self.server = BatchedPolicyServer(
            policy,
            name=name,
            max_batch_size=max_batch_size,
            batch_wait_timeout_s=batch_wait_timeout_s,
            explore=explore,
            vectorized=vectorized,
            obs_filter=obs_filter,
            preprocessor=prep,
            start=False,
        )
        if warmup:
            self.server.warmup()
        self.server.start()
        # the watcher follows the ROOT the checkpoint came from, so a
        # live trainer writing new checkpoints refreshes this replica
        ckpt = info["checkpoint"]
        self.checkpoint_root = (
            os.path.dirname(ckpt)
            if os.path.basename(ckpt).startswith(discovery.PERIODIC_PREFIX)
            else ckpt
        )
        self.watcher = None
        if watch:
            try:
                init_ver = discovery.target_version("checkpoint", ckpt)
            except ValueError:
                init_ver = (-1, -1)
            self.watcher = CheckpointWatcher(
                self.checkpoint_root,
                lambda state, inf: self.server.update_params(state, info=inf),
                policy_id=policy_id,
                poll_interval_s=poll_interval_s,
                initial_version=init_ver,
            )

    def __call__(self, payload=None):
        if isinstance(payload, dict):
            obs = payload.get("obs")
            explore = payload.get("explore")
        else:
            obs, explore = payload, None
        fut = self.server.submit(np.asarray(obs), explore=explore)
        action, extra = fut.result()
        return _json_row(action, extra, fut.params_version)

    def compute_actions(self, obs_batch, explore=None):
        return self.server.compute_actions(obs_batch, explore=explore)

    def handle_rows(self, rows, explore=None, timeout_s: float = 60.0):
        """Batch entry point for the ingress coalescing router: one
        pre-coalesced bucket in (enqueued atomically, ``submit_many``),
        one JSON-friendly row per request out."""
        futs = self.server.submit_many([np.asarray(r) for r in rows], explore=explore)
        out = []
        for fut in futs:
            action, extra = fut.result(timeout_s)
            out.append(_json_row(action, extra, fut.params_version))
        return out

    def reconfigure(self, user_config) -> None:
        """Serve-core live config push: ``{"checkpoint": path}`` loads
        that target at once (the push-based alternative to the watcher)."""
        if not user_config:
            return
        path = user_config.get("checkpoint")
        if path:
            kind = "stream" if path.endswith(".pkl") else "checkpoint"
            state = load_policy_state(kind, path, self.policy_id)
            self.server.update_params(state, info={"kind": kind, "path": path})

    def preemption_notice(self):
        """The provider eviction probe (``resilience/provider_notice.py``)."""
        from ray_tpu_torch.resilience import provider_notice

        return provider_notice.probe()

    def stats(self) -> Dict[str, Any]:
        out = self.server.stats()
        if self.watcher is not None:
            out["reload"] = self.watcher.stats()
        out["checkpoint_root"] = self.checkpoint_root
        return out

    def stop(self) -> None:
        if self.watcher is not None:
            self.watcher.stop()
        self.server.stop()


def policy_deployment(
    checkpoint: str,
    *,
    name: str = "policy",
    num_replicas: int = 1,
    autoscaling_config: Optional[Dict] = None,
    **kwargs,
):
    """A ready-to-``serve.run`` Deployment serving ``checkpoint``: each
    replica actor restores the policy, batches its own requests and
    hot-reloads from the checkpoint root on its own."""
    from ray_tpu_torch.serve.serve import Deployment

    return Deployment(
        PolicyDeployment,
        name,
        num_replicas=num_replicas,
        init_args=(checkpoint,),
        init_kwargs=dict(kwargs, name=name),
        autoscaling_config=autoscaling_config,
    )
