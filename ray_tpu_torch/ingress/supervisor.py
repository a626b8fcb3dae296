"""Horizontal front door: N ingress worker PROCESSES on ONE port.

Counterpart of ``ray_tpu/ingress/supervisor.py``. A single
:class:`~ray_tpu_torch.ingress.http.PolicyIngress` event loop is the
serving plane's aggregate-throughput ceiling: one process parses every
request, runs every admission check, serializes every response. An
:class:`IngressSupervisor` runs ``num_workers`` worker processes, each a
full ``PolicyIngress`` with its own event loop and its own
:class:`~ray_tpu_torch.ingress.router.CoalescingRouter` stack, all
accepting on the SAME ``host:port``:

- **SO_REUSEPORT** (the default wherever the kernel offers it): every
  worker binds its own listening socket on the shared port and the
  kernel balances incoming connections across the bank;
- **inherited-listener fallback**: the supervisor binds ONE listening
  socket and hands it to every worker, which accept from its one queue.

The supervisor is the bank's control plane, over one duplex pipe a
worker:

- **membership forwarding**: the supervisor follows the serve
  controller's membership feed (``serve.membership_feed``) and forwards
  ``(version, encoded-members)`` to every worker, whose router follows a
  :class:`ForwardedFeed`;
- **respawn**: a crashed worker is detected by process liveness and
  replaced; the replacement re-runs ``worker_init`` and is re-sent the
  last-known membership, drain state and merged metrics
  (``ray_tpu_ingress_workers{state=}``,
  ``ray_tpu_ingress_worker_respawns_total``);
- **whole-bank drain**: the supervisor probes
  ``resilience.provider_notice`` for its host and broadcasts the notice,
  flipping EVERY worker into the healthz-503 + connection-close drain at
  once (``drain()`` does the same on demand);
- **merged /metrics**: workers push registry snapshots
  (``telemetry.fleetview.registry_snapshot``) on their heartbeat; the
  supervisor merges them through a
  :class:`~ray_tpu_torch.telemetry.fleetview.FleetAggregator` (each
  series labelled ``host="ingress-w<i>"``) and broadcasts the merged
  exposition back, which each worker serves from ``/metrics``: ANY
  worker's scrape shows the whole bank.

**Workers are spawned, not forked** (the reference forks). A CUDA
context does not survive a fork, and a process that would start a bank
on the card has usually initialised CUDA already, so every worker starts
a fresh interpreter with a CUDA context of its own. ``worker_init``
travels to it through the object plane's serializer
(``core/serialization.dumps``): a module-level function by name, a
closure or lambda by value through cloudpickle, so closures over local
state still work; what such a closure captures must pickle (a live
socket, thread or CUDA tensor does not, where a forked worker would have
inherited it), and the spawned worker re-imports the parent's
``__main__`` module as ``__mp_main__``, so a script that starts a bank
keeps its top level behind a ``__main__`` guard. ``worker_init(ctx)``
runs INSIDE the worker with a :class:`WorkerContext` (the worker's
ingress, its index, and ``ctx.membership(name)`` feeds) and mounts
policies, typically restoring a checkpoint into an in-process replica
stack on the card. If it raises (a worker asked for the card and cannot
reach it, say), the worker reports the error and exits, and
:meth:`IngressSupervisor.start` raises: a worker never serves from
another device in its place. Serve-core actor handles are not
forwardable across processes; encode membership to descriptors your
router's ``wrap`` can resolve worker-side.
"""

from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import os
import socket
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.telemetry import metrics as telemetry_metrics

WORKER_HOST_PREFIX = "ingress-w"


def reuseport_available() -> bool:
    """Whether the kernel offers SO_REUSEPORT load-balanced binds."""
    return hasattr(socket, "SO_REUSEPORT")


class ForwardedFeed:
    """Worker-side membership surface: the router polls ``current()``
    between batches exactly like a live
    ``resilience.discovery.MembershipFeed``; the supervisor's control
    pipe pushes ``(version, payload)`` into it. ``decode`` (settable by
    ``worker_init``) maps the forwarded payload to the member list the
    router's ``wrap=`` consumes."""

    def __init__(self, name: str):
        self.name = name
        self.decode: Callable[[Any], Any] = lambda payload: payload
        self._lock = threading.Lock()
        self._version = 0
        self._payload: Any = ()

    def _set(self, version: int, payload: Any) -> None:
        with self._lock:
            self._version = int(version)
            self._payload = payload

    def current(self):
        with self._lock:
            version, payload = self._version, self._payload
        return version, self.decode(payload)


class WorkerContext:
    """What ``worker_init`` gets inside the worker process."""

    def __init__(self, ingress, index: int, feeds: Dict[str, ForwardedFeed]):
        self.ingress = ingress
        self.index = index
        self._feeds = feeds

    def membership(self, name: str) -> ForwardedFeed:
        """The forwarded membership feed for deployment ``name``: hand
        it to a router as ``membership=``."""
        feed = self._feeds.get(name)
        if feed is None:
            feed = self._feeds[name] = ForwardedFeed(name)
        return feed


class _MergedView:
    """Per-worker shim behind ``fleetview.install``: ``/metrics`` serves
    the supervisor's latest merged bank exposition; until the first
    merge arrives, ``render_installed`` returns None and the route falls
    back to the process-local exposition."""

    def __init__(self):
        self._text: Optional[str] = None

    def merged_exposition(self) -> Optional[str]:
        return self._text


def _default_encode(members) -> Any:
    """Default membership encoder: index descriptors. Actor handles (and
    arbitrary live objects) do not survive a process boundary; workers
    that need real member identity pass their own encoder."""
    return list(range(len(members)))


def _worker_main(index: int, spec: Dict[str, Any], conn) -> None:
    """Worker process entry: build the ingress, mount policies via
    ``worker_init``, then serve control messages until stopped. Runs as
    the child's MAIN thread; the heartbeat runs beside it. ``boot``
    stamps (wall clock, comparable across the host's processes) split
    the worker's start: spawned (the supervisor's stamp) → entered
    (interpreter, imports and the unpickled spec) → init_done
    (``worker_init``) → ready (the ingress bound)."""
    entered_at = time.time()
    from ray_tpu_torch.core import serialization
    from ray_tpu_torch.ingress.http import PolicyIngress
    from ray_tpu_torch.telemetry import fleetview

    boot = {"spawned_at": spec["spawned_at"], "entered_at": entered_at}
    feeds: Dict[str, ForwardedFeed] = {}
    kwargs = dict(spec.get("ingress_kwargs") or {})
    listen_sock = spec.get("listen_sock")
    if listen_sock is not None:
        ingress = PolicyIngress(spec["host"], spec["port"], listen_sock=listen_sock, **kwargs)
    else:
        ingress = PolicyIngress(spec["host"], spec["port"], reuse_port=True, **kwargs)
    ctx = WorkerContext(ingress, index, feeds)
    merged = _MergedView()
    stop_hb = threading.Event()
    send_lock = threading.Lock()  # the heartbeat and the main thread both send

    def send(msg) -> None:
        with send_lock:
            conn.send(msg)

    try:
        blob = spec.get("worker_init")
        try:
            worker_init = serialization.loads(blob) if blob is not None else None
            if worker_init is not None:
                worker_init(ctx)
        except BaseException:
            try:
                send(("error", index, traceback.format_exc()))
            except (OSError, ValueError):
                pass
            raise
        boot["init_done_at"] = time.time()
        ingress.start()
        fleetview.install(merged)
        boot["ready_at"] = time.time()

        # ray-tpu: thread=ingress-worker-hb
        def heartbeat() -> None:
            seq = 0
            host = f"{WORKER_HOST_PREFIX}{index}"
            while not stop_hb.wait(spec["heartbeat_s"]):
                snap = {
                    "host": host,
                    "seq": seq,
                    "ts": time.time(),
                    "metrics": fleetview.registry_snapshot(),
                    "spans": [],
                    "arrivals": [],
                }
                # worker_init may attach a callable as
                # ``ctx.ingress.extra_stats`` to ship custom
                # process-local numbers home (compile counters, device
                # memory, a cold start's split)
                extra = getattr(ingress, "extra_stats", None)
                try:
                    extra_out = extra() if callable(extra) else None
                except Exception:
                    extra_out = None
                stats = {
                    "pid": os.getpid(),
                    "port": ingress.port,
                    "draining": ingress.draining,
                    "ingress": ingress.stats(),
                    "boot": boot,
                    "extra": extra_out,
                }
                try:
                    send(("hb", index, snap, stats))
                except (OSError, ValueError):
                    return  # supervisor is gone; ctl loop exits too
                seq += 1

        hb = threading.Thread(target=heartbeat, daemon=True, name="ingress_worker_hb")
        hb.start()

        def handle(msg) -> bool:
            op = msg[0]
            if op == "stop":
                return False
            elif op == "membership":
                _, name, version, payload = msg
                feed = feeds.get(name)
                if feed is None:
                    feed = feeds[name] = ForwardedFeed(name)
                feed._set(version, payload)
            elif op == "drain":
                ingress.drain(msg[1])
            elif op == "merged":
                merged._text = msg[1]
            return True

        # apply the supervisor's pre-spawn replay (membership, drain,
        # merged text) BEFORE reporting ready: once ready is visible the
        # bank is expected to route
        live = True
        while live and conn.poll(0):
            live = handle(conn.recv())
        if live:
            send(("ready", index, ingress.port, os.getpid()))
        while live:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                break
            live = handle(msg)
    finally:
        stop_hb.set()
        try:
            ingress.stop()
        except Exception:
            pass
        try:
            conn.close()
        except Exception:
            pass


class _WorkerSlot:
    __slots__ = ("proc", "conn", "send_lock", "pid", "port", "stats", "ready", "error")

    def __init__(self, proc, conn):
        self.proc = proc
        self.conn = conn
        # the pump and the caller's thread (drain, stop) both send; a
        # Connection's send of a large payload is several writes
        self.send_lock = threading.Lock()
        self.pid: Optional[int] = None
        self.port: Optional[int] = None
        self.stats: Optional[Dict[str, Any]] = None
        self.ready = False
        self.error: Optional[str] = None


class IngressSupervisor:
    """Run and babysit a bank of ingress worker processes on one port.

    ``worker_init(ctx)`` runs inside EACH worker (and after every
    respawn) to mount policies; see the module docstring for how it
    travels and the membership-forwarding contract.
    ``follow_membership(name)`` subscribes the supervisor to a
    controller feed and keeps every worker's :class:`ForwardedFeed`
    current.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        num_workers: int = 2,
        worker_init: Optional[Callable[[WorkerContext], None]] = None,
        ingress_kwargs: Optional[Dict[str, Any]] = None,
        respawn: bool = True,
        poll_s: float = 0.2,
        heartbeat_s: float = 0.25,
        metrics_interval_s: float = 1.0,
        notice_host: Optional[str] = None,
        notice_poll_s: float = 2.0,
        force_inherited_listener: bool = False,
    ):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        self.host = host
        self._requested_port = int(port)
        self.port: Optional[int] = None
        self.num_workers = int(num_workers)
        self.worker_init = worker_init
        self.ingress_kwargs = dict(ingress_kwargs or {})
        self.respawn = bool(respawn)
        self.poll_s = float(poll_s)
        self.heartbeat_s = float(heartbeat_s)
        self.metrics_interval_s = float(metrics_interval_s)
        self.notice_host = notice_host or socket.gethostname()
        self.notice_poll_s = float(notice_poll_s)
        self._use_reuseport = reuseport_available() and not force_inherited_listener
        self._mp = multiprocessing.get_context("spawn")
        self._init_blob: Optional[bytes] = None
        self._probe_sock: Optional[socket.socket] = None
        self._listen_sock: Optional[socket.socket] = None
        self._slots: List[Optional[_WorkerSlot]] = []
        self._feeds: Dict[str, Any] = {}
        self._feed_state: Dict[str, tuple] = {}  # name -> (ver, payload)
        self._feed_encode: Dict[str, Callable] = {}
        self._agg = None
        self._merged_text: Optional[str] = None
        self._draining = False
        self._drain_grace: Optional[float] = None
        self.respawned_total = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_merge = 0.0
        self._last_notice_probe = 0.0

    # -- controller-side membership feeds --------------------------------

    def follow_membership(self, name: str, feed=None,
                          encode: Optional[Callable[[Any], Any]] = None) -> None:
        """Follow deployment ``name``'s controller feed and forward
        version bumps to every worker. ``feed`` defaults to
        ``serve.membership_feed(name)``; ``encode`` maps the live member
        list to a picklable payload the workers' ``decode`` / router
        ``wrap=`` resolve (default: index descriptors)."""
        if feed is None:
            from ray_tpu_torch.serve import serve as serve_core

            feed = serve_core.membership_feed(name)
        with self._lock:
            self._feeds[name] = feed
            self._feed_encode[name] = encode or _default_encode

    # -- lifecycle -------------------------------------------------------

    def start(self, timeout_s: float = 60.0) -> "IngressSupervisor":
        """Bind the shared port, spawn the bank and wait until every
        worker reports ready. Raises when a worker's ``worker_init``
        fails or the bank is not up within ``timeout_s`` (a spawned
        worker imports torch and builds its replicas before it is
        ready)."""
        if self._thread is not None:
            return self
        from ray_tpu_torch.core import serialization
        from ray_tpu_torch.telemetry.fleetview import FleetAggregator

        self._agg = FleetAggregator(kv=None, subscribe=False)
        self._init_blob = (
            serialization.dumps(self.worker_init) if self.worker_init is not None else None
        )
        if self._use_reuseport:
            # reserve the port with a held (never-listening) member of
            # the reuseport group; workers bind their own listeners
            probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            probe.bind((self.host, self._requested_port))
            self._probe_sock = probe
            self.port = probe.getsockname()[1]
        else:
            # the fallback: ONE listener bound here, its descriptor
            # handed to every worker, which accept from its queue
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((self.host, self._requested_port))
            srv.listen(128)
            self._listen_sock = srv
            self.port = srv.getsockname()[1]
        # seed feed state BEFORE the first spawn so every worker's replay
        # already carries membership: no window where a bound worker
        # accepts requests it cannot route
        self._check_feeds()
        self._slots = [None] * self.num_workers
        for i in range(self.num_workers):
            self._spawn(i)
        deadline = time.monotonic() + timeout_s
        failure = None
        while time.monotonic() < deadline:
            self._service_conns(timeout=0.05)
            failure = next(
                ((i, s.error) for i, s in enumerate(self._slots) if s is not None and s.error),
                None,
            )
            if failure is not None:
                break
            if all(s is not None and s.ready for s in self._slots):
                break
        else:
            self.stop()
            raise RuntimeError("ingress workers failed to come up in time")
        if failure is not None:
            self.stop()
            raise RuntimeError(f"ingress worker {failure[0]} failed in worker_init:\n{failure[1]}")
        telemetry_metrics.set_ingress_workers("target", self.num_workers)
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name="ingress_supervisor")
        self._thread.start()
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    @property
    def draining(self) -> bool:
        return self._draining

    def _spawn(self, index: int) -> None:
        parent_conn, child_conn = self._mp.Pipe(duplex=True)
        spec = {
            "host": self.host,
            "port": self.port,
            "listen_sock": self._listen_sock,
            "ingress_kwargs": self.ingress_kwargs,
            "worker_init": self._init_blob,
            "heartbeat_s": self.heartbeat_s,
            "spawned_at": time.time(),
        }
        proc = self._mp.Process(target=_worker_main, args=(index, spec, child_conn),
                                daemon=True, name=f"ingress_worker_{index}")
        proc.start()
        child_conn.close()  # parent's copy; child keeps its own
        slot = _WorkerSlot(proc, parent_conn)
        self._slots[index] = slot
        # replay control state so a respawned worker converges onto the
        # bank: last-known membership per feed, drain, merged text
        with self._lock:
            states = dict(self._feed_state)
            draining = self._draining
            grace = self._drain_grace
            merged = self._merged_text
        for name, (version, payload) in states.items():
            self._send(slot, ("membership", name, version, payload))
        if draining:
            self._send(slot, ("drain", grace))
        if merged is not None:
            self._send(slot, ("merged", merged))

    @staticmethod
    def _send(slot: _WorkerSlot, msg) -> bool:
        try:
            with slot.send_lock:
                slot.conn.send(msg)
            return True
        except (OSError, ValueError, BrokenPipeError):
            return False

    def _broadcast(self, msg) -> None:
        for slot in self._slots:
            if slot is not None and slot.proc.is_alive():
                self._send(slot, msg)

    # -- the control pump -------------------------------------------------

    # ray-tpu: thread=ingress-supervisor
    def _pump(self) -> None:
        while not self._stop.is_set():
            try:
                self._service_conns(timeout=self.poll_s)
                self._check_feeds()
                self._check_notice()
                self._merge_metrics()
                self._reap_and_respawn()
            except Exception:
                # the bank must survive any one pump hiccup
                time.sleep(self.poll_s)

    def _service_conns(self, timeout: float) -> None:
        conns = {slot.conn: slot for slot in self._slots if slot is not None}
        if not conns:
            time.sleep(timeout)
            return
        try:
            ready = multiprocessing.connection.wait(list(conns), timeout=timeout)
        except OSError:
            return
        for conn in ready:
            slot = conns[conn]
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                continue  # liveness check handles the corpse
            op = msg[0]
            if op == "ready":
                _, _idx, port, pid = msg
                slot.port = port
                slot.pid = pid
                slot.ready = True
            elif op == "hb":
                _, _idx, snap, stats = msg
                slot.stats = stats
                slot.pid = stats.get("pid", slot.pid)
                if self._agg is not None:
                    self._agg.ingest(snap)
            elif op == "error":
                slot.error = msg[2]

    def _check_feeds(self) -> None:
        with self._lock:
            feeds = dict(self._feeds)
        for name, feed in feeds.items():
            try:
                version, members = feed.current()
            except Exception:
                continue
            with self._lock:
                prev = self._feed_state.get(name)
                if prev is not None and prev[0] == version:
                    continue
                try:
                    payload = self._feed_encode[name](members)
                except Exception:
                    continue
                self._feed_state[name] = (version, payload)
            self._broadcast(("membership", name, version, payload))

    def _check_notice(self) -> None:
        if self._draining:
            return
        now = time.monotonic()
        if now - self._last_notice_probe < self.notice_poll_s:
            return
        self._last_notice_probe = now
        try:
            from ray_tpu_torch.resilience import provider_notice

            grace = provider_notice.probe(self.notice_host)
        except Exception:
            grace = None
        if grace is not None:
            self.drain(grace)

    def _merge_metrics(self) -> None:
        now = time.monotonic()
        if now - self._last_merge < self.metrics_interval_s:
            return
        self._last_merge = now
        telemetry_metrics.set_ingress_workers("live", self.num_live())
        if self._agg is None:
            return
        try:
            text = self._agg.merged_exposition()
        except Exception:
            return
        with self._lock:
            self._merged_text = text
        self._broadcast(("merged", text))

    def _reap_and_respawn(self) -> None:
        if self._stop.is_set():
            return
        for i, slot in enumerate(self._slots):
            if slot is None or slot.proc.is_alive():
                continue
            try:
                slot.conn.close()
            except Exception:
                pass
            if not self.respawn:
                continue
            self.respawned_total += 1
            telemetry_metrics.inc_ingress_worker_respawns()
            self._spawn(i)

    # -- bank-wide operations ---------------------------------------------

    def drain(self, grace_s: Optional[float] = None) -> None:
        """Drain the WHOLE bank: every worker flips to healthz-503 +
        connection-close at once (the provider-notice path, per
        process)."""
        with self._lock:
            self._draining = True
            self._drain_grace = grace_s
        self._broadcast(("drain", grace_s))

    def merged_metrics(self) -> Optional[str]:
        """The bank's merged Prometheus exposition (what any worker's
        ``/metrics`` serves once the first merge propagated)."""
        if self._agg is None:
            return None
        return self._agg.merged_exposition()

    def num_live(self) -> int:
        return sum(1 for s in self._slots if s is not None and s.proc.is_alive())

    def worker_pids(self) -> List[Optional[int]]:
        return [(s.proc.pid if s is not None else None) for s in self._slots]

    def worker_stats(self) -> Dict[int, Optional[Dict[str, Any]]]:
        """Last heartbeat-reported stats per worker index (with the
        worker's ``boot`` stamps and ``worker_init``'s ``extra``)."""
        return {i: (s.stats if s is not None else None) for i, s in enumerate(self._slots)}

    def stats(self) -> Dict[str, Any]:
        return {
            "url": self.url if self.port else None,
            "num_workers": self.num_workers,
            "num_live": self.num_live(),
            "respawned_total": self.respawned_total,
            "draining": self._draining,
            "reuseport": self._use_reuseport,
            "feeds": sorted(self._feeds),
        }

    def stop(self, join_timeout: float = 10.0) -> None:
        self._stop.set()
        self._broadcast(("stop",))
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=join_timeout)
        self._thread = None
        deadline = time.monotonic() + join_timeout
        for slot in self._slots:
            if slot is None:
                continue
            slot.proc.join(timeout=max(0.1, deadline - time.monotonic()))
            if slot.proc.is_alive():
                slot.proc.terminate()
                slot.proc.join(timeout=2.0)
            if slot.proc.is_alive():
                slot.proc.kill()
                slot.proc.join(timeout=2.0)
            try:
                slot.conn.close()
            except Exception:
                pass
        self._slots = []
        for sockobj in (self._probe_sock, self._listen_sock):
            if sockobj is not None:
                try:
                    sockobj.close()
                except OSError:
                    pass
        self._probe_sock = None
        self._listen_sock = None
