"""The serve core: model serving over replica actors.

Counterpart of ``ray_tpu/serve/serve.py``: ``@serve.deployment``,
replica actors of the port's runtime (``core/``), a round-robin
:class:`DeploymentHandle` over the long-poll membership, the
per-request HTTP proxy, queue-wait and device-ledger autoscaling with
dead-replica replacement, and the long-poll config push, on one host.

Autoscaling: a deployment may carry an ``autoscaling_config``
(:data:`DEFAULT_AUTOSCALING`); a controller thread samples the handle's
in-flight count and, when it needs them, the replicas' stats (a policy
server's queue wait and batch fill, the card's free memory), and adds or
removes replica actors. The new membership reaches handles through the
long-poll host. A replica found dead is replaced at constant size.

Config push: ``update_deployment(name, user_config=...)`` calls
``reconfigure(user_config)`` on every live replica, without a restart.

Replicas are worker processes of the port's runtime, which hide the card
unless the runtime was started with ``init(worker_env={
"RAY_TPU_WORKER_PLATFORM": "cuda"})``: a replica that serves on the card
is asked for, and one without it is built with ``device="cpu"``.
"""

from __future__ import annotations

import functools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch import core as ray
from ray_tpu_torch.core import api as core_api
from ray_tpu_torch.serve.long_poll import LongPollHost

_DEPLOYMENTS: Dict[str, "RunningDeployment"] = {}
_HTTP_SERVER = None
_LONG_POLL = LongPollHost()
_DEATH_ERRORS = (ray.RayActorError, ray.WorkerCrashedError)

DEFAULT_AUTOSCALING = {
    "min_replicas": 1,
    "max_replicas": 4,
    "target_num_ongoing_requests_per_replica": 2.0,
    "upscale_delay_s": 0.5,
    "downscale_delay_s": 2.0,
    "interval_s": 0.25,
    # queue-wait targeting: when set, replica stats (the policy server's
    # queue_wait_p50_s) join the inflight signal
    "target_queue_wait_s": None,
    # probe replica stats every N seconds even without a queue-wait
    # target, so dead replicas are replaced
    "health_check_interval_s": None,
    "stats_timeout_s": 2.0,
    # "queue_wait" (inflight + queue wait), "ledger" (batch fill with an
    # HBM-headroom gate on scale-up) or "both" (up when either runs hot,
    # down only when both have cooled)
    "signal": "queue_wait",
    "target_batch_fill": 0.85,
    "min_hbm_headroom": 0.1,
}


@ray.remote
class _Replica:
    """Hosts one instance of the deployment class."""

    def __init__(self, cls_or_fn, init_args, init_kwargs, user_config=None):
        if isinstance(cls_or_fn, type):
            self._obj = cls_or_fn(*init_args, **(init_kwargs or {}))
        elif init_args or init_kwargs:
            # function deployment: bind args become leading call args
            self._obj = functools.partial(cls_or_fn, *init_args, **(init_kwargs or {}))
        else:
            self._obj = cls_or_fn
        self.num_requests = 0
        self.num_reconfigures = 0
        if user_config is not None:
            self.reconfigure(user_config)

    def handle(self, args, kwargs):
        self.num_requests += 1
        return self._obj(*args, **kwargs)

    def call_method(self, method, args, kwargs):
        self.num_requests += 1
        return getattr(self._obj, method)(*args, **kwargs)

    def reconfigure(self, user_config):
        """In-place config update, no restart."""
        self.num_reconfigures += 1
        if hasattr(self._obj, "reconfigure"):
            self._obj.reconfigure(user_config)

    def stats(self):
        """Replica stats, merged with the wrapped object's own
        ``stats()`` when it has one: a policy server's queue and latency
        fields reach the controller's autoscaler this way."""
        out = {"num_requests": self.num_requests, "num_reconfigures": self.num_reconfigures}
        obj_stats = getattr(self._obj, "stats", None)
        if callable(obj_stats):
            try:
                out.update(obj_stats() or {})
            except Exception:
                pass
        return out


class DeploymentHandle:
    """Routing client to a replica group: round robin over the CURRENT
    membership, which a long-poll listener keeps fresh. A replica that a
    completed call showed dead (an actor-death error) leaves the
    rotation at once."""

    def __init__(self, name: str, replicas: List):
        self.name = name
        self._replicas = list(replicas)
        self._rr = 0
        self._lock = threading.Lock()
        self._inflight = 0
        self._dead: set = set()
        # start at the key's CURRENT version: a redeploy must not adopt
        # the previous generation's membership on the shared key
        self._version = _LONG_POLL.current(f"replicas:{name}")[0]
        self._stop = threading.Event()
        self._listener = threading.Thread(target=self._listen_loop, daemon=True,
                                          name=f"serve_listen_{name}")
        self._listener.start()

    def _listen_loop(self):
        while not self._stop.is_set():
            out = _LONG_POLL.listen(f"replicas:{self.name}", self._version, timeout=1.0)
            if out is None:
                continue
            version, replicas = out
            with self._lock:
                self._version = version
                self._replicas = list(replicas)
                # a republished membership supersedes local dead marks
                live = {id(r) for r in self._replicas}
                self._dead &= live

    def mark_dead(self, replica) -> None:
        """Take a replica out of this handle's rotation; the
        controller's health pass replaces it."""
        with self._lock:
            self._dead.add(id(replica))

    def num_dead(self) -> int:
        with self._lock:
            return len(self._dead)

    def _next(self):
        with self._lock:
            n = len(self._replicas)
            for _ in range(n):
                r = self._replicas[self._rr % n]
                self._rr += 1
                if id(r) not in self._dead:
                    return r
            # every member marked dead: plain round robin, so the caller
            # fails fast on the death error instead of hanging
            r = self._replicas[self._rr % n]
            self._rr += 1
            return r

    def _track(self, ref, replica=None):
        with self._lock:
            self._inflight += 1

        def done(error):
            with self._lock:
                self._inflight -= 1
            if replica is not None and isinstance(error, _DEATH_ERRORS):
                self.mark_dead(replica)

        core_api.on_ready(ref, done)
        return ref

    def num_inflight(self) -> int:
        with self._lock:
            return self._inflight

    def num_replicas(self) -> int:
        with self._lock:
            return len(self._replicas)

    def remote(self, *args, **kwargs):
        r = self._next()
        return self._track(r.handle.remote(list(args), kwargs), r)

    def method(self, name: str):
        handle = self

        class _M:
            def remote(self, *args, **kwargs):
                r = handle._next()
                return handle._track(r.call_method.remote(name, list(args), kwargs), r)

        return _M()

    def stop(self):
        self._stop.set()


def _spawn_replica_actor(spec: "Deployment", user_config):
    """Spawn one replica actor, born knowing the HTTP proxy's address
    so that code inside it can compose onto other deployments through
    :func:`get_deployment_handle`."""
    opts = {}
    if _HTTP_SERVER is not None:
        host, port = _HTTP_SERVER.server_address[:2]
        opts["runtime_env"] = {"env_vars": {"RAY_TPU_SERVE_HTTP": f"http://{host}:{port}"}}
    return _Replica.options(**opts).remote(
        spec._cls_or_fn, spec._init_args, spec._init_kwargs, user_config,
    )


def _kill_quietly(replica) -> None:
    try:
        ray.kill(replica)
    except Exception:
        pass


class RunningDeployment:
    """Controller state for one deployment: replica membership, config
    version and the autoscale loop."""

    def __init__(self, spec: "Deployment", replicas: List, handle):
        self.spec = spec
        self.name = spec.name
        self.replicas = list(replicas)
        # guards membership against the scaler thread racing
        # update_deployment / shutdown callers
        self._members_lock = threading.Lock()
        self.handle = handle
        self.user_config = spec.user_config
        self._stop = threading.Event()
        self._last_scale = time.monotonic()
        self._last_health = time.monotonic()
        self.num_replaced = 0
        self._scaler = None
        # publish the initial membership so handles listening from an
        # older generation's version converge onto THIS generation
        self._publish()
        if spec.autoscaling_config:
            cfg = {**DEFAULT_AUTOSCALING, **spec.autoscaling_config}
            # scale-to-zero is out of scope: an empty group would
            # deadlock routing
            cfg["min_replicas"] = max(1, cfg["min_replicas"])
            self.autoscaling = cfg
            self._scaler = threading.Thread(target=self._autoscale_loop, daemon=True,
                                            name=f"serve_scaler_{self.name}")
            self._scaler.start()
        else:
            self.autoscaling = None

    def _spawn_replica(self):
        return _spawn_replica_actor(self.spec, self.user_config)

    def _publish(self):
        with self._members_lock:
            members = list(self.replicas)
        _LONG_POLL.notify(f"replicas:{self.name}", members)

    def _retire(self, victim) -> None:
        """Drain, then kill. The membership was republished already; the
        grace sleep lets handles adopt it, then the actor's ordered call
        queue means a completed stats() proves every earlier request
        finished."""
        time.sleep(0.25)
        try:
            ray.get(victim.stats.remote(), timeout=30.0)
        except Exception:
            pass
        _kill_quietly(victim)

    def replica_stats(self, timeout: Optional[float] = None) -> List:
        """``[(replica, stats dict | None | "dead"), ...]`` over the
        current membership: None for a replica that missed the timeout
        (busy, not dead), ``"dead"`` on an actor-death error."""
        if timeout is None:
            timeout = (self.autoscaling or DEFAULT_AUTOSCALING)["stats_timeout_s"]
        with self._members_lock:
            members = list(self.replicas)
        refs = [(r, r.stats.remote()) for r in members]
        out = []
        for r, ref in refs:
            try:
                out.append((r, ray.get(ref, timeout=timeout)))
            except _DEATH_ERRORS:
                out.append((r, "dead"))
            except Exception:
                out.append((r, None))
        return out

    def stats(self) -> Dict:
        """Aggregated deployment stats: replica count, inflight and the
        queue aggregate the autoscaler keys off."""
        pairs = self.replica_stats()
        dicts = [s for _, s in pairs if isinstance(s, dict)]
        waits = [s["queue_wait_p50_s"] for s in dicts if s.get("queue_wait_p50_s") is not None]
        return {
            "name": self.name,
            "num_replicas": len(pairs),
            "num_replaced": self.num_replaced,
            "inflight": self.handle.num_inflight(),
            "queue_depth_total": sum(s.get("queue_depth", 0) or 0 for s in dicts),
            "queue_wait_p50_s_max": max(waits) if waits else None,
            "replicas": dicts,
        }

    def _replace_dead(self, dead: List) -> None:
        """Swap confirmed-dead replicas for fresh ones at constant size;
        the republished membership clears the handles' dead marks."""
        if not dead:
            return
        replacements = [self._spawn_replica() for _ in dead]
        with self._members_lock:
            if self._stop.is_set():
                for r in replacements:
                    _kill_quietly(r)
                return
            dead_ids = {id(r) for r in dead}
            self.replicas = [r for r in self.replicas if id(r) not in dead_ids] + replacements
        self.num_replaced += len(dead)
        self._publish()
        for r in dead:
            _kill_quietly(r)  # make sure a wedged corpse stays dead

    def _autoscale_loop(self):
        cfg = self.autoscaling
        while not self._stop.wait(cfg["interval_s"]):
            ongoing = self.handle.num_inflight()
            with self._members_lock:
                n = len(self.replicas)
            per = ongoing / max(1, n)
            target = cfg["target_num_ongoing_requests_per_replica"]
            now = time.monotonic()
            source = cfg.get("signal") or "queue_wait"
            use_queue = source in ("queue_wait", "both")
            use_ledger = source in ("ledger", "both")
            wait_target = cfg.get("target_queue_wait_s")
            health_every = cfg.get("health_check_interval_s")
            wait_signal = fill_signal = hbm_headroom = None
            need_stats = (
                wait_target is not None
                or use_ledger
                or (health_every is not None and now - self._last_health >= health_every)
            )
            if need_stats:
                self._last_health = now
                pairs = self.replica_stats(timeout=cfg["stats_timeout_s"])
                self._replace_dead([r for r, s in pairs if s == "dead"])
                dicts = [s for _, s in pairs if isinstance(s, dict)]
                waits = [s["queue_wait_p50_s"] for s in dicts
                         if s.get("queue_wait_p50_s") is not None]
                if waits:
                    wait_signal = max(waits)
                fills = [s["batch_fill_fraction"] for s in dicts
                         if s.get("batch_fill_fraction") is not None and s.get("batches_total")]
                if fills:
                    fill_signal = sum(fills) / len(fills)
                rooms = [s["device"]["hbm_headroom"] for s in dicts
                         if isinstance(s.get("device"), dict)
                         and s["device"].get("hbm_headroom") is not None]
                if rooms:
                    hbm_headroom = min(rooms)
                with self._members_lock:
                    n = len(self.replicas)
            wait_hot = wait_target is not None and wait_signal is not None and wait_signal > wait_target
            # scale-down must not race a hot queue: waits well under the
            # target (or unknown)
            wait_cool = wait_target is None or wait_signal is None or wait_signal < 0.25 * wait_target
            queue_hot = use_queue and (per > target or wait_hot)
            queue_cool = not use_queue or (per < 0.5 * target and wait_cool)
            fill_target = cfg.get("target_batch_fill") or 0.85
            ledger_hot = use_ledger and fill_signal is not None and fill_signal > fill_target
            ledger_cool = not use_ledger or fill_signal is None or fill_signal < 0.5 * fill_target
            # no room for another replica's params: an upscale only
            # trades queueing for allocator thrash
            min_room = cfg.get("min_hbm_headroom")
            hbm_blocked = (use_ledger and min_room is not None and hbm_headroom is not None
                           and hbm_headroom < min_room)
            if ((queue_hot or ledger_hot) and not hbm_blocked and n < cfg["max_replicas"]
                    and now - self._last_scale >= cfg["upscale_delay_s"]):
                replica = self._spawn_replica()
                with self._members_lock:
                    if self._stop.is_set():  # racing shutdown
                        _kill_quietly(replica)
                        return
                    self.replicas.append(replica)
                self._last_scale = now
                self._publish()
            elif (queue_cool and ledger_cool and n > cfg["min_replicas"]
                  and now - self._last_scale >= cfg["downscale_delay_s"]):
                with self._members_lock:
                    if len(self.replicas) <= cfg["min_replicas"]:
                        continue
                    victim = self.replicas.pop()
                self._last_scale = now
                self._publish()
                self._retire(victim)

    def reconfigure(self, user_config) -> None:
        """Push a new user_config to every live replica, no restart."""
        self.user_config = user_config
        with self._members_lock:
            members = list(self.replicas)
        for r in members:
            try:
                ray.get(r.reconfigure.remote(user_config))
            except Exception:
                pass  # racing a downscale: the victim needs no config
        self._publish()

    def set_num_replicas(self, n: int) -> None:
        n = max(1, n)
        victims = []
        with self._members_lock:
            while len(self.replicas) < n:
                self.replicas.append(self._spawn_replica())
            while len(self.replicas) > n:
                victims.append(self.replicas.pop())
        self._publish()
        for victim in victims:
            self._retire(victim)

    def stop(self):
        self._stop.set()
        self.handle.stop()
        with self._members_lock:
            members = list(self.replicas)
            self.replicas = []
        for r in members:
            _kill_quietly(r)


class Deployment:
    """A bound deployment, not yet running."""

    def __init__(self, cls_or_fn, name: str, num_replicas: int = 1, init_args=(),
                 init_kwargs=None, autoscaling_config: Optional[Dict] = None,
                 user_config: Optional[Any] = None):
        self._cls_or_fn = cls_or_fn
        self.name = name
        self.num_replicas = num_replicas
        self._init_args = tuple(init_args)
        self._init_kwargs = dict(init_kwargs or {})
        self.autoscaling_config = autoscaling_config
        self.user_config = user_config

    def bind(self, *args, **kwargs) -> "Deployment":
        return Deployment(self._cls_or_fn, self.name, self.num_replicas, args, kwargs,
                          self.autoscaling_config, self.user_config)

    def options(self, num_replicas: Optional[int] = None, name: Optional[str] = None,
                autoscaling_config: Optional[Dict] = None,
                user_config: Optional[Any] = None) -> "Deployment":
        return Deployment(
            self._cls_or_fn, name or self.name, num_replicas or self.num_replicas,
            self._init_args, self._init_kwargs,
            autoscaling_config if autoscaling_config is not None else self.autoscaling_config,
            user_config if user_config is not None else self.user_config,
        )

    def deploy(self) -> DeploymentHandle:
        # the replicas' remote() starts the runtime when none is running
        n = self.num_replicas
        if self.autoscaling_config:
            n = max(self.autoscaling_config.get("min_replicas", 1), 1)
        replicas = [_spawn_replica_actor(self, self.user_config) for _ in range(n)]
        old = _DEPLOYMENTS.pop(self.name, None)
        if old is not None:
            # redeploy: retire the previous generation first, or its
            # scaler keeps publishing stale membership
            old.stop()
        handle = DeploymentHandle(self.name, replicas)
        _DEPLOYMENTS[self.name] = RunningDeployment(self, replicas, handle)
        return handle


def deployment(_cls=None, *, name: Optional[str] = None, num_replicas: int = 1,
               autoscaling_config: Optional[Dict] = None, user_config: Optional[Any] = None):
    """The ``@serve.deployment`` decorator."""

    def wrap(cls):
        return Deployment(cls, name or cls.__name__, num_replicas,
                          autoscaling_config=autoscaling_config, user_config=user_config)

    if _cls is not None:
        return wrap(_cls)
    return wrap


def run(target: Deployment, *, http_host: Optional[str] = None,
        http_port: int = 0) -> DeploymentHandle:
    """Deploy, and optionally start the per-request HTTP proxy first,
    so that the deployment's replicas are born knowing its address."""
    if http_host is not None:
        _start_http(http_host, http_port)
    return target.deploy()


class DeploymentResponse:
    """Future-shaped result of an HTTP-routed handle call:
    ``.result(timeout)`` blocks for the value."""

    def __init__(self, fetch):
        self._done = threading.Event()
        self._value = None
        self._error = None

        def _run():
            try:
                self._value = fetch()
            except BaseException as e:
                self._error = e
            finally:
                self._done.set()

        threading.Thread(target=_run, daemon=True).start()

    def result(self, timeout: Optional[float] = 60.0):
        if not self._done.wait(timeout):
            raise TimeoutError("deployment call did not complete")
        if self._error is not None:
            raise self._error
        return self._value


class HTTPDeploymentHandle:
    """Handle usable from INSIDE a replica (or any process that reaches
    the proxy): calls route over HTTP, so composition needs no actor
    handles. Payloads and results are JSON."""

    def __init__(self, name: str, base_url: str):
        self.name = name
        self.url = f"{base_url.rstrip('/')}/{name}"

    def remote(self, payload=None) -> DeploymentResponse:
        import urllib.request

        def fetch():
            req = urllib.request.Request(
                self.url, data=json.dumps(payload or {}).encode(),
                headers={"Content-Type": "application/json"}, method="POST",
            )
            with urllib.request.urlopen(req, timeout=60.0) as resp:
                out = json.loads(resp.read())
            if "error" in out:
                raise RuntimeError(out["error"])
            return out["result"]

        return DeploymentResponse(fetch)


def get_deployment_handle(name: str):
    """Composition-safe handle lookup: in the controlling process the
    actor-routing :class:`DeploymentHandle`; inside a replica an
    HTTP-routing handle whose ``.remote()`` returns a
    :class:`DeploymentResponse`."""
    dep = _DEPLOYMENTS.get(name)
    if dep is not None:
        return dep.handle
    url = os.environ.get("RAY_TPU_SERVE_HTTP")
    if url:
        return HTTPDeploymentHandle(name, url)
    raise ValueError(
        f"no deployment {name!r} here and no proxy address (RAY_TPU_SERVE_HTTP): was the "
        "HTTP server started before this replica spawned?"
    )


def get_deployment(name: str) -> DeploymentHandle:
    return _DEPLOYMENTS[name].handle


def get_running(name: str) -> Optional[RunningDeployment]:
    """Controller state for the ingress front door (``ingress/http.py``)."""
    return _DEPLOYMENTS.get(name)


def membership_feed(name: str):
    """The replica-membership feed for ``name``: the long-poll key the
    controller publishes on, as a poll surface for the ingress router."""
    from ray_tpu_torch.resilience.discovery import MembershipFeed

    return MembershipFeed(_LONG_POLL, f"replicas:{name}")


def update_deployment(name: str, *, user_config: Optional[Any] = None,
                      num_replicas: Optional[int] = None) -> None:
    """Live update: user_config reconfigures replicas in place,
    num_replicas rescales the group; both reach handles without a
    restart."""
    dep = _DEPLOYMENTS[name]
    if user_config is not None:
        dep.reconfigure(user_config)
    if num_replicas is not None:
        dep.set_num_replicas(num_replicas)


def autoscale(name: str, *, signal: Optional[str] = None, **overrides: Any) -> Dict[str, Any]:
    """Retune a running deployment's autoscaler in place (the signal
    source or any :data:`DEFAULT_AUTOSCALING` knob); the loop reads its
    config every interval. Returns the effective config."""
    dep = _DEPLOYMENTS[name]
    if dep.autoscaling is None:
        raise ValueError(
            f"deployment {name!r} runs without an autoscaler; "
            "deploy with autoscaling_config= to enable one"
        )
    if signal is not None:
        if signal not in ("queue_wait", "ledger", "both"):
            raise ValueError(f"signal must be 'queue_wait', 'ledger' or 'both', got {signal!r}")
        overrides["signal"] = signal
    unknown = set(overrides) - set(DEFAULT_AUTOSCALING)
    if unknown:
        raise ValueError(f"unknown autoscaling keys: {sorted(unknown)}")
    dep.autoscaling.update(overrides)
    return dict(dep.autoscaling)


def _start_http(host: str, port: int):
    """The per-request HTTP proxy: ``POST /<deployment>`` with a JSON
    payload, one replica call per request."""
    global _HTTP_SERVER
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    if _HTTP_SERVER is not None:
        bound_host, bound_port = _HTTP_SERVER.server_address[:2]
        if (host, port) not in ((bound_host, bound_port), (bound_host, 0)):
            raise RuntimeError(
                f"HTTP proxy already bound to {bound_host}:{bound_port}; serve.shutdown() "
                f"before rebinding to {host}:{port}"
            )
        return _HTTP_SERVER

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_POST(self):
            dep = _DEPLOYMENTS.get(self.path.strip("/"))
            if dep is None:
                self.send_response(404)
                self.end_headers()
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(self.rfile.read(length)) if length else {}
                out = ray.get(dep.handle.remote(payload))
                blob = json.dumps({"result": out}).encode()
                self.send_response(200)
            except Exception as e:
                blob = json.dumps({"error": repr(e)}).encode()
                self.send_response(500)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

    class Server(ThreadingHTTPServer):
        daemon_threads = True
        # the listen backlog: socketserver's default of 5 resets
        # connections once a few dozen clients connect at once
        request_queue_size = 128

    _HTTP_SERVER = Server((host, port), Handler)
    threading.Thread(target=_HTTP_SERVER.serve_forever, daemon=True).start()
    return _HTTP_SERVER


def http_port() -> Optional[int]:
    return _HTTP_SERVER.server_address[1] if _HTTP_SERVER else None


def shutdown() -> None:
    """Stop every deployment (killing its replicas) and the proxy."""
    global _HTTP_SERVER
    for dep in _DEPLOYMENTS.values():
        dep.stop()
    _DEPLOYMENTS.clear()
    if _HTTP_SERVER is not None:
        _HTTP_SERVER.shutdown()
        _HTTP_SERVER.server_close()
        _HTTP_SERVER = None
