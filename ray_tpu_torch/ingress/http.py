"""The HTTP/ASGI front door: real sockets in, coalesced buckets out.

Counterpart of ``ray_tpu/ingress/http.py``: a single-threaded
**asyncio** ingress speaking HTTP/1.1 over real sockets (and ASGI 3 for
external servers), whose only work per request is admission control
and one queue append; batching lives in the
:class:`~ray_tpu_torch.ingress.router.CoalescingRouter` behind it, compute
in the replicas behind that.

Protocol:

- ``POST /v1/policy/<name>/actions`` with
  ``{"obs": [...], "explore": bool?, "deadline_ms": number?}`` →
  ``{"action": ..., "params_version": int, "logp": float?}``;
  429/503 + ``Retry-After`` when admission sheds, 504 when the deadline
  expires (before dispatch: dropped, not computed);
- ``GET /healthz`` → liveness and a per-policy router/admission summary;
- ``GET /metrics`` → 501: the reference serves its Prometheus exposition
  (``utils/metrics_exporter``, ``telemetry/fleetview``), which the port
  has not yet (ROADMAP queue 1 item 9); it never answers an empty 200.

Deployments resolve through the serve core:
:meth:`PolicyIngress.serve_deployment` wraps a named
``RunningDeployment``'s replicas behind a router fed by the controller's
membership feed; :meth:`PolicyIngress.add_policy` mounts any router.
The multi-process front-door fleet (the reference's
``ingress/supervisor.py``, N ingress processes on one port) is ROADMAP
queue 1 item 6.2; ``reuse_port`` and ``listen_sock``, the hooks it
drives, work on their own.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ray_tpu_torch.ingress.admission import AdmissionController
from ray_tpu_torch.ingress.router import (
    CoalescingRouter,
    DeadlineExpired,
    NoReplicasAvailable,
)
from ray_tpu_torch.util import telemetry

# a client may hand a trace id in this header; it is echoed in the
# response (spans themselves wait for ROADMAP queue 1 item 9)
TRACE_HEADER = "x-ray-tpu-trace"

_REASONS = {
    200: "OK",
    400: "Bad Request",
    404: "Not Found",
    405: "Method Not Allowed",
    429: "Too Many Requests",
    500: "Internal Server Error",
    501: "Not Implemented",
    503: "Service Unavailable",
    504: "Gateway Timeout",
}

# request-path diet: the response head's fixed parts are serialized
# ONCE per status at import — the per-request work is two int formats
# (length) and a join, not an f-string build + encode of the whole head
_HEAD_PREFIX = {
    status: (
        f"HTTP/1.1 {status} {reason}\r\n"
        "Content-Type: application/json\r\n"
    ).encode("latin1")
    for status, reason in _REASONS.items()
}
_CONN_KEEPALIVE = b"Connection: keep-alive\r\n\r\n"
_CONN_CLOSE = b"Connection: close\r\n\r\n"


def _head_prefix(status: int) -> bytes:
    pre = _HEAD_PREFIX.get(status)
    if pre is None:
        pre = (
            f"HTTP/1.1 {status} Unknown\r\n"
            "Content-Type: application/json\r\n"
        ).encode("latin1")
    return pre

ACTIONS_PREFIX = "/v1/policy/"
ACTIONS_SUFFIX = "/actions"


def _json_row(row: Dict[str, Any]) -> Dict[str, Any]:
    """Normalize a router result row (LocalReplica numpy payloads or
    ActorReplica's already-JSON rows) into the wire shape."""
    action = row.get("action")
    if not isinstance(action, (int, float, list, type(None))):
        action = np.asarray(action).tolist()
    out: Dict[str, Any] = {
        "action": action,
        "params_version": row.get("params_version"),
    }
    if "logp" in row:
        out["logp"] = row["logp"]
    else:
        extra = row.get("extra") or {}
        logp = extra.get("action_logp")
        if logp is not None:
            out["logp"] = float(np.asarray(logp))
    return out


class PolicyIngress:
    """The serving fleet's front door: one asyncio event loop owns
    every socket; routers own batching; admission owns backpressure.

    ``start()`` binds the listener and runs the loop on a dedicated
    thread; ``asgi_app()`` exposes the identical dispatch as an ASGI 3
    application for external servers (uvicorn et al.) — both paths
    share ``_dispatch``, so behavior cannot drift between them.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        max_inflight: int = 256,
        shed_queue_wait_s: Optional[float] = None,
        default_timeout_s: float = 60.0,
        notice_host: Optional[str] = None,
        notice_poll_s: float = 2.0,
        quotas: Optional[Dict[str, int]] = None,
        default_quota: Optional[int] = None,
        reuse_port: bool = False,
        listen_sock=None,
    ):
        self.host = host
        self._requested_port = int(port)
        self.port: Optional[int] = None
        self.default_timeout_s = float(default_timeout_s)
        # horizontal scale-out hooks (the reference's supervisor): either
        # bind our own SO_REUSEPORT socket so N sibling processes
        # share ONE port (the kernel balances connections), or accept
        # on a pre-bound listener inherited from the supervisor (the
        # fallback where SO_REUSEPORT is unavailable)
        self._reuse_port = bool(reuse_port)
        self._listen_sock = listen_sock
        # provider-notice drain (resilience/provider_notice.py): the
        # ingress is a fleet member like any learner host — on a
        # preemption notice it stops renewing keep-alive connections
        # and answers healthz 503 so load balancers route away before
        # the host dies. notice_host is the identity probed against
        # the per-host notice dir (default: this machine's hostname).
        import socket as _socket

        self.notice_host = notice_host or _socket.gethostname()
        self.notice_poll_s = float(notice_poll_s)
        self._draining = False
        self._notice_grace_s: Optional[float] = None
        self._admission_defaults = dict(
            max_inflight=max_inflight,
            shed_queue_wait_s=shed_queue_wait_s,
        )
        # per-policy quotas only mean anything against ONE shared
        # in-flight budget: with quotas configured, every mounted
        # policy (without an explicit controller) admits through this
        # shared controller, whose wait signal is the WORST signal
        # across all mounted routers
        self._shared_admission: Optional[AdmissionController] = None
        if quotas is not None or default_quota is not None:
            self._shared_admission = AdmissionController(
                wait_signal=self._worst_wait_signal,
                quotas=quotas,
                default_quota=default_quota,
                **self._admission_defaults,
            )
        # name -> (router, admission); mutated only via add/remove
        self._policies: Dict[
            str, Tuple[CoalescingRouter, AdmissionController]
        ] = {}
        self._owned_routers: list = []
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._thread: Optional[threading.Thread] = None
        self._ready = threading.Event()
        self._stop = threading.Event()

    # -- policy registry -------------------------------------------------

    def add_policy(
        self,
        name: str,
        router: CoalescingRouter,
        admission: Optional[AdmissionController] = None,
    ) -> None:
        """Mount ``router`` at ``/v1/policy/<name>/actions``. Without
        an explicit controller, one is built from the ingress defaults
        with the router's ``queue_wait_signal`` as its shed feed (the
        shared ``queue_wait_window`` accessor) — unless this ingress
        was configured with ``quotas``/``default_quota``, in which
        case every defaulted policy admits through the ONE shared,
        quota-aware controller."""
        if admission is None:
            if self._shared_admission is not None:
                admission = self._shared_admission
            else:
                admission = AdmissionController(
                    wait_signal=router.queue_wait_signal,
                    **self._admission_defaults,
                )
        self._policies[name] = (router, admission)

    def _worst_wait_signal(self) -> Optional[float]:
        """Shed feed for the shared (quota) controller: the worst p50
        queue wait across every mounted router."""
        waits = []
        for router, _ in self._policies.values():
            try:
                w = router.queue_wait_signal()
            except Exception:
                w = None
            if w is not None:
                waits.append(w)
        return max(waits) if waits else None

    def serve_deployment(self, name: str, **router_kwargs) -> None:
        """Front a serve-core deployment: resolves the
        ``RunningDeployment`` (``serve.policy_deployment`` → deploy),
        builds a router over its replica membership feed, and mounts
        it. The router keeps following the feed, so autoscaler
        scale-ups and dead-replica replacements flow through without
        re-mounting."""
        from ray_tpu_torch.serve import serve as serve_core

        dep = serve_core.get_running(name)
        if dep is None:
            raise ValueError(f"no running deployment {name!r}")
        feed = serve_core.membership_feed(name)
        _, members = feed.current()
        router = CoalescingRouter(
            name, members, membership=feed, **router_kwargs
        )
        self._owned_routers.append(router)
        self.add_policy(name, router)

    def remove_policy(self, name: str) -> None:
        self._policies.pop(name, None)

    # -- lifecycle -------------------------------------------------------

    def start(self, timeout_s: float = 10.0) -> "PolicyIngress":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._run_loop, daemon=True, name="policy_ingress",
        )
        self._thread.start()
        if not self._ready.wait(timeout_s):
            raise RuntimeError("ingress failed to bind in time")
        return self

    # ray-tpu: thread=ingress-loop
    def _run_loop(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        try:
            loop.run_until_complete(self._serve_forever())
        finally:
            try:
                loop.run_until_complete(loop.shutdown_asyncgens())
            except Exception:
                pass
            loop.close()

    async def _serve_forever(self) -> None:
        if self._listen_sock is not None:
            self._server = await asyncio.start_server(
                self._handle_conn, sock=self._listen_sock
            )
        elif self._reuse_port:
            self._server = await asyncio.start_server(
                self._handle_conn,
                self.host,
                self._requested_port,
                reuse_port=True,
            )
        else:
            self._server = await asyncio.start_server(
                self._handle_conn, self.host, self._requested_port
            )
        self.port = self._server.sockets[0].getsockname()[1]
        self._ready.set()
        watcher = asyncio.ensure_future(self._watch_notice())
        try:
            async with self._server:
                await self._server.serve_forever()
        except asyncio.CancelledError:
            pass
        finally:
            watcher.cancel()

    # ray-tpu: thread=ingress-loop
    async def _watch_notice(self) -> None:
        """Poll the provider-notice source for this host; on a notice,
        flip the ingress into draining mode: live keep-alive
        connections get ``Connection: close`` on their next response,
        ``/healthz`` answers 503 so the balancer stops sending. The
        probe reads env/files only — cheap enough for the loop."""
        from ray_tpu_torch.resilience import provider_notice

        while not self._stop.is_set():
            try:
                grace = provider_notice.probe(self.notice_host)
            except Exception:
                grace = None
            if grace is not None:
                self._draining = True
                self._notice_grace_s = grace
                return
            await asyncio.sleep(self.notice_poll_s)

    def drain(self, grace_s: Optional[float] = None) -> None:
        """Flip this ingress into draining mode NOW (the same state a
        provider notice produces): healthz answers 503, keep-alive
        connections close after their next response. The supervisor
        broadcasts this to every worker of a bank so the whole front
        door drains together."""
        self._notice_grace_s = grace_s
        self._draining = True

    @property
    def draining(self) -> bool:
        return self._draining

    def preemption_notice(self) -> Optional[float]:
        """Grace seconds from the provider notice, or None when no
        notice has been observed."""
        return self._notice_grace_s

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def stop(self, join_timeout: float = 10.0) -> None:
        self._stop.set()
        loop = self._loop
        if loop is not None and loop.is_running():
            def _shutdown():
                for task in asyncio.all_tasks():
                    task.cancel()

            try:
                loop.call_soon_threadsafe(_shutdown)
            except RuntimeError:
                pass
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=join_timeout)
        self._thread = None
        for router in self._owned_routers:
            router.stop()

    # -- socket path (asyncio HTTP/1.1) ----------------------------------

    # ray-tpu: thread=ingress-loop
    async def _handle_conn(self, reader, writer) -> None:
        """One keep-alive connection: parse → dispatch → respond,
        until the client closes. Requests on DIFFERENT connections
        interleave on the loop; batching happens in the router."""
        # one header dict per CONNECTION, cleared per request — a
        # keep-alive client paying a dict allocation per request adds
        # up at flood rates (the request-path diet)
        hdr_buf: Dict[str, str] = {}
        try:
            while not self._stop.is_set():
                request = await self._read_request(reader, hdr_buf)
                if request is None:
                    break
                method, path, headers, body = request
                status, extra_headers, payload = await self._dispatch(
                    method, path, body, headers=headers
                )
                keep_alive = (
                    headers.get("connection", "").lower() != "close"
                    # draining: answer, then close — keep-alive
                    # connections must not pin requests to a host
                    # about to be preempted
                    and not self._draining
                )
                parts = [
                    _head_prefix(status),
                    b"Content-Length: %d\r\n" % len(payload),
                ]
                for k, v in extra_headers:
                    parts.append(f"{k}: {v}\r\n".encode("latin1"))
                parts.append(
                    _CONN_KEEPALIVE if keep_alive else _CONN_CLOSE
                )
                parts.append(payload)
                writer.write(b"".join(parts))
                await writer.drain()
                if not keep_alive:
                    break
        except (
            asyncio.IncompleteReadError,
            ConnectionError,
            asyncio.CancelledError,
        ):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    @staticmethod
    async def _read_request(reader, hdr_buf: Optional[Dict] = None):
        line = await reader.readline()
        if not line or line in (b"\r\n", b"\n"):
            return None
        try:
            method, path, _version = (
                line.decode("latin1").strip().split(" ", 2)
            )
        except ValueError:
            return None
        # reuse the caller's per-connection buffer when given (the
        # request-path diet); fresh dict otherwise (ASGI adapter &c.)
        if hdr_buf is not None:
            hdr_buf.clear()
            headers = hdr_buf
        else:
            headers = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            key, _, value = h.decode("latin1").partition(":")
            headers[key.strip().lower()] = value.strip()
        length = int(headers.get("content-length", 0) or 0)
        body = await reader.readexactly(length) if length else b""
        return method.upper(), path, headers, body

    # -- shared dispatch (socket server AND the ASGI app) ----------------

    async def _dispatch(
        self,
        method: str,
        path: str,
        body: bytes,
        headers: Optional[Dict[str, str]] = None,
    ):
        """Route one request. Returns ``(status, extra_headers,
        payload_bytes)``; never raises (a handler bug answers 500).
        ``headers`` carries lowercase-keyed request headers (both the
        socket parser and the ASGI adapter normalize to this)."""
        t0 = time.perf_counter()
        route = "other"
        trace_id = (headers or {}).get(TRACE_HEADER) or None
        try:
            if path == "/healthz":
                route = "healthz"
                status, headers, payload = self._healthz()
            elif path == "/metrics":
                route = "metrics"
                status, headers, payload = self._metrics()
            elif path.startswith(ACTIONS_PREFIX) and path.endswith(
                ACTIONS_SUFFIX
            ):
                route = "actions"
                name = path[
                    len(ACTIONS_PREFIX) : -len(ACTIONS_SUFFIX)
                ]
                if method != "POST":
                    status, headers, payload = self._error(
                        405, "POST required"
                    )
                else:
                    (
                        status,
                        headers,
                        payload,
                    ) = await self._handle_actions(
                        name, body, trace_id=trace_id
                    )
                    if trace_id is not None:
                        headers = list(headers) + [
                            (TRACE_HEADER, trace_id)
                        ]
            else:
                status, headers, payload = self._error(
                    404, f"no route {path!r}"
                )
        except Exception as e:  # pragma: no cover - defensive
            status, headers, payload = self._error(500, repr(e))
        telemetry.inc_ingress_request(route, status)
        telemetry.observe_ingress_latency(
            route, time.perf_counter() - t0
        )
        return status, headers, payload

    async def _handle_actions(
        self,
        name: str,
        body: bytes,
        trace_id: Optional[str] = None,
    ):
        entry = self._policies.get(name)
        if entry is None:
            return self._error(404, f"no policy {name!r}")
        router, admission = entry
        try:
            payload = json.loads(body) if body else {}
            obs = payload["obs"]
        except Exception:
            return self._error(
                400, 'body must be JSON with an "obs" field'
            )
        explore = payload.get("explore")
        deadline_ms = payload.get("deadline_ms")
        deadline_s = (
            float(deadline_ms) / 1e3
            if deadline_ms is not None
            else None
        )
        t_req = time.perf_counter()
        with telemetry.span("ingress:request", trace_id=trace_id, policy=name):
            decision = admission.try_admit(deadline_s, policy=name)
            if decision is not None:
                return self._shed_response(decision)
            try:
                fut = router.submit(obs, explore=explore, deadline_s=deadline_s)
                timeout = (
                    deadline_s
                    if deadline_s is not None
                    else self.default_timeout_s
                )
                row = await asyncio.wait_for(
                    asyncio.wrap_future(fut), timeout=timeout + 0.25
                )
            except DeadlineExpired as e:
                return self._error(504, str(e))
            except asyncio.TimeoutError:
                return self._error(
                    504, "deadline exceeded awaiting result"
                )
            except NoReplicasAvailable as e:
                return (
                    503,
                    [("Retry-After", "1")],
                    json.dumps({"error": str(e)}).encode(),
                )
            except Exception as e:
                return self._error(500, repr(e))
            finally:
                admission.release(policy=name)
            # the overload contract (bench.py --flood): a deadlined
            # request NEVER gets a 200 past its deadline — a result
            # that raced past it while batched is worthless to the
            # client and is reported as the 504 it effectively is
            if (
                deadline_s is not None
                and time.perf_counter() - t_req > deadline_s
            ):
                return self._error(
                    504, "completed past deadline"
                )
        return (
            200,
            [],
            json.dumps(_json_row(row)).encode(),
        )

    def _shed_response(self, decision):
        retry = max(1, int(round(decision.retry_after_s)))
        return (
            decision.status,
            [("Retry-After", str(retry))],
            json.dumps(
                {
                    "error": f"shed: {decision.reason}",
                    "retry_after_s": decision.retry_after_s,
                }
            ).encode(),
        )

    def _healthz(self):
        policies = {}
        for name, (router, admission) in self._policies.items():
            policies[name] = {
                "replicas": router.num_replicas(),
                "dead_replicas": router.num_dead(),
                "queue_depth": router.stats()["queue_depth"],
                "inflight": admission.num_inflight(),
            }
        ok = (
            all(
                p["replicas"] > p["dead_replicas"]
                for p in policies.values()
            )
            and not self._draining
        )
        status = "ok" if ok else "degraded"
        if self._draining:
            status = "draining"
        return (
            200 if ok else 503,
            [],
            json.dumps(
                {
                    "status": status,
                    "policies": policies,
                    "draining": self._draining,
                }
            ).encode(),
        )

    def _metrics(self):
        return self._error(
            501,
            "/metrics needs the port's Prometheus exporter and fleet view, which are not "
            "ported yet: ROADMAP.md queue 1 item 9",
        )

    @staticmethod
    def _error(status: int, message: str):
        return (
            status,
            [],
            json.dumps({"error": message}).encode(),
        )

    # -- ASGI ------------------------------------------------------------

    def asgi_app(self):
        """An ASGI 3 application over the same dispatch: mount the
        front door in any external ASGI server without the built-in
        socket listener."""
        ingress = self

        async def app(scope, receive, send):
            if scope["type"] == "lifespan":
                while True:
                    msg = await receive()
                    if msg["type"] == "lifespan.startup":
                        await send(
                            {"type": "lifespan.startup.complete"}
                        )
                    elif msg["type"] == "lifespan.shutdown":
                        await send(
                            {"type": "lifespan.shutdown.complete"}
                        )
                        return
                return
            assert scope["type"] == "http"
            body = b""
            while True:
                msg = await receive()
                body += msg.get("body", b"")
                if not msg.get("more_body"):
                    break
            req_headers = {
                k.decode("latin1").lower(): v.decode("latin1")
                for k, v in scope.get("headers") or ()
            }
            status, extra_headers, payload = await ingress._dispatch(
                scope.get("method", "GET"), scope.get("path", "/"),
                body, headers=req_headers,
            )
            headers = [
                (b"content-type", b"application/json"),
            ] + [
                (k.lower().encode("latin1"), v.encode("latin1"))
                for k, v in extra_headers
            ]
            await send(
                {
                    "type": "http.response.start",
                    "status": status,
                    "headers": headers,
                }
            )
            await send(
                {"type": "http.response.body", "body": payload}
            )

        return app

    # -- aggregate stats -------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        return {
            "url": self.url if self.port else None,
            "policies": {
                name: {
                    "router": router.stats(),
                    "admission": admission.stats(),
                }
                for name, (router, admission) in self._policies.items()
            },
        }
