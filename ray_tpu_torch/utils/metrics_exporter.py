"""Prometheus text-format exporter for ``ray_tpu_torch.utils.metrics``.

Counterpart of ``ray_tpu/utils/metrics_exporter.py``: for the same
events the exposition text is the reference's, byte for byte, and
:class:`MetricsServer` serves it at ``/metrics``, or what its ``render`` hook returns (the
fleet view's merged multi-host exposition,
``telemetry/fleetview.render_installed``)."""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ray_tpu_torch.utils.metrics import Histogram, all_metrics


def _esc(v) -> str:
    """Prometheus label-value escaping: backslash, quote, newline."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_tags(tag_items) -> str:
    if not tag_items:
        return ""
    inner = ",".join(f'{k}="{_esc(v)}"' for k, v in tag_items)
    return "{" + inner + "}"


def format_prometheus() -> str:
    """Render every registered metric in Prometheus text format."""
    lines = []
    for m in all_metrics():
        name = m.name.replace(".", "_")
        if m.description:
            lines.append(f"# HELP {name} {m.description}")
        lines.append(f"# TYPE {name} {m.kind}")
        if isinstance(m, Histogram):
            for tags, data in m.series():
                cum = 0.0
                for b, c in zip(m.boundaries, data["buckets"]):
                    cum += c
                    t = dict(tags)
                    t["le"] = repr(float(b))
                    lines.append(
                        f"{name}_bucket{_fmt_tags(sorted(t.items()))}"
                        f" {cum}"
                    )
                total = sum(data["buckets"])
                t = dict(tags)
                t["le"] = "+Inf"
                lines.append(
                    f"{name}_bucket{_fmt_tags(sorted(t.items()))}"
                    f" {total}"
                )
                # sorted like the _bucket lines above: series keys must
                # be byte-stable across scrapes or Prometheus sees a
                # new series every time tag insertion order shifts
                lines.append(
                    f"{name}_sum{_fmt_tags(sorted(tags))} {data['sum']}"
                )
                lines.append(
                    f"{name}_count{_fmt_tags(sorted(tags))}"
                    f" {data['count']}"
                )
        else:
            for tags, value in m.series():
                lines.append(
                    f"{name}{_fmt_tags(sorted(tags))} {value}"
                )
    return "\n".join(lines) + "\n"


class MetricsServer:
    """Serves /metrics (Prometheus scrape target) from a daemon
    thread; ``port=0`` takes a free port (read it back from ``port``).

    ``render`` swaps the exposition source (the fleet view's merged
    renderer, ``fleetview.render_installed``); a renderer that raises
    or returns None falls back to the process-local exposition rather
    than failing the scrape."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, render=None):
        self.render = render
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_response(404)
                    self.end_headers()
                    return
                text = None
                if outer.render is not None:
                    try:
                        text = outer.render()
                    except Exception:
                        text = None
                if text is None:
                    text = format_prometheus()
                blob = text.encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4"
                )
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()
