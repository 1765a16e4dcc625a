"""The obs HTTP server: /metrics, /snapshot, /healthz on a thread (the
port's copy of ``repro.launch.obs_server``, over the port's registry).

Vertica's Data Collector made the engine's telemetry a queryable
service; the equivalent here is a tiny stdlib ``ThreadingHTTPServer``
(no new dependencies) exposing the one metrics registry:

* ``GET /metrics``  — Prometheus text exposition
  (:func:`repro_torch.obs.export.render_prometheus`), scrapeable by any
  Prometheus-compatible collector or a plain curl.
* ``GET /snapshot`` — the JSON operational snapshot
  (:func:`repro_torch.obs.export.snapshot_payload`): raw registry, flight-
  ring status, recent SLO breaches, critical-path attribution of the
  last-N spans.
* ``GET /healthz``  — liveness (``ok``).

One module-global server per process (mirroring the registry it
exposes); ``start()`` is idempotent, ``stop()`` tears it down and is
what the test fixture calls. The handler threads only *read* registry
snapshots (callback gauges run under the registry lock), so serving a
scrape never blocks the pump. ``serve_analytics(obs_port=...)`` starts
one next to the serving engine; ``port=0`` binds an ephemeral port
(read it back from ``server.port``). A port that cannot be bound
raises ``OSError`` from ``start``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from repro_torch.obs import export


class _Handler(BaseHTTPRequestHandler):
    # quiet: the serving loop's stdout is not an access log
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    def _reply(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (http.server API)
        try:
            if self.path == "/metrics":
                self._reply(
                    200, export.render_prometheus().encode(),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
            elif self.path == "/snapshot":
                self._reply(
                    200,
                    json.dumps(
                        export.snapshot_payload(), default=str
                    ).encode(),
                    "application/json",
                )
            elif self.path == "/healthz":
                self._reply(200, b"ok\n", "text/plain; charset=utf-8")
            else:
                self._reply(
                    404, b"not found\n", "text/plain; charset=utf-8"
                )
        except BrokenPipeError:
            pass  # scraper hung up mid-reply; nothing to clean up


class ObsServer:
    """One registry-exposition server on a daemon thread."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="repro-torch-obs-server",
            daemon=True,
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


_SERVER: Optional[ObsServer] = None


def start(port: int = 0, host: str = "127.0.0.1") -> ObsServer:
    """Start (or return) the process obs server. Idempotent: a live
    server is returned as-is — there is one registry, so one server."""
    global _SERVER
    if _SERVER is None:
        _SERVER = ObsServer(port, host)
    return _SERVER


def get() -> Optional[ObsServer]:
    return _SERVER


def stop() -> None:
    """Stop the process obs server if one is live (idempotent)."""
    global _SERVER
    if _SERVER is not None:
        _SERVER.stop()
        _SERVER = None
