"""Stdlib-only metrics scrape endpoint (DESIGN.md §15).

Optional: serving works fully without it.  :class:`MetricsServer` wraps a
``ThreadingHTTPServer`` on a daemon thread exposing a
:class:`~repro_torch.obs.metrics.MetricsRegistry`:

* ``GET /metrics``       — Prometheus text exposition (version 0.0.4)
* ``GET /metrics.json``  — the JSON snapshot (same dict the benches print)

``port=0`` binds an ephemeral port (tests); ``server.port`` reports the
bound port either way.  Rendering happens in the request handler thread —
the serving loop never blocks on a scrape.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.obs.metrics import MetricsRegistry

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    """Serve one registry's metrics over HTTP until ``stop()``."""

    def __init__(self, registry: MetricsRegistry, host: str = "127.0.0.1",
                 port: int = 0, prefix: str = "terra"):
        self.registry = registry
        self.prefix = prefix
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):                          # noqa: N802
                if self.path.split("?")[0] == "/metrics":
                    body = server.registry.prometheus_text(
                        server.prefix).encode()
                    ctype = PROM_CONTENT_TYPE
                elif self.path.split("?")[0] == "/metrics.json":
                    body = json.dumps(server.registry.snapshot()).encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):                 # quiet by default
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="terra-metrics-http",
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
