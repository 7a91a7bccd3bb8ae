"""Stdlib-only HTTP scrape endpoint: Prometheus ``/metrics`` and ``/health``.

JAX counterpart: ``torcheval_tpu/obs/httpd.py``, ported whole. An operator
points a Prometheus scraper (or ``curl``) at an evaluation host without
adding a dependency::

    srv = MetricsServer(port=0).start()   # port 0: ephemeral
    urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics")

Routes:

* ``GET /metrics``: ``obs.prometheus_text()`` (text exposition format
  0.0.4);
* ``GET /health``: JSON from the wired ``health_provider``, or a minimal
  ``{"ok": true}`` without one.

One ``ThreadingHTTPServer`` on a daemon thread: scrapes never touch the
evaluation path, a slow scraper blocks only its own connection, and
``close()`` is idempotent. Binding is loopback by default; pass
``host="0.0.0.0"`` deliberately.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional

from torcheval_tpu_torch.obs import export as _export
from torcheval_tpu_torch.obs.registry import Registry

__all__ = ["MetricsServer"]


class MetricsServer:
    """Serve ``/metrics`` (Prometheus) and ``/health`` (JSON) on a
    background thread. ``port=0`` binds an ephemeral port (read ``.port``
    after :meth:`start`)."""

    def __init__(
        self,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        registry: Optional[Registry] = None,
        health_provider: Optional[Callable[[], Dict[str, Any]]] = None,
    ) -> None:
        self._host = host
        self._bind_port = port
        self._registry = registry
        self._health_provider = health_provider
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsServer":
        if self._httpd is not None:
            return self
        registry = self._registry
        health_provider = self._health_provider

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (stdlib handler name)
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        body = _export.prometheus_text(registry).encode()
                        ctype = "text/plain; version=0.0.4; charset=utf-8"
                    elif path == "/health":
                        report = (
                            health_provider()
                            if health_provider is not None
                            else {"ok": True}
                        )
                        body = json.dumps(report, default=str).encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404, "unknown path")
                        return
                except Exception as exc:  # a broken provider must not 500
                    # the whole server into silence — report it as the body
                    body = json.dumps(
                        {"ok": False, "error": repr(exc)}
                    ).encode()
                    ctype = "application/json"
                    self.send_response(500)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args: Any) -> None:
                pass  # scrapes must not spam stderr

        self._httpd = ThreadingHTTPServer(
            (self._host, self._bind_port), _Handler
        )
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="torcheval-tpu-torch-metrics-httpd",
            daemon=True,
        )
        self._thread.start()
        return self

    @property
    def port(self) -> int:
        """The bound port (meaningful after :meth:`start`)."""
        if self._httpd is None:
            return self._bind_port
        return self._httpd.server_address[1]

    @property
    def address(self) -> tuple:
        """``(host, port)`` as bound."""
        return (self._host, self.port)

    def close(self) -> None:
        """Stop serving and release the port. Idempotent."""
        httpd, thread = self._httpd, self._thread
        self._httpd = self._thread = None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            thread.join(timeout=5.0)
