"""Shared stdlib HTTP service scaffolding: the port of
``horovod_tpu/utils/httpd.py``, the same code (stdlib only).

In the JAX package two subsystems serve HTTP from a daemon
``ThreadingHTTPServer``: the per-rank telemetry plane
(``telemetry/server.py`` — /metrics, /healthz, /flightrec, /profile) and
the serving frontends (``serve/server.py``, ``serve/fleet/frontend.py``
— streaming /generate). Both need the same boilerplate — a quiet handler
base with a content-length'd ``_respond``, an ephemeral-port-capable
bind, a named daemon serve thread, and an idempotent stop that joins —
and ``run/rendezvous.py`` already grew a third hand-rolled copy for the
launcher KV store (kept separate: its HMAC-authenticated PUT/DELETE
protocol shares none of this surface). This module is the one copy the
two service planes build on.

Port-collision policy stays with the caller: :meth:`HttpService.start`
raises the bind ``OSError`` untouched — ``runtime/services.py`` logs and
runs without a scrape plane, ``hvdrun`` pre-validates its
``--metrics-port`` fan-out, and ``hvd-serve-torch`` treats a taken port as
fatal. One mechanism, three policies.
"""

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

logger = logging.getLogger("horovod_tpu_torch")


class QuietHandler(BaseHTTPRequestHandler):
    """Handler base: stderr chatter demoted to debug logging, plus the
    ``_respond`` helpers every endpoint uses. ``log_name`` labels the
    debug lines with the owning service."""

    log_name = "http"

    def log_message(self, fmt, *args):  # no stderr chatter
        logger.debug(self.log_name + " server: " + fmt, *args)

    def _respond(self, code, body, ctype):
        data = body if isinstance(body, bytes) else body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _respond_json(self, code, obj):
        self._respond(code, json.dumps(obj), "application/json")


class HttpService:
    """start/stop lifecycle around one daemon ``ThreadingHTTPServer``.

    ``port=0`` binds an ephemeral port (the bound port is in ``.port``
    after :meth:`start`). Subclasses provide :meth:`_handler_class` —
    typically a closure over ``self`` returning a :class:`QuietHandler`
    subclass — and may extend :meth:`stop` (idempotent, joins the serve
    thread) with their own teardown."""

    thread_name = "hvd_tpu_http"

    def __init__(self, addr="127.0.0.1", port=0):
        self._addr = addr
        self._want_port = port
        self._httpd = None
        self._thread = None
        self.port = None

    def _handler_class(self):
        raise NotImplementedError

    def start(self):
        # a taken port raises OSError here, untouched — the caller owns
        # the collision policy (module docstring)
        self._httpd = ThreadingHTTPServer((self._addr, self._want_port),
                                          self._handler_class())
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name=self.thread_name, daemon=True)
        self._thread.start()
        return self.port

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
