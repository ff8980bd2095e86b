"""Fleet HTTP frontend: one streaming endpoint over N replicas. The port
of ``horovod_tpu/serve/fleet/frontend.py``.

Wire-compatible with the single-replica ``serve/server.py`` — same
``POST /generate`` ndjson stream, same sampling knobs — so clients
point at a fleet without changes. What
differs is behind the socket:

* ``/generate`` submits a :class:`~horovod_tpu_torch.serve.fleet.router.
  FleetRequest`: the router picks the replica, and if that replica is
  preempted mid-stream the client's connection NEVER sees it — the
  continuation re-dispatch keeps the same ndjson stream flowing from
  a survivor.
* ``/healthz`` is fleet-shaped: aggregate status (``ok`` while at
  least one replica admits, ``draining`` while all live replicas are
  refusing admission, ``down`` when none is left), router queue
  depth, re-dispatch/drop counters, and the per-replica health dict
  each replica's own ``/healthz`` would report.
* ``/metrics`` renders the shared registry — per-replica
  ``hvd_serve_queue_depth{replica=...}`` / ``hvd_serve_kv_blocks``
  children plus the fleet's ``hvd_serve_replicas{state=...}``.
"""

import json
import logging

from horovod_tpu_torch.serve import engine as engine_lib
from horovod_tpu_torch.serve.fleet.router import FleetRequest
from horovod_tpu_torch.serve.sampling import SamplingParams
from horovod_tpu_torch.telemetry.registry import get_registry
from horovod_tpu_torch.utils.httpd import HttpService, QuietHandler

logger = logging.getLogger("horovod_tpu_torch")

MAX_BODY = 8 << 20


class FleetServer(HttpService):
    """The generate frontend over one :class:`FleetRouter`. ``port=0``
    binds an ephemeral port (in ``.port`` after ``start()``)."""

    thread_name = "hvd_fleet_http"

    def __init__(self, router, addr="127.0.0.1", port=0, registry=None,
                 stream_timeout=300.0):
        super().__init__(addr=addr, port=port)
        self.router = router
        self.registry = (registry if registry is not None
                         else getattr(router, "registry", None))
        if self.registry is None:
            self.registry = get_registry()
        self._stream_timeout = float(stream_timeout)

    def _handler_class(self):
        server = self

        class Handler(QuietHandler):
            log_name = "fleet"

            def do_GET(self):
                try:
                    if self.path == "/healthz":
                        body = server.router.healthz()
                        self._respond_json(
                            200 if body["status"] == "ok" else 503,
                            body)
                    elif self.path == "/metrics":
                        self._respond(
                            200, server.registry.render_prometheus(),
                            "text/plain; version=0.0.4; charset=utf-8")
                    else:
                        self._respond(404, "not found\n", "text/plain")
                except BrokenPipeError:
                    pass
                # keep the plane up; the handler reports 500 below
                except Exception as e:
                    logger.warning("fleet endpoint %s failed: %s",
                                   self.path, e)
                    try:
                        self._respond(500, f"{e}\n", "text/plain")
                    # the client is gone; nothing left to report to
                    except Exception:
                        pass

            def do_POST(self):
                if self.path != "/generate":
                    return self._respond(404, "not found\n", "text/plain")
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    if length <= 0 or length > MAX_BODY:
                        return self._respond_json(
                            400, {"error": "body required (JSON, "
                                           f"<= {MAX_BODY} bytes)"})
                    try:
                        body = json.loads(self.rfile.read(length))
                        tokens = body["tokens"]
                        if (not isinstance(tokens, list)
                                or not all(isinstance(t, int)
                                           for t in tokens)):
                            raise ValueError(
                                "tokens must be a list of ints")
                        sp = None
                        if any(k in body for k in ("temperature",
                                                   "top_p", "seed")):
                            sp = SamplingParams(
                                temperature=float(
                                    body.get("temperature", 0.0)),
                                top_p=float(body.get("top_p", 1.0)),
                                seed=int(body.get("seed", 0)))
                        freq = FleetRequest(
                            tokens, int(body.get("max_new_tokens", 16)),
                            eos_id=body.get("eos_id"), sampling=sp,
                            trace=bool(body.get("trace", False)))
                    except (KeyError, ValueError, TypeError) as e:
                        return self._respond_json(400, {"error": str(e)})
                    try:
                        server.router.submit(freq)
                    except engine_lib.RequestError as e:
                        return self._respond_json(400, {"error": str(e)})
                    self._stream(freq)
                except BrokenPipeError:
                    pass  # client went away; the fleet finishes anyway
                # keep the plane up; the handler reports 500 below
                except Exception as e:
                    logger.warning("fleet /generate failed: %s", e)
                    try:
                        self._respond(500, f"{e}\n", "text/plain")
                    # the client is gone; nothing left to report to
                    except Exception:
                        pass

            def _stream(self, freq):
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Connection", "close")
                self.end_headers()

                def line(obj):
                    self.wfile.write((json.dumps(obj) + "\n").encode())
                    self.wfile.flush()

                tr = freq.trace
                first = tr is not None
                try:
                    for tok in freq.stream(
                            timeout=server._stream_timeout):
                        if first:
                            # best-effort first-byte span (the trace
                            # may finalize before the stream drains)
                            first = False
                            t0 = tr.now()
                            line({"token": tok})
                            tr.span("stream", t0, tr.now(),
                                    actor="http", first_byte=True)
                        else:
                            line({"token": tok})
                    line({"done": True, "tokens": freq.generated,
                          "finish_reason": freq.finish_reason,
                          "hops": freq.hops})
                except (engine_lib.RequestError, TimeoutError) as e:
                    line({"error": str(e)})

        return Handler

    def start(self):
        port = super().start()
        logger.info("fleet endpoint on http://%s:%d/generate "
                    "(%d replicas)", self._addr, port,
                    len(self.router.replicas))
        return port
