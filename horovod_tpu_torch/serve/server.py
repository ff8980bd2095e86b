"""Streaming HTTP frontend for the serve engine (stdlib only): the port
of ``horovod_tpu/serve/server.py``, the same wire protocol.

Built on the same ``utils/httpd`` scaffolding as the telemetry plane.
Endpoints:

* ``POST /generate`` — body ``{"tokens": [int, ...],
  "max_new_tokens": N, "eos_id": optional, "temperature": optional,
  "top_p": optional, "seed": optional}`` (the sampling knobs of
  ``serve/sampling.py``; omitted = greedy). The response streams
  newline-delimited JSON (``application/x-ndjson``): one
  ``{"token": t}`` line per generated token **as the engine produces
  it** (HTTP/1.0, connection-close delimited — no chunked-encoding
  games), then a terminal ``{"done": true, "tokens": [...],
  "finish_reason": ...}`` line carrying the full generation. Invalid
  requests get 400 with the reason; an engine stopped mid-stream ends
  the stream with an ``{"error": ...}`` line.
* ``GET /healthz`` — serving liveness: queue depth, active sequences,
  KV-pool occupancy, installed weights version. Follows the telemetry
  plane's convention (200 ok / 503 when the engine is down) so the
  same probes drive both — and mirrors its elastic-transition shape
  with a third state: a replica refusing admission (preempt-drain or
  weight staging) answers 503 with ``status: "draining"``, which is
  what tells a fleet router (serve/fleet/) to dispatch elsewhere while
  in-flight streams finish.
* ``GET /metrics`` — the shared registry in Prometheus text format
  (the ``hvd_serve_*`` family plus everything else this process
  records), for deployments that don't also run the telemetry server.

Same security model as the metrics endpoint: binds loopback by default,
no auth — put a real gateway in front before exposing it.
"""

import json
import logging

from horovod_tpu_torch.serve.engine import Request, RequestError
from horovod_tpu_torch.serve.sampling import SamplingParams
from horovod_tpu_torch.telemetry.registry import get_registry
from horovod_tpu_torch.utils.httpd import HttpService, QuietHandler

logger = logging.getLogger("horovod_tpu_torch")

MAX_BODY = 8 << 20  # a prompt is token ids, not tensors


class ServeServer(HttpService):
    """The generate frontend over one :class:`ServeEngine`. ``port=0``
    binds an ephemeral port (in ``.port`` after ``start()``)."""

    thread_name = "hvd_serve_http"

    def __init__(self, engine, addr="127.0.0.1", port=0, registry=None,
                 stream_timeout=300.0):
        super().__init__(addr=addr, port=port)
        self.engine = engine
        # default to the registry the ENGINE records into (an isolated
        # registry in tests, the process default in production) so
        # /metrics always shows this server's own hvd_serve_* family
        if registry is None:
            registry = getattr(getattr(engine, "instruments", None),
                               "registry", None)
        self.registry = registry if registry is not None else get_registry()
        self._stream_timeout = float(stream_timeout)

    def _handler_class(self):
        server = self

        class Handler(QuietHandler):
            log_name = "serve"

            def do_GET(self):
                try:
                    if self.path == "/healthz":
                        eng = server.engine
                        down = (eng._stop.is_set()
                                or eng._broken is not None)
                        draining = (not down
                                    and getattr(eng, "draining", False))
                        status = ("down" if down
                                  else "draining" if draining else "ok")
                        body = {
                            "status": status,
                            "queue_depth": eng.queue_depth,
                            "active": eng.active_count,
                            "kv_blocks_in_use": eng.allocator.in_use,
                            "kv_blocks_free": eng.allocator.available,
                            "weights_version": eng.weights_version,
                        }
                        # draining is 503 like down: probes pull the
                        # replica from rotation while it finishes
                        # in-flight work (admission is refused anyway)
                        self._respond_json(200 if status == "ok" else 503,
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
                    logger.warning("serve endpoint %s failed: %s",
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
                        # Request()/SamplingParams() coerce and
                        # validate their fields — a non-numeric field
                        # is a CLIENT error, so both must be built
                        # inside this block to 400, not fall through
                        # to the generic 500 handler
                        sp = None
                        if any(k in body for k in ("temperature",
                                                   "top_p", "seed")):
                            sp = SamplingParams(
                                temperature=float(
                                    body.get("temperature", 0.0)),
                                top_p=float(body.get("top_p", 1.0)),
                                seed=int(body.get("seed", 0)))
                        req = Request(tokens,
                                      int(body.get("max_new_tokens", 16)),
                                      eos_id=body.get("eos_id"),
                                      sampling=sp,
                                      trace=bool(body.get("trace",
                                                          False)))
                    except (KeyError, ValueError, TypeError) as e:
                        return self._respond_json(400, {"error": str(e)})
                    try:
                        server.engine.submit(req)
                    except RequestError as e:
                        return self._respond_json(400, {"error": str(e)})
                    self._stream(req)
                except BrokenPipeError:
                    pass  # client went away mid-stream; engine finishes
                # keep the plane up; the handler reports 500 below
                except Exception as e:
                    logger.warning("serve /generate failed: %s", e)
                    try:
                        self._respond(500, f"{e}\n", "text/plain")
                    # the client is gone; nothing left to report to
                    except Exception:
                        pass

            def _stream(self, req):
                # HTTP/1.0 + Connection: close — the closed socket
                # delimits the ndjson stream; each token line is
                # flushed as the engine emits it
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Connection", "close")
                self.end_headers()

                def line(obj):
                    self.wfile.write((json.dumps(obj) + "\n").encode())
                    self.wfile.flush()

                tr = req.trace
                first = tr is not None
                try:
                    for tok in req.stream(
                            timeout=server._stream_timeout):
                        if first:
                            # best-effort first-byte span: the trace
                            # may already be finalized for a short
                            # generation the engine finished first
                            first = False
                            t0 = tr.now()
                            line({"token": tok})
                            tr.span("stream", t0, tr.now(),
                                    actor="http", first_byte=True)
                        else:
                            line({"token": tok})
                    line({"done": True, "tokens": req.generated,
                          "finish_reason": req.finish_reason})
                except (RequestError, TimeoutError) as e:
                    line({"error": str(e)})

        return Handler

    def start(self):
        port = super().start()
        logger.info("serve endpoint on http://%s:%d/generate",
                    self._addr, port)
        return port
