"""The per-rank HTTP observability plane (stdlib only).

The port of ``horovod_tpu/telemetry/server.py``: the same four
endpoints, started by ``runtime/services.py`` when
``HOROVOD_METRICS_PORT`` is set and bound to ``HOROVOD_METRICS_ADDR``
(127.0.0.1 by default):

* ``GET /metrics``  — the registry in Prometheus text format,
* ``GET /healthz``  — liveness JSON (rank identity + step progress);
  200 while serving, **503** with a ``phase`` field while a
  health-relevant goodput-ledger bracket is open,
* ``GET /flightrec`` — the flight recorder's current ring as JSON;
  ``?dump=1`` also writes ``flightrec.rank<r>.json``,
* ``GET /profile?seconds=N`` — an on-demand ``torch.profiler`` capture
  into ``HOROVOD_PROFILE_DIR`` (default ``<tmp>/horovod_tpu_torch_profile``)
  of the steps that run in the next N seconds, parsed by the X-ray
  (``telemetry/xprof.py``) into ``xray.rank<r>.json`` beside the trace;
  ``&wait=1`` returns the summary inline, ``?result=1`` fetches the last
  one.

What differs from the JAX server is where the capture is taken: torch's
profiler records CPU operators only on the thread that enabled it, so
the server does not start it on its own thread. It arms a window
(``xprof.ProfileWindow``) that the train steps open at the start of the
next step and close at the end of the first step past N seconds, whole
steps on the steps' own thread; with no step in that time the request
ends with an error summary.

Security note: the endpoints are UNAUTHENTICATED — ``/profile`` writes
to local disk on request — so bind a non-loopback address only on
networks where every peer is trusted.
"""

import json
import logging
import os
import threading
from urllib.parse import parse_qs, urlparse

from horovod_tpu_torch.telemetry.registry import get_registry
from horovod_tpu_torch.utils.httpd import HttpService, QuietHandler

logger = logging.getLogger("horovod_tpu_torch")

# a window that no step opened or closed ends this long after its N s
WINDOW_GRACE_S = 60.0


def default_profile_dir():
    import tempfile
    return os.path.join(tempfile.gettempdir(), "horovod_tpu_torch_profile")


class MetricsServer(HttpService):
    """One rank's scrape endpoint. ``port=0`` binds an ephemeral port
    (the bound port is in ``.port`` after ``start()``). Built on the
    shared ``utils/httpd`` scaffolding (the serving frontend,
    ``serve/server.py``, is the other tenant in the JAX package)."""

    thread_name = "hvd_torch_metrics"

    def __init__(self, addr="127.0.0.1", port=0, registry=None,
                 health_fn=None, profile_dir=None):
        super().__init__(addr=addr, port=port)
        self.registry = registry if registry is not None else get_registry()
        self._health_fn = health_fn
        self.profile_dir = profile_dir or default_profile_dir()
        self._profile_lock = threading.Lock()
        self._profile_active = False
        self._profile_thread = None
        self._profile_window = None
        self._profile_summary = None  # last capture's X-ray attribution

    # -- profiling ----------------------------------------------------------
    def _start_profile(self, seconds):
        """Arm a capture window for the next steps (``xprof.open_window``)
        and wait for it on a worker thread, which then parses the
        capture; return at once. One capture at a time. ``stop()``
        cancels a pending window and joins the thread."""
        from horovod_tpu_torch.telemetry import xprof
        with self._profile_lock:
            if self._profile_active:
                return None  # already capturing
            window = xprof.open_window(self.profile_dir, seconds)
            if window is None:
                return None
            self._profile_active = True
            self._profile_window = window

        def _capture():
            try:
                if not window.done.wait(seconds + WINDOW_GRACE_S):
                    window.cancel()
                    window.done.wait(WINDOW_GRACE_S)
                self._profile_summary = self._attribute_capture(window)
            except Exception:
                logger.warning("profile capture failed", exc_info=True)
            finally:
                with self._profile_lock:
                    self._profile_active = False

        self._profile_thread = threading.Thread(
            target=_capture, daemon=True, name="hvd_torch_profile")
        self._profile_thread.start()
        return self.profile_dir

    def _attribute_capture(self, window):
        """Run the window's capture through the X-ray parser: drops
        ``xray.rank<r>.json`` next to the trace for ``hvd-doctor-torch xray``
        and returns the summary the HTTP response serves. No capture
        (no step ran in the window) or a torn one returns
        ``{"error": ...}``."""
        from horovod_tpu_torch.telemetry import xprof
        if window.run_dir is None:
            return {"error": window.error or
                    "no train step ran in the profile window"}
        try:
            summary = xprof.analyze_capture(window.run_dir,
                                            steps=window.steps)
        except ValueError as e:
            return {"error": str(e)}
        xprof.write_summary(summary, window.run_dir, rank=xprof._rank())
        return summary

    # -- server -------------------------------------------------------------
    def _handler_class(self):
        server = self

        class Handler(QuietHandler):
            log_name = "metrics"

            def do_GET(self):
                url = urlparse(self.path)
                try:
                    if url.path == "/metrics":
                        self._respond(
                            200, server.registry.render_prometheus(),
                            "text/plain; version=0.0.4; charset=utf-8")
                    elif url.path == "/healthz":
                        health = {"status": "ok"}
                        if server._health_fn is not None:
                            health.update(server._health_fn() or {})
                        # a rank parked in an elastic transition
                        # (re-rendezvous, checkpoint restore) is NOT
                        # healthy-and-serving: 503 with the phase in the
                        # body, so load balancers and probes drain it
                        # instead of routing to a wedged rank
                        code = 200 if health.get("status", "ok") == "ok" \
                            else 503
                        self._respond(code, json.dumps(health),
                                      "application/json")
                    elif url.path == "/flightrec":
                        from horovod_tpu_torch.diag import \
                            recorder as flightrec
                        rec = flightrec.get_recorder()
                        if rec is None:
                            self._respond(404, json.dumps(
                                {"error": "no flight recorder installed "
                                          "(HOROVOD_FLIGHTREC)"}),
                                "application/json")
                        else:
                            q = parse_qs(url.query)
                            # ?dump=1 additionally writes the on-disk
                            # flightrec.rank<r>.json (on-demand black box)
                            if q.get("dump", ["0"])[0] not in ("0", ""):
                                rec.dump(reason="endpoint")
                            self._respond(
                                200, json.dumps(rec.snapshot()),
                                "application/json")
                    elif url.path == "/profile":
                        q = parse_qs(url.query)
                        if q.get("result", ["0"])[0] not in ("0", ""):
                            # the last capture's attribution, no new
                            # capture started
                            s = server._profile_summary
                            if s is None:
                                self._respond(404, json.dumps(
                                    {"error": "no finished capture; "
                                              "GET /profile?seconds=N "
                                              "first"}),
                                    "application/json")
                            else:
                                self._respond(200, json.dumps(
                                    {"output_dir": server.profile_dir,
                                     "summary": s}), "application/json")
                            return
                        seconds = float(q.get("seconds", ["3"])[0])
                        seconds = min(max(seconds, 0.1), 600.0)
                        wait = q.get("wait", ["0"])[0] not in ("0", "")
                        out = server._start_profile(seconds)
                        if out is None:
                            self._respond(409, json.dumps(
                                {"error": "a profile capture is already "
                                          "running"}), "application/json")
                        elif wait:
                            # block until capture + X-ray parse finish
                            # and return the attribution inline (the
                            # cold profiler start is why async is the
                            # default; opt into the wait explicitly)
                            server._profile_thread.join(
                                timeout=seconds + 120)
                            self._respond(200, json.dumps(
                                {"profiling_seconds": seconds,
                                 "output_dir": out,
                                 "summary": server._profile_summary}),
                                "application/json")
                        else:
                            self._respond(200, json.dumps(
                                {"profiling_seconds": seconds,
                                 "output_dir": out,
                                 "result": "/profile?result=1 after the "
                                           "capture finishes, or "
                                           "hvd-doctor-torch xray on the "
                                           "dir"}),
                                "application/json")
                    else:
                        self._respond(404, "not found\n", "text/plain")
                except BrokenPipeError:
                    pass
                except Exception as e:  # keep the plane up, report the err
                    logger.warning("metrics endpoint %s failed: %s",
                                   url.path, e)
                    try:
                        self._respond(500, f"{e}\n", "text/plain")
                    except Exception:
                        pass

        return Handler

    def start(self):
        port = super().start()
        logger.info("metrics endpoint on http://%s:%d/metrics",
                    self._addr, port)
        return port

    def stop(self):
        super().stop()
        if self._profile_thread is not None:
            # end a pending window NOW (a capture a step holds open
            # closes at that step's end) and wait for the parse
            if self._profile_window is not None:
                self._profile_window.cancel()
            self._profile_thread.join(timeout=30)
            self._profile_thread = None
