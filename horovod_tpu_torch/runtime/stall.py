"""Stall inspector: warn when ranks stop making progress together. The
port of ``horovod_tpu/runtime/stall.py``.

Horovod's ``horovod/common/stall_inspector.cc`` is a coordinator-side
watchdog that warns when a tensor has been submitted by some ranks but
is missing on others for >60 s (``stall_inspector.h:30-70``), with an
optional job shutdown after ``HOROVOD_STALL_SHUTDOWN_TIME_SECONDS``.

Here, as in the JAX package, the unit of progress is the **step**:
``record_progress`` marks a completed step, and the inspector warns when
no step completed for longer than the warning threshold, and can ask for
the job's shutdown after the shutdown threshold. Progress listeners
(``add_progress_listener``) carry each step to the elastic driver's
liveness view (``elastic/worker.py``).

Telemetry: the inspector owns the ``hvd_stalled_ranks`` gauge — the
number of ranks currently past the warning threshold (from
``heartbeat_fn`` when a cluster view exists, else this rank's own 0/1).

Testability: the check is a pure function of time (``check_once``) driven
by an injectable ``clock``, so unit tests step a fake clock instead of
sleeping; the background loop's wake-up cadence is ``check_interval``,
deliberately independent of ``warning_time`` (a 600 s warning threshold
must not mean 600 s detection latency for the shutdown path).
"""

import logging
import threading
import time

logger = logging.getLogger("horovod_tpu_torch")


class StallInspector:
    def __init__(self, warning_time=60.0, shutdown_time=0.0,
                 heartbeat_fn=None, check_interval=5.0,
                 clock=time.monotonic, on_shutdown=None):
        self._warning_time = warning_time
        self._shutdown_time = shutdown_time
        self._heartbeat_fn = heartbeat_fn  # () -> dict rank->last_progress
        self._check_interval = check_interval
        self._clock = clock
        self._on_shutdown = on_shutdown
        self._last_progress = clock()
        self._stop_event = threading.Event()
        self._thread = None
        self._warned = False
        self._progress_listeners = []
        self.shutdown_requested = False
        from horovod_tpu_torch.telemetry import instruments as _tele
        self._stalled_gauge = _tele.stalled_ranks_gauge()
        self._stalled_gauge.set(0)

    def add_progress_listener(self, fn):
        """Register ``fn(step)`` to run on every ``record_progress`` —
        the elastic worker context hooks its driver-facing heartbeat here
        (elastic/worker.py), turning local step progress into the
        driver's liveness view."""
        self._progress_listeners.append(fn)

    def record_progress(self, step=None):
        """Call once per completed step (the analogue of a tensor being
        submitted by this rank)."""
        self._last_progress = self._clock()
        self._warned = False
        for fn in list(self._progress_listeners):
            try:
                fn(step)
            except Exception:
                logger.debug("progress listener failed", exc_info=True)

    def start(self):
        self._thread = threading.Thread(target=self._loop,
                                        name="hvd_torch_stall", daemon=True)
        self._thread.start()

    def _stalled_ranks(self, now):
        """Ranks past the warning threshold: the cluster heartbeat view
        when available, else this rank's own idleness as rank -1."""
        if self._heartbeat_fn is not None:
            try:
                beats = self._heartbeat_fn() or {}
                return [r for r, t in beats.items()
                        if now - t > self._warning_time]
            except Exception:
                logger.debug("heartbeat_fn failed", exc_info=True)
        idle = now - self._last_progress
        return [-1] if idle > self._warning_time else []

    def check_once(self, now=None):
        """One watchdog evaluation at time ``now`` (defaults to the
        injected clock). Updates the stalled-ranks gauge, logs the
        warning once per stall episode, and flips ``shutdown_requested``
        past the shutdown threshold. Returns the stalled rank list."""
        now = now if now is not None else self._clock()
        idle = now - self._last_progress
        stalled = self._stalled_ranks(now)
        self._stalled_gauge.set(len(stalled))
        if idle > self._warning_time and not self._warned:
            names = ("" if stalled == [-1] else
                     f" (stalled ranks: {sorted(stalled)})")
            logger.warning(
                "One or more ranks stalled for %.0f s (no training-step "
                "progress)%s. Check that all ranks are submitting steps.",
                idle, names)
            self._warned = True
            # the stall warning IS a dump trigger: the flight recorder
            # must hit disk while the evidence (which collective we are
            # parked in) is still in the ring — a later SIGKILL leaves
            # nothing (diag/recorder.py)
            try:
                from horovod_tpu_torch.diag import recorder as _flightrec
                _flightrec.record_event("stall", idle_s=round(idle, 3),
                                        stalled=sorted(stalled))
                _flightrec.dump_now("stall")
            except Exception:
                logger.debug("stall flight-recorder dump failed",
                             exc_info=True)
        if (self._shutdown_time > 0 and idle > self._shutdown_time
                and not self.shutdown_requested):
            logger.error(
                "Stall exceeded HOROVOD_STALL_SHUTDOWN_TIME_SECONDS "
                "(%.0f s); requesting shutdown.", self._shutdown_time)
            self.shutdown_requested = True
            if self._on_shutdown is not None:
                try:
                    self._on_shutdown()
                except Exception:
                    logger.warning("stall shutdown hook failed",
                                   exc_info=True)
        return stalled

    def _loop(self):
        # the wake-up cadence is check_interval, never warning_time: a
        # long warning threshold must not delay shutdown detection
        while not self._stop_event.wait(self._check_interval):
            self.check_once()
            if self.shutdown_requested:
                break

    def stop(self):
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
