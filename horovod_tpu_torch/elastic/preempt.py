"""Graceful eviction: preemption notices → bounded commit → drain. The
port of ``horovod_tpu/elastic/preempt.py``.

Spot/preemptible capacity announces its death (SIGTERM on most
schedulers, a metadata file or HTTP probe on the clouds) seconds to
minutes before pulling the plug. This module turns that notice into a
*planned drain* instead of a crash:

1. **Catch the notice.** SIGTERM rides the flight recorder's wakeup-fd
   watcher (``diag/recorder.py``): the C-level handler writes the signal
   number to a pipe no matter what the main thread is doing, so a rank
   parked inside a native collective still runs its eviction on the
   watcher thread. File-/HTTP-based notices (``HOROVOD_PREEMPT_NOTICE_
   FILE`` / ``_URL``, matching cloud spot-notice shapes) are polled by a
   daemon thread. Without a recorder the handler degrades to its own
   ``signal.signal`` + self-pipe path (flag-set only in the handler —
   HVD-SIGSAFE).
2. **Bounded force-commit.** The attached elastic ``State``'s
   ``flush(timeout=...)`` pushes any in-flight ``ckpt.AsyncCheckpointer``
   save to durability within the grace budget
   (``HOROVOD_GRACE_SECONDS``, default 30 s) — the step already
   committed is what survives; an uncommitted half-step never does.
3. **Announce the doomed host** on the launcher KV
   (``elastic/doomed/<host>``) so the :class:`~horovod_tpu_torch.elastic.
   driver.ElasticDriver` removes the host from the *next* rendezvous
   before its death breaks a collective, and blames nobody
   (``Blacklist.record_drain``).
4. **Exit clean** — ``EXIT_RENDEZVOUS`` under a driver-managed epoch
   (one re-rendezvous, not a hang+doctor cycle), 0 otherwise, through
   ``os._exit``: no process group is destroyed on the way out (an NCCL
   communicator whose peer is gone can hang in its destroy).

The whole window is charged to the goodput ledger's ``preemption``
phase, counted in ``hvd_preemptions_total{kind}`` and
``hvd_grace_commit_seconds``, and recorded as structured ``preempt``
flight-recorder events so ``hvd-doctor-torch hang`` can report "graceful
eviction" instead of a dead rank.
"""

import contextlib
import json
import logging
import os
import signal
import socket
import sys
import threading
import time

logger = logging.getLogger("horovod_tpu_torch")

GRACE_ENV = "HOROVOD_GRACE_SECONDS"
DEFAULT_GRACE_SECONDS = 30.0
NOTICE_FILE_ENV = "HOROVOD_PREEMPT_NOTICE_FILE"
NOTICE_URL_ENV = "HOROVOD_PREEMPT_NOTICE_URL"
POLL_ENV = "HOROVOD_PREEMPT_POLL_SECONDS"

# KV keys of the doomed-host plane (the driver consumes + deletes both
# at its next rendezvous; elastic/driver.py)
DOOMED_KEY_PREFIX = "elastic/doomed/"
DOOMED_MARKER_KEY = "elastic/doomed-latest"

# A bare SIGTERM arriving this soon after ANOTHER host's doomed
# announcement is the launcher's teardown fan-out (the evicted rank
# exited, the job monitor is recycling the epoch), not a second
# preemption — announcing *our* host doomed too would drain healthy
# capacity. A genuine second preemption inside this window degrades
# gracefully: the rank still grace-commits and exits clean, it just is
# not pre-drained from the next rendezvous.
TEARDOWN_WINDOW_S = 60.0


def grace_seconds(env=None):
    """The grace budget: seconds between the preemption notice and the
    host's death that the eviction may spend committing. Size it above
    the p99 ``hvd_ckpt_save_seconds`` tail."""
    raw = (env if env is not None else os.environ).get(GRACE_ENV)
    if not raw:
        return DEFAULT_GRACE_SECONDS
    try:
        return max(0.0, float(raw))
    except ValueError:
        logger.warning("preempt: bad %s=%r; using %.0fs", GRACE_ENV, raw,
                       DEFAULT_GRACE_SECONDS)
        return DEFAULT_GRACE_SECONDS


def local_host(env=None):
    env = env if env is not None else os.environ
    return env.get("HOROVOD_HOSTNAME") or socket.gethostname()


def configured(env=None):
    """True when this process should install an eviction handler even
    outside a driver-managed elastic epoch (an explicit grace budget or
    notice source in the env is an opt-in)."""
    env = env if env is not None else os.environ
    return bool(env.get(GRACE_ENV) or env.get(NOTICE_FILE_ENV)
                or env.get(NOTICE_URL_ENV))


class GracefulEvictionHandler:
    """One rank's eviction path (module docstring). ``clock`` and
    ``exit_fn`` are injectable so tests can drive the whole eviction
    without dying; ``finished`` is set right before ``exit_fn`` runs."""

    def __init__(self, state=None, grace=None, notice_file=None,
                 notice_url=None, poll_interval=None,
                 clock=time.monotonic, exit_fn=None, env=None):
        e = env if env is not None else os.environ
        self._env = e
        self._grace = grace_seconds(e) if grace is None else float(grace)
        self._notice_file = notice_file if notice_file is not None \
            else e.get(NOTICE_FILE_ENV)
        self._notice_url = notice_url if notice_url is not None \
            else e.get(NOTICE_URL_ENV)
        try:
            self._poll = float(poll_interval if poll_interval is not None
                               else e.get(POLL_ENV) or 1.0)
        except ValueError:
            self._poll = 1.0
        self._clock = clock
        self._exit = exit_fn if exit_fn is not None else os._exit
        self._state = state
        self._host = local_host(e)
        self._rank = int(e.get("HOROVOD_RANK", "0") or 0)
        self._evicting = threading.Event()
        self._stop = threading.Event()
        self.finished = threading.Event()
        self.last = None      # {"kind", "outcome", ...} of the eviction
        self.installed = False
        self._via_recorder = False
        self._fallback = None
        self._poller = None

    def attach_state(self, state):
        """Point the bounded force-commit at the run's elastic state
        (its ``flush(timeout=...)``). The ``@hvd.elastic.run`` wrapper
        does this automatically."""
        self._state = state

    # -- install / uninstall -------------------------------------------------
    def install(self):
        """Arm the notice sources. Prefers the flight recorder's
        wakeup-fd watcher (a rank parked in a native collective still
        evicts); falls back to a self-pipe ``signal.signal`` path.
        Idempotent."""
        if self.installed:
            return self
        self.installed = True
        try:
            from horovod_tpu_torch.diag import recorder as _flightrec
            watcher = _flightrec.signal_watcher_active()
        except ImportError:
            watcher = False
        if watcher:
            _flightrec.add_signal_listener(signal.SIGTERM, self._on_signal)
            self._via_recorder = True
        else:
            self._install_fallback()
        if self._notice_file or self._notice_url:
            self._poller = threading.Thread(
                target=self._poll_notices, daemon=True,
                name="hvd_torch_preempt_poll")
            self._poller.start()
        return self

    def uninstall(self):
        if not self.installed:
            return
        self.installed = False
        self._stop.set()
        if self._via_recorder:
            self._via_recorder = False
            try:
                from horovod_tpu_torch.diag import recorder as _flightrec
                _flightrec.remove_signal_listener(signal.SIGTERM,
                                                  self._on_signal)
            except ImportError:
                pass
        fb = self._fallback
        self._fallback = None
        if fb is not None:
            try:
                if signal.getsignal(signal.SIGTERM) is fb["handler"]:
                    prev = fb["prev"]
                    signal.signal(signal.SIGTERM,
                                  prev if prev is not None
                                  else signal.SIG_DFL)
            except (ValueError, OSError):
                pass
            # the write end first: EOF wakes the waiter. Its read end is
            # closed only once the waiter is gone: a waiter that had not
            # yet reached its read would otherwise read whatever pipe
            # reuses the descriptor next (the recorder's wakeup pipe, say)
            # and swallow its signal byte; the JAX handler closes both at
            # once
            r_fd, w_fd = fb["pipe"]
            try:
                os.close(w_fd)
            except OSError:
                pass
            fb["waiter"].join(timeout=5.0)
            try:
                os.close(r_fd)
            except OSError:
                pass

    # -- notice sources ------------------------------------------------------
    def _on_signal(self, signum):
        # recorder watcher thread — free to block; the recorder already
        # dumped for this signal before dispatching listeners
        self.trigger("sigterm", signum=int(signum))

    def _install_fallback(self):
        """Degraded mode (no recorder watcher): own self-pipe. The
        handler body only ``os.write``s (HVD-SIGSAFE); a waiter thread
        runs the eviction. A rank parked in native code will not reach
        the Python handler here — the recorder path exists for that."""
        if threading.current_thread() is not threading.main_thread():
            logger.debug("preempt: not the main thread and no recorder "
                         "watcher; SIGTERM eviction unavailable")
            return
        try:
            r_fd, w_fd = os.pipe()
            os.set_blocking(w_fd, False)
        except OSError:
            return

        def _handler(signum, frame):
            try:
                os.write(w_fd, b"\x01")
            except OSError:
                pass

        try:
            prev = signal.signal(signal.SIGTERM, _handler)
        except (ValueError, OSError):
            for fd in (w_fd, r_fd):
                try:
                    os.close(fd)
                except OSError:
                    pass
            return

        def _wait():
            try:
                data = os.read(r_fd, 1)
            except OSError:
                return
            if data and not self._stop.is_set():
                self.trigger("sigterm", signum=int(signal.SIGTERM))

        waiter = threading.Thread(target=_wait, daemon=True,
                                  name="hvd_torch_preempt")
        waiter.start()
        self._fallback = {"pipe": (r_fd, w_fd), "prev": prev,
                          "handler": _handler, "waiter": waiter}

    def _poll_notices(self):
        while not self._stop.is_set() and not self._evicting.is_set():
            kind = self._check_notice()
            if kind:
                self.trigger(kind)
                return
            self._stop.wait(self._poll)

    def _check_notice(self):
        if self._notice_file and os.path.exists(self._notice_file):
            return "notice:file"
        if self._notice_url:
            import urllib.error
            import urllib.request
            try:
                with urllib.request.urlopen(self._notice_url,
                                            timeout=2.0) as r:
                    body = r.read(64).decode("utf-8",
                                             errors="replace").strip()
                # GCE's /instance/preempted probe answers 200 with
                # TRUE/FALSE; a bare 200 (custom notifiers) also counts
                if body.upper() not in ("FALSE", "0", "NO"):
                    return "notice:http"
            except (OSError, urllib.error.URLError):
                pass
        return None

    # -- the eviction --------------------------------------------------------
    def trigger(self, kind, signum=None):
        """Begin the eviction once (idempotent; safe from any thread).
        Returns the thread driving it, or None when one already ran."""
        if self._evicting.is_set():
            return None
        self._evicting.set()
        t = threading.Thread(target=self._evict, args=(kind, signum),
                             name="hvd_torch_evict")
        t.start()
        return t

    def _evict(self, kind, signum):
        if kind == "sigterm" and self._peer_recently_doomed():
            # the launcher's post-eviction fan-out, not a preemption of
            # THIS host (see TEARDOWN_WINDOW_S)
            kind = "teardown"
        deadline = self._clock() + self._grace
        logger.warning("graceful eviction (%s): grace %.1fs, host %s",
                       kind, self._grace, self._host)
        _record("preempt", kind=kind, signum=signum, host=self._host,
                grace=round(self._grace, 3))
        self._count(kind)
        ledger = _get_ledger()
        bracket = ledger.phase("preemption") if ledger is not None \
            else contextlib.nullcontext()
        announced = False
        with bracket:
            if kind != "teardown":
                announced = self._announce(kind)
            outcome, commit_s = self._force_commit(deadline)
        self._observe_commit(commit_s)
        _record("preempt", kind=kind, outcome=outcome, announced=announced,
                commit_seconds=round(commit_s, 6))
        self.last = {"kind": kind, "outcome": outcome,
                     "announced": announced, "commit_seconds": commit_s}
        self._write_dumps(kind)
        code = self._exit_code()
        logger.warning("graceful eviction (%s): commit %s in %.2fs; "
                       "exiting %d", kind, outcome, commit_s, code)
        try:
            sys.stdout.flush()
            sys.stderr.flush()
        except (OSError, ValueError):
            pass
        self.finished.set()
        self._exit(code)

    def _kv_endpoint(self):
        addr = self._env.get("HOROVOD_GLOO_RENDEZVOUS_ADDR")
        try:
            port = int(self._env.get("HOROVOD_GLOO_RENDEZVOUS_PORT") or 0)
        except ValueError:
            port = 0
        return (addr, port) if addr and port > 0 else (None, 0)

    def _peer_recently_doomed(self):
        addr, port = self._kv_endpoint()
        if not addr:
            return False
        try:
            from horovod_tpu_torch.run import secret as _secret
            from horovod_tpu_torch.run.rendezvous import kv_get
            raw = kv_get(addr, port, DOOMED_MARKER_KEY,
                         auth_key=_secret.key_from_env(self._env))
        except OSError:
            return False
        if not raw:
            return False
        try:
            marker = json.loads(raw.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return False
        return (marker.get("host") not in (None, self._host)
                and time.time() - float(marker.get("time") or 0)
                < TEARDOWN_WINDOW_S)

    def _announce(self, kind):
        """Publish ``elastic/doomed/<host>`` (+ the latest-marker) so
        the driver drains this host from the next rendezvous."""
        addr, port = self._kv_endpoint()
        if not addr:
            return False
        payload = json.dumps({
            "host": self._host, "rank": self._rank, "kind": kind,
            "time": time.time(), "grace": self._grace,
        }).encode("utf-8")
        try:
            from horovod_tpu_torch.run import secret as _secret
            from horovod_tpu_torch.run.rendezvous import kv_put
            key = _secret.key_from_env(self._env)
            kv_put(addr, port, DOOMED_KEY_PREFIX + self._host, payload,
                   auth_key=key)
            kv_put(addr, port, DOOMED_MARKER_KEY, payload, auth_key=key)
        except OSError:
            logger.warning("preempt: doomed-host announcement failed "
                           "(driver will see a crash instead of a drain)",
                           exc_info=True)
            return False
        return True

    def _force_commit(self, deadline):
        state = self._state
        t0 = self._clock()
        if state is None:
            return "no-state", 0.0
        timeout = max(0.5, deadline - t0)
        try:
            flush = getattr(state, "flush", None)
            if callable(flush):
                flush(timeout=timeout)
                outcome = "committed"
            else:
                outcome = "no-op"
        except TimeoutError:
            outcome = "timeout"
        except Exception:
            logger.warning("preempt: grace commit failed", exc_info=True)
            outcome = "error"
        return outcome, max(0.0, self._clock() - t0)

    def _exit_code(self):
        if "HOROVOD_ELASTIC_EPOCH" in self._env:
            try:
                from horovod_tpu_torch.elastic.driver import EXIT_RENDEZVOUS
                return EXIT_RENDEZVOUS
            except ImportError:
                return 75
        return 0

    def _write_dumps(self, kind):
        try:
            from horovod_tpu_torch.diag import recorder as _flightrec
        except ImportError:
            return
        rec = _flightrec.get_recorder()
        dump_dir = rec.dump_dir if rec is not None \
            else self._env.get("HOROVOD_FLIGHTREC_DIR")
        if dump_dir:
            try:
                ledger = _get_ledger()
                if ledger is not None and ledger.enabled and ledger.started:
                    ledger.write_dump(dump_dir, self._rank,
                                      extra={"preempted": kind})
            except Exception:
                logger.debug("preempt: goodput dump failed", exc_info=True)
        _flightrec.dump_now(reason="preempt")

    # -- metrics -------------------------------------------------------------
    def _count(self, kind):
        try:
            from horovod_tpu_torch.telemetry import instruments as _tele
            from horovod_tpu_torch.telemetry.registry import get_registry
            get_registry().counter(
                _tele.PREEMPTIONS_TOTAL,
                "Preemption notices acted on, by source kind",
                label_names=("kind",)).labels(kind).inc()
        except Exception:
            pass

    def _observe_commit(self, seconds):
        try:
            from horovod_tpu_torch.telemetry import instruments as _tele
            from horovod_tpu_torch.telemetry.registry import get_registry
            get_registry().histogram(
                _tele.GRACE_COMMIT_SECONDS,
                "Bounded force-commit duration inside the eviction "
                "grace window").observe(seconds)
        except Exception:
            pass


def _get_ledger():
    try:
        from horovod_tpu_torch.telemetry import ledger as _ledger_lib
        return _ledger_lib.get_ledger()
    except Exception:
        return None


def _record(etype, **fields):
    try:
        from horovod_tpu_torch.diag import recorder as _flightrec
        _flightrec.record_event(etype, **fields)
    except Exception:
        pass


# -- the process handler -----------------------------------------------------

_handler = None


def install(state=None, **kwargs):
    """Create (once) and arm this process's eviction handler. A second
    call just re-attaches ``state``."""
    global _handler
    if _handler is None:
        _handler = GracefulEvictionHandler(state=state, **kwargs)
        _handler.install()
    elif state is not None:
        _handler.attach_state(state)
    return _handler


def get_handler():
    return _handler


def attach_state(state):
    """Best-effort: point an installed handler at the run's elastic
    state (no-op without one)."""
    if _handler is not None:
        _handler.attach_state(state)


def uninstall():
    global _handler
    if _handler is not None:
        _handler.uninstall()
        _handler = None
