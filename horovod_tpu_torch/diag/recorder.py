"""Per-rank flight recorder: a bounded ring of structured events.

The port of ``horovod_tpu/diag/recorder.py``, the same ring, digest,
dump format and hooks. One thing is added: torch names its dtypes
``torch.float32`` and its shapes ``torch.Size([...])``, so every dtype
is hashed and dumped under numpy's name (``float32``, ``bfloat16``,
:func:`dtype_name`) and every shape as a tuple of ints. The same
schedule then gives the same ``(seq, digest)`` in both packages, and
one doctor reads a job whose ranks ran either.

Design constraints (the hot path is the collective dispatch path):

* Recording is a ``collections.deque(maxlen=...)`` append plus a
  ``zlib.crc32`` update — no I/O, no locks. The GIL makes the append
  atomic; the ring bounds memory to ``capacity`` events forever.
* The schedule digest must be comparable ACROSS ranks, so it is a CRC
  chain over ``op|name|shape|dtype`` (``hash()`` is salted per process
  and useless here). Two ranks that dispatched the same collective
  schedule hold the same ``(seq, digest)`` pair; the first divergent
  dispatch forks the chain forever — the trace-time mirror of the
  reference controller's shape/dtype mismatch checks
  (``controller.cc:55-346``).
* Dumps are atomic (tempfile + ``os.replace``) and idempotent: a second
  signal landing mid-teardown rewrites the same path and can never leave
  a torn file; every dump reason is appended to the header so the doctor
  sees the full trigger history.

Signal story (why there is a watcher thread): Python-level signal
handlers only run on the MAIN thread between bytecodes. A rank parked in
a native collective (``_core.hvdc_wait``) never reaches another
bytecode, so a plain ``signal.signal`` handler would neither dump nor
die — the launcher's SIGTERM fan-out would hang. ``install()`` therefore
also routes signals through ``signal.set_wakeup_fd`` to a daemon watcher
thread: the C-level handler writes the signal number to a pipe
regardless of what the main thread is doing, the watcher dumps from its
own thread, and — when the previous disposition was the default
(terminate) — SIGKILLs the process after a short grace so the fan-out
still kills a wedged rank.
"""

import atexit
import collections
import dataclasses
import json
import logging
import os
import signal
import sys
import threading
import time
import zlib

logger = logging.getLogger("horovod_tpu_torch")

DUMP_PREFIX = "flightrec.rank"
DEFAULT_CAPACITY = 4096
# (seq, digest) checkpoints kept for cross-rank comparison; the KV
# heartbeat ships the most recent DIGEST_PUBLISH of them
DIGEST_HISTORY = 128
DIGEST_PUBLISH = 16
# seconds between the watcher's dump and its failsafe SIGKILL when the
# default disposition should have terminated the process already
FAILSAFE_GRACE_S = 2.0


def dtype_name(dtype):
    """numpy's name of a dtype: ``torch.bfloat16`` -> ``"bfloat16"``;
    a numpy dtype or a name passes through (``str``), None stays None."""
    if dtype is None:
        return None
    name = str(dtype)
    return name[len("torch."):] if name.startswith("torch.") else name


def _crc(h, *parts):
    for p in parts:
        h = zlib.crc32(str(p).encode(), h)
    return h & 0xFFFFFFFF


# knobs that legitimately differ per rank (identity, per-rank ports/
# paths) — everything else differing across ranks is a desync hazard
_PER_RANK_KEYS = frozenset({
    "rank", "local_rank", "cross_rank", "metrics_port", "flightrec_dir",
    "timeline", "controller_port", "autotune_log", "profile_dir"})


def config_fingerprint(cfg):
    """Stable CRC over the config snapshot — lets the doctor flag ranks
    that ran with mismatched knobs (a classic source of desyncs).
    Per-rank identity fields are excluded, so equal fingerprints mean
    "same knobs", not "same process"."""
    try:
        items = sorted(dataclasses.asdict(cfg).items())
    except TypeError:
        items = sorted(vars(cfg).items())
    h = 0
    for k, v in items:
        if k in _PER_RANK_KEYS:
            continue
        h = _crc(h, k, v)
    return h


class FlightRecorder:
    """One rank's black box.

    ``clock``/``wall_clock`` are injectable so unit tests can drive
    wraparound, dump idempotency and digest divergence without sleeping
    (the same discipline as ``runtime/stall.py``).
    """

    def __init__(self, capacity=DEFAULT_CAPACITY, rank=0, size=1,
                 dump_dir=None, clock=time.monotonic, wall_clock=time.time,
                 config=None):
        self.capacity = max(1, int(capacity))
        self.rank = rank
        self.size = size
        self.dump_dir = dump_dir or os.environ.get(
            "HOROVOD_FLIGHTREC_DIR") or _default_dump_dir()
        self._clock = clock
        self._wall = wall_clock
        self._events = collections.deque(maxlen=self.capacity)
        self._events_total = 0
        self.collective_seq = 0        # collectives ENTERED on this rank
        self.last_completed_seq = 0    # collectives EXITED on this rank
        self._digest = 0
        self._digest_hist = collections.deque(maxlen=DIGEST_HISTORY)
        self._open = {}                # seq -> op of entered-not-exited
        self._dump_lock = threading.Lock()
        self.dump_reasons = []
        self.config_snapshot = None
        self.config_crc = None
        if config is not None:
            try:
                self.config_snapshot = {
                    k: v for k, v in dataclasses.asdict(config).items()}
            except TypeError:
                self.config_snapshot = dict(vars(config))
            self.config_crc = config_fingerprint(config)
        self.record("start", pid=os.getpid(),
                    host=os.environ.get("HOROVOD_HOSTNAME"))

    # -- recording (the hot path) -------------------------------------------
    def record(self, etype, **fields):
        """Bounded append of one structured event (``etype`` is the
        event kind, stored as ``k``). Safe from any thread; never raises
        into the caller."""
        ev = {"k": etype, "t": self._wall(), "m": self._clock()}
        if fields:
            ev.update(fields)
        self._events.append(ev)
        self._events_total += 1
        return ev

    def collective_enter(self, op, name=None, shape=None, dtype=None,
                         nbytes=0, mode="eager", hash_shape=True):
        """Advance ``collective_seq``, extend the schedule digest, record
        the entry. Returns the seq so the matching :meth:`collective_exit`
        can close it. ``mode`` is ``"eager"`` (one event per executed
        call, bracketed B/E so a rank parked inside the call leaves a
        dangling B) or ``"trace"`` (one event per collective baked into a
        compiled program, recorded at trace time as a single ``T`` marker
        — there is no per-execution exit on the compiled plane, so trace
        entries are never "open")."""
        dtype = dtype_name(dtype)
        if shape is not None:
            shape = tuple(int(d) for d in shape)
        self.collective_seq += 1
        seq = self.collective_seq
        # hash_shape=False for variable-length collectives (eager
        # allgatherv semantics): per-rank first dims legitimately
        # differ, and hashing them would fork the cross-rank digest
        # chain forever — a false DESYNC on a correct program
        self._digest = _crc(self._digest, op, name,
                            shape if hash_shape else "<varlen>", dtype)
        self._digest_hist.append((seq, self._digest))
        if mode == "eager":
            self._open[seq] = op
        self.record("coll", ph="B" if mode == "eager" else "T",
                    seq=seq, op=op, name=name,
                    shape=list(shape) if shape is not None else None,
                    dtype=str(dtype) if dtype is not None else None,
                    nbytes=int(nbytes), mode=mode)
        return seq

    def collective_exit(self, op, seq, ok=True):
        self._open.pop(seq, None)
        if ok and seq > self.last_completed_seq:
            self.last_completed_seq = seq
        self.record("coll", ph="E", seq=seq, op=op, ok=bool(ok))

    def step_begin(self, step):
        self.record("step", ph="B", step=int(step))

    def step_end(self, step):
        self.record("step", ph="E", step=int(step))

    def heartbeat(self, step=None):
        self.record("heartbeat", step=step)

    def epoch(self, epoch):
        """Rendezvous epoch marker (elastic membership changes)."""
        self.record("epoch", epoch=int(epoch))

    # -- digests (the desync plane) -----------------------------------------
    def digest(self):
        """Compact rolling digest for the KV heartbeat: current ``seq``
        and schedule hash plus the last few ``(seq, hash)`` checkpoints so
        the driver can line ranks up at a common seq."""
        return {"seq": self.collective_seq, "hash": self._digest,
                "hist": [list(p) for p in
                         list(self._digest_hist)[-DIGEST_PUBLISH:]]}

    # -- snapshots / dumps ---------------------------------------------------
    def _snapshot_events(self):
        # list(deque) can race a concurrent append ("deque mutated during
        # iteration"); retry — the ring is bounded so this converges
        for _ in range(8):
            try:
                return list(self._events)
            except RuntimeError:
                continue
        return []

    def snapshot(self, reason=None):
        now_m, now_w = self._clock(), self._wall()
        return {
            "flightrec": 1,
            "rank": self.rank,
            "size": self.size,
            "pid": os.getpid(),
            "host": os.environ.get("HOROVOD_HOSTNAME"),
            "capacity": self.capacity,
            "events_total": self._events_total,
            "collective_seq": self.collective_seq,
            "last_completed_seq": self.last_completed_seq,
            "open_collectives": {str(s): op
                                 for s, op in sorted(self._open.items())},
            "digest": self.digest(),
            "config_crc": self.config_crc,
            "config": self.config_snapshot,
            # both clocks at snapshot time: wall = mono + offset lets the
            # doctor align per-rank monotonic stamps on one wall axis
            "clock": {"monotonic": now_m, "wall": now_w,
                      "wall_minus_monotonic": now_w - now_m},
            "dump_reasons": list(self.dump_reasons) + (
                [reason] if reason else []),
            "events": self._snapshot_events(),
        }

    def dump_path(self):
        return os.path.join(self.dump_dir, f"{DUMP_PREFIX}{self.rank}.json")

    def dump(self, reason="on_demand", path=None):
        """Write the black box to disk. Atomic, idempotent, re-entrant:
        a dump racing another dump (double signal) skips — the first
        writer's file is complete and the reasons history is preserved
        on the next successful dump."""
        if not self._dump_lock.acquire(blocking=False):
            return None
        try:
            self.record("dump", reason=reason)
            self.dump_reasons.append(reason)
            out = path or self.dump_path()
            os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
            tmp = f"{out}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(self.snapshot(), f)
            os.replace(tmp, out)
            return out
        except Exception:
            logger.warning("flight recorder dump failed", exc_info=True)
            return None
        finally:
            self._dump_lock.release()

    def wait_for_dump(self, timeout=5.0):
        """Block until an in-flight :meth:`dump` on ANOTHER thread has
        finished. A thread about to terminate the process after its own
        dump() skipped (the non-blocking lock was held) must wait here
        first: the signal wakeup-fd watcher and the main-thread signal
        handler both fire on one signal, and the loser re-raising the
        fatal default disposition would otherwise kill the winner
        mid-``json.dump`` — a torn tmp file and no black box at all."""
        if self._dump_lock.acquire(timeout=timeout):
            self._dump_lock.release()


def _default_dump_dir():
    import tempfile
    return os.path.join(tempfile.gettempdir(), "horovod_tpu_torch_flightrec")


# ---------------------------------------------------------------------------
# Module-level hooks: the emission sites (ops/collective, ops/fusion,
# training, data/loader, ckpt/snapshot) call these unconditionally; with no recorder installed each is
# one global load + None check.
# ---------------------------------------------------------------------------

_recorder = None

# signum -> [callable]: consumers that CLAIM a signal (graceful eviction,
# elastic/preempt.py). A claimed signal changes the termination contract:
# the main-thread handler dumps and returns (no re-raise of the fatal
# default), the watcher dumps, runs every listener on its own thread
# (free to block — it is not a signal context), and skips the failsafe
# SIGKILL. The listener owns process termination from that point.
_signal_listeners = {}


def add_signal_listener(signum, fn):
    """Register ``fn(signum)`` to run on the wakeup-fd WATCHER thread
    when ``signum`` arrives. This is how the graceful-eviction handler
    rides the recorder's signal path: the C-level handler writes the
    signal number to the pipe regardless of what the main thread is
    doing, so a rank parked in a native collective still runs its
    bounded grace commit. Registering claims the signal (see
    ``_signal_listeners``)."""
    _signal_listeners.setdefault(int(signum), []).append(fn)


def remove_signal_listener(signum, fn):
    fns = _signal_listeners.get(int(signum))
    if not fns:
        return
    try:
        fns.remove(fn)
    except ValueError:
        return
    if not fns:
        _signal_listeners.pop(int(signum), None)


def _listeners_for(signum):
    return list(_signal_listeners.get(int(signum), ()))


def signal_watcher_active():
    """True when the wakeup-fd watcher thread is installed and alive —
    the precondition for :func:`add_signal_listener` actually firing.
    Consumers fall back to their own ``signal.signal`` path otherwise."""
    hooks = _hooks
    t = hooks.get("watcher") if hooks else None
    return t is not None and t.is_alive()


def get_recorder():
    return _recorder


def collective_enter(op, x=None, name=None, nbytes=0, mode="eager",
                     hash_shape=True):
    r = _recorder
    if r is None:
        return 0
    shape = dtype = None
    if x is not None:
        try:
            shape = tuple(x.shape)
            dtype = getattr(x, "dtype", None)
        except Exception:
            pass
    try:
        return r.collective_enter(op, name=name, shape=shape, dtype=dtype,
                                  nbytes=nbytes, mode=mode,
                                  hash_shape=hash_shape)
    except Exception:
        return 0


def collective_exit(op, seq, ok=True):
    r = _recorder
    if r is None or not seq:
        return
    try:
        r.collective_exit(op, seq, ok=ok)
    except Exception:
        pass


def step_begin(step):
    r = _recorder
    if r is not None:
        try:
            r.step_begin(step)
        except Exception:
            pass


def step_end(step):
    r = _recorder
    if r is not None:
        try:
            r.step_end(step)
        except Exception:
            pass


def record_event(etype, **fields):
    r = _recorder
    if r is not None:
        try:
            r.record(etype, **fields)
        except Exception:
            pass


def current_digest():
    r = _recorder
    if r is None:
        return None
    try:
        return r.digest()
    except Exception:
        return None


def dump_now(reason="on_demand"):
    """Dump the installed recorder (no-op without one). Used by the
    stall inspector when its warning fires and by the ``/flightrec``
    endpoint."""
    r = _recorder
    if r is None:
        return None
    return r.dump(reason=reason)


# ---------------------------------------------------------------------------
# install / uninstall: crash-dump triggers.
# ---------------------------------------------------------------------------

_hooks = None  # state of the installed trigger set


def install(capacity=DEFAULT_CAPACITY, dump_dir=None, rank=0, size=1,
            config=None, signals=(signal.SIGTERM, signal.SIGABRT),
            handle_signals=True):
    """Create and install the process flight recorder + dump triggers:
    ``sys.excepthook``, ``atexit``, and (``handle_signals=True``) the
    SIGTERM/SIGABRT path described in the module docstring. Idempotent —
    a second install returns the existing recorder. Must be called from
    the main thread (signal API constraint)."""
    global _recorder, _hooks
    if _recorder is not None:
        return _recorder
    rec = FlightRecorder(capacity=capacity, rank=rank, size=size,
                         dump_dir=dump_dir, config=config)
    _recorder = rec
    hooks = {"signals": {}, "wakeup": None, "pipe": None,
             "excepthook": sys.excepthook, "watcher": None,
             "stop": threading.Event()}

    def _excepthook(tp, val, tb):
        try:
            rec.record("exception", type=getattr(tp, "__name__", str(tp)),
                       value=repr(val)[:500])
            rec.dump(reason="exception")
        finally:
            hooks["excepthook"](tp, val, tb)

    sys.excepthook = _excepthook
    hooks["installed_excepthook"] = _excepthook

    def _atexit_dump():
        if _recorder is rec:
            rec.dump(reason="exit")

    atexit.register(_atexit_dump)
    hooks["atexit"] = _atexit_dump

    if handle_signals:
        try:
            _install_signal_path(rec, hooks, signals)
        except (ValueError, OSError):
            # not the main thread / restricted env: the excepthook +
            # atexit + stall triggers still work
            logger.debug("flight recorder signal triggers unavailable",
                         exc_info=True)
    _hooks = hooks
    return rec


def _install_signal_path(rec, hooks, signals):
    r_fd, w_fd = os.pipe()
    os.set_blocking(w_fd, False)
    hooks["pipe"] = (r_fd, w_fd)
    hooks["wakeup"] = signal.set_wakeup_fd(w_fd, warn_on_full_buffer=False)

    prev = {}
    for sig in signals:
        prev[sig] = signal.getsignal(sig)

        def _handler(signum, frame, _prev=prev[sig]):
            # main-thread path: dump, then hand over to the previous
            # behavior (user handler, ignore, or default termination).
            # The watcher thread races us on the same signal via the
            # wakeup fd — if it holds the dump lock our dump() skips,
            # and we must let its write FINISH before re-raising a
            # fatal disposition that would tear it mid-file.
            rec.record("signal", signum=int(signum))
            rec.dump(reason=f"signal:{signum}")
            rec.wait_for_dump()
            if _listeners_for(signum):
                # a listener claimed this signal (graceful eviction):
                # the watcher runs it and the listener owns termination
                # — re-raising the fatal default here would kill the
                # process mid-grace-commit
                return
            if _prev is signal.SIG_IGN:
                return  # the app chose to survive this signal; honor it
            if callable(_prev):
                _prev(signum, frame)
                return
            try:
                signal.signal(signum, signal.SIG_DFL)
            except (ValueError, OSError):
                pass
            os.kill(os.getpid(), signum)

        signal.signal(sig, _handler)
        hooks["signals"][sig] = prev[sig]

    fatal_by_default = {int(s) for s in signals
                        if prev[s] in (signal.SIG_DFL, None)}

    def _watch():
        while True:
            try:
                data = os.read(r_fd, 64)
            except OSError:
                return
            if not data or hooks["stop"].is_set():
                return
            for b in data:
                if b not in {int(s) for s in signals}:
                    continue
                rec.record("signal", signum=int(b), via="watcher")
                rec.dump(reason=f"signal:{b}")
                listeners = _listeners_for(b)
                for fn in listeners:
                    try:
                        fn(int(b))
                    except Exception:
                        logger.warning("signal listener failed",
                                       exc_info=True)
                if listeners:
                    # the listener owns termination (bounded grace
                    # commit, then exit) — no failsafe kill
                    continue
                if b in fatal_by_default:
                    # the default disposition should already have killed
                    # us; if the main thread is parked in native code the
                    # Python handler can never run — honor the signal's
                    # intent after a grace so the launcher's fan-out
                    # still terminates this rank
                    hooks["stop"].wait(FAILSAFE_GRACE_S)
                    if not hooks["stop"].is_set():
                        os.kill(os.getpid(), signal.SIGKILL)

    t = threading.Thread(target=_watch, daemon=True,
                         name="hvd_torch_flightrec")
    t.start()
    hooks["watcher"] = t


def uninstall(dump=True, reason="shutdown"):
    """Tear down the recorder and restore every hook it installed.
    ``dump=True`` writes one final dump (so a cleanly-exiting rank leaves
    evidence that it exited cleanly — the doctor distinguishes 'no dump'
    = hard-killed from 'dump with shutdown reason' = clean)."""
    global _recorder, _hooks
    rec, hooks = _recorder, _hooks
    if rec is None:
        return
    if dump:
        rec.dump(reason=reason)
    _recorder = None
    _hooks = None
    _signal_listeners.clear()
    if hooks is None:
        return
    hooks["stop"].set()
    if sys.excepthook is hooks.get("installed_excepthook"):
        sys.excepthook = hooks["excepthook"]
    try:
        atexit.unregister(hooks["atexit"])
    except Exception:
        pass
    for sig, prev in hooks["signals"].items():
        try:
            signal.signal(sig, prev if prev is not None else signal.SIG_DFL)
        except (ValueError, OSError):
            pass
    if hooks["wakeup"] is not None or hooks["pipe"] is not None:
        try:
            signal.set_wakeup_fd(hooks["wakeup"]
                                 if hooks["wakeup"] is not None else -1)
        except (ValueError, OSError):
            pass
    if hooks["pipe"] is not None:
        # write end first: EOF wakes the watcher's blocking read before
        # the read end goes away under it
        r_fd, w_fd = hooks["pipe"]
        for fd in (w_fd, r_fd):
            try:
                os.close(fd)
            except OSError:
                pass
