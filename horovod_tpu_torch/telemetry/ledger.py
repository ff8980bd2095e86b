"""The goodput ledger: run-level time attribution.

The port of ``horovod_tpu/telemetry/ledger.py``, the same code and the
same phases. What differs is who charges them: every collective of the
port runs eagerly, so ``exposed_collective`` is charged by the
collectives called outside a train step (``ops/collective.py``), and
``compile`` by the CUDA kernels' build at first use (``_build.py``) and
by the GSPMD steps' first call of each batch signature
(``parallel/gspmd.CompiledProgramCache``).

The telemetry plane records *events* and the flight recorder records
*forensics*; this module accounts for *time*. A per-rank
:class:`TimeLedger` classifies every wall-clock second of a run into
exclusive phases, so "where did my time go" has a number instead of a
guess — and ROADMAP item 5's "<5% goodput loss on preemptible capacity"
claim becomes testable.

Phases (exclusive — each second lands in exactly one):

* ``compute``             — the residual of each train-step interval
  after the explicitly-measured stalls below are subtracted: the time
  the accelerator had work. Collectives *hidden* behind the step
  (the compiled overlap pipeline) are compute by design — only exposed
  dispatch time is charged separately.
* ``exposed_collective``  — host time spent dispatching eager
  collectives (time the step could not hide). Under ``spmd=True`` this
  phase is STRUCTURALLY zero — the collectives are compiled into the
  step and their time books as ``compute``; the step wrappers call
  :meth:`TimeLedger.note_compiled_path` so snapshots/dumps carry a
  ``compiled_path`` flag and the report annotates the zero instead of
  implying "no exposed comms" (run ``hvd-doctor-torch xray`` for the
  device-side split).
* ``data_wait``           — the training thread blocked on the input
  pipeline (``hvd_data_wait_seconds``'s source, charged here too).
* ``ckpt_stall``          — the blocking portion of checkpoint saves
  (snapshot + budget wait + any flush the training thread sat in).
* ``compile``             — the kernels' build and the GSPMD steps'
  first call per batch signature (``instruments.record_compile``).
* ``rendezvous_recovery`` — elastic recovery: rollback, restore from
  checkpoint, re-rendezvous sync.
* ``preemption``          — planned-churn cost: the graceful-eviction
  window (bounded grace commit + doomed-host announcement) when a spot
  notice / SIGTERM evicts this rank (``elastic/preempt.py``), and the
  scripted eviction spans of ``bench.py --churn``.
* ``stall_idle``          — unattributed gaps longer than
  ``IDLE_THRESHOLD_S`` settled outside a step (the job was parked and
  nothing claimed the time — the "something is wrong" bucket).
* ``overhead``            — small unattributed non-step gaps (host
  bookkeeping between phases).

Mechanics: subsystems ``charge(phase, seconds)`` the stalls they
measure anyway; the train-step wrapper calls ``settle_step()`` after
each step, which closes the interval since the previous settle and
books the residual as ``compute``. ``settle_idle()`` (scrape/shutdown
path) books a non-step residual as ``stall_idle``/``overhead``.
Charges are clipped to the interval they fall in, so the phase sum can
never exceed wall time; the remainder of an *unfinished* interval shows
up as ``unattributed_seconds`` in a live snapshot and collapses to ~0
after a final settle (bench.py enforces <2%).

The ledger is pure host-side bookkeeping: it never touches traced
code, so compiled programs are byte-identical with it on or off
(``HOROVOD_GOODPUT=0`` disables it), and a settle is a few dict adds —
well under the 2% step-overhead budget the plane already meets.

Registry mirror: ``hvd_time_seconds_total{phase=...}`` counters and the
``hvd_goodput_ratio`` gauge (compute / attributed wall) update at every
settle, ride the KV heartbeat snapshots (``instruments.kv_snapshot``)
into the elastic driver's fleet view, and land in every BENCH json.
``write_dump()`` drops ``goodput.rank<r>.json`` next to the
flight-recorder dumps at shutdown; ``telemetry/report.py`` (and
``hvd-doctor-torch perf``) aggregates them into the end-of-run report.
"""

import json
import logging
import os
import threading
import time

logger = logging.getLogger("horovod_tpu_torch")

PHASES = ("compute", "exposed_collective", "data_wait", "ckpt_stall",
          "compile", "rendezvous_recovery", "preemption", "stall_idle",
          "overhead")

# an unattributed non-step gap at least this long is a stall, not
# bookkeeping overhead
IDLE_THRESHOLD_S = 0.5

DUMP_PREFIX = "goodput.rank"


def dominant_sink(phases):
    """The largest non-compute phase of a ``{phase: seconds}`` mapping —
    ``(phase, seconds)``, or ``(None, 0.0)`` when nothing non-compute
    was charged. The ONE sink-naming policy, shared by the live ledger
    and the end-of-run report (telemetry/report.py)."""
    sinks = {p: s for p, s in phases.items() if p != "compute" and s > 0}
    if not sinks:
        return None, 0.0
    phase = max(sinks, key=sinks.get)
    return phase, sinks[phase]


def enabled(env=None):
    """Ledger on/off (default ON — it is host-side floats only; the
    compiled program is identical either way)."""
    env = env if env is not None else os.environ
    return env.get("HOROVOD_GOODPUT", "1").lower() not in (
        "0", "false", "no", "off")


class _Bracket:
    """One open blocking-phase span (``TimeLedger.phase``)."""

    __slots__ = ("label", "charge_phase", "health", "opened", "accounted",
                 "inner")

    def __init__(self, label, charge_phase, health, now):
        self.label = label
        self.charge_phase = charge_phase
        self.health = health
        self.opened = now
        self.accounted = now  # everything before this is already booked
        self.inner = 0.0      # seconds sub-charges claimed inside the span


class _PhaseContext:
    def __init__(self, ledger, label, charge_phase, health):
        self._ledger = ledger
        self._label = label
        self._charge = charge_phase
        self._health = health
        self._bracket = None

    def __enter__(self):
        self._bracket = self._ledger._open_bracket(
            self._label, self._charge, self._health)
        return self

    def __exit__(self, *exc):
        self._ledger._close_bracket(self._bracket)
        return False


class TimeLedger:
    """Per-rank exclusive-phase time accounting (module docstring)."""

    def __init__(self, clock=time.perf_counter, registry=None,
                 enabled=None, idle_threshold=IDLE_THRESHOLD_S):
        self._clock = clock
        self._registry = registry
        self.enabled = globals()["enabled"]() if enabled is None \
            else bool(enabled)
        self._idle_threshold = idle_threshold
        self._lock = threading.Lock()
        self._totals = {p: 0.0 for p in PHASES}
        self._pending = {p: 0.0 for p in PHASES}
        self._open = []          # stack of _Bracket
        self._t0 = None
        self._mark = None
        self._steps_settled = 0
        self._counters = None    # phase -> registry counter child
        self._gauge_installed = False
        self.compiled_path = False  # any spmd step settled this run

    # -- lifecycle ----------------------------------------------------------
    @property
    def started(self):
        return self._t0 is not None

    def start(self, now=None):
        """Open the run clock (idempotent; the first charge/settle does
        it implicitly)."""
        if not self.enabled:
            return
        with self._lock:
            self._start_locked(self._now(now))

    def _now(self, now=None):
        return self._clock() if now is None else now

    def _start_locked(self, now):
        if self._t0 is None:
            self._t0 = now
            self._mark = now
            self._install_instruments()

    # -- recording ----------------------------------------------------------
    def charge(self, phase, seconds, now=None):
        """Attribute ``seconds`` of the current (unsettled) interval to
        ``phase``. Called by the subsystems that measure their own
        stalls (loader wait, ckpt blocking, compile listener, eager
        dispatch). Thread-safe, allocation-free, no-op when disabled."""
        if not self.enabled or seconds <= 0:
            return
        if phase not in self._totals:
            phase = "overhead"
        with self._lock:
            self._start_locked(self._now(now))
            self._pending[phase] += seconds
            if self._open:
                # a measured sub-stall inside an open bracket (e.g. a
                # ckpt flush inside elastic recovery) claims its span —
                # the bracket books only what is left, keeping phases
                # exclusive
                self._open[-1].inner += seconds

    def note_compiled_path(self):
        """Mark this run as a compiled-path (GSPMD) run: its
        ``exposed_collective`` phase is structurally zero because the
        collectives live inside the compiled step. Snapshots, dumps and
        ``hvd-doctor-torch perf`` annotate the zero instead of implying no
        exposed comms — the device-side answer is ``hvd-doctor-torch xray``.
        Called by the spmd step wrappers; idempotent, a bool store."""
        self.compiled_path = True

    def phase(self, label, charge=None, health=True):
        """Context manager bracketing a blocking span: the elapsed time
        (minus any sub-charges made inside it) is charged to ``charge``
        (default: ``label`` when it names a phase, else ``overhead``).
        While open, ``health=True`` brackets flip ``/healthz`` to 503
        with ``label`` as the reported phase (docs/OBSERVABILITY.md)."""
        if charge is None:
            charge = label if label in PHASES else "overhead"
        return _PhaseContext(self, label, charge, health)

    def _open_bracket(self, label, charge_phase, health):
        # brackets open even when accounting is disabled: the /healthz
        # 503-during-transition contract rides on them and must not be
        # switched off by a perf-bookkeeping opt-out (HOROVOD_GOODPUT=0
        # only stops the time charges)
        with self._lock:
            now = self._now()
            if self.enabled:
                self._start_locked(now)
            b = _Bracket(label, charge_phase, health, now)
            self._open.append(b)
            return b

    def _close_bracket(self, bracket):
        if bracket is None:
            return
        with self._lock:
            now = self._now()
            try:
                self._open.remove(bracket)
            except ValueError:
                return
            if not self.enabled:
                return
            seg = max(0.0, now - bracket.accounted - bracket.inner)
            if seg > 0:
                self._pending[bracket.charge_phase] += seg
            if self._open:
                # the child's span is spoken for from the parent's point
                # of view — but only the part since the parent's own
                # accounting point (a settle mid-nesting already booked
                # the earlier part through both brackets)
                parent = self._open[-1]
                parent.inner += now - max(bracket.opened, parent.accounted)

    def _open_bracket_spans(self, now):
        """Unbooked seconds per open bracket, nested spans counted once:
        brackets form a stack (all opened on the training thread), so a
        child's span since the parent's accounting point is the child's
        to claim — the parent books only what is left. Returns
        ``[(bracket, seconds)]``; callers hold the lock."""
        out = []
        inner_claim = 0.0
        prev = None  # the bracket nested immediately inside this one
        for b in reversed(self._open):
            if prev is not None:
                inner_claim = now - max(prev.opened, b.accounted)
            out.append((b, max(0.0,
                               now - b.accounted - b.inner - inner_claim)))
            prev = b
        return out

    def active_health_label(self):
        """The innermost open health-relevant bracket label, or None —
        what ``/healthz`` reports (503) while a rank is parked in
        recovery/restore. Works with accounting disabled too: health
        semantics are not a perf-opt-out casualty."""
        with self._lock:
            for b in reversed(self._open):
                if b.health:
                    return b.label
        return None

    # -- settling -----------------------------------------------------------
    def settle_step(self, now=None):
        """Close the interval since the last settle at a train-step
        boundary: measured charges keep their phases, the residual is
        ``compute``. Called by the step wrappers after every step."""
        self._settle("step", now)

    def settle_idle(self, now=None):
        """Close the interval outside a step (scrape, shutdown, report):
        the residual is ``stall_idle`` when it exceeds the idle
        threshold, ``overhead`` otherwise."""
        self._settle("idle", now)

    def _settle(self, kind, now=None):
        if not self.enabled:
            return
        with self._lock:
            now = self._now(now)
            self._start_locked(now)
            # book the elapsed portion of any open bracket first so a
            # settle mid-recovery attributes the parked time correctly
            # (innermost-first: a nested child's span subtracts from its
            # parent instead of booking twice)
            for b, seg in self._open_bracket_spans(now):
                if seg > 0:
                    self._pending[b.charge_phase] += seg
                b.accounted = now
                b.inner = 0.0
            gap = max(0.0, now - self._mark)
            total = sum(self._pending.values())
            if total > gap:
                # overlapping measurements (nested stalls double-timed):
                # scale proportionally so the interval is explained
                # exactly once
                scale = (gap / total) if total > 0 else 0.0
                for p in self._pending:
                    self._pending[p] *= scale
                total = gap
            residual = gap - total
            if kind == "step":
                self._pending["compute"] += residual
                self._steps_settled += 1
            elif residual >= self._idle_threshold:
                self._pending["stall_idle"] += residual
            else:
                self._pending["overhead"] += residual
            for p, v in self._pending.items():
                if v > 0:
                    self._totals[p] += v
                    if self._counters is not None:
                        self._counters[p].inc(v)
                self._pending[p] = 0.0
            self._mark = now

    # -- reading ------------------------------------------------------------
    def snapshot(self, now=None):
        """Live view (does NOT settle): booked totals plus pending
        charges and open-bracket elapsed; ``unattributed_seconds`` is
        the tail of the current interval that has not been classified
        yet (→ ~0 after a final settle)."""
        with self._lock:
            now = self._now(now)
            phases = dict(self._totals)
            for p, v in self._pending.items():
                phases[p] += v
            if self.enabled:
                for b, seg in self._open_bracket_spans(now):
                    phases[b.charge_phase] += seg
            wall = (now - self._t0) if self._t0 is not None else 0.0
            attributed = sum(phases.values())
            if attributed > wall > 0:
                attributed = wall  # clock skew guard
            unattributed = max(0.0, wall - attributed)
            ratio = (phases["compute"] / attributed) if attributed > 0 \
                else 1.0
            return {
                "phases": phases,
                "wall_seconds": wall,
                "attributed_seconds": attributed,
                "unattributed_seconds": unattributed,
                "goodput_ratio": ratio,
                "steps": self._steps_settled,
                "compiled_path": self.compiled_path,
            }

    def finalize(self, now=None):
        """Final settle + snapshot: after this the snapshot explains
        (within float noise) every second since the run clock opened."""
        self.settle_idle(now)
        return self.snapshot(now)

    def dominant_sink(self, snapshot=None):
        """The largest non-compute phase of ``snapshot`` (or the live
        one) — ``(phase, seconds)``, or ``(None, 0.0)`` when nothing was
        charged."""
        snap = snapshot if snapshot is not None else self.snapshot()
        return dominant_sink(snap["phases"])

    # -- registry mirror ----------------------------------------------------
    def _install_instruments(self):
        if self._counters is not None:
            return
        try:
            from horovod_tpu_torch.telemetry import instruments as _tele
            from horovod_tpu_torch.telemetry.registry import get_registry
            reg = self._registry if self._registry is not None \
                else get_registry()
            fam = reg.counter(
                _tele.TIME_SECONDS,
                "Wall-clock seconds attributed to each goodput-ledger "
                "phase (exclusive; docs/OBSERVABILITY.md, 'Where did my "
                "time go')", label_names=("phase",))
            self._counters = {p: fam.labels(p) for p in PHASES}
            ledger = self

            def _ratio():
                return ledger.snapshot()["goodput_ratio"]

            reg.gauge(
                _tele.GOODPUT_RATIO,
                "compute / attributed wall time of this run's goodput "
                "ledger (1.0 = every attributed second was productive "
                "compute)").set_function(_ratio)
            self._gauge_installed = True
        except Exception:  # the ledger must never break training
            logger.debug("goodput ledger: registry mirror unavailable",
                         exc_info=True)
            self._counters = None

    # -- dumps --------------------------------------------------------------
    def write_dump(self, directory, rank, extra=None):
        """Finalize and write ``goodput.rank<r>.json`` into
        ``directory`` (atomically) — the per-rank half of the end-of-run
        report (``telemetry/report.py`` / ``hvd-doctor-torch perf``)."""
        if not self.enabled or not self.started:
            return None
        snap = self.finalize()
        payload = {
            "goodput": 1,
            "rank": int(rank),
            "wall_clock": time.time(),
            "phases": {p: round(s, 6) for p, s in snap["phases"].items()},
            "wall_seconds": round(snap["wall_seconds"], 6),
            "unattributed_seconds": round(snap["unattributed_seconds"], 6),
            "goodput_ratio": round(snap["goodput_ratio"], 6),
            "steps": snap["steps"],
            "compiled_path": snap["compiled_path"],
        }
        try:
            from horovod_tpu_torch.telemetry import instruments as _tele
            payload["build_info"] = _tele.build_info_labels()
        except Exception:
            pass
        if extra:
            payload.update(extra)
        path = os.path.join(directory, f"{DUMP_PREFIX}{int(rank)}.json")
        try:
            os.makedirs(directory, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)
        except OSError:
            logger.warning("goodput ledger: dump to %s failed", path,
                           exc_info=True)
            return None
        return path


# -- the process ledger ------------------------------------------------------

_ledger = None
_ledger_lock = threading.Lock()


def get_ledger():
    """The process-wide ledger (created lazily; ``reset_run()`` at
    ``hvd.init`` gives each run a fresh one)."""
    global _ledger
    with _ledger_lock:
        if _ledger is None:
            _ledger = TimeLedger()
        return _ledger


def reset_run(registry=None):
    """Open a fresh run ledger (called from ``runtime/services.start``
    so sequential init/shutdown cycles in one process each get their own
    attribution window). The registry counters stay cumulative — only
    the run-level snapshot resets."""
    global _ledger
    with _ledger_lock:
        _ledger = TimeLedger(registry=registry)
        if _ledger.enabled:
            _ledger.start()
    if _ledger.enabled:
        # compile time must reach the ledger even when no metrics
        # endpoint is configured (the listener records into the always-
        # safe registry either way)
        try:
            from horovod_tpu_torch.telemetry import instruments as _tele
            _tele.install_compile_listeners()
        except Exception:
            logger.debug("goodput ledger: compile listeners unavailable",
                         exc_info=True)
    return _ledger
