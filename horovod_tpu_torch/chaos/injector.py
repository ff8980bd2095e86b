"""ChaosMonkey: applies a seeded :class:`~horovod_tpu_torch.chaos.plan.
ChaosPlan` to the live worker processes of an ``hvdrun-torch`` job. The
port of ``horovod_tpu/chaos/injector.py``.

The monkey runs on its own daemon thread with an injectable clock and
sleeper (fake-clock tests drive the whole schedule in microseconds). It
deliberately holds a *reference* to the current
:class:`~horovod_tpu_torch.run.launcher.Job` rather than a process list:
elastic runs replace the job every rendezvous epoch, and ``attach()``
retargets the remaining injections at the new epoch's workers.

Kind semantics against a POSIX process:

* ``sigterm``   — ``send_signal(SIGTERM)``: a spot eviction notice; the
  worker's graceful-eviction handler (elastic/preempt.py) gets its
  bounded grace window.
* ``sigkill``   — ``kill()``: an ungraceful host loss; no grace, no
  announcement — the driver must blame and back off via the crash path.
* ``stall``     — ``SIGSTOP`` then ``SIGCONT`` after ``duration``: a
  straggler / live-lock; peers park in collectives meanwhile.
* ``slow_disk`` — pulsed ``SIGSTOP``/``SIGCONT`` (duty-cycled) for
  ``duration``: approximates degraded I/O by periodically freezing the
  rank, which elongates its checkpoint writes and step times without
  killing it. (True fault injection at the filesystem layer needs
  privileges a test harness cannot assume.)
* ``host_sigterm`` / ``host_sigkill`` — the rank draw picks a live
  *host* (``Job.slots`` hostnames) and EVERY live rank on it gets the
  signal: preemption at the granularity it actually arrives on
  multi-host clusters. The graceful form lets every rank's eviction
  handler announce the host, so the elastic driver records a *drain*
  (no blacklist penalty) rather than N crashes — drained ≠ crashed at
  host scope (elastic/driver.py Blacklist).
"""

import signal
import sys
import threading
import time

from horovod_tpu_torch.chaos.plan import KINDS  # noqa: F401  (re-export)

# slow_disk duty cycle: frozen 40% of each 250ms period
_SLOW_DISK_PERIOD_S = 0.25
_SLOW_DISK_DUTY = 0.4


def _log(msg):
    sys.stderr.write(f"hvd-chaos: {msg}\n")
    sys.stderr.flush()


class ChaosMonkey:
    """Schedules a plan's injections against a live job."""

    def __init__(self, plan, clock=time.monotonic, sleep=time.sleep):
        self.plan = plan
        self.injections_done = []   # (Injection, rank, pid) applied
        self._attempted = 0         # injections attempted (host kinds
        #                             append one done-entry PER RANK)
        self._clock = clock
        self._sleep = sleep
        self._job = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None

    # -- lifecycle ---------------------------------------------------------

    def attach(self, job):
        """(Re)target the monkey at ``job``'s processes. The first call
        also starts the scheduler thread; elastic re-launches call it
        again each epoch so pending injections hit the NEW workers."""
        with self._lock:
            self._job = job
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="hvd_torch_chaos", daemon=True)
            self._thread.start()
            _log(f"armed: {self.plan.describe()}")
        return self

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout=5.0)

    def done(self):
        # plan items attempted, never done-entries: a host injection
        # appends one entry per rank it fells, so counting entries would
        # report the plan done while items are still pending (the JAX
        # injector's max(attempted, entries) does)
        return self._attempted >= len(self.plan.injections) \
            or self._stop.is_set()

    # -- scheduler ---------------------------------------------------------

    def _run(self):
        start = self._clock()
        for inj in self.plan.injections:
            while not self._stop.is_set():
                remaining = start + inj.at - self._clock()
                if remaining <= 0:
                    break
                self._sleep(min(0.25, remaining))
            if self._stop.is_set():
                return
            self._apply(inj)
            self._attempted += 1
        _log(f"plan complete: {len(self.injections_done)} injection(s) "
             f"applied")

    def _live_procs(self):
        with self._lock:
            job = self._job
        if job is None:
            return []
        return [(rank, p) for rank, p in enumerate(job.procs)
                if p.poll() is None]

    def _hostname(self, rank):
        with self._lock:
            job = self._job
        slots = getattr(job, "slots", None)
        if slots and rank < len(slots):
            return slots[rank].hostname
        return "local"  # no slot map: the whole job is one host

    def _apply_host(self, inj, live):
        """Host-granularity kinds: the draw picks a live HOST; every
        live rank on it gets the signal."""
        hosts = {}
        for rank, proc in live:
            hosts.setdefault(self._hostname(rank), []).append((rank, proc))
        names = sorted(hosts)
        target = names[inj.rank % len(names)]
        sig = (signal.SIGKILL if inj.kind == "host_sigkill"
               else signal.SIGTERM)
        hit = []
        for rank, proc in hosts[target]:
            try:
                if sig == signal.SIGKILL:
                    proc.kill()
                else:
                    proc.send_signal(sig)
            except OSError as e:
                _log(f"{inj.kind} -> host {target} rank {rank}: {e}")
                continue
            self.injections_done.append(
                (inj, rank, getattr(proc, "pid", None)))
            hit.append(rank)
        _log(f"t+{inj.at:.1f}s {inj.kind} -> host {target} "
             f"(ranks {hit})")

    def _apply(self, inj):
        live = self._live_procs()
        if not live:
            _log(f"skip {inj.kind} at t+{inj.at:.1f}s: no live processes")
            return
        if inj.kind in ("host_sigterm", "host_sigkill"):
            return self._apply_host(inj, live)
        rank, proc = live[inj.rank % len(live)]
        try:
            if inj.kind == "sigterm":
                proc.send_signal(signal.SIGTERM)
            elif inj.kind == "sigkill":
                proc.kill()
            elif inj.kind == "stall":
                self._freeze(proc, inj.duration)
            elif inj.kind == "slow_disk":
                self._pulse(proc, inj.duration)
        except OSError as e:
            _log(f"{inj.kind} -> rank {rank}: {e}")
            return
        self.injections_done.append((inj, rank, getattr(proc, "pid", None)))
        _log(f"t+{inj.at:.1f}s {inj.kind} -> rank {rank} "
             f"(pid {getattr(proc, 'pid', '?')})"
             + (f" for {inj.duration:.1f}s"
                if inj.kind in ("stall", "slow_disk") else ""))

    def _freeze(self, proc, duration):
        proc.send_signal(signal.SIGSTOP)
        try:
            end = self._clock() + max(0.0, duration)
            while not self._stop.is_set():
                remaining = end - self._clock()
                if remaining <= 0:
                    break
                self._sleep(min(0.25, remaining))
        finally:
            if proc.poll() is None:
                proc.send_signal(signal.SIGCONT)

    def _pulse(self, proc, duration):
        end = self._clock() + max(0.0, duration)
        while not self._stop.is_set() and self._clock() < end \
                and proc.poll() is None:
            self._freeze(proc, _SLOW_DISK_PERIOD_S * _SLOW_DISK_DUTY)
            self._sleep(_SLOW_DISK_PERIOD_S * (1.0 - _SLOW_DISK_DUTY))
