"""Elastic driver: membership tracking, blacklisting, re-rendezvous. The
port of ``horovod_tpu/elastic/driver.py`` (Horovod's
``horovod/run/elastic/driver.py``): the launcher-side brain of an
elastic job. It owns

* a :class:`~horovod_tpu_torch.elastic.discovery.HostDiscoveryPoller` whose
  diffs become worker interrupts (notification.py) + timeline
  ``MEMBERSHIP`` markers,
* a :class:`Blacklist` of repeatedly-failing hosts (exponential backoff,
  then permanent exclusion — reference ``blacklist_host`` semantics),
* the rendezvous loop: each *epoch* assigns ranks to the current
  non-excluded host set (reusing ``run/allocation.py``), publishes the
  assignment on the launcher KV, launches workers, and decides from exit
  codes whether the job is done, needs a plain re-rendezvous (graceful
  ``EXIT_RENDEZVOUS``), or a failure round (blame + retry).

Recovery model: workers are re-*launched* per epoch — the state plane
(elastic/state.py commit/restore/sync) provides continuity, the driver
provides membership. Worker liveness feeds in through the KV heartbeats
published by ``runtime/stall.py`` progress hooks (elastic/worker.py);
``cluster_view`` reads their metric snapshots and cross-checks their
flight-recorder digests (``diag/desync.py``).

One departure from the JAX driver: when a crash ends an epoch, the
launcher's SIGTERM fan-out reaches the surviving ranks, whose eviction
handlers announce their own hosts as doomed (no other host announced
first, so nothing marks the signal as the fan-out). The JAX driver then
drains those healthy hosts from the next rendezvous; this one takes an
announcement stamped after the epoch's first failure (``Job.
failed_at``) from a host other than the failed one as the fan-out's,
and drops it.
"""

import json
import logging
import sys
import threading
import time

from horovod_tpu_torch.diag import desync as desync_lib
from horovod_tpu_torch.elastic.discovery import HostDiscoveryPoller
from horovod_tpu_torch.elastic.notification import WorkerNotificationClient
from horovod_tpu_torch.elastic.preempt import DOOMED_KEY_PREFIX, DOOMED_MARKER_KEY
from horovod_tpu_torch.run import allocation
from horovod_tpu_torch.telemetry import get_registry
from horovod_tpu_torch.telemetry import instruments as _tele

logger = logging.getLogger("horovod_tpu_torch")

# a worker whose median step time exceeds the cluster median by this
# factor gets flagged as a straggler in the driver's cluster view
STRAGGLER_THRESHOLD = 2.0

# Worker exit code meaning "re-rendezvous requested" (EX_TEMPFAIL): the
# elastic loop exits with it on HostsUpdatedInterrupt under a driver, so
# the driver can tell a graceful world change from a crash.
EXIT_RENDEZVOUS = 75

# A heartbeat younger than this marks its host "healthy" in the
# cluster view — the sustained-health evidence that decays blacklist
# failure counts.
HEALTHY_HEARTBEAT_S = 30.0

# Default unbroken-health window that forgives one below-threshold
# failure (driver-constructed Blacklists; pass your own to override).
BLACKLIST_DECAY_WINDOW_S = 300.0

# A doomed-host announcement older than this is stale: the spot host
# either already died (and discovery dropped it) or came back — it must
# not stay excluded forever on a leftover key.
DOOMED_TTL_S = 120.0


class Blacklist:
    """Failure accounting per host (reference ``ElasticDriver``'s
    blacklist + cooldown): each failure excludes the host for an
    exponentially growing backoff window; after ``threshold`` failures it
    is excluded permanently.

    Two refinements over the reference for spot capacity:

    * **drained ≠ crashed** — a host whose eviction was announced on the
      KV (``elastic/preempt.py``) departs via :meth:`record_drain`,
      which carries no penalty: preemption is the *plan* on spot
      capacity, and penalizing it would walk every host toward
      permanent exclusion.
    * **decay on sustained health** — with ``decay_window`` set, each
      unbroken window of observed health (:meth:`observe_health`, fed by
      the driver's ``cluster_view()`` heartbeat freshness) forgives one
      below-threshold failure, so a host that flapped once is not one
      failure from permanent exclusion for the life of a week-long run.
      Permanent blacklisting never decays.

    ``clock`` is injectable so tests can drive the backoff and the decay
    without sleeping."""

    def __init__(self, threshold=3, base_delay=5.0, max_delay=600.0,
                 clock=time.monotonic, decay_window=None):
        self._threshold = threshold
        self._base = base_delay
        self._max = max_delay
        self._clock = clock
        self._decay_window = decay_window
        self._failures = {}   # host -> count
        self._cooldown = {}   # host -> excluded-until timestamp
        self._drains = {}     # host -> graceful-departure count
        self._healthy_anchor = {}  # host -> start of current health streak

    def record_failure(self, host):
        n = self._failures.get(host, 0) + 1
        self._failures[host] = n
        self._healthy_anchor.pop(host, None)  # a failure breaks the streak
        delay = min(self._base * (2 ** (n - 1)), self._max)
        self._cooldown[host] = self._clock() + delay
        if n >= self._threshold:
            logger.warning("elastic: host %s blacklisted after %d failures",
                           host, n)
        else:
            logger.warning("elastic: host %s failed (%d/%d), backing off "
                           "%.1fs", host, n, self._threshold, delay)
        return n

    def record_drain(self, host):
        """A planned departure (graceful eviction announced on the KV):
        counted for observability, zero blacklist penalty."""
        n = self._drains.get(host, 0) + 1
        self._drains[host] = n
        logger.info("elastic: host %s drained gracefully (%d drain(s), "
                    "no penalty)", host, n)
        return n

    def observe_health(self, hosts, now=None):
        """Feed sustained-health evidence: ``hosts`` is the set observed
        healthy right now (fresh heartbeats in ``cluster_view()``). A
        host absent from consecutive observations loses its streak; each
        full ``decay_window`` of unbroken presence forgives one
        below-threshold failure. No-op without ``decay_window``."""
        if not self._decay_window:
            return
        now = self._clock() if now is None else now
        hosts = set(hosts)
        for host in list(self._healthy_anchor):
            if host not in hosts:
                del self._healthy_anchor[host]
        for host in hosts:
            anchor = self._healthy_anchor.setdefault(host, now)
            n = self._failures.get(host, 0)
            if n <= 0 or n >= self._threshold:
                continue
            if now - anchor >= self._decay_window:
                n -= 1
                self._healthy_anchor[host] = now
                if n <= 0:
                    self._failures.pop(host, None)
                    self._cooldown.pop(host, None)
                else:
                    self._failures[host] = n
                logger.info("elastic: host %s healthy for %.0fs — failure "
                            "count decayed to %d", host,
                            self._decay_window, n)

    def count(self, host):
        return self._failures.get(host, 0)

    def drains(self, host):
        return self._drains.get(host, 0)

    def blacklisted(self, host):
        """Permanently excluded (failure count reached the threshold)."""
        return self._failures.get(host, 0) >= self._threshold

    def excluded(self, host, now=None):
        """Excluded right now: blacklisted, or inside a backoff window."""
        if self.blacklisted(host):
            return True
        until = self._cooldown.get(host)
        if until is None:
            return False
        return (now if now is not None else self._clock()) < until

    @property
    def hosts(self):
        """The permanently blacklisted host set."""
        return {h for h, n in self._failures.items()
                if n >= self._threshold}


class ElasticDriver:
    """Launcher-side elastic controller.

    ``kv`` is the launcher's :class:`~horovod_tpu_torch.run.rendezvous.
    KVStoreServer`; workers publish their notification endpoints and
    heartbeats there (elastic/worker.py) and the driver publishes each
    epoch's rank assignment under ``elastic/slots/<epoch>``.
    """

    def __init__(self, discovery, min_np, max_np=None, blacklist=None,
                 kv=None, auth_key=None, poll_interval=1.0, timeline=None,
                 start_timeout=600, hopeless_grace=30.0,
                 doomed_ttl=DOOMED_TTL_S):
        if min_np < 1:
            raise ValueError(f"min_np must be >= 1 (got {min_np})")
        if max_np is not None and max_np < min_np:
            raise ValueError(
                f"max_np ({max_np}) must be >= min_np ({min_np})")
        self.min_np = min_np
        self.max_np = max_np
        self.blacklist = blacklist if blacklist is not None else Blacklist(
            decay_window=BLACKLIST_DECAY_WINDOW_S)
        self._doomed_ttl = doomed_ttl
        self._kv = kv
        self._auth_key = auth_key
        self._timeline = timeline
        self._start_timeout = start_timeout
        self._hopeless_grace = hopeless_grace
        self._poll_interval = poll_interval
        self.epoch = 0
        self._current_slots = []
        self._membership_dirty = False
        self._flagged_stragglers = set()
        self._flagged_desync = set()
        self._last_digests = None
        self._poller = HostDiscoveryPoller(
            discovery, poll_interval=poll_interval,
            on_update=self._on_hosts_updated)
        # launcher-side telemetry (the driver has its own registry view;
        # worker metrics arrive through the KV heartbeats)
        reg = get_registry()
        self._m_epochs = reg.counter(
            _tele.RENDEZVOUS_EPOCHS, "Rendezvous epochs opened")
        self._m_blacklist = reg.gauge(
            _tele.BLACKLIST_HOSTS, "Hosts currently excluded "
            "(blacklisted or in a backoff window)")
        self._m_recovery = reg.histogram(
            _tele.RECOVERY_SECONDS, "Wall time from a worker failure to "
            "the next completed rendezvous")
        self._m_straggler = reg.gauge(
            _tele.STRAGGLER_RATIO, "Slowest/median per-rank median step "
            "time across the current epoch's workers")
        self._m_goodput = reg.gauge(
            _tele.GOODPUT_RATIO, "Fleet-wide goodput: summed compute "
            "seconds / summed attributed seconds across the workers' "
            "per-rank goodput ledgers (KV heartbeat snapshots)")
        self._m_preempt = reg.counter(
            _tele.PREEMPTIONS_TOTAL, "Preemption notices acted on, by "
            "source kind",
            label_names=("kind",))
        self._m_drain = reg.histogram(
            _tele.DRAIN_SECONDS, "Doomed-host announcement to the "
            "rendezvous that drained (or knowingly reused) the host — "
            "the wall cost of planned churn")

    # -- membership ----------------------------------------------------------
    def available_hosts(self):
        """Current discovery view minus excluded hosts."""
        hosts = self._poller.current()
        return {h: s for h, s in hosts.items()
                if s > 0 and not self.blacklist.excluded(h)}

    def available_slots(self):
        return sum(self.available_hosts().values())

    def wait_for_available_slots(self, count, timeout=None):
        """Block until at least ``count`` slots exist on non-excluded
        hosts (reference ``wait_for_available_slots``); TimeoutError
        names the shortfall and the blacklist."""
        timeout = timeout if timeout is not None else self._start_timeout
        deadline = time.monotonic() + timeout
        hopeless_deadline = None
        while True:
            hosts = self.available_hosts()
            if sum(hosts.values()) >= count:
                return hosts
            # hosts in a backoff window come back on their own, but
            # permanently blacklisted ones never do: when even counting
            # the cooled-down hosts the target is unreachable, only NEW
            # hosts from discovery could save the job — fail fast after
            # a short grace instead of burning the full start timeout.
            # The clamp is recomputed per iteration so a transiently
            # empty discovery view (flaky script) cannot permanently
            # shorten the real deadline.
            view = self._poller.current()
            potential = sum(s for h, s in view.items()
                            if not self.blacklist.blacklisted(h))
            if potential < count:
                if hopeless_deadline is None:
                    hopeless_deadline = time.monotonic() + min(
                        timeout, self._hopeless_grace)
                effective = min(deadline, hopeless_deadline)
            else:
                hopeless_deadline = None
                effective = deadline
            if time.monotonic() >= effective:
                raise TimeoutError(
                    f"elastic: needed {count} slots but only "
                    f"{sum(hosts.values())} available after {timeout:.0f}s "
                    f"(hosts={sorted(hosts)}, "
                    f"blacklisted={sorted(self.blacklist.hosts)})")
            # re-poll at the configured discovery cadence (the wait must
            # not hammer an external discovery script at 4 Hz)
            time.sleep(min(self._poll_interval,
                           max(0.05, effective - time.monotonic())))
            self._poller.poll_once()

    def _read_doomed(self):
        """Fresh doomed-host announcements (``elastic/doomed/<host>``,
        published by evicted workers — elastic/preempt.py), keyed by
        host. Stale entries (older than ``doomed_ttl``) are dropped and
        deleted: a reclaimed spot host that came back must not stay
        excluded on a leftover key."""
        if self._kv is None:
            return {}
        hosts = set(self._poller.current()) | {
            s.hostname for s in self._current_slots}
        doomed = {}
        for host in sorted(hosts):
            raw = self._kv.get(DOOMED_KEY_PREFIX + host)
            if raw is None:
                continue
            try:
                info = json.loads(raw)
            except (ValueError, UnicodeDecodeError):
                info = {}
            ts = float(info.get("time") or 0)
            if ts and abs(time.time() - ts) > self._doomed_ttl:
                self._kv.delete(DOOMED_KEY_PREFIX + host)
                continue
            doomed[host] = info
        return doomed

    def _consume_doomed(self, hosts):
        """Drain announced-doomed hosts from the rendezvous about to
        open — the point of the announcement: the host leaves the world
        BEFORE its death breaks a collective. One-shot (the keys are
        consumed here). When excluding every doomed host would drop
        below ``min_np`` the hosts are knowingly reused — a doomed host
        that has not died yet beats failing the job, and the
        announcement still bought no-blame drain accounting."""
        doomed = self._read_doomed()
        if not doomed:
            return {}
        kept = {h: s for h, s in hosts.items() if h not in doomed}
        if sum(kept.values()) >= self.min_np:
            for host in doomed:
                hosts.pop(host, None)
            logger.info("elastic: draining doomed host(s) %s from the "
                        "next rendezvous", sorted(doomed))
        else:
            logger.warning(
                "elastic: doomed host(s) %s announced but the remaining "
                "capacity is below min_np=%d; knowingly reusing them",
                sorted(doomed), self.min_np)
        now = time.time()
        for host, info in doomed.items():
            self._kv.delete(DOOMED_KEY_PREFIX + host)
            ts = float(info.get("time") or now)
            self._m_preempt.labels(info.get("kind") or "sigterm").inc()
            self._m_drain.observe(max(0.0, now - ts))
        self._kv.delete(DOOMED_MARKER_KEY)
        self._membership_event(
            "DRAIN", {"epoch": self.epoch, "hosts": sorted(doomed),
                      "reused": sum(kept.values()) < self.min_np})
        return doomed

    def _on_hosts_updated(self, added, removed, current, res):
        logger.info("elastic: host set changed (added=%s removed=%s)",
                    added, removed)
        self._membership_event("UPDATED",
                               {"added": added, "removed": removed,
                                "hosts": sorted(current)})
        reason = "removed" if removed and not added else (
            "added" if added and not removed else "updated")
        self._membership_dirty = True
        if not self.notify_workers(reason):
            # workers may still be booting (endpoint not yet on the KV):
            # keep trying in the background until one acks or the epoch
            # turns over — a membership change must never be lost to a
            # startup race
            self._notify_until_acked(reason, self.epoch)

    def _notify_until_acked(self, res, epoch, attempts=120, interval=0.25):
        def _retry():
            for _ in range(attempts):
                time.sleep(interval)
                if self.epoch != epoch:
                    return
                if self.notify_workers(res):
                    return
            logger.warning("elastic: no worker acked the %s membership "
                           "update in epoch %d", res, epoch)

        threading.Thread(target=_retry, daemon=True,
                         name="hvd_torch_elastic_notify").start()

    def _membership_event(self, event, details):
        if self._timeline is not None:
            self._timeline.membership(event, details)

    # -- worker notification / liveness --------------------------------------
    def _worker_endpoints(self):
        """Notification endpoints the current epoch's workers published
        on the KV (rank -> (addr, port))."""
        if self._kv is None:
            return {}
        endpoints = {}
        for slot in self._current_slots:
            raw = self._kv.get(f"elastic/notif/{self.epoch}/{slot.rank}")
            if raw is None:
                continue
            info = json.loads(raw)
            endpoints[slot.rank] = (info["addr"], int(info["port"]))
        return endpoints

    def notify_workers(self, res="updated"):
        """Post a hosts-updated interrupt to every reachable worker;
        unreachable ones are already dead or will learn at relaunch."""
        notified = []
        for rank, (addr, port) in self._worker_endpoints().items():
            try:
                acked = WorkerNotificationClient(
                    addr, port, key=self._auth_key).notify_hosts_updated(res)
            except OSError:
                continue
            if acked:  # a dropped frame / empty reply is NOT delivery
                notified.append(rank)
        return notified

    def worker_progress(self):
        """The driver's liveness view: last heartbeat each current worker
        published through its stall-inspector progress hook
        (``elastic/heartbeat/<epoch>/<rank>`` -> {step, time})."""
        if self._kv is None:
            return {}
        progress = {}
        for slot in self._current_slots:
            raw = self._kv.get(f"elastic/heartbeat/{self.epoch}/{slot.rank}")
            if raw is not None:
                progress[slot.rank] = json.loads(raw)
        return progress

    def cluster_view(self):
        """Aggregate the metric snapshots riding the KV heartbeats into
        the coordinator's view of the epoch: per-rank step progress and
        step-time medians, the slowest/median step-time ratio, and the
        flagged straggler ranks (ratio > ``STRAGGLER_THRESHOLD``).
        Updates the ``hvd_straggler_step_time_ratio`` gauge and logs
        flagged ranks (rate-limited to once per epoch per rank)."""
        progress = self.worker_progress()
        view = {"epoch": self.epoch, "ranks": {}, "stragglers": [],
                "straggler_ratio": None, "goodput": None}
        # sustained-health evidence for blacklist decay: a fresh
        # heartbeat marks the rank's host healthy this observation
        now_wall = time.time()
        healthy_hosts = set()
        for slot in self._current_slots:
            hb = progress.get(slot.rank)
            if hb and now_wall - float(hb.get("time") or 0) \
                    <= HEALTHY_HEARTBEAT_S:
                healthy_hosts.add(slot.hostname)
        if healthy_hosts:
            self.blacklist.observe_health(healthy_hosts)
        view["healthy_hosts"] = sorted(healthy_hosts)
        step_times = {}
        fleet_phases = {}
        for rank, hb in progress.items():
            m = hb.get("metrics") or {}
            view["ranks"][rank] = {
                "step": hb.get("step"), "last_heartbeat": hb.get("time"),
                **m}
            t = m.get("step_seconds_p50")
            if t:
                step_times[rank] = float(t)
            for phase, secs in (m.get("goodput") or {}).items():
                fleet_phases[phase] = fleet_phases.get(phase, 0.0) \
                    + float(secs)
        if fleet_phases:
            # the live fleet-wide goodput gauge: per-rank ledger phase
            # totals ride the heartbeats (instruments.kv_snapshot), the
            # driver just sums rank-seconds
            attributed = sum(fleet_phases.values())
            ratio = (fleet_phases.get("compute", 0.0) / attributed
                     if attributed > 0 else 1.0)
            view["goodput"] = {"phases": fleet_phases, "ratio": ratio}
            self._m_goodput.set(ratio)
        if len(step_times) >= 2:
            ordered = sorted(step_times.values())
            # LOWER median: with the upper-middle element, a 2-worker
            # cluster's "median" would be its own slowest rank and a 10x
            # straggler could never be flagged
            median = ordered[(len(ordered) - 1) // 2]
            slowest = ordered[-1]
            if median > 0:
                ratio = slowest / median
                view["straggler_ratio"] = ratio
                self._m_straggler.set(ratio)
                view["stragglers"] = sorted(
                    r for r, t in step_times.items()
                    if t / median > STRAGGLER_THRESHOLD)
        fresh = [r for r in view["stragglers"]
                 if r not in self._flagged_stragglers]
        if fresh:
            self._flagged_stragglers.update(fresh)
            logger.warning(
                "elastic: epoch %d straggler(s) %s — median step time "
                ">%.1fx the cluster median (%s)", self.epoch, fresh,
                STRAGGLER_THRESHOLD,
                {r: round(step_times[r], 4) for r in fresh})
        view["flightrec"] = self._cross_check_digests(progress)
        return view

    def _cross_check_digests(self, progress):
        """Desync detection while the job hangs: compare the flight-
        recorder digests riding the heartbeats (seq + collective-schedule
        hash, ``horovod_tpu_torch.diag.desync``) and NAME the rank whose
        schedule diverged or whose seq stopped advancing — the live
        mirror of Horovod's controller's shape/dtype mismatch checks
        (``controller.cc:55-346``)."""
        digests = {r: hb.get("flightrec") for r, hb in progress.items()
                   if hb.get("flightrec")}
        check = desync_lib.cross_check(digests, prev=self._last_digests)
        self._last_digests = digests or self._last_digests
        fresh = [r for r in check["desynced"]
                 if r not in self._flagged_desync]
        if fresh:
            self._flagged_desync.update(fresh)
            logger.error(
                "elastic: epoch %d DESYNC — rank(s) %s diverged from the "
                "majority collective schedule (%s); their compiled/eager "
                "collective order no longer matches the cluster",
                self.epoch, fresh, check.get("detail"))
            self._membership_event(
                "DESYNC", {"epoch": self.epoch, "ranks": fresh,
                           "detail": check.get("detail")})
        if check["stuck"]:
            logger.warning(
                "elastic: epoch %d rank(s) %s stopped advancing their "
                "collective seq while peers progressed (%s) — dead data "
                "feed or wedged collective; flight-recorder dumps will "
                "name the op (hvdrun-torch --doctor)", self.epoch,
                check["stuck"], check["seqs"])
        return check

    # -- rendezvous ----------------------------------------------------------
    def rendezvous(self):
        """Open a new epoch: wait for min-np capacity, assign ranks to
        the current host set (capped at max-np), publish the assignment.
        Returns the slot list."""
        hosts = self.wait_for_available_slots(self.min_np)
        self._consume_doomed(hosts)
        host_list = [allocation.HostSlots(h, s)
                     for h, s in sorted(hosts.items())]
        total = sum(h.slots for h in host_list)
        np_now = min(total, self.max_np) if self.max_np else total
        self.epoch += 1
        slots = allocation.allocate(host_list, np_now)
        self._current_slots = slots
        self._flagged_stragglers = set()
        self._flagged_desync = set()
        self._last_digests = None  # fresh processes restart their seqs
        self._m_epochs.inc()
        self._m_blacklist.set(sum(
            1 for h in self._poller.current()
            if self.blacklist.excluded(h)))
        if self._kv is not None:
            # stale cross-epoch coordination keys must not leak into the
            # new world (a late rank would adopt epoch N-1's controller)
            self._kv.delete("controller/port")
            self._kv.put(f"elastic/slots/{self.epoch}", json.dumps(
                [{"rank": s.rank, "host": s.hostname,
                  "local_rank": s.local_rank} for s in slots]).encode())
            self._kv.put("elastic/epoch", str(self.epoch).encode())
        self._membership_event("RENDEZVOUS",
                               {"epoch": self.epoch, "np": np_now,
                                "hosts": sorted(hosts)})
        logger.info("elastic: epoch %d rendezvous: %d ranks on %s",
                    self.epoch, np_now, sorted(hosts))
        return slots

    def worker_env(self):
        """Extra env vars every elastic worker gets (the elastic side of
        the launcher env contract)."""
        env = {"HOROVOD_ELASTIC": "1",
               "HOROVOD_ELASTIC_EPOCH": str(self.epoch),
               "HOROVOD_ELASTIC_MIN_NP": str(self.min_np)}
        if self.max_np is not None:
            env["HOROVOD_ELASTIC_MAX_NP"] = str(self.max_np)
        return env

    # -- the retry loop ------------------------------------------------------
    def run_job(self, launch_fn, max_epochs=None):
        """Drive the job to completion: launch an epoch, inspect exit
        codes, blame/blacklist, re-rendezvous, repeat.

        ``launch_fn(slots, epoch, extra_env)`` must start one worker per
        slot and return a :class:`horovod_tpu_torch.run.launcher.Job` (or
        anything with ``join() -> {rank: exit_code}`` and
        ``first_failure``; ``failed_at``, the wall time of that failure,
        when it has one). Returns the number of epochs used."""
        self._poller.start()
        spurious_drains = 0
        failure_time = None
        monitor_stop = threading.Event()
        monitor = threading.Thread(
            target=self._monitor_cluster, args=(monitor_stop,),
            name="hvd_torch_elastic_cluster", daemon=True)
        monitor.start()
        try:
            while True:
                if max_epochs is not None and self.epoch >= max_epochs:
                    raise RuntimeError(
                        f"elastic: giving up after {self.epoch} epochs")
                slots = self.rendezvous()
                if failure_time is not None:
                    # failure -> blame -> wait-for-slots -> new epoch
                    # published: the recovery wall-time the north-star
                    # cares about
                    self._m_recovery.observe(
                        time.monotonic() - failure_time)
                    failure_time = None
                job = launch_fn(slots, self.epoch, self.worker_env())
                job.join()
                first = job.first_failure
                if first is None:
                    logger.info("elastic: job completed in epoch %d",
                                self.epoch)
                    return self.epoch
                rank, rc = first
                doomed = self._read_doomed()
                if rc != EXIT_RENDEZVOUS:
                    self._drop_fanout(doomed, slots[rank].hostname,
                                      getattr(job, "failed_at", None))
                if rc == EXIT_RENDEZVOUS:
                    # graceful: workers drained at a commit boundary in
                    # response to a membership interrupt — no blame. A
                    # drain with NO membership change behind it means the
                    # command exits 75 on its own: cap it, or hvdrun
                    # would relaunch in a tight infinite loop.
                    if doomed:
                        # planned churn: an evicted worker announced its
                        # host before exiting (elastic/preempt.py) —
                        # blame nobody; the next rendezvous consumes the
                        # announcement and drains the host
                        spurious_drains = 0
                        for h in sorted(doomed):
                            self.blacklist.record_drain(h)
                        logger.info(
                            "elastic: epoch %d graceful eviction of %s "
                            "(kind=%s)", self.epoch, sorted(doomed),
                            sorted({(d.get("kind") or "sigterm")
                                    for d in doomed.values()}))
                    elif self._membership_dirty:
                        self._membership_dirty = False
                        spurious_drains = 0
                    else:
                        spurious_drains += 1
                        if spurious_drains >= 3:
                            raise RuntimeError(
                                "elastic: workers exited with "
                                f"EXIT_RENDEZVOUS ({EXIT_RENDEZVOUS}) "
                                f"{spurious_drains} times with no "
                                "membership change; treating as a "
                                "persistent failure")
                        time.sleep(1.0)
                    logger.info("elastic: epoch %d drained for "
                                "re-rendezvous", self.epoch)
                    continue
                spurious_drains = 0
                failure_time = time.monotonic()
                host = slots[rank].hostname
                logger.warning(
                    "elastic: epoch %d rank %d on %s exited with %s "
                    "(last heartbeat: %s)", self.epoch, rank, host, rc,
                    self.worker_progress().get(rank))
                if host in doomed:
                    # the doomed host died before finishing its clean
                    # exit (SIGKILL beat the grace window) — still
                    # PLANNED churn: drain accounting, no backoff that
                    # would penalize the next rendezvous
                    self.blacklist.record_drain(host)
                    self._membership_event(
                        "DRAIN", {"epoch": self.epoch, "rank": rank,
                                  "host": host, "exit_code": rc,
                                  "crashed_in_grace": True})
                else:
                    self.blacklist.record_failure(host)
                    self._membership_event(
                        "FAILURE", {"epoch": self.epoch, "rank": rank,
                                    "host": host, "exit_code": rc})
        finally:
            monitor_stop.set()
            self._poller.stop()

    def _drop_fanout(self, doomed, failed_host, failed_at):
        """Drop from ``doomed`` (and the store) the announcements that
        the launcher's SIGTERM fan-out after a crash made: stamped at or
        after the epoch's first failure, by a host other than the failed
        one (module docstring)."""
        if failed_at is None or self._kv is None:
            return
        for host in sorted(doomed):
            info = doomed[host]
            if host == failed_host or \
                    float(info.get("time") or 0) < failed_at:
                continue
            logger.info("elastic: host %s's eviction was the fan-out of "
                        "the crash on %s; not a drain", host, failed_host)
            del doomed[host]
            self._kv.delete(DOOMED_KEY_PREFIX + host)
            raw = self._kv.get(DOOMED_MARKER_KEY)
            try:
                marker = json.loads(raw) if raw is not None else {}
            except (ValueError, UnicodeDecodeError):
                marker = {}
            if marker.get("host") == host:
                self._kv.delete(DOOMED_MARKER_KEY)

    def _monitor_cluster(self, stop_event, interval=None):
        """Background cluster-view refresh while a job runs: keeps the
        straggler gauge current and the flag log timely (run_job itself
        is blocked in ``job.join()``)."""
        interval = interval if interval is not None else max(
            2.0, 5 * self._poll_interval)
        while not stop_event.wait(interval):
            try:
                self.cluster_view()
            except Exception:
                logger.debug("cluster view refresh failed", exc_info=True)

    def stop(self):
        self._poller.stop()


def default_launch_fn(command, controller_port=0, rendezvous_addr=None,
                      rendezvous_port=None, extra_env=None, ssh_port=None,
                      output_dir=None, jax_coordinator=False):
    """Build a ``launch_fn`` for :meth:`ElasticDriver.run_job` that runs
    ``command`` on real hosts through ``run/launcher.py`` (the hvdrun
    elastic path). Per-rank logs go to ``output_dir/epoch-<n>/`` so a
    relaunch never truncates the previous epoch's logs, the evidence of
    the failure being recovered from. With ``jax_coordinator`` each
    epoch's ranks get ``HOROVOD_COORDINATOR_ADDR``, the job's rendezvous
    store on the launcher's host (``run.spmd_env``)."""
    import os

    from horovod_tpu_torch.run import launcher

    def launch(slots, epoch, elastic_env):
        env = dict(extra_env or {})
        env.update(elastic_env)
        controller_addr = slots[0].hostname
        if controller_addr in launcher.LOCAL_HOSTS:
            controller_addr = "127.0.0.1"
        if jax_coordinator:
            addr = rendezvous_addr or launcher.launcher_addr(slots)
            env["HOROVOD_COORDINATOR_ADDR"] = f"{addr}:{rendezvous_port}"
        out_dir = (os.path.join(output_dir, f"epoch-{epoch}")
                   if output_dir else None)
        sys.stderr.write(
            f"hvdrun: elastic epoch {epoch}: launching "
            f"{len(slots)} workers\n")
        return launcher.launch(
            slots, command, controller_addr, controller_port,
            rendezvous_addr=rendezvous_addr,
            rendezvous_port=rendezvous_port, extra_env=env,
            ssh_port=ssh_port, output_dir=out_dir)

    return launch
