"""Host discovery for elastic jobs: the port of
``horovod_tpu/elastic/discovery.py`` (Horovod's
``horovod/run/elastic/discovery.py``). A ``HostDiscovery``
interface the driver polls for the current ``{hostname: slots}`` view,
with a fixed implementation for static clusters and a script-backed one
(``--host-discovery-script``) for schedulers that can report membership
(spot/preemptible pools, cluster autoscalers).

The poller thread diffs consecutive views and reports additions and
removals to the driver, which turns them into worker interrupts and a
re-rendezvous (driver.py).
"""

import logging
import subprocess
import threading

logger = logging.getLogger("horovod_tpu_torch")


class HostUpdateResult:
    """Bitmask describing a membership diff (reference
    ``HostUpdateResult``): what the poller saw between two views."""
    NO_UPDATE = 0
    ADDED = 1
    REMOVED = 2
    MIXED = ADDED | REMOVED


class HostDiscovery:
    """Interface: report the CURRENT available hosts and their slots."""

    def find_available_hosts_and_slots(self):
        """Return ``{hostname: slots}`` for every host usable right now."""
        raise NotImplementedError


class FixedHosts(HostDiscovery):
    """A static host set (reference ``FixedHosts``): elasticity then means
    "survive losing members of this set", not growing it.

    Accepts ``{host: slots}``, a ``"h1:4,h2:2"`` spec string, or a list of
    ``run.allocation.HostSlots``. The set can be swapped at runtime with
    :meth:`set` — tests and schedulers use that to simulate membership
    changes.
    """

    def __init__(self, hosts):
        self._lock = threading.Lock()
        self._hosts = _normalize_hosts(hosts)

    def find_available_hosts_and_slots(self):
        with self._lock:
            return dict(self._hosts)

    def set(self, hosts):
        with self._lock:
            self._hosts = _normalize_hosts(hosts)


class ScriptDiscovery(HostDiscovery):
    """Poll an external executable (reference ``HostDiscoveryScript``,
    ``--host-discovery-script``): it must print one host per line,
    ``hostname:slots`` or bare ``hostname`` (= ``default_slots``).

    A failing script (non-zero exit) reports an EMPTY host set — the
    driver's min-np wait then decides whether that is fatal; a flaky
    script must not crash the polling thread."""

    def __init__(self, script, default_slots=1, timeout=10.0):
        self._script = script
        self._default_slots = default_slots
        self._timeout = timeout

    def find_available_hosts_and_slots(self):
        try:
            out = subprocess.run(
                [self._script], capture_output=True, text=True,
                timeout=self._timeout)
        except (OSError, subprocess.TimeoutExpired) as e:
            logger.warning("host discovery script %s failed: %s",
                           self._script, e)
            return {}
        if out.returncode != 0:
            logger.warning("host discovery script %s exited %d: %s",
                           self._script, out.returncode,
                           out.stderr.strip()[:500])
            return {}
        hosts = {}
        for line in out.stdout.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                if ":" in line:
                    name, slots = line.rsplit(":", 1)
                    hosts[name.strip()] = int(slots)
                else:
                    hosts[line] = self._default_slots
            except ValueError:
                # malformed output is a flaky poll, never a driver crash
                # (same contract as a non-zero exit)
                logger.warning("host discovery script %s printed a "
                               "malformed line %r; ignoring this poll",
                               self._script, line)
                return {}
        return hosts


def _normalize_hosts(hosts):
    if isinstance(hosts, str):
        from horovod_tpu_torch.run.allocation import parse_hosts
        hosts = parse_hosts(hosts)
    if isinstance(hosts, dict):
        return dict(hosts)
    # list of HostSlots (or anything with .hostname/.slots)
    return {h.hostname: h.slots for h in hosts}


def diff_hosts(old, new):
    """Diff two ``{host: slots}`` views; returns ``(added, removed, res)``
    where a slot-count change on a surviving host counts as both (its
    workers must be renumbered either way)."""
    added = sorted(h for h in new
                   if h not in old or new[h] > old[h])
    removed = sorted(h for h in old
                     if h not in new or new[h] < old[h])
    res = HostUpdateResult.NO_UPDATE
    if added:
        res |= HostUpdateResult.ADDED
    if removed:
        res |= HostUpdateResult.REMOVED
    return added, removed, res


class HostDiscoveryPoller:
    """Background thread diffing consecutive discovery views (reference
    ``ElasticDriver._discover_hosts``): on any change, invokes
    ``on_update(added, removed, current, res)`` from the polling thread.

    The current view is always available via :meth:`current` (first read
    polls synchronously so callers never see an empty bootstrap view)."""

    def __init__(self, discovery, poll_interval=1.0, on_update=None):
        self._discovery = discovery
        self._interval = poll_interval
        self._on_update = on_update
        self._lock = threading.Lock()
        self._poll_lock = threading.Lock()
        self._current = None
        self._stop = threading.Event()
        self._thread = None

    def current(self):
        with self._lock:
            if self._current is not None:
                return dict(self._current)
        return self.poll_once()

    def poll_once(self):
        """One synchronous discovery round: update the view, fire the
        callback on change, return the new view.

        Serialized end-to-end: concurrent callers (the poll thread and
        the driver's min-np wait) must not interleave, or a slow caller
        could overwrite a newer view with its stale read and fire a
        phantom diff."""
        with self._poll_lock:
            new = self._discovery.find_available_hosts_and_slots()
            with self._lock:
                old, self._current = self._current, dict(new)
            if old is not None:
                added, removed, res = diff_hosts(old, new)
                if res != HostUpdateResult.NO_UPDATE and self._on_update:
                    try:
                        self._on_update(added, removed, dict(new), res)
                    except Exception:
                        logger.exception("host-update callback failed")
            return dict(new)

    def start(self):
        if self._thread is not None:
            return
        self.poll_once()  # establish the baseline before going async
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="hvd_torch_host_discovery",
                                        daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(self._interval):
            try:
                self.poll_once()
            except Exception:
                logger.exception("host discovery poll failed")

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
