"""One fleet replica: a named engine, its state, its preemption arm. The
port of ``horovod_tpu/serve/fleet/replica.py``.

The replica is the unit of capacity AND the unit of failure: spot
preemption, chaos eviction, and rolling weight staging all happen to
one replica while the rest of the fleet keeps admitting. State
transitions are one-way in the failure direction (``ready`` →
``draining`` → ``dead``) except staging, which drains briefly and
returns to ready.

Spot capacity reuses ``elastic/preempt.py`` wholesale: the replica
arms a :class:`~horovod_tpu_torch.elastic.preempt.GracefulEvictionHandler`
whose *bounded force-commit* is the traffic drain (the handler calls
``state.flush(timeout=grace)``; here the "state" being committed is
the replica's in-flight requests) and whose *exit* is the router's
eviction callback instead of ``os._exit``. Notice sources (the
per-replica spot notice file / URL), the grace budget, the doomed-host
announce, ``hvd_preemptions_total{kind}`` and
``hvd_grace_commit_seconds`` all come along unchanged — one eviction
machinery for the training and serving planes.
"""

import logging
import time

from horovod_tpu_torch.elastic import preempt as preempt_lib

logger = logging.getLogger("horovod_tpu_torch")

READY = "ready"
DRAINING = "draining"
DEAD = "dead"
STATES = (READY, DRAINING, DEAD)


class _DrainAsState:
    """Adapter: the eviction handler force-commits whatever its
    ``state.flush(timeout=...)`` does — for a serving replica that is
    "drain my in-flight traffic within the grace budget"."""

    def __init__(self, drain_fn):
        self._drain = drain_fn

    def flush(self, timeout=None):
        self._drain(timeout)


class Replica:
    """One engine in the fleet. The router owns the state machine;
    this class owns the engine handle and the preempt arm."""

    def __init__(self, name, engine, clock=time.monotonic):
        self.name = str(name)
        self.engine = engine
        self.state = READY
        self.stopped_at = None  # clock() when the engine was stopped
        # clock() when the last drain (preempt, chaos, weight staging)
        # began — the start of the window request traces overlap and
        # hvd_serve_weight_swap_seconds measures for a rolling reload
        self.drain_started_at = None
        self._clock = clock
        self._handler = None

    # -- dispatch inputs -----------------------------------------------------
    @property
    def load(self):
        """Queued + running requests — the queue-depth half of the
        router's dispatch score."""
        return self.engine.queue_depth + self.engine.active_count

    def headroom_for(self, need_blocks):
        """True when the replica could cover a ``need_blocks`` KV
        reservation: free blocks plus the prefix cache's RECLAIMABLE
        claim (engine admission releases cache LRU under pressure).
        Only sole-reference cache entries count — an entry a live
        sequence also maps frees no pool block when released, so
        counting it would score headroom the replica doesn't have."""
        reclaimable = (self.engine.prefix_cache.reclaimable()
                       if self.engine.prefix_cache is not None else 0)
        return (self.engine.allocator.available + reclaimable
                >= need_blocks)

    def health(self):
        """The per-replica ``/healthz`` shape (serve/server.py), as the
        fleet frontend aggregates it."""
        eng = self.engine
        return {
            "state": self.state,
            "queue_depth": eng.queue_depth,
            "active": eng.active_count,
            "kv_blocks_in_use": eng.allocator.in_use,
            "kv_blocks_free": eng.allocator.available,
            "prefix_cache_blocks": (eng.prefix_cache.size
                                    if eng.prefix_cache is not None
                                    else 0),
            "weights_version": eng.weights_version,
            "drain_started_at": self.drain_started_at,
        }

    # -- spot preemption -----------------------------------------------------
    def arm_preempt(self, on_drain, on_evict, notice_file=None,
                    notice_url=None, grace=None, poll_interval=None,
                    env=None):
        """Arm the graceful-eviction machinery for this replica.
        ``on_drain(timeout)`` runs inside the grace window (the
        router's traffic drain); ``on_evict()`` replaces process exit.
        With a notice source the handler's poller watches it; without
        one the handler is trigger-only (the router's ``preempt()``
        and the chaos harness drive it)."""
        if self._handler is not None:
            return self._handler
        self._handler = preempt_lib.GracefulEvictionHandler(
            state=_DrainAsState(on_drain),
            grace=grace, notice_file=notice_file, notice_url=notice_url,
            poll_interval=poll_interval, clock=self._clock,
            exit_fn=lambda code: on_evict(), env=env)
        if notice_file or notice_url:
            self._handler.install()
        return self._handler

    def trigger_preempt(self, kind="notice:router"):
        """Start this replica's eviction (idempotent). Returns the
        eviction thread, or None when none is armed / already run."""
        if self._handler is None:
            return None
        return self._handler.trigger(kind)

    def disarm(self):
        if self._handler is not None:
            self._handler.uninstall()
            self._handler = None
