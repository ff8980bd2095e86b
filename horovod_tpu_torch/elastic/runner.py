"""The elastic retry loop, ``@hvd.elastic.run``: the port of
``horovod_tpu/elastic/runner.py`` (Horovod's
``horovod/common/elastic.py`` ``run_fn``). It wraps a training function
that takes a :class:`~horovod_tpu_torch.elastic.state.State` first, and
implements the recovery policy:

* ``HostsUpdatedInterrupt`` (membership changed, raised at a commit
  boundary): the committed progress is KEPT. A worker of a driver's
  epoch (``HOROVOD_ELASTIC_EPOCH`` set) exits with ``EXIT_RENDEZVOUS``,
  so that the driver relaunches it into the new world; in process the
  loop re-syncs and retries.
* worker failures (``WorkerFailureError`` and whatever ``retryable=``
  adds, such as the ``RuntimeError`` a collective against a dead peer
  raises): the last committed state is restored, the half-applied batch
  discarded, then the loop re-syncs and retries, up to
  ``HOROVOD_ELASTIC_RESET_LIMIT`` resets (0: no limit).

The time after the first attempt (reset, restore, re-sync) is booked to
the goodput ledger's ``rendezvous_recovery`` under a ``re-rendezvous``
bracket, which also flips ``/healthz`` to 503 while the rank is parked
there.
"""

import contextlib
import functools
import logging
import os
import sys

from horovod_tpu_torch.elastic.exceptions import (HostsUpdatedInterrupt,
                                                  WorkerFailureError)

logger = logging.getLogger("horovod_tpu_torch")


def _driver_managed():
    """True when an ElasticDriver's epoch launched this process (then a
    re-rendezvous is an exit and a relaunch, not a retry in place)."""
    return "HOROVOD_ELASTIC_EPOCH" in os.environ


def run(func=None, *, retryable=()):
    """Decorate ``func(state, *args, **kwargs)`` with the elastic retry
    loop. ``retryable`` extends the set of worker-failure exceptions."""
    if func is None:
        return functools.partial(run, retryable=retryable)
    failure_excs = (WorkerFailureError,) + tuple(retryable)

    @functools.wraps(func)
    def wrapper(state, *args, **kwargs):
        from horovod_tpu_torch.elastic import preempt as _preempt
        from horovod_tpu_torch.elastic.driver import EXIT_RENDEZVOUS
        from horovod_tpu_torch.telemetry import ledger as ledger_lib
        # an armed eviction handler (runtime/services.py) force-commits
        # this state's in-flight save inside the grace window
        _preempt.attach_state(state)
        reset_limit = int(os.environ.get("HOROVOD_ELASTIC_RESET_LIMIT",
                                         "0") or 0)
        resets = 0
        first = True

        def _recovery_bracket(in_recovery):
            if not in_recovery:
                return contextlib.nullcontext()
            return ledger_lib.get_ledger().phase(
                "re-rendezvous", charge="rendezvous_recovery")

        while True:
            if not first:
                with _recovery_bracket(True):
                    state.on_reset()
            try:
                with _recovery_bracket(not first):
                    state.sync()
                return func(state, *args, **kwargs)
            except HostsUpdatedInterrupt as e:
                # the progress is committed; only the world is rebuilt
                if _driver_managed():
                    logger.info("elastic: hosts %s; draining for "
                                "re-rendezvous", e.res)
                    sys.exit(EXIT_RENDEZVOUS)
                logger.info("elastic: hosts %s; re-syncing in process",
                            e.res)
                first = False
            except failure_excs as e:
                resets += 1
                if reset_limit and resets > reset_limit:
                    raise WorkerFailureError(
                        f"elastic: giving up after {resets - 1} resets "
                        f"(HOROVOD_ELASTIC_RESET_LIMIT="
                        f"{reset_limit})") from e
                logger.warning("elastic: worker failure (%s); restoring "
                               "the last commit (reset %d)", e, resets)
                with _recovery_bracket(True):
                    state.restore()
                first = False

    return wrapper
