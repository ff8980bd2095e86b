"""Elastic control-flow exceptions: the port of
``horovod_tpu/elastic/exceptions.py``.

``HorovodInternalError`` (a collective or a peer failed; the committed
state must be restored) and ``HostsUpdatedInterrupt`` (membership
changed; the state is still good, the job only re-rendezvouses). A
failure rolls the model back to the last ``commit()``, an update does
not.
"""


class HostsUpdatedInterrupt(Exception):
    """Raised between batches (at ``State.commit()``) when the driver has
    signalled a host-membership change. The training state is NOT rolled
    back; the elastic loop re-syncs and continues under the new world.

    ``res`` records what changed ("added" / "removed" / "updated")."""

    def __init__(self, res="updated"):
        super().__init__(res)
        self.res = res


class WorkerFailureError(RuntimeError):
    """A peer worker (or a collective against it) failed mid-batch. The
    elastic loop restores the last committed state before retrying: the
    updates of the failed batch must not survive."""


# Horovod's name (``horovod.common.exceptions``).
HorovodInternalError = WorkerFailureError
