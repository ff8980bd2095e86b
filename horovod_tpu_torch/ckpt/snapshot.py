"""Snapshot-offload: the training thread pays for the copy, not the write.

The port of ``horovod_tpu/ckpt/snapshot.py``'s :class:`AsyncCheckpointer`:
a save is a synchronous host snapshot (``sharded.snapshot_payload``) and
a background serialize, CRC, fsync and two-phase commit
(``sharded.write_shard`` + ``manifest.commit``), under a bounded number
of saves in flight.

torch updates parameters and optimizer state in place, so ``save()``
returns only once its copy is final: the card's tensors are copied into
pinned host buffers and the copy's event is waited for before it
returns; an ``optimizer.step()`` right after it cannot reach the
snapshot. The pinned buffers are made by the first save and reused by
the later ones (``sharded.Staging``): one set for each save that may be
in flight. The background thread never touches the collective plane: the
commit barrier is the shared filesystem's ``.ok`` markers.

The JAX package's telemetry counters and flight-recorder events of a
save are not ported (they come with the telemetry plane);
``last_blocking_s`` (of which ``last_pin_s`` made buffers,
``last_gather_s`` gathered a tensor- or expert-parallel state's cut leaves
and ``last_copy_s`` copied into the buffers), ``last_save_s`` and
``last_bytes`` record the latest save's times and size instead.
"""

import atexit
import logging
import os
import queue
import threading
import time

from horovod_tpu_torch.ckpt import manifest as manifest_lib
from horovod_tpu_torch.ckpt import sharded

logger = logging.getLogger("horovod_tpu_torch")

snapshot_tree = sharded.snapshot_payload  # the synchronous half

DEFAULT_KEEP = 5


def _env_rank_world():
    from horovod_tpu_torch import basics
    if basics.is_initialized():
        return basics.rank(), basics.size()
    return (int(os.environ.get("HOROVOD_RANK", "0")),
            int(os.environ.get("HOROVOD_SIZE", "1")))


class AsyncCheckpointer:
    """Bounded-budget async sharded checkpoint writer for one rank.

    ``max_inflight`` caps queued-but-uncommitted saves: when the budget
    is spent, ``save()`` blocks until the oldest save commits, and the
    wait counts in its blocking time. ``keep`` is the retention depth
    (complete checkpoints, enforced by rank 0 at each commit)."""

    def __init__(self, directory, keep=DEFAULT_KEEP, max_inflight=1,
                 rank=None, world=None, barrier_timeout=None):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got "
                             f"{max_inflight}")
        if barrier_timeout is None:
            barrier_timeout = float(
                os.environ.get("HOROVOD_CKPT_TIMEOUT", "120"))
        env_rank, env_world = _env_rank_world()
        self.directory = directory
        self.keep = keep
        self.rank = env_rank if rank is None else int(rank)
        self.world = env_world if world is None else int(world)
        self.barrier_timeout = barrier_timeout
        self.max_inflight = max_inflight
        # host buffers: one set for each save in flight, reused after it
        self._staging = [sharded.Staging() for _ in range(max_inflight)]
        self._queue = queue.Queue()
        self._inflight = 0
        self._lock = threading.Condition()
        self._error = None
        self._thread = None
        self._closed = False
        self._abandoned = False
        self.last_manifest = None
        self.last_blocking_s = None  # the training thread's stall
        self.last_pin_s = None       # of it: making host buffers
        self.last_gather_s = None    # of it: gathering cut leaves
        self.last_copy_s = None      # of it: copying into them
        self.last_save_s = None      # save() entry to commit
        self.last_bytes = None       # this rank's shard
        atexit.register(self.close)

    # -- the training-thread half ------------------------------------------
    def save(self, step, tree, meta=None, block=False):
        """Snapshot ``tree`` now; persist + commit in the background.
        Returns the seconds training was blocked. ``block=True`` also
        waits for this save's commit."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        self._reraise()
        t0 = time.perf_counter()
        with self._lock:
            while self._inflight >= self.max_inflight and not self._error:
                self._lock.wait(0.005)
            self._reraise()
            self._inflight += 1
            staging = self._staging.pop()
        try:
            # a re-save of a step whose earlier attempt was torn, or whose
            # damaged manifest a fallback restore skipped: clear the old
            # manifest and this rank's stale ack here, before new bytes
            manifest_lib.clear_stale_ack(self.directory, step, self.rank,
                                         self.world)
            payload, zero_info = sharded.snapshot_payload(
                tree, self.rank, self.world, staging)
        except BaseException:
            # no job was queued: give the budget slot back
            self._release(staging)
            raise
        blocking = time.perf_counter() - t0
        self.last_blocking_s = blocking
        self.last_pin_s, self.last_copy_s = staging.pin_s, staging.copy_s
        self.last_gather_s = staging.gather_s
        self._ensure_thread()
        self._queue.put((int(step), payload, zero_info, meta, t0, staging))
        if block:
            self.flush()
        return blocking

    def flush(self, timeout=None):
        """Block until every queued save has committed; re-raise the
        first background failure. Returns the last manifest."""
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        with self._lock:
            while self._inflight > 0 and self._error is None:
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"ckpt flush: {self._inflight} save(s) still in "
                        f"flight after {timeout:.0f}s")
                self._lock.wait(0.01)
        self._reraise()
        return self.last_manifest

    def close(self, timeout=None):
        """Flush (best effort) and stop the background thread."""
        if self._closed:
            return
        try:
            self.flush(timeout=timeout)
        except Exception as e:  # noqa: BLE001 - the exit path must not throw
            logger.warning("ckpt: close() dropping failed save: %s", e)
        self._closed = True
        atexit.unregister(self.close)
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join(timeout=5.0)
            self._thread = None

    def abandon(self):
        """Stop without waiting for saves in flight (membership broke, so
        the commit barrier may never complete): queued saves are
        dropped, a save already mid-write drains under its own barrier
        timeout. The torn step stays invisible to restore."""
        self._abandoned = True
        self._closed = True
        atexit.unregister(self.close)
        self._queue.put(None)

    # -- the background half -----------------------------------------------
    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._worker, name="hvd-ckpt-writer", daemon=True)
            self._thread.start()

    def _worker(self):
        while True:
            job = self._queue.get()
            if job is None:
                return
            step, payload, zero_info, meta, t0, staging = job
            try:
                if self._abandoned:
                    continue
                info = sharded.write_shard(self.directory, step, payload)
                man = manifest_lib.commit(
                    self.directory, step, self.rank, self.world, meta=meta,
                    zero_info=zero_info, keep=self.keep,
                    timeout=self.barrier_timeout)
                self.last_manifest = man
                self.last_save_s = time.perf_counter() - t0
                self.last_bytes = info["bytes"]
                logger.debug("ckpt: committed step %d (%d bytes, %.1f ms "
                             "end to end)", step, info["bytes"],
                             self.last_save_s * 1e3)
            except Exception as e:  # noqa: BLE001 - surfaced by flush()
                logger.error("ckpt: background save of step %s failed: %s",
                             step, e)
                with self._lock:
                    if self._error is None:
                        self._error = e
            finally:
                self._release(staging)

    def _release(self, staging):
        """End a save: its staging set and its budget slot are free."""
        with self._lock:
            self._staging.append(staging)
            self._inflight -= 1
            self._lock.notify_all()

    def _reraise(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(
                f"ckpt: a background checkpoint save failed: {e}") from e
