"""The worker side of an elastic job: its notification endpoint and its
heartbeats. The port of ``horovod_tpu/elastic/worker.py``; the
heartbeat is the producer half of the driver's cluster view.

* It starts a :class:`~horovod_tpu_torch.elastic.notification.
  WorkerNotificationService` and publishes its endpoint on the
  launcher's key-value store (``elastic/notif/<epoch>/<rank>``), so the
  driver can interrupt this worker between batches;
* it publishes a heartbeat a step (``elastic/heartbeat/<epoch>/<rank>``),
  fed by ``runtime/stall.py``'s progress hooks: the step
  (``StepState.step``), the time, the metrics snapshot of
  ``telemetry.instruments.kv_snapshot`` and the flight recorder's digest
  (``diag.recorder.current_digest``), which the driver's
  ``cluster_view`` reads and cross-checks (``diag.desync.cross_check``).

Workers launched by the elastic driver get ``HOROVOD_ELASTIC=1`` and
``HOROVOD_ELASTIC_EPOCH``; ``init_worker_context()`` reads the rest of
the launcher's contract (rank, the store's address, the secret key).
"""

import json
import logging
import os
import socket
import time

from horovod_tpu_torch.elastic import notification
from horovod_tpu_torch.run import secret as _secret
from horovod_tpu_torch.run.rendezvous import kv_put

logger = logging.getLogger("horovod_tpu_torch")

_context = None


def is_elastic_worker(env=None):
    return (env or os.environ).get("HOROVOD_ELASTIC") == "1"


class WorkerContext:
    """One elastic worker's attachments to the control plane."""

    def __init__(self, rank=None, epoch=None, kv_addr=None, kv_port=None,
                 auth_key=None):
        env = os.environ
        self.rank = rank if rank is not None else int(
            env.get("HOROVOD_RANK", "0"))
        self.epoch = epoch if epoch is not None else int(
            env.get("HOROVOD_ELASTIC_EPOCH", "0"))
        self._kv_addr = kv_addr or env.get("HOROVOD_GLOO_RENDEZVOUS_ADDR")
        self._kv_port = int(kv_port or
                            env.get("HOROVOD_GLOO_RENDEZVOUS_PORT", "0"))
        self._key = auth_key if auth_key is not None else \
            _secret.key_from_env()
        self.attached_to_inspector = False
        self.manager = notification.notification_manager
        # without a per-run key (a job on this host) the fixed LOCAL_KEY
        # keeps no secret, so the loopback bind is the isolation; only
        # an authenticated job across hosts listens on the network
        self.service = notification.WorkerNotificationService(
            key=self._key, manager=self.manager,
            host="0.0.0.0" if self._key else "127.0.0.1")
        self._publish_endpoint()
        try:
            from horovod_tpu_torch.diag import recorder as _flightrec
            _flightrec.record_event("epoch", epoch=self.epoch)
        except Exception:  # forensics never break the epoch's set-up
            pass

    def _advertised_addr(self):
        """An address the driver can dial: this host's address, or
        loopback when it does not resolve or the job is on this host."""
        if not self._key:
            return "127.0.0.1"  # the loopback-only bind above
        try:
            return socket.gethostbyname(socket.gethostname())
        except OSError:
            return "127.0.0.1"

    def _kv_ready(self):
        return bool(self._kv_addr) and self._kv_port > 0

    def _publish_endpoint(self):
        if not self._kv_ready():
            logger.debug("elastic: no rendezvous store; the notification "
                         "endpoint is not published")
            return
        payload = {"addr": self._advertised_addr(),
                   "port": self.service.port}
        kv_put(self._kv_addr, self._kv_port,
               f"elastic/notif/{self.epoch}/{self.rank}",
               json.dumps(payload).encode(), auth_key=self._key)

    def report_progress(self, step=None):
        """Publish a heartbeat. ``attach_progress_reporter`` makes it a
        listener of ``StallInspector.record_progress``, so each completed
        step refreshes the driver's liveness view. The heartbeat carries
        the metrics snapshot and the flight recorder's digest (module
        docstring); neither may break the liveness channel."""
        if not self._kv_ready():
            return
        payload = {"step": step, "time": time.time()}
        try:
            from horovod_tpu_torch.telemetry import instruments as _tele
            metrics = _tele.kv_snapshot()
            if metrics:
                payload["metrics"] = metrics
        except Exception:
            pass
        try:
            from horovod_tpu_torch.diag import recorder as _flightrec
            _flightrec.record_event("heartbeat", step=step)
            digest = _flightrec.current_digest()
            if digest:
                # seq and schedule hash (and a short history): the
                # driver names a diverged or stuck rank while it hangs
                payload["flightrec"] = digest
        except Exception:
            pass
        try:
            kv_put(self._kv_addr, self._kv_port,
                   f"elastic/heartbeat/{self.epoch}/{self.rank}",
                   json.dumps(payload).encode(), auth_key=self._key)
        except OSError:
            pass  # the store going away must never kill a step

    def shutdown(self):
        self.service.shutdown()


def init_worker_context(**kwargs):
    """Create (once) and return this process's :class:`WorkerContext`."""
    global _context
    if _context is None:
        _context = WorkerContext(**kwargs)
    return _context


def get_worker_context():
    return _context


def shutdown_worker_context():
    global _context
    if _context is not None:
        _context.shutdown()
        _context = None


def attach_progress_reporter(inspector, context=None):
    """Register the heartbeat publisher as a progress listener of a
    ``runtime.stall.StallInspector``: the inspector's progress hooks feed
    the driver's liveness view."""
    ctx = context or init_worker_context()
    inspector.add_progress_listener(ctx.report_progress)
    ctx.attached_to_inspector = True
    return ctx
