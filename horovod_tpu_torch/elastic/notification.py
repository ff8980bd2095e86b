"""The worker notification plane: how the driver interrupts workers. The
port of ``horovod_tpu/elastic/notification.py``.

Each worker runs a small TCP service; when host membership changes, the
driver posts ``hosts_updated`` to every worker, and the worker raises
:class:`HostsUpdatedInterrupt` at the next batch boundary
(``State.commit()`` / ``check_host_updates()``), never inside a
collective.

The transport is the HMAC-framed JSON of ``run/discovery.py`` (``digest
|| u32 len || json``), the JAX package's wire format: a JAX client and a
port service (or the reverse) talk under one key. Never pickle.
"""

import logging
import socket
import socketserver
import threading

from horovod_tpu_torch.elastic.exceptions import HostsUpdatedInterrupt
from horovod_tpu_torch.run.discovery import recv_frame, send_frame

logger = logging.getLogger("horovod_tpu_torch")

# An unauthenticated single-host run still needs a key for the frame's
# MAC; a fixed local key keeps the framing uniform (the loopback bind is
# the isolation there, as with the launcher's key-value store). The JAX
# package's key, so that the two packages interoperate unauthenticated.
LOCAL_KEY = b"horovod-tpu-elastic-local"


class WorkerNotificationManager:
    """Worker-side mailbox between the notification service's thread and
    the training loop: the service records interrupts, the loop polls at
    commit boundaries."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending = None

    def handle_hosts_updated(self, res="updated"):
        with self._lock:
            self._pending = res

    def poll(self, clear=True):
        """The pending update's reason, or None; clears it by default."""
        with self._lock:
            res = self._pending
            if clear:
                self._pending = None
            return res

    def check(self):
        """Raise :class:`HostsUpdatedInterrupt` if an update is pending
        (``State.commit()`` calls it, between batches)."""
        res = self.poll()
        if res is not None:
            raise HostsUpdatedInterrupt(res)

    def reset(self):
        self.poll()


# The mailbox ``State`` objects check by default: a worker process has
# one training loop, so one manager a process.
notification_manager = WorkerNotificationManager()


class WorkerNotificationService:
    """The TCP endpoint of one worker that the driver posts interrupts
    to. Ops: ``hosts_updated`` (records the interrupt) and ``ping``
    (liveness; answers with the service's name). Frames with a bad
    digest and unknown ops are dropped."""

    def __init__(self, key=None, manager=None, host="0.0.0.0", port=0):
        self._key = key or LOCAL_KEY
        self.manager = manager if manager is not None else \
            notification_manager
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                req = recv_frame(self.request, outer._key)
                if req is None:
                    return  # a bad digest or garbage
                op = req.get("op")
                if op == "hosts_updated":
                    outer.manager.handle_hosts_updated(
                        req.get("res", "updated"))
                    send_frame(self.request, outer._key, {"ok": True})
                elif op == "ping":
                    send_frame(self.request, outer._key,
                               {"service": "worker-notification"})

        self._server = socketserver.ThreadingTCPServer((host, port),
                                                       _Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="hvd_torch_worker_notif",
                                        daemon=True)
        self._thread.start()

    @property
    def port(self):
        return self._server.socket.getsockname()[1]

    def shutdown(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join()


class WorkerNotificationClient:
    """The driver's handle on one worker's notification service."""

    def __init__(self, addr, port, key=None, timeout=3.0):
        self._target = (addr, port)
        self._key = key or LOCAL_KEY
        self._timeout = timeout

    def _call(self, obj):
        with socket.create_connection(self._target,
                                      timeout=self._timeout) as sock:
            send_frame(sock, self._key, obj)
            return recv_frame(sock, self._key)

    def notify_hosts_updated(self, res="updated"):
        resp = self._call({"op": "hosts_updated", "res": res})
        return bool(resp and resp.get("ok"))

    def ping(self):
        resp = self._call({"op": "ping"})
        return bool(resp and resp.get("service") == "worker-notification")
