"""The serve fleet: N engine replicas behind one routing frontend. The
port of ``horovod_tpu/serve/fleet/``.

* **replica** (``replica.py``) — one named engine plus its lifecycle
  state (``ready`` / ``draining`` / ``dead``) and its armed preemption
  handler — the ``elastic/preempt.py`` machinery (notice polling, grace
  budget, ``hvd_preemptions_total``) pointed at traffic drain instead of
  checkpoint commit;
* **router** (``router.py``) — queue-depth- and KV-headroom-aware
  dispatch over the ready replicas, fleet-wide rolling weight reload
  (one replica staged at a time), and the zero-drop eviction path: a
  request cut off by a dying replica is re-dispatched to a survivor as a
  continuation, which the position-keyed sampling of
  ``serve/sampling.py`` and the engine's replay make stream-transparent;
* **frontend** (``frontend.py``) — the one streaming HTTP endpoint in
  front of the fleet, the single-replica ``serve/server.py``'s wire
  protocol plus a fleet-shaped ``/healthz``.

Replicas are in-process, each engine on its own device (several may
share one card); everything the router consumes (health state, queue
depth, KV headroom, weights version) is what the per-replica
``/healthz`` reports.
"""

from horovod_tpu_torch.serve.fleet.frontend import FleetServer  # noqa: F401
from horovod_tpu_torch.serve.fleet.replica import Replica  # noqa: F401
from horovod_tpu_torch.serve.fleet.router import (  # noqa: F401
    FleetRequest,
    FleetRouter,
)

__all__ = ["Replica", "FleetRouter", "FleetRequest", "FleetServer"]
