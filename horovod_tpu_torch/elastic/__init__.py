"""horovod_tpu_torch.elastic: fault-tolerant, membership-elastic
training. The port of ``horovod_tpu/elastic/``, Horovod's post-0.20
``horovod.elastic``, over ``torch.distributed``:

* **discovery**: ``HostDiscovery`` / ``FixedHosts`` / ``ScriptDiscovery``
  and a polling thread diffing host sets;
* **state**: ``State`` / ``ObjectState`` / ``TorchState`` (a model, its
  ``DistributedOptimizer`` and its ``StepState``) with ``commit()`` /
  ``restore()`` / ``sync()`` (a broadcast from the lowest committed
  rank; disk commits through ``ckpt``, on the JAX package's format);
* **driver**: ``ElasticDriver`` and ``Blacklist``: a rendezvous an epoch
  over ``run/allocation.py``, blame with exponential backoff, the
  cluster view of the workers' heartbeats;
* **notification**: the driver-to-worker interrupt plane (HMAC-framed
  TCP, the wire format of ``run/discovery.py``);
* **runner**: the ``@hvd.elastic.run`` retry loop;
* **preempt**: graceful eviction (``GracefulEvictionHandler``): SIGTERM
  or a spot notice, a bounded force-commit, the doomed host announced,
  a clean exit.

A worker::

    import horovod_tpu_torch as hvd

    hvd.init()
    step = hvd.training.make_lm_train_step(model, opt)
    state = hvd.elastic.TorchState(model, opt, step.state,
                                   directory=ckpt_dir)

    @hvd.elastic.run
    def train(state):
        while state.step_state.step < num_steps:
            step(batch(state.step_state.step))
            state.commit()

    train(state)

(``training.elastic_train_loop`` is that loop, with a loader's cursor,
the final commit forced to disk and error feedback reset after a
rollback.)
"""

from horovod_tpu_torch.elastic import preempt
from horovod_tpu_torch.elastic.discovery import (FixedHosts, HostDiscovery,
                                                 HostDiscoveryPoller,
                                                 HostUpdateResult,
                                                 ScriptDiscovery,
                                                 diff_hosts)
from horovod_tpu_torch.elastic.driver import (EXIT_RENDEZVOUS, Blacklist,
                                              ElasticDriver)
from horovod_tpu_torch.elastic.exceptions import (HorovodInternalError,
                                                  HostsUpdatedInterrupt,
                                                  WorkerFailureError)
from horovod_tpu_torch.elastic.notification import (
    WorkerNotificationClient, WorkerNotificationManager,
    WorkerNotificationService, notification_manager)
from horovod_tpu_torch.elastic.preempt import GracefulEvictionHandler
from horovod_tpu_torch.elastic.runner import run
from horovod_tpu_torch.elastic.state import ObjectState, State, TorchState
from horovod_tpu_torch.elastic.worker import (WorkerContext,
                                              attach_progress_reporter,
                                              get_worker_context,
                                              init_worker_context,
                                              is_elastic_worker,
                                              shutdown_worker_context)

__all__ = [
    "HostDiscovery", "FixedHosts", "ScriptDiscovery",
    "HostDiscoveryPoller", "HostUpdateResult", "diff_hosts",
    "State", "ObjectState", "TorchState",
    "HostsUpdatedInterrupt", "WorkerFailureError", "HorovodInternalError",
    "ElasticDriver", "Blacklist", "EXIT_RENDEZVOUS",
    "WorkerNotificationManager", "WorkerNotificationService",
    "WorkerNotificationClient", "notification_manager",
    "WorkerContext", "init_worker_context", "get_worker_context",
    "shutdown_worker_context", "attach_progress_reporter",
    "is_elastic_worker",
    "run",
    "preempt", "GracefulEvictionHandler",
]
