"""The per-host discovery task that hvdrun starts before a multi-host
job: the port of ``horovod_tpu/run/task_fn.py``. It registers the host's
candidate addresses, ring-probes its successor with interface matching
(``discovery.py``) and waits for the driver's verdict, so that its ping
server stays up for a predecessor still probing.

Usage (started by ``run.py``)::

    python -m horovod_tpu_torch.run.task_fn <index> <num_hosts> <kv_addr> <kv_port> [timeout_s]

The run's key arrives in ``HOROVOD_SECRET_KEY``.
"""

import sys

from horovod_tpu_torch.run import secret as _secret
from horovod_tpu_torch.run.discovery import TaskAgent


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) not in (4, 5):
        print("usage: task_fn <index> <num_hosts> <kv_addr> <kv_port> "
              "[timeout_s]", file=sys.stderr)
        return 1
    index, num_hosts = int(argv[0]), int(argv[1])
    kv_addr, kv_port = argv[2], int(argv[3])
    timeout = float(argv[4]) if len(argv) == 5 else 600.0
    key = _secret.key_from_env()
    if key is None:
        print("task_fn: HOROVOD_SECRET_KEY not set", file=sys.stderr)
        return 1
    agent = TaskAgent(index, num_hosts, kv_addr, kv_port, key)
    try:
        agent.register()
        agent.run_ring_probe(timeout=timeout)
        agent.common_interfaces(timeout=timeout)
    finally:
        agent.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
