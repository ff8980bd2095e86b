"""The entry point of one cluster executor slot, started by
``cluster.LocalProcessBackend``: the port of
``horovod_tpu/run/cluster_task.py``. It registers, probes, takes its
rank assignment and runs the shipped function (``cluster.cluster_task``;
the Spark backend calls that in its partitions instead).

Usage: python -m horovod_tpu_torch.run.cluster_task <index> <n> <kv_addr> <kv_port>
The run's key arrives in HOROVOD_SECRET_KEY.
"""

import os
import sys

from horovod_tpu_torch.run import secret as _secret
from horovod_tpu_torch.run.cluster import cluster_task


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 4:
        print("usage: cluster_task <index> <num_tasks> <kv_addr> <kv_port>",
              file=sys.stderr)
        return 1
    key_hex = os.environ.get(_secret.SECRET_ENV)
    if not key_hex:
        print("cluster_task: HOROVOD_SECRET_KEY not set", file=sys.stderr)
        return 1
    ctx = {"kv_addr": argv[2], "kv_port": int(argv[3]), "key": key_hex}
    cluster_task(int(argv[0]), int(argv[1]), ctx)
    return 0


if __name__ == "__main__":
    sys.exit(main())
