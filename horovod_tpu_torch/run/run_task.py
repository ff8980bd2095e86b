"""The worker of ``run(fn)``: fetch the pickled function from the
launcher's key-value store, run it under the env contract, publish the
result. The port of ``horovod_tpu/run/run_task.py``.

Without ``cloudpickle`` the function travels by reference, so it must live
in a module the worker can import (the checkout is on its PYTHONPATH).
"""

import os
import pickle
import sys

from horovod_tpu_torch.run.rendezvous import kv_put, kv_wait
from horovod_tpu_torch.run.task_exec import exec_and_publish


def main():
    addr = os.environ["HOROVOD_GLOO_RENDEZVOUS_ADDR"]
    port = int(os.environ["HOROVOD_GLOO_RENDEZVOUS_PORT"])
    rank = int(os.environ["HOROVOD_RANK"])
    # plain pickle loads cloudpickle's payloads when cloudpickle imports
    fn, args, kwargs = pickle.loads(
        kv_wait(addr, port, "runfunc/func", timeout=60))
    ok = exec_and_publish(
        fn, args, kwargs,
        lambda payload: kv_put(addr, port, f"runfunc/result/{rank}",
                               payload))
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
