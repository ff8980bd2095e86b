"""hvdrun, the port's process launcher: the port of ``horovod_tpu/run``.

It starts one training process per slot across hosts with the
``HOROVOD_RANK/SIZE/LOCAL_RANK/...`` env contract and an HTTP key-value
store through which the workers' ``init()`` finds its TCP store; plain
subprocess and ssh, no MPI. The contract and the store are the JAX
package's, so it also launches that package's workers.

Entry points:
* CLI: ``python -m horovod_tpu_torch.run -np 4 python train.py`` (the
  ``hvdrun-torch`` console script);
* programmatic: ``horovod_tpu_torch.run.run(fn, args=(), np=4)``.
"""

from horovod_tpu_torch.run.run import main, parse_args
# after the submodule ``run.run``, so that the name ``run`` is the function
from horovod_tpu_torch.run.api import run

__all__ = ["run", "main", "parse_args"]
