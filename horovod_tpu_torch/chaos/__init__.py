"""horovod_tpu_torch.chaos — seeded fault injection against live hvdrun
jobs. The port of ``horovod_tpu/chaos/``.

The harness half of the preemption-native training story
(elastic/preempt.py): a :class:`ChaosPlan` is a
deterministic, seeded schedule of injections (SIGTERM / SIGKILL / stall
/ slow-disk) and a :class:`ChaosMonkey` applies it to the worker
processes of a running :class:`~horovod_tpu_torch.run.launcher.Job`.
``hvdrun --chaos=<spec>`` arms one for soak runs; tests drive the
injector with fake clocks and fake processes.
"""

from horovod_tpu_torch.chaos.injector import ChaosMonkey
from horovod_tpu_torch.chaos.plan import (KINDS, ChaosPlan, Injection,
                                    parse_spec)

__all__ = ["ChaosPlan", "ChaosMonkey", "Injection", "KINDS",
           "parse_spec"]
