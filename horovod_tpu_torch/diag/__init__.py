"""Black-box crash forensics: flight recorder + collective desync doctor.

The port of ``horovod_tpu/diag/``: the recorder (``recorder.py``), the
rolling schedule digest (``desync.py``), the hang doctor
(``doctor.py``, with its ``perf`` and ``xray`` routes) and the X-ray
report (``xray.py``). Dumps, digests and reports keep the JAX package's
file names and JSON schemas, so either package's doctor reads either
package's dumps.

Hot-path discipline: recording is a bounded deque append plus a CRC
update — no I/O, no locks, and nothing on the card.
"""

from horovod_tpu_torch.diag.recorder import (FlightRecorder,
                                             config_fingerprint, dump_now,
                                             get_recorder, install,
                                             uninstall)
from horovod_tpu_torch.diag import desync

# NOTE: doctor is deliberately NOT imported here: `python -m
# horovod_tpu_torch.diag.doctor` must not find the module pre-imported by
# its own package (runpy RuntimeWarning); import it as
# `from horovod_tpu_torch.diag import doctor`.

__all__ = ["FlightRecorder", "config_fingerprint", "dump_now",
           "get_recorder", "install", "uninstall", "desync"]
