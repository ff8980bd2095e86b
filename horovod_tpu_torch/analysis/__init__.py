"""hvd-lint for the port: the JAX package's project-native static
analysis (``horovod_tpu/analysis``, docs/ANALYSIS.md) over
``horovod_tpu_torch/`` and ``chip_smoke.py``. Pure standard library: it
imports neither torch nor JAX.

The passes: collectives under rank-dependent control flow
(HVD-DESYNC), host syncs inside functions that flow into the train step
or ``torch.compile`` (HVD-HOSTSYNC), lock-order cycles and locks held
across blocking calls (HVD-LOCKORDER), blocking signal handlers
(HVD-SIGSAFE), broad exception handlers (HVD-EXCEPT), raw process groups
and device meshes outside the mesh layer (HVD-MESH),
``init_process_group`` outside ``cluster.ensure_distributed``
(HVD-DISTINIT) and metric-name drift (HVD-METRIC).

Public surface::

    from horovod_tpu_torch.analysis import run_lint, default_targets
    result = run_lint(paths, baseline_path=...)   # LintResult
    result.clean
"""

from horovod_tpu_torch.analysis.engine import (  # noqa: F401
    Finding, LintError, LintResult, all_rules, default_targets,
    load_baseline, run_lint, write_baseline,
)
from horovod_tpu_torch.analysis import rules  # noqa: F401  (registers passes)
