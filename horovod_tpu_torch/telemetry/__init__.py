"""Unified telemetry plane: metrics registry, Prometheus endpoint,
goodput ledger, cross-rank trace merge, on-demand device profiling.

The port of ``horovod_tpu/telemetry/``: one rank-local registry
(``registry.py``) fed by the steps, collectives, bucket exchange, loader
and checkpointer through the instruments of ``instruments.py``, exposed
by the ``/metrics``, ``/healthz``, ``/flightrec`` and ``/profile`` HTTP
plane (``server.py``); the goodput ledger (``ledger.py``) and its
end-of-run report (``report.py``); the per-rank host timeline's merge
(``merge.py``); and the step X-ray over ``torch.profiler`` captures
(``xprof.py``). Metric names, ledger phases, X-ray categories, dump file
names and JSON schemas are the JAX package's, so one dashboard, one
report and one doctor read both packages' runs.
"""

from horovod_tpu_torch.telemetry import instruments  # noqa: F401
from horovod_tpu_torch.telemetry import ledger  # noqa: F401
from horovod_tpu_torch.telemetry import report  # noqa: F401
from horovod_tpu_torch.telemetry.instruments import (  # noqa: F401
    DataInstruments,
    StepInstruments,
    build_info_gauge,
    data_instruments,
    enabled,
    install_compile_listeners,
    record_bucket,
    record_collective,
)
from horovod_tpu_torch.telemetry.ledger import (  # noqa: F401
    TimeLedger,
    get_ledger,
)
from horovod_tpu_torch.telemetry.merge import (  # noqa: F401
    load_events,
    merge_traces,
)
from horovod_tpu_torch.telemetry.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
)
from horovod_tpu_torch.telemetry.server import MetricsServer  # noqa: F401

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "get_registry",
    "MetricsServer", "StepInstruments", "DataInstruments",
    "data_instruments", "enabled", "build_info_gauge",
    "install_compile_listeners", "record_collective", "record_bucket",
    "load_events", "merge_traces", "instruments", "ledger", "report",
    "TimeLedger", "get_ledger",
]
