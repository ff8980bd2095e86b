"""The serving plane: continuous-batching inference straight from sharded
checkpoints. The port of ``horovod_tpu/serve/``, module for module.

* **weights** (``loader.py``) — a ``ckpt/`` MANIFEST (either package's)
  loads params-only (ZeRO rows skipped), and a :class:`ReloadWatcher`
  rolls newer checkpoints into the live engine without dropping traffic;
* **memory** (``kvcache.py``) — a paged KV pool on the device (fixed-size
  blocks, per-sequence block tables, a host-side ref-counted allocator
  and prefix cache);
* **compute** (``engine.py``) — iteration-level continuous batching over
  two static-shaped programs (chunked prefill + batched decode) on one
  device, per-request token streams;
* **frontend** (``server.py`` + ``cli.py``, ``hvd-serve-torch``) — a
  streaming ``/generate`` endpoint on the shared stdlib HTTP scaffolding,
  ``/healthz`` + ``/metrics`` alongside, with the ``hvd_serve_*``
  instrument family in the standard registry;
* **sampling** (``sampling.py``) — temperature / top-p with per-request
  seeds keyed on (seed, absolute position) through JAX's threefry, so a
  seeded stream is the same across replicas, batches and re-dispatch;
* **fleet** (``fleet/``) — N engine replicas behind one routing
  frontend: queue-depth/KV-headroom dispatch, rolling weight reload, and
  spot-preemption drains that re-dispatch cut-off streams to a survivor
  with zero dropped requests;
* **tracing** (``tracing.py``) — request-scoped span recording across
  router, engines and frontends, zero-cost when off, exported as ndjson
  for ``hvd-doctor serve`` (``diag/serve_doctor.py``) and as merged
  Chrome traces.
"""

from horovod_tpu_torch.serve.engine import (  # noqa: F401
    Request,
    RequestError,
    ServeEngine,
)
from horovod_tpu_torch.serve.fleet import (  # noqa: F401
    FleetRequest,
    FleetRouter,
    FleetServer,
    Replica,
)
from horovod_tpu_torch.serve.kvcache import (  # noqa: F401
    BlockAllocator,
    KVCacheConfig,
    PrefixCache,
    init_pool,
)
from horovod_tpu_torch.serve.loader import (  # noqa: F401
    ReloadWatcher,
    abstract_params,
    load_params,
)
from horovod_tpu_torch.serve.sampling import (  # noqa: F401
    GREEDY,
    SamplingParams,
)
from horovod_tpu_torch.serve.server import ServeServer  # noqa: F401
from horovod_tpu_torch.serve.tracing import (  # noqa: F401
    SPAN_KINDS,
    RequestTrace,
    ServeTracer,
)

__all__ = [
    "ServeEngine", "Request", "RequestError",
    "KVCacheConfig", "BlockAllocator", "PrefixCache", "init_pool",
    "load_params", "abstract_params", "ReloadWatcher",
    "ServeServer", "SamplingParams", "GREEDY",
    "Replica", "FleetRouter", "FleetRequest", "FleetServer",
    "ServeTracer", "RequestTrace", "SPAN_KINDS",
]
