"""The port's passes. Importing this package registers every rule with
the engine registry (``engine.register``): five as the JAX package has
them, and torch twins of its three JAX-specific ones (``hostsync``,
``mesh``, ``distinit``)."""

from horovod_tpu_torch.analysis.rules import (  # noqa: F401
    desync, distinit, excepts, hostsync, lockorder, mesh, metric,
    sigsafe,
)
