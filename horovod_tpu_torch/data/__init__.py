"""The data plane: per-rank sharding and the prefetch loader. The port of
``horovod_tpu/data``, on the same index streams, so a run of either
package resumes from the other's cursor:

* ``sharding.py``: ``shard_indices``, ``DistributedSampler``,
  ``shard_dataset``, ``local_batches``;
* ``sources.py``: the index-addressed ``ArraySource`` and ``FileSource``;
* ``loader.py``: ``PrefetchLoader``, a background producer with a
  serializable cursor, and its staging onto the card
  (``device_placement``, ``ready``).

``training.make_train_step(loader=...)`` installs the staging and pulls
its batches from the loader.
"""

from horovod_tpu_torch.data.loader import (  # noqa: F401
    CURSOR_VERSION,
    PrefetchLoader,
    device_placement,
    epoch_order,
    ready,
    segment,
)
from horovod_tpu_torch.data.sharding import (  # noqa: F401
    DistributedSampler,
    local_batches,
    shard_dataset,
    shard_indices,
)
from horovod_tpu_torch.data.sources import (  # noqa: F401
    ArraySource,
    FileSource,
    Source,
)

__all__ = [
    "shard_indices", "DistributedSampler", "shard_dataset",
    "local_batches",
    "Source", "ArraySource", "FileSource",
    "PrefetchLoader", "epoch_order", "segment", "CURSOR_VERSION",
    "device_placement", "ready",
]
