"""Async sharded checkpoints: snapshot-offload writes, the two-phase
manifest commit and the N→M resharded restore. The port of
``horovod_tpu/ckpt``, on the same disk format, so a checkpoint written
by either package restores in the other:

* ``snapshot.py``: ``AsyncCheckpointer``, a synchronous host copy and a
  background write and commit;
* ``sharded.py``: per-rank shard files (flax msgpack, ``_msgpack.py``)
  and the deterministic reshard of ZeRO-1 rows;
* ``manifest.py``: the layout, the ``.ok`` markers with their CRC32s,
  ``MANIFEST.json`` and retention.

``convert.train_state_to_flat`` and ``convert.train_state_from_flat``
carry a model, its ``DistributedOptimizer`` (or a model shard and its
plain optimizer, the leaves it cuts as ``GatheredLeaf``s) and the step
count to and from the JAX ``TrainState``'s flat leaf list, the tree
these functions save and restore.
"""

from horovod_tpu_torch.ckpt.manifest import (  # noqa: F401
    MANIFEST_NAME,
    is_complete,
    latest_complete_step,
    list_complete_steps,
    read_manifest,
    retention_gc,
)
from horovod_tpu_torch.ckpt.sharded import (  # noqa: F401
    GatheredLeaf,
    ShardValidationError,
    ZeroLeaf,
    restore_sharded,
    save_sharded,
    shard_path,
    step_dir,
)
from horovod_tpu_torch.ckpt.snapshot import (  # noqa: F401
    AsyncCheckpointer,
    snapshot_tree,
)

__all__ = [
    "AsyncCheckpointer", "snapshot_tree",
    "save_sharded", "restore_sharded", "ShardValidationError", "ZeroLeaf",
    "GatheredLeaf",
    "shard_path", "step_dir",
    "MANIFEST_NAME", "read_manifest", "is_complete",
    "list_complete_steps", "latest_complete_step", "retention_gc",
]
