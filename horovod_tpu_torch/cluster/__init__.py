"""The process-mesh subsystem of the port: one logical mesh over every
rank of a job that spans hosts, with DCN-aware tiers (the port of
``horovod_tpu/cluster/``).

``ensure_distributed`` is the one ``torch.distributed.init_process_group``
call site of the port; everything else here derives the mesh's rows and
each rank's block of a global value.
"""

from horovod_tpu_torch.cluster.procmesh import (  # noqa: F401
    assert_process_contiguous,
    build_process_mesh,
    coordinator_spec,
    ensure_distributed,
    global_batch,
    is_multiprocess,
    local_row_block,
    mesh_tiers,
    place,
    process_grid,
    shard_from_global,
)

__all__ = [
    "assert_process_contiguous",
    "build_process_mesh",
    "coordinator_spec",
    "ensure_distributed",
    "global_batch",
    "is_multiprocess",
    "local_row_block",
    "mesh_tiers",
    "place",
    "process_grid",
    "shard_from_global",
]
