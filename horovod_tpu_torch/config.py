"""Environment-variable configuration: the launcher's rank contract, the
fusion threshold and the wire format, under the same ``HOROVOD_*`` names
as the JAX package (``horovod_tpu/config.py``)."""

import dataclasses
import os

# Default tensor-fusion buffer size: 64 MB, Horovod's default.
DEFAULT_FUSION_THRESHOLD = 64 * 1024 * 1024


def _env_int(name, default):
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def _env_str(name, default=None):
    v = os.environ.get(name)
    return default if v in (None, "") else v


@dataclasses.dataclass
class Config:
    """Snapshot of the knobs at ``init()`` time."""

    rank: int = 0
    size: int = 1
    local_rank: int = 0
    local_size: int = 1
    cross_rank: int = 0
    cross_size: int = 1
    # rendezvous of a multi-process job: the launcher's HTTP key-value
    # store (HOROVOD_GLOO_RENDEZVOUS_ADDR/PORT, kv_store True), or else a
    # torch TCP store at MASTER_ADDR/MASTER_PORT
    rendezvous_addr: str = None
    rendezvous_port: int = 0
    kv_store: bool = False
    fusion_threshold: int = DEFAULT_FUSION_THRESHOLD
    # the default wire format of DistributedOptimizer(compression=None),
    # a name of ops/compression.by_name
    wire_dtype: str = None

    @classmethod
    def from_env(cls) -> "Config":
        return cls(
            rank=_env_int("HOROVOD_RANK", 0),
            size=_env_int("HOROVOD_SIZE", 1),
            local_rank=_env_int("HOROVOD_LOCAL_RANK", 0),
            local_size=_env_int("HOROVOD_LOCAL_SIZE", 1),
            cross_rank=_env_int("HOROVOD_CROSS_RANK", 0),
            cross_size=_env_int("HOROVOD_CROSS_SIZE", 1),
            rendezvous_addr=_env_str("HOROVOD_GLOO_RENDEZVOUS_ADDR",
                                     _env_str("MASTER_ADDR")),
            rendezvous_port=_env_int("HOROVOD_GLOO_RENDEZVOUS_PORT",
                                     _env_int("MASTER_PORT", 0)),
            kv_store=_env_str("HOROVOD_GLOO_RENDEZVOUS_ADDR") is not None,
            fusion_threshold=_env_int("HOROVOD_FUSION_THRESHOLD",
                                      DEFAULT_FUSION_THRESHOLD),
            wire_dtype=_env_str("HOROVOD_WIRE_DTYPE"),
        )
