"""Environment-variable configuration: the launcher's rank contract and
the native core's controller (``HOROVOD_CONTROLLER_ADDR/PORT``), the
fusion threshold, the wire format, the two-level reduction and the
process mesh across hosts (``HOROVOD_SPMD_*``) and the observability
planes (timeline, metrics endpoint, profile directory, flight recorder),
under the same ``HOROVOD_*`` names as the JAX package
(``horovod_tpu/config.py``), the stall inspector's thresholds, and the
native core's cycle, cache, logging and autotune knobs."""

import dataclasses
import os

# Default tensor-fusion buffer size: 64 MB, Horovod's default.
DEFAULT_FUSION_THRESHOLD = 64 * 1024 * 1024
# Stall-warning threshold in seconds (Horovod's 60 s, stall_inspector.h).
DEFAULT_STALL_WARNING_TIME = 60.0
# The native core's background cycle and response cache (Horovod's
# HOROVOD_CYCLE_TIME and HOROVOD_CACHE_CAPACITY defaults).
DEFAULT_CYCLE_TIME_MS = 5.0
DEFAULT_CACHE_CAPACITY = 1024
# The tuning variables that the port acts on; hvdrun says of every other
# one it sets that the port does not act on it.
ACTED_ON = ("HOROVOD_FUSION_THRESHOLD", "HOROVOD_WIRE_DTYPE",
            "HOROVOD_HIERARCHICAL_ALLREDUCE", "HOROVOD_TIMELINE",
            "HOROVOD_TIMELINE_MARK_CYCLES", "HOROVOD_METRICS_PORT",
            "HOROVOD_METRICS_ADDR", "HOROVOD_STALL_CHECK_DISABLE",
            "HOROVOD_STALL_CHECK_TIME_SECONDS",
            "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS")


def _env_int(name, default):
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def _env_bool(name, default=False):
    v = os.environ.get(name)
    if v in (None, ""):
        return default
    return v.lower() not in ("0", "false", "no", "off")


def _env_float(name, default):
    v = os.environ.get(name)
    return default if v in (None, "") else float(v)


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
    # the native core's controller (runtime/services.start_core): set by
    # the launcher; port 0 is resolved through the key-value store
    controller_addr: str = None
    controller_port: int = 0
    fusion_threshold: int = DEFAULT_FUSION_THRESHOLD
    # the default wire format of DistributedOptimizer(compression=None),
    # a name of ops/compression.by_name
    wire_dtype: str = None
    # the default of fused_allreduce_(hierarchical=None) and
    # DistributedOptimizer(hierarchical=None): the two-level reduction
    # on a mesh with a dcn axis
    hierarchical_allreduce: bool = False
    # kept only for parity with the JAX Config, which reads them too;
    # nothing in either package acts on them (hvdrun names them so)
    hierarchical_allgather: bool = False
    adasum_chunk_size: int = 1 << 26
    # one process mesh across hosts (hvdrun --spmd-procs N
    # --spmd-local-devices K): N rows of K ranks each, the (dcn, data)
    # mesh of cluster/procmesh.py; 0 = unset
    spmd_procs: int = 0
    spmd_local_devices: int = 0
    # --- observability (JAX config.py:103-127) ---
    # the per-rank host trace (utils/timeline.py); a multi-process job
    # writes <base>.rank<r><ext>
    timeline: str = None
    timeline_mark_cycles: bool = False
    # metrics endpoint (telemetry/server.py): None = off, 0 = an
    # ephemeral port; loopback by default (the endpoints are
    # unauthenticated)
    metrics_port: int = None
    metrics_addr: str = "127.0.0.1"
    profile_dir: str = None
    # flight recorder (diag/): None = on for a multi-process job, off for
    # one process; HOROVOD_FLIGHTREC=0/1 forces; _CAPACITY bounds the
    # ring; _DIR is where flightrec.rank<r>.json dumps land
    flightrec: bool = None
    flightrec_capacity: int = 4096
    flightrec_dir: str = None
    # --- stall inspector (runtime/stall.py; JAX config.py:129-132):
    # started for an elastic worker (HOROVOD_ELASTIC=1) unless disabled
    stall_check_disable: bool = False
    stall_warning_time: float = DEFAULT_STALL_WARNING_TIME
    stall_shutdown_time: float = 0.0
    # --- the native core's knobs (JAX config.py:88-89, 105, 134-140),
    # read here as the JAX Config reads them. The core (_core.py) reads
    # the variables itself when it starts, and hvdrun names the ones the
    # port does not act on (ACTED_ON)
    cycle_time_ms: float = DEFAULT_CYCLE_TIME_MS
    cache_capacity: int = DEFAULT_CACHE_CAPACITY
    batch_d2d_memcopies: bool = True
    log_level: str = "warning"
    log_hide_timestamp: bool = False
    autotune: bool = False
    autotune_log: str = None
    autotune_warmup_samples: int = 3
    autotune_steps_per_sample: int = 10
    autotune_bayes_opt_max_samples: int = 20
    autotune_gaussian_process_noise: float = 0.8

    @property
    def flightrec_enabled(self):
        return self.size > 1 if self.flightrec is None else self.flightrec

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
            controller_addr=_env_str("HOROVOD_CONTROLLER_ADDR"),
            controller_port=_env_int("HOROVOD_CONTROLLER_PORT", 0),
            fusion_threshold=_env_int("HOROVOD_FUSION_THRESHOLD",
                                      DEFAULT_FUSION_THRESHOLD),
            wire_dtype=_env_str("HOROVOD_WIRE_DTYPE"),
            hierarchical_allreduce=_env_bool(
                "HOROVOD_HIERARCHICAL_ALLREDUCE"),
            hierarchical_allgather=_env_bool(
                "HOROVOD_HIERARCHICAL_ALLGATHER"),
            adasum_chunk_size=_env_int("HOROVOD_ADASUM_CHUNK_SIZE", 1 << 26),
            spmd_procs=_env_int("HOROVOD_SPMD_PROCS", 0),
            spmd_local_devices=_env_int("HOROVOD_SPMD_LOCAL_DEVICES", 0),
            timeline=_env_str("HOROVOD_TIMELINE"),
            timeline_mark_cycles=_env_bool("HOROVOD_TIMELINE_MARK_CYCLES"),
            metrics_port=_env_int("HOROVOD_METRICS_PORT", None),
            metrics_addr=_env_str("HOROVOD_METRICS_ADDR", "127.0.0.1"),
            profile_dir=_env_str("HOROVOD_PROFILE_DIR"),
            flightrec=(None if _env_str("HOROVOD_FLIGHTREC") is None
                       else _env_bool("HOROVOD_FLIGHTREC")),
            flightrec_capacity=_env_int("HOROVOD_FLIGHTREC_CAPACITY", 4096),
            flightrec_dir=_env_str("HOROVOD_FLIGHTREC_DIR"),
            stall_check_disable=_env_bool("HOROVOD_STALL_CHECK_DISABLE"),
            stall_warning_time=_env_float(
                "HOROVOD_STALL_CHECK_TIME_SECONDS",
                DEFAULT_STALL_WARNING_TIME),
            stall_shutdown_time=_env_float(
                "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", 0.0),
            cycle_time_ms=_env_float("HOROVOD_CYCLE_TIME",
                                     DEFAULT_CYCLE_TIME_MS),
            cache_capacity=_env_int("HOROVOD_CACHE_CAPACITY",
                                    DEFAULT_CACHE_CAPACITY),
            batch_d2d_memcopies=_env_bool("HOROVOD_BATCH_D2D_MEMCOPIES", True),
            log_level=_env_str("HOROVOD_LOG_LEVEL", "warning"),
            log_hide_timestamp=_env_bool("HOROVOD_LOG_HIDE_TIME"),
            autotune=_env_bool("HOROVOD_AUTOTUNE"),
            autotune_log=_env_str("HOROVOD_AUTOTUNE_LOG"),
            autotune_warmup_samples=_env_int(
                "HOROVOD_AUTOTUNE_WARMUP_SAMPLES", 3),
            autotune_steps_per_sample=_env_int(
                "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", 10),
            autotune_bayes_opt_max_samples=_env_int(
                "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", 20),
            autotune_gaussian_process_noise=_env_float(
                "HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE", 0.8),
        )
