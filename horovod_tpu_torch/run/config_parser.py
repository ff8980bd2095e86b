"""hvdrun's tuning flags and config file mapped onto ``HOROVOD_*`` env:
the port of ``horovod_tpu/run/config_parser.py``, the same flag for the
same variable. Which of them the port acts on is
``horovod_tpu_torch.config.ACTED_ON``.
"""

# arg name -> env var
ARG_TO_ENV = {
    "fusion_threshold_mb": "HOROVOD_FUSION_THRESHOLD",
    "cycle_time_ms": "HOROVOD_CYCLE_TIME",
    "cache_capacity": "HOROVOD_CACHE_CAPACITY",
    "hierarchical_allreduce": "HOROVOD_HIERARCHICAL_ALLREDUCE",
    "hierarchical_allgather": "HOROVOD_HIERARCHICAL_ALLGATHER",
    "timeline_filename": "HOROVOD_TIMELINE",
    "timeline_mark_cycles": "HOROVOD_TIMELINE_MARK_CYCLES",
    "no_stall_check": "HOROVOD_STALL_CHECK_DISABLE",
    "stall_warning_time_seconds": "HOROVOD_STALL_CHECK_TIME_SECONDS",
    "stall_shutdown_time_seconds": "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS",
    "autotune": "HOROVOD_AUTOTUNE",
    "autotune_log_file": "HOROVOD_AUTOTUNE_LOG",
    "autotune_warmup_samples": "HOROVOD_AUTOTUNE_WARMUP_SAMPLES",
    "autotune_steps_per_sample": "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE",
    "autotune_sample_repeats": "HOROVOD_AUTOTUNE_SAMPLE_REPEATS",
    "autotune_bayes_opt_max_samples":
        "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES",
    "autotune_gaussian_process_noise":
        "HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE",
    "log_level": "HOROVOD_LOG_LEVEL",
    # the launcher's value is the BASE port; each rank's is base +
    # local_rank (launcher.slot_env)
    "metrics_port": "HOROVOD_METRICS_PORT",
    "metrics_addr": "HOROVOD_METRICS_ADDR",
}


def args_to_env(args):
    """The env-var dict of the parsed args."""
    env = {}
    for arg, var in ARG_TO_ENV.items():
        val = getattr(args, arg, None)
        # identity checks: 0 and 0.0 are explicit values (0 == False)
        if val is None or val is False:
            continue
        if arg == "fusion_threshold_mb":
            val = int(val) * 1024 * 1024
        if val is True:
            val = "1"
        env[var] = str(val)
    if getattr(args, "disable_cache", False):
        env["HOROVOD_CACHE_CAPACITY"] = "0"
    return env


def load_config_file(path, args, parser_defaults):
    """Overlay a YAML config file onto the args left at their defaults
    (the command line wins over the file)."""
    import yaml
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    flat = {}

    def _flatten(d, prefix=""):
        for k, v in d.items():
            key = (prefix + "_" + k if prefix else k).replace("-", "_")
            if isinstance(v, dict):
                _flatten(v, key)
            else:
                flat[key] = v

    _flatten(cfg)
    for key, val in flat.items():
        if hasattr(args, key) and getattr(args, key) == \
                parser_defaults.get(key):
            setattr(args, key, val)
    return args
