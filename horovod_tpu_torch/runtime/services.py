"""The telemetry and diagnosis services of one run, started by
``init()`` and stopped by ``shutdown()`` (``basics.py``).

The port of the telemetry part of ``horovod_tpu/runtime/services.py``
(``start``, ``:54-115``, and its ``stop`` counterpart), in the JAX
order:

* a fresh goodput ledger for the run (``telemetry/ledger.py``;
  ``HOROVOD_GOODPUT=0`` turns it off);
* the flight recorder, armed first, so that it explains a failure of
  what follows (``diag/recorder.py``; on by default for a multi-process
  job, ``HOROVOD_FLIGHTREC`` forces it);
* the per-rank host timeline (``utils/timeline.py``;
  ``HOROVOD_TIMELINE``, one file a rank in a multi-process job);
* the metrics server with its health function (``telemetry/server.py``;
  ``HOROVOD_METRICS_PORT``, bound to ``HOROVOD_METRICS_ADDR``): a taken
  port is logged and the run goes on without a scrape plane;
* for an elastic worker (``HOROVOD_ELASTIC=1``) the stall inspector
  (``runtime/stall.py``, unless ``HOROVOD_STALL_CHECK_DISABLE``), whose
  progress hooks publish the heartbeats of the elastic driver's
  liveness view (``elastic/worker.py``), as the JAX ``services.py:146-
  166`` does; the JAX package's native controller, the inspector's other
  host there, is not ported;
* the graceful-eviction handler (``elastic/preempt.py``) for an elastic
  worker or a run that set a grace budget or a notice source, after the
  recorder, so that SIGTERM rides its signal watcher (JAX
  ``services.py:167-178``).

``stop`` writes ``goodput.rank<r>.json`` beside the flight-recorder
dumps, uninstalls the eviction handler, stops the server and the
inspector, closes the elastic worker's endpoint and the timeline, and
uninstalls the recorder with a final dump, which is how the doctor tells
a clean exit from a hard kill.
"""

import logging
import os

logger = logging.getLogger("horovod_tpu_torch")


def rank_timeline_path(path, rank, size):
    """Per-rank trace paths for the cross-rank merge: a multi-process job
    suffixes the rank (``trace.rank<r>.json``); one process keeps the
    path."""
    if size <= 1:
        return path
    base, ext = os.path.splitext(path)
    return f"{base}.rank{rank}{ext or '.json'}"


def start(state):
    cfg = state.config
    from horovod_tpu_torch.telemetry import ledger as ledger_lib
    state.ledger = ledger_lib.reset_run()
    if cfg.flightrec_enabled:
        from horovod_tpu_torch import diag
        state.flight_recorder = diag.install(
            capacity=cfg.flightrec_capacity, dump_dir=cfg.flightrec_dir,
            rank=cfg.rank, size=cfg.size, config=cfg)
        logger.info("flight recorder armed (capacity %d) -> %s",
                    cfg.flightrec_capacity,
                    state.flight_recorder.dump_path())
    if cfg.timeline:
        from horovod_tpu_torch.utils.timeline import Timeline
        path = rank_timeline_path(cfg.timeline, cfg.rank, cfg.size)
        state.timeline = Timeline(path,
                                  mark_cycles=cfg.timeline_mark_cycles,
                                  rank=cfg.rank,
                                  host=os.environ.get("HOROVOD_HOSTNAME"))
        logger.info("timeline enabled -> %s", path)
    if cfg.metrics_port is not None:
        from horovod_tpu_torch import telemetry

        def _health():
            reg = telemetry.get_registry()
            steps = reg.get(telemetry.instruments.STEP_TOTAL)
            health = {"rank": cfg.rank, "size": cfg.size,
                      "step": int(steps.value) if steps is not None else 0}
            phase = telemetry.get_ledger().active_health_label()
            if phase is not None:
                health["status"] = "recovering"
                health["phase"] = phase
            return health

        telemetry.install_compile_listeners()
        telemetry.build_info_gauge(cfg)
        telemetry.instruments.stalled_ranks_gauge().set(0)
        state.metrics_server = telemetry.MetricsServer(
            addr=cfg.metrics_addr, port=cfg.metrics_port,
            health_fn=_health, profile_dir=cfg.profile_dir)
        try:
            state.metrics_server.start()
        except OSError as e:
            logger.warning(
                "metrics endpoint failed to bind %s:%s (%s); telemetry "
                "recording stays on, the scrape plane is off",
                cfg.metrics_addr, cfg.metrics_port, e)
            state.metrics_server = None
    elastic = os.environ.get("HOROVOD_ELASTIC") == "1"
    if elastic and not cfg.stall_check_disable:
        from horovod_tpu_torch.runtime.stall import StallInspector
        state.stall_inspector = StallInspector(
            warning_time=cfg.stall_warning_time,
            shutdown_time=cfg.stall_shutdown_time)
        try:
            from horovod_tpu_torch.elastic import worker as elastic_worker
            elastic_worker.attach_progress_reporter(state.stall_inspector)
        except Exception:  # the inspector works alone
            logger.warning("elastic worker context failed to attach",
                           exc_info=True)
        state.stall_inspector.start()
    from horovod_tpu_torch.elastic import preempt as _preempt
    if elastic or _preempt.configured():
        try:
            state.preempt_handler = _preempt.install()
            logger.info("graceful-eviction handler armed (grace %.0fs)",
                        _preempt.grace_seconds())
        except Exception:  # eviction is armor, not a startup dependency
            logger.warning("graceful-eviction handler failed to install",
                           exc_info=True)


def stop(state, reason="shutdown"):
    """Stop what ``start`` started; ``reason`` is the recorder's final
    dump's (``"shutdown"`` reads as a clean exit to the doctor)."""
    try:
        from horovod_tpu_torch.telemetry import ledger as ledger_lib
        led = state.ledger or ledger_lib.get_ledger()
        if led.enabled and led.started:
            dump_dir = (state.flight_recorder.dump_dir
                        if state.flight_recorder is not None
                        else state.config.flightrec_dir)
            if dump_dir:
                led.write_dump(dump_dir, state.config.rank)
        state.ledger = None
    except Exception:
        logger.warning("goodput ledger dump failed", exc_info=True)
    if getattr(state, "preempt_handler", None) is not None:
        from horovod_tpu_torch.elastic import preempt as _preempt
        _preempt.uninstall()
        state.preempt_handler = None
    if state.metrics_server is not None:
        state.metrics_server.stop()
        state.metrics_server = None
    if getattr(state, "stall_inspector", None) is not None:
        state.stall_inspector.stop()
        state.stall_inspector = None
    if os.environ.get("HOROVOD_ELASTIC") == "1":
        from horovod_tpu_torch.elastic import worker as elastic_worker
        elastic_worker.shutdown_worker_context()
    if state.timeline is not None:
        state.timeline.close()
        state.timeline = None
    if state.flight_recorder is not None:
        from horovod_tpu_torch import diag
        diag.uninstall(dump=True, reason=reason)
        state.flight_recorder = None
