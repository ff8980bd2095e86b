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
  port is logged and the run goes on without a scrape plane.

``stop`` writes ``goodput.rank<r>.json`` beside the flight-recorder
dumps, stops the server, closes the timeline and uninstalls the
recorder with a final dump, which is how the doctor tells a clean exit
from a hard kill.
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
    if state.metrics_server is not None:
        state.metrics_server.stop()
        state.metrics_server = None
    if state.timeline is not None:
        state.timeline.close()
        state.timeline = None
    if state.flight_recorder is not None:
        from horovod_tpu_torch import diag
        diag.uninstall(dump=True, reason=reason)
        state.flight_recorder = None
