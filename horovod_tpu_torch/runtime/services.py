"""The host services of one run, started by ``init()`` and stopped by
``shutdown()`` (``basics.py``).

The port of ``horovod_tpu/runtime/services.py`` (``start``, ``:54-178``,
and ``stop``), in the JAX order, but for the native host core, which
``start_core`` starts at the classic adapters' first collective
(``basics.native_core``):

* a fresh goodput ledger for the run (``telemetry/ledger.py``;
  ``HOROVOD_GOODPUT=0`` turns it off);
* the flight recorder, armed first, so that it explains a failure of
  what follows (``diag/recorder.py``; on by default for a multi-process
  job, ``HOROVOD_FLIGHTREC`` forces it);
* the per-rank host timeline (``utils/timeline.py``;
  ``HOROVOD_TIMELINE``, one file a rank in a multi-process job; the
  native core's own timeline of rank 0's negotiations keeps the plain
  path);
* the metrics server with its health function (``telemetry/server.py``;
  ``HOROVOD_METRICS_PORT``, bound to ``HOROVOD_METRICS_ADDR``): a taken
  port is logged and the run goes on without a scrape plane;
* for an elastic worker (``HOROVOD_ELASTIC=1``) the stall inspector
  (``runtime/stall.py``, unless ``HOROVOD_STALL_CHECK_DISABLE``), whose
  progress hooks publish the heartbeats of the elastic driver's
  liveness view (``elastic/worker.py``). The JAX package also starts it
  with its native core, where nothing but an elastic commit feeds it
  progress, so that it warns of a stall after 60 s in every healthy
  job; the port does not;
* the graceful-eviction handler (``elastic/preempt.py``) for an elastic
  worker or a run that set a grace budget or a notice source, after the
  recorder, so that SIGTERM rides its signal watcher.

``stop`` writes ``goodput.rank<r>.json`` beside the flight-recorder
dumps, uninstalls the eviction handler, stops the server and the
inspector, closes the elastic worker's endpoint, stops the native host
core where the classic adapters started it (``start_core``, called by
``basics.native_core``), closes the timeline, and uninstalls the recorder
with a final dump, which is how the doctor tells a clean exit from a hard
kill.
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


def _controller_port(state, cfg):
    """The controller's port: the launcher's, or for port 0 a free port
    on rank 0's host, published through the launcher's key-value store
    under a key of this run's elastic epoch and this process's count of
    core starts (as ``basics._kv_store`` keys the torch store), so that a
    later start never reads an earlier one's port."""
    if cfg.controller_port:
        return cfg.controller_port
    import socket

    from horovod_tpu_torch.run import rendezvous
    if not cfg.kv_store:
        raise RuntimeError(
            "HOROVOD_CONTROLLER_PORT=0 requires the launcher's key-value "
            "store (HOROVOD_GLOO_RENDEZVOUS_ADDR/PORT)")
    state.core_starts += 1
    key = (f"controller/port/{os.environ.get('HOROVOD_ELASTIC_EPOCH', '0')}"
           f"/{state.core_starts}")
    if cfg.rank == 0:
        with socket.socket() as s:
            s.bind(("0.0.0.0", 0))
            port = s.getsockname()[1]
        rendezvous.kv_put(cfg.rendezvous_addr, cfg.rendezvous_port, key,
                          str(port).encode())
        return port
    return int(rendezvous.kv_wait(cfg.rendezvous_addr, cfg.rendezvous_port,
                                  key, timeout=120).decode())


def _advertise_addr():
    """The address this rank's data plane advertises: ``HOROVOD_HOSTNAME``
    (loopback for ``localhost``), or across hosts this host's address on
    the first interface of ``HOROVOD_COMMON_INTERFACES`` (hvdrun's NIC
    pre-flight) that it owns."""
    advertise = os.environ.get("HOROVOD_HOSTNAME", "127.0.0.1")
    if advertise == "localhost":
        advertise = "127.0.0.1"
    common = os.environ.get("HOROVOD_COMMON_INTERFACES")
    if common and advertise != "127.0.0.1":
        from horovod_tpu_torch.run.discovery import local_interfaces
        mine = local_interfaces()
        for intf in common.split(","):
            if mine.get(intf):
                return mine[intf][0][0]
    return advertise


def start_core(state, cfg):
    """Start the native host core of a multi-process job whose launcher
    named a controller (``HOROVOD_CONTROLLER_ADDR``); sets
    ``state.controller``. Every rank builds (or loads) the library
    first, then rank 0 resolves port 0 to a free port and publishes it
    through the launcher's key-value store, and every rank joins the
    core's controller, advertising its address on the first of
    ``HOROVOD_COMMON_INTERFACES`` it owns. A failure raises."""
    from horovod_tpu_torch import _core
    _core.build()  # every rank, before any wait on another's start
    port = _controller_port(state, cfg)
    _core.init(rank=cfg.rank, size=cfg.size, coord_host=cfg.controller_addr,
               coord_port=port, advertise_host=_advertise_addr())
    state.controller = _core
    logger.info("native core started (controller %s:%d)",
                cfg.controller_addr, port)


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
    if state.controller is not None:
        state.controller.shutdown()
        state.controller = None
    if state.timeline is not None:
        state.timeline.close()
        state.timeline = None
    if state.flight_recorder is not None:
        from horovod_tpu_torch import diag
        diag.uninstall(dump=True, reason=reason)
        state.flight_recorder = None
