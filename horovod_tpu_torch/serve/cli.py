"""``hvd-serve-torch`` — serve a checkpointed transformer over HTTP. The
port of ``horovod_tpu/serve/cli.py`` (``hvd-serve``), the same flags.

    hvd-serve-torch --ckpt-dir /ckpts --port 8000 \\
        --num-layers 4 --num-heads 8 --d-model 512 --d-ff 2048

Loads the newest manifest-complete checkpoint's params (written by
either package, any training world), starts the continuous-batching
engine on the card (``--device``) and the streaming frontend, and keeps
polling the checkpoint dir for newer manifests — a training job
committing checkpoints into the same directory rolls new weights into
serving without a restart.

Under ``hvdrun-torch -np N`` (N > 1) every rank loads the params and
runs one rank of a single engine over the ranks (``serve/engine.py``):
the decode slots split over the data ranks, the pool replicated. Only
rank 0 binds HTTP and takes requests (and polls for new checkpoints,
whose weights it broadcasts); the other ranks follow its iterations and
leave SIGTERM and SIGINT to it: a shutdown on rank 0 ends every rank.
``--fleet`` serves the cards of one process and is refused there.

The model architecture is not recorded in the checkpoint (params are a
plain tree), so the flags must restate it. A manifest whose ``meta``
carries a ``model_config`` dict is cross-checked against the flags and
mismatches fail loudly instead of serving garbage.
"""

import argparse
import logging
import os
import signal
import sys
import threading

logger = logging.getLogger("horovod_tpu_torch")


def build_parser():
    p = argparse.ArgumentParser(
        prog="hvd-serve-torch",
        description="continuous-batching inference server fed from "
                    "sharded checkpoints")
    p.add_argument("--ckpt-dir", required=True,
                   help="checkpoint root (ckpt-<step>/ dirs with "
                        "MANIFEST.json)")
    p.add_argument("--step", type=int, default=None,
                   help="serve this exact step (default: newest "
                        "complete, with validation fallback)")
    p.add_argument("--addr", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    # model architecture (must match the checkpoint)
    p.add_argument("--vocab-size", type=int, default=32000)
    p.add_argument("--num-layers", type=int, default=4)
    p.add_argument("--num-heads", type=int, default=8)
    p.add_argument("--d-model", type=int, default=512)
    p.add_argument("--d-ff", type=int, default=2048)
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--device", default="cuda",
                   help="where the engines run: cuda (the default; "
                        "replicas of --fleet take the cards in turn) or "
                        "cpu")
    # serving shape
    p.add_argument("--max-slots", type=int, default=8,
                   help="decode batch width")
    p.add_argument("--prefill-chunk", type=int, default=256)
    p.add_argument("--block-size", type=int, default=16,
                   help="KV tokens per pool block")
    p.add_argument("--num-blocks", type=int, default=None,
                   help="KV pool blocks incl. the null block "
                        "(default: max_slots * max_blocks_per_seq + 1)")
    p.add_argument("--max-seq-len", type=int, default=2048,
                   help="longest prompt+generation a request may map")
    p.add_argument("--reload-poll-seconds", type=float, default=5.0)
    p.add_argument("--no-reload", action="store_true",
                   help="serve the startup checkpoint forever")
    # fleet
    p.add_argument("--fleet", type=int, default=1,
                   help="number of engine replicas; > 1 serves them "
                        "behind the fleet router, one a card in turn "
                        "(several share a card when there are fewer)")
    p.add_argument("--grace", type=float, default=None,
                   help="preemption drain budget per replica in "
                        "seconds (default: HOROVOD_GRACE_SECONDS); "
                        "notice sources come from the standard "
                        "HOROVOD_PREEMPT_NOTICE_FILE/_URL env knobs")
    p.add_argument("--trace-dir", default=None,
                   help="write per-request trace dumps here on "
                        "shutdown (ndjson for `hvd-doctor-torch serve` plus "
                        "a merged Chrome trace); also arms tracing as "
                        "if HOROVOD_SERVE_TRACE_DIR were set — "
                        "sampling/SLO come from HOROVOD_SERVE_TRACE "
                        "and HOROVOD_SERVE_TRACE_SLO_MS")
    return p


def _check_meta(meta, args):
    """Fail loudly when the manifest records an architecture that
    contradicts the flags (best effort: trainers opt in via meta)."""
    mc = (meta or {}).get("model_config")
    if not isinstance(mc, dict):
        return
    flags = {"vocab_size": args.vocab_size, "num_layers": args.num_layers,
             "num_heads": args.num_heads, "d_model": args.d_model,
             "d_ff": args.d_ff}
    bad = {k: (mc[k], v) for k, v in flags.items()
           if k in mc and int(mc[k]) != int(v)}
    if bad:
        raise SystemExit(
            f"hvd-serve-torch: checkpoint manifest records model_config "
            f"{ {k: a for k, (a, _) in bad.items()} }, flags say "
            f"{ {k: b for k, (_, b) in bad.items()} } — refusing to "
            "serve a mismatched architecture")


def replica_devices(n, device):
    """The device of each of ``n`` replicas: the cards in turn for
    ``cuda``, else ``device`` for every one."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n
    count = torch.cuda.device_count()
    if count == 0:
        raise SystemExit("hvd-serve-torch: no CUDA device (pass "
                         "--device cpu to serve on the CPU)")
    return [torch.device("cuda", i % count) for i in range(n)]


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")

    import torch

    from horovod_tpu_torch.elastic import preempt as preempt_lib
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    from horovod_tpu_torch.serve import engine as engine_lib
    from horovod_tpu_torch.serve import kvcache, loader
    from horovod_tpu_torch.serve.fleet import FleetRouter, FleetServer
    from horovod_tpu_torch.serve.server import ServeServer
    from horovod_tpu_torch.serve.tracing import ServeTracer

    from horovod_tpu_torch import basics
    from horovod_tpu_torch.config import Config
    from horovod_tpu_torch.telemetry.registry import MetricsRegistry

    mesh = None
    if Config.from_env().size > 1:
        if args.fleet > 1:
            raise SystemExit("hvd-serve-torch: --fleet serves the cards of "
                             "one process; under hvdrun-torch -np N > 1 the "
                             "ranks serve one engine")
        basics.init(device="cpu" if args.device == "cpu" else None)
        mesh = basics.mesh()
    leader = mesh is None or mesh.rank == 0

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    cfg = TransformerConfig(
        vocab_size=args.vocab_size, num_layers=args.num_layers,
        num_heads=args.num_heads, d_model=args.d_model, d_ff=args.d_ff,
        dtype=dtype, causal=True)
    devices = ([basics.device()] if mesh is not None
               else replica_devices(max(1, args.fleet), args.device))
    model = Transformer(cfg)

    target = loader.abstract_params(model)
    step, params, meta = loader.load_params(args.ckpt_dir, target,
                                            step=args.step)
    _check_meta(meta, args)
    logger.info("hvd-serve-torch: loaded params of ckpt step %d from %s",
                step, args.ckpt_dir)

    mbps = -(-args.max_seq_len // args.block_size)
    num_blocks = (args.num_blocks if args.num_blocks is not None
                  else args.max_slots * mbps + 1)
    kv = kvcache.KVCacheConfig(
        num_blocks=num_blocks, block_size=args.block_size,
        num_layers=args.num_layers, num_heads=args.num_heads,
        head_dim=args.d_model // args.num_heads,
        max_blocks_per_seq=mbps, dtype=dtype)
    logger.info("hvd-serve-torch: KV pool %d blocks x %d tokens "
                "(%.1f MiB) a replica", num_blocks, args.block_size,
                kv.pool_bytes() / 2 ** 20)

    # tracing is opt-in (env knobs / --trace-dir); tracer=None keeps
    # the request path free of any recording
    tracer = (ServeTracer.from_env(out_dir=args.trace_dir) if leader
              else None)
    if tracer is not None:
        logger.info("hvd-serve-torch: request tracing armed (sample=%.3g, "
                    "slo_ms=%s, dir=%s)", tracer.sample, tracer.slo_ms,
                    tracer.out_dir)

    router = None
    if args.fleet > 1:
        # a host-wide spot notice drains every replica — the whole VM
        # is doomed
        notice_file = os.environ.get(preempt_lib.NOTICE_FILE_ENV)
        notice_url = os.environ.get(preempt_lib.NOTICE_URL_ENV)
        router = FleetRouter(grace=args.grace, tracer=tracer)
        for i, dev in enumerate(devices):
            eng = engine_lib.ServeEngine(
                model, params, kv, device=dev, max_slots=args.max_slots,
                prefill_chunk=args.prefill_chunk, weights_version=step,
                name=f"r{i}")
            router.add_replica(f"r{i}", eng, notice_file=notice_file,
                               notice_url=notice_url)
        router.start()
        target_for_reload, frontend = router, FleetServer(
            router, addr=args.addr, port=args.port)
    elif not leader:
        # a rank of the engine over the ranks: its own registry (the
        # serve instruments count once per job, on rank 0), rank 0's
        # iterations followed until its stop
        eng = engine_lib.ServeEngine(
            model, params, kv, mesh=mesh, device=devices[0],
            max_slots=args.max_slots, prefill_chunk=args.prefill_chunk,
            weights_version=step, registry=MetricsRegistry())
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        logger.info("hvd-serve-torch: rank %d follows rank 0's engine "
                    "(decode rows %d..%d)", mesh.rank, eng._rows.start,
                    eng._rows.stop - 1)
        eng.follow()
        basics.shutdown()
        return 0
    else:
        eng = engine_lib.ServeEngine(
            model, params, kv, mesh=mesh, device=devices[0],
            max_slots=args.max_slots, prefill_chunk=args.prefill_chunk,
            weights_version=step, tracer=tracer)
        eng.start()
        target_for_reload, frontend = eng, ServeServer(
            eng, addr=args.addr, port=args.port)

    watcher = None
    if not args.no_reload:
        watcher = loader.ReloadWatcher(args.ckpt_dir, target_for_reload,
                                       target,
                                       poll_s=args.reload_poll_seconds)
        watcher.mark_current(step)
        watcher.start()

    server = frontend
    server.start()  # a taken --port is fatal: let the OSError surface
    logger.info("hvd-serve-torch: ready on http://%s:%d (weights step %d, "
                "%d replica%s on %s)", args.addr, server.port, step,
                args.fleet, "" if args.fleet == 1 else "s",
                ", ".join(str(d) for d in devices))

    done = threading.Event()

    def _sig(signum, frame):
        done.set()

    signal.signal(signal.SIGINT, _sig)
    signal.signal(signal.SIGTERM, _sig)
    try:
        done.wait()
    finally:
        server.stop()
        if watcher is not None:
            watcher.stop()
        if router is not None:
            router.stop()  # stops every replica engine
        else:
            eng.stop()
        if tracer is not None and tracer.out_dir:
            n = len(tracer.traces())
            if n:
                merged = os.path.join(tracer.out_dir,
                                      "servetrace.merged.json")
                tracer.write_chrome(merged)
                logger.info("hvd-serve-torch: wrote %d request trace(s) "
                            "to %s (ndjson) and %s (Chrome)", n,
                            tracer.out_dir, merged)
            tracer.close()
        if mesh is not None:
            basics.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
