"""Synthetic LM training benchmark: tokens/s through the port's hot path
(``DistributedOptimizer``'s fused allreduce, the transformer LM with the
flash kernels, AdamW). The port of ``examples/jax_lm_benchmark.py``, at
its flags and defaults, started as Horovod's own examples are: the
initial state broadcast, the learning-rate warmup of Goyal et al. and
the loss averaged by the callbacks.

On the card, under the port's launcher:

    python -m horovod_tpu_torch.run -np 1 \\
        python -m horovod_tpu_torch.examples.lm_benchmark --steps 5

On the CPU, two ranks over gloo at a small size:

    python -m horovod_tpu_torch.run -np 2 \\
        python -m horovod_tpu_torch.examples.lm_benchmark --device cpu \\
        --layers 1 --d-model 32 --heads 2 --vocab 64 --seq-len 16 \\
        --batch 2 --steps 2 --warmup 1

``--batch`` sequences a rank. The run is one unconditional warm step,
``--warmup`` more and ``--steps`` timed ones. The warm steps are the
first epoch, over which the learning rate ramps from the optimizer's to
``size()`` times it; the timed steps are the second. Rank 0 prints one
JSON line: the JAX example's keys (``value``: tokens/s over all ranks
from the median timed step), each step's loss, learning rate and ms,
each epoch's loss averaged by ``MetricAverageCallback``, the flash
kernels' launches over the whole run, the device, and the seconds of
the imports, ``init()``, the device's first allocation, the kernel
library's load and the model's build.
"""

import argparse
import json
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", type=int, default=1,
                    help="data-axis size (the world's size; above 1 "
                         "refused)")
    ap.add_argument("--seq", type=int, default=1,
                    help="seq-axis size (above 1 refused)")
    ap.add_argument("--batch", type=int, default=8,
                    help="sequences a rank")
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--no-flash", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu, or a card (default: this rank's card)")
    args = ap.parse_args(argv)
    if args.data > 1 or args.seq > 1:
        ap.error("--data and --seq above 1 need sequence parallelism, "
                 "which horovod_tpu_torch does not have yet (ROADMAP.md "
                 "Queue 1 item 4); the data axis is hvdrun's -np")
    if args.steps < 1 or args.warmup < 0:
        ap.error("--steps must be >= 1 and --warmup >= 0")

    t = time.perf_counter()
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import _build, callbacks
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.utils.benchmarks import make_lm_bench, sync
    import_s = time.perf_counter() - t

    t = time.perf_counter()
    hvd.init(device=args.device)
    init_s = time.perf_counter() - t
    dev = hvd.device()
    # the device's context and first allocation, apart from the build
    t = time.perf_counter()
    torch.zeros(1, device=dev).sum().item()
    context_s = time.perf_counter() - t
    kernel_load_s = None
    if dev.type == "cuda" and not args.no_flash:
        # the library a build in this checkout left under _build/, else
        # built here
        t = time.perf_counter()
        _build.load()
        kernel_load_s = time.perf_counter() - t
    t = time.perf_counter()
    step, model, opt, tokens = make_lm_bench(
        batch=args.batch, seq_len=args.seq_len, layers=args.layers,
        d_model=args.d_model, heads=args.heads, vocab=args.vocab,
        flash=not args.no_flash)
    sync()
    build_s = time.perf_counter() - t

    warm = 1 + args.warmup
    lr0 = opt.param_groups[0]["lr"]
    broadcast = callbacks.BroadcastGlobalVariablesCallback(root_rank=0)
    warmup = callbacks.LearningRateWarmupCallback(
        opt, initial_lr=lr0, warmup_epochs=1, steps_per_epoch=warm)
    average = callbacks.MetricAverageCallback()
    broadcast.on_train_begin({"model": model, "optimizer": opt})

    fa.reset_launches()
    losses, lrs, times, epoch_losses = [], [], [], []
    for epoch, n in enumerate((warm, args.steps)):
        warmup.on_epoch_begin(epoch)
        for batch in range(n):
            warmup.on_batch_begin(batch)
            lrs.append(opt.param_groups[0]["lr"])
            t = time.perf_counter()
            loss = step(tokens)
            sync()
            times.append(time.perf_counter() - t)
            losses.append(float(loss))
        metrics = average.on_epoch_end(
            epoch, {"loss": float(np.mean(losses[-n:]))})
        epoch_losses.append(metrics["loss"])
    launches = dict(fa.LAUNCHES)

    step_s = float(np.median(times[warm:]))
    tok_s = args.batch * args.seq_len * hvd.size() / step_s
    if hvd.rank() == 0:
        print(json.dumps({
            "metric": "transformer_lm_tokens_per_sec",
            "value": round(tok_s, 1),
            "unit": "tokens/sec",
            "seq_len": args.seq_len,
            "mesh": {"data": hvd.size(), "seq": 1},
            "flash_attention": not args.no_flash,
            "final_loss": round(losses[-1], 4),
            "losses": losses,
            "lrs": lrs,
            "initial_lr": lr0,
            "warm_steps": warm,
            "step_ms": [1e3 * x for x in times],
            "epoch_losses": epoch_losses,
            "launches": launches,
            "device": dev.type,
            "device_name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
            "world": hvd.size(),
            "import_s": import_s,
            "init_s": init_s,
            "context_s": context_s,
            "kernel_load_s": kernel_load_s,
            "build_s": build_s,
        }), flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()
