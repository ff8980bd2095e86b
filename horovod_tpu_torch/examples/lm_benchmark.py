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

Sequence-parallel over a (data, seq) mesh of the ranks (ring attention,
the flash kernels per block), the JAX example's ``--data D --seq S``
under ``-np D*S``:

    python -m horovod_tpu_torch.run -np 4 \\
        python -m horovod_tpu_torch.examples.lm_benchmark --device cpu \\
        --data 2 --seq 2 --layers 1 --d-model 32 --heads 2 --vocab 64 \\
        --seq-len 32 --batch 2 --steps 2 --warmup 1

Tensor-parallel over a (data, model) mesh (``--model M``, the JAX
package's ``jax_lm_tensor_parallel.py``) and a Switch MoE LM over a
(data, expert) mesh (``--expert N --moe-every 2``, its ``jax_lm_moe.py``),
under ``-np D*M*N``; each rank holds its shard of the weights
(``parallel.tensor``) and trains through ``make_tp_lm_train_step`` with
a plain AdamW:

    python -m horovod_tpu_torch.run -np 2 \\
        python -m horovod_tpu_torch.examples.lm_benchmark --device cpu \\
        --model 2 --layers 1 --d-model 32 --heads 2 --vocab 64 \\
        --seq-len 32 --batch 2 --steps 2 --warmup 1

``--data`` defaults to the world's size over ``--seq``, ``--model`` and
``--expert``; ``--seq`` above 1 does not combine with the sharded model.
``--batch`` is
the sequences of a data index (of a rank, without ``--seq``), drawn once
for the whole mesh and cut by each rank's coordinates; ``--seq-len`` is
the whole sequence. The model computes in bf16 on the card and in fp32
on the CPU, as the JAX example does off the TPU. The run is one
unconditional warm step,
``--warmup`` more and ``--steps`` timed ones. The warm steps are the
first epoch, over which the learning rate ramps from the optimizer's to
``--data`` times it (``LearningRateWarmupCallback`` counts the mesh's
data axis); the timed steps are the second. Rank 0 prints the mesh,
``data x seq`` (or ``data x model x expert`` for the sharded model,
whose ranks start from the same seed and cut their shards, with no
broadcast), and one JSON line: the JAX example's keys (``value``:
tokens/s over all ranks from the median timed step), each step's loss,
learning rate and ms, each epoch's loss averaged by
``MetricAverageCallback``, the flash kernels' launches over the whole
run, the device, and the seconds of the imports, ``init()``, the
device's first allocation, the kernel library's load and the model's
build.
"""

import argparse
import json
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", type=int, default=None,
                    help="data-axis size (default: the world's size over "
                         "--seq)")
    ap.add_argument("--seq", type=int, default=1,
                    help="seq-axis size (ring attention over it above 1)")
    ap.add_argument("--model", type=int, default=1,
                    help="model-axis size (heads, d_ff and vocab sharded)")
    ap.add_argument("--expert", type=int, default=1,
                    help="expert-axis size (the MoE experts sharded)")
    ap.add_argument("--moe-every", type=int, default=0,
                    help="every N-th block a MoE block (0: dense)")
    ap.add_argument("--experts", type=int, default=8)
    ap.add_argument("--moe-groups", type=int, default=1)
    ap.add_argument("--top-k", type=int, default=1)
    ap.add_argument("--batch", type=int, default=8,
                    help="sequences a data index")
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
    from horovod_tpu_torch.config import Config
    world = Config.from_env().size
    if min(args.seq, args.model, args.expert) < 1:
        ap.error("--seq, --model and --expert must be >= 1")
    sharded = args.model > 1 or args.expert > 1 or args.moe_every > 0
    if sharded and args.seq > 1:
        ap.error("--seq does not combine with --model, --expert or "
                 "--moe-every")
    others = args.seq * args.model * args.expert
    if args.data is None:
        args.data = max(1, world // others)
    if args.data * others != world:
        ap.error(f"a mesh of --data {args.data} x --seq {args.seq} x "
                 f"--model {args.model} x --expert {args.expert} needs "
                 f"{args.data * others} ranks; this job has {world} "
                 "(hvdrun -np)")
    if args.steps < 1 or args.warmup < 0:
        ap.error("--steps must be >= 1 and --warmup >= 0")

    t = time.perf_counter()
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import _build, callbacks
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.parallel.mesh import build_mesh
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
    if sharded:
        shape = {"data": args.data, "model": args.model,
                 "expert": args.expert}
        moe = dict(model_axis="model", expert_axis="expert",
                   moe_every=args.moe_every, num_experts=args.experts,
                   moe_num_groups=args.moe_groups, moe_top_k=args.top_k)
    else:
        shape, moe = {"data": args.data, "seq": args.seq}, {}
    mesh = build_mesh(tuple(shape.values()), tuple(shape))
    step, model, opt, tokens = make_lm_bench(
        batch=args.batch, seq_len=args.seq_len, layers=args.layers,
        d_model=args.d_model, heads=args.heads, vocab=args.vocab,
        flash=not args.no_flash, mesh=mesh,
        dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32,
        seq_axis="seq" if args.seq > 1 else None, **moe)
    sync()
    build_s = time.perf_counter() - t

    warm = 1 + args.warmup
    lr0 = opt.param_groups[0]["lr"]
    broadcast = callbacks.BroadcastGlobalVariablesCallback(root_rank=0)
    warmup = callbacks.LearningRateWarmupCallback(
        opt, initial_lr=lr0, warmup_epochs=1, steps_per_epoch=warm)
    average = callbacks.MetricAverageCallback()
    if not sharded:  # a broadcast would overwrite the other shards
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
    tok_s = args.batch * args.data * args.seq_len / step_s
    if hvd.rank() == 0:
        print(f"mesh {' x '.join(map(str, shape.values()))} "
              f"({' x '.join(shape)})", flush=True)
        print(json.dumps({
            "metric": "transformer_lm_tokens_per_sec",
            "value": round(tok_s, 1),
            "unit": "tokens/sec",
            "seq_len": args.seq_len,
            "mesh": shape,
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
