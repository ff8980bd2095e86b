"""An elastic LM worker: the transformer LM of ``lm_benchmark.py``
trained through ``make_lm_train_step`` under
``training.elastic_train_loop`` with an ``elastic.TorchState`` that
commits every step to a checkpoint directory, the port's counterpart of
the JAX package's ``tests/elastic_train_worker.py``. It rehearses a
death: ``--die kill`` SIGKILLs the worker after ``--die-after`` steps of
its life, once their commit is durable; ``--die evict`` SIGTERMs it
there, so that the graceful-eviction handler announces the host,
force-commits and exits ``EXIT_RENDEZVOUS``. Only a worker on
``--die-host`` dies, and only in epochs before ``--die-until-epoch``.

Every rank trains on the same seeded batch (the one rank 0 of
``lm_benchmark.py`` draws), so the averaged gradient is the batch's own
at any world size and a resumed run repeats an unbroken one's losses
bit for bit. Rank 0 appends one JSON line a step to ``--log`` (its loss
and the flash kernels' launches so far),
one when its loop starts (the step it resumed from, the restore's
seconds, the seconds of its imports, ``init()``, the device's first
allocation, the kernel library's load and the model's build, and the
wall time the build ended) and one at the end or at its death, with each
commit's blocking seconds (the first the commit before the first step:
a fresh start's, None after a restore) and the flash kernels' launches
counted from 0 at the first step.

Under an elastic driver on the CPU, two ranks over gloo:

    python -m horovod_tpu_torch.run --min-np 1 --max-np 2 -H localhost:2 \\
        python -m horovod_tpu_torch.examples.elastic_train --device cpu \\
        --layers 1 --d-model 32 --heads 2 --vocab 64 --seq-len 16 \\
        --batch 2 --steps 4 --ckpt-dir /tmp/ckpt --log /tmp/losses.jsonl

On the card (the default device) at the LM's full width:

    python -m horovod_tpu_torch.run --min-np 1 -np 1 \\
        python -m horovod_tpu_torch.examples.elastic_train --steps 5 \\
        --ckpt-dir /tmp/ckpt --log /tmp/losses.jsonl

``local_launch`` is a ``launch_fn`` for ``ElasticDriver.run_job`` that
runs every slot's worker on this machine whatever its host's name, as
the tests and ``chip_smoke.py`` drive a driver over named hosts.
"""

import argparse
import json
import os
import signal
import sys
import time

T_START = time.time()


def local_launch(kv_port, argv, extra_env=None, log_dir=None):
    """A ``launch_fn`` for ``ElasticDriver.run_job``: one process a slot
    on this machine, running ``python -m
    horovod_tpu_torch.examples.elastic_train *argv`` under the launcher's
    env contract (``HOROVOD_HOSTNAME`` the slot's host, the rendezvous at
    ``127.0.0.1:kv_port``) and the epoch's elastic env, with no
    middleman. With ``log_dir`` each rank's output goes to
    ``epoch-<n>.rank<r>.log`` there. The job records when each epoch
    launched (``job.launched_at``)."""
    import subprocess

    from horovod_tpu_torch.run import launcher

    def launch(slots, epoch, elastic_env):
        job = launcher.Job()
        job.launched_at = time.time()
        for slot in slots:
            env = dict(os.environ)
            env.update(extra_env or {})
            env.update(elastic_env)
            env.update(launcher.slot_env(slot, "127.0.0.1", 0,
                                         rendezvous_addr="127.0.0.1",
                                         rendezvous_port=kv_port))
            env["PYTHONPATH"] = launcher.repo_pythonpath(env)
            out = None
            if log_dir:
                out = open(os.path.join(
                    log_dir, f"epoch-{epoch}.rank{slot.rank}.log"), "wb")
            try:
                job.procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "horovod_tpu_torch.examples.elastic_train",
                     *map(str, argv)],
                    env=env, stdout=out, stderr=subprocess.STDOUT
                    if out else None))
            finally:
                if out is not None:
                    out.close()  # the child holds its own descriptor
            job.slots.append(slot)
        return job

    return launch


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (this rank's card) or cpu")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--log", required=True,
                    help="rank 0 appends a JSON line a step here")
    ap.add_argument("--die", choices=("kill", "evict"), default=None)
    ap.add_argument("--die-host", default=None)
    ap.add_argument("--die-until-epoch", type=int, default=0)
    ap.add_argument("--die-after", type=int, default=1,
                    help="steps of this worker's life before it dies")
    ap.add_argument("--step-sleep", type=float, default=0.0,
                    help="seconds to sleep before each step (a slower "
                         "run for injected faults to land in)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    t = time.perf_counter()
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import _build, elastic, training
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.utils.benchmarks import make_lm_bench, sync
    timing = {"import_s": time.perf_counter() - t, "t_start": T_START}

    t = time.perf_counter()
    hvd.init(device=args.device)
    timing["init_s"] = time.perf_counter() - t
    dev = hvd.device()
    t = time.perf_counter()
    torch.zeros(1, device=dev).sum().item()
    timing["context_s"] = time.perf_counter() - t
    timing["kernel_load_s"] = None
    if dev.type == "cuda":
        # the library a build in this checkout left under _build/
        t = time.perf_counter()
        _build.load()
        timing["kernel_load_s"] = time.perf_counter() - t
    t = time.perf_counter()
    step, model, opt, _ = make_lm_bench(
        batch=args.batch, seq_len=args.seq_len, layers=args.layers,
        d_model=args.d_model, heads=args.heads, vocab=args.vocab,
        flash=True,
        dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32)
    # rank 0's batch of lm_benchmark on every rank (module docstring)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, args.vocab, size=(args.batch, args.seq_len)).astype(
            np.int64)).to(dev)
    sync()
    timing["build_s"] = time.perf_counter() - t
    timing["t_built"] = time.time()

    rank = hvd.rank()
    host = os.environ.get("HOROVOD_HOSTNAME", "localhost")
    epoch = int(os.environ.get("HOROVOD_ELASTIC_EPOCH", "0"))
    state = elastic.TorchState(model, opt, step.state,
                               directory=args.ckpt_dir)
    commits = []
    entry = {"step": None}
    dying = (args.die is not None and host == args.die_host
             and epoch < args.die_until_epoch)

    def log(record):
        if rank == 0:
            with open(args.log, "a") as f:
                f.write(json.dumps({"epoch": epoch, "host": host,
                                    **record}) + "\n")

    def batch(n):
        if entry["step"] is None:
            entry["step"] = n
            log({"event": "resume", "resumed_from": n,
                 "restore_s": state.last_restore_s, "time": time.time(),
                 "world": hvd.size(), **timing})
            fa.reset_launches()  # this worker's steps only
        if dying and n - entry["step"] >= args.die_after:
            die(n)
        if args.step_sleep:
            time.sleep(args.step_sleep)
        return tokens

    def die(n):
        if args.die == "evict":
            # a preemption notice: the eviction thread owns the rest of
            # this process's life (commit, announce, exit 75); park so no
            # further step races the drain
            commits.append(state.last_blocking_s)
            log({"event": "death", "mode": "evict", "step": n,
                 "time": time.time(), "commit_blocking_s": commits,
                 "launches": dict(fa.LAUNCHES)})
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(120)
            raise SystemExit("the eviction never fired")
        # the crash strikes once the commit of step n is durable; bounded,
        # since a peer's shard may lag
        try:
            state.flush(timeout=60.0)
        except Exception:
            pass  # die anyway: the restore falls back a commit
        commits.append(state.last_blocking_s)
        log({"event": "death", "mode": "kill", "step": n,
             "time": time.time(), "commit_blocking_s": commits,
             "launches": dict(fa.LAUNCHES)})
        os.kill(os.getpid(), signal.SIGKILL)

    def on_step(n, loss):
        commits.append(state.last_blocking_s)
        log({"step": n, "loss": loss, "time": time.time(),
             "launches": dict(fa.LAUNCHES)})

    training.elastic_train_loop(state, step, batch, args.steps,
                                on_step=on_step)
    commits.append(state.last_blocking_s)
    log({"done": step.state.step, "resumed_from": entry["step"],
         "time": time.time(), "commit_blocking_s": commits,
         "world": hvd.size(), "launches": dict(fa.LAUNCHES)})
    hvd.shutdown()


if __name__ == "__main__":
    main()
