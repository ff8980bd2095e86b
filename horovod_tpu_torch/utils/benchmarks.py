"""The LM benchmark workload, built one way (the port of
``horovod_tpu/utils/benchmarks.py``'s ``make_lm_bench`` and ``sync``),
and timing on the card with CUDA events."""

import numpy as np
import torch


def sync():
    """Wait until the card has finished all queued work."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def make_lm_bench(*, batch, seq_len, layers, d_model, heads, vocab, flash,
                  dtype=torch.bfloat16, lr=3e-4, weight_decay=1e-4, seed=0,
                  sharded_update=False):
    """The LM benchmark: the transformer LM at the given widths, AdamW
    through ``DistributedOptimizer`` on the data axis (its buckets packed
    in the flax leaf order; ZeRO-1 with ``sharded_update``), and a seeded
    batch of this rank's ``batch`` sequences. ``init()`` must have run.
    Returns ``(step, model, optimizer, tokens)``; ``step(tokens)``
    returns the averaged loss."""
    from horovod_tpu_torch import basics, convert, hvd_torch, training
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)

    device = basics.device()
    cfg = TransformerConfig(vocab_size=vocab, num_layers=layers,
                            num_heads=heads, d_model=d_model,
                            d_ff=4 * d_model, dtype=dtype,
                            flash_attention=flash)
    model = Transformer(cfg, generator=torch.Generator().manual_seed(seed),
                        device=device)
    # optax.adamw's defaults, with the decay stated (torch's is 1e-2)
    inner = torch.optim.AdamW(model.parameters(), lr=lr,
                              betas=(0.9, 0.999), eps=1e-8,
                              weight_decay=weight_decay)
    opt = hvd_torch.DistributedOptimizer(
        inner, named_parameters=convert.flax_named_parameters(model),
        sharded_update=sharded_update)
    training.create_train_state(model, opt)
    rng = np.random.default_rng(seed + basics.rank())
    tokens = torch.from_numpy(
        rng.integers(0, vocab, size=(batch, seq_len)).astype(np.int64)
    ).to(device)
    return training.make_lm_train_step(model, opt), model, opt, tokens


def cuda_time_ms(fn, iters=10, warmup=2):
    """Milliseconds of one ``fn()`` on the card: the median over 3 rounds
    of the time of ``iters`` calls made back to back between one pair of
    CUDA events, over ``iters``. The host enqueues ahead of the card, so
    a call's launch overhead on the host is hidden whenever the call
    takes longer on the card than on the host."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))
