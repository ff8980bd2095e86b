"""A function for the programmatic launcher: ``run(probe, np=N)``. It
lives in the package so that it travels by reference where there is no
``cloudpickle``."""


def probe(device=None, scale=1.0):
    """Initialize on ``device`` (None: this rank's card), average
    ``(rank + 1) * scale`` over the ranks in a 4-element tensor, shut
    down. Returns ``(rank, size, device name, averaged values)``."""
    import torch

    import horovod_tpu_torch as hvd
    hvd.init(device=device)
    try:
        dev = hvd.device()
        x = torch.full((4,), (hvd.rank() + 1) * scale, device=dev)
        value = hvd.allreduce(x, op=hvd.Average)
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        return hvd.rank(), hvd.size(), name, value.tolist()
    finally:
        hvd.shutdown()
