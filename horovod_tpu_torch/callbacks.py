"""Training callbacks and learning-rate schedules: the port of
``horovod_tpu/callbacks.py`` (Horovod's Keras callback suite).

* Callback objects with ``on_train_begin``, ``on_epoch_begin``,
  ``on_epoch_end``, ``on_batch_begin`` and ``on_batch_end`` hooks for an
  imperative loop: the startup broadcast, metric averaging, and the
  learning-rate callbacks, which write ``optimizer.param_groups`` (a
  ``torch.optim`` optimizer or the port's ``DistributedOptimizer``).
* ``warmup_schedule`` and ``lr_schedule``, the JAX package's optax
  schedule builders as factor functions for
  ``torch.optim.lr_scheduler.LambdaLR``: the rate at step ``t`` is the
  optimizer's own rate times ``factor(t)``, the optax schedule's value
  at ``t`` when that rate is the schedule's base.
"""

import torch
from torch.utils import _pytree

from horovod_tpu_torch import basics, hvd_torch
from horovod_tpu_torch.ops import collective
from horovod_tpu_torch.parallel import mesh as mesh_lib


class Callback:
    def on_train_begin(self, ctx=None):
        pass

    def on_epoch_begin(self, epoch, ctx=None):
        pass

    def on_epoch_end(self, epoch, metrics=None, ctx=None):
        return metrics

    def on_batch_begin(self, batch, ctx=None):
        pass

    def on_batch_end(self, batch, ctx=None):
        pass


class BroadcastGlobalVariablesCallback(Callback):
    """Broadcast the initial state from ``root_rank`` at train begin.
    ``ctx`` is a dict with any of ``model`` (an ``nn.Module``: its
    ``state_dict``), ``optimizer`` (its state and hyperparameters) and
    ``params`` (a dict or list of tensors); every tensor is overwritten in
    place."""

    def __init__(self, root_rank=0):
        self.root_rank = root_rank

    def on_train_begin(self, ctx=None):
        ctx = ctx or {}
        model = ctx.get("model")
        if model is not None:
            hvd_torch.broadcast_parameters(model.state_dict(),
                                           self.root_rank)
        optimizer = ctx.get("optimizer")
        if optimizer is not None:
            hvd_torch.broadcast_optimizer_state(optimizer, self.root_rank)
        params = ctx.get("params")
        if isinstance(params, dict):
            hvd_torch.broadcast_parameters(params, self.root_rank)
        elif params is not None:
            with torch.no_grad():
                for t in params:
                    collective.broadcast_(t, root_rank=self.root_rank)
        return ctx


class MetricAverageCallback(Callback):
    """Average the epoch's metrics over all ranks
    (``hvd_torch.allreduce_metrics``): each numeric leaf of the nest comes
    back as a Python float, other leaves (strings, None) unchanged."""

    def on_epoch_end(self, epoch, metrics=None, ctx=None):
        if not metrics:
            return metrics
        reduced = hvd_torch.allreduce_metrics(metrics)
        return _pytree.tree_map(
            lambda x: float(x) if torch.is_tensor(x) else x, reduced)


def _set_lr(optimizer, lr):
    for group in optimizer.param_groups:
        group["lr"] = lr


class LearningRateWarmupCallback(Callback):
    """Ramp the rate from ``initial_lr`` to ``initial_lr`` times the
    data-parallel replicas over the first ``warmup_epochs``: the
    linear-scaling warmup of Goyal et al. The replicas are the ranks
    across the installed mesh's data axes: ``size()`` on ``init()``'s
    1-D mesh, ``D`` on a (data D, seq S) mesh, whose seq axis adds no
    samples to the batch. With ``steps_per_epoch`` the rate moves every
    batch, else every epoch."""

    def __init__(self, optimizer, initial_lr, warmup_epochs=5,
                 steps_per_epoch=None, verbose=False):
        data = mesh_lib.data_axis_names()
        self.optimizer = optimizer
        self.initial_lr = initial_lr
        self.target_lr = initial_lr * (collective.mesh_size(data) if data
                                       else 1)
        self.warmup_epochs = warmup_epochs
        self.steps_per_epoch = steps_per_epoch
        self.verbose = verbose
        self._epoch = 0

    def _lr_at(self, progress):
        if progress >= self.warmup_epochs:
            return self.target_lr
        frac = progress / self.warmup_epochs
        return self.initial_lr + (self.target_lr - self.initial_lr) * frac

    def on_epoch_begin(self, epoch, ctx=None):
        self._epoch = epoch
        if self.steps_per_epoch is None:
            _set_lr(self.optimizer, self._lr_at(epoch))

    def on_batch_begin(self, batch, ctx=None):
        if self.steps_per_epoch is not None:
            _set_lr(self.optimizer,
                    self._lr_at(self._epoch + batch / self.steps_per_epoch))


class LearningRateScheduleCallback(Callback):
    """Set the rate to the optimizer's rate at construction times
    ``multiplier(epoch)`` (or a constant multiplier) from ``start_epoch``
    up to ``end_epoch``; ``staircase`` takes whole epochs."""

    def __init__(self, optimizer, multiplier, start_epoch=0, end_epoch=None,
                 staircase=True):
        self.optimizer = optimizer
        self.multiplier = (multiplier if callable(multiplier)
                           else (lambda _: multiplier))
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.base_lr = optimizer.param_groups[0]["lr"]

    def on_epoch_begin(self, epoch, ctx=None):
        if epoch < self.start_epoch:
            return
        if self.end_epoch is not None and epoch >= self.end_epoch:
            return
        e = int(epoch) if self.staircase else epoch
        _set_lr(self.optimizer, self.base_lr * self.multiplier(e))


# ---------------------------------------------------------------------------
# LambdaLR factors: the JAX package's optax schedules
# ---------------------------------------------------------------------------


def warmup_schedule(size=None, warmup_steps=1000):
    """``LambdaLR`` factor of ``optax.join_schedules([linear_schedule(base,
    base * size, warmup_steps), constant_schedule(base * size)],
    [warmup_steps])``: a linear ramp from 1 to ``size``, then ``size``.
    ``size`` defaults to the world's size (1 before ``init()``)."""
    if size is None:
        size = basics.size() if basics.is_initialized() else 1

    def factor(step):
        if step >= warmup_steps:
            return float(size)
        return (1.0 - size) * (1.0 - step / warmup_steps) + size

    return factor


def lr_schedule(boundaries_and_scales):
    """``LambdaLR`` factor of ``optax.piecewise_constant_schedule(base,
    boundaries_and_scales)``: the product of the scales of every boundary
    ``b`` with ``step >= b``, e.g. ``{30_000: 0.1, 60_000: 0.1}``."""
    items = sorted(boundaries_and_scales.items())
    if any(scale < 0 for _, scale in items):
        raise ValueError("lr_schedule expects non-negative scale factors")

    def factor(step):
        v = 1.0
        for boundary, scale in items:
            if step >= boundary:
                v *= scale
        return v

    return factor
