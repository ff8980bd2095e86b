"""Keras ``Callback`` classes for distributed ``model.fit``: the port of
``horovod_tpu/tensorflow/callbacks.py`` (reference:
``horovod/_keras/callbacks.py:20-185`` + the thin ``tensorflow.keras.
callbacks`` shims over it).

These are real ``keras.callbacks.Callback`` subclasses, so they plug
straight into ``model.fit(callbacks=[...])`` on Keras 3. When running
against the test fake (which has no keras.callbacks), a minimal base
class with the same hook surface stands in — the hook logic is
identical either way.

* ``BroadcastGlobalVariablesCallback`` — after the first batch (so
  lazily-built variables exist), broadcast model + optimizer variables
  from the root rank. The first-batch timing is the reference's: Keras
  materializes weights during the first ``train_step``.
* ``MetricAverageCallback`` — on epoch end, replace every numeric log
  value with its allreduce-average across ranks, in sorted-key order so
  the wire names agree on every rank.
* ``LearningRateScheduleCallback`` — multiply the initial lr by
  ``multiplier(epoch)`` inside ``[start_epoch, end_epoch)``; staircase
  (first batch of each epoch) or smooth (every batch, fractional
  epoch). With ``momentum_correction``, while the lr is perturbed the
  optimizer's momentum is scaled by ``new_lr / old_lr`` for that batch
  and restored afterwards (Goyal et al., "Accurate, Large Minibatch
  SGD" — keeps the effective update magnitude continuous across lr
  steps).
* ``LearningRateWarmupCallback`` — smooth ramp from ``initial_lr /
  size`` to ``initial_lr`` over ``warmup_epochs`` (same paper).
"""

import numpy as np

import tensorflow as tf

import horovod_tpu_torch.tensorflow as hvd

_KerasCallback = getattr(getattr(getattr(tf, "keras", None), "callbacks",
                                 None), "Callback", None)

if _KerasCallback is None:  # test fake: same hook surface, no keras
    class _KerasCallback:
        model = None
        params = None

        def set_model(self, model):
            self.model = model

        def set_params(self, params):
            self.params = params

        # keras.callbacks.Callback forwards the train-prefixed hooks to
        # the generic ones by default; the shim must do the same
        def on_batch_begin(self, batch, logs=None):
            pass

        def on_batch_end(self, batch, logs=None):
            pass

        def on_train_batch_begin(self, batch, logs=None):
            self.on_batch_begin(batch, logs=logs)

        def on_train_batch_end(self, batch, logs=None):
            self.on_batch_end(batch, logs=logs)


def _get_attr_lr(optimizer):
    # Keras 3 spells it learning_rate; Keras 2 and the fake spell it lr
    return ("learning_rate" if hasattr(optimizer, "learning_rate")
            else "lr")


def _get_lr(optimizer):
    return float(np.asarray(getattr(optimizer, _get_attr_lr(optimizer))))


def _set_lr(optimizer, value):
    # the Keras 3 learning_rate setter assigns through to the backing
    # variable, so this is safe inside a compiled training loop
    setattr(optimizer, _get_attr_lr(optimizer), float(value))


class BroadcastGlobalVariablesCallback(_KerasCallback):
    """Broadcast all model/optimizer variables from ``root_rank`` after
    the first batch (reference ``BroadcastGlobalVariablesCallbackImpl.
    on_batch_end``)."""

    def __init__(self, root_rank=0):
        super().__init__()
        self.root_rank = root_rank
        self.broadcast_done = False

    def on_batch_end(self, batch, logs=None):
        if self.broadcast_done:
            return
        variables = list(getattr(self.model, "variables", None)
                         or getattr(self.model, "weights", []))
        opt = getattr(self.model, "optimizer", None)
        if opt is not None:
            opt_vars = getattr(opt, "variables", None)
            if callable(opt_vars):
                opt_vars = opt_vars()
            variables += list(opt_vars or [])
        hvd.broadcast_variables(variables, root_rank=self.root_rank)
        self.broadcast_done = True


class MetricAverageCallback(_KerasCallback):
    """Average epoch-end metrics across ranks in place (reference
    ``MetricAverageCallbackImpl._average_metrics_in_place``)."""

    def on_epoch_end(self, epoch, logs=None):
        if not logs:
            return
        # sorted order: every rank must enqueue the same wire names in
        # the same set, or negotiation never completes
        for metric in sorted(logs):
            value = logs[metric]
            if isinstance(value, (int, float, np.floating, np.integer)):
                out = hvd.allreduce(
                    tf.convert_to_tensor(np.float64(value)),
                    op=hvd.Average, name=f"metric.{metric}")
                # .reshape(-1)[0]: the non-graph core path widens 0-d
                # tensors to (1,), and float() of a (1,) array is a
                # NumPy deprecation on its way to a TypeError
                logs[metric] = float(np.asarray(out).reshape(-1)[0])


class LearningRateScheduleCallback(_KerasCallback):
    """Scale the lr by ``multiplier(epoch)`` during an epoch window
    (reference ``LearningRateScheduleCallbackImpl``)."""

    def __init__(self, multiplier, start_epoch=0, end_epoch=None,
                 staircase=True, momentum_correction=True,
                 steps_per_epoch=None):
        super().__init__()
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase if callable(multiplier) else True
        self.momentum_correction = momentum_correction
        self.steps_per_epoch = steps_per_epoch
        self.initial_lr = None
        self.restore_momentum = None
        self.current_epoch = None
        self._warned_momentum = False
        self.multiplier = (multiplier if callable(multiplier)
                           else (lambda epoch: multiplier))

    def _steps(self):
        if self.steps_per_epoch:
            return self.steps_per_epoch
        params = self.params or {}
        if params.get("steps"):
            return params["steps"]
        raise ValueError(
            f"{type(self).__name__} needs steps_per_epoch for a smooth "
            "(non-staircase) schedule; pass it explicitly")

    def _adjust(self, epoch):
        opt = self.model.optimizer
        old_lr = _get_lr(opt)
        new_lr = self.initial_lr * self.multiplier(epoch)
        _set_lr(opt, new_lr)
        if not self.momentum_correction or old_lr <= 0:
            return
        momentum = getattr(opt, "momentum", None)
        if momentum is None:
            return
        if hasattr(momentum, "assign"):
            # variable-backed momentum: assignment reaches the compiled
            # train step, so the scale-for-one-batch trick is sound
            self.restore_momentum = float(np.asarray(momentum))
            momentum.assign(self.restore_momentum * new_lr / old_lr)
        elif not self._warned_momentum:
            # Keras 3 stores momentum as a plain float that tf.function
            # bakes into the traced step as a constant — mutating the
            # attribute would either do nothing or permanently trace the
            # perturbed value, so correction is skipped instead
            self._warned_momentum = True
            import warnings
            warnings.warn(
                "momentum_correction skipped: this optimizer's momentum "
                "is a plain Python float (Keras 3), which is baked into "
                "the compiled train step at trace time and cannot be "
                "safely scaled per batch")

    def _restore(self):
        if self.restore_momentum is not None:
            self.model.optimizer.momentum.assign(self.restore_momentum)
            self.restore_momentum = None

    def on_train_begin(self, logs=None):
        self.initial_lr = _get_lr(self.model.optimizer)
        if not self.staircase:
            self.steps_per_epoch = self._steps()

    def on_epoch_begin(self, epoch, logs=None):
        self.current_epoch = epoch

    def on_batch_begin(self, batch, logs=None):
        epoch = self.current_epoch or 0
        if epoch < self.start_epoch or (
                self.end_epoch is not None and epoch >= self.end_epoch):
            return
        if self.staircase:
            if batch == 0:
                self._adjust(epoch)
        else:
            self._adjust(epoch + float(batch) / self.steps_per_epoch)

    def on_batch_end(self, batch, logs=None):
        self._restore()

    def on_epoch_end(self, epoch, logs=None):
        if logs is not None:
            logs["lr"] = _get_lr(self.model.optimizer)


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Smooth warmup from ``initial_lr / size`` to ``initial_lr`` over
    ``warmup_epochs`` (reference ``LearningRateWarmupCallbackImpl``)."""

    def __init__(self, warmup_epochs=5, momentum_correction=True,
                 steps_per_epoch=None, verbose=0):
        def multiplier(epoch):
            # nudge so the ramp lands exactly on 1.0 at the end of the
            # last warmup epoch rather than one batch short
            epoch += 1.0 / self.steps_per_epoch
            size = hvd.size()
            return (1.0 / size) * (epoch * (size - 1) / warmup_epochs + 1)

        super().__init__(multiplier, start_epoch=0,
                         end_epoch=warmup_epochs, staircase=False,
                         momentum_correction=momentum_correction,
                         steps_per_epoch=steps_per_epoch)
        self.verbose = verbose

    def on_epoch_end(self, epoch, logs=None):
        super().on_epoch_end(epoch, logs)
        if epoch == self.end_epoch - 1 and self.verbose:
            print(f"\nEpoch {epoch + 1}: finished learning rate warmup "
                  f"to {_get_lr(self.model.optimizer):g}.")
