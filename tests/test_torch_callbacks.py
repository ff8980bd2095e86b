"""The port's training callbacks and schedules (horovod_tpu_torch/
callbacks.py) against the JAX package's (horovod_tpu/callbacks.py): the
learning rates each sets on the same torch SGD, epoch by epoch and batch
by batch, exactly (the same float arithmetic); the ``LambdaLR`` factors
against the optax schedules within rtol 1e-6 (optax computes in fp32);
the startup broadcast and the metric average on 2 gloo ranks."""

import numpy as np
import pytest
import torch

import horovod_tpu as hvd_j
import horovod_tpu_torch as hvd_t
from horovod_tpu import callbacks as jcallbacks
from horovod_tpu_torch import callbacks
from horovod_tpu_torch.run import api


@pytest.fixture()
def worlds():
    """World 1 on both sides: the port on the CPU, the JAX package on
    one device."""
    import jax
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    hvd_j.shutdown()
    hvd_j.init(devices=jax.devices()[:1])
    yield
    hvd_j.shutdown()
    hvd_t.shutdown()


def _sgd(lr=0.1):
    return torch.optim.SGD([torch.nn.Parameter(torch.zeros(2))], lr=lr,
                           momentum=0.9)


def _drive(warm, sched, epochs=6, steps_per_epoch=None):
    """The rates a loop sets through a warmup and a schedule callback
    (each owning its own optimizer, as a loop over them would)."""
    lrs = []
    for epoch in range(epochs):
        warm.on_epoch_begin(epoch)
        sched.on_epoch_begin(epoch)
        lrs.append(("epoch", sched.optimizer.param_groups[0]["lr"],
                    warm.optimizer.param_groups[0]["lr"]))
        for batch in range(steps_per_epoch or 1):
            warm.on_batch_begin(batch)
            lrs.append(("batch", warm.optimizer.param_groups[0]["lr"]))
    # a fractional epoch, for the schedule's staircase
    sched.on_epoch_begin(epochs + 0.5)
    lrs.append(("half", sched.optimizer.param_groups[0]["lr"]))
    return lrs


SCHEDULES = [
    dict(multiplier=lambda e: 0.5 ** e, start_epoch=3),
    dict(multiplier=0.1, start_epoch=1, end_epoch=4),
    dict(multiplier=lambda e: 1.0 / (1 + e), staircase=False),
]


@pytest.mark.parametrize("steps_per_epoch", [None, 4])
@pytest.mark.parametrize("sched_kw", SCHEDULES)
def test_lr_callbacks_match_jax_world_one(worlds, steps_per_epoch,
                                          sched_kw):
    got = []
    for mod in (callbacks, jcallbacks):
        warm = mod.LearningRateWarmupCallback(
            _sgd(), initial_lr=0.1, warmup_epochs=3,
            steps_per_epoch=steps_per_epoch)
        sched = mod.LearningRateScheduleCallback(_sgd(0.2), **sched_kw)
        got.append(_drive(warm, sched, steps_per_epoch=steps_per_epoch))
    assert got[0] == got[1]
    assert len({x[-1] for x in got[0]}) >= 2


@pytest.mark.parametrize("size,warmup_steps", [(1, 5), (2, 5), (8, 3),
                                               (4, 1), (3, 0)])
def test_warmup_schedule_matches_optax(size, warmup_steps):
    base = 0.05
    ref = jcallbacks.warmup_schedule(base, size=size,
                                     warmup_steps=warmup_steps)
    opt = _sgd(base)
    lambda_lr = torch.optim.lr_scheduler.LambdaLR(
        opt, callbacks.warmup_schedule(size=size, warmup_steps=warmup_steps))
    for step in range(2 * max(warmup_steps, 1) + 1):
        np.testing.assert_allclose(opt.param_groups[0]["lr"],
                                   float(ref(step)), rtol=1e-6)
        opt.step()
        lambda_lr.step()
    assert opt.param_groups[0]["lr"] == pytest.approx(base * size)


@pytest.mark.parametrize("bounds", [{4: 0.1}, {3: 0.5, 6: 0.1},
                                    {6: 0.1, 2: 0.5, 4: 0.0}, {0: 2.0}])
def test_lr_schedule_matches_optax(bounds):
    base = 0.3
    ref = jcallbacks.lr_schedule(base, bounds)
    opt = _sgd(base)
    lambda_lr = torch.optim.lr_scheduler.LambdaLR(
        opt, callbacks.lr_schedule(bounds))
    for step in range(2 * max(bounds) + 1):
        np.testing.assert_allclose(opt.param_groups[0]["lr"],
                                   float(ref(step)), rtol=1e-6)
        opt.step()
        lambda_lr.step()
    with pytest.raises(ValueError, match="non-negative"):
        callbacks.lr_schedule({2: -0.1})


def test_warmup_schedule_takes_the_worlds_size(monkeypatch):
    hvd_t.shutdown()
    assert callbacks.warmup_schedule(warmup_steps=2)(5) == 1.0
    monkeypatch.setattr(callbacks.basics, "is_initialized", lambda: True)
    monkeypatch.setattr(callbacks.basics, "size", lambda: 4)
    assert callbacks.warmup_schedule(warmup_steps=2)(5) == 4.0


def test_callbacks_without_work_pass_through():
    cb = callbacks.Callback()
    assert cb.on_epoch_end(0, {"a": 1}) == {"a": 1}
    assert callbacks.MetricAverageCallback().on_epoch_end(0, {}) == {}
    assert callbacks.BroadcastGlobalVariablesCallback().on_train_begin() \
        == {}


def _make_two_rank_fn():
    # a closure, so that cloudpickle ships it by value: the workers
    # cannot import this test module
    def fn():
        import numpy as np
        import torch

        import horovod_tpu_torch as hvd
        from horovod_tpu_torch import callbacks
        from horovod_tpu_torch.models.simple import MLP

        hvd.init(device="cpu")
        r = hvd.rank()
        # different weights and momentum on each rank before the broadcast
        model = MLP(6, (5, 3), generator=torch.Generator().manual_seed(r))
        opt = torch.optim.SGD(model.parameters(), lr=0.1 * (r + 1),
                              momentum=0.9)
        model(torch.ones(2, 6)).sum().backward()
        opt.step()
        listed = [torch.full((3,), float(r)), torch.arange(4.0) * (r + 1)]
        named = {"b": torch.full((2,), 10.0 + r), "a": torch.tensor(r)}
        callbacks.BroadcastGlobalVariablesCallback(root_rank=0) \
            .on_train_begin({"model": model, "optimizer": opt,
                             "params": listed})
        callbacks.BroadcastGlobalVariablesCallback(root_rank=1) \
            .on_train_begin({"params": named})
        state = {k: v.numpy().copy() for k, v in model.state_dict().items()}
        moments = [opt.state[p]["momentum_buffer"].numpy().copy()
                   for p in model.parameters()]
        averaged = callbacks.MetricAverageCallback().on_epoch_end(0, {
            "loss": float(r + 1), "acc": np.float32(0.25 * r),
            "count": r + 3, "nested": [torch.tensor(2.0 * r), {"n": r}],
            "name": "run-a", "none": None})
        # the warmup to size() times the rate, epoch by epoch and by batch
        lrs = []
        for spe in (None, 3):
            cb = callbacks.LearningRateWarmupCallback(
                opt, initial_lr=0.1, warmup_epochs=2, steps_per_epoch=spe)
            for epoch in range(4):
                cb.on_epoch_begin(epoch)
                for batch in range(spe or 1):
                    cb.on_batch_begin(batch)
                    lrs.append(opt.param_groups[0]["lr"])
        factor = callbacks.warmup_schedule(warmup_steps=4)
        out = dict(rank=r, state=state, moments=moments,
                   lr=opt.param_groups[0]["lr"],
                   listed=[t.numpy() for t in listed],
                   named={k: v.numpy() for k, v in named.items()},
                   averaged=averaged, lrs=lrs,
                   factors=[factor(s) for s in range(6)])
        hvd.shutdown()
        return out

    return fn


def _jax_lrs_at_world_two():
    """The JAX warmup callback's rates with its target as a world of 2
    would set it: ``initial_lr * size()`` is its only use of the size."""
    lrs = []
    for spe in (None, 3):
        opt = _sgd(0.1)
        cb = jcallbacks.LearningRateWarmupCallback(
            opt, initial_lr=0.1, warmup_epochs=2, steps_per_epoch=spe)
        cb.target_lr = 2 * cb.initial_lr
        for epoch in range(4):
            cb.on_epoch_begin(epoch)
            for batch in range(spe or 1):
                cb.on_batch_begin(batch)
                lrs.append(opt.param_groups[0]["lr"])
    return lrs


def test_callbacks_on_two_ranks(worlds):
    """2 gloo ranks under the port's ``run()``: after the broadcast, rank
    1's state dict, optimizer momentum and rate, and its listed tensors
    are rank 0's bit for bit, the named ones rank 1's; the metric average
    is each numeric leaf's mean as a float, strings and None unchanged;
    the warmup rates are the JAX callback's at world 2."""
    r0, r1 = api.run(_make_two_rank_fn(), np=2)
    assert (r0["rank"], r1["rank"]) == (0, 1)
    for k, v in r0["state"].items():
        assert v.tobytes() == r1["state"][k].tobytes(), k
    for a, b in zip(r0["moments"], r1["moments"]):
        assert a.tobytes() == b.tobytes()
    assert r0["lr"] == r1["lr"]
    for a, b in zip(r0["listed"], r1["listed"]):
        assert a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(r0["listed"][0], [0.0] * 3)
    for r in (r0, r1):
        np.testing.assert_array_equal(r["named"]["b"], [11.0, 11.0])
        assert int(r["named"]["a"]) == 1
        assert r["averaged"] == {"loss": 1.5, "acc": 0.125, "count": 3.5,
                                 "nested": [1.0, {"n": 0.5}],
                                 "name": "run-a", "none": None}
        assert all(type(x) is float for x in (
            r["averaged"]["loss"], r["averaged"]["acc"],
            r["averaged"]["nested"][0], r["averaged"]["nested"][1]["n"]))
        assert r["lrs"] == _jax_lrs_at_world_two()
        ref = jcallbacks.warmup_schedule(1.0, size=2, warmup_steps=4)
        np.testing.assert_allclose(r["factors"],
                                   [float(ref(s)) for s in range(6)],
                                   rtol=1e-6)
