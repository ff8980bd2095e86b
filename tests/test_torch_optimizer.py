"""The port's ``DistributedOptimizer`` as a ``torch.optim.Optimizer``
(horovod_tpu_torch/hvd_torch.py): ``param_groups``, ``state``,
``defaults``, ``state_dict`` and ``load_state_dict`` are the inner
optimizer's, as Horovod's torch optimizer (``horovod_tpu/torch``)
delegates them, so torch's learning-rate schedulers and the JAX
package's callbacks, which write ``optimizer.param_groups``, drive it;
under ZeRO-1 the state dict carries this rank's rows.

CPU, world 1, numpy-seeded inputs. Learning rates are compared exactly
(the same float arithmetic on both sides); parameters after a restored
step bit for bit (the same operations on the same values).
"""

import copy

import numpy as np
import pytest
import torch

import horovod_tpu as hvd_j
import horovod_tpu_torch as hvd_t
from horovod_tpu import basics as jbasics
from horovod_tpu import callbacks as jcallbacks
from horovod_tpu_torch import convert
from horovod_tpu_torch import training as t_training
from horovod_tpu_torch.models.simple import MLP

IN, FEATURES = 6, (10, 7, 3)


@pytest.fixture()
def cpu_world():
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    yield hvd_t
    hvd_t.shutdown()


def _data(seed=0, n=8):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((n, IN)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, FEATURES[-1], size=(n,))))


def _opt(model, sharded=False, kind="adamw", lr=1e-2):
    inner = (torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=1e-4)
             if kind == "adamw" else
             torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9))
    return hvd_t.DistributedOptimizer(
        inner, named_parameters=convert.flax_named_parameters(model),
        sharded_update=sharded)


@pytest.mark.parametrize("sharded", [False, True])
def test_is_a_torch_optimizer_and_delegates(cpu_world, sharded):
    model = MLP(IN, FEATURES)
    opt = _opt(model, sharded)
    assert isinstance(opt, torch.optim.Optimizer)
    assert opt.param_groups is opt.optimizer.param_groups
    assert opt.state is opt.optimizer.state
    assert opt.defaults is opt.optimizer.defaults
    with pytest.raises(ValueError, match="fixed parameter list"):
        opt.add_param_group({"params": [torch.nn.Parameter(torch.ones(1))]})


@pytest.mark.parametrize("sharded", [False, True])
def test_step_lr_drives_the_update(cpu_world, sharded):
    """``StepLR`` halves the learning rate every step; the update each
    step (ZeRO-1's row optimizer included) takes the scheduled rate:
    against a plain torch AdamW under the same scheduler."""
    x, y = _data()
    model = MLP(IN, FEATURES)
    ref_model = copy.deepcopy(model)
    opt = _opt(model, sharded)
    ref = torch.optim.AdamW(ref_model.parameters(), lr=1e-2,
                            weight_decay=1e-4)
    sched = torch.optim.lr_scheduler.StepLR(opt, 1, gamma=0.5)
    ref_sched = torch.optim.lr_scheduler.StepLR(ref, 1, gamma=0.5)
    step = t_training.make_train_step(model, opt)
    lrs = []
    for _ in range(4):
        step(x, y)
        ref.zero_grad()
        t_training.softmax_cross_entropy(ref_model(x), y).backward()
        ref.step()
        sched.step()
        ref_sched.step()
        lrs.append(opt.param_groups[0]["lr"])
    assert lrs == [5e-3, 2.5e-3, 1.25e-3, 6.25e-4]
    if sharded:
        assert opt.zero_state.inner.param_groups[0]["lr"] == 1.25e-3
    for p, q in zip(model.parameters(), ref_model.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("steps_per_epoch", [None, 4])
def test_jax_warmup_callback_sets_the_ports_learning_rate(
        cpu_world, monkeypatch, steps_per_epoch):
    """The JAX package's ``LearningRateWarmupCallback`` and
    ``LearningRateScheduleCallback`` write ``param_groups``: on the
    port's optimizer they set the same rates as on a plain torch one,
    epoch by epoch and batch by batch, and the port's next step takes
    the rate they set. The warmup ramps to the rate times the world
    size, taken as 4 here."""
    hvd_j.shutdown()
    hvd_j.init()
    monkeypatch.setattr(jbasics, "size", lambda: 4)
    try:
        model = MLP(IN, FEATURES)
        opts = [_opt(model, kind="sgd", lr=0.1),
                torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)]
        seen = []
        for opt in opts:
            warm = jcallbacks.LearningRateWarmupCallback(
                opt, initial_lr=0.1, warmup_epochs=3,
                steps_per_epoch=steps_per_epoch)
            decay = jcallbacks.LearningRateScheduleCallback(
                opt, multiplier=lambda e: 0.5 ** e, start_epoch=3)
            lrs = []
            for epoch in range(5):
                warm.on_epoch_begin(epoch)
                decay.on_epoch_begin(epoch)
                for batch in range(steps_per_epoch or 1):
                    warm.on_batch_begin(batch)
                    lrs.append(opt.param_groups[0]["lr"])
            seen.append(lrs)
        assert seen[0] == seen[1]
        # the ramp from 0.1 towards 0.4, then the schedule's decay
        assert seen[0][0] == 0.1 and 0.2 in seen[0]
        assert len(set(seen[0])) >= 4
        # the rate the callbacks left is the one the next step applies
        x, y = _data()
        opt = opts[0]
        before = [p.detach().clone() for p in model.parameters()]
        t_training.make_train_step(model, opt)(x, y)
        lr = opt.param_groups[0]["lr"]
        assert lr == seen[0][-1]
        for p, b in zip(model.parameters(), before):
            # SGD's first step moves by lr * g, up to fp32 rounding of p
            np.testing.assert_allclose((b - p).detach().numpy(),
                                       lr * p.grad.numpy(), rtol=1e-5,
                                       atol=1e-7)
    finally:
        hvd_j.shutdown()


@pytest.mark.parametrize("kind", ["adamw", "sgd"])
@pytest.mark.parametrize("sharded", [False, True])
def test_state_dict_round_trip(cpu_world, kind, sharded):
    """``state_dict()`` (with this rank's ZeRO-1 rows under ``"zero"``)
    loads into a fresh optimizer over a copy of the model; the next step
    then equals the original's bit for bit."""
    x, y = _data()
    model = MLP(IN, FEATURES)
    opt = _opt(model, sharded, kind)
    step = t_training.make_train_step(model, opt)
    for _ in range(3):
        step(x, y)
    sd = copy.deepcopy(opt.state_dict())
    assert ("zero" in sd) == sharded
    if sharded:
        assert (sd["zero"]["rank"], sd["zero"]["world"]) == (0, 1)
        assert len(sd["zero"]["state"]["state"]) == len(
            opt.zero_state.rows)
    model2 = copy.deepcopy(model)
    opt2 = _opt(model2, sharded, kind)
    opt2.load_state_dict(sd)
    step2 = t_training.make_train_step(model2, opt2)
    step(x, y)
    step2(x, y)
    for p, q in zip(model.parameters(), model2.parameters()):
        assert torch.equal(p, q)
    with pytest.raises(ValueError, match="ZeRO-1 rows"):
        _opt(MLP(IN, FEATURES), not sharded, kind).load_state_dict(sd)


def test_zero_rows_of_another_world_are_refused(cpu_world):
    model = MLP(IN, FEATURES)
    opt = _opt(model, True)
    sd = opt.state_dict()
    sd["zero"]["world"] = 2
    with pytest.raises(ValueError, match="reshards"):
        opt.load_state_dict(sd)
