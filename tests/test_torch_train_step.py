"""The port's data-parallel LM train step (horovod_tpu_torch/training.py,
hvd_torch.DistributedOptimizer, ops/fusion.py) against the JAX package's
``make_lm_train_step`` with the same weights and tokens.

The JAX side runs on a 1-device mesh with
``DistributedOptimizer(optax.adamw(lr, weight_decay=1e-4))``, the port on
a gloo world of 1 on the CPU with ``AdamW`` at the same settings (torch's
default decay is 1e-2, optax's 1e-4: both are stated). fp32 throughout.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu_torch as hvd_t
from horovod_tpu import hvd_jax, training
from horovod_tpu.models.transformer import Transformer as JTransformer
from horovod_tpu.models.transformer import TransformerConfig as JConfig
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu_torch import convert
from horovod_tpu_torch import training as t_training
from horovod_tpu_torch.models.transformer import Transformer, TransformerConfig
from horovod_tpu_torch.ops import fusion as tfusion

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTHS = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32,
              d_ff=128)
LR = 1e-3


@pytest.fixture()
def cpu_world():
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    yield hvd_t
    hvd_t.shutdown()


def test_three_steps_match_jax(cpu_world):
    """Per-step losses agree to fp32 summation order (rtol 1e-5). Params
    after step 1: AdamW's first update is about lr * sign(g), so a
    gradient near zero can move its update by up to lr * |dg| / eps; the
    bound 1e-6 is lr / 1000."""
    tokens = np.random.default_rng(0).integers(
        0, WIDTHS["vocab_size"], size=(4, 32)).astype(np.int32)
    jcfg = JConfig(**WIDTHS, dtype=jnp.float32, flash_attention=False)
    tx = hvd_jax.DistributedOptimizer(optax.adamw(LR, weight_decay=1e-4),
                                      axes=("data",))
    state = training.create_train_state(JTransformer(jcfg), tx,
                                        jax.random.PRNGKey(0),
                                        jnp.asarray(tokens[:1]))
    params0 = jax.tree_util.tree_map(np.asarray, state.params)
    mesh1 = jax.sharding.Mesh(np.asarray(jax.devices()[:1]), ("data",))
    jstep = training.make_lm_train_step(JTransformer(jcfg), tx, mesh=mesh1,
                                        donate=False)

    # the port runs its flash path (plain versions on the CPU) against
    # JAX's dense path: both compute the same attention
    tcfg = TransformerConfig(**WIDTHS, dtype=torch.float32,
                             flash_attention=True)
    model = Transformer(tcfg)
    model.load_state_dict(convert.params_from_flax(params0, tcfg))
    opt = hvd_t.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=1e-4),
        named_parameters=model.named_parameters())
    t_training.create_train_state(model, opt)
    tstep = t_training.make_lm_train_step(model, opt)

    for i in range(3):
        state, j_loss = jstep(state, jnp.asarray(tokens))
        t_loss = tstep(torch.from_numpy(tokens).long())
        np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-5)
        if i == 0:
            got = convert.flax_from_params(model.state_dict(), tcfg)
            jax.tree_util.tree_map(
                lambda a, b: np.testing.assert_allclose(a, np.asarray(b),
                                                        atol=1e-6),
                got, state.params)
    assert len(opt.last_buckets) == 1  # 0.1 MB of fp32 grads, one bucket


@pytest.mark.parametrize("threshold", [64, 4096, 30_000, 64 << 20])
def test_plan_buckets_matches_jax(threshold):
    """The same greedy, dtype-homogeneous packing on the same leaves:
    the LM's parameter leaves in flax order, plus bf16 and int leaves."""
    params = JTransformer(JConfig(**WIDTHS, dtype=jnp.float32)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]
    leaves[3:3] = [np.zeros((5, 7), jnp.bfloat16), np.zeros(9, np.int32)]
    leaves.append(np.zeros((300,), jnp.bfloat16))
    jb = jfusion.plan_buckets(leaves, threshold)
    tb = tfusion.plan_buckets(
        [torch.from_numpy(np.array(x, np.float32)).to(
            {np.dtype(np.float32): torch.float32,
             np.dtype(jnp.bfloat16): torch.bfloat16,
             np.dtype(np.int32): torch.int32}[x.dtype]) for x in leaves],
        threshold)
    assert len(jb) == len(tb) > 0
    for a, b in zip(jb, tb):
        assert a.leaf_indices == b.leaf_indices
        assert a.sizes == b.sizes and a.shapes == b.shapes
        assert np.dtype(a.dtype).itemsize == b.dtype.itemsize


def test_fused_allreduce_roundtrip_keeps_shapes(cpu_world):
    ts = [torch.arange(6.0).reshape(2, 3), torch.ones(4, dtype=torch.int32),
          torch.full((5,), 2.0)]
    before = [t.clone() for t in ts]
    buckets = hvd_t.fused_allreduce_(ts, op=hvd_t.Sum, threshold_bytes=32)
    assert len(buckets) == 3  # 24 B + 20 B of fp32 split at 32 B; one int
    for t, b in zip(ts, before):
        assert torch.equal(t, b)  # world of 1: the sum is the tensor


_WORKER = textwrap.dedent("""
    import json, torch
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    r = hvd.rank()
    torch.manual_seed(r)  # replicas start different ...
    lin = torch.nn.Linear(3, 2, bias=False)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=1.0),
                                   named_parameters=lin.named_parameters())
    hvd.broadcast_parameters(lin.state_dict(), root_rank=0)  # ... then not
    w0 = lin.weight.detach().clone()
    lin.weight.grad = torch.full((2, 3), float(r + 1))  # ranks differ
    opt.step()
    mx = hvd.allreduce(torch.tensor([float(r)]), op=hvd.Max).item()
    sm = hvd.allreduce(torch.tensor([float(r)]), op=hvd.Sum).item()
    g = hvd.allgather(torch.tensor([r]))
    print("RESULT", json.dumps([r, (w0 - lin.weight).tolist(),
                                w0.sum().item(), mx, sm, g.tolist()]),
          flush=True)
    hvd.shutdown()
""")


def test_distributed_optimizer_averages_across_two_processes():
    """Two gloo ranks with different gradients step to the same weights:
    w - lr * mean(g) = w - 1.5, from rank 0's broadcast weights."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(2):
        env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE="2",
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        line = [x for x in out.splitlines() if x.startswith("RESULT")][0]
        results.append(json.loads(line.split(" ", 1)[1]))
    for r, (rank, delta, w0sum, mx, sm, gathered) in enumerate(
            sorted(results)):
        assert rank == r
        np.testing.assert_allclose(delta, np.full((2, 3), 1.5))
        assert mx == 1.0 and sm == 1.0 and gathered == [0, 1]
    assert results[0][2] == results[1][2]  # same broadcast weights


def _convnet_run(steps, resume_at=None, tmp=None, keep_count=True):
    """The MNISTConvNet trained ``steps`` steps (SGD with momentum, 2
    microbatches, dropout in training mode) on a fixed batch; with
    ``resume_at`` the run saves at that step through ``ckpt``, and a
    fresh model, optimizer and step restore it and go on. Returns each
    microbatch's local loss and the final parameters. ``keep_count=False``
    restarts the step count at 0 after the restore, as a count that a
    checkpoint does not carry would."""
    from horovod_tpu_torch import ckpt
    from horovod_tpu_torch.models.simple import MNISTConvNet
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((4, 8, 8, 1)).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, 10, size=(4,)))
    local = []

    def loss_fn(logits, labels):
        loss = t_training.softmax_cross_entropy(logits, labels)
        local.append(loss.item())
        return loss

    def build():
        model = MNISTConvNet(image_shape=(8, 8, 1))
        opt = hvd_t.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
            named_parameters=convert.flax_named_parameters(model))
        return model, opt, t_training.make_train_step(
            model, opt, loss_fn=loss_fn, dropout_seed=7, accum_steps=2)

    model, opt, step = build()
    for i in range(steps):
        if i == resume_at:
            ckpt.save_sharded(tmp, i, convert.train_state_to_flat(
                model, opt, step.state))
            model, opt, step = build()  # a new process would start so
            target = convert.train_state_to_flat(model, opt, step.state)
            _, flat, _ = ckpt.restore_sharded(tmp, target)
            convert.train_state_from_flat(model, opt, step.state, flat)
            assert step.state.step == resume_at
            if not keep_count:
                step.state.step = 0
        step(x, y)
    return local, [p.detach().clone() for p in model.parameters()]


def test_dropout_masks_survive_a_restore(cpu_world, tmp_path):
    """The dropout stream is keyed by the checkpointed step count
    (``StepState``, the JAX ``TrainState.step``), not by the step
    builder's own calls: 4 steps with a save and restore after 2 draw the
    masks of 4 unbroken steps, so losses and parameters equal them bit
    for bit; a restore that lost the count (step 0) draws step 0's masks
    again and does not."""
    unbroken, p_unbroken = _convnet_run(4)
    resumed, p_resumed = _convnet_run(4, resume_at=2, tmp=str(tmp_path))
    assert resumed == unbroken
    for a, b in zip(p_resumed, p_unbroken):
        assert torch.equal(a, b)
    # each step and microbatch drew its own masks
    assert len(set(unbroken)) == len(unbroken) == 8
    # a count restarted at 0 replays step 0's masks on step 2's weights
    lost, _ = _convnet_run(4, resume_at=2, tmp=str(tmp_path / "lost"),
                           keep_count=False)
    assert lost[:4] == unbroken[:4] and lost[4:] != unbroken[4:]
