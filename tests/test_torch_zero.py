"""The port's microbatched, overlapped train step and ZeRO-1
(horovod_tpu_torch/training.py ``make_train_step``, parallel/zero.py,
hvd_torch.DistributedOptimizer's ``sharded_update`` and
``backward_passes_per_step``) against the JAX package's, with the same
weights (carried over by convert.py) and the same numpy-seeded data.

The JAX side runs on a mesh of the conftest's CPU devices, the port on a
gloo world of the same size on the CPU: in this process at world 1, in
two spawned processes at world 2, each rank on its own shard of the
batch. fp32 throughout, AdamW at lr 1e-3 with the decay stated (optax's
1e-4; torch's default is 1e-2). Losses agree to rtol 1e-5 (summation
order); parameters after 3 steps to atol 1e-6: AdamW's first updates
are about lr * sign(g), so a gradient near zero can move its update by
up to lr * |dg| / eps, and 1e-6 is lr / 1000.

The MLP is (6 -> 10 -> 7 -> 3): 171 parameters, odd, so every bucket
of the world-2 schedule carries a padding element. Besides the 8 cases of
{accum 1, 2} x {plain, overlap} x {replicated, sharded}, one case takes
the plain path with ``backward_passes_per_step=2`` (4 steps: two rounds of
the optimizer's own accumulator).
"""

import itertools
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

import horovod_tpu as hvd_j
import horovod_tpu_torch as hvd_t
from horovod_tpu import training
from horovod_tpu.models.simple import MLP as JMLP
from horovod_tpu.models.transformer import Transformer as JTransformer
from horovod_tpu.models.transformer import TransformerConfig as JConfig
from horovod_tpu_torch import convert
from horovod_tpu_torch import training as t_training
from horovod_tpu_torch.models.simple import MLP, MNISTConvNet
from horovod_tpu_torch.models.transformer import Transformer, TransformerConfig
from horovod_tpu_torch.parallel import zero

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, WD = 1e-3, 1e-4
STEPS = 3
IN, FEATURES = 6, (10, 7, 3)
BATCH = 8  # global: 4 per rank at world 2, 2 per microbatch at accum 2
# (accum_steps, overlap_grads, sharded_update, backward_passes_per_step)
CASES = [c + (1,) for c in
         itertools.product((1, 2), (False, True), (False, True))]
CASES.append((1, False, False, 2))
LM_WIDTHS = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32,
                 d_ff=128)


def _ids(case):
    accum, overlap, sharded, passes = case
    return (f"accum{accum}-{'overlap' if overlap else 'plain'}-"
            f"{'sharded' if sharded else 'replicated'}"
            + (f"-passes{passes}" if passes > 1 else ""))


def _steps(case):
    return 4 if case[3] > 1 else STEPS


def _mlp_data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, IN)).astype(np.float32)
    y = rng.integers(0, FEATURES[-1], size=(BATCH,)).astype(np.int32)
    return x, y


@pytest.fixture()
def jax_world():
    """A JAX mesh of the first ``n`` CPU devices, installed as the
    package's mesh (ZeRO plans read it)."""
    def make(n):
        hvd_j.shutdown()
        hvd_j.init(devices=jax.devices()[:n])
        return hvd_j.mesh()
    yield make
    hvd_j.shutdown()


@pytest.fixture()
def cpu_world():
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    yield hvd_t
    hvd_t.shutdown()


def _jax_mlp_run(mesh, case, x, y):
    """Initial params, per-step losses and final params of the JAX
    ``make_train_step`` on ``mesh``."""
    accum, overlap, sharded, passes = case
    tx = hvd_j.DistributedOptimizer(optax.adamw(LR, weight_decay=WD),
                                    sharded_update=sharded,
                                    backward_passes_per_step=passes)
    model = JMLP(features=FEATURES)
    state = training.create_train_state(model, tx, jax.random.PRNGKey(0),
                                        jnp.asarray(x[:1]))
    params0 = jax.tree_util.tree_map(np.asarray, state.params)
    step = training.make_train_step(model, tx, mesh=mesh, donate=False,
                                    accum_steps=accum, overlap_grads=overlap)
    losses = []
    for _ in range(_steps(case)):
        state, loss = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    return params0, losses, jax.tree_util.tree_map(np.asarray, state.params)


def _torch_mlp_run(case, params0, x, y):
    """The port's run on this rank's shard of ``x``/``y``; returns the
    losses, the final flax-layout params and the optimizer."""
    accum, overlap, sharded, passes = case
    model = MLP(IN, FEATURES)
    model.load_state_dict(convert.params_from_flax(params0, model))
    opt = hvd_t.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=WD),
        named_parameters=convert.flax_named_parameters(model),
        sharded_update=sharded, backward_passes_per_step=passes)
    t_training.create_train_state(model, opt)
    step = t_training.make_train_step(model, opt, accum_steps=accum,
                                      overlap_grads=overlap)
    world, rank = hvd_t.size(), hvd_t.rank()
    n = BATCH // world
    xs = torch.from_numpy(x[rank * n:(rank + 1) * n])
    ys = torch.from_numpy(y[rank * n:(rank + 1) * n]).long()
    losses = [float(step(xs, ys)) for _ in range(_steps(case))]
    return losses, convert.flax_from_params(model.state_dict(), model), opt


def _assert_matches(losses, params, j_losses, j_params):
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(np.asarray(a), b, atol=1e-6),
        j_params, params)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_make_train_step_matches_jax_world_one(cpu_world, jax_world, case):
    x, y = _mlp_data()
    params0, j_losses, j_params = _jax_mlp_run(jax_world(1), case, x, y)
    losses, params, opt = _torch_mlp_run(case, params0, x, y)
    _assert_matches(losses, params, j_losses, j_params)
    if case[1] or case[2]:
        assert len(opt.params) == 6  # 3 Dense layers, kernel and bias


def _dropout_losses():
    """This rank's local loss of each microbatch over 2 steps of the
    MNISTConvNet in training mode, at lr 0, with every rank and
    microbatch on the same images: they differ only by their dropout
    masks."""
    model = MNISTConvNet(image_shape=(8, 8, 1))
    opt = hvd_t.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.0))
    local = []

    def loss_fn(logits, labels):
        loss = t_training.softmax_cross_entropy(logits, labels)
        local.append(loss.item())
        return loss

    step = t_training.make_train_step(model, opt, loss_fn=loss_fn,
                                      dropout_seed=3, accum_steps=2)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 8, 8, 1)).astype(np.float32)).repeat(2, 1, 1, 1)
    y = torch.tensor([1, 4, 1, 4])
    for _ in range(2):
        step(x, y)
    return local


_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    sys.path.insert(0, {tests!r})
    import horovod_tpu_torch as hvd
    import test_torch_zero as t
    from horovod_tpu_torch.parallel import zero
    hvd.init(device="cpu")
    data = np.load(sys.argv[1], allow_pickle=True)
    x, y, params0 = data["x"], data["y"], data["params0"].item()
    out = {{}}
    for case in t.CASES:
        losses, params, opt = t._torch_mlp_run(case, params0, x, y)
        out[t._ids(case)] = dict(
            losses=losses,
            params={{k: {{n: v.tolist() for n, v in d.items()}}
                     for k, d in params.items()}},
            state_bytes=(zero.local_state_bytes(opt.zero_state)
                         if case[2] else None))
    out["dropout"] = t._dropout_losses()
    print("RESULT", json.dumps([hvd.rank(), out]), flush=True)
    hvd.shutdown()
""")


def _run_ranks(src, world, args):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(world):
        env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE=str(world),
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", src, *args], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][0]
        results.append(json.loads(line.split(" ", 1)[1]))
    return [r[1] for r in sorted(results, key=lambda r: r[0])]


def test_make_train_step_matches_jax_world_two(jax_world, tmp_path):
    """Every case at world 2: each rank on its half of the batch against
    the JAX step on a 2-device mesh; both ranks end with the same params;
    ZeRO-1 state per rank is half of world 1's; each rank and microbatch
    draws its own dropout masks."""
    x, y = _mlp_data()
    mesh = jax_world(2)
    want, params0 = {}, None
    for case in CASES:
        params0, j_losses, j_params = _jax_mlp_run(mesh, case, x, y)
        want[_ids(case)] = (j_losses, j_params)
    path = tmp_path / "data.npz"
    np.savez(path, x=x, y=y, params0=np.array(params0, dtype=object))
    ranks = _run_ranks(_WORKER.format(tests=os.path.join(REPO, "tests")),
                       2, [str(path)])

    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    try:
        _, _, opt1 = _torch_mlp_run((1, False, True, 1), params0, x, y)
        bytes1 = zero.local_state_bytes(opt1.zero_state)
    finally:
        hvd_t.shutdown()
    for case in CASES:
        j_losses, j_params = want[_ids(case)]
        for got in ranks:
            got = got[_ids(case)]
            _assert_matches(got["losses"], got["params"], j_losses,
                            j_params)
        if case[2]:
            # AdamW's exp_avg and exp_avg_sq over 86 of 172 padded
            # elements a rank, plus one 4-byte step per bucket row
            b2 = ranks[0][_ids(case)]["state_bytes"]
            assert ranks[1][_ids(case)]["state_bytes"] == b2
            assert bytes1 == 2 * 4 * 171 + 4
            assert b2 == 2 * 4 * 86 + 4
    # 2 ranks x 2 steps x 2 microbatches of one loss on the same images
    # and weights: 8 different losses, 8 different mask draws
    losses = ranks[0]["dropout"] + ranks[1]["dropout"]
    assert len(losses) == 8 and len(set(losses)) == 8, losses


def test_dropout_streams_are_seeded(cpu_world):
    """The same seed draws the same masks again (at world 1)."""
    assert _dropout_losses() == _dropout_losses()


@pytest.mark.parametrize("kind", ["sharded_update", "backward_passes_2"])
def test_lm_step_matches_jax(cpu_world, jax_world, kind):
    """``make_lm_train_step`` with a ZeRO-1 optimizer, and with gradients
    accumulated over two calls (a running mean, applied on the second,
    as optax.MultiSteps does), against the JAX step through ``tx.update``;
    4 steps, so the accumulator takes two full rounds."""
    tokens = np.random.default_rng(0).integers(
        0, LM_WIDTHS["vocab_size"], size=(4, 32)).astype(np.int32)
    jcfg = JConfig(**LM_WIDTHS, dtype=jnp.float32, flash_attention=False)
    tcfg = TransformerConfig(**LM_WIDTHS, dtype=torch.float32,
                             flash_attention=True)
    kw = (dict(sharded_update=True) if kind == "sharded_update"
          else dict(backward_passes_per_step=2))
    mesh = jax_world(1)
    tx = hvd_j.DistributedOptimizer(optax.adamw(LR, weight_decay=WD), **kw)
    state = training.create_train_state(JTransformer(jcfg), tx,
                                        jax.random.PRNGKey(0),
                                        jnp.asarray(tokens[:1]))
    params0 = jax.tree_util.tree_map(np.asarray, state.params)
    jstep = training.make_lm_train_step(JTransformer(jcfg), tx, mesh=mesh,
                                        donate=False)

    model = Transformer(tcfg)
    model.load_state_dict(convert.params_from_flax(params0, tcfg))
    opt = hvd_t.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=WD),
        named_parameters=convert.flax_named_parameters(model), **kw)
    t_training.create_train_state(model, opt)
    tstep = t_training.make_lm_train_step(model, opt)
    prev = params0
    for i in range(4):
        state, j_loss = jstep(state, jnp.asarray(tokens))
        t_loss = tstep(torch.from_numpy(tokens).long())
        np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-5)
        got = convert.flax_from_params(model.state_dict(), tcfg)
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, np.asarray(b),
                                                    atol=1e-6),
            got, state.params)
        if kind == "backward_passes_2" and i % 2 == 0:
            # the first call of a round only accumulates
            jax.tree_util.tree_map(np.testing.assert_array_equal, got, prev)
        prev = got
    if kind == "sharded_update":
        assert len(opt.zero_state.plan.schedule.buckets) == 1


def _adamw(model):
    return torch.optim.AdamW(model.parameters(), lr=LR)


def _opt(model, **kw):
    return hvd_t.DistributedOptimizer(_adamw(model), **kw)


def _step_with_indivisible_batch(model):
    step = t_training.make_train_step(model, _opt(model), accum_steps=3)
    step(torch.zeros(4, IN), torch.zeros(4, dtype=torch.long))


def _wire_env_step(model):
    opt = _opt(model)
    model(torch.zeros(2, IN)).sum().backward()
    opt.step()


def _wire_env_overlap(sharded):
    """The overlapped pipeline resolves the wire format when it is built
    (it never calls ``step()``)."""
    return lambda m: t_training.make_train_step(
        m, _opt(m, sharded_update=sharded), overlap_grads=True)


def _wire_env_preaveraged(model):
    """``update_preaveraged`` exchanges nothing, so it does not resolve
    the wire format; the next exchange does."""
    opt = _opt(model)
    model(torch.zeros(2, IN)).sum().backward()
    opt.update_preaveraged()
    opt.step()


class _BatchNormNet(torch.nn.Module):
    """torch's ``nn.SyncBatchNorm`` is refused: the port synchronizes
    BatchNorm as flax does, through ``ResNet(bn_cross_replica_axes=...)``;
    per-rank BatchNorm is averaged by the step."""

    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(IN, 3)
        self.bn = torch.nn.SyncBatchNorm(3)


REJECTED = {
    # DistributedOptimizer (hvd_jax.py's argument checks)
    "sharded-adasum": (lambda m: _opt(m, sharded_update=True, op=hvd_t.Adasum),
                       ValueError, "Sum or Average"),
    "sharded-accumulating": (
        lambda m: _opt(m, sharded_update=True, backward_passes_per_step=2),
        ValueError, "backward_passes_per_step"),
    "no-backward-pass": (lambda m: _opt(m, backward_passes_per_step=0),
                         ValueError, ">= 1"),
    "compression": (lambda m: _opt(m, compression="int8", op=hvd_t.Adasum),
                    ValueError, "chunked wire format"),
    # HOROVOD_WIRE_DTYPE is read at use; an unknown name raises there
    "wire-dtype-env": (_wire_env_step, ValueError, "unknown wire dtype"),
    "wire-dtype-env-overlap": (_wire_env_overlap(False), ValueError,
                               "unknown wire dtype"),
    "wire-dtype-env-overlap-sharded": (_wire_env_overlap(True), ValueError,
                                       "unknown wire dtype"),
    "wire-dtype-env-preaveraged": (_wire_env_preaveraged, ValueError,
                                   "unknown wire dtype"),
    "unnamed-parameter": (
        lambda m: _opt(m, named_parameters=list(m.named_parameters())[:1]),
        ValueError, "exactly the parameters"),
    "preaveraged-sharded": (
        lambda m: _opt(m, sharded_update=True).update_preaveraged(),
        ValueError, "overlap pipeline"),
    # ZeRO-1
    "two-param-groups": (
        lambda m: hvd_t.DistributedOptimizer(
            torch.optim.SGD([{"params": [m.layers[0].weight]},
                             {"params": [p for n, p in m.named_parameters()
                                         if n != "layers.0.weight"],
                              "lr": 0.5}], lr=0.1), sharded_update=True),
        ValueError, "one param group"),
    "plan-op": (lambda m: zero.make_plan(list(m.parameters()), op="max"),
                ValueError, "Sum or Average"),
    "plan-empty": (lambda m: zero.make_plan([]), ValueError, "non-empty"),
    # make_train_step (training.py's checks)
    "accum-zero": (lambda m: t_training.make_train_step(
        m, _opt(m), accum_steps=0), ValueError, "accum_steps must be"),
    "accum-plain-optimizer": (lambda m: t_training.make_train_step(
        m, _adamw(m), accum_steps=2), ValueError, "DistributedOptimizer"),
    "overlap-plain-optimizer": (lambda m: t_training.make_train_step(
        m, _adamw(m), overlap_grads=True), ValueError, "DistributedOptimizer"),
    # the overlapped pipeline reduce-scatters, which JAX's reducescatter
    # takes for Sum or Average only
    "overlap-adasum": (lambda m: t_training.make_train_step(
        m, _opt(m, op=hvd_t.Adasum), overlap_grads=True), ValueError,
        "Sum or Average"),
    "two-accumulators": (lambda m: t_training.make_train_step(
        m, _opt(m, backward_passes_per_step=2), accum_steps=2),
        ValueError, "two accumulators"),
    "indivisible-microbatch": (_step_with_indivisible_batch, ValueError,
                               "microbatches"),
    "batchnorm": (lambda m: t_training.make_train_step(
        _BatchNormNet(), _opt(_BatchNormNet())), NotImplementedError,
        "bn_cross_replica_axes"),
    # collectives
    "reducescatter-max": (lambda m: hvd_t.reducescatter(torch.ones(2),
                                                        op=hvd_t.Max),
                          ValueError, "Sum or Average"),
}


@pytest.mark.parametrize("name", sorted(REJECTED))
def test_rejects(monkeypatch, name):
    """Each unsupported combination raises instead of running another
    exchange than the one asked for."""
    fn, exc, match = REJECTED[name]
    if name.startswith("wire-dtype-env"):
        monkeypatch.setenv("HOROVOD_WIRE_DTYPE", "int4")
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    try:
        with pytest.raises(exc, match=match):
            fn(MLP(IN, FEATURES))
    finally:
        hvd_t.shutdown()


def test_uncompressed_names_are_accepted(cpu_world):
    model = MLP(IN, FEATURES)
    for name in (None, "none", "NONE"):
        _opt(model, compression=name)


@pytest.mark.parametrize("sharded", [False, True],
                         ids=["replicated", "sharded"])
def test_explicit_none_overrides_wire_dtype_env(monkeypatch, sharded):
    """``compression="none"`` pins the exchange uncompressed whatever
    ``HOROVOD_WIRE_DTYPE`` says, as in the JAX package: the overlapped
    step builds and trains, and so does ``step()``."""
    monkeypatch.setenv("HOROVOD_WIRE_DTYPE", "int8")
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    try:
        x, y = (torch.from_numpy(a) for a in _mlp_data())
        model = MLP(IN, FEATURES)
        step = t_training.make_train_step(
            model, _opt(model, compression="none", sharded_update=sharded),
            overlap_grads=True)
        model = MLP(IN, FEATURES)
        plain = t_training.make_train_step(
            model, _opt(model, compression="none", sharded_update=sharded))
        for run in (step, plain):
            losses = [float(run(x, y.long())) for _ in range(2)]
            assert losses[1] < losses[0]
    finally:
        hvd_t.shutdown()
