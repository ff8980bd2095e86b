"""The port's ResNet and VGG-16 (horovod_tpu_torch/models/resnet.py,
models/vgg.py, convert.py) and ``make_train_step``'s BatchNorm
statistics (training.py) against the JAX package's flax models and step,
with the same weights (carried over by convert.py) and the same
numpy-seeded data, in fp32.

Tolerances: logits to 1e-4 of their largest magnitude; gradients to
1e-4 of the model's largest gradient (a few leaves, such as the stem's
BatchNorm bias, have gradients that cancel to about 1e-7, where any
relative bound would measure summation order); running statistics to
1e-5 absolute. Train steps (3 steps of SGD with momentum): losses to
rtol 1e-5; each leaf of the parameters and of the statistics to
1e-6 + 5e-2 max|x - x0|, a twentieth of how far the leaf moved. A small
BatchNorm net amplifies rounding into the leaves whose gradients cancel:
the port against itself, its start perturbed by 1e-6 relative, parts by
up to 2.5 % of a leaf's movement after 3 steps (2 microbatches), the port
against JAX by up to 1.2 %. A lost or doubled bucket, a missing 1/K, a
wrong world size or an unaveraged statistic is off by tens of percent.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as hvd_j
import horovod_tpu_torch as hvd_t
from horovod_tpu import training
from horovod_tpu.models import resnet as jresnet
from horovod_tpu.models import vgg as jvgg
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu.utils import benchmarks as jbench
from horovod_tpu_torch import convert
from horovod_tpu_torch import training as t_training
from horovod_tpu_torch.models import resnet, vgg
from horovod_tpu_torch.ops import fusion as tfusion
from horovod_tpu_torch.utils import benchmarks as tbench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = 10
# (stage sizes, block) of the small ResNets: ResNet-18's, and a bottleneck
# net with one block a stage
NETS = {"basic": ((2, 2, 2, 2), "BasicBlock"),
        "bottleneck": ((1, 1, 1, 1), "BottleneckBlock")}
LR = 0.01
STEPS = 3
STEP_BATCH = 8  # global; 4 a rank at world 2, 2 a microbatch at accum 2
STEP_SIZE = 64


def _jax_net(name):
    stages, block = NETS[name]
    return jresnet.ResNet(stage_sizes=stages,
                          block_cls=getattr(jresnet, block), num_filters=8,
                          num_classes=CLASSES, dtype=jnp.float32)


def _torch_net(name):
    stages, block = NETS[name]
    return resnet.ResNet(stages, getattr(resnet, block), num_filters=8,
                         num_classes=CLASSES, dtype=torch.float32)


def _images(n, size, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, size, size, 3)).astype(np.float32)
    y = rng.integers(0, CLASSES, size=(n,)).astype(np.int32)
    return x, y


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _init(jmodel, x, seed=1):
    """flax variables with every BatchNorm scale drawn away from 1 and 0,
    so the zero-initialized last scale of a block hides no branch."""
    v = jax.jit(lambda k, x1: jmodel.init(k, x1, train=False))(
        jax.random.PRNGKey(seed), jnp.asarray(x[:1]))
    rng = np.random.default_rng(seed)

    def jitter(path, leaf):
        leaf = np.asarray(leaf)
        if path[-1].key == "scale":
            return (rng.uniform(0.5, 1.5, leaf.shape)).astype(np.float32)
        return leaf

    params = jax.tree_util.tree_map_with_path(jitter, v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    return params, stats


def _load(tmodel, params, stats):
    tmodel.load_state_dict(convert.params_from_flax(params, tmodel),
                           strict=False)
    if stats is not None:
        tmodel.load_state_dict(convert.batch_stats_from_flax(stats, tmodel),
                               strict=False)
    return tmodel


def _xent(logits, labels):
    return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits),
                                         labels[:, None], axis=1))


def _assert_tree_close(got, want, atol, what):
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), rtol=0, atol=atol,
            err_msg=f"{what}{jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("size", [32, 33])
@pytest.mark.parametrize("name", sorted(NETS))
def test_resnet_matches_flax(name, size):
    """Training-mode logits, every gradient and the updated batch_stats,
    then evaluation-mode logits from the running statistics, at an even
    size (SAME pads a stride-2 window (0, 1)) and an odd one ((1, 1))."""
    x, y = _images(4, size)
    jmodel = _jax_net(name)
    params, stats = _init(jmodel, x)

    def loss(p):
        logits, mut = jmodel.apply({"params": p, "batch_stats": stats},
                                   jnp.asarray(x), train=True,
                                   mutable=["batch_stats"])
        return _xent(logits, jnp.asarray(y)), (logits, mut["batch_stats"])

    # each reference compiled once as a whole (eager JAX compiles every
    # operation of the net on its first use)
    (j_loss, (j_logits, j_stats)), j_grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    j_eval = jax.jit(lambda p, s: jmodel.apply(
        {"params": p, "batch_stats": s}, jnp.asarray(x), train=False))(
        params, j_stats)

    tmodel = _load(_torch_net(name), params, stats).train()
    logits = tmodel(_nchw(x))
    t_loss = t_training.softmax_cross_entropy(logits, torch.from_numpy(y)
                                              .long())
    t_loss.backward()
    scale = float(np.abs(np.asarray(j_logits)).max())
    np.testing.assert_allclose(logits.detach().numpy(), j_logits, rtol=0,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    grads = convert.flax_from_params(
        {n: p.grad for n, p in tmodel.named_parameters()}, tmodel)
    g_max = max(float(np.abs(np.asarray(g)).max())
                for g in jax.tree_util.tree_leaves(j_grads))
    _assert_tree_close(grads, j_grads, 1e-4 * g_max, "grad")
    _assert_tree_close(
        convert.flax_from_batch_stats(tmodel.state_dict(), tmodel), j_stats,
        1e-5, "batch_stats")
    tmodel.eval()
    with torch.no_grad():
        np.testing.assert_allclose(tmodel(_nchw(x)).numpy(), j_eval, rtol=0,
                                   atol=1e-4 * scale)


@pytest.mark.parametrize("n,kernel,stride,want", [
    (224, 7, 2, (2, 3)),   # the stem
    (112, 3, 2, (0, 1)),   # the max-pool, a 3x3/2 on an even input
    (33, 3, 2, (1, 1)),
    (56, 1, 2, (0, 0)),    # a strided projection
    (56, 3, 1, (1, 1)),
])
def test_same_padding_is_flax(n, kernel, stride, want):
    """flax's SAME padding, asymmetric for a stride of 2, for a
    convolution and for the max-pool (padded with -inf)."""
    assert resnet.same_pads(n, kernel, stride) == want
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((1, n, n, 2)) - 3.0).astype(np.float32)
    w = rng.standard_normal((kernel, kernel, 2, 3)).astype(np.float32)
    want_conv = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    conv = resnet.Conv(2, 3, kernel, stride)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w).permute(3, 2, 0, 1))
        got = conv(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want_conv, rtol=1e-5, atol=1e-4)
    if kernel == 3:
        want_pool = fnn.max_pool(jnp.asarray(x), (3, 3), (stride, stride),
                                 padding="SAME")
        got = resnet.max_pool_same(_nchw(x), 3, stride)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                      want_pool)


def test_batchnorm_is_flax():
    """Running averages of the batch mean and BIASED variance with weight
    0.1 of the batch, in fp32, eps 1e-5: with 2 elements a channel the
    unbiased variance of ``nn.BatchNorm2d`` is twice as large."""
    x = np.random.default_rng(3).standard_normal((2, 1, 1, 4)).astype(
        np.float32) * 3 + 1
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y, mut = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    ours = resnet.BatchNorm(4).train()
    got = ours(_nchw(x))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), y,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours.running_mean.numpy(),
                               mut["batch_stats"]["mean"], rtol=1e-6)
    np.testing.assert_allclose(ours.running_var.numpy(),
                               mut["batch_stats"]["var"], rtol=1e-5)
    torch_bn = torch.nn.BatchNorm2d(4).train()
    torch_bn(_nchw(x))
    assert not np.allclose(torch_bn.running_var.numpy(),
                           mut["batch_stats"]["var"], rtol=1e-2)


@pytest.mark.parametrize("name,millions", [("resnet50", 25.5),
                                           ("resnet101", 44.5)])
def test_full_size_leaves_match_flax(name, millions):
    """Every flax leaf of the full-size model, in flax's order, with its
    shape (through convert.py's layouts) and the parameter count."""
    jmodel = jbench.make_model(name, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=False))
    j_leaves = jax.tree_util.tree_leaves_with_path(shapes["params"])
    tmodel = tbench.make_model(name, dtype=torch.float32)
    leaves = list(convert.flax_named_parameters(tmodel))
    assert [n for n, _, _ in leaves] == [
        "/".join(k.key for k in p) for p, _ in j_leaves]
    for (n, p, _), (_, j) in zip(leaves, j_leaves):
        assert sorted(p.shape) == sorted(j.shape), n
        assert p.numel() == int(np.prod(j.shape)), n
    total = sum(p.numel() for p in tmodel.parameters())
    assert total == sum(int(np.prod(j.shape)) for _, j in j_leaves)
    assert abs(total / 1e6 - millions) < 0.1
    j_stats = jax.tree_util.tree_leaves(shapes["batch_stats"])
    assert len(convert._stats_table(tmodel)) == len(j_stats)


def test_vgg_matches_flax():
    """A narrow VGG-16 (``cfg`` override) at 32x32: logits and gradients
    in evaluation mode (no dropout), which covers the flatten order of a
    4x4x16 activation into the first fully connected layer."""
    cfg = (8, "M", 16, "M", 16, "M")
    x, y = _images(2, 32, seed=4)
    jmodel = jvgg.VGG16(num_classes=CLASSES, dtype=jnp.float32, cfg=cfg)
    params = jmodel.init(jax.random.PRNGKey(2), jnp.asarray(x[:1]),
                         train=False)["params"]

    def loss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x), train=False)
        return _xent(logits, jnp.asarray(y)), logits

    (j_loss, j_logits), j_grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    tmodel = vgg.VGG16(num_classes=CLASSES, dtype=torch.float32, cfg=cfg,
                       image_size=32).eval()
    _load(tmodel, params, None)
    logits = tmodel(_nchw(x))
    t_loss = t_training.softmax_cross_entropy(logits,
                                              torch.from_numpy(y).long())
    t_loss.backward()
    scale = float(np.abs(np.asarray(j_logits)).max())
    np.testing.assert_allclose(logits.detach().numpy(), j_logits, rtol=0,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    g_max = max(float(np.abs(np.asarray(g)).max())
                for g in jax.tree_util.tree_leaves(j_grads))
    grads = convert.flax_from_params(
        {n: p.grad for n, p in tmodel.named_parameters()}, tmodel)
    _assert_tree_close(grads, j_grads, 1e-4 * g_max, "grad")


def test_vgg_dropout_takes_the_callers_generator():
    tmodel = vgg.VGG16(num_classes=CLASSES, dtype=torch.float32,
                       cfg=(4, "M"), image_size=8).train()
    x = torch.ones(2, 3, 8, 8)

    def run(seed):
        return tmodel(x, dropout_generator=torch.Generator().manual_seed(
            seed))

    assert torch.equal(run(0), run(0))
    assert not torch.equal(run(0), run(1))


def test_batch_stats_round_trip():
    x, _ = _images(1, 32)
    params, stats = _init(_jax_net("bottleneck"), x)
    tmodel = _load(_torch_net("bottleneck"), params, stats)
    back = convert.flax_from_batch_stats(tmodel.state_dict(), tmodel)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, stats)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(stats)
    with pytest.raises(TypeError, match="batch_stats"):
        convert.batch_stats_from_flax(stats, vgg.VGG16(cfg=(4, "M"),
                                                       image_size=8))


@pytest.mark.parametrize("threshold", [4096, 200_000])
def test_flax_order_buckets_match_jax(threshold):
    """ResNet-18's reverse-order bucket schedule, packed in the flax leaf
    order, equals the JAX package's at two thresholds and worlds 1, 2."""
    x, _ = _images(1, 32)
    params, _ = _init(_jax_net("basic"), x)
    leaves = jax.tree_util.tree_leaves(params)
    tmodel = _torch_net("basic")
    tleaves = [p for _, p, _ in convert.flax_named_parameters(tmodel)]
    for world in (1, 2):
        want = jfusion.bucket_schedule(leaves, world,
                                       threshold_bytes=threshold,
                                       axes=("data",))
        got = tfusion.bucket_schedule(tleaves, world,
                                      threshold_bytes=threshold)
        assert len(got.buckets) == len(want.buckets) > 1
        assert got.padded_sizes == want.padded_sizes
        for a, b in zip(got.buckets, want.buckets):
            assert a.leaf_indices == b.leaf_indices and a.sizes == b.sizes


def test_synthetic_batch_is_the_jax_batch():
    j_images, j_labels = jbench.synthetic_batch(4, 8, dtype=jnp.float32)
    images, labels = tbench.synthetic_batch(4, 8)
    np.testing.assert_array_equal(images.permute(0, 2, 3, 1).numpy(),
                                  j_images)
    np.testing.assert_array_equal(labels.numpy(), j_labels)


# (accum_steps, overlap_grads, sharded_update)
STEP_CASES = [(1, False, False), (2, True, True), (2, True, False)]


def _case_id(case):
    accum, overlap, sharded = case
    return (f"accum{accum}-{'overlap' if overlap else 'plain'}-"
            f"{'sharded' if sharded else 'replicated'}")


def _step_data():
    return _images(STEP_BATCH, STEP_SIZE, seed=5)


def _jax_step_run(mesh, case, x, y, start=None):
    """Initial variables (``start``, else drawn by ``_init``), per-step
    losses and final params and statistics of the JAX
    ``make_train_step`` on the bottleneck net."""
    accum, overlap, sharded = case
    jmodel = _jax_net("bottleneck")
    tx = hvd_j.DistributedOptimizer(optax.sgd(LR, momentum=0.9),
                                    sharded_update=sharded)
    params, stats = start or _init(jmodel, x, seed=0)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = training.TrainState(
        params=jparams, opt_state=tx.init(jparams),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
        step=jnp.zeros((), jnp.int32))
    step = training.make_train_step(jmodel, tx, mesh=mesh, donate=False,
                                    accum_steps=accum, overlap_grads=overlap)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    final = jax.tree_util.tree_map(np.asarray, (state.params,
                                                state.batch_stats))
    return (params, stats), losses, final


def _torch_step_run(case, start, x, y):
    """The port's run on this rank's shard; returns the losses and the
    final flax-layout params and statistics."""
    accum, overlap, sharded = case
    tmodel = _load(_torch_net("bottleneck"), *start)
    opt = hvd_t.DistributedOptimizer(
        torch.optim.SGD(tmodel.parameters(), lr=LR, momentum=0.9),
        named_parameters=convert.flax_named_parameters(tmodel),
        sharded_update=sharded)
    t_training.create_train_state(tmodel, opt)
    step = t_training.make_train_step(tmodel, opt, accum_steps=accum,
                                      overlap_grads=overlap)
    world, rank = hvd_t.size(), hvd_t.rank()
    n = STEP_BATCH // world
    xs, ys = _nchw(x[rank * n:(rank + 1) * n]), torch.from_numpy(
        y[rank * n:(rank + 1) * n]).long()
    losses = [float(step(xs, ys)) for _ in range(STEPS)]
    assert tmodel.training
    sd = tmodel.state_dict()
    return losses, (convert.flax_from_params(sd, tmodel),
                    convert.flax_from_batch_stats(sd, tmodel))


def _assert_moved_close(got, want, start, what):
    for (path, a), b, c in zip(jax.tree_util.tree_leaves_with_path(want),
                               jax.tree_util.tree_leaves(got),
                               jax.tree_util.tree_leaves(start)):
        a, c = np.asarray(a), np.asarray(c)
        np.testing.assert_allclose(
            np.asarray(b), a, rtol=0,
            atol=1e-6 + 5e-2 * float(np.abs(a - c).max()),
            err_msg=f"{what}{jax.tree_util.keystr(path)}")


def _assert_step_matches(losses, final, j_losses, j_final, start):
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    _assert_moved_close(final[0], j_final[0], start[0], "params")
    _assert_moved_close(final[1], j_final[1], start[1], "batch_stats")


@pytest.fixture()
def jax_world():
    def make(n):
        hvd_j.shutdown()
        hvd_j.init(devices=jax.devices()[:n])
        return hvd_j.mesh()
    yield make
    hvd_j.shutdown()


@pytest.mark.parametrize("case", STEP_CASES, ids=_case_id)
def test_make_train_step_batchnorm_matches_jax_world_one(jax_world, case):
    x, y = _step_data()
    start, j_losses, j_final = _jax_step_run(jax_world(1), case, x, y)
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    try:
        losses, final = _torch_step_run(case, start, x, y)
    finally:
        hvd_t.shutdown()
    _assert_step_matches(losses, final, j_losses, j_final, start)


_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    sys.path.insert(0, {tests!r})
    import horovod_tpu_torch as hvd
    import test_torch_resnet as t
    hvd.init(device="cpu")
    data = np.load(sys.argv[1], allow_pickle=True)
    x, y, start = data["x"], data["y"], tuple(data["start"])
    out = {{}}
    for case in t.STEP_CASES:
        losses, final = t._torch_step_run(case, start, x, y)
        out[t._case_id(case)] = dict(losses=losses,
                                     final=[t._listed(f) for f in final])
    print("RESULT", json.dumps([hvd.rank(), out]), flush=True)
    hvd.shutdown()
""")


def _start_ranks(src, world, args):
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
    return procs


def _collect_ranks(procs):
    results = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][0]
        results.append(json.loads(line.split(" ", 1)[1]))
    return [r[1] for r in sorted(results, key=lambda r: r[0])]


def _listed(d):
    """A flax-shaped tree of arrays as json's nested lists."""
    if isinstance(d, dict):
        return {k: _listed(v) for k, v in d.items()}
    return np.asarray(d).tolist()


def _nested(d):
    """json's nested lists back to numpy fp32, flax-tree shaped."""
    if isinstance(d, dict):
        return {k: _nested(v) for k, v in d.items()}
    return np.asarray(d, np.float32)


def test_make_train_step_batchnorm_matches_jax_world_two(jax_world,
                                                         tmp_path):
    """Every case at world 2: each rank on its half of the batch, with its
    own BatchNorm statistics until the step averages them, against the
    JAX step on a 2-device mesh; both ranks end equal. The JAX steps run
    while the ranks do."""
    x, y = _step_data()
    start = _init(_jax_net("bottleneck"), x, seed=0)
    path = tmp_path / "data.npz"
    np.savez(path, x=x, y=y, start=np.array(start, dtype=object))
    procs = _start_ranks(_WORKER.format(tests=os.path.join(REPO, "tests")),
                         2, [str(path)])
    try:
        mesh = jax_world(2)
        want = {}
        for case in STEP_CASES:
            _, j_losses, j_final = _jax_step_run(mesh, case, x, y,
                                                 start=start)
            want[_case_id(case)] = (j_losses, j_final)
        ranks = _collect_ranks(procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for case in STEP_CASES:
        j_losses, j_final = want[_case_id(case)]
        for got in ranks:
            got = got[_case_id(case)]
            final = tuple(_nested(t) for t in got["final"])
            _assert_step_matches(got["losses"], final, j_losses, j_final,
                                 start)


def _xent64(logits, labels):
    """The loss in fp64 on both sides (the models hand back fp32 logits,
    rounded alike from the same fp64 values)."""
    if isinstance(logits, torch.Tensor):
        logp = torch.log_softmax(logits.double(), dim=-1)
        return -logp.gather(-1, labels[..., None].long())[..., 0].mean()
    logp = jax.nn.log_softmax(logits.astype(jnp.float64), axis=-1)
    return -jnp.mean(jnp.take_along_axis(logp, labels[..., None],
                                         axis=-1)[..., 0])


@pytest.mark.parametrize("case", STEP_CASES, ids=_case_id)
def test_make_train_step_batchnorm_matches_jax_fp64(jax_world, case):
    """The BatchNorm train step in fp64 on both sides (JAX under
    ``enable_x64``, the port's ResNet in float64), where rounding no
    longer hides a gap: 3 steps of the bottleneck net, each leaf of the
    parameters and statistics within 1e-12 + 1e-9 max|x - x0| of JAX's
    (the fp32 test allows 5e-2), losses within rtol 1e-12."""
    accum, overlap, sharded = case
    x, y = _step_data()
    x = x.astype(np.float64)
    params, stats = _init(_jax_net("bottleneck"), x.astype(np.float32),
                          seed=0)
    with jax.enable_x64(True):
        mesh = jax_world(1)
        stages, block = NETS["bottleneck"]
        jmodel = jresnet.ResNet(stage_sizes=stages,
                                block_cls=getattr(jresnet, block),
                                num_filters=8, num_classes=CLASSES,
                                dtype=jnp.float64)
        tx = hvd_j.DistributedOptimizer(optax.sgd(LR, momentum=0.9),
                                        sharded_update=sharded)
        p64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), params)
        state = training.TrainState(
            params=p64, opt_state=tx.init(p64),
            batch_stats=jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), stats),
            step=jnp.zeros((), jnp.int32))
        step = training.make_train_step(jmodel, tx, mesh=mesh, donate=False,
                                        loss_fn=_xent64, accum_steps=accum,
                                        overlap_grads=overlap)
        j_losses = []
        for _ in range(STEPS):
            state, loss = step(state, jnp.asarray(x), jnp.asarray(y))
            j_losses.append(float(loss))
        assert jax.tree_util.tree_leaves(state.params)[0].dtype == \
            jnp.float64
        j_final = jax.tree_util.tree_map(
            np.asarray, (state.params, state.batch_stats))

    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    try:
        tmodel = _load(resnet.ResNet(stages, getattr(resnet, block),
                                     num_filters=8, num_classes=CLASSES,
                                     dtype=torch.float64).double(),
                       params, stats)
        opt = hvd_t.DistributedOptimizer(
            torch.optim.SGD(tmodel.parameters(), lr=LR, momentum=0.9),
            named_parameters=convert.flax_named_parameters(tmodel),
            sharded_update=sharded)
        tstep = t_training.make_train_step(tmodel, opt, loss_fn=_xent64,
                                           accum_steps=accum,
                                           overlap_grads=overlap)
        losses = [float(tstep(_nchw(x), torch.from_numpy(y)))
                  for _ in range(STEPS)]
        sd = tmodel.state_dict()
        assert sd["head.weight"].dtype == torch.float64
        # flax-layout trees at the model's own dtype
        final = (jax.tree_util.tree_map(
            lambda t: np.array(t.detach().numpy()),
            convert.train_state_trees(tmodel)[0]),
            convert._nest([(path, sd[name].numpy())
                           for path, name in convert._stats_table(tmodel)]))
    finally:
        hvd_t.shutdown()
    np.testing.assert_allclose(losses, j_losses, rtol=1e-12)
    for got, want, start in zip(final, j_final, (params, stats)):
        for (path, a), b, c in zip(
                jax.tree_util.tree_leaves_with_path(want),
                jax.tree_util.tree_leaves(got),
                jax.tree_util.tree_leaves(start)):
            a, c = np.asarray(a), np.asarray(c, np.float64)
            np.testing.assert_allclose(
                np.asarray(b), a, rtol=0,
                atol=1e-12 + 1e-9 * float(np.abs(a - c).max()),
                err_msg=jax.tree_util.keystr(path))
