"""The port's gradient exchange against the JAX package's, on the same
numpy inputs: the flax leaf order of ``convert.flax_named_parameters``
(the order the buckets pack), ``plan_buckets`` and ``bucket_schedule``
(ops/fusion.py), the collectives ``reducescatter``, ``alltoall`` and
``allgather`` and the bucket ops built on them (ops/collective.py,
ops/fusion.py), ``allreduce_metrics`` and ``join`` (hvd_torch.py), and
the small models of models/simple.py.

Multi-rank checks run the port on 2 gloo processes on the CPU and the
JAX package under ``shard_map`` on a 2-device mesh of the conftest's CPU
devices. The collectives only move and add pairs of values, so they
agree exactly.
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
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu as hvd_j
from horovod_tpu import hvd_jax
from horovod_tpu.models.simple import MLP as JMLP
from horovod_tpu.models.simple import MNISTConvNet as JConvNet
from horovod_tpu.models.transformer import Transformer as JTransformer
from horovod_tpu.models.transformer import TransformerConfig as JConfig
from horovod_tpu.ops import collective as jcoll
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import simple
from horovod_tpu_torch.models.simple import MLP, MNISTConvNet
from horovod_tpu_torch.models.transformer import Transformer, TransformerConfig
from horovod_tpu_torch.ops import fusion as tfusion

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THRESHOLDS = [64, 4096, 30_000, 64 << 20]
LM_WIDTHS = dict(vocab_size=64, num_layers=12, num_heads=2, d_model=32,
                 d_ff=128)  # 12 layers: block_10 sorts before block_2
IMAGE = (8, 8, 1)


def _models():
    """(flax model, flax init input, torch model) of each model the port
    packs buckets for."""
    return {
        "lm": (JTransformer(JConfig(**LM_WIDTHS, dtype=jnp.float32)),
               jnp.zeros((1, 4), jnp.int32),
               Transformer(TransformerConfig(**LM_WIDTHS))),
        "mlp": (JMLP(features=(16, 12, 10)), jnp.zeros((1, 20)),
                MLP(20, (16, 12, 10))),
        "convnet": (JConvNet(), jnp.zeros((1,) + IMAGE),
                    MNISTConvNet(image_shape=IMAGE)),
    }


@pytest.mark.parametrize("threshold", THRESHOLDS)
@pytest.mark.parametrize("name", ["lm", "mlp", "convnet"])
def test_flax_leaf_order_buckets_match_jax(name, threshold):
    """``flax_named_parameters`` yields the flax tree's leaves in
    ``tree_leaves`` order, so the port's buckets (forward and reverse)
    equal JAX's, leaf for leaf."""
    jmodel, sample, tmodel = _models()[name]
    params = jmodel.init(jax.random.PRNGKey(0), sample)["params"]
    paths, leaves = zip(*jax.tree_util.tree_leaves_with_path(params))
    named = list(convert.flax_named_parameters(tmodel))
    assert [n for n, _, _ in named] == [
        "/".join(k.key for k in path) for path in paths]
    tleaves = [p for _, p, _ in named]
    assert [p.numel() for p in tleaves] == [np.size(x) for x in leaves]
    for reverse in (False, True):
        jb = jfusion.plan_buckets(list(leaves), threshold, reverse=reverse)
        tb = tfusion.plan_buckets(tleaves, threshold, reverse=reverse)
        assert [b.leaf_indices for b in jb] == [b.leaf_indices for b in tb]
        assert [b.sizes for b in jb] == [b.sizes for b in tb]


def _layout_leaves(name, seed=0):
    """Random values in each flax leaf's shape (the LM's ``heads_in`` and
    ``heads_out`` kernels, the conv net's HWIO kernels), as numpy for
    JAX, and as the port's tensors in torch's layout with their
    layouts."""
    jmodel, sample, tmodel = _models()[name]
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                sample))["params"]
    rng = np.random.default_rng(seed)
    jleaves = [rng.standard_normal(x.shape).astype(np.float32)
               for x in jax.tree_util.tree_leaves(shapes)]
    layouts = [lay for _, _, lay in convert.flax_named_parameters(tmodel)]
    tleaves = [convert._to_torch(torch.from_numpy(a), lay).contiguous()
               for a, lay in zip(jleaves, layouts)]
    return jleaves, tleaves, layouts


@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("name", ["lm", "convnet"])
def test_flax_layout_buckets_match_jax_elementwise(name, world):
    """With each leaf's flax layout, the port packs every bucket element
    for element as the JAX package does (the LM's attention kernels
    transposed and split into heads, the conv kernels OIHW -> HWIO), so
    ZeRO-1's rows are JAX's rows; unpacking gives back each torch leaf,
    exactly. Without the layouts a 2-d leaf lands transposed."""
    jleaves, tleaves, layouts = _layout_leaves(name)
    kinds = {"lm": {"heads_in", "heads_out", "linear"},
             "convnet": {"conv", "linear"}}[name]
    assert kinds <= set(layouts)
    want = jfusion.bucket_schedule(jleaves, world, threshold_bytes=4096,
                                   axes=("data",))
    got = tfusion.bucket_schedule(
        tleaves, world, threshold_bytes=4096,
        perms=[convert.flax_perm(lay) for lay in layouts])
    plain = tfusion.bucket_schedule(tleaves, world, threshold_bytes=4096)
    assert len(got.buckets) == len(want.buckets) > 1
    differs = 0
    for i in range(len(got.buckets)):
        jflat = np.asarray(jfusion._pack_padded(want, i, jleaves))
        flat = tfusion.pack_padded(got, i, tleaves)
        np.testing.assert_array_equal(flat.numpy(), jflat)
        differs += not np.array_equal(
            tfusion.pack_padded(plain, i, tleaves).numpy(), jflat)
        for j, t in tfusion.unpack_bucket(got, i, flat, tleaves).items():
            assert t.shape == tleaves[j].shape
            assert torch.equal(t, tleaves[j])
        rows = jflat.reshape(world, -1)
        for r in range(world):
            np.testing.assert_array_equal(
                flat[r * got.shard_sizes[i]:
                     (r + 1) * got.shard_sizes[i]].numpy(), rows[r])
    assert differs > 0


def _mixed_leaves():
    """The LM's leaves in flax order plus bf16 and int leaves, as numpy
    (for JAX) and torch tensors."""
    params = JTransformer(JConfig(**LM_WIDTHS, dtype=jnp.float32)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]
    leaves[3:3] = [np.zeros((5, 7), jnp.bfloat16), np.zeros(9, np.int32)]
    leaves.append(np.zeros((301,), jnp.bfloat16))
    dtypes = {np.dtype(np.float32): torch.float32,
              np.dtype(jnp.bfloat16): torch.bfloat16,
              np.dtype(np.int32): torch.int32}
    return leaves, [torch.zeros(x.shape, dtype=dtypes[x.dtype])
                    for x in leaves]


@pytest.mark.parametrize("world", [1, 2, 3, 8])
@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_bucket_schedule_matches_jax(threshold, world):
    jleaves, tleaves = _mixed_leaves()
    js = jfusion.bucket_schedule(jleaves, world, threshold_bytes=threshold,
                                 axes=("data",))
    ts = tfusion.bucket_schedule(tleaves, world, threshold_bytes=threshold)
    assert len(ts.buckets) == len(js.buckets) > 0
    for a, b in zip(js.buckets, ts.buckets):
        assert a.leaf_indices == b.leaf_indices
        assert a.sizes == b.sizes and a.shapes == b.shapes
        assert np.dtype(a.dtype).itemsize == b.dtype.itemsize
    assert ts.padded_sizes == js.padded_sizes
    assert ts.shard_sizes == js.shard_sizes
    assert ts.world == js.world == world


# per-rank inputs of the collective checks, made the same way on both
# sides: rank r's tensors are row r of each array
def _collective_inputs():
    rng = np.random.default_rng(7)
    return dict(
        x=rng.standard_normal((2, 6, 3)).astype(np.float32),
        leaves=[rng.standard_normal((2,) + s).astype(np.float32)
                for s in [(3, 4), (5,), (2, 3), (7,)]],
        metric=rng.standard_normal((2,)).astype(np.float32),
        count=np.array([3, 8], np.int32),
        grads=rng.standard_normal((2, 5)).astype(np.float32))


# three buckets of the leaves above, in reverse: 28 + 24, 20 and 48
# bytes; the first two padded by one element
THRESHOLD = 64

_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    sys.path.insert(0, {tests!r})
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import fusion
    from test_torch_exchange import THRESHOLD, _collective_inputs
    hvd.init(device="cpu")
    r = hvd.rank()
    inp = _collective_inputs()
    x = torch.from_numpy(inp["x"][r])
    leaves = [torch.from_numpy(a[r]) for a in inp["leaves"]]
    sched = fusion.bucket_schedule(leaves, hvd.size(),
                                   threshold_bytes=THRESHOLD)
    out = dict(
        rs_sum=hvd.reducescatter(x, op=hvd.Sum),
        rs_avg=hvd.reducescatter(x, op=hvd.Average),
        a2a=hvd.alltoall(x),
        ag_rs=hvd.allgather(hvd.reducescatter(x, op=hvd.Sum)))
    for i in range(len(sched.buckets)):
        pending = fusion.reduce_scatter_bucket(sched, i, leaves,
                                               async_op=True)
        shard = pending.wait()
        out[f"shard{{i}}"] = shard
        flat = fusion.all_gather_bucket(sched, i, shard)
        for j, t in fusion.unpack_bucket(sched, i, flat, leaves).items():
            out[f"leaf{{j}}"] = t
    m = hvd.allreduce_metrics({{"loss": float(inp["metric"][r]),
                                "tag": "eval", "n": [int(inp["count"][r])]}})
    ms = hvd.allreduce_metrics({{"n": int(inp["count"][r])}}, op=hvd.Sum)
    assert m["tag"] == "eval" and ms["n"].dtype == torch.int64
    out.update(m_loss=m["loss"], m_n=m["n"][0], ms_n=ms["n"])
    joined, n_active = hvd.join([torch.from_numpy(inp["grads"][r])],
                                is_active=(r == 0))
    out.update(join=joined[0], n_active=n_active)
    print("RESULT", json.dumps([r, {{k: v.tolist() for k, v in out.items()}}]),
          flush=True)
    hvd.shutdown()
""")


def _run_ranks(src, world):
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
            [sys.executable, "-c", src], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][0]
        results.append(json.loads(line.split(" ", 1)[1]))
    return [r[1] for r in sorted(results, key=lambda r: r[0])]


def _jax_collectives(inp):
    """The same calls under ``shard_map`` on a 2-device mesh: a dict of
    ``[2, ...]`` arrays, row r the value on device r."""
    hvd_j.shutdown()
    hvd_j.init(devices=jax.devices()[:2])
    try:
        mesh = hvd_j.mesh()
        local = [a[0] for a in inp["leaves"]]
        sched = jfusion.bucket_schedule(local, 2, threshold_bytes=THRESHOLD,
                                        axes=("data",))

        def f(x, leaves, metric, count, grads):
            x, metric, count, grads = x[0], metric[0], count[0], grads[0]
            leaves = [a[0] for a in leaves]
            out = dict(rs_sum=jcoll.reducescatter(x, op=jcoll.Sum),
                       rs_avg=jcoll.reducescatter(x, op=jcoll.Average),
                       a2a=jcoll.alltoall(x),
                       ag_rs=jcoll.allgather(jcoll.reducescatter(x)))
            for i in range(len(sched.buckets)):
                shard = jfusion.reduce_scatter_bucket(sched, i, leaves)
                out[f"shard{i}"] = shard
                flat = jfusion.all_gather_bucket(sched, i, shard)
                for j, t in jfusion.unpack_bucket(sched, i, flat,
                                                  leaves).items():
                    out[f"leaf{j}"] = t
            m = hvd_jax.allreduce_metrics({"loss": metric, "n": [count]})
            ms = hvd_jax.allreduce_metrics({"n": count}, op=jcoll.Sum)
            joined, n_active = hvd_jax.join(
                [grads], is_active=jcoll.mesh_rank() == 0)
            out.update(m_loss=m["loss"], m_n=m["n"][0], ms_n=ms["n"],
                       join=joined[0], n_active=n_active)
            return {k: v[None] for k, v in out.items()}

        spec = P("data")
        fn = jax.shard_map(f, mesh=mesh, in_specs=spec, out_specs=spec,
                           check_vma=False)
        out = fn(inp["x"], inp["leaves"], inp["metric"], inp["count"],
                 inp["grads"])
        return {k: np.asarray(v) for k, v in out.items()}
    finally:
        hvd_j.shutdown()


def test_collectives_two_ranks_match_shard_map():
    """reducescatter (Sum, Average), alltoall, allgather as the inverse of
    reducescatter, the bucket reduce-scatter / all-gather / unpack of a
    3-bucket schedule with padding, allreduce_metrics and join: 2 gloo
    ranks against ``shard_map`` on 2 devices, exactly."""
    inp = _collective_inputs()
    want = _jax_collectives(inp)
    ranks = _run_ranks(_WORKER.format(tests=os.path.join(REPO, "tests")), 2)
    sched = tfusion.bucket_schedule(
        [torch.from_numpy(a[0]) for a in inp["leaves"]], 2,
        threshold_bytes=THRESHOLD)
    assert sched.padded_sizes == (14, 6, 12)
    assert set(ranks[0]) == set(want)
    for key, value in want.items():
        for r, got in enumerate(ranks):
            np.testing.assert_array_equal(
                np.asarray(got[key], value.dtype), value[r], err_msg=key)
    # ownership: chunk r of dim 0 is rank r's, and the gather inverts it
    x = inp["x"]
    np.testing.assert_array_equal(want["rs_sum"][1], (x[0] + x[1])[3:])
    np.testing.assert_array_equal(want["ag_rs"][0], x[0] + x[1])
    np.testing.assert_array_equal(want["a2a"][0][3:], x[1][:3])


def _grad_parity(jmodel, jparams, x, tmodel, tx):
    def loss(params):
        return jnp.sum(jmodel.apply({"params": params}, x, train=False) ** 2)
    jloss, jgrads = jax.value_and_grad(loss)(jparams)
    tmodel.load_state_dict(convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jparams), tmodel))
    tmodel.eval()
    out = tmodel(tx)
    tloss = (out ** 2).sum()
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    grads = convert.flax_from_params(
        {n: p.grad for n, p in tmodel.named_parameters()}, tmodel)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(
            a, np.asarray(b), rtol=1e-4, atol=1e-5 * float(
                np.abs(np.asarray(b)).max())), grads, jgrads)


@pytest.mark.parametrize("name", ["mlp", "convnet"])
def test_simple_models_match_flax(name):
    """Outputs and gradients of the port's MLP and MNISTConvNet (in
    evaluation mode: the dropout masks cannot match threefry's) against
    flax with converted weights, fp32: summation order only."""
    jmodel, sample, tmodel = _models()[name]
    jparams = jmodel.init(jax.random.PRNGKey(1), sample)["params"]
    shape = (4,) + tuple(sample.shape[1:])
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    _grad_parity(jmodel, jparams, jnp.asarray(x), tmodel, torch.from_numpy(x))


def test_convnet_dropout_is_seeded():
    """Training-mode dropout draws from the caller's generator: two calls
    with generators of one seed give the same output, another seed other
    masks, and half the hidden units are dropped."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (16,) + IMAGE).astype(np.float32))
    model = MNISTConvNet(image_shape=IMAGE)

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    model.train()
    torch.testing.assert_close(model(x, dropout_generator=gen(5)),
                               model(x, dropout_generator=gen(5)),
                               rtol=0, atol=0)
    assert not torch.equal(model(x, dropout_generator=gen(5)),
                           model(x, dropout_generator=gen(6)))
    dropped = model(x, dropout_generator=gen(5))
    model.eval()
    evaluated = model(x, dropout_generator=gen(5))
    torch.testing.assert_close(evaluated, model(x), rtol=0, atol=0)
    assert not torch.equal(evaluated, dropped)
    h = torch.ones(64, 128)
    kept = (simple.dropout(h, 0.5, gen(5)) != 0).float().mean().item()
    assert 0.4 < kept < 0.6
