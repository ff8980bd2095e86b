"""The port's two-level reduction (horovod_tpu_torch/parallel/
hierarchical.py, the hierarchical bucket schedule of ops/fusion.py, the
hierarchical ZeRO-1 plan of parallel/zero.py, init()'s (dcn, data) mesh)
and its synchronized BatchNorm (models/resnet.py) against the JAX
package's, on the same numpy inputs.

In process, every rank of a (dcn x data) mesh is held in one process
through ``parallel.axis.local_axes`` and held against the JAX functions
under ``shard_map`` on the conftest's CPU devices: values within atol
1e-6 (fp32 summation order), chunk ownership and the all-gather exact.
One spawn of 4 gloo ranks runs ``init()`` under ``HOROVOD_CROSS_SIZE=2``
and the dryrun's sections 1 and 1b (``__graft_entry__.py``): a tiny
ResNet-18 on identical shard batches through
``DistributedOptimizer(hierarchical=True)`` on (2 x 2) and
``op=Adasum`` on 4 ranks, against the single-rank oracle and the JAX
step (loss rtol 1e-5, params atol 1e-6); the group forms of the
reductions bit for bit equal to the in-process forms; and synchronized
BatchNorm against flax ``BatchNorm(axis_name="data")``. A second spawn
lays 4 ranks out on hosts of 3 and 1, whose ranks see different
``HOROVOD_CROSS_SIZE``: every rank keeps the flat mesh.
"""

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
from jax.sharding import PartitionSpec as P

import horovod_tpu as hvd_j
import horovod_tpu_torch as hvd_t
from horovod_tpu import training as j_training
from horovod_tpu.models import resnet as jresnet
from horovod_tpu.ops import adasum as jadasum
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu.parallel import hierarchical as jhier
from horovod_tpu.parallel import zero as jzero
from horovod_tpu_torch import convert
from horovod_tpu_torch import training as t_training
from horovod_tpu_torch.models import resnet as tresnet
from horovod_tpu_torch.ops import adasum as tadasum
from horovod_tpu_torch.ckpt import sharded as tsharded
from horovod_tpu_torch.ops import fusion as tfusion
from horovod_tpu_torch.parallel import axis as taxis
from horovod_tpu_torch.parallel import hierarchical as thier
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import zero as tzero

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("dcn", "data")
SHAPES = [(2, 2), (2, 3), (2, 4)]
ATOL = 1e-6


def _jax_per_rank(fn, shape, *inputs):
    """``fn`` on each shard of a ``shape`` (dcn, data) mesh of CPU devices:
    every input ``[R, ...]`` split by rank, every output stacked
    ``[R, ...]`` in rank order."""
    n = int(np.prod(shape))
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                             NAMES)
    spec = P(NAMES)

    def f(*xs):
        out = fn(*(x[0] for x in xs))
        return jax.tree_util.tree_map(lambda o: jnp.asarray(o)[None], out)

    out = jax.shard_map(f, mesh=mesh, in_specs=(spec,) * len(inputs),
                        out_specs=spec, check_vma=False)(*inputs)
    return jax.tree_util.tree_map(np.asarray, out)


def _shards(x):
    return [torch.from_numpy(np.ascontiguousarray(v)) for v in x]


def _local(shape):
    ax = taxis.local_axes(shape, NAMES)
    return [ax["data"]], ax["dcn"]


def _inputs(shape, length, seed=0):
    n = int(np.prod(shape))
    return np.random.default_rng(seed).standard_normal(
        (n, length)).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("op", ["sum", "average"])
def test_reducescatter_allgather_match_jax(shape, op):
    """The reduce-scatter over (data, then dcn) against JAX's, each rank
    its own chunk of the sum; the rank owning chunk ``i`` is the one at
    ``i = data * dcn_size + dcn``; the all-gather inverts it exactly."""
    n = int(np.prod(shape))
    x = _inputs(shape, 3 * n)
    ici, dcn = _local(shape)
    got = [t.numpy()
           for t in thier._reducescatter(_shards(x), ici + [dcn], op)]
    want = _jax_per_rank(
        lambda v: jhier.hierarchical_reducescatter(v, ("data",), "dcn", op),
        shape, x)
    total = x.sum(axis=0) / (n if op == "average" else 1)
    for r in range(n):
        np.testing.assert_allclose(got[r], want[r], rtol=0, atol=ATOL)
        owner = (r % shape[1]) * shape[0] + r // shape[1]
        np.testing.assert_allclose(got[r], total[3 * owner:3 * owner + 3],
                                   rtol=0, atol=ATOL)
    parts = _inputs(shape, 3, seed=1)  # distinct per rank: data movement
    gathered = [t.numpy() for t in
                thier._allgather(_shards(parts), ici + [dcn])]
    j_gathered = _jax_per_rank(
        lambda v: jhier.hierarchical_allgather(v, ("data",), "dcn"),
        shape, parts)
    for r in range(n):
        np.testing.assert_array_equal(gathered[r], j_gathered[r])
    round_trip = thier._allgather(thier._reducescatter(
        _shards(x), ici + [dcn], op), ici + [dcn])
    for t in round_trip:
        np.testing.assert_allclose(t.numpy(), total, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("op", ["sum", "average"])
def test_allreduce_matches_jax(shape, op):
    """A length that divides by no shard count: zero-padded, every rank
    the whole reduction, within summation order of JAX's."""
    n = int(np.prod(shape))
    x = _inputs(shape, 4 * n + 3).reshape(n, 1, -1)  # a 2-d leaf
    got = thier._allreduce(_shards(x), *_local(shape), op)
    want = _jax_per_rank(
        lambda v: jhier.hierarchical_allreduce(v, ("data",), "dcn", op),
        shape, x)
    flat = x.sum(axis=0) / (n if op == "average" else 1)
    for r in range(n):
        assert got[r].shape == x[r].shape
        np.testing.assert_allclose(got[r].numpy(), want[r], rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(got[r].numpy(), flat, rtol=0, atol=ATOL)


@pytest.mark.parametrize("fn", ["reducescatter", "allreduce"])
def test_other_ops_raise_as_jax(fn):
    ici, dcn = _local((2, 2))
    xs = _shards(_inputs((2, 2), 8))
    port = {"reducescatter": lambda xs, op: thier._reducescatter(
                xs, ici + [dcn], op),
            "allreduce": lambda xs, op: thier._allreduce(xs, ici, dcn,
                                                         op)}[fn]
    jfn = {"reducescatter": jhier.hierarchical_reducescatter,
           "allreduce": jhier.hierarchical_allreduce}[fn]
    for op in ("max", "adasum"):
        with pytest.raises(ValueError, match="supports sum/average"):
            port(xs, op)
        with pytest.raises(ValueError, match="supports sum/average"):
            jfn(jnp.zeros(8), op=op)


@pytest.mark.parametrize("axes,hierarchical,want", [
    (("dcn", "data"), True, ("data", "dcn")),
    (("dcn", "data"), False, ("dcn", "data")),
    (("data",), True, ("data",)),
    (("data", "dcn"), True, ("data", "dcn")),
])
def test_bucket_schedule_orders_axes_as_jax(axes, hierarchical, want):
    """``bucket_schedule(hierarchical=True)`` puts ``dcn`` last, as JAX
    ``test_fusion.py``'s ``test_bucket_schedule_hierarchical_reorders_
    ici_first`` pins; without a dcn axis, or without ``hierarchical``,
    the order stays."""
    leaves = [np.ones((8,), np.float32)]
    j = jfusion.bucket_schedule(leaves, world=8, threshold_bytes=1 << 20,
                                axes=axes, hierarchical=hierarchical)
    t = tfusion.bucket_schedule([torch.ones(8)], 8, threshold_bytes=1 << 20,
                                axes=axes, hierarchical=hierarchical)
    assert t.axes == j.axes == want
    assert t.padded_sizes == j.padded_sizes


def _fake_mesh(shape, rank):
    """Rank ``rank`` of a (dcn, data) mesh of ``shape`` with its group
    layout and no process group: enough for the plan and ``mesh_rank``,
    which communicate nothing."""
    groups = {}
    for axes, rows in tmesh.mesh_groups(shape, NAMES).items():
        for ranks in rows:
            if rank in ranks and axes != NAMES:
                groups[axes] = (None, ranks)
    return tmesh.Mesh(group=None, device=torch.device("cpu"),
                      size=int(np.prod(shape)), rank=rank, axis_names=NAMES,
                      shape=shape, groups=groups)


ZERO_LEAVES = [(7,), (3, 5), (4,), (2, 3, 2)]


@pytest.mark.parametrize("hierarchical", [True, False])
def test_zero_rows_match_jax(hierarchical):
    """The ZeRO-1 rows of every rank of a (2 x 4) mesh under a (non-)
    hierarchical plan equal, element for element, the rows the JAX plan
    gives the same device (``_local_param_rows`` under ``shard_map``)."""
    shape = (2, 4)
    rng = np.random.default_rng(3)
    leaves = [rng.standard_normal(s).astype(np.float32)
              for s in ZERO_LEAVES]
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]).reshape(shape),
                             NAMES)
    jplan = jzero.make_plan(leaves, axes=NAMES, threshold_bytes=64,
                            hierarchical=hierarchical, mesh=mesh)
    assert len(jplan.schedule.buckets) > 1

    def rows_of(_):
        rows = jzero._local_param_rows(jplan.schedule,
                                       [jnp.asarray(x) for x in leaves])
        return {k: v for k, v in rows.items()}

    want = _jax_per_rank(rows_of, shape, np.zeros((8, 1), np.float32))
    params = [torch.from_numpy(x) for x in leaves]
    saved = tmesh._current
    try:
        for r in range(8):
            tmesh.set_mesh(_fake_mesh(shape, r))
            plan = tzero.make_plan(params, threshold_bytes=64,
                                   axes=NAMES if not hierarchical else None,
                                   hierarchical=hierarchical)
            assert plan.schedule.axes == jplan.schedule.axes
            assert plan.schedule.padded_sizes == jplan.schedule.padded_sizes
            got = tzero._local_param_rows(plan.schedule, params)
            for i, row in enumerate(got):
                np.testing.assert_array_equal(row.numpy(),
                                              want[f"b{i}"][r, 0])
            if hierarchical:
                assert tzero.row_index(plan.schedule) == \
                    (r % 4) * 2 + r // 4
    finally:
        tmesh.set_mesh(saved)


def test_build_mesh_num_slices_form():
    """``build_mesh()`` with no shape is the JAX ``build_mesh``: the 1-D
    ``("data",)`` mesh over the world at ``num_slices=1``, and a world
    that ``num_slices`` does not divide refused with the same
    ``ValueError`` (the 4-rank spawn below builds the (2 x 2) one)."""
    from horovod_tpu.parallel import mesh as jmesh
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    try:
        m = tmesh.build_mesh()
        assert (m.axis_names, m.shape) == (("data",), (1,))
        with pytest.raises(ValueError, match="not divisible by num_slices"):
            tmesh.build_mesh(num_slices=2)
        with pytest.raises(ValueError, match="not divisible by num_slices"):
            jmesh.build_mesh(devices=jax.devices()[:1], num_slices=2)
        j = jmesh.build_mesh(devices=jax.devices()[:8], num_slices=2)
        assert (tuple(j.axis_names), j.devices.shape) == (NAMES, (2, 4))
    finally:
        hvd_t.shutdown()


# ---------------------------------------------------------------------------
# 4 gloo ranks: one spawn runs every check
# ---------------------------------------------------------------------------

STEP_LR, IMAGE, CLASSES = 0.01, 16, 4
BN_SHAPE = (4, 2, 3, 5, 5)  # ranks, then each rank's [N, C, H, W]


def _shard_batch():
    """One shard's batch (the dryrun's: 2 images of 16 x 16), NHWC."""
    rng = np.random.default_rng(0)
    return (rng.standard_normal((2, IMAGE, IMAGE, 3)).astype(np.float32),
            rng.integers(0, CLASSES, size=(2,)).astype(np.int32))


def _jax_resnet():
    return jresnet.ResNet18(num_classes=CLASSES, num_filters=8,
                            dtype=jnp.float32)


def _torch_resnet():
    return tresnet.ResNet18(num_classes=CLASSES, num_filters=8,
                            dtype=torch.float32)


def _flax_start():
    x, _ = _shard_batch()
    v = _jax_resnet().init(jax.random.PRNGKey(0), jnp.asarray(x[:1]),
                           train=False)
    return (jax.tree_util.tree_map(np.asarray, v["params"]),
            jax.tree_util.tree_map(np.asarray, v["batch_stats"]))


def _port_model(state_path):
    model = _torch_resnet()
    model.load_state_dict(torch.load(state_path))
    return model


# the dryrun's 1b2 on the two-level schedule: the overlapped pipeline
# and ZeRO-1 rows owned (data, dcn)-major (one microbatch: at 16 x 16
# the last stage's BatchNorm sees 1 x 1 pixels, so it needs 2 images)
ZERO_STEP = dict(overlap_grads=True, momentum=0.9, sharded_update=True)


def _port_step(model, accum_steps=1, overlap_grads=False, momentum=0.0,
               **opt_kw):
    """One step of the port's ``make_train_step`` on this rank's shard
    batch: the loss, the flax-layout parameters, the optimizer and the
    step."""
    opt = hvd_t.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=STEP_LR, momentum=momentum),
        named_parameters=convert.flax_named_parameters(model),
        threshold_bytes=1 << 14, **opt_kw)
    t_training.create_train_state(model, opt)
    step = t_training.make_train_step(model, opt, accum_steps=accum_steps,
                                      overlap_grads=overlap_grads)
    x, y = _shard_batch()
    loss = float(step(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                      torch.from_numpy(y).long()))
    return (loss, convert.flax_from_params(model.state_dict(), model), opt,
            step)


def _bn_inputs():
    rng = np.random.default_rng(12)
    x = rng.standard_normal(BN_SHAPE).astype(np.float32) * 2 + 0.5
    g = rng.standard_normal(BN_SHAPE).astype(np.float32)
    w = rng.uniform(0.5, 1.5, BN_SHAPE[2]).astype(np.float32)
    b = rng.standard_normal(BN_SHAPE[2]).astype(np.float32)
    return x, g, w, b


def _port_sync_bn(rank):
    """Synchronized BatchNorm on this rank's input over the data axis:
    the output, the running statistics and the gradients of sum(y * g)."""
    x, g, w, b = _bn_inputs()
    bn = tresnet.BatchNorm(BN_SHAPE[2], cross_replica_axes=("data",))
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
    xr = torch.from_numpy(x[rank]).requires_grad_()
    y = bn(xr)
    (y * torch.from_numpy(g[rank])).sum().backward()
    return dict(y=y.detach().numpy(), dx=xr.grad.numpy(),
                dw=bn.weight.grad.numpy(), db=bn.bias.grad.numpy(),
                mean=bn.running_mean.numpy(), var=bn.running_var.numpy())


def _group_inputs():
    """Per-rank inputs of the group-form reductions on 4 ranks."""
    rng = np.random.default_rng(21)
    return dict(rs=rng.standard_normal((4, 12)).astype(np.float32),
                parts=rng.standard_normal((4, 3)).astype(np.float32),
                ar=rng.standard_normal((4, 2, 7)).astype(np.float32),
                ada=rng.standard_normal((4, 13)).astype(np.float32))


def _group_forms(rank):
    """The reductions on the installed (2 x 2) mesh, group form."""
    from horovod_tpu_torch.ops import adasum, collective
    from horovod_tpu_torch.parallel import hierarchical
    inp = {k: torch.from_numpy(v[rank]) for k, v in _group_inputs().items()}
    out = {}
    for op in ("sum", "average"):
        out[f"rs_{op}"] = hierarchical.hierarchical_reducescatter(
            inp["rs"], op=op)
        out[f"ar_{op}"] = hierarchical.hierarchical_allreduce(inp["ar"],
                                                              op=op)
    out["ag"] = hierarchical.hierarchical_allgather(inp["parts"])
    out["ada_2d"] = collective.allreduce(inp["ada"], op=hvd_t.Adasum)
    out["ada_2d_explicit"] = adasum.hierarchical_adasum_allreduce(
        inp["ada"], ici_axes=("data",), dcn_axis="dcn")
    out["rank_hier"] = torch.tensor(collective.mesh_rank(("data", "dcn")))
    out.update(_permuted(collective, inp["rs"], inp["parts"]))
    return {k: v.numpy() for k, v in out.items()}


PERMUTED = ("data", "dcn")  # out of mesh order: a hierarchical schedule's


def _permuted(coll, rs, parts):
    """The collectives over axes out of mesh order (``coll`` the port's
    or the JAX package's module): chunks and rows row-major over
    ``PERMUTED``."""
    return {"perm_ag": coll.allgather(parts, axes=PERMUTED),
            "perm_rs": coll.reducescatter(rs, op=coll.Sum, axes=PERMUTED),
            "perm_a2a": coll.alltoall(rs, axes=PERMUTED),
            "perm_bcast": coll.broadcast(parts, root_rank=1, axes=PERMUTED)}


def _jax_permuted():
    from horovod_tpu.ops import collective as jcoll
    inp = _group_inputs()
    out = _jax_per_rank(lambda rs, parts: _permuted(jcoll, rs, parts),
                        (2, 2), inp["rs"], inp["parts"])
    return {k: np.asarray(v) for k, v in out.items()}


def _local_forms():
    """The same reductions with every rank in this process."""
    inp = {k: [torch.from_numpy(r) for r in v]
           for k, v in _group_inputs().items()}
    ax = taxis.local_axes((2, 2), NAMES)
    ici, dcn = [ax["data"]], ax["dcn"]
    out = {}
    for op in ("sum", "average"):
        out[f"rs_{op}"] = thier._reducescatter(inp["rs"], ici + [dcn], op)
        out[f"ar_{op}"] = thier._allreduce(inp["ar"], ici, dcn, op)
    out["ag"] = thier._allgather(inp["parts"], ici + [dcn])
    out["ada_2d"] = tadasum._hierarchical_adasum(inp["ada"], ici, dcn)
    out["ada_2d_explicit"] = out["ada_2d"]
    out["ada_flat"] = tadasum._adasum_tree(inp["ada"], taxis.LocalAxis(4))
    return {k: [t.numpy() for t in v] for k, v in out.items()}


LM_TOKENS = (4, 16)  # the global batch: one sequence a rank at world 4


def _default_lm_losses():
    """Two AdamW steps of a tiny LM through ``make_lm_train_step`` and
    ``shard_lm_batch`` with every default (the batch axes are the
    installed mesh's data axes): the losses."""
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    cfg = TransformerConfig(vocab_size=64, num_layers=1, num_heads=2,
                            d_model=32, d_ff=128, dtype=torch.float32)
    model = Transformer(cfg, generator=torch.Generator().manual_seed(0),
                        device=hvd_t.device())
    opt = hvd_t.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-2),
        named_parameters=convert.flax_named_parameters(model))
    t_training.create_train_state(model, opt)
    step = t_training.make_lm_train_step(model, opt)
    tokens = np.random.default_rng(5).integers(0, 64, size=LM_TOKENS)
    local = t_training.shard_lm_batch(torch.from_numpy(tokens))
    return np.asarray([float(step(local)) for _ in range(2)])


def _zero_row_load_refused(model, hier_opt):
    """Whether ZeRO-1 rows saved by a flat plan are refused by the
    hierarchical optimizer ``hier_opt`` on this rank."""
    flat_opt = hvd_t.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=STEP_LR, momentum=0.9),
        named_parameters=convert.flax_named_parameters(model),
        threshold_bytes=1 << 14, sharded_update=True, hierarchical=False)
    try:
        hier_opt.load_state_dict(flat_opt.state_dict())
    except ValueError as e:
        assert "restore through horovod_tpu_torch.ckpt" in str(e), e
        return True
    return False


def rank_checks(out_dir, state_path):
    """Run on each of 4 gloo ranks under ``HOROVOD_CROSS_SIZE=2``; the
    results go to ``out_dir/rank<r>.npz``."""
    from horovod_tpu_torch.ops import collective
    hvd_t.init(device="cpu")
    r = hvd_t.rank()
    m = tmesh.get_mesh()
    res = {"names": np.asarray(m.axis_names), "shape": np.asarray(m.shape),
           "coords": np.asarray(m.coords),
           "cross": np.asarray([hvd_t.cross_rank(), hvd_t.cross_size()])}
    res.update({f"group/{k}": v for k, v in _group_forms(r).items()})
    loss, params, _, _ = _port_step(_port_model(state_path),
                                    hierarchical=True)
    res["hier/loss"] = np.asarray(loss)
    res.update({f"hier/{k}": v for k, v in _flat_tree(params).items()})
    model = _port_model(state_path)
    loss, params, opt, step = _port_step(model, hierarchical=True,
                                         **ZERO_STEP)
    res["zero/loss"] = np.asarray(loss)
    res.update({f"zero/{k}": v for k, v in _flat_tree(params).items()})
    res["zero_axes"] = np.asarray(opt.zero_state.plan.schedule.axes)
    res["zero_flat_load_refused"] = np.asarray(
        _zero_row_load_refused(_port_model(state_path), opt))
    res["lm_losses"] = _default_lm_losses()
    # a sharded checkpoint saves the row this rank holds
    payload, _ = tsharded.snapshot_payload(
        convert.train_state_to_flat(model, opt, step.state), r, 4)
    res["zero_saved_rows"] = np.asarray(sorted(
        {int(row) for leaf in payload["zero"].values()
         for rows in leaf["rows"].values() for row in rows}))
    # one process mesh over 2 rows of 2 ranks, and the GSPMD step on it
    from horovod_tpu_torch.cluster import procmesh
    import test_torch_gspmd as tg
    pm = procmesh.build_process_mesh(procmesh.row_owners(4, 2))
    res["procmesh"] = np.asarray(list(pm.axis_names) + list(pm.shape))
    for hier in (False, True):
        tag = "spmd_hier" if hier else "spmd_flat"
        res[f"{tag}/explicit"] = np.asarray(tg.run_1b4(False, hier)[0])
        losses, _, _, step = tg.run_1b4(True, hier)
        res[f"{tag}/losses"] = np.asarray(losses)
        res[f"{tag}/axes"] = np.asarray(sorted(
            (label, op, v["calls"])
            for label, v in step.compiled_axis_collectives.items()
            for op in v["ops"])).astype(str)
    tmesh.build_mesh((4,), ("data",))
    res["group/ada_flat"] = collective.allreduce(
        torch.from_numpy(_group_inputs()["ada"][r]), op=hvd_t.Adasum).numpy()
    loss, params, _, _ = _port_step(_port_model(state_path), op=hvd_t.Adasum)
    res["adasum/loss"] = np.asarray(loss)
    res.update({f"adasum/{k}": v for k, v in _flat_tree(params).items()})
    res.update({f"bn/{k}": v for k, v in _port_sync_bn(r).items()})
    np.savez(os.path.join(out_dir, f"rank{r}.npz"), **res)
    hvd_t.shutdown()


def _flat_tree(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


_WORKER = textwrap.dedent("""
    import sys
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, {tests!r})
    from test_torch_hierarchical import rank_checks
    rank_checks({out!r}, {state!r})
""")


def _run_four_ranks(src, timeout):
    """``src`` on 4 gloo ranks laid out as 2 hosts of 2 (the launcher's
    env contract, host-major); each must exit 0 within ``timeout``."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(4):
        env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE="4",
                   HOROVOD_LOCAL_RANK=str(r % 2), HOROVOD_LOCAL_SIZE="2",
                   HOROVOD_CROSS_RANK=str(r // 2), HOROVOD_CROSS_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", src], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            p.kill()
            p.wait()


_UNEVEN_WORKER = textwrap.dedent("""
    import numpy as np
    import torch
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.parallel import mesh
    hvd.init(device="cpu")
    m = mesh.get_mesh()
    total = hvd.allreduce(torch.tensor([float(hvd.rank())]), op=hvd.Sum)
    np.savez({out!r} + "/rank%d.npz" % hvd.rank(),
             names=np.asarray(m.axis_names), shape=np.asarray(m.shape),
             total=total.numpy())
    hvd.shutdown()
""")


def test_uneven_hosts_keep_the_flat_mesh(tmp_path):
    """4 ranks on hosts of 3 and 1 (the launcher's allocation): ranks 0
    and 3 see ``HOROVOD_CROSS_SIZE=2``, ranks 1 and 2 see 1, and every
    rank must make the same decision, since building the (dcn, data)
    mesh is collective. All four keep the 1-D ``("data",)`` mesh and
    reduce over it."""
    from horovod_tpu_torch.run import allocation
    slots = allocation.allocate([allocation.HostSlots("a", 3),
                                 allocation.HostSlots("b", 1)], 4)
    assert [s.cross_size for s in slots] == [2, 1, 1, 2]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    for s in slots:
        env = dict(os.environ, HOROVOD_RANK=str(s.rank),
                   HOROVOD_SIZE=str(s.size),
                   HOROVOD_LOCAL_RANK=str(s.local_rank),
                   HOROVOD_LOCAL_SIZE=str(s.local_size),
                   HOROVOD_CROSS_RANK=str(s.cross_rank),
                   HOROVOD_CROSS_SIZE=str(s.cross_size),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _UNEVEN_WORKER.format(out=str(tmp_path))],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r in range(4):
        res = np.load(tmp_path / f"rank{r}.npz")
        assert tuple(res["names"]) == ("data",)
        assert tuple(res["shape"]) == (4,)
        assert float(res["total"][0]) == 6.0


def _jax_step(start, devices, num_slices, **tx_kw):
    """The JAX ``make_train_step`` on ``devices`` with every shard the
    same batch: its loss and parameters."""
    x, y = _shard_batch()
    hvd_j.shutdown()
    hvd_j.init(devices=devices, num_slices=num_slices)
    try:
        tx = hvd_j.DistributedOptimizer(optax.sgd(STEP_LR), **tx_kw)
        params = jax.tree_util.tree_map(jnp.asarray, start[0])
        state = j_training.TrainState(
            params=params, opt_state=tx.init(params),
            batch_stats=jax.tree_util.tree_map(jnp.asarray, start[1]),
            step=jnp.zeros((), jnp.int32))
        step = j_training.make_train_step(_jax_resnet(), tx,
                                          mesh=hvd_j.mesh(), donate=False)
        n = len(devices)
        state, loss = step(state, jnp.asarray(np.tile(x, (n, 1, 1, 1))),
                           jnp.asarray(np.tile(y, n)))
        return float(loss), _flat_tree(jax.tree_util.tree_map(
            np.asarray, state.params))
    finally:
        hvd_j.shutdown()


def _jax_sync_bn():
    """flax ``BatchNorm(axis_name="data")`` under ``shard_map`` on 4
    devices (NHWC): per shard the output, the new running statistics and
    the gradients of sum(y * g)."""
    x, g, w, b = _bn_inputs()
    nhwc = lambda a: np.ascontiguousarray(a.transpose(0, 1, 3, 4, 2))
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5, axis_name="data")
    c = BN_SHAPE[2]
    stats = {"mean": jnp.zeros(c), "var": jnp.ones(c)}
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]), ("data",))

    def f(xs, gs, params):
        def loss(xr, p):
            y, upd = bn.apply({"params": p, "batch_stats": stats}, xr,
                              mutable=["batch_stats"])
            return jnp.sum(y * gs[0]), (y, upd["batch_stats"])
        (_, (y, new)), (dx, dp) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(xs[0], params)
        out = dict(y=y, dx=dx, dw=dp["scale"], db=dp["bias"],
                   mean=new["mean"], var=new["var"])
        return {k: v[None] for k, v in out.items()}

    out = jax.shard_map(f, mesh=mesh, in_specs=(P("data"), P("data"), P()),
                        out_specs=P("data"), check_vma=False)(
        nhwc(x), nhwc(g), {"scale": jnp.asarray(w), "bias": jnp.asarray(b)})
    out = {k: np.asarray(v) for k, v in out.items()}
    for k in ("y", "dx"):  # back to NCHW
        out[k] = out[k].transpose(0, 1, 4, 2, 3)
    return out


def _assert_params(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=f"{what} {k}")


def test_four_gloo_ranks_two_level_adasum_and_sync_bn(tmp_path):
    """On 4 gloo ranks of 2 hosts: ``init()`` installs the (dcn, data)
    mesh of (2, 2); the dryrun's sections 1 (``hierarchical=True`` on
    2 x 2) and 1b (flat ``op=Adasum`` on 4 ranks) on a tiny ResNet-18
    whose shards see the same batch equal the single-rank oracle and the
    JAX step on the same weights (loss rtol 1e-5, params atol 1e-6), and
    so does 1b2 on the two-level schedule (overlap and ZeRO-1, whose rows
    are owned (data, dcn)-major: a sharded checkpoint saves row
    [0, 2, 1, 3][rank], and rows a flat plan saved are refused where the
    row differs) against its oracle; ``make_lm_train_step`` and
    ``shard_lm_batch`` with their defaults give the single-rank losses
    (rtol 1e-5); the collectives over axes out
    of mesh order equal JAX's (exactly, the reduce-scatter's sum of four
    within atol 1e-6); the two-level reductions and
    Adasum in their group form equal the in-process form bit for bit;
    synchronized BatchNorm matches flax's
    ``BatchNorm(axis_name="data")`` (outputs and statistics within 1e-5,
    gradients within 1e-4 of the largest); ``procmesh.build_process_mesh``
    of 2 rows of 2 installs the same (dcn, data) mesh, and on it the
    GSPMD ZeRO-1 step (flat and ICI-first rows) holds the dryrun's 1b4
    bar against the explicit overlapped step, its collectives over the
    axes its rows are sharded over."""
    start = _flax_start()
    model = _torch_resnet()
    model.load_state_dict(convert.params_from_flax(start[0], model),
                          strict=False)
    model.load_state_dict(convert.batch_stats_from_flax(start[1], model),
                          strict=False)
    state_path = tmp_path / "start.pt"
    torch.save(model.state_dict(), state_path)
    _run_four_ranks(_WORKER.format(tests=os.path.join(REPO, "tests"),
                                   out=str(tmp_path),
                                   state=str(state_path)), timeout=300)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    for r, res in enumerate(ranks):
        assert tuple(res["names"]) == NAMES
        assert tuple(res["shape"]) == (2, 2)
        assert tuple(res["coords"]) == (r // 2, r % 2)
        assert tuple(res["cross"]) == (r // 2, 2)
    # the group forms against the in-process forms, bit for bit
    local = _local_forms()
    for key, per_rank in local.items():
        for r, res in enumerate(ranks):
            np.testing.assert_array_equal(res[f"group/{key}"], per_rank[r],
                                          err_msg=f"{key} rank {r}")
    assert [int(res["group/rank_hier"]) for res in ranks] == [0, 2, 1, 3]
    for key, want in _jax_permuted().items():
        for r, res in enumerate(ranks):
            # the sum of four addends: fp32 summation order; the rest
            # moves data, exactly
            np.testing.assert_allclose(
                res[f"group/{key}"], want[r], rtol=0,
                atol=1e-6 if key == "perm_rs" else 0,
                err_msg=f"{key} rank {r}")
    # the dryrun's contract: the oracle, then the JAX step
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    try:
        lm_losses = _default_lm_losses()
        o_loss, o_params, _, _ = _port_step(_port_model(state_path))
        z_loss, z_params, _, _ = _port_step(_port_model(state_path),
                                            **ZERO_STEP)
    finally:
        hvd_t.shutdown()
    o_params, z_params = _flat_tree(o_params), _flat_tree(z_params)
    for r, res in enumerate(ranks):
        # the default LM step and batch on (dcn, data): the world-1 losses
        np.testing.assert_allclose(res["lm_losses"], lm_losses, rtol=1e-5)
        # flat rows load only where the hierarchical row is the same
        assert bool(res["zero_flat_load_refused"]) == (r in (1, 2))
        assert tuple(res["zero_axes"]) == ("data", "dcn")
        assert list(res["zero_saved_rows"]) == [[0, 2, 1, 3][r]]
        np.testing.assert_allclose(float(res["zero/loss"]), z_loss,
                                   rtol=1e-5)
        _assert_params({k[5:]: v for k, v in res.items()
                        if k.startswith("zero/") and k != "zero/loss"},
                       z_params, f"two-level ZeRO-1 rank {r} vs oracle")
    devices = jax.devices()[:4]
    j_hier = _jax_step(start, devices, 2, hierarchical=True)
    j_ada = _jax_step(start, devices, None, op=hvd_j.Adasum)
    for tag, (j_loss, j_params) in (("hier", j_hier), ("adasum", j_ada)):
        for r, res in enumerate(ranks):
            loss = float(res[f"{tag}/loss"])
            params = {k[len(tag) + 1:]: v for k, v in res.items()
                      if k.startswith(f"{tag}/") and k != f"{tag}/loss"}
            np.testing.assert_allclose(loss, o_loss, rtol=1e-5)
            np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
            _assert_params(params, o_params, f"{tag} rank {r} vs oracle")
            _assert_params(params, j_params, f"{tag} rank {r} vs JAX")
    # one process mesh of 2 rows (build_process_mesh) and the GSPMD ZeRO-1
    # step on it against the explicit overlapped step: flat rows ride the
    # whole mesh in one collective, ICI-first rows a collective an axis
    for r, res in enumerate(ranks):
        assert list(res["procmesh"]) == ["dcn", "data", "2", "2"]
        for tag in ("spmd_flat", "spmd_hier"):
            got, want = res[f"{tag}/losses"], res[f"{tag}/explicit"]
            assert np.max(np.abs(got - want) / np.abs(want)) <= 1e-4, \
                (tag, got, want)
        assert {tuple(x[:2]) for x in res["spmd_flat/axes"]} == {
            ("dcn+data", "all-gather"), ("dcn+data", "all-reduce"),
            ("dcn+data", "reduce-scatter")}
        assert {tuple(x[:2]) for x in res["spmd_hier/axes"]} == {
            ("data", "reduce-scatter"), ("dcn", "reduce-scatter"),
            ("data", "all-gather"), ("dcn", "all-gather"),
            ("dcn+data", "all-reduce")}
    # synchronized BatchNorm against flax
    want = _jax_sync_bn()
    grad_scale = {k: float(np.abs(want[k]).max()) for k in ("dx", "dw",
                                                           "db")}
    for r, res in enumerate(ranks):
        for k in ("y", "mean", "var"):
            np.testing.assert_allclose(res[f"bn/{k}"], want[k][r], rtol=0,
                                       atol=1e-5, err_msg=f"bn {k} {r}")
        for k, scale in grad_scale.items():
            np.testing.assert_allclose(res[f"bn/{k}"], want[k][r], rtol=0,
                                       atol=1e-4 * scale,
                                       err_msg=f"bn {k} {r}")


def measured_gaps():
    """The largest gaps of the in-process cases above against JAX, for
    PERF.md: ``{what: max abs}``."""
    out = {}
    for shape in SHAPES:
        n = int(np.prod(shape))
        ici, dcn = _local(shape)
        for op in ("sum", "average"):
            x = _inputs(shape, 3 * n)
            got = thier._reducescatter(_shards(x), ici + [dcn], op)
            want = _jax_per_rank(lambda v: jhier.hierarchical_reducescatter(
                v, ("data",), "dcn", op), shape, x)
            gap = max(float(np.abs(g.numpy() - w).max())
                      for g, w in zip(got, want))
            out["reducescatter"] = max(out.get("reducescatter", 0.0), gap)
            x = _inputs(shape, 4 * n + 3).reshape(n, 1, -1)
            got = thier._allreduce(_shards(x), ici, dcn, op)
            want = _jax_per_rank(lambda v: jhier.hierarchical_allreduce(
                v, ("data",), "dcn", op), shape, x)
            gap = max(float(np.abs(g.numpy() - w).max())
                      for g, w in zip(got, want))
            out["allreduce"] = max(out.get("allreduce", 0.0), gap)
    return out


if __name__ == "__main__":
    # python tests/test_torch_hierarchical.py: the measured gaps
    # (JAX_PLATFORMS and the virtual devices as tests/conftest.py sets
    # them)
    for what, gap in measured_gaps().items():
        print(f"{what}: max abs {gap:.3e}")
