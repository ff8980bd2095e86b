"""The port's GSPMD path (horovod_tpu_torch/parallel/gspmd.py, the
``spmd=True`` steps of training.py, ``DistributedOptimizer.update_spmd``)
against the JAX package's (horovod_tpu/parallel/gspmd.py and
tests/test_gspmd.py), on the CPU: gloo, the kernels' plain versions,
fp32, narrow widths, weights carried by convert.py.

One spawn of 2 gloo ranks runs every check that needs two ranks: the
dryrun's 1b4 (the MLP under ZeRO-1, the GSPMD step against the explicit
overlapped ZeRO-1 step within ``GSPMD_EPSILON``, every ZeRO row 1 of 2
rows a rank) and 1b5 (int8 and fp8 islands within ``WIRE_EPSILON`` of
the exact GSPMD step); the steps against JAX's GSPMD steps on a
2-device mesh (plain DP, the LM); the collectives counted (one
reduce-scatter and one all-gather a ZeRO-1 bucket, one all-reduce a
plain bucket, and the loss's one scalar all-reduce; their bytes from the
shapes; their axes); checkpoints crossing between the two paths; the
global BatchNorm of a ResNet against the explicit step's synchronized
BatchNorm; dropout masks that do not depend on the world; the gradient
norm that ``telemetry=True`` reports (``hvd_grad_norm``) on every path
of both step builders, against plain autograd and JAX's steps. The rest
runs in this process at world 1.
"""

import ast
import copy
import json
import os
import pathlib
import socket
import subprocess
import sys
import textwrap
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as hvd_j
import horovod_tpu_torch as hvd_t
from horovod_tpu import training as jtraining
from horovod_tpu.models.simple import MLP as JMLP
from horovod_tpu.models.transformer import Transformer as JTransformer
from horovod_tpu.models.transformer import TransformerConfig as JConfig
from horovod_tpu.parallel import gspmd as jgspmd
from horovod_tpu.telemetry import instruments as jinst
from horovod_tpu.telemetry import registry as jreg
from horovod_tpu_torch import basics, convert, training
from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.models.simple import MLP, MNISTConvNet
from horovod_tpu_torch.models.transformer import Transformer, TransformerConfig
from horovod_tpu_torch.ops import fusion
from horovod_tpu_torch.parallel import gspmd
from horovod_tpu_torch.parallel import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX package's bars (__graft_entry__.py)
GSPMD_STEPS, GSPMD_EPSILON = 8, 1e-4
WIRE_STEPS, WIRE_EPSILON, WIRE_EPSILON_FLOOR = 8, 0.05, 1e-3
# hvd_grad_norm: fp32 sums in another order than the references'
NORM_STEPS, NORM_RTOL = 2, 1e-5
LM_WIDTHS = dict(vocab_size=32, num_layers=1, num_heads=2, d_model=16,
                 d_ff=32)


@pytest.fixture()
def cpu_world():
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    yield hvd_t
    hvd_t.shutdown()


# ---- the guard: the path's two entry points stay where they are -------

def _calls(name, path):
    """The lines of ``path`` that name ``name`` in code (an attribute, a
    name or an import), docstrings and comments left out."""
    tree = ast.parse(pathlib.Path(path).read_text())
    lines = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr == name or \
                isinstance(node, ast.Name) and node.id == name:
            lines.add(node.lineno)
        elif isinstance(node, ast.ImportFrom) and any(
                a.name == name for a in node.names):
            lines.add(node.lineno)
    return sorted(lines)


def test_guard_local_map_and_init_process_group_stay_in_their_module():
    """The port's counterpart of the JAX package's
    ``test_guard_no_new_pmap_or_shard_map_call_sites`` (its HVD-MESH and
    HVD-DISTINIT passes): ``local_map`` appears only in
    ``parallel/gspmd.py`` (``shard_map_island``, the one sanctioned
    island) and ``init_process_group`` only in ``cluster/procmesh.py``
    (``ensure_distributed``, the one join of the job)."""
    pkg = pathlib.Path(REPO) / "horovod_tpu_torch"
    found = {"local_map": {}, "init_process_group": {}}
    for path in sorted(pkg.rglob("*.py")):
        for name in found:
            lines = _calls(name, path)
            if lines:
                found[name][str(path.relative_to(pkg))] = lines
    assert set(found["local_map"]) == {"parallel/gspmd.py"}, found
    assert set(found["init_process_group"]) == {"cluster/procmesh.py"}, \
        found


# ---- the plan -----------------------------------------------------------

def _adam_tx(sharded):
    return hvd_j.DistributedOptimizer(optax.adam(1e-2),
                                      sharded_update=sharded)


def _zero_opt(model, **kw):
    return hvd_t.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-2),
        named_parameters=convert.flax_named_parameters(model),
        sharded_update=True, **kw)


@pytest.mark.parametrize("two_d", [False, True], ids=["1d", "2d"])
def test_plan_and_state_specs_match_jax(cpu_world, two_d):
    """``derive_plan`` and ``state_partition_specs`` against JAX's
    (``tests/test_gspmd.py:64-99``) on a 1-D and a (dcn, data) mesh:
    the data axes, the batch spec, params replicated, ZeRO rows sharded
    over the schedule's axes; the placed rows are this rank's block of
    the global ``[world, shard]`` row."""
    hvd_j.shutdown()
    hvd_j.init(**({"num_slices": 2} if two_d else {}))
    try:
        jplan = jgspmd.derive_plan()
        jstate = jtraining.create_train_state(
            JMLP(features=(4,)), _adam_tx(True), jax.random.PRNGKey(0),
            jnp.ones((1, 8)))
        jspecs = jtraining.state_specs(jstate)
        jrows = {tuple(s) for s in jax.tree_util.tree_leaves(
            jspecs.opt_state.inner,
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            if tuple(s)}
    finally:
        hvd_j.shutdown()
    if two_d:
        tmesh.build_mesh((1, 1), ("dcn", "data"))
    plan = gspmd.derive_plan()
    assert plan.data_axes == tuple(jplan.data_axes)
    assert plan.batch_spec == tuple(jplan.batch_spec)
    assert plan.world() == 1
    assert tuple(plan.device_mesh.mesh_dim_names) == \
        tmesh.get_mesh().axis_names
    with pytest.raises(ValueError, match="model_axis"):
        gspmd.derive_plan(model_axis="nope")
    model = MLP(8, (4,))
    opt = _zero_opt(model)
    specs = gspmd.state_partition_specs(model, opt)
    assert set(specs["params"].values()) == {()}
    model(torch.ones(2, 8)).sum().backward()
    opt.step()  # the row optimizer's state exists after a step
    specs = gspmd.state_partition_specs(model, opt)
    rows = {s for d in specs["opt_state"].values() for s in d.values() if s}
    assert rows == jrows
    placed = gspmd.place_state(plan, model, opt)
    shard = opt.zero_state.plan.schedule.shard_sizes[0]
    row = placed["opt_state"]["b0"]["exp_avg"]
    assert tuple(row.shape) == (1, shard)
    assert tuple(row.to_local().shape) == (1, shard)
    assert row.to_local().data_ptr() == \
        opt.zero_state.inner.state[opt.zero_state.rows[0]][
            "exp_avg"].data_ptr()


# ---- refusals, the gate, the wire's drift ------------------------------

class _SyncNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(6, 3)
        self.bn = torch.nn.SyncBatchNorm(3)


REFUSED = {
    "accum_steps": (lambda m: training.make_train_step(
        m, hvd_t.DistributedOptimizer(torch.optim.SGD(m.parameters(),
                                                      lr=0.1)),
        spmd=True, accum_steps=2), ValueError, "explicit pipeline"),
    "overlap_grads": (lambda m: training.make_train_step(
        m, hvd_t.DistributedOptimizer(torch.optim.SGD(m.parameters(),
                                                      lr=0.1)),
        spmd=True, overlap_grads=True), ValueError, "explicit pipeline"),
    "adasum": (lambda m: training.make_train_step(
        m, hvd_t.DistributedOptimizer(torch.optim.SGD(m.parameters(),
                                                      lr=0.1),
                                      op=hvd_t.Adasum), spmd=True),
        ValueError, "Average"),
    "plain-optimizer": (lambda m: training.make_train_step(
        m, torch.optim.SGD(m.parameters(), lr=0.1), spmd=True),
        ValueError, "DistributedOptimizer"),
    "backward-passes": (lambda m: training.make_train_step(
        m, hvd_t.DistributedOptimizer(torch.optim.SGD(m.parameters(),
                                                      lr=0.1),
                                      backward_passes_per_step=2),
        spmd=True), ValueError, "backward_passes_per_step"),
    "plain-wire-update": (lambda m: hvd_t.DistributedOptimizer(
        torch.optim.SGD(m.parameters(), lr=0.1)).update_spmd(
            [None] * 2, gspmd.derive_plan(),
            wire=hvd_t.Compression.bf16), ValueError, "ZeRO-1"),
    "chunked-rows": (lambda m: gspmd.apply_shards_spmd(
        _zero_opt(m).zero_state, [None] * 2, gspmd.derive_plan(),
        wire=hvd_t.Compression.int8), ValueError, "no placement form"),
    "sync-batchnorm": (lambda m: training.make_train_step(
        _SyncNet(), hvd_t.DistributedOptimizer(torch.optim.SGD(
            _SyncNet().parameters(), lr=0.1)), spmd=True),
        NotImplementedError, "SyncBatchNorm"),
    "lm-seq-axis": (lambda m: training.make_lm_train_step(
        Transformer(TransformerConfig(**LM_WIDTHS, dtype=torch.float32)),
        None, seq_axis="seq", spmd=True), ValueError, "sequence axis"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals(cpu_world, case):
    """The JAX step's refusals (``tests/test_gspmd.py:214``), and the
    port's: a plain torch optimizer, ``nn.SyncBatchNorm``."""
    fn, exc, match = REFUSED[case]
    with pytest.raises(exc, match=match):
        fn(MLP(6, (3,)))


def test_gate_reports_reason(cpu_world, monkeypatch):
    """(``tests/test_gspmd.py:336``)."""
    monkeypatch.setattr(gspmd, "gspmd_supported",
                        lambda: (False, "synthetic: no DTensor"))
    model = MLP(6, (3,))
    opt = hvd_t.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                     lr=0.1))
    with pytest.raises(RuntimeError, match="synthetic: no DTensor"):
        training.make_train_step(model, opt, spmd=True)
    monkeypatch.undo()
    assert gspmd.gspmd_supported() == (True, "")


def test_late_wire_install_warns(cpu_world):
    """A wire format installed after the step was built warns at the next
    step, naming the rebuild (``tests/test_gspmd.py:303``)."""
    model = MLP(6, (8, 3))
    opt = hvd_t.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                     lr=0.05))
    step = training.make_train_step(model, opt, spmd=True)
    x, y = torch.ones(4, 6), torch.zeros(4, dtype=torch.long)
    step(x, y)
    old = basics._state.config.wire_dtype
    basics._state.config.wire_dtype = "int8"
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            step(x, y)
        drift = [str(m.message) for m in w
                 if "built uncompressed" in str(m.message)]
        assert drift and any("Rebuild the step" in m for m in drift), drift
        assert not any("fall" in m.lower() for m in drift), drift
    finally:
        basics._state.config.wire_dtype = old


@pytest.mark.parametrize("wire", [None, "int8"])
def test_new_batch_shape_gets_its_own_accounting(cpu_world, monkeypatch,
                                                 wire):
    """Each batch signature records its collectives once, a signature
    seen before runs bare (``tests/test_gspmd.py:284``, ``:441``), for
    the placement program and the int8 island."""
    recorded = []
    real = gspmd.record_collectives

    def counting(fn, *args, **kw):
        recorded.append(tuple(tuple(a.shape) for a in args))
        return real(fn, *args, **kw)

    monkeypatch.setattr(gspmd, "record_collectives", counting)
    model = MLP(6, (8, 3))
    opt = _zero_opt(model, compression=wire)
    step = training.make_train_step(model, opt, spmd=True)
    x1, y1 = torch.ones(4, 6), torch.zeros(4, dtype=torch.long)
    x2, y2 = torch.ones(8, 6), torch.zeros(8, dtype=torch.long)
    losses = [step(x1, y1), step(x2, y2), step(x1, y1)]
    assert recorded == [((4, 6), (4,)), ((8, 6), (8,))]
    assert all(torch.isfinite(v) and v.dtype == torch.float32 and
               v.dim() == 0 for v in losses)
    assert step.spmd and step.state.step == 3
    if wire is None:
        # world 1: DTensor issues nothing over a mesh dim of one rank
        assert step.compiled_collectives == {}
    else:
        # the island's process-group collectives run on a group of one
        assert step.compiled_collectives["all-to-all"]["calls"] == 2
        assert set(step.compiled_axis_collectives) == {"replica"}


def test_spmd_step_with_loader(cpu_world):
    """``make_train_step(spmd=True, loader=...)``: the loader stages the
    global batch onto the device, ``step()`` pulls it and places this
    rank's rows (``tests/test_gspmd.py:179``)."""
    from horovod_tpu_torch.data import ArraySource, PrefetchLoader
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, 6)).astype(np.float32)
    y = rng.integers(0, 3, size=(16,)).astype(np.int64)
    model = MLP(6, (8, 3))
    opt = hvd_t.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                     lr=0.05))
    loader = PrefetchLoader(ArraySource([x, y]), 4, rank=0, world=1,
                            shuffle=False)
    try:
        step = training.make_train_step(model, opt, spmd=True,
                                        loader=loader)
        dm, placements = loader.placement_spec
        assert dm is step.plan.device_mesh and placements[0].is_shard(0)
        losses = [float(step()) for _ in range(3)]
    finally:
        loader.close()
    assert all(np.isfinite(losses))
    # the same batches passed by hand give the same losses
    model2 = MLP(6, (8, 3))
    opt2 = hvd_t.DistributedOptimizer(torch.optim.SGD(model2.parameters(),
                                                      lr=0.05))
    step2 = training.make_train_step(model2, opt2, spmd=True)
    assert losses == [float(step2(torch.from_numpy(x[i:i + 4]),
                                  torch.from_numpy(y[i:i + 4])))
                      for i in (0, 4, 8)]


def test_cast_wire_keeps_the_placement_program(cpu_world):
    """bf16 under ZeRO-1 narrows the placement exchange, no island
    (``tests/test_gspmd.py:259``): the rows are cast even at world 1, so
    the losses leave the exact run's bits and stay within
    ``WIRE_EPSILON``."""
    def run(wire):
        torch.manual_seed(0)
        model = MLP(6, (8, 3))
        opt = _zero_opt(model, compression=wire)
        step = training.make_train_step(model, opt, spmd=True)
        x = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (4, 6)).astype(np.float32))
        y = torch.arange(4) % 3
        return step, [float(step(x, y)) for _ in range(4)]

    step, cast = run("bf16")
    _, exact = run(None)
    assert step.wire.wire_dtype == torch.bfloat16 and not step.wire.chunked
    assert step.program is not None and cast != exact
    np.testing.assert_allclose(cast, exact, rtol=WIRE_EPSILON)


def test_step_moves_the_models_own_parameters(cpu_world):
    """The step's DTensor parameters share the model's storage, so the
    optimizer is never rebound: after ``load_state_dict`` of the model
    and the optimizer a step repeats the step taken from that state, and
    it moves the model's own parameters."""
    torch.manual_seed(0)
    model = MLP(6, (8, 3))
    opt = _zero_opt(model)
    step = training.make_train_step(model, opt, spmd=True)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 6)).astype(np.float32))
    y = torch.arange(4) % 3
    step(x, y)
    saved = ({k: v.clone() for k, v in model.state_dict().items()},
             _clone_state(opt.state_dict()))
    before = [p.detach().clone() for p in model.parameters()]
    want = float(step(x, y))
    assert all(not torch.equal(a, p) for a, p in zip(before,
                                                     model.parameters()))
    model.load_state_dict(saved[0])
    opt.load_state_dict(saved[1])
    assert float(step(x, y)) == want
    views = step.program.views()
    for name, p in model.named_parameters():
        assert views[name].to_local().data_ptr() == p.data_ptr()


def _clone_state(sd):
    if isinstance(sd, dict):
        return {k: _clone_state(v) for k, v in sd.items()}
    if isinstance(sd, list):
        return [_clone_state(v) for v in sd]
    return sd.clone() if torch.is_tensor(sd) else sd


# ---- accounting: the classifier, the axes, the recorder ---------------

NAMES = ["all-reduce", "all-reduce-start.1", "all-gather-done",
         "reduce-scatter.3", "all-to-all", "collective-permute-start",
         "all-reduce-scatter-fusion", "fusion.1", "all-reduce-started",
         "copy"]
TORCH_NAMES = {
    "_c10d_functional.all_reduce.default": ("all-reduce", None),
    "_c10d_functional.reduce_scatter_tensor.default": ("reduce-scatter",
                                                       None),
    "_c10d_functional.all_gather_into_tensor.default": ("all-gather", None),
    "_c10d_functional.wait_tensor.default": (None, None),
    "c10d.alltoall_base_.default": ("all-to-all", None),
    "c10d.allreduce_.default": ("all-reduce", None),
    "ncclDevKernel_AllGather_RING_LL": ("all-gather", None),
    "ncclKernel_AllReduce_RING_LL_Sum_float": ("all-reduce", None),
    "ncclDevKernel_ReduceScatter_Sum_f32_RING_LL": ("reduce-scatter", None),
    "ncclDevKernel_SendRecv": ("collective-permute", None),
    "ncclDevKernel_Broadcast_RING_LL": (None, None),
    "aten.mm.default": (None, None),
}


def test_collective_kind_reads_jax_torch_and_nccl_names():
    assert gspmd.COLLECTIVE_OPS == jgspmd.COLLECTIVE_OPS
    for op in gspmd.COLLECTIVE_OPS:
        assert gspmd.collective_label(op) == jgspmd.collective_label(op)
    for name in NAMES:
        assert gspmd.collective_kind(name) == jgspmd.collective_kind(name), \
            name
    for name, want in TORCH_NAMES.items():
        assert gspmd.collective_kind(name) == want, name


@pytest.mark.parametrize("groups", [
    [[0, 1, 2, 3], [4, 5, 6, 7]], [[0, 4], [4, 0]],
    [[0, 1, 2, 3, 4, 5, 6, 7]], [[0, 4], [1, 5], [2, 6], [3, 7]], [[5]]])
def test_group_axes_is_jax(groups):
    """The same rank groups on a (dcn 2, data 4) mesh span the same axes
    (``tests/test_procmesh.py:285-322``)."""
    port = types.SimpleNamespace(shape=(2, 4), axis_names=("dcn", "data"))
    jmesh = types.SimpleNamespace(devices=np.empty((2, 4), dtype=object),
                                  axis_names=("dcn", "data"))
    assert gspmd.group_axes(groups, port) == \
        jgspmd.group_axes(groups, jmesh)


def test_record_collectives_at_world_one(cpu_world):
    """A process-group collective is recorded with its result's bytes
    and its group's axes (one rank: ``replica``); DTensor's
    redistribution over a mesh dim of one rank issues none."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial

    def both():
        t = torch.ones(4)
        dist.all_reduce(t)
        plan = gspmd.derive_plan()
        d = DTensor.from_local(torch.ones(3), plan.device_mesh, [Partial()],
                               run_check=False)
        return gspmd.constrain(d, plan, ()).to_local()

    out, by_op, by_axes = gspmd.record_collectives(
        both, mesh=tmesh.get_mesh())
    assert out.tolist() == [1.0, 1.0, 1.0]
    assert by_op == {"all-reduce": {"calls": 1, "bytes": 16}}
    assert by_axes == {"replica": {"calls": 1, "bytes": 16,
                                   "ops": {"all-reduce": 16}}}
    assert gspmd.collective_bytes(both) == by_op
    assert gspmd.collective_axis_bytes(both) == by_axes


# ---- what the 2-rank spawn runs -----------------------------------------

def _torch_global(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _rows(x):
    """This rank's rows of a global batch."""
    w, r = hvd_t.size(), hvd_t.rank()
    n = x.shape[0] // w
    return x[r * n:(r + 1) * n]


def _mlp(in_features, features, seed):
    return MLP(in_features, features,
               generator=torch.Generator().manual_seed(seed))


def _tiled(seed, shard_rows=4, world=None):
    """The dryrun's identical per-shard batches, tiled over the world."""
    world = world or hvd_t.size()
    rng = np.random.default_rng(seed)
    sx = rng.standard_normal((shard_rows, 12)).astype(np.float32)
    sy = rng.integers(0, 4, size=(shard_rows,))
    return (_torch_global(np.tile(sx, (world, 1))),
            _torch_global(np.tile(sy, world)).long())


def run_1b4(spmd, hierarchical=False):
    """The dryrun's 1b4 (``__graft_entry__.py:222-283``): MLP (32, 16, 4)
    under ZeRO-1 Adam 0.05, 8 steps, the GSPMD step on the global batch
    or the explicit overlapped ZeRO-1 step on this rank's rows;
    ``hierarchical`` orders the rows ICI-first on a (dcn, data) mesh."""
    x, y = _tiled(13)
    model = _mlp(12, (32, 16, 4), 3)
    opt = hvd_t.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=0.05),
        named_parameters=convert.flax_named_parameters(model),
        sharded_update=True, hierarchical=hierarchical)
    step = training.make_train_step(model, opt, spmd=spmd,
                                    overlap_grads=not spmd)
    if not spmd:
        x, y = _rows(x), _rows(y)
    losses = [float(step(x, y)) for _ in range(GSPMD_STEPS)]
    return losses, model, opt, step


def run_1b5(wire, sharded=True):
    """The dryrun's 1b5 (``__graft_entry__.py:286``): SGD(0.1, momentum
    0.9), ZeRO-1, the GSPMD step at ``wire``, 8 steps."""
    x, y = _tiled(7)
    model = _mlp(12, (32, 16, 4), 11)
    opt = hvd_t.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=convert.flax_named_parameters(model),
        sharded_update=sharded, compression=wire)
    step = training.make_train_step(model, opt, spmd=True)
    return [float(step(x, y)) for _ in range(WIRE_STEPS)], step


def _plain_batch(world):
    rng = np.random.default_rng(5)
    sx = rng.standard_normal((2, 10)).astype(np.float32)
    sy = rng.integers(0, 3, size=(2,))
    return np.tile(sx, (world, 1)), np.tile(sy, world).astype(np.int32)


def _lm_tokens(world):
    return np.random.default_rng(0).integers(
        0, LM_WIDTHS["vocab_size"], size=(2 * world, 16)).astype(np.int32)


def port_plain(params0):
    """``tests/test_gspmd.py:119``'s plain DP MLP (16, 3), SGD(0.1,
    momentum 0.9), 5 GSPMD steps, from the JAX initial parameters."""
    x, y = _plain_batch(hvd_t.size())
    model = MLP(10, (16, 3))
    model.load_state_dict(convert.params_from_flax(params0, model))
    opt = hvd_t.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=convert.flax_named_parameters(model))
    step = training.make_train_step(model, opt, spmd=True)
    losses = [float(step(_torch_global(x), _torch_global(y).long()))
              for _ in range(5)]
    return (losses, convert.flax_from_params(model.state_dict(), model),
            step, opt)


def port_lm(params0):
    """``tests/test_gspmd.py:151``'s LM (vocab 32, 1 layer, d 16, fp32),
    Adam 1e-2, 4 GSPMD steps; attention through the flash island."""
    cfg = TransformerConfig(**LM_WIDTHS, dtype=torch.float32,
                            flash_attention=True)
    model = Transformer(cfg)
    model.load_state_dict(convert.params_from_flax(params0, cfg))
    opt = hvd_t.DistributedOptimizer(
        torch.optim.Adam(model.parameters(), lr=1e-2),
        named_parameters=convert.flax_named_parameters(model))
    step = training.make_lm_train_step(model, opt, spmd=True)
    tokens = _torch_global(_lm_tokens(hvd_t.size())).long()
    return [float(step(tokens)) for _ in range(4)]


def _ckpt_build(spmd):
    """``tests/test_gspmd.py:480``'s state: MLP (8, 3), Adam 0.05, ZeRO-1,
    int8 wire; the explicit step is the plain one (its ``step()``
    compresses statelessly)."""
    model = _mlp(6, (8, 3), 0)
    opt = hvd_t.DistributedOptimizer(  # optax.adam: AdamW without decay
        torch.optim.AdamW(model.parameters(), lr=0.05, weight_decay=0.0),
        named_parameters=convert.flax_named_parameters(model),
        sharded_update=True, compression="int8")
    return model, opt, training.make_train_step(model, opt, spmd=spmd)


def _ckpt_batch(spmd):
    rng = np.random.default_rng(11)
    x = _torch_global(rng.normal(size=(4, 6)).astype(np.float32))
    y = torch.arange(4) % 3
    return (x, y) if spmd else (_rows(x), _rows(y))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _leaves(flat):
    """The arrays of a flat training state, a ``ckpt.ZeroLeaf``'s rows
    included."""
    out = []
    for leaf in flat:
        if hasattr(leaf, "entries"):
            for _, _, value in leaf.entries:
                vals = value.values() if isinstance(value, dict) else [value]
                out.extend(_np(v) for v in vals)
        else:
            out.append(_np(leaf))
    return out


def ckpt_cross(from_spmd, root):
    """Two steps on one path, its state saved (``convert``,
    ``ckpt.save_sharded``) and restored into a fresh state of the other
    path: the restored state is the saved one bit for bit, and the next
    step's loss is, bit for bit, that path's step taken from the saved
    state itself. Returns ``(restored equal, next loss, the loss from the
    state itself)``."""
    from horovod_tpu_torch import ckpt
    model, opt, step = _ckpt_build(from_spmd)
    for _ in range(2):
        step(*_ckpt_batch(from_spmd))
    saved = convert.train_state_to_flat(model, opt, step.state)
    ckpt.save_sharded(root, 2, saved, rank=hvd_t.rank(), world=hvd_t.size())
    model2, opt2, step2 = _ckpt_build(not from_spmd)
    _, tree, _ = ckpt.restore_sharded(root, convert.train_state_to_flat(
        model2, opt2, step2.state))
    convert.train_state_from_flat(model2, opt2, step2.state, tree)
    got = _leaves(convert.train_state_to_flat(model2, opt2, step2.state))
    want = _leaves(saved)
    same = len(got) == len(want) and all(
        a.dtype == b.dtype and np.array_equal(a, b)
        for a, b in zip(got, want))
    batch = _ckpt_batch(not from_spmd)
    restored = float(step2(*batch))
    itself = float(training.make_train_step(model, opt,
                                            spmd=not from_spmd)(*batch))
    return same, restored, itself


def bn_run(spmd):
    """The smallest ResNet of ``tests/test_torch_resnet.py`` (one
    bottleneck block a stage, 8 filters), SGD(0.01, momentum 0.9), 3
    steps on 8 images of 32x32: the GSPMD step on the global batch, or
    the explicit step with ``bn_cross_replica_axes=("data",)`` on this
    rank's rows."""
    torch.manual_seed(0)
    model = resnet.ResNet((1, 1, 1, 1), resnet.BottleneckBlock,
                          num_filters=8, num_classes=10, dtype=torch.float32,
                          bn_cross_replica_axes=None if spmd else ("data",))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    opt = hvd_t.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9))
    step = training.make_train_step(model, opt, spmd=spmd)
    rng = np.random.default_rng(2)
    x = _torch_global(rng.standard_normal((8, 3, 32, 32)).astype(
        np.float32))
    y = _torch_global(rng.integers(0, 10, size=(8,))).long()
    if not spmd:
        x, y = _rows(x), _rows(y)
    losses = [float(step(x, y)) for _ in range(3)]
    return losses, start, {k: v.clone() for k, v in
                           model.state_dict().items()}


def dropout_losses():
    """The MNISTConvNet at lr 0 in training mode, 2 GSPMD steps with
    ``dropout_seed=3`` on 4 images (every rank the same global batch):
    the losses differ only by the dropout masks."""
    model = MNISTConvNet(image_shape=(8, 8, 1))
    opt = hvd_t.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                     lr=0.0))
    step = training.make_train_step(model, opt, dropout_seed=3, spmd=True)
    x = _torch_global(np.random.default_rng(5).standard_normal(
        (4, 8, 8, 1)).astype(np.float32))
    y = torch.tensor([1, 4, 1, 4])
    return [float(step(x, y)) for _ in range(2)]


def _norm_batch(world):
    """Two rows a rank, every row its own: on the tiled batches above
    the ranks' gradients agree, and the root-mean of their norms would
    be the exact norm."""
    rng = np.random.default_rng(17)
    return (rng.standard_normal((2 * world, 10)).astype(np.float32),
            rng.integers(0, 3, size=(2 * world,)).astype(np.int32))


def _norm_refs(model, rank_loss, world, wire_mean=None):
    """Plain autograd on a copy of ``model``: each rank's gradient of
    its local loss ``rank_loss(model, r)``, then ``(the norm of their
    mean, the root-mean of their norms)``, in fp64. With ``wire_mean``
    the first is the norm of the mean a chunked wire delivers
    (``wire_mean`` of the copies)."""
    grads, copies = [], []
    for r in range(world):
        m = copy.deepcopy(model)
        for p in m.parameters():
            p.grad = None
        rank_loss(m, r).backward()
        copies.append(m)
        grads.append(torch.cat([p.grad.reshape(-1).double()
                                for p in m.parameters()]))
    mean = sum(grads) / world
    exact = float(mean.norm()) if wire_mean is None else wire_mean(copies)
    return (exact,
            float(torch.stack([g.norm() ** 2 for g in grads]).mean()
                  .sqrt()))


def _wire_mean_norm(model, opt, schedules):
    """The norm, in fp64, of the mean that the chunked wire of ``opt``
    delivers over ``schedules`` (``(schedule, bucket)`` pairs over the
    optimizer's packing order): each rank's ``[world, shard]`` rows
    quantized and decoded, then averaged over the ranks; row ``j`` is
    rank ``j``'s reduced shard. Plain autograd supplies each rank's
    gradients."""
    wire = opt.compression
    index = {id(p): i for i, p in enumerate(model.parameters())}

    def norm(copies):
        total = 0.0
        for sched, i in schedules:
            shard = sched.shard_sizes[i]
            q = wire.for_length(shard)
            rows = []
            for m in copies:
                params = list(m.parameters())
                leaves = [params[index[id(p)]].grad for p in opt.params]
                flat = fusion.pack_padded(sched, i, leaves).float()
                packed, scales = q.compress_flat(
                    flat.reshape(sched.world, shard))
                rows.append(q.decompress_flat(packed, scales,
                                              torch.float32,
                                              n=shard).double())
            total += float((sum(rows) / len(rows)).square().sum())
        return total ** 0.5
    return norm


def _island_schedules(opt, world, lm):
    """The ``(schedule, bucket)`` pairs a chunked island reduce-scatters:
    the overlapped step's schedule, or for the LM step the forward
    buckets of ``fused_allreduce_``, one schedule each."""
    if not lm:
        sched = fusion.bucket_schedule(
            opt.params, world, threshold_bytes=opt.threshold_bytes,
            perms=opt.perms, axes=opt.axes)
        return [(sched, i) for i in range(len(sched.buckets))]
    out = []
    for b in fusion.plan_buckets(opt.params,
                                 fusion._threshold(opt.threshold_bytes),
                                 perms=opt.perms):
        size = sum(b.sizes)
        out.append((fusion.BucketSchedule(
            buckets=(b,), padded_sizes=(size + (-size) % world,),
            world=world, axes=opt.reduce_axes()), 0))
    return out


def _norm_run(model, step, batch, spmd, rank_loss, wire_mean=None):
    got, refs = [], []
    for _ in range(NORM_STEPS):
        refs.append(_norm_refs(model, rank_loss, hvd_t.size(), wire_mean))
        step(*batch) if spmd else step(*(_rows(b) for b in batch))
        got.append(step.instruments.grad_norm.value)
    return {"got": got, "refs": refs}


# path: (step builder's kwargs, DistributedOptimizer's kwargs)
NORM_PATHS = {
    "spmd": (dict(spmd=True), {}),
    "spmd_zero": (dict(spmd=True), dict(sharded_update=True)),
    "plain": ({}, {}),
    "overlap": (dict(overlap_grads=True), {}),
    "overlap_zero": (dict(overlap_grads=True), dict(sharded_update=True)),
    "zero": ({}, dict(sharded_update=True)),
    "bpps2": ({}, dict(backward_passes_per_step=2)),
    "lm": ({}, {}),
    "lm_spmd": (dict(spmd=True), {}),
    "lm_zero": ({}, dict(sharded_update=True)),
    # the chunked wires' GSPMD islands: the norm of the mean the wire
    # delivers (the reduce-scattered shards)
    "spmd_int8": (dict(spmd=True, error_feedback=False),
                  dict(compression="int8")),
    "spmd_fp8": (dict(spmd=True, error_feedback=False),
                 dict(compression="fp8_e4m3")),
    "lm_spmd_int8": (dict(spmd=True), dict(compression="int8")),
}
NORM_WIRES = ("spmd_int8", "spmd_fp8", "lm_spmd_int8")
# where the norm is the root-mean of the ranks' local norms (the JAX
# definition where the step holds only local gradients), not the exact
# norm of their mean
NORM_ROOT_MEAN = ("zero", "bpps2", "lm_zero")


def grad_norms(mlp0, lm0):
    """``hvd_grad_norm`` after each of 2 steps on every path, from the
    JAX initial parameters (the MLP (16, 3) under SGD(0.1, momentum
    0.9), the LM under Adam 1e-2), beside the references of the same
    step (``_norm_refs``)."""
    world = hvd_t.size()
    x, y = (_torch_global(a) for a in _norm_batch(world))
    y = y.long()
    tokens = _torch_global(_lm_tokens(world)).long()

    def mlp_loss(m, r):
        return training.softmax_cross_entropy(m(x[2 * r:2 * r + 2]),
                                              y[2 * r:2 * r + 2])

    def lm_loss(m, r):
        t = tokens[2 * r:2 * r + 2]
        return training.softmax_cross_entropy(m(t)[:, :-1], t[:, 1:])

    out = {}
    for name, (step_kw, opt_kw) in NORM_PATHS.items():
        if name.startswith("lm"):
            cfg = TransformerConfig(**LM_WIDTHS, dtype=torch.float32,
                                    flash_attention=True)
            model = Transformer(cfg)
            model.load_state_dict(convert.params_from_flax(lm0, cfg))
            inner = torch.optim.Adam(model.parameters(), lr=1e-2)
        else:
            model = MLP(10, (16, 3))
            model.load_state_dict(convert.params_from_flax(mlp0, model))
            inner = torch.optim.SGD(model.parameters(), lr=0.1,
                                    momentum=0.9)
        opt = hvd_t.DistributedOptimizer(
            inner, named_parameters=convert.flax_named_parameters(model),
            **opt_kw)
        wire_mean = (_wire_mean_norm(model, opt, _island_schedules(
            opt, world, name.startswith("lm")))
            if name in NORM_WIRES else None)
        if name.startswith("lm"):
            step = training.make_lm_train_step(model, opt, telemetry=True,
                                               **step_kw)
            out[name] = _norm_run(model, step, (tokens,),
                                  step_kw.get("spmd"), lm_loss, wire_mean)
        else:
            step = training.make_train_step(model, opt, telemetry=True,
                                            **step_kw)
            out[name] = _norm_run(model, step, (x, y), step_kw.get("spmd"),
                                  mlp_loss, wire_mean)
    return out


def _jsonable(d):
    return json.loads(json.dumps(d, default=lambda o: o.tolist()
                                 if hasattr(o, "tolist") else str(o)))


def rank_checks(out_dir, start_path):
    """Every 2-rank check, on each rank; the results go to
    ``out_dir/rank<r>.json``."""
    hvd_t.init(device="cpu")
    start = np.load(start_path, allow_pickle=True)
    r = hvd_t.rank()
    res = {}
    ex, ex_model, _, _ = run_1b4(False)
    sp, sp_model, sp_opt, sp_step = run_1b4(True)
    res["1b4"] = dict(
        explicit=ex, spmd=sp,
        params_gap=max(float((a - b).detach().abs().max()) for a, b in zip(
            ex_model.parameters(), sp_model.parameters())),
        collectives=sp_step.compiled_collectives,
        axes=sp_step.compiled_axis_collectives,
        shard_sizes=list(sp_opt.zero_state.plan.schedule.shard_sizes),
        padded_sizes=list(sp_opt.zero_state.plan.schedule.padded_sizes),
        rows={k: [list(v.shape), list(v.to_local().shape)]
              for k, v in gspmd.place_state(
                  sp_step.plan, sp_model, sp_opt)["opt_state"]["b0"].items()
              if hasattr(v, "placements") and v.placements[0].is_shard()})
    exact, _ = run_1b5(None)
    res["1b5"] = {"exact": exact}
    for wire in ("int8", "fp8_e4m3", "bf16"):
        losses, step = run_1b5(wire)
        res["1b5"][wire] = losses
        res["1b5"][wire + "/collectives"] = step.compiled_collectives
    losses, params, step, opt = port_plain(start["plain"].item())
    res["plain"] = dict(losses=losses, params=params,
                        collectives=step.compiled_collectives,
                        buckets=len(fusion.plan_buckets(
                            opt.params, basics.fusion_threshold())))
    res["lm"] = port_lm(start["lm"].item())
    res["ckpt"] = {
        "from_explicit": ckpt_cross(False, os.path.join(out_dir, "ce")),
        "from_spmd": ckpt_cross(True, os.path.join(out_dir, "cs"))}
    res["bn"] = {}
    for spmd in (False, True):
        losses, start_sd, end_sd = bn_run(spmd)
        res["bn"][str(spmd)] = dict(
            losses=losses, end={k: v.numpy() for k, v in end_sd.items()
                                if v.is_floating_point()},
            start={k: v.numpy() for k, v in start_sd.items()
                   if v.is_floating_point()})
    res["dropout"] = dropout_losses()
    res["norms"] = grad_norms(start["norm"].item(), start["lm"].item())
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
        json.dump(_jsonable(res), f)
    hvd_t.shutdown()


_WORKER = textwrap.dedent("""
    import sys
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, {tests!r})
    from test_torch_gspmd import rank_checks
    rank_checks({out!r}, {start!r})
""")


def _run_two_ranks(src, timeout):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(2):
        env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE="2",
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE="2",
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


def _jax_plain(world):
    """JAX's GSPMD plain DP step on ``world`` devices
    (``tests/test_gspmd.py:119-148``): initial params, losses, params."""
    hvd_j.shutdown()
    hvd_j.init(devices=jax.devices()[:world])
    try:
        x, y = _plain_batch(world)
        model = JMLP(features=(16, 3))
        tx = hvd_j.DistributedOptimizer(optax.sgd(0.1, momentum=0.9))
        state = jtraining.create_train_state(model, tx,
                                             jax.random.PRNGKey(1),
                                             jnp.asarray(x[:1]))
        params0 = jax.tree_util.tree_map(np.asarray, state.params)
        step = jtraining.make_train_step(model, tx, donate=False, spmd=True)
        losses = []
        for _ in range(5):
            state, loss = step(state, jnp.asarray(x), jnp.asarray(y))
            losses.append(float(loss))
        return params0, losses, jax.tree_util.tree_map(np.asarray,
                                                       state.params)
    finally:
        hvd_j.shutdown()


def _jax_lm(world):
    """JAX's GSPMD LM step on ``world`` devices (``:151-177``)."""
    hvd_j.shutdown()
    hvd_j.init(devices=jax.devices()[:world])
    try:
        cfg = JConfig(**LM_WIDTHS, dtype=jnp.float32, flash_attention=False)
        model = JTransformer(cfg)
        tokens = jnp.asarray(_lm_tokens(world))
        tx = hvd_j.DistributedOptimizer(optax.adam(1e-2))
        state = jtraining.create_train_state(model, tx,
                                             jax.random.PRNGKey(2),
                                             tokens[:1])
        params0 = jax.tree_util.tree_map(np.asarray, state.params)
        step = jtraining.make_lm_train_step(model, tx, donate=False,
                                            spmd=True)
        losses = []
        for _ in range(4):
            state, loss = step(state, tokens)
            losses.append(float(loss))
        return params0, losses
    finally:
        hvd_j.shutdown()


def _jax_norms(world):
    """JAX's ``hvd_grad_norm`` after each of 2 steps of the MLP (16, 3)
    under SGD(0.1, momentum 0.9) on ``world`` devices, on the GSPMD plain
    DP step, the explicit overlapped step and the GSPMD step's int8 and
    fp8 islands: the initial parameters and ``{path: norms}``."""
    hvd_j.shutdown()
    hvd_j.init(devices=jax.devices()[:world])
    try:
        x, y = (jnp.asarray(a) for a in _norm_batch(world))
        model = JMLP(features=(16, 3))
        tx = hvd_j.DistributedOptimizer(optax.sgd(0.1, momentum=0.9))
        state0 = jtraining.create_train_state(model, tx,
                                              jax.random.PRNGKey(4), x[:1])
        norms = {}
        for name, kw, wire in (
                ("spmd", dict(spmd=True), None),
                ("overlap", dict(overlap_grads=True), None),
                ("spmd_int8", dict(spmd=True, error_feedback=False), "int8"),
                ("spmd_fp8", dict(spmd=True, error_feedback=False),
                 "fp8_e4m3")):
            tx = hvd_j.DistributedOptimizer(optax.sgd(0.1, momentum=0.9),
                                            compression=wire)
            step = jtraining.make_train_step(model, tx, donate=False,
                                             telemetry=True, **kw)
            state, norms[name] = state0, []
            for _ in range(NORM_STEPS):
                state, _ = step(state, x, y)
                norms[name].append(
                    jreg.get_registry().get(jinst.GRAD_NORM).value)
        return jax.tree_util.tree_map(np.asarray, state0.params), norms
    finally:
        hvd_j.shutdown()


def _assert_tree(got, want, **tol):
    """A flax tree from JSON (nested dicts of lists) against the JAX one."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree(got[k], want[k], **tol)
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _rel(got, want, floor=0.0):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)
                        / np.maximum(np.abs(want), floor)))


def test_two_gloo_ranks(tmp_path):
    """On 2 gloo ranks (one spawn):

    * 1b4: the GSPMD ZeRO-1 step within ``GSPMD_EPSILON`` of the explicit
      overlapped ZeRO-1 step at every step, the parameters close, the
      collectives recorded, each rank's ZeRO rows 1 of 2;
    * 1b5: int8 and fp8 islands (error feedback on) within
      ``WIRE_EPSILON`` of the exact GSPMD step; the bf16 cast too;
    * the counts: one reduce-scatter and one all-gather a ZeRO-1 bucket,
      one all-reduce a plain bucket, the loss's one scalar all-reduce and
      nothing else; bytes from the shapes (the bf16 wire's half); every
      collective over the ``data`` axis; the islands' all-to-alls;
    * plain DP within rtol 1e-5, atol 1e-7 of JAX's GSPMD step on 2
      devices, the LM within rtol 1e-4, atol 1e-6;
    * checkpoints crossing both ways bit for bit, and the next loss the
      step from the saved state itself, bit for bit;
    * the GSPMD step's global BatchNorm against the explicit step's
      ``bn_cross_replica_axes=("data",)`` (losses rtol 1e-5, every leaf
      within 1e-6 + 5e-2 max|x - x0|);
    * the dropout masks at world 2 those at world 1;
    * ``hvd_grad_norm`` on every path of ``NORM_PATHS``, on rows that
      differ from rank to rank, within ``NORM_RTOL`` of plain autograd:
      the exact norm of the ranks' mean gradient, or on the paths of
      ``NORM_ROOT_MEAN`` the root-mean of the ranks' local norms; and on
      the GSPMD and overlapped paths within ``NORM_RTOL`` of JAX's
      ``hvd_grad_norm`` on the same inputs."""
    p_params0, p_losses, p_params = _jax_plain(2)
    l_params0, l_losses = _jax_lm(2)
    n_params0, j_norms = _jax_norms(2)
    start = tmp_path / "start.npz"
    np.savez(start, plain=np.array(p_params0, dtype=object),
             lm=np.array(l_params0, dtype=object),
             norm=np.array(n_params0, dtype=object))
    _run_two_ranks(_WORKER.format(tests=os.path.join(REPO, "tests"),
                                  out=str(tmp_path), start=str(start)),
                   timeout=240)
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(2)]
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    try:
        world1_dropout = dropout_losses()
    finally:
        hvd_t.shutdown()
    for r, res in enumerate(ranks):
        b4 = res["1b4"]
        assert np.all(np.isfinite(b4["spmd"]))
        assert _rel(b4["spmd"], b4["explicit"], 1e-6) <= GSPMD_EPSILON, b4
        assert b4["params_gap"] <= 1e-5, b4["params_gap"]
        buckets = len(b4["shard_sizes"])
        assert b4["collectives"] == {
            "reduce-scatter": {"calls": buckets,
                               "bytes": 4 * sum(b4["shard_sizes"])},
            "all-gather": {"calls": buckets,
                           "bytes": 4 * sum(b4["padded_sizes"])},
            "all-reduce": {"calls": 1, "bytes": 4}}, b4["collectives"]
        assert set(b4["axes"]) == {"data"}
        assert b4["rows"] and all(
            shape == [2, b4["shard_sizes"][0]] and local[0] == 1
            for shape, local in b4["rows"].values()), b4["rows"]
        b5 = res["1b5"]
        for wire in ("int8", "fp8_e4m3", "bf16"):
            assert _rel(b5[wire], b5["exact"], WIRE_EPSILON_FLOOR) <= \
                WIRE_EPSILON, (wire, b5[wire], b5["exact"])
        for wire in ("int8", "fp8_e4m3"):
            assert b5[wire + "/collectives"]["all-to-all"]["calls"] >= 1
        cast = b5["bf16/collectives"]
        assert "all-to-all" not in cast
        assert cast["reduce-scatter"]["bytes"] == \
            2 * sum(b4["shard_sizes"])
        assert cast["all-gather"]["bytes"] == 2 * sum(b4["padded_sizes"])
        plain = res["plain"]
        np.testing.assert_allclose(plain["losses"], p_losses, rtol=1e-5,
                                   atol=1e-7)
        _assert_tree(plain["params"], p_params, rtol=1e-5, atol=1e-6)
        assert plain["collectives"] == {
            "all-reduce": {"calls": plain["buckets"] + 1,
                           "bytes": 4 * (10 * 16 + 16 + 16 * 3 + 3) + 4}}
        np.testing.assert_allclose(res["lm"], l_losses, rtol=1e-4,
                                   atol=1e-6)
        for key, (same, restored, itself) in res["ckpt"].items():
            assert same, key
            assert restored == itself, (key, restored, itself)
        ex, sp = res["bn"]["False"], res["bn"]["True"]
        np.testing.assert_allclose(sp["losses"], ex["losses"], rtol=1e-5)
        for k, want in ex["end"].items():
            want = np.asarray(want)
            moved = np.abs(want - np.asarray(ex["start"][k])).max()
            np.testing.assert_allclose(np.asarray(sp["end"][k]), want,
                                       rtol=0, atol=1e-6 + 5e-2 * moved,
                                       err_msg=f"{k} rank {r}")
        np.testing.assert_allclose(res["dropout"], world1_dropout,
                                   rtol=1e-6)
        assert res["dropout"][0] != res["dropout"][1]
        assert set(res["norms"]) == set(NORM_PATHS)
        for name, run in res["norms"].items():
            which = 1 if name in NORM_ROOT_MEAN else 0
            for got, refs in zip(run["got"], run["refs"]):
                # the rows tell the two definitions apart
                assert refs[1] > refs[0] * (1 + 100 * NORM_RTOL), refs
                np.testing.assert_allclose(got, refs[which],
                                           rtol=NORM_RTOL, err_msg=name)
        for name, want in j_norms.items():
            np.testing.assert_allclose(res["norms"][name]["got"], want,
                                       rtol=NORM_RTOL, err_msg=name)
    # both ranks hold the same trajectories
    assert ranks[0]["1b4"]["spmd"] == ranks[1]["1b4"]["spmd"]
    assert ranks[0]["lm"] == ranks[1]["lm"]
