"""The port's wire compression (horovod_tpu_torch/ops/compression.py, the
compressed bucket ops of ops/fusion.py, ``DistributedOptimizer``'s wire
resolution and ``make_train_step``'s error feedback) against the JAX
package's, on the same numpy inputs.

The quantizers and the bucket ops agree bit for bit: the same flat
bucket goes into both sides, and both compute in fp32 with the same
operations (round half to even, IEEE division). That holds on real
layouts too: the LM's and the conv net's leaves, packed in their flax
layouts, give JAX's buckets element for element, so each chunk of 256
holds the elements JAX's holds and the int8 ops agree bit for bit.
Trajectories through a model differ in summation order, so a chunked
wire is held to the exact run by ``WIRE_EPSILON``, and a cast wire,
which is elementwise, to the JAX run at loss rtol 1e-5 and params atol
1e-6.

Multi-rank checks run the port on 2 gloo processes (one spawn for the
whole file) and the JAX package under ``shard_map`` on 2 CPU devices.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import horovod_tpu as hvd_j
import horovod_tpu_torch as hvd_t
from __graft_entry__ import WIRE_EPSILON, WIRE_EPSILON_FLOOR, WIRE_STEPS
from horovod_tpu import training
from horovod_tpu.models.simple import MLP as JMLP
from horovod_tpu.ops import compression as jcomp
from horovod_tpu.ops import fusion as jfusion
from horovod_tpu_torch import convert
from horovod_tpu_torch import training as t_training
from horovod_tpu_torch.models.simple import MLP
from horovod_tpu_torch.ops import compression as tcomp
from horovod_tpu_torch.ops import fusion as tfusion

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNKED = ["int8", "fp8_e4m3", "fp8_e5m2"]
WIRES = CHUNKED + ["bf16"]
# leaves of the bucket-op check: a zero chunk, ragged tails, values
# across 30 decades; at THRESHOLD 4096 bytes they make three buckets,
# whose world-2 shards are below, at and above the 256-element chunk
LEAF_SHAPES = [(30, 20), (7,), (256,), (512,), (3, 5)]
THRESHOLD = 4096
# the MLP trajectories: as tests/test_torch_zero.py's
IN, FEATURES, BATCH = 6, (10, 7, 3), 8
LR, WD = 1e-3, 1e-4


def _hard_values(rng, shape):
    x = rng.standard_normal(shape) * np.exp(rng.uniform(-12, 12, shape))
    return x.astype(np.float32)


def _quantizer_input():
    """Rows of 700 elements: a zero chunk, a tail of 188, spikes of
    +-3e38 beside values of 1e-30, a row of one sign. Every scale stays a
    normal number: XLA's CPU backend flushes subnormals to zero, torch
    keeps them, so a chunk of 1 holding 1e-38 would get another scale."""
    rng = np.random.default_rng(0)
    x = _hard_values(rng, (4, 700))
    x[0, :256] = 0.0
    x[1, 300] = 3e38
    x[1, 301] = -3e38
    x[2, 5:9] = [1e-30, -1e-30, 0.0, 5e-31]
    x[3] = np.abs(x[3])
    return x


def _bits(t):
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        return t.view(torch.uint8).numpy()
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jbits(a):
    a = np.asarray(a)
    if "float8" in str(a.dtype):
        return a.view(np.uint8)
    return a.astype(np.float32) if "bfloat16" in str(a.dtype) else a


@pytest.mark.parametrize("chunk", [256, 100, 1])
@pytest.mark.parametrize("name", CHUNKED)
def test_quantizer_matches_jax_bit_for_bit(name, chunk):
    """Wire bytes, scales, the round trip's dequantized values and
    ``decompress_flat``, at the default chunk and at ``for_length``'s
    clamped ones, on rows of a 2-D input."""
    x = _quantizer_input()
    jq, tq = jcomp.by_name(name).for_length(chunk), \
        tcomp.by_name(name).for_length(chunk)
    assert tq.chunk == jq.chunk == min(chunk, 256)
    jw, js, jd = jq.roundtrip(jnp.asarray(x))
    tw, ts, td = tq.roundtrip(torch.from_numpy(x))
    assert tw.shape == jw.shape and ts.shape == js.shape
    np.testing.assert_array_equal(_bits(tw), _jbits(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    tw2, ts2 = tq.compress_flat(torch.from_numpy(x))
    assert torch.equal(tw2.view(torch.uint8), tw.view(torch.uint8))
    assert torch.equal(ts2, ts)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            _bits(tq.decompress_flat(tw, ts, dtype, n=700)),
            _jbits(jq.decompress_flat(jw, js, jdtype, n=700)))
    # a zero chunk keeps scale 1
    assert float(ts[0, 0]) == 1.0
    # the single-tensor interface
    tz, ctx = tq.compress(torch.from_numpy(x))
    np.testing.assert_array_equal(
        tq.decompress(tz, ctx).numpy(),
        np.asarray(jq.decompress(*jq.compress(jnp.asarray(x)))))


@pytest.mark.parametrize("name", ["bf16", "fp16", "float16"])
def test_cast_compressors_match_jax(name):
    x = _hard_values(np.random.default_rng(1), (3, 40)) * 1e-30
    jc, tc = jcomp.by_name(name), tcomp.by_name(name)
    assert tc.name == jc.name and tc.chunked is False
    jw, _, jd = jc.roundtrip(jnp.asarray(x))
    tw, ts, td = tc.roundtrip(torch.from_numpy(x))
    assert ts is None
    np.testing.assert_array_equal(tw.float().numpy(),
                                  np.asarray(jw).astype(np.float32))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    t, ctx = tc.compress(torch.from_numpy(x))
    assert t.dtype == tc.wire_dtype and ctx == torch.float32
    assert tc.decompress(t, ctx).dtype == torch.float32


def test_fp16_is_bf16_and_names_resolve_as_in_jax():
    assert tcomp.Compression.fp16 is tcomp.Compression.bf16
    assert tcomp.Compression.fp8 is tcomp.Compression.fp8_e4m3
    assert tcomp.Compression.float16.wire_dtype == torch.float16
    assert tcomp.Compression.fp8_e4m3.wire_dtype == torch.float8_e4m3fn
    assert tcomp.Compression.fp8_e5m2.range_max == 57344.0
    assert tcomp.Compression.fp8_e4m3.range_max == 448.0
    for name in sorted(jcomp._BY_NAME) + ["INT8", "Bf16"]:
        j, t = jcomp.by_name(name), tcomp.by_name(name)
        assert (j is None) == (t is None)
        if t is not None:
            assert t.name == j.name and t.chunked == j.chunked
    assert tcomp.by_name(None) is None
    with pytest.raises(ValueError, match="unknown wire dtype"):
        tcomp.by_name("int4")


def test_non_float_passes_through_bit_for_bit():
    x = torch.tensor([[-(2 ** 31), 7, 2 ** 31 - 1]], dtype=torch.int64)
    for name in WIRES + ["float16"]:
        wire = tcomp.by_name(name)
        w, scales, deq = wire.roundtrip(x)
        assert w is x and scales is None and deq is x
        assert wire.compress(x) == (x, None)
        assert wire.decompress_flat(w, None, torch.int64, n=2).tolist() \
            == [[-(2 ** 31), 7]]


@pytest.mark.parametrize("n", [1, 100, 256, 700])
def test_wire_bytes_match_jax(n):
    for name in WIRES + ["float16"]:
        j, t = jcomp.by_name(name), tcomp.by_name(name)
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16),
                         (jnp.int32, torch.int32)):
            assert t.wire_bytes(n, tdt) == j.wire_bytes(n, jdt), (name, jdt)
            if t.chunked:
                assert t.for_length(n).wire_bytes(n, tdt) == \
                    j.for_length(n).wire_bytes(n, jdt), (name, jdt)


@pytest.fixture()
def cpu_world():
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    yield hvd_t
    hvd_t.shutdown()


def test_allreduce_takes_cast_wires_only(cpu_world):
    x = torch.tensor([1.0 + 2 ** -10, 3.0])
    out = hvd_t.allreduce(x, compression="bf16")
    assert out.dtype == torch.float32
    assert out.tolist() == [1.0, 3.0]  # rounded to bf16 on the wire
    assert x.tolist() == [1.0 + 2 ** -10, 3.0]
    for name in CHUNKED:
        with pytest.raises(ValueError, match="chunked quantizer"):
            hvd_t.allreduce(x, compression=name)


def test_fused_allreduce_world_one(cpu_world):
    """At world 1 a chunked wire is dropped (there is no wire), a cast wire
    still narrows, and a chunked wire with Max raises."""
    x = torch.tensor([1.0 + 2 ** -10, 2.0 ** -20])
    for name in CHUNKED:
        t = [x.clone()]
        tfusion.fused_allreduce_(t, compression=name)
        assert torch.equal(t[0], x)
    t = [x.clone()]
    tfusion.fused_allreduce_(t, compression="bf16")
    assert t[0].tolist() == [1.0, 2.0 ** -20]
    with pytest.raises(ValueError, match="Sum/Average"):
        tfusion.fused_allreduce_([x.clone()], op=hvd_t.Max,
                                 compression="int8")


def _opt(model, **kw):
    return hvd_t.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), **kw)


@pytest.mark.parametrize("op", ["Min", "Max", "Adasum"])
def test_chunked_wire_rejects_other_reductions(cpu_world, monkeypatch, op):
    """Given explicitly, a chunked wire with Min, Max or Adasum raises;
    from HOROVOD_WIRE_DTYPE it is ignored with one warning; a cast wire
    composes."""
    model = MLP(IN, FEATURES)
    for name in CHUNKED:
        with pytest.raises(ValueError, match="chunked wire format"):
            _opt(model, op=getattr(hvd_t, op), compression=name)
    assert _opt(model, op=getattr(hvd_t, op),
                compression="bf16").compression is tcomp.Compression.bf16
    monkeypatch.setattr(hvd_t.basics._state.config, "wire_dtype", "int8")
    opt = _opt(model, op=getattr(hvd_t, op))
    with pytest.warns(UserWarning, match="ignoring HOROVOD_WIRE_DTYPE"):
        assert opt.compression is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert opt.compression is None  # warned once


def test_every_name_and_member_is_accepted(cpu_world):
    model = MLP(IN, FEATURES)
    for name in tcomp._BY_NAME:
        assert _opt(model, compression=name).compression is \
            tcomp.by_name(name)
    for member in ("none", "bf16", "fp16", "float16", "fp8", "fp8_e4m3",
                   "fp8_e5m2", "int8"):
        wire = getattr(tcomp.Compression, member)
        got = _opt(model, compression=wire).compression
        assert got is (None if member == "none" else wire)


def test_none_pins_uncompressed_and_config_is_read_at_use(cpu_world,
                                                          monkeypatch):
    cfg = hvd_t.basics._state.config
    model = MLP(IN, FEATURES)
    pinned = _opt(model, compression="none")
    pinned_member = _opt(model, compression=tcomp.Compression.none)
    deferred = _opt(model)
    assert deferred.compression is None
    monkeypatch.setattr(cfg, "wire_dtype", "fp8_e5m2")
    assert deferred.compression is tcomp.Compression.fp8_e5m2
    assert pinned.compression is None
    assert pinned_member.compression is None
    monkeypatch.setattr(cfg, "wire_dtype", "none")
    assert deferred.compression is None


def test_wire_drift_warns_once(cpu_world, monkeypatch):
    """The overlapped step keeps the wire it was built with and warns once
    when the optimizer's resolution moves."""
    cfg = hvd_t.basics._state.config
    monkeypatch.setattr(cfg, "wire_dtype", "int8")
    model = MLP(IN, FEATURES)
    opt = _opt(model)
    step = t_training.make_train_step(model, opt, overlap_grads=True)
    assert step.wire is tcomp.Compression.int8
    x, y = torch.zeros(4, IN), torch.zeros(4, dtype=torch.long)

    def drift_warnings():
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            step(x, y)
        return [w for w in seen if "train step was built" in str(w.message)]

    assert drift_warnings() == []
    monkeypatch.setattr(cfg, "wire_dtype", "bf16")
    (w,) = drift_warnings()
    assert "resolves to 'bfloat16'" in str(w.message)
    assert "built with 'int8'" in str(w.message)
    assert drift_warnings() == []
    assert step.wire is tcomp.Compression.int8


def test_residuals_are_lazy_reset_and_dropped_by_a_failing_step(cpu_world):
    """One fp32 residual per bucket and direction, allocated at the first
    step, kept outside the optimizer state; ``reset_error_feedback`` and
    a step that raises drop them."""
    model = MLP(IN, FEATURES)
    opt = _opt(model, compression="int8", threshold_bytes=200)
    step = t_training.make_train_step(model, opt, accum_steps=2,
                                      overlap_grads=True)
    assert step.residuals() is None
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, IN)).astype(np.float32))
    y = torch.tensor([0, 1, 2, 0])
    step(x, y)
    res = step.residuals()
    sched = step.schedule
    assert len(sched.buckets) > 1
    assert [r.shape[0] for r in res["rs"]] == list(sched.padded_sizes)
    assert [r.shape[0] for r in res["ag"]] == list(sched.shard_sizes)
    assert all(r.dtype == torch.float32 for r in res["rs"] + res["ag"])
    assert any(float(r.abs().max()) > 0 for r in res["rs"])
    assert not any(id(r) in {id(v) for s in opt.optimizer.state.values()
                             for v in s.values()} for r in res["rs"])
    step.reset_error_feedback()
    assert step.residuals() is None
    step(x, y)
    assert step.residuals() is not None
    with pytest.raises(ValueError, match="microbatches"):
        step(x[:3], y[:3])
    assert step.residuals() is None
    step(x, y)
    assert step.residuals() is not None


def test_no_residuals_without_error_feedback_or_wire(cpu_world):
    model = MLP(IN, FEATURES)
    x, y = torch.zeros(4, IN), torch.zeros(4, dtype=torch.long)
    for kw, ef in ((dict(compression="int8"), False), ({}, True)):
        step = t_training.make_train_step(model, _opt(model, **kw),
                                          overlap_grads=True,
                                          error_feedback=ef)
        step(x, y)
        assert step.residuals() is None


def _mlp_data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, IN)).astype(np.float32)
    y = rng.integers(0, FEATURES[-1], size=(BATCH,)).astype(np.int32)
    return x, y


# (sharded_update, accum_steps) of the bf16-wire trajectories
BF16_CASES = [(False, 2), (True, 2)]


def _bf16_id(case):
    return f"{'sharded' if case[0] else 'replicated'}-accum{case[1]}"


def _jax_bf16_run(mesh, case, x, y):
    sharded, accum = case
    tx = hvd_j.DistributedOptimizer(optax.adamw(LR, weight_decay=WD),
                                    sharded_update=sharded,
                                    compression="bf16")
    model = JMLP(features=FEATURES)
    state = training.create_train_state(model, tx, jax.random.PRNGKey(0),
                                        jnp.asarray(x[:1]))
    params0 = jax.tree_util.tree_map(np.asarray, state.params)
    step = training.make_train_step(model, tx, mesh=mesh, donate=False,
                                    accum_steps=accum, overlap_grads=True)
    losses = []
    for _ in range(3):
        state, loss = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    return params0, losses, jax.tree_util.tree_map(np.asarray, state.params)


def _torch_bf16_run(case, params0, x, y):
    sharded, accum = case
    model = MLP(IN, FEATURES)
    model.load_state_dict(convert.params_from_flax(params0, model))
    opt = hvd_t.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=WD),
        named_parameters=convert.flax_named_parameters(model),
        sharded_update=sharded, compression="bf16")
    step = t_training.make_train_step(model, opt, accum_steps=accum,
                                      overlap_grads=True)
    world, rank = hvd_t.size(), hvd_t.rank()
    n = BATCH // world
    xs = torch.from_numpy(x[rank * n:(rank + 1) * n])
    ys = torch.from_numpy(y[rank * n:(rank + 1) * n]).long()
    losses = [float(step(xs, ys)) for _ in range(3)]
    return losses, convert.flax_from_params(model.state_dict(), model)


def _assert_bf16_matches(losses, params, j_losses, j_params):
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(np.asarray(b), a, atol=1e-6),
        j_params, params)


@pytest.fixture()
def jax_world():
    def make(n):
        hvd_j.shutdown()
        hvd_j.init(devices=jax.devices()[:n])
        return hvd_j.mesh()
    yield make
    hvd_j.shutdown()


@pytest.mark.parametrize("case", BF16_CASES, ids=_bf16_id)
def test_bf16_wire_trajectory_matches_jax_world_one(jax_world, case):
    x, y = _mlp_data()
    params0, j_losses, j_params = _jax_bf16_run(jax_world(1), case, x, y)
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    try:
        losses, params = _torch_bf16_run(case, params0, x, y)
    finally:
        hvd_t.shutdown()
    _assert_bf16_matches(losses, params, j_losses, j_params)


# -- world 2: one spawn runs every port-side check of this file ----------

def _bucket_inputs():
    """Per-rank leaves ([2, ...]), an rs residual per bucket (the padded
    bucket's size) and an all-gather shard and ag residual per bucket, for
    the world-2 schedule of LEAF_SHAPES at THRESHOLD."""
    rng = np.random.default_rng(11)
    leaves = [_hard_values(rng, (2,) + s) for s in LEAF_SHAPES]
    leaves[2][:, :] = 0.0  # a zero leaf: whole zero chunks
    sched = tfusion.bucket_schedule([torch.from_numpy(a[0]) for a in leaves],
                                    2, threshold_bytes=THRESHOLD)
    rs_res = [(rng.standard_normal((2, n)) * 1e-3).astype(np.float32)
              for n in sched.padded_sizes]
    ag_in = [_hard_values(rng, (2, n)) for n in sched.shard_sizes]
    ag_res = [(rng.standard_normal((2, n)) * 1e-3).astype(np.float32)
              for n in sched.shard_sizes]
    return dict(leaves=leaves, rs_res=rs_res, ag_in=ag_in, ag_res=ag_res)


def _port_bucket_ops(inp, rank):
    """The port's compressed bucket ops on this rank's inputs, every wire,
    with and without residuals (the reduce-scatter issued asynchronously
    and waited for)."""
    leaves = [torch.from_numpy(a[rank]) for a in inp["leaves"]]
    sched = tfusion.bucket_schedule(leaves, 2, threshold_bytes=THRESHOLD)
    out = {}
    for name in WIRES:
        wire = tcomp.by_name(name)
        for i in range(len(sched.buckets)):
            pending, res = tfusion.reduce_scatter_bucket_compressed(
                sched, i, leaves, wire, op=hvd_t.Average,
                residual=torch.from_numpy(inp["rs_res"][i][rank]),
                async_op=True)
            out[f"{name}/rs{i}"] = pending.wait()
            out[f"{name}/rs_res{i}"] = res
            out[f"{name}/rs_sum{i}"], none = \
                tfusion.reduce_scatter_bucket_compressed(
                    sched, i, leaves, wire, op=hvd_t.Sum)
            assert none is None
            flat, res = tfusion.all_gather_bucket_compressed(
                sched, i, torch.from_numpy(inp["ag_in"][i][rank]), wire,
                residual=torch.from_numpy(inp["ag_res"][i][rank]))
            out[f"{name}/ag{i}"], out[f"{name}/ag_res{i}"] = flat, res
    return {k: v.tolist() for k, v in out.items()}


# the real layouts of the int8 check: the LM's attention kernels
# (heads_in, heads_out) and Dense kernels, and the conv net's HWIO kernels,
# in buckets of at most 16 KB
LAYOUT_LM = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32,
                 d_ff=128)
LAYOUT_THRESHOLD = 16384


def _layout_models():
    from horovod_tpu.models.simple import MNISTConvNet as JConvNet
    from horovod_tpu.models.transformer import Transformer as JTransformer
    from horovod_tpu.models.transformer import TransformerConfig as JConfig
    from horovod_tpu_torch.models.simple import MNISTConvNet
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    return {"lm": (JTransformer(JConfig(**LAYOUT_LM, dtype=jnp.float32)),
                   jnp.zeros((1, 4), jnp.int32),
                   Transformer(TransformerConfig(**LAYOUT_LM))),
            "convnet": (JConvNet(), jnp.zeros((1, 8, 8, 1)),
                        MNISTConvNet(image_shape=(8, 8, 1)))}


def _layout_inputs():
    """Per model: each rank's gradient leaves in their flax shapes
    (``[2, ...]``) and their layouts."""
    rng = np.random.default_rng(13)
    out = {}
    for name, (jmodel, sample, tmodel) in _layout_models().items():
        shapes = jax.eval_shape(lambda: jmodel.init(  # noqa: B023
            jax.random.PRNGKey(0), sample))["params"]
        leaves = [_hard_values(rng, (2,) + x.shape)
                  for x in jax.tree_util.tree_leaves(shapes)]
        layouts = [lay for _, _, lay in
                   convert.flax_named_parameters(tmodel)]
        out[name] = dict(leaves=leaves, layouts=layouts)
    return out


def _port_layout_ops(inp, rank):
    """The port's int8 reduce-scatter (Average, with a zero residual) of
    each model's buckets, its leaves in torch's layout packed through
    their flax layouts."""
    out = {}
    wire = tcomp.by_name("int8")
    for name, d in inp.items():
        leaves = [convert._to_torch(torch.from_numpy(a[rank]), lay)
                  .contiguous() for a, lay in zip(d["leaves"], d["layouts"])]
        sched = tfusion.bucket_schedule(leaves, 2,
                                        threshold_bytes=LAYOUT_THRESHOLD,
                                        perms=[convert.flax_perm(lay)
                                               for lay in d["layouts"]])
        for i, n in enumerate(sched.padded_sizes):
            shard, res = tfusion.reduce_scatter_bucket_compressed(
                sched, i, leaves, wire, op=hvd_t.Average,
                residual=torch.zeros(n))
            out[f"{name}/rs{i}"], out[f"{name}/rs_res{i}"] = shard, res
    return {k: v.tolist() for k, v in out.items()}


def _jax_layout_ops(inp):
    hvd_j.shutdown()
    hvd_j.init(devices=jax.devices()[:2])
    try:
        out = {}
        wire = jcomp.by_name("int8")
        for name, d in inp.items():
            sched = jfusion.bucket_schedule(
                [a[0] for a in d["leaves"]], 2,
                threshold_bytes=LAYOUT_THRESHOLD, axes=("data",))

            def f(leaves, sched=sched, name=name):
                leaves = [a[0] for a in leaves]
                res = {}
                for i, n in enumerate(sched.padded_sizes):
                    s, r = jfusion.reduce_scatter_bucket_compressed(
                        sched, i, leaves, wire, op=hvd_j.Average,
                        residual=jnp.zeros((n,), jnp.float32))
                    res[f"{name}/rs{i}"], res[f"{name}/rs_res{i}"] = s, r
                return {k: v[None] for k, v in res.items()}

            fn = jax.shard_map(f, mesh=hvd_j.mesh(), in_specs=P("data"),
                               out_specs=P("data"), check_vma=False)
            out.update({k: np.asarray(v)
                        for k, v in fn(d["leaves"]).items()})
        return out
    finally:
        hvd_j.shutdown()


def _jax_bucket_ops(inp):
    """The same calls under ``shard_map`` on 2 devices: ``[2, ...]`` per
    key, row r rank r's."""
    hvd_j.shutdown()
    hvd_j.init(devices=jax.devices()[:2])
    try:
        mesh = hvd_j.mesh()
        sched = jfusion.bucket_schedule([a[0] for a in inp["leaves"]], 2,
                                        threshold_bytes=THRESHOLD,
                                        axes=("data",))

        def f(leaves, rs_res, ag_in, ag_res):
            leaves = [a[0] for a in leaves]
            out = {}
            for name in WIRES:
                wire = jcomp.by_name(name)
                for i in range(len(sched.buckets)):
                    s, r = jfusion.reduce_scatter_bucket_compressed(
                        sched, i, leaves, wire, op=hvd_j.Average,
                        residual=rs_res[i][0])
                    out[f"{name}/rs{i}"], out[f"{name}/rs_res{i}"] = s, r
                    out[f"{name}/rs_sum{i}"], _ = \
                        jfusion.reduce_scatter_bucket_compressed(
                            sched, i, leaves, wire, op=hvd_j.Sum)
                    flat, r = jfusion.all_gather_bucket_compressed(
                        sched, i, ag_in[i][0], wire, residual=ag_res[i][0])
                    out[f"{name}/ag{i}"], out[f"{name}/ag_res{i}"] = flat, r
            return {k: v[None] for k, v in out.items()}

        fn = jax.shard_map(f, mesh=mesh, in_specs=P("data"),
                           out_specs=P("data"), check_vma=False)
        out = fn(inp["leaves"], inp["rs_res"], inp["ag_in"], inp["ag_res"])
        return {k: np.asarray(v) for k, v in out.items()}
    finally:
        hvd_j.shutdown()


def _bowl(wire, ef):
    """The quadratic bowl of tests/test_compression.py on the port: 30
    steps of SGD(0.4) through the overlapped pipeline on identical
    shards; returns the final parameters (flax layout)."""
    d = 32
    rng = np.random.default_rng(3)
    q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    shard_x = (q * np.sqrt(d)).astype(np.float32)
    w_true = np.ones(d)
    w_true[0] = 300.0
    shard_y = (shard_x @ w_true).astype(np.float32)
    model = MLP(d, (1,))

    def mse(logits, labels):
        return ((logits[:, 0] - labels) ** 2).mean()

    opt = hvd_t.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.4),
        named_parameters=convert.flax_named_parameters(model),
        compression=wire)
    step = t_training.make_train_step(model, opt, loss_fn=mse,
                                      overlap_grads=True, error_feedback=ef)
    for _ in range(30):
        loss = float(step(torch.from_numpy(shard_x),
                          torch.from_numpy(shard_y)))
    return loss, convert.flax_from_params(model.state_dict(), model)


def _dryrun_wire(wire):
    """``__graft_entry__._dryrun_wire_compression`` on the port: the MLP
    (12 -> 32, 16, 4) on identical shards, SGD(0.1, momentum 0.9),
    ZeRO-1, 2 microbatches, the overlapped pipeline, WIRE_STEPS steps;
    returns the losses."""
    rng = np.random.default_rng(7)
    shard_x = torch.from_numpy(rng.standard_normal((4, 12)).astype(
        np.float32))
    shard_y = torch.from_numpy(rng.integers(0, 4, size=(4,)))
    model = MLP(12, (32, 16, 4), generator=torch.Generator().manual_seed(11))
    opt = hvd_t.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=convert.flax_named_parameters(model),
        sharded_update=True, compression=wire)
    step = t_training.make_train_step(model, opt, accum_steps=2,
                                      overlap_grads=True)
    return [float(step(shard_x, shard_y)) for _ in range(WIRE_STEPS)]


_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    sys.path.insert(0, {tests!r})
    import horovod_tpu_torch as hvd
    import test_torch_compression as t
    hvd.init(device="cpu")
    data = np.load(sys.argv[1], allow_pickle=True)
    inp = data["bucket"].item()
    x, y, params0 = data["x"], data["y"], data["params0"].item()
    out = dict(bucket=t._port_bucket_ops(inp, hvd.rank()),
               layout=t._port_layout_ops(data["layout"].item(), hvd.rank()))
    bowl = {{}}
    for wire, ef in (("none", True), ("int8", True), ("int8", False)):
        loss, params = t._bowl(wire, ef)
        bowl[f"{{wire}}-{{ef}}"] = dict(loss=loss, params={{
            k: {{n: v.tolist() for n, v in d.items()}}
            for k, d in params.items()}})
    out["bowl"] = bowl
    out["dryrun"] = {{w: t._dryrun_wire(w)
                     for w in ("none", "int8", "fp8_e4m3")}}
    out["bf16"] = {{}}
    for case in t.BF16_CASES:
        losses, params = t._torch_bf16_run(case, params0[t._bf16_id(case)],
                                           x, y)
        out["bf16"][t._bf16_id(case)] = dict(losses=losses, params={{
            k: {{n: v.tolist() for n, v in d.items()}}
            for k, d in params.items()}})
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


def _gap(params, exact):
    return max(float(np.abs(np.asarray(params[k][n]) - np.asarray(v)).max())
               for k, d in exact.items() for n, v in d.items())


def test_two_ranks_match_jax(jax_world, tmp_path):
    """At world 2, on 2 gloo ranks:

    * the compressed reduce-scatter (Average, with a residual, issued
      asynchronously; Sum, stateless) and all-gather (with a residual) of
      a 3-bucket schedule equal ``shard_map``'s bit for bit at every wire,
      new residuals included;
    * so does the int8 reduce-scatter of the LM's and the conv net's
      gradient leaves, packed through their flax layouts;
    * the quadratic bowl: int8 with error feedback lands on the exact
      run's parameters, int8 without it measurably does not;
    * the dryrun's wire contract: int8 and fp8 with error feedback stay
      within WIRE_EPSILON of the exact losses over WIRE_STEPS steps;
    * the bf16 wire's trajectory equals the JAX step's (loss rtol 1e-5,
      params atol 1e-6), replicated and ZeRO-1."""
    inp = _bucket_inputs()
    want = _jax_bucket_ops(inp)
    layout_inp = _layout_inputs()
    want_layout = _jax_layout_ops(layout_inp)
    x, y = _mlp_data()
    mesh = jax_world(2)
    params0, j_runs = {}, {}
    for case in BF16_CASES:
        p0, j_losses, j_params = _jax_bf16_run(mesh, case, x, y)
        params0[_bf16_id(case)] = p0
        j_runs[_bf16_id(case)] = (j_losses, j_params)
    path = tmp_path / "data.npz"
    np.savez(path, bucket=np.array(inp, dtype=object),
             layout=np.array(layout_inp, dtype=object), x=x, y=y,
             params0=np.array(params0, dtype=object))
    ranks = _run_ranks(_WORKER.format(tests=os.path.join(REPO, "tests")),
                       2, [str(path)])

    assert set(ranks[0]["bucket"]) == set(want)
    for key, value in want.items():
        for r, got in enumerate(ranks):
            np.testing.assert_array_equal(
                np.asarray(got["bucket"][key], np.float32),
                value[r].astype(np.float32), err_msg=key)
    assert set(ranks[0]["layout"]) == set(want_layout)
    assert len(want_layout) > 8  # several buckets of each model
    for key, value in want_layout.items():
        for r, got in enumerate(ranks):
            np.testing.assert_array_equal(
                np.asarray(got["layout"][key], np.float32), value[r],
                err_msg=key)

    for got in ranks:
        bowl = got["bowl"]
        exact = bowl["none-True"]
        assert exact["loss"] < 1e-6
        g_ef = _gap(bowl["int8-True"]["params"], exact["params"])
        g_noef = _gap(bowl["int8-False"]["params"], exact["params"])
        assert g_ef < 3e-3, f"error feedback missed the optimum: {g_ef}"
        assert g_noef > 3e-2, f"no error feedback still landed: {g_noef}"
        assert g_noef > 10 * g_ef

        exact = np.asarray(got["dryrun"]["none"])
        assert np.isfinite(exact).all()
        for wire in ("int8", "fp8_e4m3"):
            losses = np.asarray(got["dryrun"][wire])
            assert np.isfinite(losses).all()
            rel = np.max(np.abs(losses - exact)
                         / np.maximum(np.abs(exact), WIRE_EPSILON_FLOOR))
            assert rel <= WIRE_EPSILON, (wire, losses, exact)
            assert not np.array_equal(losses, exact)

        for key, (j_losses, j_params) in j_runs.items():
            run = got["bf16"][key]
            params = {k: {n: np.asarray(v, np.float32) for n, v in d.items()}
                      for k, d in run["params"].items()}
            _assert_bf16_matches(run["losses"], params, j_losses, j_params)
    assert ranks[0]["dryrun"] == ranks[1]["dryrun"]
