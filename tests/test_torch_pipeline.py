"""The port's pipeline parallelism (``horovod_tpu_torch/parallel/pipeline.py``:
``stack_params``, ``split_stages``, GPipe's ``pipelined_forward``, the 1F1B
table and ``pipeline_train_1f1b``; the axes' ``ppermute``;
``convert.stacked_blocks_from_flax`` and ``transformer.stage_block_fn``)
against the JAX package's ``parallel/pipeline.py``.

Inputs are made by numpy from seeds and the weights carried across from
flax; fp32 throughout. The JAX side runs on the conftest's 8 CPU devices,
the port's local form (every stage in this process, ``LocalAxis``) here,
and its group form on 4 gloo processes. Tolerances: outputs 1e-5, losses
rtol 1e-5, gradients rtol 2e-4 with an atol of 1e-6 for GPipe and 1e-5
for 1F1B (the JAX tests' against the sequential oracle) or 1e-6 of the
leaf's largest element, whichever is larger (``OF_MAX``); the
transformer blocks 1e-4 of the largest element, the port's transformer
tolerance; the dryrun's sections with the dryrun's own.
"""

import os
import textwrap

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.models.transformer import Block as JBlock
from horovod_tpu.models.transformer import Transformer as JTransformer
from horovod_tpu.models.transformer import TransformerConfig as JConfig
from horovod_tpu.parallel import pipeline as jpp
from horovod_tpu_torch import convert
from horovod_tpu_torch.models.transformer import (Block, TransformerConfig,
                                                  single_axes, stage_block_fn)
from horovod_tpu_torch.parallel import axis as taxis
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import pipeline as tpp
from test_torch_ring import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = jax.sharding.PartitionSpec


class Layer(nn.Module):
    """The JAX pipeline tests' layer: Dense 2d, gelu, Dense d, residual."""
    d: int

    @nn.compact
    def __call__(self, x):
        h = nn.Dense(2 * self.d, use_bias=False)(x)
        return x + nn.Dense(self.d, use_bias=False)(nn.gelu(h))


class NormLayer(nn.Module):
    """vjp of x/||x|| is NaN at x=0: a schedule that computes on a bubble's
    garbage gives NaN gradients."""

    @nn.compact
    def __call__(self, x):
        y = nn.Dense(x.shape[-1], use_bias=False)(x)
        return y / jnp.linalg.norm(y, axis=-1, keepdims=True)


def layer_fn(ps, xs):
    """``Layer`` in the port: flax's kernels transposed (``[out, in]``)."""
    return [x + F.linear(F.gelu(F.linear(x, p["Dense_0"]),
                                approximate="tanh"), p["Dense_1"])
            for p, x in zip(ps, xs)]


def norm_fn(ps, xs):
    ys = [F.linear(x, p["Dense_0"]) for p, x in zip(ps, xs)]
    return [y / y.norm(dim=-1, keepdim=True) for y in ys]


def tp_fn(model):
    """The JAX tests' Megatron column/row pair over the model axis
    ``model``: ``x + gelu(x w1) w2``, w1's columns and w2's rows cut."""
    def block_fn(ps, xs):
        hs = model.copy_to(xs)
        ys = model.reduce_from([F.gelu(h @ p["w1"], approximate="tanh")
                                @ p["w2"] for p, h in zip(ps, hs)])
        return [x + y for x, y in zip(xs, ys)]
    return block_fn


def _jax_tp_block(p, x):
    xv = jax.lax.pcast(x, "model", to="varying")
    return x + jax.lax.psum(jax.nn.gelu(xv @ p["w1"]) @ p["w2"], "model")


def _mesh(shape, names):
    n = int(np.prod(shape))
    return jax.sharding.Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                             names)


def _flax_layers(module, x, n_layers, key0=0):
    """Stacked flax params of ``n_layers`` inits (keys ``key0 + i``) as
    numpy, and the port's stacked dict (kernels transposed)."""
    trees = [module.init(jax.random.PRNGKey(key0 + i), x)["params"]
             for i in range(n_layers)]
    stacked = jax.tree_util.tree_map(np.asarray, jpp.stack_params(trees))
    port = {k: torch.tensor(v["kernel"]).transpose(1, 2).contiguous()
            for k, v in stacked.items()}
    return stacked, port


def _kernels(grads):
    """Port gradients ``{name: [L, out, in]}`` as flax kernels."""
    return {k: {"kernel": np.asarray(v.detach()).transpose(0, 2, 1)}
            for k, v in grads.items()}


def _tp_weights(seed, d=8, ff=16, n_layers=4, w2_scale=None):
    rng = np.random.default_rng(seed)
    w = {"w1": np.stack([rng.standard_normal((d, ff)) / d ** 0.5
                         for _ in range(n_layers)]).astype(np.float32),
         "w2": np.stack([rng.standard_normal((ff, d)) /
                         (w2_scale or ff ** 0.5)
                         for _ in range(n_layers)]).astype(np.float32)}
    return w


# the share of a gradient leaf's largest element below which the port's
# and JAX's sums (in other orders) may part: fp32 sums of terms up to the
# largest, several ulps (2^-24) each
OF_MAX = 1e-6


def _assert_tree(got, want, rtol, atol, of_max=OF_MAX):
    """Each leaf within ``rtol`` and an atol of ``max(atol, of_max *
    max|leaf|)``: an element that cancels to near zero keeps the rounding
    of the terms that cancel, which the leaf's scale bounds."""
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        key = jax.tree_util.keystr(path)
        g = got
        for k in path:
            g = g[k.key]
        leaf = np.asarray(leaf)
        np.testing.assert_allclose(
            np.asarray(g), leaf, err_msg=key, rtol=rtol,
            atol=max(atol, of_max * float(np.abs(leaf).max())))


# ---- the 1F1B table ---------------------------------------------------------

@pytest.mark.parametrize("n_micro", range(1, 13))
@pytest.mark.parametrize("n_stages", range(1, 7))
def test_schedule_1f1b_matches_jax(n_stages, n_micro):
    """The port's table equals JAX's entry for entry; every stage forwards
    and backwards each micro once, in-flight within ``min(n_micro,
    n_stages - s)``, in ``2 (n_micro + n_stages - 1)`` ticks."""
    fwd, bwd = tpp._schedule_1f1b(n_stages, n_micro)
    jf, jb = jpp._schedule_1f1b(n_stages, n_micro)
    np.testing.assert_array_equal(fwd, jf)
    np.testing.assert_array_equal(bwd, jb)
    assert fwd.shape[0] == 2 * (n_micro + n_stages - 1)
    for s in range(n_stages):
        assert sorted(m for m in fwd[:, s] if m >= 0) == list(range(n_micro))
        assert sorted(m for m in bwd[:, s] if m >= 0) == list(range(n_micro))
        inflight = peak = 0
        for t in range(fwd.shape[0]):
            inflight += int(fwd[t, s] >= 0) - int(bwd[t, s] >= 0)
            peak = max(peak, inflight)
        assert peak <= min(n_micro, n_stages - s), (s, peak)


# ---- stage axes: the JAX tests' grid ---------------------------------------

def _port_gpipe(block_fn, stacked, x, n_stages, n_micro, scale, remat=False):
    """GPipe over ``n_stages`` stages in this process: each stage's output,
    the stacked gradients and h's of ``scale * sum(out^2)``."""
    stacked = {k: v.clone().requires_grad_() for k, v in stacked.items()}
    stage = taxis.LocalAxis(n_stages)
    h = torch.from_numpy(x).requires_grad_()
    outs = tpp.pipelined_forward(block_fn, tpp.split_stages(stacked, stage),
                                 [h] * n_stages, stage=stage,
                                 n_micro=n_micro, remat=remat)
    torch.autograd.backward([scale * (o ** 2).sum() for o in outs])
    return outs, {k: v.grad for k, v in stacked.items()}, h.grad


def _port_1f1b(block_fn, stacked, x, n_stages, n_micro):
    stage = taxis.LocalAxis(n_stages)
    losses, grads, dh = tpp.pipeline_train_1f1b(
        block_fn, tpp.split_stages(stacked, stage),
        [torch.from_numpy(x)] * n_stages,
        lambda ys, m: [(y ** 2).sum() for y in ys], stage=stage,
        n_micro=n_micro, with_input_grad=True)
    whole = {k: torch.cat([g[k] for g in grads]) for k in grads[0]}
    return losses, whole, dh


GRID = [(4, 4, 4), (2, 4, 8), (4, 8, 2), (4, 4, 16)]


@pytest.mark.parametrize("n_stages,n_layers,n_micro", GRID)
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_schedules_match_jax(schedule, n_stages, n_layers, n_micro):
    """On the JAX tests' grid (one layer a stage; two, more micros than
    stages; fewer micros than stages; deep microbatching): GPipe's outputs
    and the gradients of mean(out^2), and 1F1B's loss, gradients and
    input gradient of sum(y^2), against the JAX schedule on the same
    weights, every stage's replica."""
    rng = np.random.default_rng(n_stages * 100 + n_layers * 10 + n_micro)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    layer = Layer(8)
    jstacked, stacked = _flax_layers(layer, x, n_layers)
    blk = lambda p, v: layer.apply({"params": p}, v)  # noqa: E731
    mesh = _mesh((n_stages,), ("stage",))
    if schedule == "gpipe":
        def loss(p):
            out = jpp.pipelined_forward(blk, p, jnp.asarray(x), mesh=mesh,
                                        n_micro=n_micro)
            return jnp.mean(out ** 2), out
        (_, j_out), j_grads = jax.value_and_grad(loss, has_aux=True)(
            jstacked)
        outs, grads, _ = _port_gpipe(layer_fn, stacked, x, n_stages, n_micro,
                                     1.0 / x.size)
        for o in outs:
            np.testing.assert_allclose(o.detach(), np.asarray(j_out),
                                       rtol=1e-5, atol=1e-5)
        _assert_tree(_kernels(grads), j_grads, rtol=2e-4, atol=1e-6)
        return
    j_loss, j_grads, j_dh = jpp.pipeline_train_1f1b(
        blk, jstacked, jnp.asarray(x), lambda y, m: jnp.sum(y ** 2),
        mesh=mesh, n_micro=n_micro, with_input_grad=True)
    losses, grads, dh = _port_1f1b(layer_fn, stacked, x, n_stages, n_micro)
    for loss, d in zip(losses, dh):
        np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
        np.testing.assert_allclose(d, np.asarray(j_dh), rtol=2e-4, atol=1e-5)
    _assert_tree(_kernels(grads), j_grads, rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("n_stages,n_micro", [(4, 4), (2, 8)])
def test_gpipe_remat_is_plain_gpipe(n_stages, n_micro):
    """``remat=True`` recomputes each layer in backward from its input: the
    same operations on the same values, so the same bits."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((16, 8)).astype(np.float32)
    _, stacked = _flax_layers(Layer(8), x, 4)
    plain = _port_gpipe(layer_fn, stacked, x, n_stages, n_micro, 1.0)
    remat = _port_gpipe(layer_fn, stacked, x, n_stages, n_micro, 1.0,
                        remat=True)
    for a, b in zip(plain[0], remat[0]):
        assert torch.equal(a, b)
    for k in stacked:
        assert torch.equal(plain[1][k], remat[1][k]), k
    assert torch.equal(plain[2], remat[2])


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_grads_finite_for_norm_blocks(schedule):
    """A bubble computes nothing, so a block whose backward is NaN at zero
    input (``x / ||x||``) gives finite gradients, those of JAX's GPipe."""
    rng = np.random.default_rng(42)
    x = rng.standard_normal((8, 8)).astype(np.float32)
    layer = NormLayer()
    jstacked, stacked = _flax_layers(layer, x, 4)
    blk = lambda p, v: layer.apply({"params": p}, v)  # noqa: E731
    mesh = _mesh((4,), ("stage",))
    j_grads = jax.grad(lambda p: jnp.sum(jpp.pipelined_forward(
        blk, p, jnp.asarray(x), mesh=mesh) ** 2))(jstacked)
    if schedule == "gpipe":
        _, grads, _ = _port_gpipe(norm_fn, stacked, x, 4, 4, 1.0)
    else:
        _, grads, _ = _port_1f1b(norm_fn, stacked, x, 4, 4)
    for k, g in grads.items():
        assert torch.isfinite(g).all(), k
    _assert_tree(_kernels(grads), j_grads, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("case", ["batch", "layers"])
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_rejections_match_jax(schedule, case):
    """A batch that does not divide by ``n_micro x dp`` and a stack that
    does not divide by the stages raise JAX's ``ValueError``, word for
    word."""
    x = np.ones((8, 8), np.float32)
    layer = Layer(8)
    jstacked, stacked = _flax_layers(layer, x, 4)
    blk = lambda p, v: layer.apply({"params": p}, v)  # noqa: E731
    n_stages, n_micro = (4, 3) if case == "batch" else (3, 4)
    mesh = _mesh((n_stages,), ("stage",))
    stage = taxis.LocalAxis(n_stages)
    if schedule == "gpipe":
        def jax_call():
            jpp.pipelined_forward(blk, jstacked, x, mesh=mesh,
                                  n_micro=n_micro)
    else:
        def jax_call():
            jpp.pipeline_train_1f1b(blk, jstacked, x,
                                    lambda y, m: jnp.sum(y), mesh=mesh,
                                    n_micro=n_micro)
    with pytest.raises(ValueError, match="not divisible") as want:
        jax_call()
    with pytest.raises(ValueError) as got:
        parts = ([{k: v[:1] for k, v in stacked.items()}] * n_stages
                 if case == "batch" else tpp.split_stages(stacked, stage))
        h = [torch.from_numpy(x)] * n_stages
        if schedule == "gpipe":
            tpp.pipelined_forward(layer_fn, parts, h, stage=stage,
                                  n_micro=n_micro)
        else:
            tpp.pipeline_train_1f1b(layer_fn, parts, h,
                                    lambda ys, m: [y.sum() for y in ys],
                                    stage=stage, n_micro=n_micro)
    assert str(got.value) == str(want.value)


# ---- composed with the data and model axes ----------------------------------

def shard_inputs(w, x, shape, names, positions):
    """Each shard's stage block of the weights (its own tensors, cut over
    ``model``'s columns of w1 and rows of w2) and its data slice of x."""
    params, hs = [], []
    for r in positions:
        c = dict(zip(names, np.unravel_index(r, shape)))
        s, S = c.get("stage", 0), shape[names.index("stage")]
        m, R = ((c["model"], shape[names.index("model")])
                if "model" in names else (0, 1))
        d, D = ((c["data"], shape[names.index("data")])
                if "data" in names else (0, 1))
        L, ff = w["w1"].shape[0] // S, w["w1"].shape[2] // R
        params.append({
            "w1": torch.tensor(w["w1"][s * L:(s + 1) * L, :,
                                       m * ff:(m + 1) * ff]),
            "w2": torch.tensor(w["w2"][s * L:(s + 1) * L,
                                       m * ff:(m + 1) * ff])})
        b = x.shape[0] // D
        hs.append(torch.tensor(x[d * b:(d + 1) * b]))
    return params, hs


def _stage_model_axis(shape, names, group):
    """The model axis a block moves one stage's shards over: the mesh's
    without the stage axis (an axis of one rank without a model axis)."""
    if group:
        return taxis.group_axis("model" if "model" in names else None)
    rest = [(n, a) for n, a in zip(shape, names) if a != "stage"]
    if "model" not in names:
        return taxis.single_axis(int(np.prod([n for n, _ in rest])))
    return taxis.local_axes(tuple(n for n, _ in rest),
                            tuple(a for _, a in rest))["model"]


def run_port(schedule, w, x, shape, names, n_micro, scale, group=False,
             positions=None):
    """GPipe (outputs, gradients of ``scale * sum(out^2)``, h's) or 1F1B
    (loss, gradients, dh of ``sum(y^2) * scale``) on the shards at
    ``positions`` of a mesh ``shape`` named ``names``: every shard in this
    process (``local_axes``), or this rank's (``group``, the installed
    mesh's ``GroupAxis``). Returns ``{name: [array a shard]}``."""
    if group:
        positions = [tmesh.get_mesh().rank]
        axes = {a: taxis.GroupAxis(a) for a in names}
    else:
        positions = list(range(int(np.prod(shape))))
        axes = taxis.local_axes(shape, names)
    stage, batch = axes["stage"], axes.get("data")
    block_fn = tp_fn(_stage_model_axis(shape, names, group))
    params, hs = shard_inputs(w, x, shape, names, positions)
    out = {}
    if schedule == "gpipe":
        for p in params:
            for v in p.values():
                v.requires_grad_()
        hs = [h.requires_grad_() for h in hs]
        ys = tpp.pipelined_forward(block_fn, params, hs, stage=stage,
                                   n_micro=n_micro, batch=batch)
        torch.autograd.backward([scale * (y ** 2).sum() for y in ys])
        out["out"] = [y.detach() for y in ys]
        out["dh"] = [torch.zeros_like(h) if h.grad is None else h.grad
                     for h in hs]
        grads = [{k: v.grad for k, v in p.items()} for p in params]
    else:
        losses, grads, dh = tpp.pipeline_train_1f1b(
            block_fn, params, hs,
            lambda ys, m: [scale * (y ** 2).sum() for y in ys],
            stage=stage, n_micro=n_micro, batch=batch, with_input_grad=True)
        out["loss"], out["dh"] = losses, dh
    for k in ("w1", "w2"):
        out[k] = [g[k] for g in grads]
    return {k: [np.asarray(t.detach()) for t in v] for k, v in out.items()}


def _hold_to_global(got, shape, names, w_grads, rtol, atol, of_max=OF_MAX):
    """Each shard's gradients against its block of the global ones, within
    ``rtol`` and ``max(atol, of_max * max|global leaf|)``."""
    tol = {k: dict(rtol=rtol, atol=max(atol, of_max * np.abs(v).max()))
           for k, v in w_grads.items()}
    for r in range(int(np.prod(shape))):
        c = dict(zip(names, np.unravel_index(r, shape)))
        S = shape[names.index("stage")]
        R = shape[names.index("model")] if "model" in names else 1
        m = c.get("model", 0)
        L = w_grads["w1"].shape[0] // S
        layers = slice(c["stage"] * L, (c["stage"] + 1) * L)
        ff = w_grads["w1"].shape[2] // R
        cols = slice(m * ff, (m + 1) * ff)
        np.testing.assert_allclose(got["w1"][r],
                                   w_grads["w1"][layers, :, cols],
                                   **tol["w1"])
        np.testing.assert_allclose(got["w2"][r],
                                   w_grads["w2"][layers, cols], **tol["w2"])


COMPOSED = {"data": ((2, 4), ("data", "stage")),
            "data_model": ((2, 2, 2), ("data", "stage", "model"))}


@pytest.mark.parametrize("layout", sorted(COMPOSED))
@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_composed_with_data_and_model_axes(schedule, layout):
    """PP x DP (data 2 x stage 4) and PP x TP x DP (data 2 x stage 2 x
    model 2) in this process against JAX's schedule on the same 8-device
    mesh (``batch_axis``, ``param_specs``): the loss (or each data slice's
    outputs) and every shard's gradients, each its block of JAX's."""
    shape, names = COMPOSED[layout]
    w = _tp_weights(3)
    x = np.random.default_rng(4).standard_normal((16, 8)).astype(np.float32)
    mesh = _mesh(shape, names)
    specs = ({"w1": P(None, "model"), "w2": P("model", None)}
             if "model" in names else None)
    blk = (_jax_tp_block if "model" in names else
           lambda p, v: v + jax.nn.gelu(v @ p["w1"]) @ p["w2"])
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    n_micro = 2 if schedule == "gpipe" else 4
    if schedule == "gpipe":
        def loss(p):
            out = jpp.pipelined_forward(blk, p, jnp.asarray(x), mesh=mesh,
                                        n_micro=n_micro, batch_axis="data",
                                        param_specs=specs)
            return jnp.mean(out ** 2), out
        (_, j_out), j_grads = jax.value_and_grad(loss, has_aux=True)(jw)
        got = run_port(schedule, w, x, shape, names, n_micro, 1.0 / x.size)
        D = shape[0]
        for r, o in enumerate(got["out"]):
            d = np.unravel_index(r, shape)[0]
            b = x.shape[0] // D
            np.testing.assert_allclose(o, np.asarray(j_out)[d * b:(d + 1) * b],
                                       rtol=1e-5, atol=1e-5)
        tol = dict(rtol=2e-4, atol=1e-6)
    else:
        j_loss, j_grads = jpp.pipeline_train_1f1b(
            blk, jw, jnp.asarray(x), lambda y, m: jnp.sum(y ** 2),
            mesh=mesh, n_micro=n_micro, batch_axis="data",
            param_specs=specs)
        got = run_port(schedule, w, x, shape, names, n_micro, 1.0)
        for loss in got["loss"]:
            np.testing.assert_allclose(loss, float(j_loss), rtol=1e-5)
        tol = dict(rtol=2e-4, atol=1e-5)
    _hold_to_global(got, shape, names,
                    {k: np.asarray(v) for k, v in j_grads.items()}, **tol)


# ---- the dryrun's sections 1e and 1f ----------------------------------------

def test_dryrun_section_1e_gpipe():
    """Section 1e as the dryrun writes it: 8 layers on 8 stages, GPipe,
    the gradients of mean(out^2), against JAX's pipeline and the
    sequential oracle, at the dryrun's tolerance (loss rtol 1e-3, grads
    rtol 1e-3, atol 1e-4)."""
    n = 8
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((2 * n, 8)).astype(np.float32)
    layer = Layer(8)
    jstacked, stacked = _flax_layers(layer, xs, n, key0=10)
    blk = lambda p, v: layer.apply({"params": p}, v)  # noqa: E731
    mesh = _mesh((n,), ("stage",))
    pp_loss, pp_grads = jax.jit(jax.value_and_grad(lambda q: jnp.mean(
        jpp.pipelined_forward(blk, q, jnp.asarray(xs), mesh=mesh) ** 2)))(
            jstacked)

    def oracle(q):
        out = jnp.asarray(xs)
        for i in range(n):
            out = layer.apply(
                {"params": jax.tree_util.tree_map(lambda v: v[i], q)}, out)
        return jnp.mean(out ** 2)

    o_loss, o_grads = jax.value_and_grad(oracle)(jstacked)
    outs, grads, _ = _port_gpipe(layer_fn, stacked, xs, n, n, 1.0 / xs.size)
    loss = float((outs[-1].detach() ** 2).mean())
    for want_loss, want in ((pp_loss, pp_grads), (o_loss, o_grads)):
        np.testing.assert_allclose(loss, float(want_loss), rtol=1e-3)
        _assert_tree(_kernels(grads), want, rtol=1e-3, atol=1e-4, of_max=0)


def test_dryrun_section_1f_1f1b_pp_tp_dp():
    """Section 1f: 1F1B over a (data 2, stage 2, model 2) mesh with the
    Megatron block, 4 micros, the loss and gradients of sum(y^2) on the
    port's ``local_axes`` mesh against JAX's ``pipeline_train_1f1b`` on
    the same 8-device mesh and the dense oracle (loss rtol 1e-3, grads
    rtol 1e-3, atol 1e-4)."""
    shape, names = (2, 2, 2), ("data", "stage", "model")
    rng = np.random.default_rng(1)
    w = _tp_weights(rng.integers(1 << 30), w2_scale=4.0)
    x3 = rng.standard_normal((16, 8)).astype(np.float32)
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    f1_loss, f1_grads = jax.jit(lambda p: jpp.pipeline_train_1f1b(
        _jax_tp_block, p, jnp.asarray(x3), lambda y, m: jnp.sum(y ** 2),
        mesh=_mesh(shape, names), n_micro=4, batch_axis="data",
        param_specs={"w1": P(None, "model"), "w2": P("model", None)}))(jw)

    def oracle(q):
        out = jnp.asarray(x3)
        for i in range(4):
            out = out + jax.nn.gelu(out @ q["w1"][i]) @ q["w2"][i]
        return jnp.sum(out ** 2)

    o_loss, o_grads = jax.value_and_grad(oracle)(jw)
    got = run_port("1f1b", w, x3, shape, names, 4, 1.0)
    for want_loss, want in ((f1_loss, f1_grads), (o_loss, o_grads)):
        for loss in got["loss"]:
            assert np.isfinite(loss)
            np.testing.assert_allclose(loss, float(want_loss), rtol=1e-3)
        _hold_to_global(got, shape, names,
                        {k: np.asarray(v) for k, v in want.items()},
                        rtol=1e-3, atol=1e-4, of_max=0)


# ---- the transformer's blocks -----------------------------------------------

LM = dict(vocab_size=64, num_layers=4, num_heads=4, d_model=64, d_ff=256)
LM_SEQ, LM_BATCH = 32, 8


def _lm_params():
    model = JTransformer(JConfig(**LM, dtype=jnp.float32))
    tokens = jnp.zeros((1, LM_SEQ), jnp.int32)
    return jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), tokens)["params"])


def test_stacked_blocks_from_flax_is_stack_params():
    """``convert.stacked_blocks_from_flax`` equals ``stack_params`` over the
    blocks of ``params_from_flax``, under ``Block``'s parameter names."""
    params = _lm_params()
    cfg = TransformerConfig(**LM, dtype=torch.float32)
    sd = convert.params_from_flax(params, cfg)
    per_layer = [{k[len(f"blocks.{i}."):]: v for k, v in sd.items()
                  if k.startswith(f"blocks.{i}.")}
                 for i in range(cfg.num_layers)]
    want = tpp.stack_params(per_layer)
    got = convert.stacked_blocks_from_flax(params, cfg)
    assert sorted(got) == sorted(want) == sorted(
        k for k, _ in Block(cfg, torch.Generator()).named_parameters())
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("n_stages,n_micro", [(2, 4), (4, 8)])
def test_transformer_blocks_through_both_schedules(n_stages, n_micro):
    """A 4-layer narrow transformer's blocks (d 64, 4 heads, sequence 32,
    fp32; the flax init carried across) through GPipe and 1F1B at S 2
    and 4, against JAX's ``pipelined_forward`` over flax ``Block.apply``:
    outputs, the stacked gradients and the input gradient of sum(y^2),
    within 1e-4 of the largest element. The port's blocks run the flash
    path (its plain versions on the CPU), JAX's dense attention."""
    params = _lm_params()
    jcfg = JConfig(**LM, dtype=jnp.float32, flash_attention=False)
    jstacked = jpp.stack_params([params[f"block_{i}"]
                                 for i in range(LM["num_layers"])])
    rng = np.random.default_rng(n_stages)
    h = (rng.standard_normal((LM_BATCH, LM_SEQ, LM["d_model"])) *
         0.5).astype(np.float32)

    def blk(p, x):
        pos = jnp.broadcast_to(jnp.arange(x.shape[1]), x.shape[:2])
        return JBlock(jcfg).apply({"params": p}, x, pos)

    mesh = _mesh((n_stages,), ("stage",))

    def loss(p, x):
        out = jpp.pipelined_forward(blk, p, x, mesh=mesh, n_micro=n_micro)
        return jnp.sum(out ** 2), out
    (j_loss, j_out), (j_grads, j_dh) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jstacked, jnp.asarray(h))
    cfg = TransformerConfig(**LM, dtype=torch.float32, flash_attention=True)
    stacked = convert.stacked_blocks_from_flax(params, cfg)
    block_fn = stage_block_fn([Block(cfg, torch.Generator())], single_axes())
    want = convert.stacked_blocks_from_flax(
        {f"block_{i}": jax.tree_util.tree_map(
            lambda v, i=i: np.asarray(v)[i], j_grads)
         for i in range(LM["num_layers"])}, cfg)

    def close(got, ref):
        ref = np.asarray(ref)
        np.testing.assert_allclose(np.asarray(got.detach()), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())

    outs, grads, dh = _port_gpipe(block_fn, stacked, h, n_stages, n_micro,
                                  1.0)
    for o in outs:
        close(o, j_out)
    close(dh, j_dh)
    for k in want:
        close(grads[k], want[k])
    losses, grads, dhs = _port_1f1b(block_fn, stacked, h, n_stages, n_micro)
    for loss_, d in zip(losses, dhs):
        np.testing.assert_allclose(loss_.item(), float(j_loss), rtol=1e-5)
        close(d, j_dh)
    for k in want:
        close(grads[k], want[k])


# ---- memory -----------------------------------------------------------------

class _Held:
    """A tensor autograd keeps for backward, counted while it lives."""

    def __init__(self, counter, t):
        self.counter, self.t = counter, t
        self.n = t.numel() * t.element_size()
        counter.live += self.n
        counter.peak = max(counter.peak, counter.live)

    def __del__(self):
        self.counter.live -= self.n


class _SavedBytes:
    def __init__(self):
        self.live = self.peak = 0

    def __enter__(self):
        self.hooks = torch.autograd.graph.saved_tensors_hooks(
            lambda t: _Held(self, t), lambda held: held.t)
        self.hooks.__enter__()
        return self

    def __exit__(self, *exc):
        self.hooks.__exit__(*exc)


def test_1f1b_saves_far_less_than_gpipe():
    """1F1B's point: activation memory O(n_stages), not O(n_micro). At S 4,
    32 micros of Layer(128)'s stack (the JAX test's shapes), the peak of
    the bytes autograd keeps for backward at once, plus 1F1B's three
    rings of S micro activations a stage, is at least 4x below GPipe's
    (whose backward keeps every micro's graph)."""
    d, L, S, M = 128, 4, 4, 32
    x = np.ones((64 * M, d), np.float32)
    _, stacked = _flax_layers(Layer(d), x[:8], L)
    stage = taxis.LocalAxis(S)
    h = [torch.from_numpy(x)] * S
    with _SavedBytes() as gpipe:
        outs = tpp.pipelined_forward(
            layer_fn, tpp.split_stages(
                {k: v.requires_grad_() for k, v in stacked.items()}, stage),
            h, stage=stage, n_micro=M)
        peak_gpipe = gpipe.peak
        torch.autograd.backward([(o ** 2).sum() for o in outs])
    stacked = {k: v.detach() for k, v in stacked.items()}
    with _SavedBytes() as f1:
        tpp.pipeline_train_1f1b(
            layer_fn, tpp.split_stages(stacked, stage), h,
            lambda ys, m: [(y ** 2).sum() for y in ys], stage=stage,
            n_micro=M)
    rings = 3 * S * S * (x.nbytes // M)
    assert (f1.peak + rings) * 4 < peak_gpipe, (f1.peak, rings, peak_gpipe)


# ---- the group forms on 4 gloo ranks ----------------------------------------

SPAWN = {"stage4": ((4,), ("stage",)),
         "data2_stage2": ((2, 2), ("data", "stage")),
         "stage2_model2": ((2, 2), ("stage", "model"))}


def _spawn_inputs():
    w = _tp_weights(11)
    x = np.random.default_rng(12).standard_normal((16, 8)).astype(np.float32)
    return w, x


def rank_pipeline_checks(out_dir):
    """On each of 4 gloo ranks, for each layout of ``SPAWN``: the axes'
    ``ppermute`` and both schedules in the group form (this rank's shard)
    and in the local form (every shard in this process); saves both."""
    import horovod_tpu_torch as hvd
    rank = hvd.rank()
    w, x = _spawn_inputs()
    res = {}
    for name, (shape, names) in sorted(SPAWN.items()):
        tmesh.build_mesh(shape, names)
        stage_n = shape[names.index("stage")]
        perm = [(i, i + 1) for i in range(stage_n - 1)]
        xs = [torch.arange(6.0).reshape(2, 3) + 10 * p
              for p in range(int(np.prod(shape)))]
        res[f"{name}/ppermute/group"] = taxis.GroupAxis("stage").ppermute(
            [xs[rank]], perm)[0].numpy()
        res[f"{name}/ppermute/local"] = taxis.local_axes(
            shape, names)["stage"].ppermute(xs, perm)[rank].numpy()
        for schedule in ("gpipe", "1f1b"):
            for form in ("group", "local"):
                got = run_port(schedule, w, x, shape, names, 4, 1.0,
                               group=form == "group")
                for k, v in got.items():
                    res[f"{name}/{schedule}/{form}/{k}"] = (
                        v[0] if form == "group" else v[rank])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)


_WORKER = textwrap.dedent("""
    import sys
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, {tests!r})
    import horovod_tpu_torch as hvd
    from test_torch_pipeline import rank_pipeline_checks
    hvd.init(device="cpu")
    rank_pipeline_checks({out!r})
    hvd.shutdown()
""")


def test_group_forms_on_four_ranks_are_the_local_forms(tmp_path):
    """On 4 gloo ranks, stage 4, data 2 x stage 2 and stage 2 x model 2:
    ``GroupAxis.ppermute`` (a move that does not wrap, zeros to stage 0)
    and GPipe's and 1F1B's outputs, losses, gradients and input gradients
    in the group form, each rank's bit for bit its shard of the local
    form; the local forms against the sequential oracle."""
    run_ranks(_WORKER.format(tests=os.path.join(REPO, "tests"),
                             out=str(tmp_path)), 4, timeout=300)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    for res in ranks:
        groups = sorted(k for k in res if "/group" in k)
        assert len(groups) == 3 * 9
        for key in groups:
            np.testing.assert_array_equal(
                res[key], res[key.replace("/group", "/local")], err_msg=key)
    w, x = _spawn_inputs()
    wj = {k: jnp.asarray(v) for k, v in w.items()}

    def oracle(q, v):
        for i in range(4):
            v = v + jax.nn.gelu(v @ q["w1"][i]) @ q["w2"][i]
        return jnp.sum(v ** 2)
    o_loss, (o_grads, o_dh) = jax.value_and_grad(oracle, argnums=(0, 1))(
        wj, jnp.asarray(x))
    for name, (shape, names) in SPAWN.items():
        got = {k: [ranks[r][f"{name}/1f1b/local/{k}"] for r in range(4)]
               for k in ("loss", "w1", "w2")}
        for loss in got["loss"]:
            np.testing.assert_allclose(loss, float(o_loss), rtol=1e-5)
        _hold_to_global(got, shape, names,
                        {k: np.asarray(v) for k, v in o_grads.items()},
                        rtol=2e-4, atol=1e-5)
        # a stage that receives nothing gets zeros
        assert not ranks[0][f"{name}/ppermute/group"].any()
