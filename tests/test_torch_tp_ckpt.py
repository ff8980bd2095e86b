"""Checkpoints of the port's tensor- and expert-parallel states and of
``backward_passes_per_step`` against the JAX package's: the sharded
format (``horovod_tpu_torch/ckpt``) and the single file
(``checkpoint.py``), through ``convert.train_state_to_flat`` and
``convert.train_state_trees``.

* A JAX tensor-parallel ``TrainState`` (``parallel/tensor.py``'s
  ``shard_lm_state`` over a (data 2, model 4) CPU mesh, or at MoE widths
  over (data 2, expert 4), ``optax.adamw``) takes one step and is saved
  whole, as the JAX package writes every leaf; the port restores it as
  shards held in one process at (1 x 4), (2 x 2) and world 1, its key
  paths string for string ``jax.tree_util.keystr``'s and every leaf bit
  for bit, and each takes one more step: the loss to rtol 1e-5 and every
  parameter to atol 1e-6 of JAX's next step (the tolerances of
  ``PERF.md``'s port table).
* The other way: the port trains from the flax init and saves; the JAX
  package's ``restore_sharded`` reads it into a ``shard_lm_state``
  target bit for bit, and the next steps agree as above.
* A world-1 port save of a tensor-parallel state writes JAX's shard
  bytes; the single-file checkpoint carries the same state both ways.
* ``DistributedOptimizer(backward_passes_per_step=2)`` is
  ``optax.MultiSteps`` state: saved after mini-step 1 (inside a window)
  and 2 (at its boundary), by either package, it resumes alike in the
  other.
* ``unshard_flax`` puts back a leaf cut over two axes.

fp32 throughout, the JAX side on the conftest's CPU devices.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as hvd_j
import horovod_tpu_torch as hvd_t
from horovod_tpu import checkpoint as jcheckpoint
from horovod_tpu import ckpt as jckpt
from horovod_tpu import training
from horovod_tpu.ckpt import manifest as jmanifest
from horovod_tpu.models.simple import MLP as JMLP
from horovod_tpu.models.transformer import Transformer as JTransformer
from horovod_tpu.models.transformer import TransformerConfig as JConfig
from horovod_tpu.parallel import tensor as jtp
from horovod_tpu_torch import checkpoint, ckpt, convert
from horovod_tpu_torch import training as t_training
from horovod_tpu_torch.ckpt import manifest as tmanifest
from horovod_tpu_torch.models.simple import MLP
from horovod_tpu_torch.models.transformer import Axes, TransformerConfig
from horovod_tpu_torch.parallel import axis as taxis
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import tensor as ttp

WIDTHS = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64)
MOE = dict(WIDTHS, moe_every=2, num_experts=8)
LR, WD = 1e-3, 1e-4
# the JAX state's mesh and the port's layouts, by kind
JAX_NAMES = {"dense": ("data", "model"), "moe": ("data", "expert")}
LAYOUTS = [(1, 4), (2, 2), (1, 1)]


def _ids(layout):
    return f"{layout[0]}x{layout[1]}"


@pytest.fixture()
def worlds():
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    yield
    hvd_t.shutdown()
    hvd_j.shutdown()


def _tokens():
    return np.random.default_rng(0).integers(
        0, WIDTHS["vocab_size"], size=(4, 16)).astype(np.int64)


def _widths(kind):
    return MOE if kind == "moe" else WIDTHS


def _axes_of(kind):
    """``(model_axis, expert_axis)`` of a kind."""
    return ("model", None) if kind == "dense" else (None, "expert")


def _jax_tp(kind):
    """``(state, step, mesh)``: JAX's ``shard_lm_state`` on a 2 x 4 CPU
    mesh with ``optax.adamw`` and its ``make_tp_lm_train_step``."""
    names = JAX_NAMES[kind]
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4),
                             names)
    model_axis, expert_axis = _axes_of(kind)
    model = JTransformer(JConfig(**_widths(kind), dtype=jnp.float32,
                                 expert_mesh=mesh if expert_axis else None))
    tx = optax.adamw(LR, weight_decay=WD)
    state = jtp.shard_lm_state(model, tx, jax.random.PRNGKey(0),
                               jnp.asarray(_tokens()[:1]), mesh,
                               model_axis=model_axis,
                               expert_axis=expert_axis)
    step = jtp.make_tp_lm_train_step(model, tx, mesh, model_axis=model_axis,
                                     expert_axis=expert_axis, donate=False)
    return state, step, mesh


def _jax_step(step, state):
    state, loss = step(state, jnp.asarray(_tokens(), jnp.int32))
    return state, float(loss)


def _jax_flat(state):
    flat, _ = jax.tree_util.tree_flatten_with_path(state)
    return [(jax.tree_util.keystr(p), np.asarray(leaf)) for p, leaf in flat]


def _rank_mesh(shape, names, rank):
    return tmesh.Mesh(group=None, device=torch.device("cpu"),
                      size=int(np.prod(shape)), rank=rank, axis_names=names,
                      shape=shape)


def _port_tp(kind, layout, params=None):
    """The port's shards of a ``layout`` (data, model) or (data, expert)
    mesh held in this process, each with a plain AdamW, and their step
    (``make_tp_lm_train_step_shards``); ``step()`` takes the global batch,
    each shard its data block, and returns the shards' mean loss."""
    names = JAX_NAMES[kind]
    model_axis, expert_axis = _axes_of(kind)
    n = int(np.prod(layout))
    cfg = TransformerConfig(**_widths(kind), dtype=torch.float32)
    models = [ttp.shard_lm_state(cfg, _rank_mesh(layout, names, r),
                                 model_axis=model_axis,
                                 expert_axis=expert_axis, params=params)
              for r in range(n)]
    opts = [torch.optim.AdamW(m.parameters(), lr=LR, betas=(0.9, 0.999),
                              eps=1e-8, weight_decay=WD) for m in models]
    ax = taxis.local_axes(layout, names)
    one = taxis.single_axis(n)
    inner = ttp.make_tp_lm_train_step_shards(
        models, opts, Axes(ax.get("model", one), ax.get("expert", one),
                           ax["data"]))
    blocks = np.split(_tokens(), layout[0])

    def step():
        losses = inner([torch.from_numpy(blocks[r // layout[1]])
                        for r in range(n)])
        return float(losses[0])

    step.state = inner.state
    return models, opts, step


def _whole(flat):
    """A flat state's leaves as numpy, every cut leaf gathered."""
    return [np.asarray(x.gather() if isinstance(x, ckpt.GatheredLeaf)
                       else x) for x in flat]


def _port_flat(models, opts, step):
    return _whole(convert.train_state_to_flat(models, opts, step.state))


def _assert_flat_equal(got, want_pairs):
    assert len(got) == len(want_pairs)
    for g, (key, w) in zip(got, want_pairs):
        np.testing.assert_array_equal(g, w, err_msg=key)
        assert g.dtype == w.dtype, key


def _assert_params_close(models, jparams):
    whole = dict(_flat_tree(convert.unshard_flax(
        [convert.flax_from_params(m.state_dict(), m) for m in models],
        ttp.transformer_param_specs(models[0], models[0].shard.model_axis,
                                    models[0].shard.expert_axis),
        [m.shard.coords() for m in models])))
    for key, want in _flat_tree(jax.tree_util.tree_map(np.asarray,
                                                       jparams)):
        np.testing.assert_allclose(whole[key], want, rtol=0, atol=1e-6,
                                   err_msg=key)


def _flat_tree(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat_tree(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(tree[k])


@pytest.mark.parametrize("layout", LAYOUTS, ids=_ids)
@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_jax_tp_state_restores_in_the_port_and_steps_alike(
        worlds, tmp_path, kind, layout):
    """JAX's (data 2 x model 4) or (data 2 x expert 4) state after one
    step, saved whole, restores in the port's shards at ``layout``: key
    paths and every leaf (gathered again) bit for bit; the next step's
    loss and parameters within loss rtol 1e-5 and atol 1e-6 of JAX's."""
    jstate, jstep, _ = _jax_tp(kind)
    jstate, _ = _jax_step(jstep, jstate)
    root = str(tmp_path)
    jckpt.save_sharded(root, 1, jstate)

    models, opts, step = _port_tp(kind, layout)
    want = _jax_flat(jstate)
    assert convert.train_state_paths(models, opts) == [k for k, _ in want]
    target = convert.train_state_to_flat(models, opts, step.state)
    got_step, restored, _ = ckpt.restore_sharded(root, target)
    assert got_step == 1
    convert.train_state_from_flat(models, opts, step.state, restored)
    assert step.state.step == 1
    _assert_flat_equal(_port_flat(models, opts, step), want)

    jstate, j_loss = _jax_step(jstep, jstate)
    loss = step()
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    _assert_params_close(models, jstate.params)


@pytest.mark.parametrize("layout", LAYOUTS[:2], ids=_ids)
@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_port_tp_state_restores_in_jax(worlds, tmp_path, kind, layout):
    """The port's shards at ``layout`` train one step from the flax init
    and save; the JAX package's ``restore_sharded`` reads it into a
    ``shard_lm_state`` target bit for bit, and the next steps agree."""
    jstate0, jstep, _ = _jax_tp(kind)
    params0 = jax.tree_util.tree_map(np.asarray, jstate0.params)
    models, opts, step = _port_tp(kind, layout, params=params0)
    step()
    root = str(tmp_path)
    man = ckpt.save_sharded(root, 1, convert.train_state_to_flat(
        models, opts, step.state))
    assert man["world"] == 1 and not man["zero"]
    _, restored, _ = jckpt.restore_sharded(root, jstate0)
    # each leaf placed as the target's (its scalars uncommitted)
    jstate = jax.tree_util.tree_map(
        lambda r, t: jax.device_put(r, t.sharding) if isinstance(
            t.sharding, jax.sharding.NamedSharding) else jnp.asarray(r),
        restored, jstate0)
    _assert_flat_equal(_port_flat(models, opts, step), _jax_flat(jstate))
    assert int(jstate.step) == 1

    jstate, j_loss = _jax_step(jstep, jstate)
    np.testing.assert_allclose(step(), j_loss, rtol=1e-5)
    _assert_params_close(models, jstate.params)


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_tp_shard_bytes_equal_jax(worlds, tmp_path, kind):
    """A JAX state restored in the port's (1 x 4) shards and saved again
    at world 1 gives JAX's shard file and ``.ok`` marker byte for byte:
    every leaf gathered whole, in the JAX package's leaf order and
    dtypes."""
    jstate, jstep, _ = _jax_tp(kind)
    jstate, _ = _jax_step(jstep, jstate)
    root, again = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save_sharded(root, 1, jstate)
    models, opts, step = _port_tp(kind, (1, 4))
    _, restored, _ = ckpt.restore_sharded(
        root, convert.train_state_to_flat(models, opts, step.state))
    convert.train_state_from_flat(models, opts, step.state, restored)
    saver = ckpt.AsyncCheckpointer(again)
    saver.save(1, convert.train_state_to_flat(models, opts, step.state))
    saver.close()
    assert saver.last_gather_s > 0
    for name in (tmanifest.shard_name(0, 1), tmanifest.ok_name(0, 1)):
        with open(os.path.join(jmanifest.step_dir(root, 1), name),
                  "rb") as a, open(os.path.join(
                      tmanifest.step_dir(again, 1), name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_tp_single_file_both_ways(worlds, tmp_path, kind):
    """``checkpoint.py``: JAX's file of a tensor-parallel state restores in
    the port's (2 x 2) shards bit for bit; the port's file of them
    restores in JAX bit for bit, with the same bytes."""
    jstate, jstep, _ = _jax_tp(kind)
    jstate, _ = _jax_step(jstep, jstate)
    hvd_j.shutdown()
    hvd_j.init(devices=jax.devices()[:1])
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jcheckpoint.save_checkpoint(jdir, 1, jstate.params, jstate.opt_state)
    models, opts, step = _port_tp(kind, (2, 2))
    checkpoint.restore_checkpoint(jdir, 1, models, opts)
    want = [(k, w) for k, w in _jax_flat(jstate) if "flat index 3" not in k]
    _assert_flat_equal(_port_flat(models, opts, step)[:-1], want)
    path = checkpoint.save_checkpoint(tdir, 1, models, opts)
    params, opt_state, _ = jcheckpoint.restore_checkpoint(
        tdir, 1, jstate.params, jstate.opt_state)
    _assert_flat_equal(
        [np.asarray(x) for x in jax.tree_util.tree_leaves(
            (params, opt_state))],
        [(k, w) for k, w in want])
    with open(path, "rb") as a, open(os.path.join(
            jdir, "ckpt-1.msgpack"), "rb") as b:
        assert a.read() == b.read()


# -- backward_passes_per_step as optax.MultiSteps ----------------------------

IN, FEATURES = 6, (10, 7, 3)


def _mlp_data(i):
    rng = np.random.default_rng(10 + i)
    return (rng.standard_normal((8, IN)).astype(np.float32),
            rng.integers(0, FEATURES[-1], size=(8,)).astype(np.int32))


def _jax_multi():
    """``(state, step)``: the JAX MLP through
    ``DistributedOptimizer(optax.adamw, backward_passes_per_step=2)`` at
    world 1."""
    hvd_j.shutdown()
    hvd_j.init(devices=jax.devices()[:1])
    tx = hvd_j.DistributedOptimizer(optax.adamw(LR, weight_decay=WD),
                                    backward_passes_per_step=2)
    model = JMLP(features=FEATURES)
    x, _ = _mlp_data(0)
    state = training.create_train_state(model, tx, jax.random.PRNGKey(0),
                                        jnp.asarray(x[:1]))
    step = training.make_train_step(model, tx, mesh=hvd_j.mesh(),
                                    donate=False)

    def one(state, i):
        x, y = _mlp_data(i)
        return step(state, jnp.asarray(x), jnp.asarray(y))

    return state, one


def _port_multi(params0=None):
    model = MLP(IN, FEATURES)
    if params0 is not None:
        model.load_state_dict(convert.params_from_flax(params0, model))
    opt = hvd_t.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=WD),
        named_parameters=convert.flax_named_parameters(model),
        backward_passes_per_step=2)
    inner = t_training.make_train_step(model, opt)

    def step(i):
        x, y = _mlp_data(i)
        return float(inner(torch.from_numpy(x), torch.from_numpy(y)))

    step.state = inner.state
    return model, opt, step


def _port_mlp_flat(model, opt, step):
    return [np.array(x.detach().numpy()) if torch.is_tensor(x)
            else np.array(x)
            for x in convert.train_state_to_flat(model, opt, step.state)]


@pytest.mark.parametrize("mini", [1, 2], ids=["mid-window", "boundary"])
def test_multi_steps_state_both_ways(worlds, tmp_path, mini):
    """JAX's ``MultiStepsState`` after ``mini`` mini-steps restores in the
    port, key paths string for string and every leaf bit for bit (the
    accumulator's zeros after a window's update compare equal to optax's
    signed ones), and the port's after the same mini-steps restores in
    JAX bit for bit; then both continue 3 mini-steps from each restore,
    losses rtol 1e-5 and parameters atol 1e-6."""
    jstate, jstep = _jax_multi()
    params0 = jax.tree_util.tree_map(np.asarray, jstate.params)
    for i in range(mini):
        jstate, _ = jstep(jstate, i)
    root = str(tmp_path / "jax")
    jckpt.save_sharded(root, mini, jstate)
    want = _jax_flat(jstate)

    model, opt, step = _port_multi()
    assert convert.train_state_paths(model, opt) == [k for k, _ in want]
    _, restored, _ = ckpt.restore_sharded(
        root, convert.train_state_to_flat(model, opt, step.state))
    convert.train_state_from_flat(model, opt, step.state, restored)
    assert (opt._mini_step, opt._gradient_step) == (mini % 2, mini // 2)
    _assert_flat_equal(_port_mlp_flat(model, opt, step), want)

    # the port from the same start, saved after the same mini-steps
    model2, opt2, step2 = _port_multi(params0)
    for i in range(mini):
        step2(i)
    again = str(tmp_path / "port")
    ckpt.save_sharded(again, mini, convert.train_state_to_flat(
        model2, opt2, step2.state))
    jtarget, _ = _jax_multi()
    _, jrestored, _ = jckpt.restore_sharded(again, jtarget)
    for (key, got), (_, w) in zip(_jax_flat(jrestored), want):
        np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-6,
                                   err_msg=key)
    _assert_flat_equal(_port_mlp_flat(model2, opt2, step2),
                       _jax_flat(jrestored))

    for i in range(mini, mini + 3):
        jstate, j_loss = jstep(jstate, i)
        jrestored, jr_loss = jstep(jrestored, i)
        np.testing.assert_allclose(step(i), float(j_loss), rtol=1e-5)
        np.testing.assert_allclose(step2(i), float(jr_loss), rtol=1e-5)
    for m, js in ((model, jstate), (model2, jrestored)):
        got = convert.flax_from_params(m.state_dict(), m)
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(b, np.asarray(a),
                                                    atol=1e-6),
            js.params, got)


def test_multi_steps_resume_repeats_the_unbroken_run(worlds, tmp_path):
    """The port alone: 4 mini-steps unbroken against a save after each of
    the first 3 and a fresh model and optimizer restored from it; every
    resumed run's losses and final parameters bit for bit the unbroken
    run's (world 1: the accumulator is the whole state)."""
    model, opt, step = _port_multi()
    unbroken = [step(i) for i in range(4)]
    final = [p.detach().clone() for p in model.parameters()]
    for k in (1, 2, 3):
        model, opt, step = _port_multi()
        for i in range(k):
            step(i)
        root = str(tmp_path / str(k))
        ckpt.save_sharded(root, k, convert.train_state_to_flat(
            model, opt, step.state))
        model, opt, step = _port_multi(
            jax.tree_util.tree_map(np.asarray, _jax_multi()[0].params))
        _, restored, _ = ckpt.restore_sharded(
            root, convert.train_state_to_flat(model, opt, step.state))
        convert.train_state_from_flat(model, opt, step.state, restored)
        assert [step(i) for i in range(k, 4)] == unbroken[k:]
        assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                     final))


# -- unshard_flax over two axes ------------------------------------------

@pytest.mark.parametrize("order", ["model-first", "expert-first"])
def test_unshard_flax_puts_back_a_leaf_cut_over_two_axes(order):
    """A hand-made spec that cuts one leaf over two axes (the rules give
    none: expert weights take the expert axis alone) and one over each:
    ``shard_flax`` at every coordinate of a (data 2, model 2, expert 3)
    mesh, then ``unshard_flax``, gives the tree back bit for bit, numpy
    or torch."""
    rng = np.random.default_rng(4)
    tree = {"a": {"w": rng.standard_normal((6, 4, 5)).astype(np.float32)},
            "b": rng.standard_normal((4, 3)).astype(np.float32),
            "c": rng.standard_normal((7,)).astype(np.float32)}
    two = ("expert", "model", None) if order == "model-first" \
        else ("model", None, "expert")
    if order == "expert-first":
        tree["a"]["w"] = rng.standard_normal((4, 5, 6)).astype(np.float32)
    specs = {"a": {"w": two}, "b": ("model", None), "c": ()}
    coords = [{"data": (d, 2), "model": (m, 2), "expert": (e, 3)}
              for d in range(2) for m in range(2) for e in range(3)]
    shards = [convert.shard_flax(tree, specs, c) for c in coords]
    got = convert.unshard_flax(shards, specs, coords)
    for key, want in _flat_tree(tree):
        np.testing.assert_array_equal(dict(_flat_tree(got))[key], want)
    torch_shards = [jax.tree_util.tree_map(torch.from_numpy, s)
                    for s in shards]
    got = convert.unshard_flax(torch_shards, specs, coords)
    np.testing.assert_array_equal(got["a"]["w"].numpy(), tree["a"]["w"])
