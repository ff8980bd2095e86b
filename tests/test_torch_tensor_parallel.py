"""The port's tensor parallelism (``horovod_tpu_torch/parallel/tensor.py``:
``transformer_param_specs``, ``shard_lm_state``, ``make_tp_lm_train_step``,
the vocab-sharded loss; the sharded transformer of
``models/transformer.py``; ``convert.shard_flax`` and ``unshard_flax``)
against the JAX package's ``parallel/tensor.py``, and the LM example
under hvdrun at ``--model 2``.

Inputs are made by numpy from seeds and the weights carried across from
flax by ``convert``; fp32 throughout. Multi-rank runs are 4 gloo
processes on the CPU; the JAX side runs on the conftest's CPU devices.
The 4-rank step trains at AdamW's rate 1e-3: its first steps move a
weight by about ``lr * g / (|g| + eps)`` whatever its gradient's size,
so the fp32 rounding of the smallest gradients shows at about 1e-4 of
``lr`` (measured in PERF.md).
"""

import json
import os
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
from horovod_tpu.models.transformer import Transformer as JTransformer
from horovod_tpu.models.transformer import TransformerConfig as JConfig
from horovod_tpu.parallel import tensor as jtp
from horovod_tpu_torch import convert
from horovod_tpu_torch import training as t_training
from horovod_tpu_torch.models.transformer import (Axes, Transformer,
                                                  TransformerConfig,
                                                  forward_shards)
from horovod_tpu_torch.parallel import axis as taxis
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import tensor as ttp
from test_torch_ring import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX tensor-parallel test's model
WIDTHS = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64)
MOE = dict(WIDTHS, moe_every=2, num_experts=8)
LR = 1e-3
STEPS = 3


@pytest.fixture()
def cpu_world():
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    yield hvd_t
    hvd_t.shutdown()


def _tokens(batch=4, seq=16, seed=0):
    return np.random.default_rng(seed).integers(
        0, WIDTHS["vocab_size"], size=(batch, seq)).astype(np.int64)


def _flax_params(widths, seed=0):
    model = JTransformer(JConfig(**widths, dtype=jnp.float32))
    return jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(seed), jnp.asarray(_tokens()[:1]))["params"])


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _nested(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _rank_mesh(shape, names, rank):
    """A mesh of ``shape`` seen from ``rank``: coordinates, no groups."""
    return tmesh.Mesh(group=None, device=torch.device("cpu"),
                      size=int(np.prod(shape)), rank=rank, axis_names=names,
                      shape=shape)


def _shard_tree(model):
    return convert.flax_from_params(
        {n: p.detach() for n, p in model.state_dict().items()}, model)


AXES = [("model", None), (None, "expert"), ("model", "expert"), (None, None)]


@pytest.mark.parametrize("axes", AXES, ids=lambda a: f"{a[0]}-{a[1]}")
@pytest.mark.parametrize("widths", [WIDTHS, MOE], ids=["dense", "moe"])
def test_param_specs_match_jax(widths, axes):
    """``transformer_param_specs`` gives JAX's spec leaf for leaf on the
    same flax tree, and the same tree read off the port's module."""
    params = _flax_params(widths)
    want = jax.tree_util.tree_map(tuple, jtp.transformer_param_specs(
        params, *axes), is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
    assert ttp.transformer_param_specs(params, *axes) == want
    module = Transformer(TransformerConfig(**widths))
    assert ttp.transformer_param_specs(module, *axes) == want


@pytest.mark.parametrize("widths,names", [
    (WIDTHS, ("data", "model")), (MOE, ("data", "expert"))],
    ids=["model", "expert"])
def test_shards_match_jax_addressable_shards(widths, names):
    """On a 2 x 4 CPU mesh: each rank's shard from ``shard_lm_state``
    (the JAX init carried across) element for element the shard JAX's
    ``shard_lm_state`` puts on that rank's device, every leaf; and
    ``unshard_flax`` of the eight shards is the whole tree."""
    shape = (2, 4)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]).reshape(shape),
                             names)
    model_axis = "model" if "model" in names else None
    expert_axis = "expert" if "expert" in names else None
    jcfg = JConfig(**widths, dtype=jnp.float32,
                   expert_mesh=mesh if expert_axis else None)
    state = jtp.shard_lm_state(JTransformer(jcfg), optax.sgd(0.1),
                               jax.random.PRNGKey(0),
                               jnp.asarray(_tokens()[:1]), mesh,
                               model_axis=model_axis,
                               expert_axis=expert_axis)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    cfg = TransformerConfig(**widths, dtype=torch.float32)
    shards, coords = [], []
    for rank, dev in enumerate(mesh.devices.reshape(-1)):
        model = ttp.shard_lm_state(cfg, _rank_mesh(shape, names, rank),
                                   model_axis=model_axis,
                                   expert_axis=expert_axis, params=params)
        mine = _flat(_shard_tree(model))
        for path, leaf in jax.tree_util.tree_leaves_with_path(state.params):
            key = "/".join(k.key for k in path)
            shard = next(s for s in leaf.addressable_shards
                         if s.device == dev)
            np.testing.assert_array_equal(mine[key],
                                          np.asarray(shard.data),
                                          err_msg=f"rank {rank} {key}")
        shards.append(_shard_tree(model))
        coords.append(model.shard.coords())
    specs = ttp.transformer_param_specs(params, model_axis, expert_axis)
    whole = _flat(convert.unshard_flax(shards, specs, coords))
    for key, want in _flat(params).items():
        np.testing.assert_array_equal(np.asarray(whole[key]), want)


@pytest.mark.parametrize("what,widths,size", [
    ("heads", dict(WIDTHS, num_heads=6, d_model=24), 4),
    ("d_ff", dict(WIDTHS, d_ff=66), 4),
    ("vocab", dict(WIDTHS, vocab_size=66), 4),
    ("experts", dict(MOE, num_experts=6), 4)])
def test_sizes_the_axis_does_not_divide_raise(what, widths, size):
    """A size the axis does not divide (heads, d_ff, the vocabulary, the
    experts) raises ``ValueError`` naming it, as JAX's placement of the
    same tree raises."""
    axis = "expert" if what == "experts" else "model"
    names = ("data", axis)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]).reshape(2, size),
                             names)
    jcfg = JConfig(**widths, dtype=jnp.float32,
                   expert_mesh=mesh if what == "experts" else None)
    with pytest.raises(ValueError):
        jtp.shard_lm_state(JTransformer(jcfg), optax.sgd(0.1),
                           jax.random.PRNGKey(0),
                           jnp.asarray(_tokens()[:1]), mesh,
                           model_axis=None if what == "experts" else "model",
                           expert_axis="expert" if what == "experts"
                           else None)
    cfg = TransformerConfig(**widths)
    shard = ttp.Shard(**({"expert_axis": "expert", "expert_size": size}
                         if what == "experts" else
                         {"model_axis": "model", "model_size": size}))
    bad = {"heads": 6, "d_ff": 66, "vocab": 66, "experts": 6}[what]
    with pytest.raises(ValueError, match=rf"\({bad}\) does not divide over "
                                         rf"the '{axis}' axis of {size}"):
        Transformer(cfg, shard=shard)


@pytest.mark.parametrize("r", [1, 2, 4])
def test_vocab_parallel_loss_matches_log_softmax(r):
    """The loss of vocab-sharded logits over R shards in one process
    against ``log_softmax`` over the full logits, with its gradient in
    each shard's block of the vocabulary."""
    rng = np.random.default_rng(r)
    logits = rng.standard_normal((3, 7, 64)).astype(np.float32) * 4
    targets = torch.from_numpy(rng.integers(0, 64, size=(3, 7)))
    full = torch.from_numpy(logits).requires_grad_()
    want = -torch.log_softmax(full, -1).gather(
        -1, targets[..., None])[..., 0].mean()
    want.backward()
    parts = [torch.from_numpy(c.copy()).requires_grad_()
             for c in np.split(logits, r, axis=-1)]
    got = ttp.vocab_parallel_cross_entropy(taxis.LocalAxis(r), parts,
                                           [targets] * r)
    torch.autograd.backward(got)
    for loss in got:
        np.testing.assert_allclose(loss.item(), want.item(), rtol=1e-6)
    np.testing.assert_allclose(torch.cat([p.grad for p in parts], -1),
                               full.grad, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("r", [2, 4])
def test_model_shards_match_unsharded_and_flax(r):
    """R model shards in one process (``forward_shards`` over a
    ``LocalAxis``): the vocab blocks of their logits against the
    unsharded port model and flax's (1e-4 on logits of order 1), and
    each shard's gradients against the matching block of the unsharded
    model's (1e-5 of the largest)."""
    params = _flax_params(WIDTHS)
    tokens = torch.from_numpy(_tokens())
    cfg = TransformerConfig(**WIDTHS, dtype=torch.float32)
    whole = Transformer(cfg)
    whole.load_state_dict(convert.params_from_flax(params, cfg))
    want = whole(tokens)
    (want * torch.linspace(-1, 1, want.numel()).reshape(want.shape)).sum() \
        .backward()
    j_logits = JTransformer(JConfig(**WIDTHS, dtype=jnp.float32)).apply(
        {"params": params}, jnp.asarray(tokens.numpy()))
    names = ("model",)
    models = [ttp.shard_lm_state(cfg, _rank_mesh((r,), names, i),
                                 model_axis="model", batch_axis=None,
                                 params=params) for i in range(r)]
    one = taxis.single_axis(r)
    outs = forward_shards(models, [tokens] * r,
                          Axes(taxis.LocalAxis(r), one, one))
    got = torch.cat(outs, dim=-1)
    weight = torch.linspace(-1, 1, got.numel()).reshape(got.shape)
    torch.autograd.backward([(o * w).sum() for o, w in zip(
        outs, weight.chunk(r, dim=-1))])
    np.testing.assert_allclose(got.detach(), want.detach(), atol=1e-5)
    np.testing.assert_allclose(got.detach(), np.asarray(j_logits), atol=1e-4)
    specs = ttp.transformer_param_specs(params, "model")
    full_grads = convert.flax_from_params(
        {n: p.grad for n, p in whole.named_parameters()}, cfg)
    for i, m in enumerate(models):
        mine = _flat(convert.flax_from_params(
            {n: p.grad for n, p in m.named_parameters()}, m))
        block = _flat(convert.shard_flax(full_grads, specs,
                                         {"model": (i, r)}))
        for key, g in block.items():
            np.testing.assert_allclose(
                mine[key], g, rtol=0, atol=1e-5 * np.abs(g).max() + 1e-9,
                err_msg=f"shard {i} {key}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_world_one_tp_step_is_the_plain_step(cpu_world, dtype):
    """At world 1 on a (1, 1) (data, model) mesh the tensor-parallel step
    is the plain LM step op for op (every axis of one rank: the operators
    are identities and the loss is ``softmax_cross_entropy``; the plain
    optimizer is the ``DistributedOptimizer``'s inner one), so 3 steps
    equal ``make_lm_train_step``'s bit for bit (the CPU counterpart of
    chip_smoke's 12b)."""
    tokens = torch.from_numpy(_tokens())
    cfg = TransformerConfig(**WIDTHS, dtype=dtype, flash_attention=True)
    runs = []
    for tp in (False, True):
        hvd_t.shutdown()
        hvd_t.init(device="cpu")
        gen = torch.Generator().manual_seed(2)
        if tp:
            mesh = tmesh.build_mesh((1, 1), ("data", "model"))
            model = ttp.shard_lm_state(cfg, mesh, generator=gen)
            opt = torch.optim.AdamW(model.parameters(), lr=1e-2,
                                    weight_decay=1e-4)
            step = ttp.make_tp_lm_train_step(model, opt, mesh)
        else:
            model = Transformer(cfg, generator=gen)
            opt = hvd_t.DistributedOptimizer(torch.optim.AdamW(
                model.parameters(), lr=1e-2, weight_decay=1e-4))
            step = t_training.make_lm_train_step(model, opt)
        losses = [step(tokens).item() for _ in range(STEPS)]
        assert step.state.step == STEPS
        runs.append((losses, [p.detach().clone()
                              for p in model.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_tp_step_refuses_mismatches(cpu_world):
    """A ``DistributedOptimizer``, a model cut over other axes, and a
    mesh that is not the installed one are refused."""
    mesh = tmesh.build_mesh((1, 1), ("data", "model"))
    cfg = TransformerConfig(**WIDTHS, dtype=torch.float32)
    model = ttp.shard_lm_state(cfg, mesh)
    plain = torch.optim.SGD(model.parameters(), lr=0.1)
    with pytest.raises(TypeError, match="plain torch optimizer"):
        ttp.make_tp_lm_train_step(model, hvd_t.DistributedOptimizer(plain),
                                  mesh)
    with pytest.raises(ValueError, match="shard_lm_state"):
        ttp.make_tp_lm_train_step(model, plain, mesh, model_axis=None)
    stray = _rank_mesh((1, 1), ("data", "model"), 0)
    with pytest.raises(ValueError, match="installed"):
        ttp.make_tp_lm_train_step(model, plain, stray)


def _adamw(model):
    return torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


def _rank_tokens(r):
    d = r // 2  # (data, model) row-major: rank r at data r // 2
    return torch.from_numpy(_tokens()[2 * d:2 * d + 2])


def rank_tp_checks(out_dir):
    """On each of 4 gloo ranks of a (data 2 x model 2) mesh: 3 AdamW steps
    of ``make_tp_lm_train_step`` from ``params0.npz``; the state saved
    (``ckpt.save_sharded`` at world 4 and ``checkpoint.save_checkpoint``,
    every cut leaf gathered over the model axis), restored on a (data 1
    x model 4) mesh (the file through ``restore_or_init`` too) and one
    more step on the whole batch."""
    from horovod_tpu_torch import checkpoint, ckpt
    mesh = tmesh.build_mesh((2, 2), ("data", "model"))
    params0 = _nested(dict(np.load(os.path.join(out_dir, "params0.npz"))))
    cfg = TransformerConfig(**WIDTHS, dtype=torch.float32)
    model = ttp.shard_lm_state(cfg, mesh, params=params0)
    opt = _adamw(model)
    step = ttp.make_tp_lm_train_step(model, opt, mesh)
    res = {"losses": np.asarray([step(_rank_tokens(hvd_t.rank())).item()
                                 for _ in range(STEPS)])}
    for k, v in _flat(_shard_tree(model)).items():
        res[f"params/{k}"] = v
    root = os.path.join(out_dir, "ckpt")
    ckpt.save_sharded(root, STEPS, convert.train_state_to_flat(
        model, opt, step.state), rank=hvd_t.rank(), world=4)
    # the single file: every rank gathers, rank 0 writes
    checkpoint.save_checkpoint(os.path.join(out_dir, "file"), STEPS, model,
                               opt)
    mesh = tmesh.build_mesh((1, 4), ("data", "model"))
    model = ttp.shard_lm_state(cfg, mesh)
    opt = _adamw(model)
    step = ttp.make_tp_lm_train_step(model, opt, mesh)
    _, restored, _ = ckpt.restore_sharded(
        root, convert.train_state_to_flat(model, opt, step.state))
    convert.train_state_from_flat(model, opt, step.state, restored)
    # the single file through restore_or_init (rank 0 reads, every leaf
    # broadcast whole, each rank cuts its shard): the same state
    other = ttp.shard_lm_state(cfg, mesh)
    other_opt = _adamw(other)
    found, _ = checkpoint.restore_or_init(os.path.join(out_dir, "file"),
                                          other, other_opt)
    mine = _whole(convert.train_state_to_flat(model, opt, None))
    theirs = _whole(convert.train_state_to_flat(other, other_opt, None))
    res["file/same"] = np.asarray(found == STEPS and all(
        np.array_equal(a, b) for a, b in zip(mine, theirs)))
    res["resumed/loss"] = np.asarray(step(torch.from_numpy(_tokens()))
                                     .item())
    for k, v in _flat(_shard_tree(model)).items():
        res[f"resumed/{k}"] = v
    np.savez(os.path.join(out_dir, f"rank{hvd_t.rank()}.npz"), **res)


_WORKER = textwrap.dedent("""
    import sys
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, {tests!r})
    import horovod_tpu_torch as hvd
    from test_torch_tensor_parallel import rank_tp_checks
    hvd.init(device="cpu")
    rank_tp_checks({out!r})
    hvd.shutdown()
""")


def _jax_tp(params0, steps=STEPS):
    """JAX's tensor-parallel step on a 2 x 2 (data, model) mesh from
    ``params0``, ``steps`` steps: ``(losses, params after each step)``."""
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                             ("data", "model"))
    model = JTransformer(JConfig(**WIDTHS, dtype=jnp.float32))
    tx = optax.adamw(LR, weight_decay=1e-4)
    state = jtp.shard_lm_state(model, tx, jax.random.PRNGKey(0),
                               jnp.asarray(_tokens()[:1]), mesh)
    for a, b in zip(jax.tree_util.tree_leaves(state.params),
                    jax.tree_util.tree_leaves(params0)):
        np.testing.assert_array_equal(np.asarray(a), b)
    step = jtp.make_tp_lm_train_step(model, tx, mesh, donate=False)
    losses, params = [], []
    for _ in range(steps):
        state, loss = step(state, jnp.asarray(_tokens(), jnp.int32))
        losses.append(float(loss))
        params.append(jax.tree_util.tree_map(np.asarray, state.params))
    return losses, params


def _local_tp(params0):
    """The same step over 4 ``LocalAxis`` shards in this process:
    ``(models, each step's losses, the whole state)``, the state
    gathered by ``convert.train_state_to_flat`` over the shards."""
    shape, names = (2, 2), ("data", "model")
    cfg = TransformerConfig(**WIDTHS, dtype=torch.float32)
    models = [ttp.shard_lm_state(cfg, _rank_mesh(shape, names, r),
                                 params=params0) for r in range(4)]
    opts = [_adamw(m) for m in models]
    ax = taxis.local_axes(shape, names)
    step = ttp.make_tp_lm_train_step_shards(
        models, opts, Axes(ax["model"], taxis.single_axis(4), ax["data"]))
    losses = [step([_rank_tokens(r) for r in range(4)])
              for _ in range(STEPS)]
    whole = _whole(convert.train_state_to_flat(models, opts, step.state))
    return models, [[x.item() for x in row] for row in losses], whole


def _whole(flat):
    """A flat train state's leaves as numpy, every cut leaf gathered."""
    from horovod_tpu_torch import ckpt
    return [np.asarray(x.gather() if isinstance(x, ckpt.GatheredLeaf)
                       else x) for x in flat]


def test_tensor_parallel_step_on_four_ranks(tmp_path):
    """On 2 x 2 gloo ranks (data, model), 3 AdamW steps of
    ``make_tp_lm_train_step`` from JAX's init (the JAX test's model):
    losses rtol 1e-5 and every parameter atol 1e-6 against JAX's step on
    a 2 x 2 CPU mesh, and bit for bit the same step over ``LocalAxis``
    shards in one process. The state the four ranks save (its cut leaves
    gathered over the model axis's groups) is bit for bit the state the
    local shards gather, and restored on a 1 x 4 mesh its next step is
    JAX's fourth (the same tolerances). The single file that rank 0
    writes of it reads back into 4 local shards bit for bit, and through
    ``restore_or_init`` on the 1 x 4 mesh as the sharded restore does."""
    from horovod_tpu_torch import checkpoint, ckpt
    params0 = _flax_params(WIDTHS)
    np.savez(tmp_path / "params0.npz", **_flat(params0))
    run_ranks(_WORKER.format(tests=os.path.join(REPO, "tests"),
                             out=str(tmp_path)), 4, timeout=240)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    j_losses, j_params = _jax_tp(params0, STEPS + 1)
    models, l_losses, whole_state = _local_tp(params0)
    _, saved, _ = ckpt.restore_sharded(
        str(tmp_path / "ckpt"), [np.zeros(x.shape, x.dtype)
                                 for x in whole_state])
    assert len(saved) == len(whole_state)
    for got, want in zip(saved, whole_state):
        np.testing.assert_array_equal(got, want)
    # the single file, read into 4 fresh local shards
    fresh = [ttp.shard_lm_state(TransformerConfig(**WIDTHS),
                                _rank_mesh((2, 2), ("data", "model"), r))
             for r in range(4)]
    opts = [_adamw(m) for m in fresh]
    checkpoint.restore_checkpoint(str(tmp_path / "file"), STEPS, fresh, opts)
    for got, want in zip(_whole(convert.train_state_to_flat(fresh, opts,
                                                            None))[:-1],
                         whole_state):
        np.testing.assert_array_equal(got, want)
    for r, res in enumerate(ranks):
        assert res["file/same"], f"rank {r}: restore_or_init"
        np.testing.assert_allclose(res["resumed/loss"], j_losses[STEPS],
                                   rtol=1e-5)
    resumed = _flat(convert.unshard_flax(
        [_nested({k[8:]: v for k, v in res.items()
                  if k.startswith("resumed/") and k != "resumed/loss"})
         for res in ranks], ttp.transformer_param_specs(params0, "model"),
        [{"model": (r, 4)} for r in range(4)]))
    for k, v in _flat(j_params[STEPS]).items():
        np.testing.assert_allclose(resumed[k], v, rtol=0, atol=1e-6,
                                   err_msg=f"resumed {k}")
    j_losses, j_params = j_losses[:STEPS], j_params[STEPS - 1]
    shards, coords = [], []
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["losses"], j_losses, rtol=1e-5)
        np.testing.assert_array_equal(res["losses"],
                                      [row[r] for row in l_losses])
        for k, v in _flat(_shard_tree(models[r])).items():
            np.testing.assert_array_equal(res[f"params/{k}"], v,
                                          err_msg=k)
        shards.append(_nested({k[7:]: v for k, v in res.items()
                               if k.startswith("params/")}))
        coords.append({"model": (r % 2, 2)})
    specs = ttp.transformer_param_specs(params0, "model")
    whole = _flat(convert.unshard_flax(shards, specs, coords))
    for k, v in _flat(j_params).items():
        np.testing.assert_allclose(whole[k], v, rtol=0, atol=1e-6,
                                   err_msg=k)


EXAMPLE = [sys.executable, "-m", "horovod_tpu_torch.examples.lm_benchmark",
           "--device", "cpu", "--layers", "1", "--d-model", "32", "--heads",
           "2", "--vocab", "64", "--seq-len", "32", "--steps", "1",
           "--warmup", "0", "--batch", "4"]


def _example(np_, *args):
    return subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", str(np_),
         *EXAMPLE, *args],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=180)


def test_lm_example_model_two_equals_one_rank():
    """``hvdrun -np 2 ... lm_benchmark --model 2`` (heads, d_ff and vocab
    over two ranks) trains as ``-np 1``: the same losses (rtol 1e-5), the
    mesh printed as data x model x expert; a world other than data x seq
    x model x expert exits 2."""
    two = _example(2, "--model", "2")
    one = _example(1)
    for out in (two, one):
        assert out.returncode == 0, out.stderr[-4000:]
    mesh_line, res = two.stdout.splitlines()[-2:]
    assert mesh_line == "mesh 1 x 2 x 1 (data x model x expert)"
    res, ref = json.loads(res), json.loads(one.stdout.splitlines()[-1])
    assert res["mesh"] == {"data": 1, "model": 2, "expert": 1}
    assert res["world"] == 2 and len(res["losses"]) == 2
    np.testing.assert_allclose(res["losses"], ref["losses"], rtol=1e-5)
    bad = subprocess.run([*EXAMPLE, "--model", "2"], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=180)
    assert bad.returncode == 2 and "needs 2 ranks" in bad.stderr
