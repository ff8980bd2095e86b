"""ZeRO-1 and the overlapped train step over a part of the mesh
(``DistributedOptimizer(axes=("data",))`` on a (data 2, model 2) mesh)
against the JAX package's ``make_train_step`` on a 2 x 2 CPU mesh, and
what ``axes=None`` resolves to there.

The port runs on 4 gloo ranks laid out as (data 2, model 2), one spawn
for every case; the ranks that share a data index are replicas: they
take the same shard of the batch and hold the same ZeRO-1 rows, as the
JAX rows ``P(("data",))`` are replicated over ``model``. The MLP (5 ->
10 -> 7 -> 3) has 161 parameters, odd, so every bucket of the world-2
schedule pads; a 64-byte fusion threshold spreads it over several
buckets. AdamW at lr 1e-2 with optax's decay stated, fp32, 3 steps:
losses to rtol 1e-5, parameters to atol 1e-6 (summation order only).

* ``axes=None`` means the data axes, as JAX's ``_resolve_axes``: the
  plain optimizer reduces over ``("data",)``, and ZeRO-1's schedule has
  world 2 and lays row ``d`` on the ranks of data index ``d``;
* ranks that start from different parameters and learning rates: a
  ``broadcast_parameters`` over ``("data",)`` leaves the model replicas
  apart, ``create_train_state``'s startup sync (every axis by default)
  makes every rank rank 0's, bit for bit, and three ZeRO-1 steps keep
  the four ranks equal, bit for bit, and JAX's;
* ZeRO-1 over ``("data",)`` (and over the default axes), with 2
  microbatches and the overlapped pipeline, with the int8 wire (within
  ``WIRE_EPSILON`` of the uncompressed run and equal to JAX's int8
  run), the overlapped pipeline without ZeRO-1, the GSPMD step with
  ZeRO-1 over ``("data",)``, and a small LM's ``make_lm_train_step``
  with ZeRO-1 over ``("data",)``;
* a checkpoint each package writes restores in the other bit for bit,
  and one more step agrees; the port's rows are written once, by the
  replica at model index 0;
* a ``TorchState`` commit at 2 x 2 restores at 2 x 2 bit for bit, from
  memory and from disk.
"""

import json
import os
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd_t
from horovod_tpu_torch import ckpt, convert
from horovod_tpu_torch import training as t_training
from horovod_tpu_torch.models.simple import MLP
from horovod_tpu_torch.models.transformer import Transformer, TransformerConfig
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import zero

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from __graft_entry__ import WIRE_EPSILON, WIRE_EPSILON_FLOOR  # noqa: E402

# the JAX side runs in the test process only: the spawned ranks import
# this module, and neither JAX nor the JAX package

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IN, FEATURES = 5, (10, 7, 3)  # 161 parameters
BATCH = 8  # global: 4 a data index, 2 a microbatch at accum 2
LR, WD = 1e-2, 1e-4
THRESHOLD = 64  # bytes
STEPS = 3
JAX_SAVED = "jax.saved"  # the file that marks JAX's checkpoint whole
SHAPE, NAMES = (2, 2), ("data", "model")
# name -> (sharded_update, axes, accum_steps, overlap_grads, wire, spmd)
CASES = {
    "zero": (True, ("data",), 1, False, None, False),
    "zero_default_axes": (True, None, 1, False, None, False),
    "zero_overlap": (True, ("data",), 2, True, None, False),
    "zero_overlap_int8": (True, ("data",), 2, True, "int8", False),
    "overlap": (False, ("data",), 2, True, None, False),
    "zero_spmd": (True, ("data",), 1, False, None, True),
}
LM_WIDTHS = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32,
                 d_ff=128)
# the LM at tests/test_torch_zero.py's rate: AdamW's first updates are
# about lr sign(g), so fp32 summation order in a gradient near zero moves
# an update by up to lr |dg| / eps, and atol 1e-6 is lr / 1000
LM_LR = 1e-3


def _data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, IN)).astype(np.float32)
    y = rng.integers(0, FEATURES[-1], size=(BATCH,)).astype(np.int32)
    return x, y


# -- the JAX side ----------------------------------------------------------

def _jax_mesh():
    """The JAX package on a (data 2, model 2) mesh of 4 CPU devices,
    installed as its mesh (ZeRO plans and ``_resolve_axes`` read it)."""
    import jax
    from jax.sharding import Mesh as JMesh

    import horovod_tpu as hvd_j
    from horovod_tpu.parallel import mesh as jmesh
    hvd_j.shutdown()
    hvd_j.init(devices=jax.devices()[:4])
    mesh = JMesh(np.asarray(jax.devices()[:4]).reshape(SHAPE), NAMES)
    jmesh.set_mesh(mesh)
    return mesh


def _jax_tx(case):
    import optax

    import horovod_tpu as hvd_j
    sharded, axes, _, _, wire, _ = CASES[case]
    return hvd_j.DistributedOptimizer(
        optax.adamw(LR, weight_decay=WD), sharded_update=sharded,
        axes=axes, threshold_bytes=THRESHOLD, compression=wire or "none")


def _jax_run(case, steps=STEPS):
    """``(state0, losses, state, step)`` of the JAX MLP on the 2 x 2
    mesh."""
    import jax
    import jax.numpy as jnp

    from horovod_tpu import training
    from horovod_tpu.models.simple import MLP as JMLP
    mesh = _jax_mesh()
    _, _, accum, overlap, _, spmd = CASES[case]
    tx = _jax_tx(case)
    model = JMLP(features=FEATURES)
    x, y = _data()
    state = training.create_train_state(model, tx, jax.random.PRNGKey(0),
                                        jnp.asarray(x[:1]))
    state0 = state
    step = training.make_train_step(model, tx, mesh=mesh, donate=False,
                                    accum_steps=accum,
                                    overlap_grads=overlap, spmd=spmd)
    losses = []
    for _ in range(steps):
        state, loss = step(state, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    return state0, losses, state, step


def _lm_tokens():
    return np.random.default_rng(1).integers(
        0, LM_WIDTHS["vocab_size"], size=(4, 16)).astype(np.int32)


def _jax_lm(steps=STEPS):
    """``(params0, losses, params)`` of JAX's ``make_lm_train_step`` with
    ZeRO-1 over ``("data",)`` on the 2 x 2 mesh, the batch over data,
    after ``steps`` steps."""
    import jax
    import jax.numpy as jnp
    import optax

    import horovod_tpu as hvd_j
    from horovod_tpu import training
    from horovod_tpu.models.transformer import Transformer as JTransformer
    from horovod_tpu.models.transformer import TransformerConfig as JConfig
    mesh = _jax_mesh()
    model = JTransformer(JConfig(**LM_WIDTHS, dtype=jnp.float32,
                                 flash_attention=False))
    tx = hvd_j.DistributedOptimizer(optax.adamw(LM_LR, weight_decay=WD),
                                    sharded_update=True, axes=("data",))
    tokens = jnp.asarray(_lm_tokens())
    state = training.create_train_state(model, tx, jax.random.PRNGKey(0),
                                        tokens[:1])
    params0 = jax.tree_util.tree_map(np.asarray, state.params)
    step = training.make_lm_train_step(model, tx, mesh=mesh,
                                       batch_axis="data", donate=False)
    losses = []
    for _ in range(steps):
        state, loss = step(state, tokens)
        losses.append(float(loss))
    return params0, losses, state.params


def _port_lm(params0):
    """The port's LM step with ZeRO-1 over ``("data",)``: this rank's
    half of the batch, its losses and flax-layout parameters."""
    cfg = TransformerConfig(**LM_WIDTHS, dtype=torch.float32,
                            flash_attention=True)
    model = Transformer(cfg)
    model.load_state_dict(convert.params_from_flax(params0, cfg))
    opt = hvd_t.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=LM_LR, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=WD),
        named_parameters=convert.flax_named_parameters(model),
        sharded_update=True, axes=("data",))
    t_training.create_train_state(model, opt)
    step = t_training.make_lm_train_step(model, opt)
    tokens = t_training.shard_lm_batch(
        torch.from_numpy(_lm_tokens()).long(), "data")
    losses = [float(step(tokens)) for _ in range(STEPS)]
    return dict(losses=losses, params=_params(model))


def _jax_layout():
    """What ``axes=None`` resolves to in the JAX package on the 2 x 2
    mesh: the reduction axes, ZeRO-1's schedule world, and each device's
    row (``mesh_rank`` over the schedule's axes under ``shard_map``)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from horovod_tpu.models.simple import MLP as JMLP
    from horovod_tpu.ops import collective as jcoll
    from horovod_tpu.parallel import zero as jzero
    mesh = _jax_mesh()
    params = JMLP(features=FEATURES).init(
        jax.random.PRNGKey(0), jnp.zeros((1, IN)))["params"]
    plan = jzero.make_plan(params, axes=None, threshold_bytes=THRESHOLD)
    sched = plan.schedule

    def rows(x):
        return x + jcoll.mesh_rank(sched.axes)

    got = jax.shard_map(rows, mesh=mesh, in_specs=P(NAMES),
                        out_specs=P(NAMES), check_vma=False)(
        jnp.zeros((4,), jnp.int32))
    return dict(axes=list(jcoll._resolve_axes(None)), world=sched.world,
                rows=np.asarray(got).tolist())


# -- the port side (each of 4 gloo ranks) ----------------------------------

def _port_opt(case, model):
    sharded, axes, _, _, wire, _ = CASES[case]
    return hvd_t.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=WD),
        named_parameters=convert.flax_named_parameters(model),
        sharded_update=sharded, axes=axes, threshold_bytes=THRESHOLD,
        compression=wire or "none")


def _port_build(case, params0):
    model = MLP(IN, FEATURES)
    model.load_state_dict(convert.params_from_flax(params0, model))
    opt = _port_opt(case, model)
    t_training.create_train_state(model, opt)
    _, _, accum, overlap, _, spmd = CASES[case]
    step = t_training.make_train_step(model, opt, accum_steps=accum,
                                      overlap_grads=overlap, spmd=spmd)
    return model, opt, step


def _shard():
    """This rank's shard of the batch: the half of its data index."""
    x, y = _data()
    d = tmesh.axis_index("data")
    n = BATCH // SHAPE[0]
    return (torch.from_numpy(x[d * n:(d + 1) * n]),
            torch.from_numpy(y[d * n:(d + 1) * n]).long())


def _params(model):
    """The model's parameters as flax's nested tree, in json's lists."""
    def listed(tree):
        return {k: listed(v) if isinstance(v, dict) else v.tolist()
                for k, v in tree.items()}
    return listed(convert.flax_from_params(model.state_dict(), model))


def _port_flat(model, opt, step_fn):
    """Host numpy copies of the port's flat train state (a ZeroLeaf as
    ``{key: {row: array} or array}``), as tests/test_torch_ckpt.py's."""
    out = []
    for leaf in convert.train_state_to_flat(model, opt, step_fn.state):
        if isinstance(leaf, ckpt.ZeroLeaf):
            out.append({key: ({r: np.array(v.detach().numpy())
                               for r, v in value.items()}
                              if b is not None else np.array(value))
                        for key, b, value in leaf.entries})
        elif torch.is_tensor(leaf):
            out.append(np.array(leaf.detach().numpy()))
        else:
            out.append(np.array(leaf))
    return out


def _listed(flat):
    """A host flat state as json's lists (rows keyed by str), the form
    tests/test_torch_ckpt.py's ``_unlisted`` reads back."""
    def one(x):
        if isinstance(x, dict):
            return {str(k): one(v) for k, v in x.items()}
        return [str(x.dtype), np.asarray(x).tolist()]
    return [one(leaf) for leaf in flat]


def _flat_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_flat_equal(a[k], b[k])
                                            for k in a)
    return a.dtype == b.dtype and np.array_equal(a, b)


def rank_checks(work):
    """Run on each of 4 gloo ranks; returns this rank's results."""
    mesh = tmesh.build_mesh(SHAPE, NAMES)
    params0 = np.load(os.path.join(work, "params0.npy"),
                      allow_pickle=True).item()
    xs, ys = _shard()
    out = {"coords": list(mesh.coords)}
    out["lm"] = _port_lm(np.load(os.path.join(work, "lm0.npy"),
                                 allow_pickle=True).item())

    model = MLP(IN, FEATURES)
    plain = hvd_t.DistributedOptimizer(torch.optim.SGD(
        model.parameters(), lr=0.1))
    out["axes"] = list(plain.reduce_axes())
    sched = _port_opt("zero_default_axes", model).zero_state.plan.schedule
    out["world"], out["row"] = sched.world, zero.row_index(sched)

    # replicas that start apart (parameters and learning rate by rank):
    # a sync over ("data",) leaves the model replicas apart, the startup
    # sync (every axis by default) makes every rank rank 0's, and ZeRO-1
    # over ("data",) then keeps them equal
    r = hvd_t.rank()
    model = MLP(IN, FEATURES)
    model.load_state_dict({k: v + 0.125 * r for k, v in
                           convert.params_from_flax(params0, model).items()})
    opt = _port_opt("zero", model)
    for g in opt.param_groups:
        g["lr"] = LR * (1 + r)
    hvd_t.broadcast_parameters(model.state_dict(), axes=("data",))
    out["sync_data"] = _params(model)
    t_training.create_train_state(model, opt)
    out["sync_lr"] = opt.param_groups[0]["lr"]
    out["sync_world"] = _params(model)
    step = t_training.make_train_step(model, opt)
    out["sync_zero"] = dict(losses=[float(step(xs, ys))
                                    for _ in range(STEPS)],
                            params=_params(model))

    for case in CASES:
        model, opt, step = _port_build(case, params0)
        # the GSPMD step takes the global batch on every rank
        batch = ((torch.from_numpy(_data()[0]),
                  torch.from_numpy(_data()[1]).long())
                 if CASES[case][5] else (xs, ys))
        losses = [float(step(*batch)) for _ in range(STEPS)]
        out[case] = dict(losses=losses, params=_params(model))
        if opt.zero_state is not None:
            sd = opt.state_dict()["zero"]
            out[case]["zero"] = [sd["world"], sd["row"]]
        if case != "zero":
            continue
        # the port's checkpoint, written by 4 ranks, for JAX to restore
        flat = _port_flat(model, opt, step)
        out["saved"] = _listed(flat)
        ckpt.save_sharded(os.path.join(work, "port"), STEPS,
                          convert.train_state_to_flat(model, opt,
                                                      step.state),
                          rank=hvd_t.rank(), world=hvd_t.size())
        # a TorchState commit at 2 x 2, restored from memory and from
        # disk after one more step
        from horovod_tpu_torch.elastic import TorchState
        state = TorchState(model, opt, step.state,
                           directory=os.path.join(work, "elastic"))
        state.commit()
        state.flush()
        loss4 = float(step(xs, ys))
        out["port_step4"] = dict(loss=loss4, params=_params(model))
        state.restore()
        out["memory_restore"] = all(
            _flat_equal(a, b) for a, b in zip(
                _port_flat(model, opt, step), flat))
        model2, opt2, step2 = _port_build(case, params0)
        TorchState(model2, opt2, step2.state,
                   directory=os.path.join(work, "elastic")).restore()
        out["disk_restore"] = all(
            _flat_equal(a, b) for a, b in zip(
                _port_flat(model2, opt2, step2), flat))

    # JAX's checkpoint, restored here, then one more step
    deadline = time.monotonic() + 200
    while not os.path.exists(os.path.join(work, JAX_SAVED)):
        if time.monotonic() > deadline:
            raise TimeoutError("JAX's checkpoint was not saved")
        time.sleep(0.05)
    model, opt, step = _port_build("zero", params0)
    target = convert.train_state_to_flat(model, opt, step.state)
    _, restored, _ = ckpt.restore_sharded(os.path.join(work, "jax"), target)
    convert.train_state_from_flat(model, opt, step.state, restored)
    out["restored"] = _listed(_port_flat(model, opt, step))
    out["jax_step4"] = dict(loss=float(step(xs, ys)), params=_params(model))
    return out


_WORKER = textwrap.dedent("""
    import json, os, sys
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, {tests!r})
    import horovod_tpu_torch as hvd
    import test_torch_zero_mesh as t
    hvd.init(device="cpu")
    out = t.rank_checks({work!r})
    with open(os.path.join({work!r}, f"rank{{hvd.rank()}}.json"), "w") as f:
        json.dump(out, f)
    hvd.shutdown()
""")


def _assert_run(got, losses, params, rtol=1e-5, atol=1e-6):
    import jax
    np.testing.assert_allclose(got["losses"], losses, rtol=rtol)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(np.asarray(b), a,
                                                atol=atol),
        jax.tree_util.tree_map(np.asarray, params), got["params"])


@pytest.fixture()
def jax_world():
    yield
    import horovod_tpu as hvd_j
    hvd_j.shutdown()


def test_four_gloo_ranks_data_two_model_two_match_jax(jax_world, tmp_path):
    import jax
    import jax.numpy as jnp

    from horovod_tpu import ckpt as jckpt
    import test_torch_ckpt as tc
    from test_torch_serve_mesh import _start_ranks, _wait_ranks
    work = str(tmp_path)
    # what the ranks read first: the initial parameters; the JAX side
    # runs while they start and run, and saves its state after 3 steps
    # for them to restore at their end (``JAX_SAVED`` marks it whole)
    target, _, _, jstep0 = _jax_run("zero", steps=0)
    params0 = jax.tree_util.tree_map(np.asarray, target.params)
    np.save(os.path.join(work, "params0.npy"), params0, allow_pickle=True)
    np.save(os.path.join(work, "lm0.npy"), _jax_lm(steps=0)[0],
            allow_pickle=True)
    procs = _start_ranks(_WORKER.format(
        tests=os.path.join(REPO, "tests"), work=work), 4, work)
    runs = {"zero": _jax_run("zero")}
    _, _, jstate, jstep = runs["zero"]
    tc._jax_save_world(os.path.join(work, "jax"), STEPS, jstate, 1)
    open(os.path.join(work, JAX_SAVED), "w").close()
    layout = _jax_layout()
    runs.update({case: _jax_run(case) for case in CASES if case != "zero"})
    lm0, lm_losses, lm_params = _jax_lm()
    x, y = _data()
    j4, j4_loss = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
    _wait_ranks(procs, 240)
    ranks = []
    for r in range(4):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))

    # axes=None: the data axes, as the JAX package resolves them
    assert layout == dict(axes=["data"], world=2, rows=[0, 0, 1, 1])
    for r, res in enumerate(ranks):
        d = r // SHAPE[1]
        assert res["coords"] == [d, r % SHAPE[1]]
        assert res["axes"] == layout["axes"]
        assert (res["world"], res["row"]) == (2, layout["rows"][r])

    # the startup sync: over ("data",) each model index keeps its own,
    # by default every rank takes rank 0's; a ZeRO-1 step keeps them equal
    assert ranks[2]["sync_data"] == ranks[0]["sync_data"]
    assert ranks[3]["sync_data"] == ranks[1]["sync_data"]
    assert ranks[1]["sync_data"] != ranks[0]["sync_data"]
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(b, a.dtype),
                                                   a),
        params0, ranks[0]["sync_world"])
    for res in ranks:
        assert res["sync_lr"] == LR
        assert res["sync_world"] == ranks[0]["sync_world"]
        assert res["sync_zero"]["params"] == ranks[0]["sync_zero"]["params"]
        _assert_run(res["sync_zero"], runs["zero"][1],
                    runs["zero"][2].params)

    for res in ranks:  # the LM step, ZeRO-1 over data
        _assert_run(res["lm"], lm_losses, lm_params)
    for case, (_, losses, state, _) in runs.items():
        for r, res in enumerate(ranks):
            _assert_run(res[case], losses, state.params)
            if CASES[case][0]:
                assert res[case]["zero"] == [2, r // SHAPE[1]], case
    # the int8 wire against the uncompressed run
    for res in ranks:
        for a, b in zip(res["zero_overlap_int8"]["losses"],
                        res["zero_overlap"]["losses"]):
            assert abs(a - b) <= WIRE_EPSILON * max(abs(b),
                                                    WIRE_EPSILON_FLOOR)

    # the port's 4-rank checkpoint in JAX: bit for bit, then one step
    flats = [tc._unlisted(res["saved"]) for res in ranks]
    jrestored = jckpt.restore_sharded(os.path.join(work, "port"),
                                      target)[1]
    tc._assert_state_equal(jrestored, flats)
    jnext, jnext_loss = jstep0(jrestored, jnp.asarray(x), jnp.asarray(y))
    for res in ranks:
        _assert_run({"losses": [res["port_step4"]["loss"]],
                     "params": res["port_step4"]["params"]},
                    [float(jnext_loss)], jnext.params)
        assert res["memory_restore"] and res["disk_restore"]
    # each row written once: by the replica at model index 0
    from horovod_tpu_torch.ckpt import sharded as tsharded
    written = {}
    for r in range(4):
        payload = tsharded._read_shard(os.path.join(work, "port"), STEPS,
                                       r, 4, None)
        for z in payload["zero"].values():
            for rows in z["rows"].values():
                written.setdefault(r, set()).update(rows)
    assert written == {0: {"0"}, 2: {"1"}}

    # JAX's checkpoint in the port: bit for bit, then one step
    tc._assert_state_equal(jstate, [tc._unlisted(res["restored"])
                                    for res in ranks])
    for res in ranks:
        _assert_run({"losses": [res["jax_step4"]["loss"]],
                     "params": res["jax_step4"]["params"]},
                    [float(j4_loss)], j4.params)
