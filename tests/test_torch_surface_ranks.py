"""The multi-rank half of ``tests/test_torch_surface.py``: one spawn of 4
gloo ranks for every check, against the JAX package on 4 CPU devices.

* ``init(num_slices=2)`` builds the ``("dcn", "data")`` mesh of (2, 2)
  ranks, JAX's shape and axis names; ``num_slices=1`` and the default
  both give ``("data",)`` of 4; ``num_slices=3`` is refused before the
  rendezvous with JAX's message.
* ``make_train_step(batch_axes=("data",), mesh=hvd.mesh())`` on that
  (dcn 2, data 2) mesh, ResNet-18 (8 filters) at 32² with BatchNorm, SGD
  with momentum, 3 steps: the loss, the BatchNorm statistics and the
  gradient exchange go over ``("data",)`` only, so the two dcn indices,
  fed batches of their own, train apart. Each against JAX's
  ``make_train_step(batch_axes=("data",))`` on the 2 x 2 CPU mesh on
  that batch (where the dcn replicas take the same half of it):
  losses to rtol 1e-5, parameters to atol 1e-6, BatchNorm statistics to
  ``tests/test_torch_resnet.py``'s bound (1e-6 + 5e-2 of how far a leaf
  moved). Both sides compute in fp64 (JAX under ``enable_x64``, the loss
  taken in fp64 as ``test_torch_resnet.py``'s fp64 test takes it): in
  fp32 this net is chaotic, its last stage normalizing over 4 values a
  channel, and JAX's own third loss moves by 0.5 % when its start moves
  by 1e-6. An optimizer that reduces over other axes, and a mesh that is
  not the installed one, are refused.
* ``restore_or_init(axes=("data",))`` on that mesh, resuming a step that
  rank 0 saved: ``axes`` is ignored, as JAX's ``restore_or_init``
  ignores it, so every rank, in either dcn index, loads rank 0's file.
* ``allgather(tiled=False)`` over ``"data"`` (2 ranks) and over
  ``("dcn", "data")``, against JAX's ``allgather(tiled=False)`` under
  ``shard_map``, bit for bit; its gradient is the tiled form's.
* The dense ring with given (packed) positions over a (data 2, seq 2)
  mesh, each data index one row of the batch: the LM's logits and the
  gradients of every parameter (summed over the ranks) against JAX's
  ``Transformer(sequence_axis="seq")`` under ``shard_map`` on 2 CPU
  devices, out to 2e-5 and gradients to 5e-4 (``tests/test_torch_ring.py``'s
  bounds); the flash ring's functions are made to raise, so the given
  positions must take the dense ring.

The spawned ranks import this module and neither JAX nor the JAX package
(the test hands them weights and data as files and runs the JAX side
while they run); each writes its results to a file.
"""

import json
import os
import socket
import sys
import textwrap

import numpy as np
import torch

import horovod_tpu_torch as hvd_t
from horovod_tpu_torch import convert
from horovod_tpu_torch import training as t_training
from horovod_tpu_torch.ops import collective as tcoll
from horovod_tpu_torch.parallel import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
CLASSES, FILTERS, SIZE = 10, 8, 32
BATCH = 8  # a dcn index's: 4 a data index
LR, STEPS = 0.01, 3
LM = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32, d_ff=128)
LM_B, LM_S = 2, 32  # the ring's global batch: one row a data index
AG_SHAPE = (3, 2)


def _xent64(logits, labels):
    """The loss in fp64 on both sides."""
    if isinstance(logits, torch.Tensor):
        logp = torch.log_softmax(logits.double(), dim=-1)
        return -logp.gather(-1, labels[..., None].long())[..., 0].mean()
    import jax
    import jax.numpy as jnp
    logp = jax.nn.log_softmax(logits.astype(jnp.float64), axis=-1)
    return -jnp.mean(jnp.take_along_axis(logp, labels[..., None],
                                         axis=-1)[..., 0])


def _images(group):
    """The batch of dcn index ``group``."""
    rng = np.random.default_rng(22 + group)
    x = rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32)
    y = rng.integers(0, CLASSES, size=(BATCH,)).astype(np.int32)
    return x, y


def _ag_inputs():
    """Each rank's ``allgather`` input and the weights of its loss."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((WORLD,) + AG_SHAPE).astype(np.float32)
    w = rng.standard_normal((2,) + AG_SHAPE).astype(np.float32)
    return x, w


def _lm_inputs():
    """Tokens, packed positions (two documents of ``LM_S // 2``, each from
    0) and the loss weights of the ring check."""
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, LM["vocab_size"], size=(LM_B, LM_S))
    half = np.concatenate([np.arange(LM_S // 2), np.arange(LM_S // 2)])
    pos = np.broadcast_to(half, (LM_B, LM_S)).copy()
    w = rng.standard_normal((LM_B, LM_S, LM["vocab_size"])).astype(
        np.float32)
    return tokens.astype(np.int32), pos.astype(np.int32), w


def _listed(tree):
    if isinstance(tree, dict):
        return {k: _listed(v) for k, v in tree.items()}
    return np.asarray(tree).tolist()


# -- the port side (each of 4 gloo ranks) ----------------------------------

def _mesh_of(hvd):
    m = hvd.mesh()
    return [list(m.axis_names), list(m.shape)]


def _resnet_checks(hvd, work):
    from horovod_tpu_torch.models import resnet
    start = np.load(os.path.join(work, "resnet0.npy"),
                    allow_pickle=True).item()
    model = resnet.ResNet((2, 2, 2, 2), resnet.BasicBlock,
                          num_filters=FILTERS, num_classes=CLASSES,
                          dtype=torch.float64).double()
    model.load_state_dict(convert.params_from_flax(start["params"], model),
                          strict=False)
    model.load_state_dict(convert.batch_stats_from_flax(start["stats"],
                                                        model), strict=False)

    def opt_of(axes):
        return hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9),
            named_parameters=convert.flax_named_parameters(model),
            axes=axes)
    out = {}
    try:  # an optimizer over every data axis, a step over ("data",)
        t_training.make_train_step(model, opt_of(None),
                                   batch_axes=("data",))
    except ValueError as e:
        out["refused_axes"] = str(e)
    other = tmesh.Mesh(group=None, device=torch.device("cpu"), size=WORLD,
                       rank=hvd.rank(), axis_names=("data",), shape=(WORLD,))
    opt = opt_of(("data",))
    try:
        t_training.make_train_step(model, opt, mesh=other,
                                   batch_axes=("data",))
    except ValueError as e:
        out["refused_mesh"] = str(e)
    t_training.create_train_state(model, opt)
    step = t_training.make_train_step(model, opt, mesh=hvd.mesh(),
                                      loss_fn=_xent64, batch_axes=("data",))
    x, y = _images(tmesh.axis_index("dcn"))
    d, n = tmesh.axis_index("data"), BATCH // 2
    xs = torch.from_numpy(x[d * n:(d + 1) * n]).double().permute(0, 3, 1, 2)
    ys = torch.from_numpy(y[d * n:(d + 1) * n]).long()
    out["losses"] = [float(step(xs.contiguous(), ys)) for _ in range(STEPS)]
    sd = model.state_dict()
    out["params"] = _listed(convert.flax_from_params(sd, model))
    out["stats"] = _listed(convert.flax_from_batch_stats(sd, model))
    return out


def _resume_checks(hvd, work):
    """Rank 0 saves a module of two parameters at step 5; every rank,
    its own module drawn from a seed of its own, resumes with
    ``axes=("data",)``."""
    from horovod_tpu_torch import checkpoint

    def module(seed):
        gen = torch.Generator().manual_seed(seed)
        m = torch.nn.Module()
        m.w = torch.nn.Parameter(torch.randn(3, 2, generator=gen,
                                             dtype=torch.float64))
        m.b = torch.nn.Parameter(torch.randn(2, generator=gen,
                                             dtype=torch.float64))
        return m
    directory = os.path.join(work, "ckpt")
    saved = module(100 + hvd.rank())
    if hvd.rank() == 0:
        checkpoint.save_checkpoint(directory, 5, saved, meta={"epoch": 2})
    model = module(200 + hvd.rank())
    step, meta = checkpoint.restore_or_init(directory, model,
                                            axes=("data",))
    return {"step": step, "meta": meta,
            "saved": _listed(dict(saved.state_dict())),
            "restored": _listed(dict(model.state_dict()))}


def _allgather_checks(hvd):
    x, w = _ag_inputs()
    mine = torch.from_numpy(x[hvd.rank()]).requires_grad_()
    out = {}
    y = tcoll.allgather(mine, axes="data", tiled=False)
    out["data"] = y.tolist()
    out["both"] = tcoll.allgather(mine.detach(), axes=("dcn", "data"),
                                  tiled=False).tolist()
    out["async"] = tcoll.allgather(mine.detach(), axes="data", tiled=False,
                                   async_op=True).wait().tolist()
    (y * torch.from_numpy(w)).sum().backward()
    untiled = mine.grad.clone()
    mine.grad = None
    tiled = tcoll.allgather(mine, axes="data")
    (tiled * torch.from_numpy(w).reshape(tiled.shape)).sum().backward()
    out["grad_equal"] = bool(torch.equal(untiled, mine.grad))
    out["grad"] = untiled.tolist()
    return out


def _ring_checks(hvd, work):
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    from horovod_tpu_torch.parallel import ring as tring

    def refuse(*args, **kwargs):
        raise AssertionError("given positions reached the flash ring")
    tring._flash_ring_forward = refuse
    tmesh.build_mesh((2, 2), ("data", "seq"))
    params = np.load(os.path.join(work, "lm0.npy"), allow_pickle=True).item()
    cfg = TransformerConfig(**LM, dtype=torch.float32, flash_attention=True,
                            sequence_axis="seq")
    model = Transformer(cfg)
    model.load_state_dict(convert.params_from_flax(params, cfg))
    tokens, pos, w = _lm_inputs()
    d, s = tmesh.axis_index("data"), tmesh.axis_index("seq")
    block = slice(s * LM_S // 2, (s + 1) * LM_S // 2)
    logits = model(torch.from_numpy(tokens[d:d + 1, block]).long(),
                   torch.from_numpy(pos[d:d + 1, block]))
    (logits * torch.from_numpy(w[d:d + 1, block])).sum().backward()
    grads = {n: tcoll.allreduce(p.grad, op=hvd.Sum, axes=("data", "seq"))
             for n, p in model.named_parameters()}
    return {"coords": [d, s], "logits": logits.detach().tolist(),
            "grads": _listed(convert.flax_from_params(grads, cfg))}


def _init_checks(hvd):
    """Three more inits of the same world, each at a fresh rendezvous
    port: ``num_slices=1``, the default, and ``num_slices=3``."""
    ports = os.environ["SURFACE_PORTS"].split(",")
    out = {}
    for key, kw, port in (("one", {"num_slices": 1}, ports[0]),
                          ("default", {}, ports[1])):
        os.environ["MASTER_PORT"] = port
        hvd.init(device="cpu", **kw)
        out[key] = _mesh_of(hvd)
        hvd.shutdown()
    try:
        hvd.init(device="cpu", num_slices=3)
    except ValueError as e:
        out["three"] = str(e)
    out["three_initialized"] = hvd.is_initialized()
    return out


def rank_checks(work):
    hvd = hvd_t
    hvd.init(device="cpu", num_slices=2)
    out = {"rank": hvd.rank(), "mesh": _mesh_of(hvd)}
    out["resnet"] = _resnet_checks(hvd, work)
    out["resume"] = _resume_checks(hvd, work)
    out["allgather"] = _allgather_checks(hvd)
    out["ring"] = _ring_checks(hvd, work)
    hvd.shutdown()
    out["init"] = _init_checks(hvd)
    return out


_WORKER = textwrap.dedent("""
    import json, os, sys
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, {tests!r})
    import test_torch_surface_ranks as t
    out = t.rank_checks({work!r})
    with open(os.path.join({work!r}, f"rank{{out['rank']}}.json"),
              "w") as f:
        json.dump(out, f)
""")


# -- the JAX side -----------------------------------------------------------

def _jax_mesh(**kw):
    import jax

    import horovod_tpu as hvd_j
    hvd_j.shutdown()
    hvd_j.init(devices=jax.devices()[:WORLD], **kw)
    return hvd_j.mesh()


def _jax_resnet():
    """The initial variables (BatchNorm scales drawn away from 1), and for
    each dcn index's batch the losses, parameters and statistics after 3
    steps of JAX's ``make_train_step(batch_axes=("data",))`` on the (dcn
    2, data 2) mesh."""
    import jax
    import jax.numpy as jnp
    import optax

    import horovod_tpu as hvd_j
    from horovod_tpu import training
    from horovod_tpu.models import resnet as jresnet
    def net(dtype):
        return jresnet.ResNet(stage_sizes=(2, 2, 2, 2),
                              block_cls=jresnet.BasicBlock,
                              num_filters=FILTERS, num_classes=CLASSES,
                              dtype=dtype)
    x, _ = _images(0)
    v = net(jnp.float32).init(jax.random.PRNGKey(0), jnp.asarray(x[:1]),
                              train=False)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map_with_path(
        lambda p, leaf: (rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
                         if p[-1].key == "scale" else np.asarray(leaf)),
        v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    with jax.enable_x64(True):
        mesh = _jax_mesh(num_slices=2)
        tx = hvd_j.DistributedOptimizer(optax.sgd(LR, momentum=0.9),
                                        axes=("data",))

        def f64(tree):
            return jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), tree)
        step = training.make_train_step(net(jnp.float64), tx, mesh=mesh,
                                        loss_fn=_xent64,
                                        batch_axes=("data",), donate=False)
        losses, finals = [], []
        for group in range(2):
            jp = f64(params)
            state = training.TrainState(
                params=jp, opt_state=tx.init(jp), batch_stats=f64(stats),
                step=jnp.zeros((), jnp.int32))
            x, y = _images(group)
            losses.append([])
            for _ in range(STEPS):
                state, loss = step(state, jnp.asarray(x, jnp.float64),
                                   jnp.asarray(y))
                losses[-1].append(float(loss))
            finals.append(jax.tree_util.tree_map(
                np.asarray, (state.params, state.batch_stats)))
    return {"params": params, "stats": stats}, losses, finals


def _jax_allgather():
    """Each device's ``allgather(tiled=False)`` over ``data`` and over
    ``(dcn, data)`` on the (dcn 2, data 2) mesh, device r holding rank r's
    input."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from horovod_tpu.ops import collective as jcoll
    mesh = _jax_mesh(num_slices=2)
    x, _ = _ag_inputs()
    spec = P(("dcn", "data"))

    def run(axes):
        f = jax.shard_map(
            lambda t: jcoll.allgather(t[0], axes=axes, tiled=False)[None],
            mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False)
        return np.asarray(f(jnp.asarray(x)))
    return run(("data",)), run(("dcn", "data"))


def _jax_ring(params):
    """JAX's LM with ``sequence_axis="seq"`` under ``shard_map`` on 2 CPU
    devices at the packed positions: its logits, and the gradients of
    ``sum(logits * w)`` (each shard's, summed over the ring)."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import PartitionSpec as P

    from horovod_tpu.models.transformer import Transformer as JTransformer
    from horovod_tpu.models.transformer import TransformerConfig as JConfig
    model = JTransformer(JConfig(**LM, dtype=jnp.float32,
                                 flash_attention=True, sequence_axis="seq"))
    tokens, pos, w = _lm_inputs()
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("seq",))

    def local(p, t, q, wt):
        def loss(p):
            return jnp.sum(model.apply({"params": p}, t, q) * wt)
        g = jax.grad(loss)(p)
        return (model.apply({"params": p}, t, q),
                jax.tree_util.tree_map(lambda x: lax.psum(x, "seq"), g))

    seq = P(None, "seq")
    f = jax.jit(jax.shard_map(local, mesh=mesh,
                              in_specs=(P(), seq, seq, seq),
                              out_specs=(seq, P()), check_vma=False))
    logits, grads = f(jax.tree_util.tree_map(jnp.asarray, params),
                      jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(w))
    return np.asarray(logits), jax.tree_util.tree_map(np.asarray, grads)


def _jax_lm_params():
    import jax
    import jax.numpy as jnp

    from horovod_tpu.models.transformer import Transformer as JTransformer
    from horovod_tpu.models.transformer import TransformerConfig as JConfig
    tokens, _, _ = _lm_inputs()
    model = JTransformer(JConfig(**LM, dtype=jnp.float32))
    return jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(3), jnp.asarray(tokens[:1]),
        train=False)["params"])


def _jax_init():
    """JAX's mesh at ``num_slices`` 2, 1 and None over 4 devices, and its
    refusal of 3."""
    import jax

    import horovod_tpu as hvd_j
    out = {}
    for key, kw in (("two", {"num_slices": 2}), ("one", {"num_slices": 1}),
                    ("default", {})):
        m = _jax_mesh(**kw)
        out[key] = [list(m.axis_names), list(m.devices.shape)]
    hvd_j.shutdown()
    try:
        hvd_j.init(devices=jax.devices()[:WORLD], num_slices=3)
    except ValueError as e:
        out["three"] = str(e)
    hvd_j.shutdown()
    return out


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _assert_tree(got, want, atol, what, start=None, moved=0.0):
    import jax
    leaves = jax.tree_util.tree_leaves_with_path(want)
    starts = (jax.tree_util.tree_leaves(start) if start is not None
              else [None] * len(leaves))
    for (path, a), c in zip(leaves, starts):
        b = got
        for key in path:
            b = b[key.key]
        a = np.asarray(a)
        bound = atol if c is None else atol + moved * float(
            np.abs(a - np.asarray(c)).max())
        np.testing.assert_allclose(np.asarray(b, a.dtype), a, rtol=0,
                                   atol=bound,
                                   err_msg=f"{what}{jax.tree_util.keystr(path)}")


def test_four_gloo_ranks_match_jax(tmp_path):
    import horovod_tpu as hvd_j
    from test_torch_serve_mesh import _start_ranks, _wait_ranks
    work = str(tmp_path)
    start, losses, final = _jax_resnet()
    np.save(os.path.join(work, "resnet0.npy"), start, allow_pickle=True)
    lm0 = _jax_lm_params()
    np.save(os.path.join(work, "lm0.npy"), lm0, allow_pickle=True)
    env_ports = ",".join(map(str, _free_ports(2)))
    os.environ["SURFACE_PORTS"] = env_ports
    try:
        procs = _start_ranks(_WORKER.format(
            tests=os.path.join(REPO, "tests"), work=work), WORLD, work)
    finally:
        del os.environ["SURFACE_PORTS"]
    try:
        ag_data, ag_both = _jax_allgather()
        ring_logits, ring_grads = _jax_ring(lm0)
        jinit = _jax_init()
    finally:
        hvd_j.shutdown()
    _wait_ranks(procs, 300)
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))

    # init(num_slices=)
    for res in ranks:
        assert res["mesh"] == jinit["two"] == [["dcn", "data"], [2, 2]]
        assert res["init"]["one"] == jinit["one"] == [["data"], [4]]
        assert res["init"]["default"] == jinit["default"]
        assert res["init"]["three"] == jinit["three"]
        assert not res["init"]["three_initialized"]

    # make_train_step(batch_axes=("data",)) against JAX's
    for r, res in enumerate(ranks):
        got, g = res["resnet"], r // 2  # rank r is (dcn r // 2, data r % 2)
        assert "DistributedOptimizer(axes=('data',))" in got["refused_axes"]
        assert "installed mesh" in got["refused_mesh"]
        np.testing.assert_allclose(got["losses"], losses[g], rtol=1e-5)
        _assert_tree(got["params"], final[g][0], 1e-6, "params")
        _assert_tree(got["stats"], final[g][1], 1e-6, "batch_stats",
                     start=start["stats"], moved=5e-2)
        assert got["params"] == ranks[2 * g]["resnet"]["params"]
    assert abs(losses[0][-1] - losses[1][-1]) > 1e-3  # the groups differ

    # restore_or_init(axes=("data",)) ignores axes: rank 0's file everywhere
    saved = ranks[0]["resume"]["saved"]
    assert ranks[2]["resume"]["saved"] != saved  # the ranks drew apart
    for r, res in enumerate(ranks):
        assert res["resume"]["step"] == 5
        assert res["resume"]["meta"] == ({"epoch": 2} if r == 0 else {})
        assert res["resume"]["restored"] == saved

    # allgather(tiled=False), bit for bit JAX's
    for r, res in enumerate(ranks):
        got = res["allgather"]
        assert np.array_equal(np.asarray(got["data"], np.float32),
                              ag_data[r])
        assert np.array_equal(np.asarray(got["both"], np.float32),
                              ag_both[r])
        assert got["async"] == got["data"]
        assert got["grad_equal"]

    # the dense ring at given positions
    for res in ranks:
        d, s = res["ring"]["coords"]
        block = ring_logits[d:d + 1, s * LM_S // 2:(s + 1) * LM_S // 2]
        np.testing.assert_allclose(np.asarray(res["ring"]["logits"]), block,
                                   rtol=0, atol=2e-5)
        _assert_tree(res["ring"]["grads"], ring_grads, 5e-4, "grads")
