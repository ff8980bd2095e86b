"""The port's sharded checkpoints (horovod_tpu_torch/ckpt, and
convert.py's train-state mapping) against the JAX package's
(horovod_tpu/ckpt), on the same disk format.

A JAX ``TrainState(params, opt_state, batch_stats, step)`` with a
``DistributedOptimizer`` over ``optax.adamw`` or ``optax.sgd(momentum)``,
replicated or ZeRO-1, is saved by one package and restored by the other:

* the flat key paths of the port's state equal
  ``jax.tree_util.tree_flatten_with_path``'s, string for string;
* a restore is bit for bit: every leaf (ZeRO-1 rows over their used
  elements, the padding zeros) equals what the JAX package's own restore
  of the same checkpoint gives, at world 1 and 2 and across a 2 -> 1 and
  a 1 -> 2 reshard, in both directions;
* a JAX-written state restored in the port and in JAX then takes one
  more step on the same batch on each side: losses to rtol 1e-5,
  parameters to atol 1e-6 (the trajectory tolerance of
  tests/test_torch_zero.py: summation order only);
* the bytes of a shard equal flax's ``msgpack_serialize`` of the same
  payload, so a JAX state restored in the port and saved again gives
  JAX's shard file byte for byte;
* a save is a snapshot: a step taken at once after ``save()`` does not
  reach it;
* torn writes, CRC mismatches and retention behave as in
  tests/test_ckpt.py.

The MLP (6 -> 10 -> 7 -> 3) at a 64-byte fusion threshold spans several
buckets; a small LM (its ``heads_in``/``heads_out`` kernels) and a small
BatchNorm ResNet (``batch_stats``) cover the other layouts. World 2 runs
in two spawned gloo processes (one spawn for the file) against a
2-device CPU mesh.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import horovod_tpu as hvd_j
import horovod_tpu_torch as hvd_t
from horovod_tpu import ckpt as jckpt
from horovod_tpu import training
from horovod_tpu.ckpt import manifest as jmanifest
from horovod_tpu.ckpt import sharded as jsharded
from horovod_tpu.models import resnet as jresnet
from horovod_tpu.models.simple import MLP as JMLP
from horovod_tpu.models.transformer import Transformer as JTransformer
from horovod_tpu.models.transformer import TransformerConfig as JConfig
from horovod_tpu_torch import ckpt, convert
from horovod_tpu_torch import training as t_training
from horovod_tpu_torch.ckpt import _msgpack
from horovod_tpu_torch.ckpt import manifest as tmanifest
from horovod_tpu_torch.ckpt import sharded as tsharded
from horovod_tpu_torch.models import resnet
from horovod_tpu_torch.models.simple import MLP
from horovod_tpu_torch.models.transformer import Transformer, TransformerConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IN, FEATURES, BATCH = 6, (10, 7, 3), 8
LR, WD = 1e-3, 1e-4
THRESHOLD = 64  # bytes: the MLP's leaves span several buckets
CONFIGS = [("adamw", False), ("adamw", True), ("sgd", False), ("sgd", True)]
LM_WIDTHS = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32,
                 d_ff=128)


def _cid(cfg):
    return f"{cfg[0]}-{'zero' if cfg[1] else 'replicated'}"


def _data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, IN)).astype(np.float32)
    y = rng.integers(0, FEATURES[-1], size=(BATCH,)).astype(np.int32)
    return x, y


def _optax(kind):
    return (optax.adamw(LR, weight_decay=WD) if kind == "adamw"
            else optax.sgd(0.1, momentum=0.9))


def _torch_opt(kind, params):
    if kind == "adamw":
        return torch.optim.AdamW(params, lr=LR, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=WD)
    return torch.optim.SGD(params, lr=0.1, momentum=0.9)


# -- the JAX side --------------------------------------------------------

def _jax_mlp(world, kind, sharded, steps):
    """``(state, step_fn)`` of the JAX MLP after ``steps`` steps on a mesh
    of ``world`` CPU devices (the package's mesh stays installed)."""
    hvd_j.shutdown()
    hvd_j.init(devices=jax.devices()[:world])
    tx = hvd_j.DistributedOptimizer(_optax(kind), sharded_update=sharded,
                                    threshold_bytes=THRESHOLD)
    model = JMLP(features=FEATURES)
    x, y = _data()
    state = training.create_train_state(model, tx, jax.random.PRNGKey(0),
                                        jnp.asarray(x[:1]))
    step = training.make_train_step(model, tx, mesh=hvd_j.mesh(),
                                    donate=False)
    for _ in range(steps):
        state, _ = step(state, jnp.asarray(x), jnp.asarray(y))
    return state, step


def _jax_save_world(root, step, tree, world):
    """Every rank's shard of a JAX state, then the commit."""
    zi = None
    for r in range(world):
        payload, zi = jckpt.snapshot_tree(tree, r, world)
        jsharded.write_shard(root, step, payload)
    return jmanifest.commit(root, step, 0, world, zero_info=zi)


def _jax_restore(root, world, kind, sharded):
    """The JAX package's own restore of ``root`` into a state of
    ``world`` (the oracle of every restore check)."""
    target, _ = _jax_mlp(world, kind, sharded, 0)
    return jckpt.restore_sharded(root, target)[1]


def _jax_flat(state):
    """``[(keystr, leaf)]`` of a JAX state, a ZeroState as one leaf."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        state, is_leaf=jsharded._is_zero_state)
    return [(jax.tree_util.keystr(p), leaf) for p, leaf in flat]


# -- the port side -------------------------------------------------------

def _port_mlp(kind, sharded, params0=None):
    """``(model, optimizer, step)`` of the port's MLP (init() must have
    run), its parameters ``params0`` (flax) when given."""
    model = MLP(IN, FEATURES)
    if params0 is not None:
        model.load_state_dict(convert.params_from_flax(params0, model))
    opt = hvd_t.DistributedOptimizer(
        _torch_opt(kind, model.parameters()),
        named_parameters=convert.flax_named_parameters(model),
        sharded_update=sharded, threshold_bytes=THRESHOLD)
    return model, opt, t_training.make_train_step(model, opt)


def _host(leaves):
    """Host numpy copies of a flat state (ZeroLeaf values too)."""
    out = []
    for leaf in leaves:
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


def _port_flat(model, opt, step_fn):
    return _host(convert.train_state_to_flat(model, opt, step_fn.state))


def _listed(flat):
    """A host flat state as json's lists (rows keyed by str)."""
    def one(x):
        if isinstance(x, dict):
            return {str(k): one(v) for k, v in x.items()}
        return [str(x.dtype), np.asarray(x).tolist()]
    return [one(leaf) for leaf in flat]


def _unlisted(flat):
    def one(x):
        if isinstance(x, dict) and x and not isinstance(
                next(iter(x.values())), list):
            return {(int(k) if k.isdigit() else k): one(v)
                    for k, v in x.items()}
        if isinstance(x, dict):
            return {(int(k) if k.isdigit() else k): one(v)
                    for k, v in x.items()}
        return np.asarray(x[1], dtype=np.dtype(x[0]))
    return [one(leaf) for leaf in flat]


def _assert_state_equal(jstate, port_flats, used=None):
    """A JAX state equals the port's flat state(s) bit for bit: the
    replicated leaves of any rank, and ZeRO-1 rows over the used
    elements of each bucket (``port_flats``: one per port rank, each
    holding its own row), the JAX rows' padding zeros."""
    jflat = _jax_flat(jstate)
    assert len(jflat) == len(port_flats[0])
    for i, (key, leaf) in enumerate(jflat):
        if not jsharded._is_zero_state(leaf):
            for flat in port_flats:
                np.testing.assert_array_equal(
                    np.asarray(flat[i]), np.asarray(leaf), err_msg=key)
                assert np.asarray(flat[i]).dtype == np.asarray(leaf).dtype
            continue
        sched = leaf.plan.schedule
        for ikey, bucket, value in jsharded._inner_entries(leaf):
            got = [flat[i][ikey] for flat in port_flats]
            if bucket is None:
                for g in got:
                    np.testing.assert_array_equal(g, np.asarray(value),
                                                  err_msg=ikey)
                continue
            n = int(sum(sched.buckets[bucket].sizes))
            rows = {}
            for g in got:
                rows.update(g)
            port = np.concatenate([rows[r] for r in sorted(rows)])
            want = np.asarray(value).reshape(-1)
            np.testing.assert_array_equal(port[:n], want[:n], err_msg=ikey)
            np.testing.assert_array_equal(want[n:], 0.0)


@pytest.fixture()
def worlds():
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    yield
    hvd_t.shutdown()
    hvd_j.shutdown()


# -- one state, both packages ---------------------------------------------

@pytest.mark.parametrize("cfg", CONFIGS, ids=_cid)
def test_jax_checkpoint_restores_in_the_port_and_steps_alike(worlds,
                                                             tmp_path, cfg):
    """JAX saves after 2 steps; the port restores it bit for bit (paths
    string for string) and re-saves it byte for byte; then one more step
    on each side agrees."""
    kind, sharded = cfg
    jstate, jstep = _jax_mlp(1, kind, sharded, 2)
    root = str(tmp_path / "jax")
    _jax_save_world(root, 7, jstate, 1)

    model, opt, step = _port_mlp(kind, sharded)
    assert convert.train_state_paths(model, opt) == [
        k for k, _ in _jax_flat(jstate)]
    target = convert.train_state_to_flat(model, opt, step.state)
    got_step, restored, meta = ckpt.restore_sharded(root, target)
    assert got_step == 7 and meta == {}
    convert.train_state_from_flat(model, opt, step.state, restored)
    assert step.state.step == 2
    _assert_state_equal(jstate, [_port_flat(model, opt, step)])

    again = str(tmp_path / "port")
    ckpt.save_sharded(again, 7, convert.train_state_to_flat(
        model, opt, step.state))
    for name in (tmanifest.shard_name(0, 1), tmanifest.ok_name(0, 1)):
        with open(os.path.join(jmanifest.step_dir(root, 7), name),
                  "rb") as a, open(os.path.join(
                      tmanifest.step_dir(again, 7), name), "rb") as b:
            assert a.read() == b.read(), name

    x, y = _data()
    jstate, j_loss = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
    loss = step(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    got = convert.flax_from_params(model.state_dict(), model)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(b, np.asarray(a), atol=1e-6),
        jstate.params, got)
    assert step.state.step == int(jstate.step) == 3


@pytest.mark.parametrize("cfg", CONFIGS, ids=_cid)
def test_port_checkpoint_restores_in_jax(worlds, tmp_path, cfg):
    """The port trains 2 steps from JAX's initial parameters and saves;
    the JAX package's ``restore_sharded`` reads it bit for bit."""
    kind, sharded = cfg
    jstate0, _ = _jax_mlp(1, kind, sharded, 0)
    params0 = jax.tree_util.tree_map(np.asarray, jstate0.params)
    model, opt, step = _port_mlp(kind, sharded, params0)
    x, y = _data()
    for _ in range(2):
        step(torch.from_numpy(x), torch.from_numpy(y))
    root = str(tmp_path)
    man = ckpt.save_sharded(root, 2, convert.train_state_to_flat(
        model, opt, step.state), meta={"epoch": 1})
    assert man["world"] == 1 and bool(man["zero"]) == sharded
    jrestored = _jax_restore(root, 1, kind, sharded)
    _assert_state_equal(jrestored, [_port_flat(model, opt, step)])
    assert int(jrestored.step) == 2


def _lm_states(sharded):
    jcfg = JConfig(**LM_WIDTHS, dtype=jnp.float32, flash_attention=False)
    tokens = np.random.default_rng(1).integers(
        0, LM_WIDTHS["vocab_size"], size=(2, 16)).astype(np.int32)
    hvd_j.shutdown()
    hvd_j.init(devices=jax.devices()[:1])
    tx = hvd_j.DistributedOptimizer(optax.adamw(LR, weight_decay=WD),
                                    sharded_update=sharded)
    jstate = training.create_train_state(JTransformer(jcfg), tx,
                                         jax.random.PRNGKey(0),
                                         jnp.asarray(tokens[:1]))
    jstep = training.make_lm_train_step(JTransformer(jcfg), tx,
                                        mesh=hvd_j.mesh(), donate=False)
    for _ in range(2):
        jstate, _ = jstep(jstate, jnp.asarray(tokens))
    tcfg = TransformerConfig(**LM_WIDTHS, dtype=torch.float32,
                             flash_attention=True)
    model = Transformer(tcfg)
    opt = hvd_t.DistributedOptimizer(
        _torch_opt("adamw", model.parameters()),
        named_parameters=convert.flax_named_parameters(model),
        sharded_update=sharded)
    return jstate, model, opt, t_training.make_lm_train_step(model, opt)


@pytest.mark.parametrize("sharded", [False, True],
                         ids=["replicated", "zero"])
def test_lm_attention_layouts_round_trip(worlds, tmp_path, sharded):
    """The LM's ``heads_in``/``heads_out`` kernels (and their AdamW
    moments, in ZeRO-1's rows) restore bit for bit in flax's shapes."""
    jstate, model, opt, step = _lm_states(sharded)
    root = str(tmp_path)
    _jax_save_world(root, 2, jstate, 1)
    assert convert.train_state_paths(model, opt) == [
        k for k, _ in _jax_flat(jstate)]
    target = convert.train_state_to_flat(model, opt, step.state)
    _, restored, _ = ckpt.restore_sharded(root, target)
    convert.train_state_from_flat(model, opt, step.state, restored)
    _assert_state_equal(jstate, [_port_flat(model, opt, step)])
    want = jstate.params["block_0"]["attn"]["out"]["kernel"]
    np.testing.assert_array_equal(
        convert.flax_from_params(model.state_dict(), model)[
            "block_0"]["attn"]["out"]["kernel"], np.asarray(want))


def test_batchnorm_state_round_trip(worlds, tmp_path):
    """A ResNet's ``batch_stats`` (after 2 JAX steps that moved them) ride
    the checkpoint: JAX -> port -> JAX, bit for bit."""
    hvd_j.shutdown()
    hvd_j.init(devices=jax.devices()[:1])
    jmodel = jresnet.ResNet(stage_sizes=(1, 1, 1, 1),
                            block_cls=jresnet.BottleneckBlock, num_filters=8,
                            num_classes=10, dtype=jnp.float32)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(4,)).astype(np.int32)
    tx = hvd_j.DistributedOptimizer(_optax("sgd"))
    jstate = training.create_train_state(jmodel, tx, jax.random.PRNGKey(0),
                                         jnp.asarray(x[:1]))
    jstep = training.make_train_step(jmodel, tx, mesh=hvd_j.mesh(),
                                     donate=False)
    for _ in range(2):
        jstate, _ = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
    root = str(tmp_path / "jax")
    _jax_save_world(root, 2, jstate, 1)
    model = resnet.ResNet((1, 1, 1, 1), resnet.BottleneckBlock,
                          num_filters=8, num_classes=10, dtype=torch.float32)
    opt = hvd_t.DistributedOptimizer(
        _torch_opt("sgd", model.parameters()),
        named_parameters=convert.flax_named_parameters(model))
    state = t_training.StepState()
    assert convert.train_state_paths(model, opt) == [
        k for k, _ in _jax_flat(jstate)]
    _, restored, _ = ckpt.restore_sharded(
        root, convert.train_state_to_flat(model, opt, state))
    convert.train_state_from_flat(model, opt, state, restored)
    flat = _host(convert.train_state_to_flat(model, opt, state))
    _assert_state_equal(jstate, [flat])
    back = str(tmp_path / "port")
    ckpt.save_sharded(back, 2, convert.train_state_to_flat(model, opt,
                                                           state))
    _, jback, _ = jckpt.restore_sharded(back, jstate)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                   np.asarray(b)),
        jback, jstate)


# -- reshard, in this process: 2 -> 1 JAX to port, 1 -> 2 port to JAX -----

@pytest.mark.parametrize("cfg", CONFIGS, ids=_cid)
def test_reshard_across_packages_in_process(worlds, tmp_path, cfg):
    kind, sharded = cfg
    # JAX at world 2 -> the port at world 1
    jstate, _ = _jax_mlp(2, kind, sharded, 2)
    root = str(tmp_path / "jax2")
    _jax_save_world(root, 2, jstate, 2)
    oracle = _jax_restore(root, 1, kind, sharded)
    model, opt, step = _port_mlp(kind, sharded)
    _, restored, _ = ckpt.restore_sharded(
        root, convert.train_state_to_flat(model, opt, step.state))
    convert.train_state_from_flat(model, opt, step.state, restored)
    _assert_state_equal(oracle, [_port_flat(model, opt, step)])
    # the port at world 1 -> JAX at world 2
    back = str(tmp_path / "port1")
    ckpt.save_sharded(back, 2, convert.train_state_to_flat(model, opt,
                                                           step.state))
    _assert_state_equal(_jax_restore(back, 2, kind, sharded),
                        [_port_flat(model, opt, step)])


# -- world 2: one spawn ---------------------------------------------------

_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    sys.path.insert(0, {tests!r})
    import horovod_tpu_torch as hvd
    import test_torch_ckpt as t
    from horovod_tpu_torch import ckpt, convert
    hvd.init(device="cpu")
    work = json.loads(open(sys.argv[1]).read())
    x, y = t._data()
    out = {{}}
    for cfg in t.CONFIGS:
        cid = t._cid(cfg)
        # a JAX world-1 checkpoint restored at world 2, one more step
        model, opt, step = t._port_mlp(*cfg)
        target = convert.train_state_to_flat(model, opt, step.state)
        _, restored, _ = ckpt.restore_sharded(work[cid]["jax1"], target)
        convert.train_state_from_flat(model, opt, step.state, restored)
        flat = t._port_flat(model, opt, step)
        n = t.BATCH // 2
        r = hvd.rank()
        loss = step(torch.from_numpy(x[r * n:(r + 1) * n]),
                    torch.from_numpy(y[r * n:(r + 1) * n]))
        out[cid] = dict(
            restored=t._listed(flat), loss=float(loss),
            params={{k: {{m: v.tolist() for m, v in d.items()}} for k, d in
                     convert.flax_from_params(model.state_dict(),
                                              model).items()}})
        # the port at world 2 trains from JAX's start and saves
        params0 = np.load(work[cid]["params0"], allow_pickle=True)
        model, opt, step = t._port_mlp(*cfg, params0["p"].item())
        for _ in range(2):
            step(torch.from_numpy(x[r * n:(r + 1) * n]),
                 torch.from_numpy(y[r * n:(r + 1) * n]))
        ckpt.save_sharded(work[cid]["port2"], 2,
                          convert.train_state_to_flat(model, opt,
                                                      step.state),
                          rank=r, world=2)
        out[cid]["saved"] = t._listed(t._port_flat(model, opt, step))
    print("RESULT", json.dumps([r, out]), flush=True)
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


def test_world_two_reshards_both_ways(tmp_path):
    """On 2 gloo ranks, for every config: a JAX world-1 checkpoint
    restores (1 -> 2) bit for bit against the JAX package's own
    world-2 restore, and one more step agrees with JAX's world-2 step
    from that restore; the port's world-2 checkpoint restores (2 -> 1)
    in JAX bit for bit against the ranks' own state."""
    work, oracles = {}, {}
    x, y = _data()
    for cfg in CONFIGS:
        cid = _cid(cfg)
        jstate, _ = _jax_mlp(1, *cfg, steps=2)
        jax1 = str(tmp_path / cid / "jax1")
        _jax_save_world(jax1, 2, jstate, 1)
        target, jstep2 = _jax_mlp(2, *cfg, steps=0)
        restored = jckpt.restore_sharded(jax1, target)[1]
        stepped, j_loss = jstep2(restored, jnp.asarray(x), jnp.asarray(y))
        oracles[cid] = (restored, float(j_loss), jax.tree_util.tree_map(
            np.asarray, stepped.params))
        p0 = tmp_path / cid / "params0.npz"
        np.savez(p0, p=np.array(jax.tree_util.tree_map(
            np.asarray, target.params), dtype=object))
        work[cid] = dict(jax1=jax1, params0=str(p0),
                         port2=str(tmp_path / cid / "port2"))
    hvd_j.shutdown()
    path = tmp_path / "work.json"
    path.write_text(json.dumps(work))
    ranks = _run_ranks(_WORKER.format(tests=os.path.join(REPO, "tests")),
                       2, [str(path)])
    try:
        for cfg in CONFIGS:
            cid = _cid(cfg)
            restored, j_loss, j_params = oracles[cid]
            got = [_unlisted(rk[cid]["restored"]) for rk in ranks]
            _assert_state_equal(restored, got)
            for rk in ranks:
                np.testing.assert_allclose(rk[cid]["loss"], j_loss,
                                           rtol=1e-5)
                jax.tree_util.tree_map(
                    lambda a, b: np.testing.assert_allclose(
                        np.asarray(b, np.float32), a, atol=1e-6),
                    j_params, rk[cid]["params"])
            saved = [_unlisted(rk[cid]["saved"]) for rk in ranks]
            _assert_state_equal(_jax_restore(work[cid]["port2"], 1, *cfg),
                                saved)
    finally:
        hvd_j.shutdown()


# -- bytes, snapshots ------------------------------------------------------

@pytest.mark.parametrize("share", [(0, 1), (0, 2), (1, 2)],
                         ids=["rank0of1", "rank0of2", "rank1of2"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=_cid)
def test_shard_bytes_equal_flax(worlds, monkeypatch, share, cfg):
    """The port's shard bytes of a trained state, this rank's share of a
    world of 1 or 2, equal flax's ``msgpack_serialize`` of the same
    payload, and read back equal; also with an array above the chunk
    size (made small here on both sides)."""
    model, opt, step = _port_mlp(*cfg)
    x, y = _data()
    step(torch.from_numpy(x), torch.from_numpy(y))
    payload, _ = tsharded.snapshot_payload(
        convert.train_state_to_flat(model, opt, step.state), *share)
    data = _msgpack.serialize(payload)
    assert data == serialization.msgpack_serialize(payload)
    back = _msgpack.restore(data)
    ref = serialization.msgpack_restore(data)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, ref)
    monkeypatch.setattr(_msgpack, "MAX_CHUNK_SIZE", 16)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 16)
    data = _msgpack.serialize(payload)
    assert data == serialization.msgpack_serialize(payload)
    assert b"__msgpack_chunked_array__" in data
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           _msgpack.restore(data),
                           serialization.msgpack_restore(data))


def test_codec_reads_every_width():
    """Ints, strings, bytes and maps at every msgpack width, 0-d arrays
    and numpy scalars: the bytes equal flax's and read back."""
    tree = {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32,
                     -33, -128, -129, -32768, -32769, -2 ** 31 - 1],
            "s": ["", "a" * 31, "b" * 32, "c" * 256, "d" * 70000],
            "b": [b"", b"x" * 300, b"y" * 70000], "f": 0.25, "t": True,
            "n": None, "m": {str(i): i for i in range(20)},
            "l": list(range(20)), "a0": np.asarray(3, np.int32),
            "sc": np.float64(1.5), "e": np.zeros((0, 3), np.float32),
            "u8": np.arange(5, dtype=np.uint8), "bool": np.ones(3, bool)}
    want = serialization.msgpack_serialize(tree)
    assert _msgpack.serialize(tree) == want
    back = _msgpack.restore(want)
    assert back["ints"] == tree["ints"] and back["s"] == tree["s"]
    assert isinstance(back["sc"], np.float64)
    assert back["a0"].shape == () and back["e"].shape == (0, 3)
    with pytest.raises(TypeError):
        _msgpack.serialize({"tuple": (1, 2)})


@pytest.mark.parametrize("sharded", [False, True],
                         ids=["replicated", "zero"])
def test_async_save_is_a_snapshot(worlds, tmp_path, sharded):
    """``save()`` returns once its copy is final: a step taken at once,
    while the background write may still run, does not reach the
    checkpoint; the restore equals the state at ``save()``."""
    model, opt, step = _port_mlp("adamw", sharded)
    x, y = _data()
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    step(xs, ys)
    at_save = _port_flat(model, opt, step)
    saver = ckpt.AsyncCheckpointer(str(tmp_path), max_inflight=2)
    blocked = saver.save(1, convert.train_state_to_flat(model, opt,
                                                        step.state))
    for _ in range(3):
        step(xs, ys)  # in place, right after the snapshot
    saver.flush()
    saver.close()
    assert blocked >= 0 and saver.last_bytes > 0
    assert saver.last_save_s >= blocked
    model2, opt2, step2 = _port_mlp("adamw", sharded)
    _, restored, _ = ckpt.restore_sharded(
        str(tmp_path), convert.train_state_to_flat(model2, opt2,
                                                   step2.state))
    convert.train_state_from_flat(model2, opt2, step2.state, restored)
    _assert_port_flat_equal(_port_flat(model2, opt2, step2), at_save)
    assert step2.state.step == 1
    now = _port_flat(model, opt, step)
    assert not np.array_equal(now[0], at_save[0])


def _assert_port_flat_equal(got, want):
    for a, b in zip(got, want, strict=True):
        if isinstance(a, dict):
            for k in a:
                av, bv = a[k], b[k]
                if isinstance(av, dict):
                    for r in av:
                        np.testing.assert_array_equal(av[r], bv[r])
                else:
                    np.testing.assert_array_equal(av, bv)
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("inflight", [1, 2])
def test_async_saves_reuse_their_buffers(worlds, tmp_path, monkeypatch,
                                         inflight):
    """Saves copy into host buffers that earlier saves made: at most one
    set for each save in flight over five saves. Each checkpoint still
    holds the state at its own ``save()``: a buffer is not written again
    while a save that reads it is in flight."""
    model, opt, step = _port_mlp("adamw", True)
    x, y = _data()
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=6,
                                   max_inflight=inflight)
    buffers, per_save = {}, []  # every buffer a save copied into, by id
    to_host = tsharded._to_host

    def spy(leaves, staging=None):
        out = to_host(leaves, staging)
        used = [slot[1] for slot in staging.buffers if slot is not None]
        buffers.update((id(t), t) for t in used)
        per_save.append(len(used))
        return out

    monkeypatch.setattr(tsharded, "_to_host", spy)
    states = {}
    for s in range(1, 6):
        step(xs, ys)
        states[s] = _port_flat(model, opt, step)
        saver.save(s, convert.train_state_to_flat(model, opt, step.state))
    saver.close()
    assert len(per_save) == 5 and len(set(per_save)) == 1
    assert per_save[0] <= len(buffers) <= inflight * per_save[0]
    for s, want in states.items():
        model2, opt2, step2 = _port_mlp("adamw", True)
        got_step, restored, _ = ckpt.restore_sharded(
            str(tmp_path), convert.train_state_to_flat(model2, opt2,
                                                       step2.state), step=s)
        assert got_step == s
        convert.train_state_from_flat(model2, opt2, step2.state, restored)
        _assert_port_flat_equal(_port_flat(model2, opt2, step2), want)


def test_async_budget_and_failures(tmp_path):
    tree = {"w": np.arange(8, dtype=np.float32)}
    saver = ckpt.AsyncCheckpointer(str(tmp_path), max_inflight=1, rank=0,
                                   world=1)
    for s in (1, 2, 3):
        saver.save(s, tree)
    assert saver.flush()["step"] == 3
    saver.close()
    with pytest.raises(RuntimeError, match="closed"):
        saver.save(4, tree)
    with pytest.raises(ValueError, match="max_inflight"):
        ckpt.AsyncCheckpointer(str(tmp_path), max_inflight=0)
    bad = ckpt.AsyncCheckpointer(str(tmp_path / "f"), rank=0, world=1)
    (tmp_path / "f").write_text("a file where the directory goes")
    bad.save(1, tree)
    with pytest.raises(RuntimeError, match="background checkpoint save"):
        bad.flush()
    bad.close()


# -- the two-phase commit, mirrored from tests/test_ckpt.py ----------------

def _save_world(root, step, tree, world, meta=None):
    zi = None
    for r in range(world):
        payload, zi = ckpt.snapshot_tree(tree, r, world)
        tsharded.write_shard(root, step, payload)
    return tmanifest.commit(root, step, 0, world, meta=meta, zero_info=zi)


def test_torn_write_recovery(tmp_path):
    root = str(tmp_path)
    tree = {"w": np.arange(8, dtype=np.float32)}
    _save_world(root, 1, tree, 2, meta={"commit": 1})
    payload, _ = ckpt.snapshot_tree({"w": tree["w"] * 2}, 0, 2)
    tsharded.write_shard(root, 2, payload)
    assert not tmanifest.is_complete(root, 2)
    assert ckpt.latest_complete_step(root) == 1
    step, restored, meta = ckpt.restore_sharded(
        root, {"w": np.zeros(8, np.float32)})
    assert step == 1 and meta == {"commit": 1}
    np.testing.assert_array_equal(restored["w"], tree["w"])
    with pytest.raises(FileNotFoundError, match="incomplete/torn"):
        ckpt.restore_sharded(root, {"w": np.zeros(8, np.float32)}, step=2)
    # the JAX package reads the same directory the same way
    assert jckpt.restore_sharded(root, {"w": np.zeros(8, np.float32)})[0] \
        == 1
    assert ckpt.retention_gc(root, keep=5) == []
    assert os.path.isdir(tmanifest.step_dir(root, 2))
    _save_world(root, 3, tree, 2)
    assert 2 in ckpt.retention_gc(root, keep=5)
    assert not os.path.isdir(tmanifest.step_dir(root, 2))


def test_crc_detects_corrupt_shard_and_falls_back(tmp_path):
    root = str(tmp_path)
    _save_world(root, 1, {"w": np.arange(64, dtype=np.float32)}, 2)
    _save_world(root, 2, {"w": np.arange(64, dtype=np.float32) * 2}, 2)
    path = ckpt.shard_path(root, 2, 1, 2)
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(path, "wb").write(bytes(data))
    with pytest.raises(ckpt.ShardValidationError, match="CRC32"):
        ckpt.restore_sharded(root, {"w": np.zeros(64, np.float32)}, step=2)
    step, restored, _ = ckpt.restore_sharded(
        root, {"w": np.zeros(64, np.float32)})
    assert step == 1
    np.testing.assert_array_equal(restored["w"], np.arange(64))
    ok = json.load(open(os.path.join(tmanifest.step_dir(root, 1),
                                     tmanifest.ok_name(0, 2))))
    data = open(ckpt.shard_path(root, 1, 0, 2), "rb").read()
    assert ok["crc32"] == zlib.crc32(data) & 0xFFFFFFFF
    assert ok["bytes"] == len(data)


def test_retention_and_stale_acks(tmp_path):
    root = str(tmp_path)
    tree = {"w": np.ones(4, np.float32)}
    for s in (1, 2, 3, 4):
        _save_world(root, s, tree, 1)
    ckpt.retention_gc(root, keep=2)
    assert ckpt.list_complete_steps(root) == [3, 4]
    # re-entering a complete step tears its manifest down first
    tmanifest.clear_stale_ack(root, 4, 0, 1)
    assert not ckpt.is_complete(root, 4)
    assert ckpt.latest_complete_step(root) == 3
    with pytest.raises(ValueError, match="state tree"):
        ckpt.restore_sharded(root, {"v": np.ones(4, np.float32),
                                    "w": np.ones(4, np.float32)}, step=3)


def test_reshard_rejects_another_bucket_layout(worlds, tmp_path):
    """A ZeRO-1 checkpoint restores only into the same bucket partition:
    another fusion threshold fails loudly, not with re-sliced rows."""
    model, opt, step = _port_mlp("adamw", True)
    ckpt.save_sharded(str(tmp_path), 1, convert.train_state_to_flat(
        model, opt, step.state))
    model2 = MLP(IN, FEATURES)
    opt2 = hvd_t.DistributedOptimizer(
        _torch_opt("adamw", model2.parameters()),
        named_parameters=convert.flax_named_parameters(model2),
        sharded_update=True, threshold_bytes=1 << 20)
    with pytest.raises(ValueError, match="bucket layout"):
        ckpt.restore_sharded(str(tmp_path), convert.train_state_to_flat(
            model2, opt2, t_training.StepState()))
