"""The port's single-file checkpoints (horovod_tpu_torch/checkpoint.py)
against the JAX package's (horovod_tpu/checkpoint.py): the same
``ckpt-<step>.msgpack``, flax's ``to_bytes`` of ``{"step", "params",
"opt_state", "meta"}``.

A JAX ``TrainState``'s params and opt_state (``DistributedOptimizer``
over ``optax.adamw`` or ``optax.sgd(momentum)``, replicated or ZeRO-1 at
world 1) written by JAX restore in the port bit for bit, and one more
step then agrees on both sides (loss rtol 1e-5, params atol 1e-6:
summation order); a file the port wrote restores in JAX bit for bit.
``restore_or_init`` finds the newest step and, at world 2 (two spawned
gloo ranks), broadcasts rank 0's restore.
"""

import dataclasses
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
from flax import serialization

import horovod_tpu as hvd_j
import horovod_tpu_torch as hvd_t
from horovod_tpu import checkpoint as jcheckpoint
from horovod_tpu_torch import checkpoint, convert

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_ckpt as tc  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _trees_equal(want, got, where=""):
    """Nested dicts of arrays equal, bit for bit and dtype for dtype."""
    if isinstance(want, dict):
        assert set(want) == set(got), where
        for k in want:
            _trees_equal(want[k], got[k], f"{where}/{k}")
        return
    a, b = np.asarray(want), np.asarray(got)
    np.testing.assert_array_equal(b, a, err_msg=where)
    assert a.dtype == b.dtype, where


def _port_trees(model, opt):
    trees = convert.train_state_trees(model, opt)
    return jax.tree_util.tree_map(
        lambda x: np.array(x.detach().numpy()) if torch.is_tensor(x)
        else np.array(x), trees)


@pytest.fixture()
def worlds():
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    yield
    hvd_t.shutdown()
    hvd_j.shutdown()


@pytest.mark.parametrize("cfg", tc.CONFIGS, ids=tc._cid)
def test_jax_file_restores_in_the_port_and_steps_alike(worlds, tmp_path,
                                                       cfg):
    kind, sharded = cfg
    jstate, jstep = tc._jax_mlp(1, kind, sharded, 2)
    d = str(tmp_path)
    jcheckpoint.write_checkpoint(d, 2, jstate.params, jstate.opt_state,
                                 meta={"epoch": 3})
    model, opt, step = tc._port_mlp(kind, sharded)
    assert checkpoint.list_steps(d) == [2]
    assert checkpoint.resume_step(d) == 2
    meta = checkpoint.restore_checkpoint(d, 2, model, opt)
    assert meta == {"epoch": 3}
    params, opt_state = _port_trees(model, opt)
    _trees_equal(serialization.to_state_dict(jstate.params), params)
    _trees_equal(serialization.to_state_dict(jstate.opt_state), opt_state)

    x, y = tc._data()
    jstate, j_loss = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
    loss = step(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    got = convert.flax_from_params(model.state_dict(), model)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(b, np.asarray(a), atol=1e-6),
        jstate.params, got)


@pytest.mark.parametrize("cfg", tc.CONFIGS, ids=tc._cid)
def test_port_file_restores_in_jax(worlds, tmp_path, cfg):
    kind, sharded = cfg
    jstate0, _ = tc._jax_mlp(1, kind, sharded, 0)
    model, opt, step = tc._port_mlp(kind, sharded, jax.tree_util.tree_map(
        np.asarray, jstate0.params))
    x, y = tc._data()
    for _ in range(2):
        step(torch.from_numpy(x), torch.from_numpy(y))
    d = str(tmp_path)
    path = checkpoint.save_checkpoint(d, 2, model, opt, meta={"lr": 0.1})
    assert path.endswith("ckpt-2.msgpack")
    params, opt_state, meta = jcheckpoint.restore_checkpoint(
        d, 2, jstate0.params, jstate0.opt_state)
    assert meta == {"lr": 0.1}
    want_p, want_o = _port_trees(model, opt)
    _trees_equal(want_p, serialization.to_state_dict(params))
    _trees_equal(want_o, serialization.to_state_dict(opt_state))


def test_params_only_and_retention(worlds, tmp_path):
    d = str(tmp_path)
    model, _, _ = tc._port_mlp("sgd", False)
    for s in (1, 2, 3):
        checkpoint.write_checkpoint(d, s, model, keep=2)
    open(os.path.join(d, "ckpt-1.msgpack.tmp"), "wb").write(b"junk")
    open(os.path.join(d, "ckpt-9.msgpack.tmp"), "wb").write(b"junk")
    checkpoint.write_checkpoint(d, 4, model, keep=2)
    assert checkpoint.list_steps(d) == [3, 4]
    assert not os.path.exists(os.path.join(d, "ckpt-1.msgpack.tmp"))
    assert os.path.exists(os.path.join(d, "ckpt-9.msgpack.tmp"))
    params, opt_state, _ = jcheckpoint.restore_checkpoint(
        d, 4, tc._jax_mlp(1, "sgd", False, 0)[0].params)
    assert opt_state == {}
    _trees_equal(_port_trees(model, None)[0],
                 serialization.to_state_dict(params))
    fresh, _, _ = tc._port_mlp("sgd", False)
    assert checkpoint.restore_or_init(d, fresh) == (4, {})
    for a, b in zip(fresh.parameters(), model.parameters()):
        assert torch.equal(a, b)
    empty = str(tmp_path / "none")
    assert checkpoint.restore_or_init(empty, fresh) == (0, {})


def test_zero_file_needs_one_process_for_every_row(worlds):
    """One file holds ZeRO-1's whole ``[world, shard]`` rows, which only
    a world of one has on one process: a plan of world 2 is refused."""
    model, opt, _ = tc._port_mlp("adamw", True)
    plan = opt.zero_state.plan
    opt.zero_state.plan = dataclasses.replace(
        plan, schedule=dataclasses.replace(plan.schedule, world=2))
    with pytest.raises(NotImplementedError, match="every row"):
        convert.train_state_trees(model, opt)


_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    sys.path.insert(0, {tests!r})
    import horovod_tpu_torch as hvd
    import test_torch_ckpt as tc
    from horovod_tpu_torch import checkpoint, convert
    hvd.init(device="cpu")
    torch.manual_seed(100 + hvd.rank())  # every rank starts elsewhere
    model, opt, step = tc._port_mlp("adamw", False)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape))
    got = checkpoint.restore_or_init(sys.argv[1], model, opt)
    params, opt_state = convert.train_state_trees(model, opt)
    flat = {{k: np.asarray(v.detach() if torch.is_tensor(v) else v).tolist()
             for k, v in [("kernel", params["Dense_0"]["kernel"]),
                          ("mu", opt_state["1"]["0"]["mu"]["Dense_2"]
                           ["kernel"]),
                          ("count", opt_state["1"]["0"]["count"])]}}
    print("RESULT", json.dumps([hvd.rank(), [got, flat]]), flush=True)
    hvd.shutdown()
""")


def test_restore_or_init_broadcasts_rank_zeros_restore(tmp_path):
    """At world 2 only rank 0 reads the newest file; every leaf of the
    parameters and the optimizer state reaches rank 1 from it."""
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    try:
        model, opt, step = tc._port_mlp("adamw", False)
        x, y = tc._data()
        for _ in range(3):
            step(torch.from_numpy(x), torch.from_numpy(y))
        d = str(tmp_path)
        checkpoint.save_checkpoint(d, 3, model, opt, meta={"k": 1})
        params, opt_state = _port_trees(model, opt)
    finally:
        hvd_t.shutdown()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(2):
        env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE="2",
                   HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=REPO)
        procs.append(subprocess.Popen(
            [sys.executable, "-c",
             _WORKER.format(tests=os.path.join(REPO, "tests")), d],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    results = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][0]
        results.append(json.loads(line.split(" ", 1)[1]))
    results = [r[1] for r in sorted(results, key=lambda r: r[0])]
    assert results[0][0] == [3, {"k": 1}] and results[1][0] == [3, {}]
    for _, flat in results:
        np.testing.assert_array_equal(
            np.asarray(flat["kernel"], np.float32),
            params["Dense_0"]["kernel"])
        np.testing.assert_array_equal(
            np.asarray(flat["mu"], np.float32),
            opt_state["1"]["0"]["mu"]["Dense_2"]["kernel"])
        assert flat["count"] == 3
