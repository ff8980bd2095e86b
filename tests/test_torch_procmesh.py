"""The port's process mesh (horovod_tpu_torch/cluster/procmesh.py) against
the JAX package's (horovod_tpu/cluster/procmesh.py), case for case with
tests/test_procmesh.py: the hvdrun env contract, the one join of the
world (a stub records ``init_process_group``), the rows' grid and its
ICI-first mesh, the contiguous row blocks the checkpoints and loaders
key on, and placement without a collective.

In the JAX package a row is a process of K devices; here a row is K
ranks (one rank drives one device), so the fake devices of the JAX
tests become each rank's row (``owners``), and a stub mesh carries its
rank grid. The hvdrun launch of ``--spmd-procs 2 --spmd-local-devices
2`` (4 gloo ranks on a (dcn 2, data 2) mesh, against the JAX oracle on
4 devices, and its sharded save restored in one process) is the one
spawn here.
"""

import json
import os
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest
import torch

import horovod_tpu_torch as hvd_t
from horovod_tpu.cluster import procmesh as jprocmesh
from horovod_tpu_torch.cluster import procmesh
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel.mesh import DATA_AXIS, DCN_AXIS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeDevice:
    def __init__(self, device_id, process_index):
        self.id = device_id
        self.process_index = process_index


def _fake_devices(procs, local):
    return [FakeDevice(p * local + i, p)
            for p in range(procs) for i in range(local)]


@pytest.fixture()
def cpu_world():
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    yield hvd_t
    hvd_t.shutdown()


# -- coordinator_spec: the hvdrun env contract -------------------------------

SPECS = [
    {},
    {"HOROVOD_COORDINATOR_ADDR": "127.0.0.1:7777", "HOROVOD_SPMD_PROCS": "1"},
    {"HOROVOD_COORDINATOR_ADDR": "127.0.0.1:7777", "HOROVOD_SPMD_PROCS": "4",
     "HOROVOD_RANK": "2"},
    {"HOROVOD_COORDINATOR_ADDR": "h0:1234", "HOROVOD_SIZE": "2",
     "HOROVOD_RANK": "1"},
]


@pytest.mark.parametrize("env", SPECS)
def test_coordinator_spec_is_jax(env):
    assert procmesh.coordinator_spec(env=dict(env)) == \
        jprocmesh.coordinator_spec(env=dict(env))


# -- ensure_distributed: the one init_process_group call site ---------------

@pytest.fixture()
def join_stub(monkeypatch):
    import torch.distributed as dist
    procmesh._reset_for_tests()
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    monkeypatch.setattr(procmesh, "_foreign_distributed", lambda: False)
    yield calls
    procmesh._reset_for_tests()


def test_single_process_joins_once(join_stub):
    stores = []
    store = lambda: stores.append(1) or "store"  # noqa: E731
    assert procmesh.ensure_distributed(env={}, store=store) is False
    assert procmesh.ensure_distributed(env={}, store=store) is False
    assert stores == [1]
    assert join_stub == [(("gloo",), {"store": "store", "rank": 0,
                                      "world_size": 1})]
    assert procmesh.is_multiprocess() is False


def test_joins_once_then_remembers(join_stub):
    env = {"HOROVOD_COORDINATOR_ADDR": "127.0.0.1:7777",
           "HOROVOD_SPMD_PROCS": "2", "HOROVOD_RANK": "0",
           "HOROVOD_SIZE": "4"}
    assert procmesh.ensure_distributed(env=env, backend="nccl") is True
    assert procmesh.ensure_distributed(env=env) is True
    assert join_stub == [(("nccl",), {"store": None, "rank": 0,
                                      "world_size": 4})]
    assert procmesh.is_multiprocess() is True
    procmesh.leave()
    assert procmesh.is_multiprocess() is False


def test_rejoining_a_different_coordinator_raises(join_stub):
    env = {"HOROVOD_COORDINATOR_ADDR": "127.0.0.1:7777",
           "HOROVOD_SPMD_PROCS": "2", "HOROVOD_RANK": "0"}
    procmesh.ensure_distributed(env=env)
    env["HOROVOD_COORDINATOR_ADDR"] = "127.0.0.1:8888"
    with pytest.raises(RuntimeError, match="cannot re-join"):
        procmesh.ensure_distributed(env=env)


def test_foreign_init_is_refused(join_stub, monkeypatch):
    monkeypatch.setattr(procmesh, "_foreign_distributed", lambda: True)
    with pytest.raises(RuntimeError, match="outside horovod_tpu_torch"):
        procmesh.ensure_distributed(env={})
    assert join_stub == []


def test_init_joins_through_procmesh(cpu_world):
    """``init()`` joins through ``ensure_distributed``; ``shutdown()``
    forgets the join, so a later ``init()`` joins again."""
    assert procmesh._dist["joined"]
    hvd_t.shutdown()
    assert not procmesh._dist["joined"]
    hvd_t.init(device="cpu")
    assert procmesh._dist["joined"]


# -- process_grid / build_process_mesh / tiers / contiguity ------------------

def _jax_grid_ids(procs, local, order=slice(None)):
    return [[d.id for d in row] for row in jprocmesh.process_grid(
        _fake_devices(procs, local)[order])]


def test_rows_are_rows_in_rank_order():
    owners = procmesh.row_owners(8, 2)
    assert owners == [0, 0, 0, 0, 1, 1, 1, 1]
    grid = procmesh.process_grid(owners)
    assert grid.tolist() == _jax_grid_ids(2, 4) == [[0, 1, 2, 3],
                                                    [4, 5, 6, 7]]


def test_rows_sort_by_row():
    # rank order within a row, the rows in row order, whatever the order
    # the ranks name them in (the JAX test's shuffled devices)
    assert procmesh.process_grid([1, 1, 0, 0]).tolist() == [[2, 3], [0, 1]]
    assert _jax_grid_ids(2, 2, slice(None, None, -1)) == [[0, 1], [2, 3]]


def test_ragged_rows_raise():
    with pytest.raises(ValueError, match="ragged"):
        procmesh.process_grid([0, 0, 1])
    with pytest.raises(ValueError, match="ragged"):
        jprocmesh.process_grid(_fake_devices(2, 2) + [FakeDevice(9, 1)])
    with pytest.raises(ValueError, match="ragged"):
        procmesh.row_owners(5, 2)
    # HOROVOD_SPMD_LOCAL_DEVICES must agree with the world
    with pytest.raises(ValueError, match="the world has 6"):
        procmesh.row_owners(6, 2, local=2)
    assert procmesh.row_owners(6, 2, local=3) == [0, 0, 0, 1, 1, 1]


def test_single_row_mesh_is_1d_data(cpu_world):
    mesh = procmesh.build_process_mesh()
    assert mesh.axis_names == (DATA_AXIS,) and mesh.shape == (1,)
    assert tmesh.get_mesh() is mesh
    assert procmesh.mesh_tiers(mesh)[0]["tier"] == "ici"


def test_rows_must_be_rank_major():
    with pytest.raises(ValueError, match="rank-major"):
        procmesh.build_process_mesh(owners=[1, 1, 0, 0])


def _stub(grid, names=(DCN_AXIS, DATA_AXIS)):
    grid = np.asarray(grid)
    return types.SimpleNamespace(grid=grid, shape=grid.shape,
                                 axis_names=names)


def _jax_stub(devices, names=(DCN_AXIS, DATA_AXIS)):
    return types.SimpleNamespace(devices=devices, axis_names=names)


def test_mesh_tiers_two_tier_is_jax():
    got = procmesh.mesh_tiers(_stub(procmesh.process_grid(
        procmesh.row_owners(8, 2))))
    want = jprocmesh.mesh_tiers(_jax_stub(jprocmesh.process_grid(
        _fake_devices(2, 4))))
    assert got == want
    assert [(t["axis"], t["size"], t["tier"]) for t in got] == \
        [(DCN_AXIS, 2, "dcn"), (DATA_AXIS, 4, "ici")]


@pytest.mark.parametrize("case", ["contiguous", "spanning", "out_of_order"])
def test_process_contiguity_is_jax(case):
    """The same grids, of ranks and of fake devices, pass or raise with
    the same message."""
    owners = procmesh.row_owners(4, 2)
    grid = procmesh.process_grid(owners)
    jgrid = jprocmesh.process_grid(_fake_devices(2, 2))
    if case == "spanning":
        grid, jgrid = grid.copy(), jgrid.copy()
        grid[0, 1], grid[1, 0] = grid[1, 0], grid[0, 1]
        jgrid[0, 1], jgrid[1, 0] = jgrid[1, 0], jgrid[0, 1]
    elif case == "out_of_order":
        grid, jgrid = grid[::-1], jgrid[::-1]
    errors = []
    for fn in (lambda: procmesh.assert_process_contiguous(
            _stub(grid), owners=owners),
            lambda: jprocmesh.assert_process_contiguous(_jax_stub(jgrid))):
        try:
            fn()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    assert errors[0] == errors[1]
    assert (errors[0] is None) == (case == "contiguous")


@pytest.mark.parametrize("rows,procs,row,want", [
    (16, 1, 0, (0, 16)), (16, 4, 2, (8, 12)), (10, 4, 0, None)])
def test_local_row_block_is_jax(monkeypatch, rows, procs, row, want):
    monkeypatch.setattr(jax, "process_count", lambda: procs)
    monkeypatch.setattr(jax, "process_index", lambda: row)
    if want is None:
        with pytest.raises(ValueError, match="not divisible"):
            procmesh.local_row_block(rows, procs=procs, row=row)
        with pytest.raises(ValueError, match="not divisible"):
            jprocmesh.local_row_block(rows)
        return
    assert procmesh.local_row_block(rows, procs=procs, row=row) == want
    assert jprocmesh.local_row_block(rows) == want


def test_local_row_block_reads_the_installed_mesh(cpu_world):
    assert procmesh.local_row_block(16) == (0, 16)


# -- placement: shard_from_global / place ------------------------------------

def test_shard_from_global_and_place(cpu_world):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from horovod_tpu_torch.parallel import gspmd
    plan = gspmd.derive_plan()
    dm = plan.device_mesh
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    g = procmesh.shard_from_global(x, dm, [Shard(0)])
    assert isinstance(g, DTensor) and tuple(g.shape) == x.shape
    np.testing.assert_array_equal(g.full_tensor().numpy(), x)
    assert procmesh.place(g, dm, [Shard(0)]) is g  # already placed
    r = procmesh.place(torch.tensor(3.5), dm, [Replicate()])
    assert procmesh.place(r, dm, [Replicate()]) is r
    assert float(r.to_local()) == 3.5
    b = procmesh.global_batch(torch.ones(8, 2), dm, [Shard(0)])
    assert tuple(b.shape) == (8, 2)
    with pytest.raises(ValueError, match="does not divide"):
        procmesh._local_slices((7, 2), types.SimpleNamespace(
            get_coordinate=lambda: [1], size=lambda d: 2), [Shard(0)])
    # rank 1 of 2 cuts the second half
    sl = procmesh._local_slices((8, 2), types.SimpleNamespace(
        get_coordinate=lambda: [1], size=lambda d: 2), [Shard(0)])
    assert sl == (slice(4, 8), slice(0, 2))


# -- hvdrun --spmd-procs 2 --spmd-local-devices 2 ----------------------------

GLOBAL_ROWS, N_FEATURES, N_CLASSES, STEPS = 8, 16, 3, 3

_LAUNCHED = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, {tests!r})
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import ckpt, convert, training
    from test_torch_procmesh import batch, build_port_state, flat_arrays
    hvd.init(device="cpu")
    mesh = hvd.mesh()
    model, opt, step = build_port_state({start!r})
    x, y = batch()
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y).long()))
              for _ in range({steps})]
    flat = convert.train_state_to_flat(model, opt, step.state)
    ckpt.save_sharded({out!r} + "/ckpt", {steps}, flat, rank=hvd.rank(),
                      world=hvd.size())
    if hvd.rank() == 0:
        np.savez({out!r} + "/reference.npz", **flat_arrays(flat))
    with open({out!r} + f"/rank{{hvd.rank()}}.json", "w") as f:
        json.dump(dict(losses=losses, names=list(mesh.axis_names),
                       shape=list(mesh.shape), coords=list(mesh.coords),
                       collectives=step.compiled_axis_collectives), f)
    hvd.shutdown()
""")


def batch():
    """``tests/multiproc_worker.py``'s global batch, the same on every
    rank."""
    rng = np.random.RandomState(0)
    x = rng.normal(size=(GLOBAL_ROWS, N_FEATURES)).astype(np.float32)
    y = rng.randint(0, N_CLASSES, size=(GLOBAL_ROWS,)).astype(np.int32)
    return x, y


def build_port_state(start):
    """``multiproc_worker.build_state_and_step``'s model and optimizer
    in the port, from the JAX initial parameters saved at ``start``:
    MLP (8, 3), SGD(0.05, momentum 0.9) through the GSPMD step."""
    from horovod_tpu_torch import convert, training
    from horovod_tpu_torch.models.simple import MLP
    model = MLP(N_FEATURES, (8, N_CLASSES))
    params = np.load(start, allow_pickle=True)["params"].item()
    model.load_state_dict(convert.params_from_flax(params, model))
    opt = hvd_t.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9),
        named_parameters=convert.flax_named_parameters(model))
    return model, opt, training.make_train_step(model, opt, spmd=True)


def flat_arrays(flat):
    """A flat training state (``convert.train_state_to_flat``, or what
    ``ckpt.restore_sharded`` returns for it) as ``{index: ndarray}``."""
    return {str(i): (leaf.detach().cpu().numpy() if torch.is_tensor(leaf)
                     else np.asarray(leaf)) for i, leaf in enumerate(flat)}


def _jax_oracle(steps):
    """The JAX single-process GSPMD trajectory on a 4-device mesh
    (``test_multiprocess._oracle_losses``) and its initial parameters."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import multiproc_worker as mpw
    mesh = jprocmesh.build_process_mesh(jax.devices()[:4])
    state, _ = mpw.build_state_and_step(mesh)
    params0 = jax.tree_util.tree_map(np.asarray, state.params)
    _, losses = mpw.train_steps(mesh, steps)
    return params0, losses


def test_hvdrun_spmd_procs_trains_on_one_process_mesh(tmp_path):
    """``hvdrun-torch --spmd-procs 2 --spmd-local-devices 2``: 4 gloo
    ranks on the (dcn 2, data 2) mesh train the MLP 3 GSPMD steps within
    rtol 1e-4 of the JAX oracle on 4 devices (the twin of
    ``tests/test_multiprocess.py:131``), the exchange rides the whole
    mesh, and the launch's sharded save restores in one process bit for
    bit (``:161``)."""
    params0, want = _jax_oracle(STEPS)
    start = tmp_path / "start.npz"
    np.savez(start, params=np.array(params0, dtype=object))
    script = tmp_path / "launched.py"
    script.write_text(_LAUNCHED.format(
        tests=os.path.join(REPO, "tests"), start=str(start),
        out=str(tmp_path), steps=STEPS))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    rv = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "--spmd-procs", "2",
         "--spmd-local-devices", "2", sys.executable, str(script)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=240)
    assert rv.returncode == 0, rv.stderr[-4000:]
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(4)]
    for r, got in enumerate(ranks):
        assert got["names"] == [DCN_AXIS, DATA_AXIS]
        assert got["shape"] == [2, 2] and got["coords"] == [r // 2, r % 2]
        np.testing.assert_allclose(got["losses"], want, rtol=1e-4)
        assert got["losses"][-1] < got["losses"][0]
        # plain DP: the buckets' all-reduce over the whole mesh, and the
        # loss's
        assert set(got["collectives"]) == {f"{DCN_AXIS}+{DATA_AXIS}"}
    # the sharded save, restored in one process, bit for bit
    from horovod_tpu_torch import ckpt, convert
    reference = dict(np.load(tmp_path / "reference.npz"))
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    try:
        model, opt, step = build_port_state(str(start))
        flat = convert.train_state_to_flat(model, opt, step.state)
        step_no, tree, _ = ckpt.restore_sharded(str(tmp_path / "ckpt"), flat)
        assert step_no == STEPS
        restored = flat_arrays(tree)
        assert sorted(restored) == sorted(reference)
        for key, value in reference.items():
            np.testing.assert_array_equal(restored[key], value,
                                          err_msg=key)
    finally:
        hvd_t.shutdown()

