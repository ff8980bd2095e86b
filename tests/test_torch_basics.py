"""Lifecycle, identity, env contract and collectives of the port
(horovod_tpu_torch/basics.py, config.py, ops/collective.py), and the
rule that the port imports neither JAX nor the JAX package."""

import ast
import pathlib
import re
import weakref

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu.config import Config as JConfig
from horovod_tpu_torch import config

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture()
def fresh():
    hvd.shutdown()
    yield hvd
    hvd.shutdown()


@pytest.mark.parametrize("fn", ["rank", "size", "local_rank", "local_size",
                                "cross_rank", "cross_size", "device"])
def test_api_raises_before_init(fresh, fn):
    assert not hvd.is_initialized()
    with pytest.raises(RuntimeError, match="not been initialized"):
        getattr(hvd, fn)()
    with pytest.raises(RuntimeError, match="not been initialized"):
        hvd.allreduce(torch.ones(2))


def test_shutdown_then_init_again(fresh):
    hvd.init(device="cpu")
    hvd.init(device="cpu")  # idempotent
    assert (hvd.rank(), hvd.size(), hvd.device()) == (0, 1,
                                                      torch.device("cpu"))
    assert torch.distributed.get_backend() == "gloo"
    hvd.shutdown()
    assert not hvd.is_initialized()
    hvd.init(device="cpu")
    assert hvd.allreduce(torch.tensor([3.0]), op=hvd.Sum).item() == 3.0


def test_init_without_cuda_raises_unless_cpu_is_asked(fresh, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hvd.init()
    assert not hvd.is_initialized()


def test_multi_process_init_needs_a_rendezvous(fresh, monkeypatch):
    monkeypatch.setenv("HOROVOD_SIZE", "2")
    for name in ("MASTER_ADDR", "MASTER_PORT", "HOROVOD_GLOO_RENDEZVOUS_ADDR",
                 "HOROVOD_GLOO_RENDEZVOUS_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="rendezvous"):
        hvd.init(device="cpu")


ENV = {"HOROVOD_RANK": "3", "HOROVOD_SIZE": "8", "HOROVOD_LOCAL_RANK": "1",
       "HOROVOD_LOCAL_SIZE": "4", "HOROVOD_CROSS_RANK": "1",
       "HOROVOD_CROSS_SIZE": "2", "HOROVOD_FUSION_THRESHOLD": "1048576",
       "HOROVOD_GLOO_RENDEZVOUS_ADDR": "10.0.0.1",
       "HOROVOD_GLOO_RENDEZVOUS_PORT": "2222"}


def test_env_contract_matches_jax_config(monkeypatch):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    mine, ref = config.Config.from_env(), JConfig.from_env()
    for field in ("rank", "size", "local_rank", "local_size", "cross_rank",
                  "cross_size", "fusion_threshold", "rendezvous_addr",
                  "rendezvous_port"):
        assert getattr(mine, field) == getattr(ref, field), field
    assert (mine.rank, mine.local_size, mine.fusion_threshold) == \
        (3, 4, 1 << 20)


def test_env_defaults(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    cfg = config.Config.from_env()
    assert (cfg.rank, cfg.size, cfg.local_rank, cfg.cross_size) == \
        (0, 1, 0, 1)
    assert cfg.fusion_threshold == config.DEFAULT_FUSION_THRESHOLD
    assert (cfg.rendezvous_addr, cfg.rendezvous_port) == ("127.0.0.1", 29500)


@pytest.mark.parametrize("op,want", [(hvd.Sum, 5.0), (hvd.Average, 5.0),
                                     (hvd.Min, 5.0), (hvd.Max, 5.0)])
def test_world_of_one_collectives(fresh, op, want):
    hvd.init(device="cpu")
    x = torch.tensor([5.0])
    assert hvd.allreduce(x, op=op).item() == want
    assert x.item() == 5.0  # out of place
    assert hvd.broadcast(x, root_rank=0).item() == 5.0
    assert torch.equal(hvd.allgather(torch.ones(2, 3)), torch.ones(2, 3))


def test_unsupported_ops_raise(fresh):
    """An unknown op and an integer Average raise; Adasum, ported, is the
    identity at world 1."""
    hvd.init(device="cpu")
    x = torch.tensor([0.5, -2.0, 3.0])
    assert torch.equal(hvd.allreduce(x, op=hvd.Adasum), x)
    with pytest.raises(ValueError, match="unknown reduction op"):
        hvd.allreduce(torch.ones(1), op="median")
    with pytest.raises(TypeError, match="floating"):
        hvd.allreduce(torch.ones(1, dtype=torch.int64), op=hvd.Average)


def _pending_holding(obj, calls):
    from horovod_tpu_torch.ops.collective import Pending

    def finish():
        calls.append(obj)
        return torch.ones(2)

    return Pending((), finish)


def test_waited_pending_runs_finish_once_and_lets_go():
    """``Pending.wait()`` runs ``finish`` once: a second wait returns the
    same output, so an Average is not divided twice. Then the Pending no
    longer holds what ``finish``'s closure held (in the collectives, the
    mesh and with it the process group)."""
    class Held:
        pass

    held, calls = Held(), []
    ref = weakref.ref(held)
    pending = _pending_holding(held, calls)
    del held
    out = pending.wait()
    assert pending.wait() is out
    assert len(calls) == 1
    calls.clear()
    assert ref() is None


def test_shutdown_lets_go_of_the_group(fresh):
    """A mesh kept past ``shutdown()`` (a step function's closure keeps
    one) no longer holds the destroyed process group."""
    from horovod_tpu_torch.parallel import mesh as mesh_lib
    hvd.init(device="cpu")
    kept = mesh_lib.get_mesh()
    assert kept.group is not None
    hvd.shutdown()
    assert kept.group is None
    hvd.init(device="cpu")
    assert mesh_lib.get_mesh().group is not None


def _imports(source):
    """Every module name that ``source`` imports, at any depth: import
    statements, and ``importlib.import_module`` / ``__import__`` of a
    literal name."""
    names = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                    node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", None)
            if name in ("import_module", "__import__"):
                names.append(node.args[0].value)
    return names


# a module of the JAX package named in a string: the ``-m`` argv of a
# launched process, which no import statement shows
_JAX_MODULE = re.compile(r"^horovod_tpu(\.\w+)+$")


def _jax_module_strings(source):
    """Every string constant of ``source``, docstrings aside, that names
    a module of the JAX package."""
    tree = ast.parse(source)
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant):
                docs.add(id(first.value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs and _JAX_MODULE.match(n.value)]


def test_port_imports_neither_jax_nor_the_jax_package():
    kinds = ("import jax\nfrom flax import linen\n"
             "def f():\n    import horovod_tpu.ckpt\n"
             "    importlib.import_module('optax')\n    __import__('jaxlib')\n"
             "from horovod_tpu_torch import ckpt\nfrom . import x\n")
    assert sorted(_imports(kinds)) == [
        "flax", "horovod_tpu.ckpt", "horovod_tpu_torch", "jax", "jaxlib",
        "optax"]
    planted = ('"""horovod_tpu.run"""\n'
               'class C:\n    """horovod_tpu.run.api"""\n'
               'def f():\n    """horovod_tpu.run.safe_exec"""\n'
               '    x = "horovod_tpu.run.task_fn"\n'
               '    return ["-m", "horovod_tpu.run.safe_exec", "horovod_tpu",\n'
               '            "horovod_tpu_torch.run.safe_exec", "horovod_tpu.",\n'
               '            f"horovod_tpu.{x}", "a horovod_tpu.run b"]\n')
    assert sorted(_jax_module_strings(planted)) == [
        "horovod_tpu.run.safe_exec", "horovod_tpu.run.task_fn"]
    files = sorted((REPO / "horovod_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 30
    banned = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")
    for f in files:
        source = f.read_text()
        for name in _imports(source):
            top = name.split(".")[0]
            assert top not in banned, f"{f.relative_to(REPO)} imports {name}"
        named = _jax_module_strings(source)
        assert not named, f"{f.relative_to(REPO)} names {named}"



_KV_WORKER = """
import json, sys, tempfile
import numpy as np
import torch
import horovod_tpu_torch as hvd
from horovod_tpu_torch import ckpt
out = []
for round_ in range(2):  # a second init finds its own store
    hvd.init(device="cpu")
    t = torch.tensor([float(hvd.rank() + 1), 10.0 * (round_ + 1)])
    out.append(hvd.allreduce(t, op=hvd.Sum).tolist())
    hvd.shutdown()
hvd.init(device="cpu")
ckpt.save_sharded(sys.argv[1], 5, {"w": np.full(3, hvd.rank(), np.float32)},
                  rank=hvd.rank(), world=hvd.size())
print("RESULT", json.dumps([hvd.rank(), out]), flush=True)
hvd.shutdown()
"""


def test_init_under_the_reference_kv_store(tmp_path):
    """Two port ranks under the launcher's env: HOROVOD_GLOO_RENDEZVOUS_*
    name the JAX package's HTTP ``KVStoreServer``, here with a secret
    key. Rank 0 publishes a TCP store there and rank 1 finds it, twice
    (shutdown, then init again); both allreduce; a checkpoint commit's
    best-effort acks reach the same store, signed. A request without the
    key is refused."""
    import json
    import os
    import subprocess
    import sys

    from horovod_tpu.run import rendezvous as jrdv
    from horovod_tpu.run import secret as jsecret
    key = jsecret.make_secret_key()
    server = jrdv.KVStoreServer(auth_key=key)
    port = server.start()
    try:
        procs = []
        for r in range(2):
            env = dict(os.environ, HOROVOD_RANK=str(r), HOROVOD_SIZE="2",
                       HOROVOD_LOCAL_RANK=str(r), HOROVOD_LOCAL_SIZE="2",
                       HOROVOD_GLOO_RENDEZVOUS_ADDR="127.0.0.1",
                       HOROVOD_GLOO_RENDEZVOUS_PORT=str(port),
                       HOROVOD_SECRET_KEY=jsecret.encode_key(key),
                       PYTHONPATH=str(REPO))
            env.pop("MASTER_ADDR", None)
            env.pop("MASTER_PORT", None)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _KV_WORKER, str(tmp_path)], env=env,
                cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        results = []
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-4000:]
            line = [ln for ln in out.splitlines()
                    if ln.startswith("RESULT")][0]
            results.append(json.loads(line.split(" ", 1)[1]))
        for _, out in results:
            assert out == [[3.0, 20.0], [3.0, 40.0]]
        stores = [server.get(f"torch_store/0/{n}") for n in (1, 2, 3)]
        assert all(stores) and len(set(stores)) == 3
        for r in range(2):
            ack = json.loads(server.get(f"ckpt/ack/5/{r}"))
            assert ack["rank"] == r and ack["world"] == 2
        assert json.loads(server.get("ckpt/manifest/5")) == {"world": 2}
        with pytest.raises(Exception, match="403"):
            jrdv.kv_get("127.0.0.1", port, "torch_store/0/1",
                        auth_key=b"not the key")
    finally:
        server.stop()


# Names of horovod_tpu's top level that the port leaves out: JAX's and
# optax's forms (DistributedOptimizer and distributed_value_and_grad stand
# for them). NOT_PORTED, the names still waiting for their port, is empty
# since the fusion autotuner landed; the test keeps checking it, so a name
# the JAX package adds later shows up here.
JAX_ONLY = {"distributed_grad", "DistributedGradientTransform",
            "HorovodOptimizer", "compat"}
NOT_PORTED = set()


def test_namespace_covers_the_jax_package():
    """``dir(horovod_tpu_torch)`` holds every public name of the JAX
    package's top level but the stated ones, and each resolves."""
    import horovod_tpu
    names = set(horovod_tpu.__all__) | {"compat"}
    assert JAX_ONLY | NOT_PORTED <= names
    missing = names - JAX_ONLY - NOT_PORTED - set(dir(hvd))
    assert not missing, sorted(missing)
    for name in names - JAX_ONLY - NOT_PORTED:
        assert getattr(hvd, name) is not None, name


@pytest.mark.parametrize("probe", ["nccl_built", "gloo_built", "mpi_built",
                                   "mpi_enabled", "mpi_threads_supported",
                                   "ccl_built", "ddl_built"])
def test_build_probes_answer_bools(probe):
    assert isinstance(getattr(hvd, probe)(), bool)


def test_compression_fp16_optimizer_and_the_mesh_at_world_one(fresh):
    """Horovod's canonical ``DistributedOptimizer(opt,
    compression=hvd.Compression.fp16)`` builds and steps at world 1; the
    mesh, its size and its data axes; ``fused_allreduce`` leaves its
    input as it is."""
    hvd.init(device="cpu")
    model = torch.nn.Linear(3, 2)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                   lr=0.1),
                                   compression=hvd.Compression.fp16)
    model(torch.ones(4, 3)).sum().backward()
    opt.step()
    assert hvd.num_devices() == 1 and hvd.mesh().size == 1
    assert hvd.data_axes() == ("data",)
    x = torch.arange(4.0)
    (y,) = hvd.fused_allreduce([x], op=hvd.Sum)
    assert y is not x and torch.equal(y, x)


def test_value_and_grad_and_broadcast_variables_at_world_one(fresh):
    """``distributed_value_and_grad`` gives the loss and its gradients
    (averaged over one rank: themselves); ``broadcast_variables`` keeps
    rank 0's values in place."""
    hvd.init(device="cpu")
    w = torch.tensor([1.0, -2.0, 3.0], requires_grad=True)
    x = torch.tensor([0.5, 0.25, 2.0])
    value, (g,) = hvd.distributed_value_and_grad(
        lambda ps, v: (ps[0] * v).pow(2).sum())([w], x)
    assert value.item() == pytest.approx(((w * x) ** 2).sum().item())
    torch.testing.assert_close(g, 2 * w.detach() * x * x)
    vs = [torch.ones(2), torch.arange(3.0)]
    got = hvd.broadcast_variables(vs)
    assert got[0] is vs[0] and torch.equal(got[1], torch.arange(3.0))


def test_launcher_imports_leave_torch_out():
    """``import horovod_tpu_torch, horovod_tpu_torch.run`` (what hvdrun and
    its middleman import) loads no torch: the namespace is lazy, its
    subpackages too."""
    import subprocess
    import sys
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, horovod_tpu_torch, horovod_tpu_torch.run\n"
         "dir(horovod_tpu_torch)\n"
         "print(sorted(m for m in sys.modules if m.split('.')[0] in "
         "('torch', 'numpy')))"],
        capture_output=True, text=True, cwd=REPO, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout
