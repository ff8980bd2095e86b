"""Lifecycle, identity, env contract and collectives of the port
(horovod_tpu_torch/basics.py, config.py, ops/collective.py), and the
rule that the port imports neither JAX nor the JAX package."""

import ast
import pathlib

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
    hvd.init(device="cpu")
    with pytest.raises(NotImplementedError, match="Adasum"):
        hvd.allreduce(torch.ones(1), op=hvd.Adasum)
    with pytest.raises(ValueError, match="unknown reduction op"):
        hvd.allreduce(torch.ones(1), op="median")
    with pytest.raises(TypeError, match="floating"):
        hvd.allreduce(torch.ones(1, dtype=torch.int64), op=hvd.Average)


def _imports(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "horovod_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    banned = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in banned, f"{f.relative_to(REPO)} imports {name}"

