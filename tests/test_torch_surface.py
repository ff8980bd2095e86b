"""The port's public surface against the JAX package's, name by name and
parameter by parameter, and the pieces of it that a walk by file path
could not see: explicit positions in the LM's training forward,
``init(num_slices=)``, ``allgather(tiled=False)``, the Config's core
knobs, the numpy Adasum references and the small helpers.

**The walk.** For every module of ``horovod_tpu/`` that has a twin by
path in ``horovod_tpu_torch/`` (one test case each), every public
function or class that the module defines has a same-named twin in the
port, and every parameter of its signature, and of each public method
(a flax ``__call__`` against a torch ``forward``), is a parameter of
the twin (a ``*args`` or ``**kwargs`` of the JAX side is met by one of
the same kind). ``JAX_ONLY`` lists what the port leaves out, each with
one of a fixed few reasons; a second check fails on an entry that no
longer names something of the JAX package, so the table cannot go stale.
The modules are imported in a subprocess, with ``fake_tensorflow``
standing in for TensorFlow (the adapters' signatures do not depend on
it, and the real one loaded into a test process would be what a later
test's ``fake_tensorflow.install()`` returns). ``mxnet/`` stays out: its
JAX modules cannot be imported without mxnet, and
``tests/test_torch_mxnet_adapter.py`` holds its adapter to JAX's.
Modules without a twin by path (``compat``, ``hvd_jax``, ``jax/``) are
``tests/test_torch_basics.py::test_namespace_covers_the_jax_package``'s.

The models run in fp32 at the small widths of
``tests/test_torch_transformer.py``: logits to 1e-4 and gradients to
1e-4 of the largest, as there. The multi-rank checks of the same items
are ``tests/test_torch_surface_ranks.py``'s.
"""

import ast
import fcntl
import inspect
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")

# -- the reasons a JAX name or parameter has no twin ----------------------

FLAX = ("flax module fields: a flax Module's attributes (name, parent, "
        "submodule choices) and flax's init/apply plumbing (rng, sample "
        "inputs, mutable collections); a torch module takes its "
        "constructor's arguments")
OPTAX = ("optax tx / MultiSteps: the port's optimizers are torch.optim "
         "ones, which own their parameters (DistributedOptimizer wraps one)")
XLA = ("XLA donate / placement: buffer donation, jax devices, meshes, "
       "shardings and partition specs, and the XLA flags; the port's "
       "ranks are processes of one device each over its installed mesh")
HLO = "HLO: parsing or costing XLA's compiled modules"
PALLAS = "Pallas tiling and interpret mode"


class Torch(str):
    """A torch-idiom departure, pinned by the named test
    (``file::function``)."""


JAX_ONLY = {
    # flax module fields
    "models.moe:MoE.name": FLAX,
    "models.moe:MoE.parent": FLAX,
    "models.moe:aux_loss.mutated": FLAX,
    "models.resnet:BasicBlock.conv": FLAX,
    "models.resnet:BasicBlock.norm": FLAX,
    "models.resnet:BasicBlock.act": FLAX,
    "models.resnet:BasicBlock.strides": FLAX,
    "models.resnet:BasicBlock.name": FLAX,
    "models.resnet:BasicBlock.parent": FLAX,
    "models.resnet:BottleneckBlock.conv": FLAX,
    "models.resnet:BottleneckBlock.norm": FLAX,
    "models.resnet:BottleneckBlock.act": FLAX,
    "models.resnet:BottleneckBlock.strides": FLAX,
    "models.resnet:BottleneckBlock.name": FLAX,
    "models.resnet:BottleneckBlock.parent": FLAX,
    "models.resnet:ResNet.name": FLAX,
    "models.resnet:ResNet.parent": FLAX,
    "models.simple:MNISTConvNet.name": FLAX,
    "models.simple:MNISTConvNet.parent": FLAX,
    "models.simple:MLP.name": FLAX,
    "models.simple:MLP.parent": FLAX,
    "models.transformer:Attention.name": FLAX,
    "models.transformer:Attention.parent": FLAX,
    "models.transformer:Block.name": FLAX,
    "models.transformer:Block.parent": FLAX,
    "models.transformer:Transformer.name": FLAX,
    "models.transformer:Transformer.parent": FLAX,
    "models.vgg:VGG16.name": FLAX,
    "models.vgg:VGG16.parent": FLAX,
    "parallel.tensor:shard_lm_state.model": FLAX,
    "parallel.tensor:shard_lm_state.rng": FLAX,
    "parallel.tensor:shard_lm_state.sample_tokens": FLAX,
    "serve.loader:abstract_params.sample_tokens": FLAX,
    "serve.loader:abstract_params.seq_len": FLAX,
    "training:TrainState": FLAX,
    "training:create_train_state.rng": FLAX,
    "training:create_train_state.sample_input": FLAX,
    "training:create_train_state.apply_kwargs": FLAX,
    # optax tx / MultiSteps
    "parallel.gspmd:apply_shards_spmd.tx": OPTAX,
    "parallel.tensor:shard_lm_state.tx": OPTAX,
    "parallel.tensor:make_tp_lm_train_step.tx": OPTAX,
    "parallel.zero:init.tx": OPTAX,
    "parallel.zero:apply_shards.tx": OPTAX,
    "parallel.zero:sharded_update.tx": OPTAX,
    "training:create_train_state.tx": OPTAX,
    "training:make_train_step.tx": OPTAX,
    "training:make_lm_train_step.tx": OPTAX,
    # XLA donate / placement
    "basics:init.devices": XLA,
    "cluster.procmesh:process_grid.devices": XLA,
    "cluster.procmesh:build_process_mesh.devices": XLA,
    "cluster.procmesh:global_batch.sharding": XLA,
    "cluster.procmesh:shard_from_global.sharding": XLA,
    "cluster.procmesh:place.sharding": XLA,
    "config:Config.cpu_collectives": XLA,
    "config:Config.xla_async_collectives": XLA,
    "config:Config.xla_latency_hiding_scheduler": XLA,
    "config:xla_overlap_flags": XLA,
    "config:apply_xla_flags": XLA,
    "models.moe:MoE.mesh": XLA,
    "models.moe:MoE.group_axis": XLA,
    "models.moe:shard_moe_params.mesh": XLA,
    "models.transformer:TransformerConfig.expert_mesh": XLA,
    # the eager path's cached mesh of jax.devices(); the port's elastic
    # reset reinstalls init()'s mesh instead (basics.invalidate_meshes)
    "ops.collective:invalidate_proc_mesh": XLA,
    # the JAX processes behind a device mesh; a port rank is a process of
    # one device, so the count is the mesh's size (hvd.size())
    "parallel.mesh:process_span": XLA,
    "parallel.gspmd:GspmdPlan.sharding": XLA,
    "parallel.gspmd:state_partition_specs.state": XLA,
    "parallel.gspmd:state_shardings.state": XLA,
    "parallel.gspmd:place_state.state": XLA,
    "parallel.gspmd:CompiledProgramCache.executable": XLA,
    "parallel.mesh:build_mesh.devices": XLA,
    "parallel.pipeline:pipelined_forward.mesh": XLA,
    "parallel.pipeline:pipelined_forward.axis_name": XLA,
    "parallel.pipeline:pipelined_forward.batch_axis": XLA,
    "parallel.pipeline:pipelined_forward.param_specs": XLA,
    "parallel.pipeline:pipeline_train_1f1b.mesh": XLA,
    "parallel.pipeline:pipeline_train_1f1b.axis_name": XLA,
    "parallel.pipeline:pipeline_train_1f1b.batch_axis": XLA,
    "parallel.pipeline:pipeline_train_1f1b.param_specs": XLA,
    "parallel.tensor:make_tp_lm_train_step.donate": XLA,
    "parallel.zero:make_plan.mesh": XLA,
    "parallel.zero:state_specs": XLA,
    "training:replicated_specs": XLA,
    "training:state_specs": XLA,
    "training:make_train_step.donate": XLA,
    "training:make_lm_train_step.donate": XLA,
    # HLO
    "diag.xray:run.hlo": HLO,
    "parallel.gspmd:collective_bytes_from_hlo": HLO,
    "parallel.gspmd:collective_axis_bytes_from_hlo": HLO,
    "parallel.gspmd:record_compiled_collectives": HLO,
    "utils.benchmarks:cost_analysis_dict": HLO,
    # Pallas tiling and interpret
    "ops.flash_attention:kernel_supported.block_q": PALLAS,
    "ops.flash_attention:kernel_supported.block_k": PALLAS,
    "ops.flash_attention:flash_attention.block_q": PALLAS,
    "ops.flash_attention:flash_attention.block_k": PALLAS,
    "ops.flash_attention:flash_attention.interpret": PALLAS,
    "ops.flash_attention:flash_attention_with_lse.block_q": PALLAS,
    "ops.flash_attention:flash_attention_with_lse.block_k": PALLAS,
    "ops.flash_attention:flash_attention_with_lse.interpret": PALLAS,
    "ops.flash_attention:flash_attention_bwd_block.block_q": PALLAS,
    "ops.flash_attention:flash_attention_bwd_block.block_k": PALLAS,
    "ops.flash_attention:flash_attention_bwd_block.interpret": PALLAS,
    # torch-idiom departures, each pinned by a test
    # LambdaLR factors instead of a schedule of base_lr
    "callbacks:warmup_schedule.base_lr": Torch(
        "tests/test_torch_callbacks.py::test_warmup_schedule_matches_optax"),
    "callbacks:lr_schedule.base_lr": Torch(
        "tests/test_torch_callbacks.py::test_lr_schedule_matches_optax"),
    # save_checkpoint(model, optimizer) and the rest of the file's calls
    "checkpoint:save_checkpoint.params": Torch(
        "tests/test_torch_checkpoint.py::test_port_file_restores_in_jax"),
    "checkpoint:save_checkpoint.opt_state": Torch(
        "tests/test_torch_checkpoint.py::test_port_file_restores_in_jax"),
    "checkpoint:write_checkpoint.params": Torch(
        "tests/test_torch_checkpoint.py::test_params_only_and_retention"),
    "checkpoint:write_checkpoint.opt_state": Torch(
        "tests/test_torch_checkpoint.py::test_params_only_and_retention"),
    "checkpoint:restore_checkpoint.params": Torch(
        "tests/test_torch_checkpoint.py::"
        "test_jax_file_restores_in_the_port_and_steps_alike"),
    "checkpoint:restore_checkpoint.opt_state": Torch(
        "tests/test_torch_checkpoint.py::"
        "test_jax_file_restores_in_the_port_and_steps_alike"),
    "checkpoint:restore_or_init.params": Torch(
        "tests/test_torch_checkpoint.py::"
        "test_restore_or_init_broadcasts_rank_zeros_restore"),
    "checkpoint:restore_or_init.opt_state": Torch(
        "tests/test_torch_checkpoint.py::"
        "test_restore_or_init_broadcasts_rank_zeros_restore"),
    # TorchState keeps a model, an optimizer and a StepState
    "elastic.state:JaxState": Torch(
        "tests/test_torch_elastic.py::"
        "test_jax_state_commit_restores_in_torch_state"),
    # module.train() / .eval() instead of a train= argument
    "models.resnet:ResNet.__call__.train": Torch(
        "tests/test_torch_resnet.py::test_resnet_matches_flax"),
    "models.simple:MLP.__call__.train": Torch(
        "tests/test_torch_exchange.py::test_simple_models_match_flax"),
    "models.simple:MNISTConvNet.__call__.train": Torch(
        "tests/test_torch_exchange.py::test_convnet_dropout_is_seeded"),
    "models.vgg:VGG16.__call__.train": Torch(
        "tests/test_torch_resnet.py::test_vgg_matches_flax"),
    # a list of tensors instead of a pytree
    "ops.fusion:fused_allreduce.tree": Torch(
        "tests/test_torch_train_step.py::"
        "test_fused_allreduce_roundtrip_keeps_shapes"),
    "ops.fusion:autotune_fusion_threshold.tree": Torch(
        "tests/test_torch_autotune.py::"
        "test_autotune_uses_shared_timing_primitive"),
    # the torch optimizer owns and updates the parameters in place
    "parallel.gspmd:apply_shards_spmd.params": Torch(
        "tests/test_torch_gspmd.py::test_step_moves_the_models_own_parameters"),
    "parallel.zero:apply_shards.grad_rows": Torch(
        "tests/test_torch_zero.py::test_make_train_step_matches_jax_world_one"),
    "parallel.zero:apply_shards.params": Torch(
        "tests/test_torch_zero.py::test_make_train_step_matches_jax_world_one"),
    "parallel.zero:sharded_update.params": Torch(
        "tests/test_torch_zero.py::test_make_train_step_matches_jax_world_one"),
    # the ZeRO state travels by state_dict(), not as a pytree
    "parallel.zero:ZeroState.tree_flatten": Torch(
        "tests/test_torch_optimizer.py::test_state_dict_round_trip"),
    "parallel.zero:ZeroState.tree_unflatten": Torch(
        "tests/test_torch_optimizer.py::test_state_dict_round_trip"),
    # torch profiler events are classified by name and category
    "telemetry.xprof:classify_device_event": Torch(
        "tests/test_torch_xray.py::test_name_table"),
    # the port's steps update their model in place: no state to thread
    "telemetry.xprof:xray_run.state": Torch(
        "tests/test_torch_xray.py::test_gspmd_lm_step_xray_on_a_real_cpu_capture"),
    # Horovod's torch signature names the scale factors
    "torch.mpi_ops:allreduce_async_.kw": Torch(
        "tests/test_torch_torch_adapter.py::test_adapters_on_two_ranks"),
    # synthetic_batch in fp32 NCHW
    "utils.benchmarks:synthetic_batch.dtype": Torch(
        "tests/test_torch_resnet.py::test_synthetic_batch_is_the_jax_batch"),
}
REASONS = (FLAX, OPTAX, XLA, HLO, PALLAS)
# what this slice ported: none of it may stand in the table
PORTED_HERE = (
    "models.transformer:Attention.__call__",
    "models.transformer:Block.__call__",
    "models.transformer:Transformer.__call__",
    "training:make_train_step.batch_axes", "training:make_train_step.mesh",
    "basics:init.num_slices", "ops.collective:allgather",
    "config:Config.cycle_time_ms", "config:Config.cache_capacity",
    "config:Config.log_level", "config:Config.log_hide_timestamp",
    "config:Config.batch_d2d_memcopies", "config:Config.autotune",
    "ops.adasum:")
SKIPPED = {"mxnet", "mxnet.mpi_ops"}  # need mxnet to import


def _module_pairs():
    """Every JAX module (dotted, without the package; "" is the package
    itself) with a twin by path in the port, mxnet and ``__main__`` left
    out."""
    pairs = []
    root = os.path.join(REPO, "horovod_tpu")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py") or f == "__main__.py":
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), root)[:-3]
            parts = rel.split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            name = ".".join(parts)
            if name in SKIPPED:
                continue
            twin = os.path.join(REPO, "horovod_tpu_torch", *parts)
            if os.path.exists(twin + ".py") or os.path.exists(
                    os.path.join(twin, "__init__.py")):
                pairs.append(name)
    return sorted(pairs)


MODULES = _module_pairs()

_DUMP = textwrap.dedent("""
    import importlib, inspect, json, sys
    sys.path.insert(0, {tests!r})
    import fake_tensorflow
    fake_tensorflow.install()

    def sig(f):
        try:
            ps = inspect.signature(f).parameters.values()
        except (TypeError, ValueError):
            return None
        return [[p.name, p.kind.name] for p in ps
                if p.name not in ("self", "cls")]

    def methods(cls):
        out = {{}}
        for n, o in vars(cls).items():
            if n.startswith("_") and n != "__call__":
                continue
            if isinstance(o, (staticmethod, classmethod)):
                o = o.__func__
            if inspect.isfunction(o):
                out[n] = o
        return out

    surface = {{}}
    for name in {modules!r}:
        jm = importlib.import_module(("horovod_tpu." + name).rstrip("."))
        pm = importlib.import_module(
            ("horovod_tpu_torch." + name).rstrip("."))
        entries = {{}}
        for n, o in vars(jm).items():
            if n.startswith("_") or not (inspect.isfunction(o)
                                         or inspect.isclass(o)):
                continue
            if getattr(o, "__module__", None) != jm.__name__:
                continue
            t = getattr(pm, n, None)
            e = {{"jax": sig(o), "port": None if t is None else sig(t),
                  "twin": t is not None, "methods": {{}}}}
            if inspect.isclass(o):
                for mn, mf in methods(o).items():
                    tn = mn
                    if mn == "__call__" and hasattr(t, "forward"):
                        tn = "forward"
                    tf = getattr(t, tn, None) if t is not None else None
                    e["methods"][mn] = {{
                        "jax": sig(mf), "twin": tf is not None,
                        "port": None if tf is None else sig(tf)}}
            entries[n] = e
        surface[name] = entries
    with open(sys.argv[1], "w") as f:
        json.dump(surface, f)
""")


@pytest.fixture(scope="session")
def surface(tmp_path_factory):
    """The surface of every module pair, dumped once a test run by
    a subprocess (shared by xdist workers through a lock). The dump lives
    in this run's own base directory, the parent of the workers' under
    xdist, so a later run dumps the sources anew."""
    shared = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        shared = shared.parent
    path = shared / "torch_surface.json"
    with open(shared / "torch_surface.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            tmp = shared / f"torch_surface.{os.getpid()}.json"
            env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
            res = subprocess.run(
                [sys.executable, "-c",
                 _DUMP.format(tests=TESTS, modules=MODULES), str(tmp)],
                cwd=REPO, env=env, capture_output=True, text=True,
                timeout=300)
            assert res.returncode == 0, res.stderr[-4000:]
            os.replace(tmp, path)
    with open(path) as f:
        return json.load(f)


def _gaps(module, entries):
    """``module:name[.method][.param]`` of everything the port lacks."""
    out = []

    def params(where, jsig, psig):
        if jsig is None or psig is None:
            return
        names = {n for n, _ in psig}
        kinds = {k for _, k in psig}
        for n, kind in jsig:
            if kind in ("VAR_POSITIONAL", "VAR_KEYWORD"):
                if kind not in kinds:
                    out.append(f"{where}.{n}")
            elif n not in names:
                out.append(f"{where}.{n}")

    for name, e in entries.items():
        where = f"{module}:{name}"
        if not e["twin"]:
            out.append(where)
            continue
        params(where, e["jax"], e["port"])
        for mn, m in e["methods"].items():
            if not m["twin"]:
                out.append(f"{where}.{mn}")
            else:
                params(f"{where}.{mn}", m["jax"], m["port"])
    return out


@pytest.mark.parametrize("module", MODULES, ids=lambda m: m or "package")
def test_module_twin_covers_the_jax_module(surface, module):
    """Every public function and class of the JAX module, every parameter
    and every public method, has its twin in the port, or a ``JAX_ONLY``
    entry."""
    missing = [g for g in _gaps(module, surface[module])
               if g not in JAX_ONLY]
    assert not missing, missing


def test_jax_only_table_names_the_jax_package(surface):
    """Each entry names a module of the walk and a function, class,
    method or parameter the JAX side has, which the port lacks."""
    gaps = {g for m in MODULES for g in _gaps(m, surface[m])}
    stale = sorted(k for k in JAX_ONLY if k not in gaps)
    assert not stale, stale


def _defines(path, func):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    return any(isinstance(n, ast.FunctionDef) and n.name == func
               for n in tree.body)


def test_jax_only_reasons_are_the_stated_ones():
    """Every reason is one of the fixed few; a torch-idiom departure names
    a test that exists; nothing this slice ported stands in the table."""
    for key, reason in JAX_ONLY.items():
        if isinstance(reason, Torch):
            path, func = reason.split("::")
            assert _defines(path, func), (key, reason)
        else:
            assert reason in REASONS, key
    for key in JAX_ONLY:
        assert not key.startswith(PORTED_HERE), key


# -- explicit positions in the training forward ---------------------------

WIDTHS = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32,
              d_ff=128)
B, S = 2, 32


def position_cases(batch, seq, seed=0):
    """``[batch, seq]`` int positions of each case: the default ones
    given explicitly, two packed documents of ``seq // 2`` (each starting
    at 0), and a random offset per row."""
    rng = np.random.default_rng(seed)
    base = np.arange(seq)[None].repeat(batch, 0)
    half = seq // 2
    packed = np.concatenate([np.arange(half), np.arange(seq - half)])
    return {"contiguous": base,
            "packed": np.broadcast_to(packed, (batch, seq)).copy(),
            "offset": base + rng.integers(0, 1000, size=(batch, 1))}


def _lm(flash, seed=0):
    from horovod_tpu.models.transformer import Transformer as JTransformer
    from horovod_tpu.models.transformer import TransformerConfig as JConfig
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.models.transformer import (Transformer,
                                                      TransformerConfig)
    jmodel = JTransformer(JConfig(**WIDTHS, dtype=jnp.float32,
                                  flash_attention=flash))
    tokens = np.random.default_rng(seed).integers(
        0, WIDTHS["vocab_size"], size=(B, S)).astype(np.int32)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(seed), jnp.asarray(tokens[:1]),
        train=False)["params"])
    cfg = TransformerConfig(**WIDTHS, dtype=torch.float32,
                            flash_attention=flash)
    tmodel = Transformer(cfg)
    tmodel.load_state_dict(convert.params_from_flax(params, cfg))
    return jmodel, params, tmodel, tokens


@pytest.fixture()
def no_flash(monkeypatch):
    """Given positions never reach the flash kernels: their wrappers and
    the flash ring raise if called."""
    from horovod_tpu_torch.ops import flash_attention as tfa
    from horovod_tpu_torch.parallel import ring as tring

    def refuse(*args, **kwargs):
        raise AssertionError("given positions reached the flash kernels")
    monkeypatch.setattr(tfa, "attention", refuse)
    monkeypatch.setattr(tfa, "flash_attention_with_lse", refuse)
    monkeypatch.setattr(tring, "_flash_ring_forward", refuse)


def _assert_grads_close(tgrads, jgrads):
    for path, jg in jax.tree_util.tree_leaves_with_path(jgrads):
        tg = tgrads
        for key in path:
            tg = tg[key.key]
        scale = float(np.abs(np.asarray(jg)).max())
        np.testing.assert_allclose(tg, np.asarray(jg),
                                   atol=1e-4 * scale + 1e-7,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
@pytest.mark.parametrize("case", ["contiguous", "packed", "offset"])
def test_explicit_positions_match_flax(no_flash, case, flash):
    """``Transformer.forward(tokens, positions)`` against flax's
    ``apply(tokens, positions)``: logits and every gradient of the
    next-token loss, fp32. Given positions mean not contiguous on both
    sides, so with ``flash_attention`` set both take the dense path."""
    from horovod_tpu_torch import convert
    jmodel, params, tmodel, tokens = _lm(flash)
    pos = position_cases(B, S)[case]
    jpos = jnp.asarray(pos)
    tpos = torch.from_numpy(pos)

    def j_loss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(tokens), jpos)
        logp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        return -jnp.mean(jnp.take_along_axis(
            logp, jnp.asarray(tokens[:, 1:])[..., None], axis=-1))

    j_logits = jmodel.apply({"params": params}, jnp.asarray(tokens), jpos)
    t_logits = tmodel(torch.from_numpy(tokens).long(), tpos)
    np.testing.assert_allclose(t_logits.detach().numpy(),
                               np.asarray(j_logits), atol=1e-4)
    logp = torch.log_softmax(t_logits[:, :-1], dim=-1)
    t_loss = -logp.gather(-1, torch.from_numpy(
        tokens[:, 1:]).long()[..., None]).mean()
    t_loss.backward()
    jl, jg = jax.value_and_grad(j_loss)(params)
    np.testing.assert_allclose(t_loss.item(), float(jl), rtol=1e-5)
    _assert_grads_close(convert.flax_from_params(
        {n: p.grad for n, p in tmodel.named_parameters()}, tmodel.cfg), jg)
    if case == "contiguous" and not flash:
        # arange given is the default dense path's arange: the same bits
        with torch.no_grad():
            assert torch.equal(t_logits.detach(),
                               tmodel(torch.from_numpy(tokens).long()))


def test_explicit_positions_over_model_shards_match_unsharded(no_flash):
    """R 2 model shards in one process (``forward_shards`` over a
    ``LocalAxis``) at packed positions: their vocabulary blocks against
    the unsharded model (1e-5) and flax (1e-4), each shard's gradients
    against the matching block of the unsharded model's (1e-5 of the
    largest), as ``test_torch_tensor_parallel.py``'s
    ``test_model_shards_match_unsharded_and_flax`` holds them."""
    from horovod_tpu.models.transformer import Transformer as JTransformer
    from horovod_tpu.models.transformer import TransformerConfig as JConfig
    from horovod_tpu_torch import convert
    from horovod_tpu_torch.models.transformer import (Axes, Transformer,
                                                      TransformerConfig,
                                                      forward_shards)
    from horovod_tpu_torch.parallel import axis as taxis
    from horovod_tpu_torch.parallel import tensor as ttp
    import test_torch_tensor_parallel as ttpt
    r = 2
    params = ttpt._flax_params(ttpt.WIDTHS)
    tokens = torch.from_numpy(ttpt._tokens())
    pos = torch.from_numpy(position_cases(*tokens.shape)["packed"])
    cfg = TransformerConfig(**ttpt.WIDTHS, dtype=torch.float32,
                            flash_attention=True)
    whole = Transformer(cfg)
    whole.load_state_dict(convert.params_from_flax(params, cfg))
    want = whole(tokens, pos)
    (want * torch.linspace(-1, 1, want.numel()).reshape(want.shape)).sum() \
        .backward()
    j_logits = JTransformer(JConfig(**ttpt.WIDTHS, dtype=jnp.float32)).apply(
        {"params": params}, jnp.asarray(tokens.numpy()),
        jnp.asarray(pos.numpy()))
    models = [ttp.shard_lm_state(cfg, ttpt._rank_mesh((r,), ("model",), i),
                                 model_axis="model", batch_axis=None,
                                 params=params) for i in range(r)]
    one = taxis.single_axis(r)
    outs = forward_shards(models, [tokens] * r,
                          Axes(taxis.LocalAxis(r), one, one), pos)
    got = torch.cat(outs, dim=-1)
    weight = torch.linspace(-1, 1, got.numel()).reshape(got.shape)
    torch.autograd.backward([(o * w).sum() for o, w in zip(
        outs, weight.chunk(r, dim=-1))])
    np.testing.assert_allclose(got.detach(), want.detach(), atol=1e-5)
    np.testing.assert_allclose(got.detach(), np.asarray(j_logits), atol=1e-4)
    specs = ttp.transformer_param_specs(params, "model")
    full = convert.flax_from_params(
        {n: p.grad for n, p in whole.named_parameters()}, cfg)
    for i, m in enumerate(models):
        mine = ttpt._flat(convert.flax_from_params(
            {n: p.grad for n, p in m.named_parameters()}, m))
        block = ttpt._flat(convert.shard_flax(full, specs, {"model": (i, r)}))
        for key, g in block.items():
            np.testing.assert_allclose(
                mine[key], g, rtol=0, atol=1e-5 * np.abs(g).max() + 1e-9,
                err_msg=f"shard {i} {key}")


def test_block_and_stage_block_fn_carry_positions_as_flax(no_flash):
    """One block at offset positions: the flax ``Block`` (non-contiguous,
    its default), the port's ``Block.forward(x, positions)``, and the
    pipeline's ``stage_block_fn(..., positions)`` on the block's own
    parameters; the last two bit for bit."""
    from horovod_tpu.models.transformer import Block as JBlock
    from horovod_tpu.models.transformer import TransformerConfig as JConfig
    from horovod_tpu_torch.models.transformer import single_axes, \
        stage_block_fn
    jmodel, params, tmodel, _ = _lm(flash=True)
    pos = position_cases(B, S)["offset"]
    x = np.random.default_rng(4).standard_normal(
        (B, S, WIDTHS["d_model"])).astype(np.float32)
    jcfg = JConfig(**WIDTHS, dtype=jnp.float32, flash_attention=True)
    want = JBlock(jcfg).apply({"params": params["block_0"]}, jnp.asarray(x),
                              jnp.asarray(pos))
    blk = tmodel.blocks[0]
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos)
    with torch.no_grad():
        got = blk(tx, tpos)
        fn = stage_block_fn([blk], single_axes(), positions=tpos)
        staged = fn([dict(blk.named_parameters())], [tx])[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert torch.equal(staged, got)


# -- Config, Adasum's references, the helpers ------------------------------

def test_config_core_knobs_match_jax(monkeypatch):
    """Under one seeded environment (every variable both Configs read),
    both packages' ``Config.from_env()`` agree field for field on every
    field both have, the core knobs among them."""
    import dataclasses

    from horovod_tpu.config import Config as JConfig
    from horovod_tpu_torch.config import Config as TConfig
    rng = np.random.default_rng(22)
    env = {
        "HOROVOD_RANK": "1", "HOROVOD_SIZE": "4", "HOROVOD_LOCAL_RANK": "1",
        "HOROVOD_LOCAL_SIZE": "2", "HOROVOD_CROSS_RANK": "0",
        "HOROVOD_CROSS_SIZE": "2",
        "HOROVOD_FUSION_THRESHOLD": str(int(rng.integers(1, 1 << 28))),
        "HOROVOD_CYCLE_TIME": str(float(rng.uniform(0.5, 20))),
        "HOROVOD_CACHE_CAPACITY": str(int(rng.integers(0, 4096))),
        "HOROVOD_BATCH_D2D_MEMCOPIES": "0",
        "HOROVOD_LOG_LEVEL": "debug", "HOROVOD_LOG_HIDE_TIME": "1",
        "HOROVOD_AUTOTUNE": "1", "HOROVOD_AUTOTUNE_LOG": "/dev/null",
        "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": str(int(rng.integers(1, 9))),
        "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": str(int(rng.integers(1, 99))),
        "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": str(
            int(rng.integers(1, 99))),
        "HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE": str(
            float(rng.uniform(0, 1))),
        "HOROVOD_HIERARCHICAL_ALLREDUCE": "1",
        "HOROVOD_WIRE_DTYPE": "bf16", "HOROVOD_TIMELINE": "tl.json",
        "HOROVOD_STALL_CHECK_TIME_SECONDS": "7.5",
        "HOROVOD_ADASUM_CHUNK_SIZE": "4096",
    }
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    j, t = JConfig.from_env(), TConfig.from_env()
    both = ({f.name for f in dataclasses.fields(JConfig)}
            & {f.name for f in dataclasses.fields(TConfig)})
    # the port's rendezvous falls back to MASTER_ADDR/PORT, JAX's does not
    both -= {"rendezvous_addr", "rendezvous_port"}
    assert {"cycle_time_ms", "cache_capacity", "batch_d2d_memcopies",
            "log_level", "log_hide_timestamp", "autotune", "autotune_log",
            "autotune_warmup_samples", "autotune_steps_per_sample",
            "autotune_bayes_opt_max_samples",
            "autotune_gaussian_process_noise"} <= both
    for name in sorted(both):
        assert getattr(t, name) == getattr(j, name), name
    assert t.cycle_time_ms == float(env["HOROVOD_CYCLE_TIME"])
    for k in env:
        monkeypatch.delenv(k)
    j, t = JConfig.from_env(), TConfig.from_env()
    for name in sorted(both):  # the defaults
        assert getattr(t, name) == getattr(j, name), name


@pytest.mark.parametrize("n", range(1, 9))
def test_adasum_tree_np_is_jaxs_bit_for_bit(n):
    """``adasum_tree_np`` and ``adasum_combine_np`` of both packages on
    seeded vectors (one of them zero where n > 2): the same bits, and a
    non-power-of-2 count refused by both."""
    from horovod_tpu.ops import adasum as jadasum
    from horovod_tpu_torch.ops import adasum as tadasum
    rng = np.random.default_rng(n)
    vecs = [rng.standard_normal(37).astype(np.float32) * 10.0 ** (i % 3)
            for i in range(n)]
    if n > 2:
        vecs[1] = np.zeros(37, np.float32)
    a, b = vecs[0], vecs[-1]
    assert np.array_equal(tadasum.adasum_combine_np(a, b),
                          jadasum.adasum_combine_np(a, b))
    if n & (n - 1):
        with pytest.raises(AssertionError):
            jadasum.adasum_tree_np(vecs)
        with pytest.raises(ValueError, match="power of 2"):
            tadasum.adasum_tree_np(vecs)
        return
    got = tadasum.adasum_tree_np(vecs)
    assert got.dtype == np.float32
    assert np.array_equal(got, jadasum.adasum_tree_np(vecs))


@pytest.mark.parametrize("grid", [(2, 2), (2, 3), (4, 2), (4, 1)])
def test_hierarchical_adasum_np_is_jaxs_bit_for_bit(grid):
    """The two-level reference on seeded ``[nodes, local, n]`` grids whose
    length does not divide by ``local`` (the zero padding): the same
    bits."""
    from horovod_tpu.ops import adasum as jadasum
    from horovod_tpu_torch.ops import adasum as tadasum
    rng = np.random.default_rng(sum(grid))
    g = rng.standard_normal(grid + (29,)).astype(np.float32)
    got = tadasum.hierarchical_adasum_np(g)
    assert got.shape == (29,)
    assert np.array_equal(got, jadasum.hierarchical_adasum_np(g))


@pytest.fixture()
def cpu_world():
    import horovod_tpu_torch as hvd_t
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    yield hvd_t
    hvd_t.shutdown()


def test_free_port_binds():
    """``free_port`` gives a port that binds, as JAX's."""
    import socket

    from horovod_tpu.run.run import free_port as jax_free_port
    from horovod_tpu_torch.run.run import free_port
    port = free_port()
    assert 0 < port < 65536
    with socket.socket() as s:
        s.bind(("0.0.0.0", port))
    assert 0 < jax_free_port() < 65536


def test_init_num_slices_that_does_not_divide_is_refused_as_jax():
    """At world 1, ``num_slices=2`` is refused with JAX's message, before
    any rendezvous; ``num_slices=1`` is the default mesh."""
    import horovod_tpu as hvd_j
    import horovod_tpu_torch as hvd_t
    hvd_j.shutdown()
    hvd_t.shutdown()
    try:
        with pytest.raises(ValueError) as je:
            hvd_j.init(num_slices=2, devices=jax.devices()[:1])
        with pytest.raises(ValueError) as te:
            hvd_t.init(device="cpu", num_slices=2)
        assert str(te.value) == str(je.value)
        assert not hvd_t.is_initialized()
        hvd_t.init(device="cpu", num_slices=1)
        assert hvd_t.mesh().axis_names == ("data",)
        assert hvd_t.mesh().shape == (1,)
    finally:
        hvd_t.shutdown()
        hvd_j.shutdown()


def test_allgather_untiled_at_world_one(cpu_world):
    """``allgather(x, tiled=False)`` stacks one new axis of the group's
    size, [1, ...] at world 1, equal to the input; async the same; its
    gradient is the tiled form's."""
    from horovod_tpu_torch.ops import collective
    x = torch.arange(6.0).reshape(2, 3).requires_grad_()
    y = collective.allgather(x, tiled=False)
    assert y.shape == (1, 2, 3) and torch.equal(y[0], x)
    (y * 3).sum().backward()
    g_untiled = x.grad.clone()
    x.grad = None
    (collective.allgather(x) * 3).sum().backward()
    assert torch.equal(g_untiled, x.grad)
    pending = collective.allgather(x.detach(), async_op=True, tiled=False)
    assert torch.equal(pending.wait(), y.detach())


def test_small_ports(cpu_world, tmp_path, monkeypatch):
    """The parameters a walk of the signatures found missing and this
    slice added: ``zero.bucket_rows`` is JAX's row view bit for bit,
    ``CompiledProgramCache(prefix=)`` labels its collectives,
    ``TorchHandle(postprocess=)`` maps the result, ``sync(x)`` takes a
    tensor, ``restore_or_init(axes=)`` is taken and ignored, as JAX's,
    ``make_train_step`` takes ``batch_axes`` and ``mesh`` by keyword
    after its earlier parameters,
    ``allreduce(logical_nbytes=)`` books the logical width, and
    ``_core.build(force=True)`` compiles again."""
    from horovod_tpu.ops import fusion as jfusion
    from horovod_tpu.parallel import zero as jzero
    from horovod_tpu_torch import _build, _core, checkpoint
    from horovod_tpu_torch.ops import collective
    from horovod_tpu_torch.ops import fusion as tfusion
    from horovod_tpu_torch.parallel import gspmd, zero
    from horovod_tpu_torch.telemetry import instruments
    from horovod_tpu_torch.torch.mpi_ops import TorchHandle
    from horovod_tpu_torch.utils import benchmarks
    rng = np.random.default_rng(7)
    leaves = [rng.standard_normal(s).astype(np.float32)
              for s in ((5,), (3, 4), (7,))]
    js = jfusion.bucket_schedule(leaves, world=2, threshold_bytes=48,
                                 axes=("data",))
    ts = tfusion.bucket_schedule([torch.from_numpy(x) for x in leaves],
                                 world=2, threshold_bytes=48, axes=("data",))
    assert len(js.buckets) == len(ts.buckets) > 1
    for i in range(len(ts.buckets)):
        want = np.asarray(jzero.bucket_rows(js, i, [jnp.asarray(x)
                                                    for x in leaves]))
        got = zero.bucket_rows(ts, i, [torch.from_numpy(x) for x in leaves])
        assert np.array_equal(got.numpy(), want)

    seen = []
    monkeypatch.setattr(instruments, "record_compiled_collective",
                        lambda label, **kw: seen.append(label))
    cache = gspmd.CompiledProgramCache(prefix="serve")
    cache.run(lambda t: collective.allreduce(t), torch.ones(3))
    assert seen and all(s.startswith("serve_") for s in seen)

    class Done:
        def wait(self):
            return np.arange(4, dtype=np.float32)
    assert torch.equal(TorchHandle(Done(), postprocess=lambda t: t * 2)
                       .synchronize(), torch.arange(4.0) * 2)
    benchmarks.sync(torch.ones(1))

    model = torch.nn.Linear(2, 2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert checkpoint.restore_or_init(str(tmp_path / "none"), model,
                                      axes=("data",)) == (0, {})
    assert all(torch.equal(v, before[k])
               for k, v in model.state_dict().items())

    # make_train_step keeps the port's earlier positional order; the new
    # parameters are keyword-only
    from horovod_tpu_torch import training
    params = inspect.signature(training.make_train_step).parameters
    assert list(params)[:11] == [
        "model", "optimizer", "loss_fn", "dropout_seed", "accum_steps",
        "overlap_grads", "error_feedback", "loader", "spmd", "telemetry",
        "batch_axes"]
    assert all(params[n].kind is inspect.Parameter.KEYWORD_ONLY
               for n in ("batch_axes", "mesh"))

    booked = []
    real = collective.allreduce_
    monkeypatch.setattr(collective, "allreduce_", lambda x, **kw: (
        booked.append(kw.get("logical_nbytes")), real(x, **kw))[1])
    collective.allreduce(torch.ones(4), logical_nbytes=123)
    assert booked == [123]

    built = []

    def fake_run(cmds):
        for cmd in cmds:
            built.append(cmd)
            out = cmd[cmd.index("-o") + 1]
            with open(out, "w") as f:
                f.write("built")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_run_all", fake_run)
    lib = tmp_path / "libcore.so"
    monkeypatch.setattr(_core, "library_path", lambda: lib)
    lib.write_text("old")
    assert _core.build() == lib and not built and lib.read_text() == "old"
    assert _core.build(force=True) == lib
    assert built and lib.read_text() == "built"
