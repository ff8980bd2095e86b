"""The port's example drivers (``horovod_tpu_torch/examples/``) against
their JAX twins (``examples/``), on the CPU at small sizes.

* ``checkpoint_resume`` on 2 ranks: a JAX first leg (4 epochs) resumed
  by the port to 8, and a port first leg resumed by JAX; the first loss
  after the crossing within rtol 1e-6 of the writer's unbroken 8-epoch
  run, every loss within rtol 1e-5 (the two Adams' bias corrections).
* ``mnist``: one JAX device against one port rank, and two virtual JAX
  devices against two port ranks under ``hvdrun-torch``, from JAX's
  initial weights (carried over by ``convert``) and JAX's dropout masks
  (flax's ``Dropout`` drawn from the key JAX's step folds for each step
  and shard); neither raises "did not learn".
* ``imagenet_resnet50`` at the JAX test's smoke size
  (``tests/test_examples.py``: depth 18, 4 filters, 32x32, 4 classes,
  16 examples, batch 2, 2 ranks), in fp32: the disjoint-shard line; the
  port resumes JAX's epoch-1 checkpoint and JAX resumes the port's, the
  first step after each resume held to the writer's unbroken run and
  each file's SGD trace to the port's momentum bit for bit; the port
  resuming its own checkpoint runs epoch 2 bit for bit as its unbroken
  run.
* ``hierarchical_allreduce``: 4 gloo ranks as 2 hosts of 2 against JAX
  on a 4-device virtual mesh with ``--slices 2``: the mesh line equal,
  the first and last loss within rtol 1e-4.
* ``synthetic_benchmark``: a tiny run prints the twin's lines at world 1
  and at world 2.
* The classic drivers over the port's adapters: ``pytorch_mnist`` and
  ``mxnet_mnist`` (over ``fake_mxnet.py`` with a torch-backed gluon
  sliver below) print the lines of their JAX-package twins under the
  JAX launcher, value for value; ``pytorch_synthetic_benchmark`` and the
  two TensorFlow drivers draw unseeded weights or time the host, so they
  are held to the lines ``tests/test_examples.py`` asserts of their twins.
* Every file of ``examples/`` has a port twin or a recorded mapping
  (``TWINS``), and every driver imports with ``jax``, ``flax``, ``optax``
  and ``horovod_tpu`` made unimportable.

Each check's docstring gives its tolerances and why. The checks read one
set of runs, so they are one test (parallel workers would each start
the runs again), and it reports every check that fails.

Launches are shared: one ``hvdrun-torch -np 2`` job runs every 2-rank
port driver in turn (this file run as a script, ``port``), a second the
classic drivers, and one JAX ``hvdrun -np 2`` job every JAX twin
(``jax``); each side writes its first legs, marks them done and waits
for the other's before its second legs. The in-process runs go on
meanwhile; the JAX hierarchical run, the classic job and the 4-rank
port spawn start as earlier launches end (``STAGES``).
"""

import contextlib
import io
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import time
import traceback

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")

# every file of examples/: its port twin, a module of
# horovod_tpu_torch/examples (and the flags that select the variant)
TWINS = {
    "elastic_train.py": "elastic_train",
    "jax_checkpoint_resume.py": "checkpoint_resume",
    "jax_hierarchical_allreduce.py": "hierarchical_allreduce",
    "jax_imagenet_resnet50.py": "imagenet_resnet50",
    "jax_lm_benchmark.py": "lm_benchmark",
    "jax_lm_moe.py": "lm_benchmark --expert --moe-every",
    "jax_lm_seq_parallel.py": "lm_benchmark --data --seq",
    "jax_lm_tensor_parallel.py": "lm_benchmark --model",
    "jax_mnist.py": "mnist",
    "jax_synthetic_benchmark.py": "synthetic_benchmark",
    "mxnet_mnist.py": "mxnet_mnist",
    "pytorch_mnist.py": "pytorch_mnist",
    "pytorch_synthetic_benchmark.py": "pytorch_synthetic_benchmark",
    "tensorflow2_keras_mnist.py": "tensorflow2_keras_mnist",
    "tensorflow2_mnist.py": "tensorflow2_mnist",
}
# the drivers this file runs (the LM and elastic drivers have their own
# tests: test_torch_run.py, test_torch_seq_parallel.py, the elastic ones)
DRIVERS = ("checkpoint_resume", "mnist", "imagenet_resnet50",
           "synthetic_benchmark", "hierarchical_allreduce", "pytorch_mnist",
           "pytorch_synthetic_benchmark", "tensorflow2_keras_mnist",
           "tensorflow2_mnist", "mxnet_mnist")
BLOCKED = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")

IMAGENET = ["--depth", "18", "--num-filters", "4", "--image-size", "32",
            "--num-classes", "4", "--num-examples", "16", "--batch-size",
            "2"]
SYNTH = ["--model", "resnet18", "--batch-size", "2", "--image-size", "32",
         "--num-warmup-batches", "1", "--num-batches-per-iter", "1",
         "--num-iters", "1"]
MNIST_STEPS = 48  # 6 epochs of 8 batches
HIER_STEPS = 2
# each launch of the shared runs and the launches that must have ended
# before it starts ("here": this process's own runs). The port's and the
# JAX job wait for each other's first legs, so they start together; the
# rest follow, so that at most six ranks run at once beside the suite's
# other workers (twelve when all started together).
STAGES = {"jax": (), "port": (), "classic": ("here",),
          "jax_hier": ("jax",),
          **{f"hier{r}": ("port", "jax_hier") for r in range(4)}}


# ---- a torch-backed gluon sliver over fake_mxnet --------------------------

def install_fake_gluon():
    """``fake_mxnet`` (the adapter's NDArray, Parameter, Trainer) plus what
    ``mxnet_mnist.py`` drives: ``mx.cpu``, ``mx.init.Xavier``,
    ``gluon.nn`` (HybridSequential, Conv2D, MaxPool2D, Flatten, Dense with
    shapes deferred to the first forward, as gluon's are),
    ``gluon.loss.SoftmaxCrossEntropyLoss``, ``autograd.record`` and an SGD
    with momentum behind ``Trainer(params, "sgd", {...})``. The layers
    compute in torch; a backward writes each parameter's gradient into its
    ``list_grad()``. Weights are drawn from a fixed seed, the same on
    every rank and in either package's process."""
    import types

    import torch
    import torch.nn.functional as F

    import fake_mxnet
    mx = fake_mxnet.install()
    if hasattr(mx, "autograd"):
        return mx

    class Tensor:
        """A forward value: a torch tensor with the NDArray reads."""

        def __init__(self, t):
            self.t = t

        def mean(self):
            return Tensor(self.t.mean())

        def asscalar(self):
            return float(self.t.detach())

        def backward(self):
            self.t.sum().backward()
            for p, t in _live:
                p.list_grad()[0][:] = t.grad.numpy()
            _live.clear()

    _live = []  # (Parameter, leaf tensor) of the recorded forward
    gen = torch.Generator().manual_seed(0)

    def value(x):
        return x.t if isinstance(x, Tensor) else torch.from_numpy(
            x.asnumpy())

    class Block:
        def __init__(self, activation=None):
            self.activation = activation
            self.params = {}

        def param(self, name, shape, fan_in, fan_out):
            p = self.params[name]
            if p._data is None:  # deferred init: the engine shapes it
                limit = (6.0 / (fan_in + fan_out)) ** 0.5
                w = (torch.rand(shape, generator=gen) * 2 - 1) * limit
                p._finish_deferred_init(
                    (w if name == "weight" else torch.zeros(shape)).numpy())
            t = torch.from_numpy(p.data().asnumpy()).requires_grad_()
            _live.append((p, t))
            return t

        def act(self, y):
            return F.relu(y) if self.activation == "relu" else y

    class Conv2D(Block):
        def __init__(self, channels, kernel_size, activation=None):
            super().__init__(activation)
            self.c, self.k = channels, kernel_size
            self.params = {"weight": fake_mxnet.Parameter("weight"),
                           "bias": fake_mxnet.Parameter("bias")}

        def __call__(self, x):
            x = value(x)
            cin = x.shape[1]
            w = self.param("weight", (self.c, cin, self.k, self.k),
                           cin * self.k ** 2, self.c * self.k ** 2)
            b = self.param("bias", (self.c,), 1, 1)
            return Tensor(self.act(F.conv2d(x, w, b)))

    class Dense(Block):
        def __init__(self, units, activation=None):
            super().__init__(activation)
            self.units = units
            self.params = {"weight": fake_mxnet.Parameter("weight"),
                           "bias": fake_mxnet.Parameter("bias")}

        def __call__(self, x):
            x = value(x).flatten(1)
            w = self.param("weight", (self.units, x.shape[1]), x.shape[1],
                           self.units)
            b = self.param("bias", (self.units,), 1, 1)
            return Tensor(self.act(F.linear(x, w, b)))

    class MaxPool2D(Block):
        def __init__(self, pool_size=2):
            super().__init__()
            self.size = pool_size

        def __call__(self, x):
            return Tensor(F.max_pool2d(value(x), self.size))

    class Flatten(Block):
        def __call__(self, x):
            return Tensor(value(x).flatten(1))

    class ParameterDict:
        def __init__(self, items):
            self._items = items

        def items(self):
            return list(self._items)

        def __iter__(self):
            return iter(p for _, p in self._items)

    class HybridSequential:
        def __init__(self):
            self.layers = []

        def add(self, *layers):
            self.layers += layers

        def initialize(self, init=None, ctx=None):
            pass

        def hybridize(self):
            pass

        def collect_params(self):
            return ParameterDict(
                (f"{i}_{name}", p) for i, layer in enumerate(self.layers)
                for name, p in layer.params.items())

        def __call__(self, x):
            for layer in self.layers:
                x = layer(x)
            return x

    class SoftmaxCrossEntropyLoss:
        def __call__(self, out, y):
            return Tensor(F.cross_entropy(value(out), value(y).long(),
                                          reduction="none"))

    class SGD(fake_mxnet.Optimizer):
        def __init__(self, learning_rate=0.01, momentum=0.0):
            super().__init__(learning_rate)
            self.momentum, self.mom = momentum, {}

        def update(self, index, weight, grad, state):
            m = self.momentum * self.mom.get(index, 0.0) \
                - self.lr * grad.asnumpy()
            self.mom[index] = m
            weight[:] = weight.asnumpy() + m

    class Trainer(fake_mxnet.Trainer):
        def __init__(self, params, optimizer, optimizer_params=None,
                     kvstore=None):
            if optimizer == "sgd":
                optimizer = SGD(**(optimizer_params or {}))
            super().__init__(params, optimizer, kvstore=kvstore)

    @contextlib.contextmanager
    def record():
        _live.clear()
        yield

    fake_mxnet.NDArray.as_in_context = lambda self, ctx: self
    mx.cpu = lambda *a: "cpu"
    mx.init = types.SimpleNamespace(Xavier=lambda *a, **k: None)
    mx.autograd = types.SimpleNamespace(record=record)
    mx.gluon.Trainer = Trainer
    mx.gluon.nn = types.SimpleNamespace(
        HybridSequential=HybridSequential, Conv2D=Conv2D,
        MaxPool2D=MaxPool2D, Flatten=Flatten, Dense=Dense)
    mx.gluon.loss = types.SimpleNamespace(
        SoftmaxCrossEntropyLoss=SoftmaxCrossEntropyLoss)
    sys.modules["mxnet.autograd"] = mx.autograd
    return mx


# ---- the workers (this file run as a script) -----------------------------

def _unflatten(npz):
    """A flax tree from ``np.savez`` keys ``a/b/c``."""
    tree = {}
    for key in npz.files:
        node = tree
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = npz[key]
    return tree


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def carry_weights(module, path):
    """Make ``module.build_model`` load the flax parameters at ``path``
    (JAX's initial weights) into the model it builds; its BatchNorm
    statistics keep their initial values, which are flax's. Returns the
    builder it replaced."""
    from horovod_tpu_torch import convert
    with np.load(path) as npz:
        tree = _unflatten(npz)
    build = module.build_model

    def build_model(*args, **kwargs):
        model = build(*args, **kwargs)
        missing, unexpected = model.load_state_dict(
            convert.params_from_flax(tree, model), strict=False)
        assert not unexpected and all(
            k.endswith(("running_mean", "running_var",
                        "num_batches_tracked")) for k in missing), missing
        return model
    module.build_model = build_model
    return build


def jax_dropout(path, rank_of):
    """Make ``models.simple.dropout`` draw JAX's masks from ``path``
    (``[step, data rank, rows, features]``), one step a call. Returns
    the function it replaced."""
    import torch

    from horovod_tpu_torch.models import simple
    with np.load(path) as npz:
        masks = npz["masks"]
    calls = [0]

    def dropout(x, rate, generator=None):
        keep = torch.from_numpy(masks[calls[0], rank_of()]).to(x.device)
        calls[0] += 1
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))
    plain, simple.dropout = simple.dropout, dropout
    return plain


@contextlib.contextmanager
def jax_start(module, job, rank_of):
    """``module``'s driver built from JAX's weights (``job["weights"]``)
    and drawing JAX's dropout masks (``job["masks"]``), for the job."""
    from horovod_tpu_torch.models import simple
    build, dropout = getattr(module, "build_model", None), None
    if "weights" in job:
        carry_weights(module, job["weights"])
    if job.get("fp32"):
        import torch
        built = module.build_model

        def build_fp32(*args, **kwargs):
            model = built(*args, **kwargs)
            model.dtype = torch.float32
            return model
        module.build_model = build_fp32
    if "masks" in job:
        dropout = jax_dropout(job["masks"], rank_of)
    try:
        yield
    finally:
        if build is not None:
            module.build_model = build
        if dropout is not None:
            simple.dropout = dropout


@contextlib.contextmanager
def jax_fp32(on):
    """The JAX package's ResNets computing in fp32 (their default is
    bf16), while ``on``."""
    if not on:
        yield
        return
    import functools

    import jax.numpy as jnp

    from horovod_tpu import models
    names = ("ResNet18", "ResNet50", "ResNet101")
    saved = {n: getattr(models, n) for n in names}
    for n in names:
        setattr(models, n, functools.partial(saved[n], dtype=jnp.float32))
    try:
        yield
    finally:
        for n in names:
            setattr(models, n, saved[n])


@contextlib.contextmanager
def jax_losses(sink):
    """Record the per-step losses of ``jax_imagenet_resnet50.py``: at each
    epoch's end it averages the list of its steps' losses with
    ``np.mean``, whose list arguments land in ``sink`` (a callback inside
    its jitted step would keep the step out of JAX's compilation
    cache)."""
    mean = np.mean

    def recorded(a, *args, **kwargs):
        if isinstance(a, list) and all(isinstance(x, float) for x in a):
            sink.extend(a)
        return mean(a, *args, **kwargs)
    np.mean = recorded
    try:
        yield
    finally:
        np.mean = mean


@contextlib.contextmanager
def momentum_dumps(prefix, rank_of):
    """While on, dump the SGD momentum of every named parameter (torch
    layout) right after ``checkpoint.restore_or_init``
    (``<prefix>.restored.rank<r>.npz``) and at each
    ``checkpoint.save_checkpoint`` (``<prefix>.saved<step>.rank<r>.npz``),
    the optimizer's own buffers as the driver holds them; ``rank_of()``
    names the rank."""
    from horovod_tpu_torch import checkpoint
    restore, save = checkpoint.restore_or_init, checkpoint.save_checkpoint

    def dump(path, model, opt):
        np.savez(path, **{
            name: opt.state[p]["momentum_buffer"].detach().cpu().numpy()
            for name, p in model.named_parameters()
            if "momentum_buffer" in opt.state.get(p, {})})

    def restored(directory, model, optimizer=None):
        out = restore(directory, model, optimizer)
        dump(f"{prefix}.restored.rank{rank_of()}.npz", model, optimizer)
        return out

    def saved(directory, step, model, optimizer=None, **kwargs):
        dump(f"{prefix}.saved{step}.rank{rank_of()}.npz", model,
             optimizer)
        return save(directory, step, model, optimizer, **kwargs)
    checkpoint.restore_or_init, checkpoint.save_checkpoint = restored, saved
    try:
        yield
    finally:
        checkpoint.restore_or_init, checkpoint.save_checkpoint = restore, save


def _run_job(side, job):
    """One job of a worker: a port driver's ``main(argv)``, or a JAX
    twin run as ``python examples/<file>`` runs it. Returns its record:
    stdout, ``main``'s return value, the error, seconds."""
    import importlib
    import runpy
    old_env = dict(os.environ)
    os.environ.update(job.get("env", {}))
    out = io.StringIO()
    rec = {"ret": None, "error": None}
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            if side == "port":
                from horovod_tpu_torch import basics
                mod = importlib.import_module(
                    f"horovod_tpu_torch.examples.{job['driver']}")
                dumps = momentum_dumps(job["dump"], basics.rank) \
                    if "dump" in job else contextlib.nullcontext()
                with jax_start(mod, job, basics.rank), dumps:
                    ret = mod.main(job["argv"])
                # what a driver returns for its caller's use (a model,
                # its step and batch) stays out of the record
                rec["ret"] = {k: v for k, v in ret.items()
                              if k not in ("model", "step", "batch")}
            else:
                path = os.path.join(REPO, "examples", job["driver"])
                sys.argv = [path] + job["argv"]
                sink = []
                with jax_fp32(job.get("fp32")), jax_losses(sink):
                    runpy.run_path(path, run_name="__main__")
                rec["ret"] = {"losses": sink}
    except BaseException:  # recorded; the worker reports it and stops
        rec["error"] = traceback.format_exc()
    finally:
        os.environ.clear()
        os.environ.update(old_env)
    rec["stdout"] = out.getvalue()
    rec["s"] = time.perf_counter() - t0
    return rec


def _wait(path, timeout=240.0):
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.05)


def worker(side, config_path):
    """Run the jobs of ``config_path`` in turn on this rank: ``port`` with
    JAX and the JAX package made unimportable; ``jax`` the JAX twins.
    The classic job, which has TensorFlow loaded already, then imports
    every driver. Writes ``<tag>.rank<r>.json``."""
    with open(config_path) as f:
        cfg = json.load(f)
    if side == "port":
        for name in BLOCKED:
            sys.modules[name] = None
    sys.path.insert(0, TESTS)
    install_fake_gluon()
    rank = int(os.environ.get("HOROVOD_RANK", "0"))
    results, imported = {}, []
    for job in cfg["jobs"]:
        if "copy" in job:  # an unbroken run's file, the other's first leg
            if rank == 0:
                os.makedirs(job["copy"][1])
                shutil.copy(*job["copy"])
        elif "mark" in job:
            if rank == 0:
                open(job["mark"], "w").close()
        elif "wait" in job:
            _wait(job["wait"])
        else:
            results[job["name"]] = rec = _run_job(side, job)
            if rec["error"] is not None:
                # stop here: the launcher ends the other ranks, which
                # would wait in a collective this rank never joins
                sys.stderr.write(f"{job['name']}: {rec['error']}\n")
                return 1
    if cfg["tag"] == "classic":
        import importlib
        for d in DRIVERS:
            importlib.import_module(f"horovod_tpu_torch.examples.{d}")
            imported.append(d)
    loaded = sorted(m for m, v in sys.modules.items()
                    if v is not None and m.split(".")[0] in BLOCKED)
    with open(os.path.join(cfg["out"], f"{cfg['tag']}.rank{rank}.json"),
              "w") as f:
        json.dump({"results": results, "imported": imported,
                   "loaded": loaded}, f)
    return 0


# ---- the JAX side in this process -----------------------------------------

def _jax_tree_file(path, model, sample):
    import jax
    variables = model.init(jax.random.PRNGKey(0), sample, train=False)
    np.savez(path, **_flatten(variables["params"]))
    return str(path)


def _jax_masks(path, steps, ranks, rows=16, features=128):
    """The keep masks of flax's ``Dropout(0.5)`` in ``MNISTConvNet``
    (top-level ``Dropout_0``) at each step and data rank of JAX's train
    step: the key folds the step, then the rank, into ``PRNGKey(0)``."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    class Drop(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return fnn.Dropout(0.5, deterministic=False)(x)

    ones = jnp.ones((rows, features))
    apply = jax.jit(lambda key: Drop().apply(
        {}, ones, rngs={"dropout": key}) != 0)
    base = jax.random.PRNGKey(0)
    masks = np.stack([np.stack([
        np.asarray(apply(jax.random.fold_in(jax.random.fold_in(base, s), r)))
        for r in range(ranks)]) for s in range(steps)])
    np.savez(path, masks=masks)
    return str(path)


def _jax_mnist(ndev):
    """``examples/jax_mnist.py`` on ``ndev`` of this process's virtual
    devices; returns its stdout and every step's loss."""
    import runpy

    import jax

    import horovod_tpu as hvd_j
    from horovod_tpu import training as jtraining
    losses = []
    make = jtraining.make_train_step

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)

        def run(state, x, y):
            state, loss = step(state, x, y)
            losses.append(float(loss))
            return state, loss
        return run

    hvd_j.shutdown()
    hvd_j.init(devices=jax.devices()[:ndev])
    out = io.StringIO()
    jtraining.make_train_step = recording
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(os.path.join(REPO, "examples", "jax_mnist.py"),
                           run_name="__main__")
    finally:
        jtraining.make_train_step = make
        hvd_j.shutdown()
    return out.getvalue(), losses


@contextlib.contextmanager
def _port_in_process(threads=2):
    import torch

    import horovod_tpu_torch as hvd_t
    n = torch.get_num_threads()
    torch.set_num_threads(threads)
    hvd_t.shutdown()
    try:
        yield
    finally:
        hvd_t.shutdown()
        torch.set_num_threads(n)


def _port_main(driver, argv):
    import importlib
    out = io.StringIO()
    mod = importlib.import_module(f"horovod_tpu_torch.examples.{driver}")
    with contextlib.redirect_stdout(out):
        ret = mod.main(argv)
    return out.getvalue(), ret


# ---- the shared runs ------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, TESTS] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               TF_CPP_MIN_LOG_LEVEL="3", TF_NUM_INTRAOP_THREADS="1",
               TF_NUM_INTEROP_THREADS="1", **extra)
    return env


def _start(cmd, log, env):
    # a session of its own: a kill reaches the launcher's ranks too
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log,
                            stderr=subprocess.STDOUT, start_new_session=True)


def _configs(root):
    """The jobs of the shared launches: ``port`` (the port's 2-rank
    drivers), ``classic`` (the classic drivers over the port's adapters),
    ``jax`` (the JAX twins) and ``hier`` (the 4-rank hierarchical run).
    The weight files are written by the fixture after the launches start;
    ``weights.done`` marks them written. An ImageNet run's first leg is
    its unbroken run's epoch-1 file, copied to a directory of its own."""
    ck = {k: str(root / f"ck_{k}") for k in ("j4", "j8", "p4", "p8")}
    im = {k: str(root / f"im_{k}") for k in ("j1", "j2", "p1", "p2", "ps")}
    done = {k: str(root / f"{k}.done") for k in ("port", "jax", "weights")}
    for d in ("keras", "tf2"):  # the drivers' CKPT_DIR exists, as theirs
        (root / d).mkdir()
    cpu = ["--device", "cpu"]
    weights = {k: str(root / f"{k}.npz")
               for k in ("imagenet", "mnist", "hier", "masks")}

    def ckpt(d, epochs):
        return ["--ckpt-dir", d, "--epochs", str(epochs)]

    def imnet(name, d, epochs, side="port"):
        job = dict(name=name, driver="imagenet_resnet50", fp32=True,
                   argv=IMAGENET + ["--ckpt-dir", d, "--epochs",
                                    str(epochs)])
        if side == "port":
            job.update(argv=job["argv"] + cpu, weights=weights["imagenet"],
                       dump=str(root / f"mom_{name}"))
        else:
            job.update(driver="jax_imagenet_resnet50.py")
        return job

    port = [
        dict(name="ckpt_leg1", driver="checkpoint_resume",
             argv=ckpt(ck["p4"], 4) + cpu),
        dict(name="ckpt_unbroken", driver="checkpoint_resume",
             argv=ckpt(ck["p8"], 8) + cpu),
        dict(wait=done["weights"]),
        imnet("imagenet_unbroken", im["p2"], 2),
        dict(copy=[os.path.join(im["p2"], "ckpt-1.msgpack"), im["p1"]]),
        dict(mark=done["port"]),
        dict(name="mnist", driver="mnist", argv=cpu,
             weights=weights["mnist"], masks=weights["masks"]),
        dict(name="synthetic", driver="synthetic_benchmark",
             argv=SYNTH + cpu),
        dict(copy=[os.path.join(im["p2"], "ckpt-1.msgpack"), im["ps"]]),
        imnet("imagenet_self", im["ps"], 2),
        dict(wait=done["jax"]),
        dict(name="ckpt_leg2", driver="checkpoint_resume",
             argv=ckpt(ck["j4"], 8) + cpu),
        imnet("imagenet_leg2", im["j1"], 2),
    ]
    classic = [
        dict(name="pytorch_mnist", driver="pytorch_mnist", argv=cpu),
        dict(name="pytorch_synthetic", driver="pytorch_synthetic_benchmark",
             argv=["--num-iters", "2", "--num-batches-per-iter", "3"] + cpu),
        dict(name="mxnet_mnist", driver="mxnet_mnist",
             argv=["--epochs", "1", "--samples", "64"]),
        dict(name="keras_leg1", driver="tensorflow2_keras_mnist",
             argv=["--epochs", "1", "--samples", "64"],
             env={"CKPT_DIR": str(root / "keras")}),
        dict(name="keras_leg2", driver="tensorflow2_keras_mnist",
             argv=["--epochs", "2", "--samples", "64"],
             env={"CKPT_DIR": str(root / "keras")}),
        dict(name="tf2_mnist", driver="tensorflow2_mnist",
             argv=["--steps", "12"], env={"CKPT_DIR": str(root / "tf2")}),
    ]
    jax = [
        dict(name="ckpt_leg1", driver="jax_checkpoint_resume.py",
             argv=ckpt(ck["j4"], 4)),
        dict(name="ckpt_unbroken", driver="jax_checkpoint_resume.py",
             argv=ckpt(ck["j8"], 8)),
        imnet("imagenet_unbroken", im["j2"], 2, "jax"),
        dict(copy=[os.path.join(im["j2"], "ckpt-1.msgpack"), im["j1"]]),
        dict(mark=done["jax"]),
        dict(name="pytorch_mnist", driver="pytorch_mnist.py", argv=[]),
        dict(name="mxnet_mnist", driver="mxnet_mnist.py",
             argv=["--epochs", "1", "--samples", "64"]),
        dict(wait=done["port"]),
        dict(name="ckpt_leg2", driver="jax_checkpoint_resume.py",
             argv=ckpt(ck["p4"], 8)),
        imnet("imagenet_leg2", im["p1"], 2, "jax"),
    ]
    hier = [dict(wait=done["weights"]),
            dict(name="hierarchical", driver="hierarchical_allreduce",
                 argv=["--slices", "2", "--steps", str(HIER_STEPS)] + cpu,
                 weights=weights["hier"])]
    return dict(port=port, classic=classic, jax=jax, hier=hier), weights, \
        done["weights"]


def _write(root, tag, jobs):
    path = root / f"{tag}.json"
    path.write_text(json.dumps({"jobs": jobs, "out": str(root),
                                "tag": tag}))
    return str(path)


def _read(root, tag, ranks, procs_log):
    out = []
    for r in range(ranks):
        path = root / f"{tag}.rank{r}.json"
        assert path.exists(), procs_log()
        out.append(json.loads(path.read_text()))
    return out


@pytest.fixture()
def runs(tmp_path_factory):
    """Every run the tests read, in stages (``STAGES``)."""
    root = tmp_path_factory.mktemp("examples")
    jobs, weights, weights_done = _configs(root)
    script = os.path.abspath(__file__)
    hier_cfg, master = _write(root, "hier", jobs["hier"]), str(_free_port())
    commands = {
        "jax": ([sys.executable, "-m", "horovod_tpu.run", "-np", "2",
                 sys.executable, script, "jax",
                 _write(root, "jax", jobs["jax"])], _env()),
        "jax_hier": ([sys.executable, os.path.join(
            REPO, "examples", "jax_hierarchical_allreduce.py"),
            "--slices", "2", "--steps", str(HIER_STEPS)],
            _env(XLA_FLAGS="--xla_force_host_platform_device_count=4")),
        **{tag: ([sys.executable, "-m", "horovod_tpu_torch.run", "-np", "2",
                  sys.executable, script, "port",
                  _write(root, tag, jobs[tag])], _env())
           for tag in ("port", "classic")},
        # two hosts of two ranks, the launcher's environment
        **{f"hier{r}": ([sys.executable, script, "port", hier_cfg],
                        _env(HOROVOD_RANK=str(r), HOROVOD_SIZE="4",
                             HOROVOD_LOCAL_RANK=str(r % 2),
                             HOROVOD_LOCAL_SIZE="2",
                             HOROVOD_CROSS_RANK=str(r // 2),
                             HOROVOD_CROSS_SIZE="2",
                             MASTER_ADDR="127.0.0.1", MASTER_PORT=master))
           for r in range(4)},
    }
    logs, procs = {}, {}

    def launch(name):
        logs[name] = open(root / f"{name}.log", "w+")
        cmd, env = commands[name]
        procs[name] = _start(cmd, logs[name], env)

    def procs_log():
        text = []
        for name, log in logs.items():
            log.seek(0)
            text.append(f"--- {name}\n{log.read()[-3000:]}")
        return "\n".join(text)

    res = {}
    try:
        for name, after in STAGES.items():
            if not after:
                launch(name)

        # in this process meanwhile: JAX's initial weights and dropout
        # masks, then JAX's MNIST at 1 and 2 devices, the port's at world
        # 1 and the synthetic benchmark at world 1
        import jax.numpy as jnp

        from horovod_tpu import models as jmodels
        _jax_tree_file(weights["imagenet"],
                       jmodels.ResNet18(num_classes=4, num_filters=4),
                       jnp.zeros((1, 32, 32, 3)))
        _jax_tree_file(weights["hier"],
                       jmodels.ResNet18(num_classes=10, dtype=jnp.float32),
                       jnp.zeros((1, 32, 32, 3)))
        _jax_tree_file(weights["mnist"], jmodels.MNISTConvNet(),
                       jnp.zeros((1, 28, 28, 1)))
        _jax_masks(weights["masks"], MNIST_STEPS, 2)
        open(weights_done, "w").close()
        res["jax_mnist"] = {d: _jax_mnist(d) for d in (1, 2)}
        with _port_in_process():
            import importlib
            mnist = importlib.import_module(
                "horovod_tpu_torch.examples.mnist")
            job = dict(weights=weights["mnist"], masks=weights["masks"])
            with jax_start(mnist, job, lambda: 0):
                res["port_mnist1"] = _port_main("mnist", ["--device", "cpu"])
        with _port_in_process():
            res["synthetic1"] = _port_main("synthetic_benchmark",
                                           SYNTH + ["--device", "cpu"])
        deadline = time.monotonic() + 300
        while True:
            codes = {n: p.poll() for n, p in procs.items()}
            if len(procs) == len(STAGES) and None not in codes.values():
                break
            bad = {n: c for n, c in codes.items() if c not in (None, 0)}
            assert not bad, f"{bad}\n{procs_log()}"
            assert time.monotonic() < deadline, f"timed out\n{procs_log()}"
            for name, after in STAGES.items():
                if name not in procs and all(
                        codes.get(d) == 0 for d in after if d != "here"):
                    launch(name)
            time.sleep(0.1)
        bad = {n: p.returncode for n, p in procs.items() if p.returncode}
        assert not bad, f"{bad}\n{procs_log()}"
    finally:
        for p in procs.values():
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    for tag, ranks in (("port", 2), ("classic", 2), ("jax", 2), ("hier", 4)):
        res[tag] = _read(root, tag, ranks, procs_log)
    logs["jax_hier"].seek(0)
    res["jax_hier"] = logs["jax_hier"].read()
    for log in logs.values():
        log.close()
    res["root"] = root
    return res


# ---- the tests ------------------------------------------------------------

def _records(side, name):
    """Every rank's record of job ``name``; each must have succeeded."""
    recs = [rank["results"][name] for rank in side]
    for r, rec in enumerate(recs):
        assert rec["error"] is None, f"rank {r}: {rec['error']}"
    return recs


def _epoch_losses(text):
    return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"^epoch (\d+): loss ([0-9.]+)", text, re.M)}


def _rel(a, b):
    return abs(a - b) / abs(b)


def check_checkpoint_resume(runs, first):
    """One package's first leg (4 epochs) resumed to 8 by the other: the
    second leg announces the step and meta the first saved; its first
    loss, a function of the saved state alone, is within rtol 1e-6 of
    the writer's unbroken 8-epoch run (the file crosses exactly), and
    every loss of the two legs within rtol 1e-5 of it. torch's Adam
    computes its bias corrections in float64 and optax in float32
    (1 - 0.999 in float32 is 1.3e-5 off), so the two packages' steps
    part by about 1e-6 of the loss an epoch after the crossing."""
    second = "port" if first == "jax" else "jax"
    leg1 = _records(runs[first], "ckpt_leg1")[0]["stdout"]
    leg2 = _records(runs[second], "ckpt_leg2")[0]["stdout"]
    unbroken = _records(runs[first], "ckpt_unbroken")[0]["stdout"]
    assert "resuming from step 4 (meta={'epoch': 4})" in leg2
    got = {**_epoch_losses(leg1), **_epoch_losses(leg2)}
    want = _epoch_losses(unbroken)
    assert sorted(got) == sorted(want) == list(range(1, 9))
    gaps = {e: _rel(got[e], want[e]) for e in want}
    print(f"checkpoint_resume {first} -> {second}: relative gaps {gaps}")
    assert all(got[e] == want[e] for e in range(1, 5)), (got, want)
    assert gaps[5] <= 1e-6, (got, want)
    assert max(gaps.values()) <= 1e-5, (got, want)
    assert "done; max |w - w_true|" in leg2


def check_mnist(runs, ndev):
    """``mnist`` against ``jax_mnist.py`` from JAX's weights and dropout
    masks: one port rank against one JAX device, two ranks under
    hvdrun-torch against two virtual devices. The first epoch's mean
    loss within rtol 1e-5, every epoch's within rtol 1e-5 plus 2e-5:
    the loss falls to 2e-3 to 2e-2, where a float32 cross-entropy of
    confident logits is exact to about 1e-6 a value and the two Adams'
    bias corrections (float64 against float32) part the runs by a few
    1e-6 (measured 7.1e-6 at most). Both print six epochs and "done"."""
    j_out, j_losses = runs["jax_mnist"][ndev]
    want = np.asarray(j_losses).reshape(6, -1).mean(axis=1)
    if ndev == 1:
        out, ret = runs["port_mnist1"]
    else:
        rec = _records(runs["port"], "mnist")[0]
        out, ret = rec["stdout"], rec["ret"]
    got = np.asarray(ret["epoch_losses"])
    print(f"mnist D {ndev}: largest gap {np.max(np.abs(got - want)):.3g}")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)
    for text in (out, j_out):
        assert len(re.findall(r"^epoch \d: loss [0-9.]+$", text, re.M)) == 6
        assert text.rstrip().endswith("done")


def _momentum(root, name, rank):
    with np.load(root / f"mom_{name}.rank{rank}.npz") as npz:
        return {k: npz[k] for k in npz.files}


def _file_momentum(path):
    """The SGD trace of a checkpoint file (``optax.sgd``'s
    ``(TraceState(trace), EmptyState())``), read with flax and put in the
    port's layout through ``convert.params_from_flax``, the parameters'
    own mapping."""
    from flax import serialization

    from horovod_tpu_torch import convert, models
    with open(path, "rb") as f:
        state = serialization.msgpack_restore(f.read())
    assert sorted(state["opt_state"]) == ["0", "1"], state["opt_state"]
    assert state["opt_state"]["1"] == {}, state["opt_state"]["1"]
    model = models.ResNet18(num_classes=4, num_filters=4, device="cpu")
    trace = convert.params_from_flax(state["opt_state"]["0"]["trace"], model)
    return {k: v.numpy() for k, v in trace.items()}


def _same_momentum(got, want):
    """Bit for bit, every parameter, and not the zeros a lost trace
    restores as."""
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert all(np.any(v != 0) for v in want.values())


def check_imagenet_resnet50(runs, first):
    """One package's epoch-1 checkpoint (its unbroken run's first file)
    resumed by the other, both in fp32 here (at bf16 the two packages'
    convolutions round apart): the disjoint-shard line and the resume
    line; the port's first step from JAX's initial weights within rtol
    1e-4 of JAX's; the first step after the resume, a function of the
    saved parameters and the cursor's batch, within rtol 1e-3 of the same
    step of the writer's unbroken run. At this size the last BatchNorm
    normalizes two 1x1 maps a rank: flax takes their variance as
    E[x^2] - E[x]^2 and torch in two passes, which parts a loss by up to
    1.8e-4 from the same weights, and later steps are not held across
    packages: JAX against itself from weights moved by 1e-7 parts by
    14 % within 4 steps.

    The losses cannot see the SGD momentum (the first step's loss is
    taken before the step), so the momentum is held leaf by leaf, bit
    for bit: JAX's file's trace is what the port's optimizer holds right
    after its restore, on both ranks; the port's file's trace is what the
    port's optimizer held at the save. Each trace goes through
    ``convert.params_from_flax`` (the parameters' mapping), not through
    the optimizer-state mapping under test."""
    second = "port" if first == "jax" else "jax"
    leg2 = _records(runs[second], "imagenet_leg2")
    unbroken = _records(runs[first], "imagenet_unbroken")
    for recs in (leg2, unbroken):
        assert "(16 examples/epoch across 2 ranks)" in recs[0]["stdout"]
        assert all(f"rank {r} done" in rec["stdout"]
                   for r, rec in enumerate(recs))
    assert "resuming from epoch 1" in leg2[0]["stdout"]
    for r in range(2):
        want = unbroken[r]["ret"]["losses"]
        got = leg2[r]["ret"]["losses"]
        assert len(want) == 8 and len(got) == 4, (got, want)
        assert _rel(got[0], want[4]) <= 1e-3, (got, want)
    port = _records(runs["port"], "imagenet_unbroken")[0]["ret"]["losses"]
    jax = _records(runs["jax"], "imagenet_unbroken")[0]["ret"]["losses"]
    assert _rel(port[0], jax[0]) <= 1e-4, (port, jax)
    root = runs["root"]
    if first == "jax":
        want = _file_momentum(root / "im_j1" / "ckpt-1.msgpack")
        for r in range(2):
            _same_momentum(_momentum(root, "imagenet_leg2.restored", r),
                           want)
    else:
        _same_momentum(_file_momentum(root / "im_p1" / "ckpt-1.msgpack"),
                       _momentum(root, "imagenet_unbroken.saved1", 0))
    e2 = (_epoch_losses(leg2[0]["stdout"])[2],
          _epoch_losses(unbroken[0]["stdout"])[2])
    print(f"imagenet {first} -> {second}: resumed step "
          f"{leg2[0]['ret']['losses'][0]} against "
          f"{unbroken[0]['ret']['losses'][4]}; epoch 2 {e2[0]} against "
          f"{e2[1]}")


def check_imagenet_resumes_itself(runs):
    """The port resuming its own epoch-1 checkpoint (a copy of the
    unbroken run's first file) runs epoch 2 bit for bit as the unbroken
    run did: all four steps' losses on both ranks and the printed epoch
    loss. Steps 2-4 take the restored momentum, so a restore that
    dropped, zeroed or misplaced it parts them; the momentum right after
    the restore is also held bit for bit to the one at the save."""
    resumed = _records(runs["port"], "imagenet_self")
    unbroken = _records(runs["port"], "imagenet_unbroken")
    assert "resuming from epoch 1" in resumed[0]["stdout"]
    for r in range(2):
        got, want = resumed[r]["ret"]["losses"], \
            unbroken[r]["ret"]["losses"]
        assert got == want[4:], (r, got, want)
        _same_momentum(_momentum(runs["root"], "imagenet_self.restored", r),
                       _momentum(runs["root"], "imagenet_unbroken.saved1",
                                 0))
    assert _epoch_losses(resumed[0]["stdout"])[2] == \
        _epoch_losses(unbroken[0]["stdout"])[2]


def check_hierarchical_allreduce(runs):
    """4 gloo ranks as 2 hosts of 2 against JAX's 4-device (2, 2) mesh:
    the same mesh line, the first and last loss within rtol 1e-4."""
    recs = _records(runs["hier"], "hierarchical")
    out = recs[0]["stdout"]
    mesh = ("mesh axes {'dcn': 2, 'data': 2} -> reduce-scatter over "
            "'data' (ICI), allreduce over 'dcn' (DCN)")
    assert mesh in out and mesh in runs["jax_hier"]
    pat = r"done: loss ([0-9.]+) -> ([0-9.]+) over \{'dcn': 2, 'data': 2\}"
    got, want = re.search(pat, out), re.search(pat, runs["jax_hier"])
    assert got and want, (out, runs["jax_hier"][-2000:])
    for g, w in zip(got.groups(), want.groups()):
        assert _rel(float(g), float(w)) <= 1e-4, (got.group(0),
                                                  want.group(0))
    assert all(rec["ret"]["losses"] == recs[0]["ret"]["losses"]
               for rec in recs)


def check_synthetic_benchmark(runs, world):
    """A tiny ``synthetic_benchmark`` run prints the lines of
    ``jax_synthetic_benchmark.py``, with finite rates."""
    if world == 1:
        out, ret = runs["synthetic1"]
    else:
        rec = _records(runs["port"], "synthetic")[0]
        out, ret = rec["stdout"], rec["ret"]
    pats = [rf"Model: resnet18, batch 2/chip x {world} chips \(cpu\)",
            r"Iter #0: [0-9.]+ img/sec total",
            r"Img/sec per chip: [0-9.]+ \+- [0-9.]+",
            rf"Total img/sec on {world} chip\(s\): [0-9.]+ \+- [0-9.]+"]
    lines = out.strip().splitlines()
    assert len(lines) == len(pats), out
    for line, pat in zip(lines, pats):
        assert re.fullmatch(pat, line), (line, pat)
    assert len(ret["img_secs"]) == 1
    assert all(np.isfinite(r) and r > 0 for r in ret["img_secs"])


def check_classic_driver(runs, driver):
    """Each classic driver over the port's adapter on 2 ranks under
    hvdrun-torch. ``pytorch_mnist`` and ``mxnet_mnist`` print what their
    JAX-package twins print under the JAX launcher, line for line
    (seeded weights, the same host ring sums); the others are held to
    what ``tests/test_examples.py`` asserts of their twins."""
    port = runs["classic"]
    if driver in ("pytorch_mnist", "mxnet_mnist"):
        got = [r["stdout"] for r in _records(port, driver)]
        want = [r["stdout"] for r in _records(runs["jax"], driver)]
        assert got == want
        assert got[0].count("epoch") == (4 if driver == "pytorch_mnist"
                                         else 1)
        assert got[0].rstrip().endswith("done")
    elif driver == "pytorch_synthetic_benchmark":
        outs = [r["stdout"] for r in _records(port, "pytorch_synthetic")]
        assert all(text.rstrip().endswith("done") for text in outs)
        assert re.search(r"^Total img/sec on 2 processes: [0-9.]+$",
                         outs[0], re.M)
        assert len(re.findall(r"^Iter #\d: [0-9.]+ img/sec per process$",
                              outs[0], re.M)) == 2
    elif driver == "tensorflow2_keras_mnist":
        leg1 = [r["stdout"] for r in _records(port, "keras_leg1")]
        leg2 = [r["stdout"] for r in _records(port, "keras_leg2")]
        assert all(text.rstrip().endswith("done") for text in leg1 + leg2)
        assert "checkpoints: ['ckpt-1.keras']" in leg1[0]
        assert "resuming from epoch 1" in leg2[0]
        assert "'ckpt-2.keras'" in leg2[0]
    else:
        outs = [r["stdout"] for r in _records(port, "tf2_mnist")]
        assert all(text.rstrip().endswith("done") for text in outs)
        assert "checkpoint: model.weights.h5" in outs[0]
        assert re.search(r"^step 10 loss [0-9.]+$", outs[0], re.M)


def check_imports_without_jax(runs):
    """Every port worker ran its drivers with ``jax``, ``flax``, ``optax``
    and ``horovod_tpu`` made unimportable, and the classic job's then
    imported every driver: none of them was loaded."""
    for rank in runs["classic"]:
        assert rank["imported"] == list(DRIVERS)
    for rank in runs["port"] + runs["classic"] + runs["hier"]:
        assert rank["loaded"] == []


CHECKS = {
    "checkpoint_resume jax -> port": (check_checkpoint_resume, "jax"),
    "checkpoint_resume port -> jax": (check_checkpoint_resume, "port"),
    "mnist D 1": (check_mnist, 1),
    "mnist D 2": (check_mnist, 2),
    "imagenet_resnet50 jax -> port": (check_imagenet_resnet50, "jax"),
    "imagenet_resnet50 port -> jax": (check_imagenet_resnet50, "port"),
    "imagenet_resnet50 port -> port": (check_imagenet_resumes_itself,),
    "hierarchical_allreduce": (check_hierarchical_allreduce,),
    "synthetic_benchmark world 1": (check_synthetic_benchmark, 1),
    "synthetic_benchmark world 2": (check_synthetic_benchmark, 2),
    **{driver: (check_classic_driver, driver) for driver in (
        "pytorch_mnist", "pytorch_synthetic_benchmark",
        "tensorflow2_keras_mnist", "tensorflow2_mnist", "mxnet_mnist")},
    "imports without JAX": (check_imports_without_jax,),
}


def test_drivers_against_their_jax_twins(runs):
    """Every check of ``CHECKS`` (each function's docstring gives its
    holds and tolerances) on the one set of runs: the runs are shared, so
    the checks are one test, and every failing check is reported."""
    failed = {}
    for name, (check, *args) in CHECKS.items():
        try:
            check(runs, *args)
        except AssertionError as e:
            failed[name] = e
    assert not failed, "\n".join(f"{k}: {v}" for k, v in failed.items())


def test_every_example_has_a_port_twin():
    """Each file of ``examples/`` has its twin in the port's examples, or
    a recorded mapping to ``lm_benchmark``'s flags, and the package's
    docstring names every driver beside its twin."""
    import horovod_tpu_torch.examples as port_examples
    files = sorted(f for f in os.listdir(os.path.join(REPO, "examples"))
                   if f.endswith(".py"))
    assert sorted(TWINS) == files
    here = os.path.dirname(port_examples.__file__)
    doc = port_examples.__doc__
    for twin, target in TWINS.items():
        module, *flags = target.split()
        path = os.path.join(here, f"{module}.py")
        assert os.path.isfile(path), twin
        src = open(path).read()
        assert "def main(argv=None)" in src, module
        for flag in flags:
            assert f'"{flag}"' in src, (twin, flag)
        assert twin in doc and module in doc, twin


if __name__ == "__main__":
    sys.exit(worker(sys.argv[1], sys.argv[2]))
