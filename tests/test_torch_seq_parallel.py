"""The port's sequence-parallel LM step (``make_lm_train_step(mesh=,
seq_axis=)``, ``shard_lm_batch``, ``TransformerConfig.sequence_axis``,
``DistributedOptimizer(axes=)``) against the port at world 1 and against
the JAX package's ``make_lm_train_step`` on a 2 x 2 (data, seq) mesh,
and the LM example under hvdrun at ``--data 2 --seq 2``.

Multi-rank runs are 4 gloo processes on the CPU; the JAX side runs under
``shard_map`` on 4 of the conftest's CPU devices, its Pallas kernels in
interpret mode. fp32 throughout; the measured gaps are in PERF.md.
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
from horovod_tpu import hvd_jax, training
from horovod_tpu.models.transformer import Transformer as JTransformer
from horovod_tpu.models.transformer import TransformerConfig as JConfig
from horovod_tpu_torch import convert
from horovod_tpu_torch import training as t_training
from horovod_tpu_torch.models.transformer import Transformer, TransformerConfig
from horovod_tpu_torch.parallel import mesh as tmesh
from test_torch_ring import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NDATA, NSEQ = 2, 2
WIDTHS = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64)
SEQ_LEN = NSEQ * 16  # 16 positions a rank: the flash ring takes them
LR = 1e-2
STEPS = 3
PW_VOCAB = 16


@pytest.fixture()
def cpu_world():
    hvd_t.shutdown()
    hvd_t.init(device="cpu")
    yield hvd_t
    hvd_t.shutdown()


class PositionwiseLM(torch.nn.Module):
    """Logits that depend on the local token only: the loss stitching is
    the only coupling across seq shards."""

    def __init__(self):
        super().__init__()
        emb = np.random.default_rng(7).standard_normal(
            (PW_VOCAB, PW_VOCAB)).astype(np.float32)
        self.emb = torch.nn.Parameter(torch.from_numpy(emb))

    def forward(self, tokens):
        return self.emb[tokens]


def pw_tokens():
    return np.random.default_rng(1).integers(
        0, PW_VOCAB, size=(NDATA * 2, NSEQ * 4)).astype(np.int64)


def lm_tokens():
    return np.random.default_rng(0).integers(
        0, WIDTHS["vocab_size"], size=(NDATA * 2, SEQ_LEN)).astype(np.int64)


def _pw_step(mesh=None, seq_axis=None, axes=None):
    model = PositionwiseLM()
    opt = hvd_t.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), axes=axes)
    step = t_training.make_lm_train_step(model, opt, mesh=mesh,
                                         seq_axis=seq_axis)
    return step, model


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
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


def _tcfg(flash, seq_axis):
    return TransformerConfig(**WIDTHS, dtype=torch.float32,
                             flash_attention=flash, sequence_axis=seq_axis)


def rank_lm_checks(out_dir):
    """On each of 4 gloo ranks of a (data 2 x seq 2) mesh: the
    positionwise LM's step, a refused optimizer, and 3 AdamW steps of the
    transformer (dense ring, flash ring) from ``params0.npz``."""
    mesh = tmesh.build_mesh((NDATA, NSEQ), ("data", "seq"))
    res = {}
    step, model = _pw_step(mesh, "seq", axes=("data", "seq"))
    loss = step(t_training.shard_lm_batch(torch.from_numpy(pw_tokens()),
                                          "data", "seq"))
    res["pw/loss"] = loss.numpy()
    res["pw/emb"] = model.emb.detach().numpy()
    try:
        _pw_step(mesh, "seq", axes=("data",))
    except ValueError as e:
        res["refused"] = np.asarray("axes" in str(e))
    params0 = _nested(dict(np.load(os.path.join(out_dir, "params0.npz"))))
    tokens = t_training.shard_lm_batch(torch.from_numpy(lm_tokens()),
                                       "data", "seq")
    for flash in (False, True):
        cfg = _tcfg(flash, "seq")
        model = Transformer(cfg)
        model.load_state_dict(convert.params_from_flax(params0, cfg))
        opt = hvd_t.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999),
                              eps=1e-8, weight_decay=1e-4),
            named_parameters=convert.flax_named_parameters(model),
            axes=("data", "seq"))
        step = t_training.make_lm_train_step(model, opt, mesh=mesh,
                                             seq_axis="seq")
        tag = "flash" if flash else "dense"
        res[f"{tag}/losses"] = np.asarray(
            [step(tokens).item() for _ in range(STEPS)])
        for k, v in _flat(convert.flax_from_params(model.state_dict(),
                                                   cfg)).items():
            res[f"{tag}/params/{k}"] = v
    np.savez(os.path.join(out_dir, f"rank{hvd_t.rank()}.npz"), **res)


_WORKER = textwrap.dedent("""
    import sys
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, {tests!r})
    import horovod_tpu_torch as hvd
    from test_torch_seq_parallel import rank_lm_checks
    hvd.init(device="cpu")
    rank_lm_checks({out!r})
    hvd.shutdown()
""")


def _jax_lm(flash):
    """JAX's seq-parallel LM step on a 2 x 2 mesh from its own init:
    ``(params0, losses, params)``."""
    cfg = JConfig(**WIDTHS, dtype=jnp.float32, sequence_axis="seq",
                  flash_attention=flash)
    init_cfg = JConfig(**WIDTHS, dtype=jnp.float32)
    tx = hvd_jax.DistributedOptimizer(optax.adamw(LR, weight_decay=1e-4),
                                      axes=("data", "seq"))
    tokens = jnp.asarray(lm_tokens(), jnp.int32)
    state = training.create_train_state(JTransformer(init_cfg), tx,
                                        jax.random.PRNGKey(0), tokens[:1])
    params0 = jax.tree_util.tree_map(np.asarray, state.params)
    devs = np.asarray(jax.devices()[:NDATA * NSEQ]).reshape(NDATA, NSEQ)
    mesh = jax.sharding.Mesh(devs, ("data", "seq"))
    step = training.make_lm_train_step(JTransformer(cfg), tx, mesh=mesh,
                                       batch_axis="data", seq_axis="seq",
                                       donate=False)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, tokens)
        losses.append(float(loss))
    return params0, losses, jax.tree_util.tree_map(np.asarray, state.params)


def test_seq_parallel_lm_on_four_ranks(cpu_world, tmp_path):
    """On 2 x 2 gloo ranks: the positionwise LM's loss and parameters
    after one step equal the port's at world 1 without ``seq_axis`` (loss
    rtol 1e-6, parameters rtol 1e-5 and atol 1e-6); an optimizer that
    reduces over the data axis only is refused; the transformer (dense
    and flash ring) trained 3 AdamW steps agrees with the JAX package's
    ``make_lm_train_step`` on the 2 x 2 mesh from the same converted
    weights (loss rtol 1e-5, parameters atol 1e-5)."""
    step, model = _pw_step()
    pw_loss = step(torch.from_numpy(pw_tokens())).item()
    pw_emb = model.emb.detach().numpy()
    ref = {flash: _jax_lm(flash) for flash in (False, True)}
    # both configurations start from one init: the JAX model's draws do
    # not depend on its attention path
    np.savez(tmp_path / "params0.npz", **_flat(ref[False][0]))
    run_ranks(_WORKER.format(tests=os.path.join(REPO, "tests"),
                             out=str(tmp_path)), 4, timeout=240)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    for res in ranks:
        np.testing.assert_allclose(res["pw/loss"], pw_loss, rtol=1e-6)
        np.testing.assert_allclose(res["pw/emb"], pw_emb, rtol=1e-5,
                                   atol=1e-6)
        assert bool(res["refused"])
        for flash in (False, True):
            tag = "flash" if flash else "dense"
            _, losses, params = ref[flash]
            np.testing.assert_allclose(res[f"{tag}/losses"], losses,
                                       rtol=1e-5)
            for k, v in _flat(params).items():
                np.testing.assert_allclose(res[f"{tag}/params/{k}"], v,
                                           atol=1e-5, err_msg=f"{tag} {k}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_world_one_seq_branch_is_the_plain_step(cpu_world, dtype):
    """At world 1 on a (1, 1) mesh the seq branch runs a ring of one
    block: K1's lse output merged once is K1's output, and K2 and K3's
    fp32 partials cast once are their bf16 outputs, so 3 steps equal the
    plain step's bit for bit (the CPU counterpart of chip_smoke's 10b)."""
    tokens = torch.from_numpy(lm_tokens())
    runs = []
    for seq in (False, True):
        hvd_t.shutdown()
        hvd_t.init(device="cpu")
        mesh = tmesh.build_mesh((1, 1), ("data", "seq")) if seq else None
        cfg = TransformerConfig(**WIDTHS, dtype=dtype, flash_attention=True,
                                sequence_axis="seq" if seq else None)
        model = Transformer(cfg, generator=torch.Generator().manual_seed(2))
        opt = hvd_t.DistributedOptimizer(torch.optim.AdamW(
            model.parameters(), lr=LR, weight_decay=1e-4))
        step = t_training.make_lm_train_step(
            model, opt, mesh=mesh, seq_axis="seq" if seq else None)
        losses = [step(tokens).item() for _ in range(STEPS)]
        runs.append((losses, [p.detach().clone()
                              for p in model.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_lm_train_step_refuses_mismatches(cpu_world):
    """A mesh that is not the installed one, a model sharded over another
    axis, and a mesh that does not fit the world are refused."""
    model = Transformer(_tcfg(False, "seq"))
    opt = hvd_t.DistributedOptimizer(torch.optim.SGD(model.parameters(),
                                                     lr=0.1))
    stray = tmesh.Mesh(group=None, device=torch.device("cpu"), size=1,
                       rank=0, axis_names=("data", "seq"), shape=(1, 1))
    with pytest.raises(ValueError, match="installed"):
        t_training.make_lm_train_step(model, opt, mesh=stray, seq_axis="seq")
    mesh = tmesh.build_mesh((1, 1), ("data", "seq"))
    assert tmesh.get_mesh() is mesh and mesh.coords == (0, 0)
    with pytest.raises(ValueError, match="sequence_axis"):
        t_training.make_lm_train_step(model, opt, mesh=mesh)
    with pytest.raises(ValueError, match="ranks"):
        tmesh.build_mesh((2, 1), ("data", "seq"))
    x = torch.arange(12).reshape(2, 6)
    assert torch.equal(t_training.shard_lm_batch(x, "data", "seq"), x)


def _example(np_, *args):
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.run", "-np", str(np_),
         sys.executable, "-m", "horovod_tpu_torch.examples.lm_benchmark",
         "--device", "cpu", "--layers", "1", "--d-model", "32", "--heads",
         "2", "--vocab", "64", "--seq-len", "32", "--steps", "1",
         "--warmup", "0", *args],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.splitlines()
    return lines[-2], json.loads(lines[-1])


def test_lm_example_data_two_seq_two_equals_one_rank():
    """``hvdrun -np 4 ... lm_benchmark --data 2 --seq 2`` trains the
    global batch of ``-np 1 --data 1 --seq 1``: the same losses (rtol
    1e-5), and the mesh printed as data x seq. Of the two steps, the
    first updates at the initial rate in both worlds and the second's
    loss reads that update; the warmup ramps each world's rate to
    ``--data`` times it, the data axis of its mesh."""
    mesh_line, four = _example(4, "--data", "2", "--seq", "2", "--batch",
                               "2")
    _, one = _example(1, "--data", "1", "--seq", "1", "--batch", "4")
    assert mesh_line == "mesh 2 x 2 (data x seq)"
    assert four["mesh"] == {"data": 2, "seq": 2} and four["world"] == 4
    assert len(four["losses"]) == 2
    np.testing.assert_allclose(four["losses"], one["losses"], rtol=1e-5)
    for run in (four, one):
        # one warm step in an epoch of warmup: the ramp's ends, progress
        # 0 and 1
        lr0, data = run["initial_lr"], run["mesh"]["data"]
        assert run["lrs"] == [lr0, lr0 * data]
