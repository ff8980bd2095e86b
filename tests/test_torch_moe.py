"""The port's mixture of experts (``horovod_tpu_torch/models/moe.py``, the
transformer's MoE blocks, expert parallelism over ``parallel/axis.py``)
against the JAX package's flax ``MoE`` and ``make_tp_lm_train_step``.

Inputs are made by numpy from seeds and the weights carried across from
flax by ``convert``. fp32 throughout, at the JAX MoE tests' own bounds
(rtol 2e-5, atol 1e-6), except the 4-rank train step, which runs both
sides in fp64 (JAX under ``enable_x64``): AdamW's first steps move each
weight by about ``lr * g / (|g| + eps)``, so where an expert weight's
gradient is near ``eps`` the fp32 rounding of the gradient (about 1e-4
of such an element, on either side) moves the weight by about 1e-4 of
``lr``; in fp64 that drops below 1e-6 (measured in PERF.md).
Multi-rank runs are 4 gloo processes on the CPU; the JAX side runs on 4
of the conftest's CPU devices.
"""

import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models import moe as jmoe
from horovod_tpu.models.transformer import Transformer as JTransformer
from horovod_tpu.models.transformer import TransformerConfig as JConfig
from horovod_tpu.parallel import tensor as jtp
from horovod_tpu.training import TrainState
from horovod_tpu_torch import convert
from horovod_tpu_torch.models import moe as tmoe
from horovod_tpu_torch.models.transformer import (Axes, Transformer,
                                                  TransformerConfig)
from horovod_tpu_torch.parallel import axis as taxis
from horovod_tpu_torch.parallel import mesh as tmesh
from horovod_tpu_torch.parallel import tensor as ttp
from test_torch_ring import run_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-5, 1e-6
AUX = {"on": (0.01, 1e-3), "off": (0.0, 0.0)}
# the layer cases: Switch and GShard top-2, G 1, 4 and 2, the
# indivisible fallback (T 16 in at most 3 groups: 2), and an overflow
# that drops tokens (capacity 1.0 at E 4 over 16 tokens: 4 slots each)
LAYERS = {
    "top1": dict(num_experts=8, d_model=16, d_ff=32),
    "top1_g4": dict(num_experts=8, d_model=16, d_ff=32, num_groups=4),
    "top2_g2": dict(num_experts=8, d_model=16, d_ff=32, top_k=2,
                    num_groups=2),
    "indivisible": dict(num_experts=4, d_model=8, d_ff=16, num_groups=3),
    "overflow": dict(num_experts=4, d_model=8, d_ff=16,
                     capacity_factor=1.0),
}
TOKENS = {"top1": 64, "top1_g4": 64, "top2_g2": 64, "indivisible": 16,
          "overflow": 16}
LM = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=16, d_ff=32,
          moe_every=2, num_experts=8)
LR = 1e-3
STEPS = 3
# the 4-rank step's configurations: one group over the global batch (the
# tokens gathered over the data axis) and two groups, one a data rank
SPAWN_GROUPS = (1, 2)


def _layer_inputs(case, seed=0):
    kw = LAYERS[case]
    rng = np.random.default_rng(seed)
    if case == "overflow":  # identical tokens: one expert takes them all
        x = np.ones((TOKENS[case], kw["d_model"]), np.float32)
    else:
        x = rng.standard_normal((TOKENS[case], kw["d_model"])).astype(
            np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    return kw, x, g


def _jax_layer(kw, x, g, weights):
    """flax's layer: params, output, sown terms, and the gradients of
    ``sum(out * g) + aux_loss`` in params and x."""
    layer = jmoe.MoE(**kw)
    params = jax.tree_util.tree_map(
        np.asarray, layer.init(jax.random.PRNGKey(0), x)["params"])

    def loss(p, v):
        out, mut = layer.apply({"params": p}, v, mutable=["losses"])
        return jnp.sum(out * g) + jmoe.aux_loss(mut, *weights), (out, mut)

    (_, (out, mut)), grads = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    return params, np.asarray(out), mut, jax.tree_util.tree_map(
        np.asarray, grads)


def _port_shards(kw, params, x, g, weights, n, tokens_sharded):
    """The port's layer over ``n`` expert shards in one process: the
    whole output, each shard's gradients of its share of the loss, and
    the input's gradient (the shards' own for sharded tokens)."""
    mods = [tmoe.MoE(**kw, expert_shard=(i, n)) for i in range(n)]
    for i, m in enumerate(mods):
        m.load_state_dict(convert.params_from_flax(
            tmoe.shard_moe_params(params, i, n), m))
    if tokens_sharded:
        xs = [torch.from_numpy(c.copy()).requires_grad_()
              for c in np.split(x, n)]
        gs = np.split(g, n)
    else:
        xs = [torch.from_numpy(x.copy()).requires_grad_()
              for _ in range(n)]
        gs = [g] * n
    outs = tmoe.moe_shards(mods, xs, taxis.LocalAxis(n),
                           taxis.single_axis(n),
                           tokens_sharded=tokens_sharded)
    torch.autograd.backward([
        (o * torch.from_numpy(gg)).sum() + tmoe.aux_loss(m, *weights)
        for o, gg, m in zip(outs, gs, mods)])
    out = torch.cat(outs) if tokens_sharded else outs[0]
    gx = torch.cat([v.grad for v in xs]) if tokens_sharded else xs[0].grad
    return mods, out.detach().numpy(), gx.numpy()


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                               err_msg=what)


@pytest.mark.parametrize("aux", sorted(AUX))
@pytest.mark.parametrize("case", sorted(LAYERS))
def test_layer_matches_flax(case, aux):
    """Output, sown terms, and the gradients of gate, w_in, w_out and the
    input against flax's, with the auxiliary weights on and off (the
    gate's gradient has a combine part and an auxiliary part)."""
    kw, x, g = _layer_inputs(case)
    params, want, mut, (jg, jgx) = _jax_layer(kw, x, g, AUX[aux])
    layer = tmoe.MoE(**kw)
    layer.load_state_dict(convert.params_from_flax(params, layer))
    xt = torch.from_numpy(x).requires_grad_()
    out = layer(xt)
    ((out * torch.from_numpy(g)).sum()
     + tmoe.aux_loss(layer, *AUX[aux])).backward()
    _close(out.detach().numpy(), want, "output")
    for key in ("load_balance", "router_z"):
        assert layer.sown[key].dtype == torch.float32
        _close(layer.sown[key].item(), float(mut["losses"][key][0]), key)
    for name in ("gate", "w_in", "w_out"):
        _close(layer.get_parameter(name).grad.numpy(), jg[name], name)
    _close(xt.grad.numpy(), jgx, "x")
    if case == "overflow":  # 4 slots of one expert: the rest drop to 0
        assert int((np.abs(out.detach().numpy()).sum(-1) > 0).sum()) == 4


def test_indivisible_groups_fall_back_and_log(caplog):
    """T 16 in at most 3 groups is 2 groups, bit for bit an explicit G 2,
    logged once per (T, num_groups); T above 1024 that loses most of its
    grouping warns."""
    x = torch.ones(16, 8)
    three = tmoe.MoE(4, 8, 16, num_groups=3)
    two = tmoe.MoE(4, 8, 16, num_groups=2)
    two.load_state_dict(three.state_dict())
    tmoe._GROUP_FALLBACKS.discard((16, 3))
    with caplog.at_level("INFO", logger="horovod_tpu_torch"):
        got = three(x)
        three(x)
    assert torch.equal(got, two(x))
    assert sum("using G=2" in r.message for r in caplog.records) == 1
    assert tmoe.effective_groups(2048, 8) == 8
    with pytest.warns(UserWarning, match="no divisor near"):
        assert tmoe.effective_groups(2053, 8) == 1


def test_aux_loss_sums_the_sown_terms():
    """``aux_loss`` weights and sums every MoE's terms in flax path order,
    as the JAX one walks the ``losses`` collection, and is fp32 zero for a
    dense model or nothing sown."""
    cfg = dict(LM, num_layers=4, moe_every=1)
    tokens = np.random.default_rng(3).integers(0, 64, size=(2, 8))
    jm = JTransformer(JConfig(**cfg, dtype=jnp.float32))
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(1), tokens)["params"])
    _, mut = jm.apply({"params": params}, tokens, mutable=["losses"])
    tcfg = TransformerConfig(**cfg, dtype=torch.float32)
    model = Transformer(tcfg)
    model.load_state_dict(convert.params_from_flax(params, tcfg))
    model(torch.from_numpy(tokens))
    for w in ((0.01, 1e-3), (0.5, 0.0), (0.0, 2.0)):
        np.testing.assert_allclose(tmoe.aux_loss(model, *w).item(),
                                   float(jmoe.aux_loss(mut, *w)), rtol=1e-6)
    dense = Transformer(TransformerConfig(**dict(cfg, moe_every=0)))
    for source in (dense, {}, []):
        zero = tmoe.aux_loss(source)
        assert zero.dtype == torch.float32 and float(zero) == 0.0


@pytest.mark.parametrize("name,fan_in", [("gate", 512), ("w_in", 512 * 8),
                                         ("w_out", 64 * 8)])
def test_init_std_is_flax(name, fan_in):
    """flax's ``lecun_normal`` counts the leading expert dim of w_in
    ``[E, d, f]`` and w_out ``[E, f, d]`` as a receptive field: fan_in
    ``d E`` and ``f E``, the gate's ``d``. On 4 k (the gate) and 262 k
    draws the port's std is flax's within 5 % (a fan_in without E would
    be off by sqrt(8)), and both are ``sqrt(1 / fan_in)``."""
    kw = dict(num_experts=8, d_model=512, d_ff=64)
    flax_p = jmoe.MoE(**kw).init(jax.random.PRNGKey(0),
                                 jnp.ones((8, 512)))["params"]
    port = tmoe.MoE(**kw, generator=torch.Generator().manual_seed(1))
    got = float(port.get_parameter(name).detach().std())
    want = float(np.std(np.asarray(flax_p[name])))
    assert abs(got / want - 1) < 0.05, (got, want)
    assert abs(got * np.sqrt(fan_in) - 1) < 0.05, got


def test_moe_param_specs_match_jax():
    """``expert_major_spec`` and ``moe_param_specs`` give JAX's specs leaf
    for leaf, and ``shard_moe_params`` JAX's addressable shards on an
    expert axis of 8."""
    x = np.random.default_rng(0).standard_normal((64, 16)).astype(
        np.float32)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:8]), ("expert",))
    params = jmoe.MoE(num_experts=8, d_model=16, d_ff=32).init(
        jax.random.PRNGKey(0), x)["params"]
    want = jmoe.moe_param_specs(params)
    got = tmoe.moe_param_specs(jax.tree_util.tree_map(np.asarray, params))
    assert {k: tuple(v) for k, v in want.items()} == got
    assert tmoe.moe_param_specs(tmoe.MoE(8, 16, 32), "ep") == {
        "gate": (), "w_in": ("ep", None, None), "w_out": ("ep", None, None)}
    sharded = jmoe.shard_moe_params(params, mesh)
    host = jax.tree_util.tree_map(np.asarray, params)
    for i, dev in enumerate(mesh.devices):
        mine = tmoe.shard_moe_params(host, i, 8)
        for k, leaf in sharded.items():
            shard = next(s for s in leaf.addressable_shards
                         if s.device == dev)
            np.testing.assert_array_equal(mine[k], np.asarray(shard.data))


@pytest.mark.parametrize("tokens_sharded", [False, True])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_local_expert_shards_match_one_device(n, tokens_sharded):
    """``n`` expert shards in one process, with the tokens replicated over
    the expert axis (the train step's layout) or sharded over it (the JAX
    layer tests' and the dryrun's 1d): output and the gradients of gate,
    w_in, w_out and the input against the one-device flax layer, at G 1
    and G 4, the auxiliary weights on. Each shard's gate gradient is the
    whole gate's: the combine part summed over the experts, the
    auxiliary part counted once."""
    for case in ("top1", "top1_g4", "top2_g2"):
        kw, x, g = _layer_inputs(case, seed=n)
        params, want, _, (jg, jgx) = _jax_layer(kw, x, g, AUX["on"])
        mods, out, gx = _port_shards(kw, params, x, g, AUX["on"], n,
                                     tokens_sharded)
        _close(out, want, f"{case} output")
        _close(gx, jgx, f"{case} x")
        for m in mods:
            _close(m.gate.grad.numpy(), jg["gate"], f"{case} gate")
        for name in ("w_in", "w_out"):
            _close(torch.cat([m.get_parameter(name).grad
                              for m in mods]).numpy(), jg[name],
                   f"{case} {name}")



def _fp32_order(got, want, r, what):
    """Two sums of the same R fp32 partial sums (one a shard's tokens) in
    other orders part by at most 2 (R - 1) 2^-24 sum_r |partial_r|; with
    each shard's partial about 1/R of the whole, every element within
    2 R^2 2^-24 max|want| (chip_smoke's ``_fp32_order`` with R for M)."""
    bound = 2 * r * r * 2.0 ** -24 * float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= bound, f"{what}: {err} beyond {bound}"


def _two_forms(form, r, top_k, seed):
    """One top-k layer (8 experts, 8 groups, 128 tokens) over ``r``
    expert shards in one process, its tokens sharded over the axis,
    through ``form``: the output, the gradients of the input, the gate
    (each shard's), w_in and w_out, the auxiliary terms and the dropped
    share, from ``sum(out * g) + aux_loss`` on each shard."""
    kw = dict(num_experts=8, d_model=16, d_ff=32, num_groups=8, top_k=top_k)
    mods = [tmoe.MoE(**kw, expert_shard=(i, r),
                     generator=torch.Generator().manual_seed(3))
            for i in range(r)]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((128, 16)).astype(np.float32)
    g = rng.standard_normal((128, 16)).astype(np.float32)
    xs = [torch.from_numpy(c.copy()).requires_grad_()
          for c in np.split(x, r)]
    outs = form(mods, xs, taxis.LocalAxis(r))
    torch.autograd.backward([
        (o * torch.from_numpy(gg)).sum() + tmoe.aux_loss(m)
        for o, gg, m in zip(outs, np.split(g, r), mods)])
    return {"out": torch.cat(outs).detach().numpy(),
            "x": torch.cat([v.grad for v in xs]).numpy(),
            "w_in": torch.cat([m.w_in.grad for m in mods]).numpy(),
            "w_out": torch.cat([m.w_out.grad for m in mods]).numpy(),
            "gate": [m.gate.grad.numpy() for m in mods],
            "aux": [np.asarray([float(m.sown[k].detach())
                                for k in sorted(m.sown)]) for m in mods],
            "dropped": [float(m.dropped) for m in mods]}


@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("r", [2, 4, 8])
def test_all_to_all_form_matches_the_gather_form(r, top_k):
    """GShard's all-to-all layout against the gather form, tokens sharded
    over an expert axis of R in one process (chip_smoke's 12d at a small
    size). Both forms dispatch each slot one token and feed the experts
    the same ``[G, E/R, C, d]``, so the expert weights' gradients are
    bit for bit, and at top-1, where every combine sum has one non-zero
    term, the output too; the gate's gradient (the shards' partial sums
    against one sum over all tokens), the auxiliary terms (local means
    summed over the axis) and the input's gradient, and at top-2 the
    output (two experts' terms summed in one einsum or over the shards),
    within fp32 summation order. ``moe_shards`` takes the all-to-all form
    here, where R divides the 8 groups."""
    a = _two_forms(tmoe.tokens_all_to_all, r, top_k, seed=r)
    b = _two_forms(tmoe.tokens_gathered, r, top_k, seed=r)
    auto = _two_forms(lambda mods, xs, ax: tmoe.moe_shards(
        mods, xs, ax, taxis.single_axis(len(xs)), tokens_sharded=True),
        r, top_k, seed=r)
    for key in ("w_in", "w_out"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for key in ("out", "x"):
        if top_k == 1 and key == "out":
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        else:
            _fp32_order(a[key], b[key], r, key)
    for key in ("gate", "aux"):
        for i, (got, want) in enumerate(zip(a[key], b[key])):
            _fp32_order(got, want, r, f"shard {i} {key}")
    assert a["dropped"] == b["dropped"]
    for key in ("out", "x", "w_in", "w_out"):
        np.testing.assert_array_equal(auto[key], a[key], err_msg=key)


def test_groups_the_axis_does_not_divide_gather_and_log(caplog):
    """Where the expert axis does not divide the effective groups (G 4
    over 8 shards), ``moe_shards`` takes the gather form, bit for bit
    ``tokens_gathered``, and logs it once per (G, R)."""
    tmoe._A2A_FALLBACKS.discard((4, 8))
    x = np.random.default_rng(5).standard_normal((64, 16)).astype(np.float32)
    runs = []
    with caplog.at_level("INFO", logger="horovod_tpu_torch"):
        for form in ("auto", "auto", "gathered"):
            mods = [tmoe.MoE(8, 16, 32, num_groups=4, expert_shard=(i, 8))
                    for i in range(8)]
            xs = [torch.from_numpy(c.copy()) for c in np.split(x, 8)]
            if form == "auto":
                outs = tmoe.moe_shards(mods, xs, taxis.LocalAxis(8),
                                       taxis.single_axis(8),
                                       tokens_sharded=True)
            else:
                outs = tmoe.tokens_gathered(mods, xs, taxis.LocalAxis(8))
            runs.append(torch.cat(outs))
    assert torch.equal(runs[0], runs[2])
    assert sum("gathering the tokens" in r.message
               for r in caplog.records) == 1


def _lm_tokens():
    return np.random.default_rng(0).integers(
        0, LM["vocab_size"], size=(4, 16)).astype(np.int64)


def test_moe_lm_logits_and_grads_match_flax():
    """The MoE LM (``moe_every 2``: block 1 a MoE block) against flax's
    ``Transformer``: logits, and the gradients of the loss plus
    ``aux_loss`` in every leaf (1e-5 of the largest, the transformer
    tests' bound, 1e-4 of logits of order 1)."""
    tokens = _lm_tokens()
    cfg = dict(LM, moe_num_groups=2)
    jm = JTransformer(JConfig(**cfg, dtype=jnp.float32))
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), tokens[:1])["params"])

    def loss(p):
        logits, mut = jm.apply({"params": p}, tokens, mutable=["losses"])
        logp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        ll = jnp.take_along_axis(logp, tokens[:, 1:, None], -1)[..., 0]
        return -jnp.mean(ll) + jmoe.aux_loss(mut), logits

    (_, j_logits), jg = jax.value_and_grad(loss, has_aux=True)(params)
    tcfg = TransformerConfig(**cfg, dtype=torch.float32)
    model = Transformer(tcfg)
    model.load_state_dict(convert.params_from_flax(params, tcfg))
    assert set(dict(model.named_parameters())) >= {
        "blocks.1.moe.gate", "blocks.1.moe.w_in", "blocks.1.moe.w_out"}
    logits = model(torch.from_numpy(tokens))
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -logp.gather(-1, torch.from_numpy(tokens[:, 1:, None]))[..., 0]
    (nll.mean() + tmoe.aux_loss(model)).backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(j_logits), atol=1e-4)
    got = convert.flax_from_params(
        {n: p.grad for n, p in model.named_parameters()}, tcfg)
    for path, want in jax.tree_util.tree_leaves_with_path(jg):
        keys = [k.key for k in path]
        have = got
        for k in keys:
            have = have[k]
        want = np.asarray(want)
        np.testing.assert_allclose(have, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max() + 1e-9,
                                   err_msg="/".join(keys))


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


def _ep_cfg(groups):
    return TransformerConfig(**LM, moe_num_groups=groups,
                             dtype=torch.float64)


def _adamw(model):
    return torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


def _rank_tokens(r):
    d = r // 2  # (data, expert) row-major: rank r at data r // 2
    return torch.from_numpy(_lm_tokens()[2 * d:2 * d + 2])


def _layer_b_inputs():
    rng = np.random.default_rng(11)
    return (rng.standard_normal((32, 16)), rng.standard_normal((32, 16)))


def _layer_b(mods, xs, g, eaxis=None):
    """The dryrun's 1d layout: tokens sharded over the expert axis, its
    ``mean(out^2)``-style loss as ``sum(out * g)`` over each shard's rows;
    the outputs, gradients on the layers and inputs. Over ``eaxis`` (the
    shards in one process) or, without, through one layer's own
    ``forward`` on the installed mesh."""
    if eaxis is None:
        outs = [m(x) for m, x in zip(mods, xs)]
    else:
        outs = tmoe.moe_shards(mods, xs, eaxis, taxis.single_axis(len(xs)),
                               tokens_sharded=True)
    torch.autograd.backward([(o * gg).sum() + tmoe.aux_loss(m)
                             for o, gg, m in zip(outs, g, mods)])
    return outs


def rank_ep_checks(out_dir):
    """On each of 4 gloo ranks of a (data 2 x expert 2) mesh: 3 AdamW
    steps of ``make_tp_lm_train_step(model_axis=None,
    expert_axis="expert")`` from ``params0.npz`` at G 1 and 2 (fp64), and
    the MoE layer's own forward with its tokens sharded over the expert
    axis at G 1 and 4."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import ckpt
    mesh = tmesh.build_mesh((2, 2), ("data", "expert"))
    params0 = _nested(dict(np.load(os.path.join(out_dir, "params0.npz"))))
    res = {}
    for groups in SPAWN_GROUPS:
        model = ttp.shard_lm_state(_ep_cfg(groups), mesh, model_axis=None,
                                   expert_axis="expert", params=params0)
        model = model.double()
        opt = _adamw(model)
        step = ttp.make_tp_lm_train_step(model, opt, mesh, model_axis=None,
                                         expert_axis="expert")
        losses = [step(_rank_tokens(hvd.rank())).item()
                  for _ in range(STEPS)]
        res[f"g{groups}/losses"] = np.asarray(losses)
        tree = convert.flax_from_params(
            {n: p.detach() for n, p in model.state_dict().items()}, model)
        for k, v in _flat(tree).items():
            res[f"g{groups}/params/{k}"] = v
        # saved at (data 2 x expert 2), restored at (data 1 x expert 4)
        root = os.path.join(out_dir, f"ckpt{groups}")
        ckpt.save_sharded(root, STEPS, convert.train_state_to_flat(
            model, opt, step.state), rank=hvd.rank(), world=4)
        mesh4 = tmesh.build_mesh((1, 4), ("data", "expert"))
        model = ttp.shard_lm_state(_ep_cfg(groups), mesh4, model_axis=None,
                                   expert_axis="expert").double()
        opt = _adamw(model)
        step = ttp.make_tp_lm_train_step(model, opt, mesh4, model_axis=None,
                                         expert_axis="expert")
        _, restored, _ = ckpt.restore_sharded(
            root, convert.train_state_to_flat(model, opt, step.state))
        convert.train_state_from_flat(model, opt, step.state, restored)
        res[f"g{groups}/resumed/loss"] = np.asarray(
            step(torch.from_numpy(_lm_tokens())).item())
        tree = convert.flax_from_params(
            {n: p.detach() for n, p in model.state_dict().items()}, model)
        for k, v in _flat(tree).items():
            res[f"g{groups}/resumed/{k}"] = v
        mesh = tmesh.build_mesh((2, 2), ("data", "expert"))
    x, g = _layer_b_inputs()
    e = mesh.axis_index("expert")
    for groups in (1, 4):
        layer = tmoe.MoE(8, 16, 32, num_groups=groups, dtype=torch.float64,
                         expert_shard=(e, 2), tokens_sharded=True,
                         generator=torch.Generator().manual_seed(5)).double()
        xs = [torch.from_numpy(x[16 * e:16 * e + 16]).requires_grad_()]
        outs = _layer_b([layer], xs,
                        [torch.from_numpy(g[16 * e:16 * e + 16])])
        res[f"b{groups}/out"] = outs[0].detach().numpy()
        res[f"b{groups}/x"] = xs[0].grad.numpy()
        for name in ("gate", "w_in", "w_out"):
            res[f"b{groups}/{name}"] = layer.get_parameter(name).grad.numpy()
        # the gather form over the same group axis (G 4: the layer's own
        # forward took the all-to-all form)
        layer.zero_grad()
        xs = [torch.from_numpy(x[16 * e:16 * e + 16]).requires_grad_()]
        outs = tmoe.tokens_gathered([layer], xs, taxis.GroupAxis("expert"))
        res[f"b{groups}/gathered"] = outs[0].detach().numpy()
    np.savez(os.path.join(out_dir, f"rank{hvd.rank()}.npz"), **res)


_WORKER = textwrap.dedent("""
    import sys
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, {tests!r})
    import horovod_tpu_torch as hvd
    from test_torch_moe import rank_ep_checks
    hvd.init(device="cpu")
    rank_ep_checks({out!r})
    hvd.shutdown()
""")


def _jax_ep(groups, params0, steps=STEPS):
    """JAX's expert-parallel step on a 2 x 2 (data, expert) mesh in fp64
    from ``params0``, ``steps`` steps: ``(losses, params after each
    step)``."""
    with jax.enable_x64(True):
        devs = np.asarray(jax.devices()[:4]).reshape(2, 2)
        mesh = jax.sharding.Mesh(devs, ("data", "expert"))
        cfg = JConfig(**LM, moe_num_groups=groups, dtype=jnp.float64,
                      expert_mesh=mesh)
        model = JTransformer(cfg)
        tx = optax.adamw(LR, weight_decay=1e-4)
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     params0)
        state = TrainState(params=p64, opt_state=tx.init(p64),
                           batch_stats={}, step=jnp.zeros((), jnp.int32))
        step = jtp.make_tp_lm_train_step(model, tx, mesh, model_axis=None,
                                         expert_axis="expert", donate=False)
        tokens = jnp.asarray(_lm_tokens(), jnp.int32)
        losses, params = [], []
        for _ in range(steps):
            state, loss = step(state, tokens)
            losses.append(float(loss))
            params.append(jax.tree_util.tree_map(np.asarray, state.params))
        return losses, params


def _local_ep(groups, params0):
    """The same step over 4 ``LocalAxis`` shards in this process."""
    shape, names = (2, 2), ("data", "expert")
    models = []
    for r in range(4):
        m = tmesh.Mesh(group=None, device=torch.device("cpu"), size=4,
                       rank=r, axis_names=names, shape=shape)
        models.append(ttp.shard_lm_state(
            _ep_cfg(groups), m, model_axis=None, expert_axis="expert",
            params=params0).double())
    ax = taxis.local_axes(shape, names)
    step = ttp.make_tp_lm_train_step_shards(
        models, [_adamw(m) for m in models],
        Axes(taxis.single_axis(4), ax["expert"], ax["data"]))
    losses = [step([_rank_tokens(r) for r in range(4)])
              for _ in range(STEPS)]
    return models, [[float(x) for x in row] for row in losses]


def _local_layer_b():
    x, g = _layer_b_inputs()
    out = {}
    for groups in (1, 4):
        mods = [tmoe.MoE(8, 16, 32, num_groups=groups, dtype=torch.float64,
                         expert_shard=(e, 2),
                         generator=torch.Generator().manual_seed(5)).double()
                for e in range(2)]
        xs = [torch.from_numpy(x[16 * e:16 * e + 16]).requires_grad_()
              for e in range(2)]
        outs = _layer_b(mods, xs, [torch.from_numpy(g[16 * e:16 * e + 16])
                                   for e in range(2)], taxis.LocalAxis(2))
        out[groups] = (mods, xs, outs)
    return out


def test_expert_parallel_step_on_four_ranks(tmp_path):
    """On 2 x 2 gloo ranks (data, expert), 3 AdamW steps of
    ``make_tp_lm_train_step(model_axis=None, expert_axis="expert")`` at G 1
    (the tokens gathered over the data axis) and G 2 (one group a data
    rank, the auxiliary statistics summed over it), fp64: losses rtol
    1e-5 and every parameter atol 1e-6 against JAX's step on a 2 x 2 CPU
    mesh, and bit for bit the same step over ``LocalAxis`` shards in one
    process; the state saved there (expert weights and moments gathered
    over the expert axis's groups) and restored at (data 1, expert 4)
    takes JAX's fourth step (the same tolerances); the MoE layer with its
    tokens sharded over the expert axis (G 1: the gather form; G 4: the
    all-to-all form), output and gradients bit for bit its ``LocalAxis``
    form, and at G 4 its output bit for bit the gather form's on the same
    group axis (top-1)."""
    jm = JTransformer(JConfig(**LM, dtype=jnp.float32))
    params0 = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.asarray(_lm_tokens()[:1]))["params"])
    np.savez(tmp_path / "params0.npz", **_flat(params0))
    run_ranks(_WORKER.format(tests=os.path.join(REPO, "tests"),
                             out=str(tmp_path)), 4, timeout=240)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    specs = ttp.transformer_param_specs(params0, None, "expert")
    coords = [{"expert": (r % 2, 2)} for r in range(4)]
    coords4 = [{"expert": (r, 4)} for r in range(4)]
    for groups in SPAWN_GROUPS:
        j_losses, j_params = _jax_ep(groups, params0, STEPS + 1)
        tag = f"g{groups}"
        resumed = _flat(convert.unshard_flax(
            [_nested({k[len(tag) + 9:]: v for k, v in res.items()
                      if k.startswith(f"{tag}/resumed/")
                      and k != f"{tag}/resumed/loss"}) for res in ranks],
            specs, coords4))
        for res in ranks:
            np.testing.assert_allclose(res[f"{tag}/resumed/loss"],
                                       j_losses[STEPS], rtol=1e-5)
        for k, v in _flat(j_params[STEPS]).items():
            np.testing.assert_allclose(resumed[k], v, rtol=0, atol=1e-6,
                                       err_msg=f"{tag} resumed {k}")
        j_losses, j_params = j_losses[:STEPS], j_params[STEPS - 1]
        models, l_losses = _local_ep(groups, params0)
        for r, res in enumerate(ranks):
            np.testing.assert_allclose(res[f"{tag}/losses"], j_losses,
                                       rtol=1e-5)
            np.testing.assert_array_equal(res[f"{tag}/losses"],
                                          [row[r] for row in l_losses])
            local = _flat(convert.flax_from_params(
                {n: p.detach() for n, p in models[r].state_dict().items()},
                models[r]))
            for k, v in local.items():
                np.testing.assert_array_equal(res[f"{tag}/params/{k}"], v,
                                              err_msg=f"{tag} {k}")
        shards = [_nested({k[len(tag) + 8:]: v for k, v in res.items()
                           if k.startswith(f"{tag}/params/")})
                  for res in ranks]
        full = _flat(convert.unshard_flax(shards, specs, coords))
        for k, v in _flat(j_params).items():
            np.testing.assert_allclose(full[k], v, rtol=0, atol=1e-6,
                                       err_msg=f"{tag} {k}")
    for groups, (mods, xs, outs) in _local_layer_b().items():
        for r, res in enumerate(ranks):
            e = r % 2
            tag = f"b{groups}"
            np.testing.assert_array_equal(res[f"{tag}/out"],
                                          outs[e].detach().numpy())
            np.testing.assert_array_equal(res[f"{tag}/x"],
                                          xs[e].grad.numpy())
            for name in ("gate", "w_in", "w_out"):
                np.testing.assert_array_equal(
                    res[f"{tag}/{name}"],
                    mods[e].get_parameter(name).grad.numpy())
            np.testing.assert_array_equal(res[f"{tag}/gathered"],
                                          res[f"{tag}/out"])
