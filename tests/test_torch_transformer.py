"""The port's transformer LM (horovod_tpu_torch/models/transformer.py)
against the flax model of horovod_tpu with the same weights, carried over
by horovod_tpu_torch/convert.py.

Both sides run a 2-layer model at d_model 32 (2 heads of 16) on the CPU,
with tokens made by numpy from a seed. fp32: the sides differ by
summation order through two blocks and the vocab projection, 1e-4 on
logits of order 1 and 1e-4 relative on gradients. bf16: the flax and
torch graphs round to bf16 at the same points, but XLA and PyTorch
compute bf16 products and GELU at different internal precision, so the
logits agree to a few bf16 ulps (5e-2 on values of order 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models.transformer import Transformer as JTransformer
from horovod_tpu.models.transformer import TransformerConfig as JConfig
from horovod_tpu_torch import convert
from horovod_tpu_torch.models.transformer import Transformer, TransformerConfig
from horovod_tpu_torch.ops import flash_attention as tfa

WIDTHS = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32,
              d_ff=128)
S = 32


def _configs(dtype, flash):
    jcfg = JConfig(**WIDTHS, dtype={"float32": jnp.float32,
                                    "bfloat16": jnp.bfloat16}[dtype],
                   flash_attention=flash)
    tcfg = TransformerConfig(**WIDTHS, dtype=getattr(torch, dtype),
                             flash_attention=flash)
    return jcfg, tcfg


def _setup(dtype, flash, seed=0):
    jcfg, tcfg = _configs(dtype, flash)
    tokens = np.random.default_rng(seed).integers(
        0, WIDTHS["vocab_size"], size=(2, S)).astype(np.int32)
    jmodel = JTransformer(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.asarray(tokens[:1]),
                         train=False)["params"]
    tmodel = Transformer(tcfg)
    tmodel.load_state_dict(convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tcfg))
    return jmodel, params, tmodel, tokens


def _loss_j(jmodel, tokens):
    def loss(params):
        logits = jmodel.apply({"params": params}, jnp.asarray(tokens))
        logp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
        return -jnp.mean(jnp.take_along_axis(
            logp, jnp.asarray(tokens[:, 1:])[..., None], axis=-1))
    return loss


def _loss_t(tmodel, tokens):
    logits = tmodel(torch.from_numpy(tokens).long())
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    return -logp.gather(-1, torch.from_numpy(tokens[:, 1:]).long()[..., None]
                        ).mean()


@pytest.mark.parametrize("flash", [False, True])
def test_fp32_logits_and_grads_match_flax(flash):
    """Dense: both sides' dense attention. Flash: the Pallas kernels in
    interpret mode against the port's flash path (plain versions on the
    CPU, through the same autograd Function as on the card)."""
    jmodel, params, tmodel, tokens = _setup("float32", flash)
    j_logits = jmodel.apply({"params": params}, jnp.asarray(tokens))
    t_logits = tmodel(torch.from_numpy(tokens).long())
    assert t_logits.dtype == torch.float32
    np.testing.assert_allclose(t_logits.detach().numpy(),
                               np.asarray(j_logits), atol=1e-4)

    tfa.reset_launches()
    j_loss, j_grads = jax.value_and_grad(_loss_j(jmodel, tokens))(params)
    t_loss = _loss_t(tmodel, tokens)
    t_loss.backward()
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-5)
    t_grads = convert.flax_from_params(
        {n: p.grad for n, p in tmodel.named_parameters()}, tmodel.cfg)
    flat_j = jax.tree_util.tree_leaves_with_path(j_grads)
    for path, jg in flat_j:
        tg = t_grads
        for key in path:
            tg = tg[key.key]
        scale = float(np.abs(np.asarray(jg)).max())
        np.testing.assert_allclose(tg, np.asarray(jg),
                                   atol=1e-4 * scale + 1e-7,
                                   err_msg=jax.tree_util.keystr(path))
    assert tfa.LAUNCHES == {"fwd": 0, "dq": 0, "dkv": 0}  # CPU: no kernel


@pytest.mark.parametrize("flash", [False, True])
def test_bf16_logits_match_flax(flash):
    jmodel, params, tmodel, tokens = _setup("bfloat16", flash, seed=1)
    j_logits = jmodel.apply({"params": params}, jnp.asarray(tokens))
    t_logits = tmodel(torch.from_numpy(tokens).long())
    assert t_logits.dtype == torch.float32  # lm_head in bf16, then fp32
    np.testing.assert_allclose(t_logits.detach().numpy(),
                               np.asarray(j_logits), atol=5e-2)


def test_convert_round_trip_and_layouts():
    """flax -> torch -> flax is exact, and the port's own init has flax's
    tree: every leaf path and shape."""
    jmodel, params, tmodel, _ = _setup("float32", False)
    back = convert.flax_from_params(tmodel.state_dict(), tmodel.cfg)
    j_leaves = jax.tree_util.tree_leaves_with_path(params)
    b_leaves = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in j_leaves] == [p for p, _ in b_leaves]
    for (_, a), (_, b) in zip(j_leaves, b_leaves):
        assert np.array_equal(np.asarray(a), b)
    fresh = Transformer(tmodel.cfg, generator=torch.Generator().manual_seed(5))
    own = convert.flax_from_params(fresh.state_dict(), fresh.cfg)
    assert jax.tree_util.tree_structure(own) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray,
                                                            params))
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_equal(
        np.shape(a), np.shape(b)), own, jax.tree_util.tree_map(np.asarray,
                                                               params))


def test_init_draws_flax_distributions():
    """Same initializer distributions as flax (not the same bits): the
    spread of each kernel and of the embedding at a width where the
    sample std is within a few percent."""
    cfg = TransformerConfig(vocab_size=512, num_layers=1, num_heads=4,
                            d_model=256, d_ff=1024, dtype=torch.float32)
    t = convert.flax_from_params(
        Transformer(cfg, generator=torch.Generator().manual_seed(0))
        .state_dict(), cfg)
    jcfg = JConfig(vocab_size=512, num_layers=1, num_heads=4, d_model=256,
                   d_ff=1024, dtype=jnp.float32)
    j = JTransformer(jcfg).init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 4), jnp.int32))["params"]
    for path, jv in jax.tree_util.tree_leaves_with_path(j):
        tv = t
        for key in path:
            tv = tv[key.key]
        jv = np.asarray(jv)
        if "scale" in jax.tree_util.keystr(path):
            assert np.all(tv == 1.0) and np.all(jv == 1.0)
            continue
        assert abs(tv.std() / jv.std() - 1) < 0.05, jax.tree_util.keystr(path)
        assert abs(np.abs(tv).max() / np.abs(jv).max() - 1) < 0.5
