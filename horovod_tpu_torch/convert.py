"""Carry weights between the flax parameter trees of the JAX package's
models and the parameters of the port's: the transformer LM
(``models/transformer.py``), the ``MLP`` and the ``MNISTConvNet``
(``models/simple.py``), the ResNets (``models/resnet.py``) and VGG-16
(``models/vgg.py``); and the ResNets' BatchNorm statistics between the
flax ``batch_stats`` tree and the running buffers
(``batch_stats_from_flax``, ``flax_from_batch_stats``).

The flax tree is plain nested dicts of numpy arrays (no flax import
here). One table per model maps each flax leaf path to a torch
parameter name and a layout:

* ``same``: the same array (``embed/embedding`` -> ``embed.weight``, a
  norm's ``scale`` -> its ``weight``, a ``bias``);
* ``linear``: a Dense kernel [in, out] -> an ``nn.Linear`` weight
  [out, in];
* ``heads_in``: ``attn/{query,key,value}/kernel`` [d_model, H, D] ->
  ``attn.{query,key,value}.weight`` [H*D, d_model];
* ``heads_out``: ``attn/out/kernel`` [H, D, d_model] -> ``attn.out.weight``
  [d_model, H*D];
* ``conv``: a Conv kernel [kh, kw, in, out] (HWIO) -> a ``Conv2d``
  weight [out, in, kh, kw] (OIHW).

``flax_named_parameters`` walks the same table in the order of
``jax.tree_util.tree_leaves`` on the flax tree (paths sorted key by key),
which is the order the JAX package packs its fusion buckets in. Within a
leaf the elements keep torch's layout; every optimizer of the port is
elementwise, so that does not change a result.
"""

import numpy as np
import torch

from horovod_tpu_torch.models.resnet import ResNet
from horovod_tpu_torch.models.simple import MLP, MNISTConvNet
from horovod_tpu_torch.models.transformer import Transformer, TransformerConfig
from horovod_tpu_torch.models.vgg import VGG16


def _transformer_table(cfg):
    rows = [(("embed", "embedding"), "embed.weight", "same"),
            (("RMSNorm_0", "scale"), "norm.weight", "same"),
            (("lm_head", "kernel"), "lm_head.weight", "linear")]
    for i in range(cfg.num_layers):
        blk, pre = f"block_{i}", f"blocks.{i}."
        for name in ("query", "key", "value"):
            rows.append(((blk, "attn", name, "kernel"),
                         pre + f"attn.{name}.weight", "heads_in"))
        rows += [((blk, "attn", "out", "kernel"), pre + "attn.out.weight",
                  "heads_out"),
                 ((blk, "RMSNorm_0", "scale"), pre + "norm1.weight", "same"),
                 ((blk, "RMSNorm_1", "scale"), pre + "norm2.weight", "same"),
                 ((blk, "Dense_0", "kernel"), pre + "mlp_in.weight",
                  "linear"),
                 ((blk, "Dense_1", "kernel"), pre + "mlp_out.weight",
                  "linear")]
    return rows


def _dense_rows(flax_name, torch_name):
    return [((flax_name, "bias"), torch_name + ".bias", "same"),
            ((flax_name, "kernel"), torch_name + ".weight", "linear")]


def _norm_rows(flax_name, torch_name):
    return [((flax_name, "bias"), torch_name + ".bias", "same"),
            ((flax_name, "scale"), torch_name + ".weight", "same")]


def _resnet_blocks(model):
    """``(flax block name, torch module name, block)`` of each block: flax
    numbers the blocks of one class across the whole model."""
    name = model.block_cls.__name__
    return [(f"{name}_{k}", f"blocks.{k}", blk)
            for k, blk in enumerate(model.blocks)]


def _resnet_table(model):
    rows = [(("conv_init", "kernel"), "conv_init.weight", "conv")]
    rows += _norm_rows("bn_init", "bn_init") + _dense_rows("head", "head")
    for flax_blk, pre, blk in _resnet_blocks(model):
        n = 3 if hasattr(blk, "conv3") else 2
        for i in range(n):
            rows.append(((flax_blk, f"Conv_{i}", "kernel"),
                         f"{pre}.conv{i + 1}.weight", "conv"))
            rows += [((flax_blk,) + path, name, layout)
                     for path, name, layout in _norm_rows(
                         f"BatchNorm_{i}", f"{pre}.bn{i + 1}")]
        if blk.proj_conv is not None:
            rows.append(((flax_blk, "conv_proj", "kernel"),
                         f"{pre}.proj_conv.weight", "conv"))
            rows += [((flax_blk,) + path, name, layout)
                     for path, name, layout in _norm_rows(
                         "norm_proj", f"{pre}.proj_bn")]
    return rows


def _vgg_table(model):
    rows = []
    for i in range(len(model.convs)):
        rows += [((f"Conv_{i}", "bias"), f"convs.{i}.bias", "same"),
                 ((f"Conv_{i}", "kernel"), f"convs.{i}.weight", "conv")]
    for i in range(3):
        rows += _dense_rows(f"Dense_{i}", f"fc{i}")
    return rows


def _table(spec):
    """The mapping rows of a model (or a ``TransformerConfig``)."""
    if isinstance(spec, Transformer):
        spec = spec.cfg
    if isinstance(spec, TransformerConfig):
        return _transformer_table(spec)
    if isinstance(spec, MLP):
        return [row for i in range(len(spec.layers))
                for row in _dense_rows(f"Dense_{i}", f"layers.{i}")]
    if isinstance(spec, MNISTConvNet):
        rows = []
        for i in range(2):
            rows += [((f"Conv_{i}", "bias"), f"conv{i}.bias", "same"),
                     ((f"Conv_{i}", "kernel"), f"conv{i}.weight", "conv")]
        return rows + _dense_rows("Dense_0", "fc0") + _dense_rows(
            "Dense_1", "fc1")
    if isinstance(spec, ResNet):
        return _resnet_table(spec)
    if isinstance(spec, VGG16):
        return _vgg_table(spec)
    raise TypeError(f"no flax layout for {type(spec).__name__}")


def _heads(spec):
    cfg = spec.cfg if isinstance(spec, Transformer) else spec
    return cfg.num_heads, cfg.d_model // cfg.num_heads


def _to_torch(x, layout):
    if layout == "linear":
        return x.T
    if layout == "heads_in":
        return x.reshape(x.shape[0], -1).T
    if layout == "heads_out":
        return x.reshape(-1, x.shape[-1]).T
    if layout == "conv":
        return x.permute(3, 2, 0, 1)
    return x


def _to_flax(x, layout, spec):
    if layout == "linear":
        return x.T
    if layout == "heads_in":
        h, hd = _heads(spec)
        return x.T.reshape(x.shape[1], h, hd)
    if layout == "heads_out":
        h, hd = _heads(spec)
        return x.T.reshape(h, hd, x.shape[0])
    if layout == "conv":
        return x.transpose(2, 3, 1, 0)
    return x


def params_from_flax(params, spec):
    """flax params (nested dict of arrays) -> torch ``state_dict`` (fp32).
    ``spec`` is the torch model, or a ``TransformerConfig``."""
    sd = {}
    for path, name, layout in _table(spec):
        x = params
        for key in path:
            x = x[key]
        x = torch.from_numpy(np.array(x, dtype=np.float32))
        sd[name] = _to_torch(x, layout).contiguous()
    return sd


def flax_from_params(state_dict, spec):
    """torch ``state_dict`` -> flax params (nested dict of numpy fp32)."""
    params = {}
    for path, name, layout in _table(spec):
        x = state_dict[name].detach().float().cpu().numpy()
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _to_flax(x, layout, spec).copy()
    return params


def flax_named_parameters(model):
    """``(flax_path, parameter)`` of ``model``, in the order
    ``jax.tree_util.tree_leaves`` gives the leaves of its flax tree: pass
    it as ``DistributedOptimizer(named_parameters=...)`` so the port packs
    its buckets leaf for leaf as the JAX package does."""
    for path, name, _ in sorted(_table(model)):
        yield "/".join(path), model.get_parameter(name)


def _stats_table(model):
    """``(flax batch_stats path, torch buffer name)`` of each BatchNorm
    running average of a ResNet: ``mean`` and ``var``."""
    if not isinstance(model, ResNet):
        raise TypeError(f"no flax batch_stats for {type(model).__name__}")
    rows = []
    for path, name, _ in _resnet_table(model):
        if path[-1] == "scale":
            pre = name[:-len("weight")]
            rows += [(path[:-1] + ("mean",), pre + "running_mean"),
                     (path[:-1] + ("var",), pre + "running_var")]
    return rows


def batch_stats_from_flax(batch_stats, model):
    """flax ``batch_stats`` (nested dict of arrays) -> the running buffers
    of ``model``'s BatchNorm layers, as a partial ``state_dict`` (fp32):
    ``model.load_state_dict(..., strict=False)`` takes it."""
    sd = {}
    for path, name in _stats_table(model):
        x = batch_stats
        for key in path:
            x = x[key]
        sd[name] = torch.from_numpy(np.array(x, dtype=np.float32))
    return sd


def flax_from_batch_stats(state_dict, model):
    """The running buffers of ``state_dict`` -> flax ``batch_stats``
    (nested dict of numpy fp32)."""
    stats = {}
    for path, name in _stats_table(model):
        node = stats
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = state_dict[name].detach().float().cpu().numpy()
    return stats
