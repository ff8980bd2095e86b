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

The transformer's MoE blocks map ``block_i/moe/{gate, w_in, w_out}`` to
``blocks.i.moe.{gate, w_in, w_out}`` as they are (``same``): the port keeps
flax's ``[d, E]``, ``[E, d, f]`` and ``[E, f, d]``; a ``MoE`` alone maps its
three leaves the same way. ``stacked_blocks_from_flax`` stacks the blocks'
leaves layer by layer, the pipeline's layout (``parallel/pipeline.py``).

A tensor- or expert-parallel model holds one shard of each weight, cut
by a tree of specs (``parallel.tensor.transformer_param_specs``,
``models.moe.moe_param_specs``: flax's ``PartitionSpec``s as tuples) at
this rank's coordinates ``{axis: (index, size)}``: ``shard_flax`` cuts a
flax tree, ``unshard_flax`` puts the shards of every rank back together,
and ``cut_module`` cuts a module's own parameters in place (each flax dim
a spec names maps to the torch dim it lies on; the heads of a
``heads_in`` or ``heads_out`` leaf are the major part of its merged
dim, so a block of heads is a block of rows or columns). A size the
axis does not divide raises ``ValueError``, as JAX's placement does.

``flax_named_parameters`` walks the same table in the order of
``jax.tree_util.tree_leaves`` on the flax tree (paths sorted key by key),
which is the order the JAX package packs its fusion buckets in, and
names each leaf's layout; ``flax_perm`` gives a layout's dim order, with
which ZeRO-1's rows and a chunked quantizer's buckets hold each leaf as
its flax array flattens (``ops/fusion.py``).

``train_state_to_flat`` and ``train_state_from_flat`` carry the whole
training state (parameters, optimizer state, BatchNorm statistics and
the step count) to and from the flat leaf list that
``jax.tree_util.tree_flatten`` gives for the JAX package's
``TrainState(params, opt_state, batch_stats, step)`` with a
``DistributedOptimizer`` over ``optax.adamw`` or ``optax.sgd``, ZeRO-1's
``ZeroState`` a leaf of its own (``ckpt.ZeroLeaf``), in flax layout: the
list a checkpoint stores leaf by leaf (``ckpt/sharded.py``). The same
calls carry ``backward_passes_per_step > 1`` as ``optax.MultiSteps``
state, and a tensor- or expert-parallel state, its leaves gathered whole
as the JAX package writes them, cut again at this rank's coordinates on
restore.

``backward_passes_per_step``'s accumulator is each rank's own running
mean of its gradients, in the JAX package as here. A checkpoint holds one
copy of each leaf, written by the rank that owns it (leaf ``i`` of the
flat state by rank ``i % world``, as the JAX package's multi-process save
writes it; a single JAX process driving several devices writes its first
device's copy). A restore gives every rank that copy: a resume at a
window's boundary (``mini_step`` 0, the accumulator zero) is exact at any
world, a resume inside a window exact at world 1.
"""

import warnings

import numpy as np
import torch

from horovod_tpu_torch.models.moe import MoE
from horovod_tpu_torch.models.resnet import ResNet
from horovod_tpu_torch.models.simple import MLP, MNISTConvNet
from horovod_tpu_torch.models.transformer import Transformer, TransformerConfig
from horovod_tpu_torch.models.vgg import VGG16

_MOE_LEAVES = ("gate", "w_in", "w_out")


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
                 ((blk, "RMSNorm_1", "scale"), pre + "norm2.weight", "same")]
        if cfg.use_moe(i):
            rows += [((blk, "moe", leaf), pre + f"moe.{leaf}", "same")
                     for leaf in _MOE_LEAVES]
        else:
            rows += [((blk, "Dense_0", "kernel"), pre + "mlp_in.weight",
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
    if isinstance(spec, MoE):
        return [((leaf,), leaf, "same") for leaf in _MOE_LEAVES]
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
    if type(spec) is torch.nn.Module and not any(spec.children()):
        # a bare module of parameters is a flat dict of arrays (the JAX
        # examples' ``{"w": w}``): each leaf under its own name
        return [((name,), name, "same") for name, _ in
                spec.named_parameters()]
    raise TypeError(f"no flax layout for {type(spec).__name__}")


def _head_dim(spec):
    cfg = spec.cfg if isinstance(spec, Transformer) else spec
    return cfg.d_model // cfg.num_heads


# each layout: the torch tensor's dims in the order of the flax array's
# dims, and which dim of that permuted array flax splits into
# (heads, head_dim); a split keeps the flat order, so the permutation
# alone says how a leaf flattens (``flax_perm``)
LAYOUTS = {"same": (None, None), "linear": ((1, 0), None),
           "heads_in": ((1, 0), 1), "heads_out": ((1, 0), 0),
           "conv": ((2, 3, 1, 0), None)}


def flax_perm(layout):
    """The dim order of ``layout``'s flax array in the torch tensor's
    dims (None: the same array; ``layout`` None too)."""
    return LAYOUTS[layout or "same"][0]


def _to_torch(x, layout):
    """The flax-layout tensor ``x`` as its torch parameter (a view)."""
    perm, split = LAYOUTS[layout or "same"]
    if perm is None:
        return x
    if split is not None:
        shape = list(x.shape)
        shape[split:split + 2] = [shape[split] * shape[split + 1]]
        x = x.reshape(shape)
    return x.permute([perm.index(d) for d in range(len(perm))])


def _to_flax(x, layout, spec):
    """The torch tensor or numpy array ``x`` in its flax layout: a view
    where the strides allow one, as for every parameter."""
    perm, split = LAYOUTS[layout or "same"]
    if perm is None:
        return x
    x = x.permute(perm) if torch.is_tensor(x) else x.transpose(perm)
    if split is not None:  # a model shard holds fewer heads
        shape = list(x.shape)
        d = _head_dim(spec)
        shape[split:split + 1] = [shape[split] // d, d]
        x = x.reshape(shape)
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


def stacked_blocks_from_flax(params, cfg):
    """A flax transformer's ``block_0`` ... ``block_{L-1}`` subtrees as the
    port's stacked dict ``{name: [L, ...]}`` (fp32), ``name`` a ``Block``
    parameter's: what ``parallel.pipeline.stack_params`` makes of the
    blocks of ``params_from_flax``."""
    layers = {}
    for path, name, layout in _table(cfg):
        if name.startswith("blocks."):
            _, i, key = name.split(".", 2)
            x = torch.from_numpy(np.array(_leaf(params, path),
                                          dtype=np.float32))
            layers.setdefault(key, {})[int(i)] = _to_torch(x, layout)
    return {k: torch.stack([v[i] for i in sorted(v)]).contiguous()
            for k, v in layers.items()}


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


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _block(x, dim, coord):
    """Block ``index`` of ``size`` equal blocks of dim ``dim`` of ``x`` (a
    tensor or an array), ``coord = (index, size)``."""
    index, size = coord
    n = x.shape[dim] // size
    return x[(slice(None),) * dim + (slice(index * n, (index + 1) * n),)]


def _spec_dims(spec, coords, shape, what):
    """``(flax dim, (index, size))`` for each dim ``spec`` shards, its
    size checked against the axis's."""
    out = []
    for k, axis in enumerate(spec):
        if axis is None:
            continue
        if axis not in coords:
            raise ValueError(f"{what}: no coordinate on the axis {axis!r}")
        index, size = coords[axis]
        if shape[k] % size:
            raise ValueError(f"{what}: dim {k} of {tuple(shape)} "
                             f"({shape[k]}) does not divide over the "
                             f"{axis!r} axis of {size}")
        out.append((k, (index, size)))
    return out


def shard_flax(params, specs, coords, path=""):
    """The shard at ``coords`` (``{axis: (index, size)}``) of the flax tree
    ``params`` (nested dicts of arrays), each leaf cut along every dim
    its spec (the same nesting, a tuple a leaf) names an axis for."""
    if isinstance(params, dict):
        return {k: shard_flax(v, specs[k], coords, f"{path}/{k}")
                for k, v in params.items()}
    x = params
    for k, coord in _spec_dims(specs, coords, x.shape, path[1:]):
        x = _block(x, k, coord)
    return x


def _cat(parts, dim):
    if torch.is_tensor(parts[0]):
        return torch.cat(parts, dim=dim)
    return np.concatenate([np.asarray(p) for p in parts], axis=dim)


def _unshard_leaf(parts, dims, coords):
    """The whole leaf from ``parts`` (``parts[i]`` at ``coords[i]``), cut
    along each ``(dim, axis)`` of ``dims``: the blocks along the first dim
    are concatenated in index order among the parts that share their
    coordinates on the other axes, and so on down the dims, the inverse
    of ``shard_flax``'s cuts. A part at coordinates seen before (a replica
    over an axis the leaf is not cut over) is skipped."""
    if not dims:
        return parts[0]
    (k, axis), rest = dims[0], dims[1:]
    size = coords[0][axis][1]
    groups = {}
    for x, c in zip(parts, coords):
        key = tuple(c[a] for _, a in rest)
        groups.setdefault(key, {}).setdefault(c[axis][0], x)
    merged, where = [], []
    for key, by_index in groups.items():
        merged.append(_cat([by_index[i] for i in range(size)], k))
        where.append({a: coord for (_, a), coord in zip(rest, key)})
    return _unshard_leaf(merged, rest, where)


def unshard_flax(shards, specs, coords):
    """The whole flax tree from the shards of every rank (``shards[i]``
    at ``coords[i]``): each leaf concatenated along each dim its spec
    shards, in index order, the inverse of ``shard_flax`` (numpy arrays,
    or torch tensors)."""
    first = shards[0]
    if isinstance(first, dict):
        return {k: unshard_flax([s[k] for s in shards], specs[k], coords)
                for k in first}
    dims = [(k, axis) for k, axis in enumerate(specs) if axis is not None]
    return _unshard_leaf(shards, dims, coords)


def _torch_dim(layout, k):
    """The torch dim that flax dim ``k`` of a ``layout`` leaf lies on."""
    perm, split = LAYOUTS[layout or "same"]
    if perm is None:
        return k
    if split is not None:
        if k == split + 1:
            raise ValueError("a head's own dim does not shard")
        if k > split + 1:
            k -= 1
    return perm[k]


def _meta_flax(p, layout, spec):
    return _to_flax(torch.empty(p.shape, device="meta"), layout, spec)


def flax_shapes(model):
    """``model``'s flax tree of meta tensors: each leaf's flax shape, no
    data."""
    return _nest([(path, _meta_flax(model.get_parameter(name), layout, model))
                  for path, name, layout in _table(model)])


def cut_module(module, specs, coords):
    """Cut ``module``'s parameters in place to the shard at ``coords``:
    each parameter of its table replaced by its block along the torch
    dims its spec (``specs``, nested by flax path) shards."""
    for path, name, layout in _table(module):
        p = module.get_parameter(name)
        what = "/".join(path)
        shape = _meta_flax(p, layout, module).shape
        x = p.detach()
        for k, coord in _spec_dims(_leaf(specs, path), coords, shape, what):
            x = _block(x, _torch_dim(layout, k), coord)
        if x.shape != p.shape:
            owner, _, leaf = name.rpartition(".")
            setattr(module.get_submodule(owner), leaf,
                    torch.nn.Parameter(x.clone()))


def flax_named_parameters(model):
    """``(flax_path, parameter, layout)`` of ``model``, in the order
    ``jax.tree_util.tree_leaves`` gives the leaves of its flax tree: pass
    it as ``DistributedOptimizer(named_parameters=...)`` so the port packs
    its buckets leaf for leaf, and each leaf element for element, as the
    JAX package does."""
    for path, name, layout in sorted(_table(model)):
        yield "/".join(path), model.get_parameter(name), layout


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


# -- the train state as the JAX TrainState's flat leaf list -----------------

class _Named:
    """An optax state namedtuple: its fields, in order, as ``(name,
    child)`` (an ``EmptyState`` has none)."""

    def __init__(self, *fields):
        self.fields = fields


class _Slot:
    """One leaf of the train state: ``get()`` its live value in flax
    layout (a view where the state holds a tensor, no copy),
    ``set(array)`` writes a flax-layout array into the live state."""

    def __init__(self, get, set):
        self.get, self.set = get, set


def _walk(node, path=""):
    """``(key path, leaf)`` in ``jax.tree_util.tree_flatten`` order, the
    key path as ``jax.tree_util.keystr`` writes it."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _walk(node[k], f"{path}[{k!r}]")
    elif isinstance(node, tuple):
        for i, child in enumerate(node):
            yield from _walk(child, f"{path}[{i}]")
    elif isinstance(node, _Named):
        for name, child in node.fields:
            yield from _walk(child, f"{path}.{name}")
    else:
        yield path, node


def _state_dict(node):
    """flax ``serialization.to_state_dict`` of the same tree."""
    if isinstance(node, dict):
        return {k: _state_dict(node[k]) for k in sorted(node)}
    if isinstance(node, tuple):
        return {str(i): _state_dict(c) for i, c in enumerate(node)}
    if isinstance(node, _Named):
        return {name: _state_dict(c) for name, c in node.fields}
    return node


def _nest(rows):
    """``[(path tuple, leaf)]`` -> nested dicts."""
    tree = {}
    for path, leaf in rows:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def _load(dst, arr, layout):
    """Write the flax-layout array ``arr`` into the tensor ``dst``: the
    array goes to ``dst``'s device as it is and is permuted there."""
    with warnings.catch_warnings():
        # a restored array may be read-only; it is only read here
        warnings.simplefilter("ignore", UserWarning)
        src = torch.from_numpy(np.ascontiguousarray(arr))
    src = src.to(dst.device)
    with torch.no_grad():
        dst.copy_(_to_torch(src, layout))


def _scalar_dtype():
    # torch.optim's own choice for a per-parameter ``step``
    return (torch.float64 if torch.get_default_dtype() == torch.float64
            else torch.float32)


def _opt_kind(inner):
    if isinstance(inner, torch.optim.AdamW):
        if inner.param_groups[0].get("amsgrad"):
            raise NotImplementedError("AdamW(amsgrad=True) keeps a state "
                                      "that optax.adamw has not")
        return "adamw"
    if type(inner) is torch.optim.Adam:
        if inner.param_groups[0].get("amsgrad") or \
                inner.param_groups[0].get("weight_decay"):
            raise NotImplementedError("Adam(amsgrad=True) or with weight "
                                      "decay keeps a state or takes a "
                                      "step that optax.adam has not")
        return "adam"
    if type(inner) is torch.optim.SGD:
        return "sgd"
    raise NotImplementedError(
        f"no optax state mapping for {type(inner).__name__}: the "
        "checkpoint carries torch.optim.AdamW (optax.adamw), "
        "torch.optim.Adam (optax.adam) and torch.optim.SGD (optax.sgd)")


def _count_slot(inner, params):
    """optax's int32 ``count`` <-> torch's per-parameter float ``step``
    (the same count: both increment before the bias correction)."""
    def get():
        steps = {int(inner.state[p]["step"]) for p in params
                 if "step" in inner.state.get(p, {})}
        if len(steps) > 1:
            raise ValueError(f"parameters at different steps: {steps}")
        return np.asarray(steps.pop() if steps else 0, np.int32)

    def set(arr):
        group = inner.param_groups[0]
        on_device = group.get("capturable") or group.get("fused")
        for p in params:
            inner.state[p]["step"] = torch.tensor(
                float(np.asarray(arr)), dtype=_scalar_dtype(),
                device=p.device if on_device else "cpu")

    return _Slot(get, set)


def _moment_slot(inner, p, key, layout, spec):
    """A per-parameter state tensor (AdamW's ``exp_avg``/``exp_avg_sq``,
    SGD's ``momentum_buffer``) in flax layout; zeros where torch has
    none yet (optax's initial state)."""
    def get():
        v = inner.state.get(p, {}).get(key)
        if v is None:
            v = torch.zeros_like(p)
        return _to_flax(v.detach(), layout, spec)

    def set(arr):
        buf = torch.empty_like(p, memory_format=torch.contiguous_format)
        _load(buf, arr, layout)
        inner.state[p][key] = buf

    return _Slot(get, set)


def _optax_state(inner, params, layouts, spec, tree):
    """The optax state of ``optax.adamw``, ``optax.adam`` or
    ``optax.sgd`` over ``params`` (each with its flax path and layout), as
    ``tree`` nests the per-parameter pieces: a ``_Named`` chain of the
    same fields (adam's chain lacks adamw's weight-decay link)."""
    kind = _opt_kind(inner)
    empty = _Named()
    if kind in ("adamw", "adam"):
        mu = tree([_moment_slot(inner, p, "exp_avg", lay, spec)
                   for p, lay in zip(params, layouts)])
        nu = tree([_moment_slot(inner, p, "exp_avg_sq", lay, spec)
                   for p, lay in zip(params, layouts)])
        adam = _Named(("count", _count_slot(inner, params)), ("mu", mu),
                      ("nu", nu))
        return (adam, empty, empty) if kind == "adamw" else (adam, empty)
    if not inner.param_groups[0].get("momentum"):
        return (empty, empty)
    trace = tree([_moment_slot(inner, p, "momentum_buffer", lay, spec)
                  for p, lay in zip(params, layouts)])
    return (_Named(("trace", trace)), empty)


def _is_hvd_optimizer(optimizer):
    from horovod_tpu_torch.hvd_torch import DistributedOptimizer
    return isinstance(optimizer, DistributedOptimizer)


def _int_slot(obj, attr):
    """An int attribute of ``obj`` (0 where it has none) as an int32
    scalar leaf."""
    return _Slot(lambda: np.asarray(getattr(obj, attr, 0), np.int32),
                 lambda arr: setattr(obj, attr, int(np.asarray(arr))))


def _acc_slot(optimizer, j, layout, spec):
    """Parameter ``j``'s running mean of ``backward_passes_per_step``'s
    gradients (``optimizer._acc``) in flax layout: zeros where no window
    is open, as optax's ``acc_grads`` are after an update."""
    p = optimizer.params[j]

    def get():
        acc = optimizer._acc
        v = torch.zeros_like(p) if acc is None else acc[j]
        return _to_flax(v.detach(), layout, spec)

    def set(arr):
        if optimizer._acc is None:
            optimizer._acc = [torch.zeros_like(q) for q in optimizer.params]
        _load(optimizer._acc[j], arr, layout)

    return _Slot(get, set)


def _multi_steps(optimizer, inner, layouts, spec, tree):
    """``optax.MultiSteps``'s ``MultiStepsState(mini_step, gradient_step,
    inner_opt_state, acc_grads, skip_state)`` of a
    ``DistributedOptimizer(backward_passes_per_step=k)``: ``inner`` the
    chained state, the accumulator in flax layout, no skip state (optax's
    default ``should_skip_update_fn`` keeps none)."""
    acc = tree([_acc_slot(optimizer, j, lay, spec)
                for j, lay in enumerate(layouts)])
    return _Named(("mini_step", _int_slot(optimizer, "_mini_step")),
                  ("gradient_step", _int_slot(optimizer, "_gradient_step")),
                  ("inner_opt_state", inner), ("acc_grads", acc),
                  ("skip_state", ()))


def _is_model_shard(model, optimizer):
    """A tensor- or expert-parallel state: a list of model shards held in
    one process, or one model shard (``parallel.tensor.shard_lm_state``)
    with the plain optimizer ``make_tp_lm_train_step`` takes."""
    if isinstance(model, (list, tuple)):
        return True
    return getattr(model, "shard", None) is not None and \
        not _is_hvd_optimizer(optimizer)


def _model_leaves(model):
    """``(params, layouts, tree, p_tree)``: ``model``'s parameters and
    their layouts in flax order, ``tree(slots)`` nesting one slot a
    parameter by its flax path, and the parameters' own slots so
    nested."""
    table = sorted(_table(model))
    params = [model.get_parameter(name) for _, name, _ in table]
    layouts = [layout for _, _, layout in table]
    paths = [path for path, _, _ in table]

    def tree(slots):
        return _nest(list(zip(paths, slots)))

    def param_slot(p, layout):
        return _Slot(lambda: _to_flax(p.detach(), layout, model),
                     lambda arr: _load(p, arr, layout))

    p_tree = tree([param_slot(p, lay) for p, lay in zip(params, layouts)])
    return params, layouts, tree, p_tree


def _model_tree(model, inner):
    """``(params, opt_state)`` of one model as trees of ``_Slot``s, the
    opt state the bare optax state of the plain optimizer ``inner`` (None:
    ``{}``), as the JAX tensor-parallel ``TrainState`` holds
    ``tx.init(params)``."""
    params, layouts, tree, p_tree = _model_leaves(model)
    opt = {} if inner is None else _optax_state(inner, params, layouts,
                                                model, tree)
    return p_tree, opt


def _zip_slots(nodes, combine, keys=()):
    """The trees ``nodes`` (one a shard, the same structure) as one tree:
    each leaf ``combine(the shards' slots, its dict keys)``."""
    first = nodes[0]
    if isinstance(first, dict):
        return {k: _zip_slots([n[k] for n in nodes], combine, keys + (k,))
                for k in first}
    if isinstance(first, tuple):
        return tuple(_zip_slots([n[i] for n in nodes], combine, keys)
                     for i in range(len(first)))
    if isinstance(first, _Named):
        return _Named(*[(name, _zip_slots([n.fields[i][1] for n in nodes],
                                          combine, keys))
                        for i, (name, _) in enumerate(first.fields)])
    return combine(nodes, keys)


def _shard_tree(model, optimizer):
    """``(params, opt_state)`` of a tensor- or expert-parallel state as
    the JAX ``TrainState`` of ``parallel/tensor.py``'s ``shard_lm_state``
    holds it: every leaf whole, in flax layout. ``model`` is one shard
    (its axes groups of the installed mesh) or a list of shards held in
    this process, ``optimizer`` its plain optimizer or a list of them.

    A leaf that a spec of ``transformer_param_specs`` cuts (a moment its
    parameter's) reads as a ``ckpt.GatheredLeaf``: its ``gather()``
    concatenates the shards over the model and expert axes, over the
    axes' process groups (``GroupAxis.all_gather``, a collective) or, for
    shards held here, with ``unshard_flax``'s concatenation. Setting a
    leaf cuts the whole array at each shard's coordinates, as
    ``shard_flax`` does, so any (data, model, expert) shape reads what
    any other wrote."""
    from horovod_tpu_torch.ckpt import GatheredLeaf
    from horovod_tpu_torch.parallel import axis as axis_lib
    from horovod_tpu_torch.parallel import tensor
    local = isinstance(model, (list, tuple))
    models = list(model) if local else [model]
    if optimizer is None:
        optimizers = [None] * len(models)
    else:
        optimizers = list(optimizer) if local else [optimizer]
    shards = [m.shard or tensor.Shard() for m in models]
    s0 = shards[0]
    specs = tensor.transformer_param_specs(models[0], s0.model_axis,
                                           s0.expert_axis)
    coords = [s.coords() for s in shards]
    sizes = {axis: n for axis, (_, n) in coords[0].items()}
    trees = [_model_tree(m, o) for m, o in zip(models, optimizers)]

    def combine(slots, keys):
        spec = _leaf(specs, keys) if keys else ()
        dims = [(k, axis) for k, axis in enumerate(spec)
                if axis is not None and sizes.get(axis, 1) > 1]

        def set(arr):
            for slot, c in zip(slots, coords):
                x = arr
                for k, axis in dims:
                    x = _block(x, k, c[axis])
                slot.set(x)

        if not dims:
            return _Slot(slots[0].get, set)

        def gather():
            if local:
                return _unshard_leaf([s.get() for s in slots], dims, coords)
            x = slots[0].get()
            for k, axis in dims:
                x = axis_lib.GroupAxis(axis).all_gather([x], dim=k)[0]
            return x

        def get():
            x = slots[0].get()
            shape = list(x.shape)
            for k, axis in dims:
                shape[k] *= sizes[axis]
            return GatheredLeaf(gather, tuple(shape), x.dtype, x.device,
                                collective=not local)

        return _Slot(get, set)

    p_tree = _zip_slots([t[0] for t in trees], combine)
    opt = _zip_slots([t[1] for t in trees], combine)
    return p_tree, opt


def gathers_across_ranks(model, optimizer=None):
    """True where reading the train state of ``model`` and ``optimizer``
    runs collectives that every rank must join: a model shard whose
    model or expert axis spans ranks of the installed mesh."""
    if not _is_model_shard(model, optimizer) or \
            isinstance(model, (list, tuple)):
        return False
    return any(n > 1 for _, n in model.shard.coords().values())


class _ZeroSlots:
    """ZeRO-1's state as the JAX ``ZeroState``: the row optimizer's optax
    state over ``{"b<i>": [world, shard]}``, of which this rank holds
    row ``rank`` of each bucket (``zero.row_index``)."""

    def __init__(self, optimizer):
        from horovod_tpu_torch.parallel import mesh as mesh_lib
        from horovod_tpu_torch.parallel import zero
        zs = optimizer.zero_state
        self.schedule = zs.plan.schedule
        # the row this rank holds: its index over the rows' axes (its
        # rank on init()'s meshes), (data, dcn)-major under a
        # hierarchical schedule; replicas along the other axes hold the
        # same row, and replica 0 writes it
        self.rank = zero.row_index(self.schedule)
        self.replica = mesh_lib.get_mesh().replica_index(self.schedule.axes)
        keyed = {f"b{i}": row for i, row in enumerate(zs.rows)}
        names = sorted(keyed)
        rows = [keyed[k] for k in names]
        self.inner = _optax_state(zs.inner, rows, [None] * len(rows), None,
                                  lambda slots: dict(zip(names, slots)))
        self.entries = []
        for key, slot in _walk(self.inner):
            bucket = None
            if key.endswith("']") and "['b" in key:
                bucket = int(key.rsplit("['b", 1)[1][:-2])
            self.entries.append((key, bucket, slot))

    def resolve(self):
        """A ``ckpt.ZeroLeaf`` of live views: ``{rank: row}`` for each
        bucket leaf, the value for each replicated one."""
        from horovod_tpu_torch import ckpt
        return ckpt.ZeroLeaf(self.schedule, self.rank, [
            (key, b, slot.get() if b is None else {self.rank: slot.get()})
            for key, b, slot in self.entries], replica=self.replica)

    def load(self, leaf):
        """Write a restored ``ckpt.ZeroLeaf`` into the rows: each bucket
        leaf the whole ``[world, shard]`` array of this world, or
        ``{row: array}`` holding this rank's row (an elastic state's
        in-memory commit)."""
        got = {key: value for key, _, value in leaf.entries}
        for key, bucket, slot in self.entries:
            if key not in got:
                raise ValueError(f"the ZeRO-1 state has no leaf {key!r}")
            value = got[key]
            if bucket is not None:
                value = (value[self.rank] if isinstance(value, dict)
                         else np.asarray(value)[self.rank])
            slot.set(value)

    def state_tree(self):
        """The ``[world, shard]`` tree of flax's ``to_state_dict``, for the
        single-file checkpoint: only a world of one holds every row."""
        if self.schedule.world != 1:
            raise NotImplementedError(
                "a ZeRO-1 state in one file needs every row on one "
                "process: save it at world > 1 with ckpt.save_sharded")
        return _state_dict(self.inner)


def _train_state_tree(model, optimizer, step_state):
    """The JAX ``TrainState``'s four children as trees of ``_Slot``s (a
    ``ZeroLeaf`` for ZeRO-1's state)."""
    step = _int_slot(step_state, "step")
    if _is_model_shard(model, optimizer):
        return (*_shard_tree(model, optimizer), {}, step)
    params, layouts, tree, p_tree = _model_leaves(model)
    if optimizer is not None and not _is_hvd_optimizer(optimizer):
        # a plain torch optimizer stepped on averaged gradients: the
        # bare optax state, as the JAX examples that run ``optax.sgd``
        # after an explicit allreduce save it
        return (p_tree, _optax_state(optimizer, params, layouts, model,
                                     tree), _stats_tree(model),
                _int_slot(step_state, "step"))
    if optimizer is not None and \
            [id(p) for p in params] != [id(p) for p in optimizer.params]:
        raise ValueError("the optimizer must pack the model's parameters "
                         "in flax order: DistributedOptimizer(named_"
                         "parameters=convert.flax_named_parameters(model))")
    if optimizer is None:
        opt = {}
    elif optimizer.zero_state is not None:
        opt = _ZeroSlots(optimizer)
    else:
        opt = (_Named(), _optax_state(optimizer.optimizer, params, layouts,
                                      model, tree))
        if optimizer.backward_passes_per_step > 1:
            opt = _multi_steps(optimizer, opt, layouts, model, tree)
    return p_tree, opt, _stats_tree(model), step


def _stats_tree(model):
    """A ResNet's BatchNorm statistics as the flax ``batch_stats`` tree of
    ``_Slot``s; ``{}`` for a model without them."""
    if not isinstance(model, ResNet):
        return {}

    def stat_slot(buf):
        return _Slot(lambda: buf.detach(),
                     lambda arr: _load(buf, arr, "same"))
    return _nest([(path, stat_slot(model.get_buffer(name)))
                  for path, name in _stats_table(model)])


def _flat_slots(model, optimizer, step_state):
    out = []
    for i, child in enumerate(_train_state_tree(model, optimizer,
                                                step_state)):
        out += list(_walk(child, f"[<flat index {i}>]"))
    return out


def train_state_paths(model, optimizer):
    """The key path of each leaf of ``train_state_to_flat``, as
    ``jax.tree_util.keystr`` writes the JAX ``TrainState``'s."""
    class _Step:
        step = 0
    return [path for path, _ in _flat_slots(model, optimizer, _Step())]


def train_state_to_flat(model, optimizer, step_state):
    """The port's training state as the JAX ``TrainState(params,
    opt_state, batch_stats, step)``'s flat leaf list: ``model``'s
    parameters in flax order and layout, ``optimizer``'s state (a
    ``DistributedOptimizer`` over ``torch.optim.AdamW``, ``Adam`` or
    ``SGD``: ``(EmptyState(), (ScaleByAdamState(count, mu, nu),
    EmptyState(), EmptyState()))`` (adam without the middle link) or
    ``(EmptyState(), (TraceState(trace), EmptyState()))``; under ZeRO-1
    one ``ckpt.ZeroLeaf``; with ``backward_passes_per_step > 1`` that
    chain inside optax's ``MultiStepsState``; a plain torch optimizer
    the bare optax state, without the leading ``EmptyState()``), a
    ResNet's BatchNorm statistics and
    ``step_state.step`` as an int32 scalar. A tensor- or expert-parallel
    state (``model`` a shard from ``parallel.tensor.shard_lm_state`` with
    its plain AdamW or SGD, or lists of the shards held in this process
    and their optimizers, as ``make_tp_lm_train_step_shards`` takes them)
    is the JAX tensor-parallel ``TrainState(params, tx.init(params), {},
    step)`` with every leaf whole: a cut leaf comes back as a
    ``ckpt.GatheredLeaf`` (``_shard_tree``). Tensors come back as live
    views (the checkpoint's snapshot copies them); counts as numpy int32
    scalars."""
    leaves = []
    for _, slot in _flat_slots(model, optimizer, step_state):
        if isinstance(slot, _Slot):
            leaves.append(slot.get())
        else:  # a ZeroLeaf of slots
            leaves.append(slot.resolve())
    return leaves


def train_state_from_flat(model, optimizer, step_state, leaves):
    """Write the flat leaf list (``train_state_to_flat``'s form, or what
    ``ckpt.restore_sharded`` returns for it) into ``model``, ``optimizer``
    and ``step_state``, in place."""
    slots = _flat_slots(model, optimizer, step_state)
    if len(leaves) != len(slots):
        raise ValueError(f"{len(leaves)} leaves for a train state of "
                         f"{len(slots)}")
    for (path, slot), leaf in zip(slots, leaves):
        if isinstance(slot, _Slot):
            slot.set(leaf)
        else:
            slot.load(leaf)


def train_state_trees(model, optimizer=None, step_state=None):
    """``(params, opt_state)`` as flax ``serialization.to_state_dict``
    writes the JAX ``TrainState``'s (the single-file ``checkpoint.py``'s
    two trees; ``{}`` for no optimizer), each leaf a live view in flax
    layout."""
    p_tree, opt, _, _ = _train_state_tree(model, optimizer, step_state)
    opt = ({"inner": _rows_tree(opt.state_tree())}
           if isinstance(opt, _ZeroSlots) else _state_dict(opt))

    def get(node):
        if isinstance(node, dict):
            return {k: get(v) for k, v in node.items()}
        return node.get()

    return get(_state_dict(p_tree)), get(opt)


def load_train_state_trees(model, optimizer, step_state, params,
                           opt_state=None):
    """Write ``train_state_trees``' two trees (numpy, flax layout) into
    the live state."""
    p_tree, opt, _, _ = _train_state_tree(model, optimizer, step_state)
    opt = ({"inner": _rows_tree(opt.state_tree())}
           if isinstance(opt, _ZeroSlots) else _state_dict(opt))

    def put(node, value, where):
        if isinstance(node, dict):
            if set(node) != set(value):
                raise ValueError(f"{where}: keys {sorted(value)}, expected "
                                 f"{sorted(node)}")
            for k in node:
                put(node[k], value[k], f"{where}/{k}")
        else:
            node.set(value)

    put(_state_dict(p_tree), params, "params")
    put(opt, {} if opt_state is None else opt_state, "opt_state")


def _rows_tree(node):
    """A world-of-one ZeRO state tree whose bucket leaves (``b<i>`` keys)
    read and write ``[1, shard]`` arrays, as the JAX rows are shaped."""
    if not isinstance(node, dict):
        return node
    out = {}
    for k, v in node.items():
        if k.startswith("b") and k[1:].isdigit() and isinstance(v, _Slot):
            v = _Slot(lambda v=v: v.get()[None],
                      lambda arr, v=v: v.set(np.asarray(arr)[0]))
        out[k] = _rows_tree(v)
    return out
