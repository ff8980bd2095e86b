"""Tensor and expert parallelism: the port of
``horovod_tpu/parallel/tensor.py``.

The JAX package shards the transformer's weights over a ``model`` mesh
axis (and its MoE experts over an ``expert`` axis) by name rules
(``transformer_param_specs``) and lets GSPMD place the collectives. Here
the same rules cut each rank's shard of the weights (``Shard``,
``shard_lm_state``), and the collectives are written out, Megatron's
column/row-parallel schedule for the model axis and GShard's for the
expert axis (``models/transformer.py``, ``models/moe.py``):

* query/key/value ``(d_model, H, D)``: heads sharded (column-parallel),
  so attention is head-parallel; attention out ``(H, D, d_model)``: heads
  sharded (row-parallel, one sum into the residual);
* MLP ``Dense_0 (d_model, d_ff)`` column-parallel, ``Dense_1 (d_ff,
  d_model)`` row-parallel (one more sum);
* ``lm_head (d_model, vocab)`` column-parallel: the logits stay
  vocab-sharded and the loss reads them there (fp32 max and sum of
  exponentials over the model axis, the target's logit from the rank
  that holds it);
* the MoE's expert-major ``w_in``/``w_out`` over the expert axis; norms,
  embedding and the gate replicated.

``make_tp_lm_train_step`` takes a plain torch optimizer, as the JAX step
takes plain optax: the JAX step's gradient is that of the global-batch
mean loss, which GSPMD reduces over the data axis; here each rank's loss
is its share of that mean and the step averages the gradients over
``batch_axis`` itself. Every rank of the model and expert axes computes
the replicated parts alike, so their gradients need no further sum.

The step and the model are written once over ``parallel/axis.py``'s axis
objects: ``GroupAxis`` in a job (``make_tp_lm_train_step``), ``LocalAxis``
with every rank in one process (``make_tp_lm_train_step_shards``, which
the tests and ``chip_smoke.py`` drive).
"""

import dataclasses
from typing import Optional

import torch
from torch import nn

from horovod_tpu_torch import convert
from horovod_tpu_torch.models.moe import aux_loss, expert_major_spec
from horovod_tpu_torch.models.transformer import (Axes, Transformer,
                                                  forward_shards)
from horovod_tpu_torch.ops import fusion
from horovod_tpu_torch.ops.reduction import Average
from horovod_tpu_torch.parallel import axis as axis_lib
from horovod_tpu_torch.parallel import mesh as mesh_lib


@dataclasses.dataclass(frozen=True)
class Shard:
    """Where one rank's shard of a model lies: its index and the size of
    the model axis and of the expert axis (each None where the model is
    not sharded over one), and the axis its batch is sharded over (the
    MoE's token groups read it)."""
    model_axis: Optional[str] = None
    model_index: int = 0
    model_size: int = 1
    expert_axis: Optional[str] = None
    expert_index: int = 0
    expert_size: int = 1
    batch_axis: Optional[str] = None

    @classmethod
    def of(cls, mesh, model_axis=None, expert_axis=None, batch_axis=None):
        """This rank's shard on ``mesh`` (its coordinates)."""
        def coord(axis):
            if axis is None:
                return 0, 1
            return mesh.axis_index(axis), mesh.axis_size(axis)
        return cls(model_axis, *coord(model_axis), expert_axis,
                   *coord(expert_axis), batch_axis)

    def coords(self):
        """``{axis: (index, size)}`` of the axes the weights are cut over."""
        out = {}
        if self.model_axis is not None:
            out[self.model_axis] = (self.model_index, self.model_size)
        if self.expert_axis is not None:
            out[self.expert_axis] = (self.expert_index, self.expert_size)
        return out

    def axes(self):
        """The ``Axes`` of this rank's shard on the installed mesh."""
        return Axes(axis_lib.group_axis(self.model_axis),
                    axis_lib.group_axis(self.expert_axis),
                    axis_lib.group_axis(self.batch_axis))


def transformer_param_specs(params, model_axis="model", expert_axis=None):
    """The name-rule spec of every leaf of a transformer's flax tree
    (``params``: nested dicts of arrays, or a ``Transformer``, read in
    flax layout), a tree of the same nesting whose leaves are flax's
    ``PartitionSpec``s as tuples. ``model_axis=None`` disables the
    tensor-parallel rules; ``expert_axis`` shards the MoE blocks' expert
    weights over that axis. Anything the rules do not name (norm scales,
    the embedding, MoE gates) is replicated, ``()``."""
    if isinstance(params, nn.Module):
        params = convert.flax_shapes(params)

    def spec_for(joined, leaf):
        if expert_axis and "moe/" in joined:
            spec = expert_major_spec(joined, expert_axis)
            if spec is not None:
                return spec                      # experts over the axis
        if model_axis is None:
            return ()
        if any(f"{p}/kernel" in joined for p in ("query", "key", "value")):
            return (None, model_axis, None)      # column: shard heads
        if "out/kernel" in joined and leaf.ndim == 3:
            return (model_axis, None, None)      # row: reduce to residual
        if "Dense_0/kernel" in joined:
            return (None, model_axis)            # column: shard d_ff
        if "Dense_1/kernel" in joined:
            return (model_axis, None)            # row: reduce to residual
        if "lm_head/kernel" in joined:
            return (None, model_axis)            # vocab-sharded logits
        return ()

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        return spec_for(path[1:], node)
    return walk(params, "")


def cut_transformer(model, shard):
    """Cut ``model``'s parameters in place to ``shard`` by
    ``transformer_param_specs`` (``ValueError`` where an axis does not
    divide the heads, ``d_ff``, the vocabulary or the experts)."""
    cfg = model.cfg
    if shard.expert_axis is not None and shard.expert_axis != cfg.expert_axis:
        raise ValueError(f"the experts are cut over cfg.expert_axis "
                         f"{cfg.expert_axis!r}, not {shard.expert_axis!r}")
    specs = transformer_param_specs(model, shard.model_axis,
                                    shard.expert_axis)
    convert.cut_module(model, specs, shard.coords())
    model.shard = shard
    for block in model.blocks:
        block.shard = shard
        if block.use_moe:
            block.moe.expert_index = shard.expert_index
            block.moe.expert_size = shard.expert_size


def shard_lm_state(cfg, mesh=None, model_axis="model", expert_axis=None,
                   batch_axis="data", params=None, generator=None,
                   device=None):
    """This rank's shard of a transformer LM on ``mesh`` (the installed
    mesh by default): the weights of ``params`` (a flax tree of arrays,
    carried across from the JAX package) or drawn from ``generator``,
    cut by the rule specs at this rank's coordinates, on ``device`` (the
    mesh's by default). Build the optimizer over its parameters; its
    state takes their shapes, the counterpart of the JAX state's
    moments in the rule shardings."""
    mesh = mesh or mesh_lib.get_mesh()
    shard = Shard.of(mesh, model_axis, expert_axis, batch_axis)
    model = Transformer(cfg, generator=generator, shard=shard)
    if params is not None:
        specs = transformer_param_specs(params, model_axis, expert_axis)
        model.load_state_dict(convert.params_from_flax(
            convert.shard_flax(params, specs, shard.coords()), model))
    return model.to(device or mesh.device)


def vocab_parallel_cross_entropy(axis, logits, targets):
    """Each shard's mean next-token loss from vocab-sharded logits: shard
    ``i`` of ``axis`` holds ``logits[i]`` ``[..., V/R]``, the block
    ``[i V/R, (i+1) V/R)`` of the vocabulary, all fp32. The log-sum-exp
    takes the maximum and the sum of exponentials over the axis, and the
    target's logit comes from the shard that holds it: the exact loss of
    ``log_softmax`` over the full logits, and its gradient on each
    shard's block."""
    v = logits[0].shape[-1]
    maxes = axis.all_max([x.detach().amax(dim=-1) for x in logits])
    sums = axis.reduce_from([torch.exp(x - m[..., None]).sum(dim=-1)
                             for x, m in zip(logits, maxes)])
    picked = []
    for x, i, t in zip(logits, axis.indices, targets):
        local = t - i * v
        inside = (local >= 0) & (local < v)
        at = x.gather(-1, local.clamp(0, v - 1)[..., None])[..., 0]
        picked.append(torch.where(inside, at, torch.zeros_like(at)))
    picked = axis.reduce_from(picked)
    return [(m + torch.log(s) - p).mean()
            for m, s, p in zip(maxes, sums, picked)]


def make_tp_lm_train_step(model, optimizer, mesh=None, model_axis="model",
                          batch_axis="data", expert_axis=None,
                          moe_aux_weight=0.01, moe_z_weight=1e-3):
    """The tensor- and expert-parallel LM train step over the installed
    mesh (``mesh``, when given, must be it). ``model`` is this rank's
    shard from ``shard_lm_state`` over the same axes, ``optimizer`` a
    plain torch optimizer over its parameters. ``step(tokens)`` takes
    this rank's block of the global batch, ``[B / D, S]`` int tokens cut
    over ``batch_axis`` (``training.shard_lm_batch``; every rank of the
    model and expert axes takes the same block), runs forward, backward
    and the optimizer step, and returns the loss averaged over
    ``batch_axis``: the exact next-token loss over the vocab-sharded
    logits plus, for a MoE model (``cfg.moe_every``), ``aux_loss`` with
    the given weights. ``step.state`` counts the steps."""
    from horovod_tpu_torch import hvd_torch
    if isinstance(optimizer, hvd_torch.DistributedOptimizer):
        raise TypeError("make_tp_lm_train_step takes a plain torch "
                        "optimizer: the step averages the gradients over "
                        "batch_axis itself, and a DistributedOptimizer "
                        "would average the model shards over the world")
    installed = mesh_lib.get_mesh()
    if mesh is not None and mesh is not installed:
        raise ValueError("make_tp_lm_train_step(mesh=...) must be the "
                         "installed mesh: parallel.mesh.build_mesh installs "
                         "the mesh it builds")
    shard = model.shard or Shard()
    if (shard.model_axis, shard.expert_axis, shard.batch_axis) != \
            (model_axis, expert_axis, batch_axis):
        raise ValueError(
            f"the model is cut over model_axis={shard.model_axis!r}, "
            f"expert_axis={shard.expert_axis!r} with its batch over "
            f"{shard.batch_axis!r}; the step's are {model_axis!r}, "
            f"{expert_axis!r}, {batch_axis!r}: build it with "
            "shard_lm_state over the step's axes")
    if model.cfg.sequence_axis is not None:
        raise ValueError("make_tp_lm_train_step keeps the whole sequence "
                         "on a rank: build the model with "
                         "sequence_axis=None")
    step = make_tp_lm_train_step_shards(
        [model], [optimizer], shard.axes(), moe_aux_weight=moe_aux_weight,
        moe_z_weight=moe_z_weight)

    def one(tokens):
        return step([tokens.to(installed.device)])[0]

    one.state = step.state
    return one


def make_tp_lm_train_step_shards(models, optimizers, axes,
                                 moe_aux_weight=0.01, moe_z_weight=1e-3):
    """``make_tp_lm_train_step`` over shards: ``models`` and
    ``optimizers`` each shard's, ``axes`` an ``Axes`` of group axes (one
    shard, a job) or of ``LocalAxis`` objects (every rank in this
    process, ``axis.local_axes``). ``step(tokens)`` takes each shard's
    block of the batch and returns each shard's loss averaged over
    ``axes.batch``. Over a ``GroupAxis`` the gradients are averaged
    through the fused buckets; over a ``LocalAxis``, tensor by tensor.
    Both sum the data ranks' gradients in one order over two ranks, so
    the two forms give the same bits."""
    from horovod_tpu_torch.training import StepState, softmax_cross_entropy
    cfg = models[0].cfg
    n_data = axes.batch.n
    params = [list(m.parameters()) for m in models]
    state = StepState()

    def losses_of(tokens):
        logits = forward_shards(models, tokens, axes)
        targets = [t[:, 1:] for t in tokens]
        counts = [torch.tensor(float(t.numel()), device=t.device)
                  for t in targets]
        totals = axes.batch.all_reduce(counts)
        if axes.model.n == 1:  # the plain step's loss, op for op
            means = [softmax_cross_entropy(x[:, :-1], t)
                     for x, t in zip(logits, targets)]
        else:
            means = vocab_parallel_cross_entropy(
                axes.model, [x[:, :-1] for x in logits], targets)
        losses = [m * c * n_data / g for m, c, g in zip(means, counts,
                                                          totals)]
        if cfg.moe_every:
            losses = [loss + aux_loss(m, moe_aux_weight, moe_z_weight)
                      for loss, m in zip(losses, models)]
        return losses

    def average_grads():
        if n_data == 1:
            return
        grads = [[p.grad if p.grad is not None else torch.zeros_like(p)
                  for p in ps] for ps in params]
        if isinstance(axes.batch, axis_lib.GroupAxis):
            fusion.fused_allreduce_(grads[0], op=Average,
                                    axes=axes.batch.axis)
            for p, g in zip(params[0], grads[0]):
                p.grad = g
            return
        for j in range(len(params[0])):
            summed = axes.batch.all_reduce([g[j] for g in grads])
            for ps, s in zip(params, summed):
                ps[j].grad = s / n_data

    def step(tokens):
        for opt in optimizers:
            opt.zero_grad(set_to_none=True)
        losses = losses_of(tokens)
        torch.autograd.backward(losses)
        with torch.no_grad():
            average_grads()
            for opt in optimizers:
                opt.step()
            out = [x.detach() for x in losses]
            if n_data > 1:
                out = [s / n_data for s in axes.batch.all_reduce(out)]
        state.step += 1
        return out

    step.state = state
    return step
