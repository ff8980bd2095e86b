"""User-facing API: DistributedOptimizer, the startup broadcasts, metric
averaging and Join.

The port of ``horovod_tpu/hvd_jax.py``'s ``DistributedOptimizer``,
``distributed_value_and_grad``, ``broadcast_variables``,
``broadcast_optimizer_state``, ``allreduce_metrics`` and ``join`` in
Horovod's PyTorch form:
``DistributedOptimizer`` wraps a ``torch.optim`` optimizer, and its
``step()`` exchanges the parameters' ``.grad`` across ranks before the
inner step. Unlike the JAX optimizer, which returns new state,
everything here updates in place: the gradients, the parameters and the
inner optimizer's state. It is a ``torch.optim.Optimizer`` whose
``param_groups``, ``state``, ``defaults``, ``state_dict`` and
``load_state_dict`` are the inner optimizer's, as Horovod's torch
optimizer (``horovod_tpu/torch/__init__.py``) delegates them, so a
learning-rate scheduler or a callback that writes
``optimizer.param_groups`` drives it.
"""

import warnings

import torch
import torch.distributed as dist
from torch.utils import _pytree

from horovod_tpu_torch import basics, convert
from horovod_tpu_torch.ops import collective, fusion
from horovod_tpu_torch.ops import compression as compression_lib
from horovod_tpu_torch.ops.reduction import Average, Sum
from horovod_tpu_torch.parallel import mesh as mesh_lib
from horovod_tpu_torch.parallel import zero


class DistributedOptimizer(torch.optim.Optimizer):
    """Wrap ``optimizer`` so every ``step()`` first reduces (``op``,
    Average by default) the gradients of ``named_parameters`` across
    ranks. ``named_parameters`` (by default every parameter of the
    optimizer, in its order) fixes the order the buckets pack: pairs
    ``(name, parameter)``, or triples ``(name, parameter, layout)``. Pass
    ``convert.flax_named_parameters(model)`` to pack as the JAX package
    does: leaf for leaf, and element for element (each parameter as its
    flax array flattens) where the order inside a bucket changes a
    result, ZeRO-1's rows and a chunked quantizer's scales. A parameter
    without a gradient takes part with zeros, so every rank sends the
    same buckets.

    * The default exchange is one allreduce per fused bucket of at most
      ``threshold_bytes`` (``HOROVOD_FUSION_THRESHOLD`` when None);
      ``last_buckets`` holds the buckets of the latest one.
    * ``sharded_update=True`` is ZeRO stage 1 (``parallel/zero.py``):
      reduce-scatter per bucket of the reverse-order schedule, the inner
      optimizer's class and hyperparameters over this rank's 1/N chunk
      (``zero_state``), and an all-gather of the parameter deltas. Sum or
      Average only, one param group only; ``init()`` must have run.
    * ``backward_passes_per_step=k`` keeps a running mean of the
      gradients over k ``step()`` calls (``optax.MultiSteps``'s
      ``acc + (g - acc) / (n + 1)``) and exchanges and steps on every
      k-th; the other calls leave the parameters as they are. The
      checkpoint carries it as ``optax.MultiStepsState`` (``convert.py``:
      each rank's accumulator is its own mean, and a save keeps the copy
      of the rank that writes each leaf).
    * ``axes`` are the mesh axes the gradients are reduced over
      (``ops/collective.py``): None, the default, is the data axes, as
      in the JAX package (the world on a 1-D mesh and on ``init()``'s
      ``(dcn, data)`` mesh); ``("data", "seq")`` for a
      sequence-parallel LM on a (data, seq) mesh. ZeRO-1 and the
      overlapped pipeline of ``make_train_step`` may run over a part of
      the mesh (``("data",)`` on a (data, model) mesh): their rows and
      buckets are laid out over the axes' ranks, and the ranks along
      the other axes hold replicas.
    * ``op`` is Average, Sum, Min, Max or Adasum: Adasum reduces each
      fused bucket by ``ops/adasum.py`` (its XOR tree over one axis, its
      two-level composite across ``dcn``); it composes with a cast wire,
      not with a chunked one, ZeRO-1 or the overlapped pipeline.
    * ``hierarchical`` reduces Sum and Average in two levels
      (``parallel/hierarchical.py``: within a host, across ``dcn``, back)
      when the axes hold ``dcn`` and one more axis, in the fused
      allreduce, the ZeRO-1 plan and ``make_train_step``'s bucket
      schedule. None defers to ``HOROVOD_HIERARCHICAL_ALLREDUCE``, read
      at use (``hierarchical_resolved``).
    * ``compression`` is the wire format of the exchange: a compressor
      of ``ops/compression.py`` or its name (``"bf16"``, ``"fp8_e4m3"``,
      ``"int8"``, ...). ``"none"`` or ``Compression.none`` pins it
      uncompressed whatever ``HOROVOD_WIRE_DTYPE`` says; None defers to
      ``HOROVOD_WIRE_DTYPE``, read at use (the ``compression``
      property). A chunked format (fp8, int8) composes with Sum and
      Average only: given here with another op it raises, from the
      environment it is ignored with one warning. ``step()`` compresses
      statelessly; ``training.make_train_step(overlap_grads=True)``
      carries error feedback.

    Under ``sharded_update``, ``state_dict()`` also carries this rank's
    ZeRO-1 rows' state (``"zero"``: the rank, the world of the rows'
    axes, the row this rank owns (``zero.row_index``, which a
    hierarchical schedule permutes) and the row optimizer's
    ``state_dict``), and ``load_state_dict`` restores it where the world
    and the row match (a replica along the other axes holds the same
    row);
    the row optimizer takes the user's hyperparameters at every step, so
    a scheduler's learning rate reaches it on the next step."""

    def __init__(self, optimizer, named_parameters=None, op=Average,
                 compression=None, threshold_bytes=None,
                 backward_passes_per_step=1, sharded_update=False,
                 axes=None, hierarchical=None):
        if backward_passes_per_step < 1:
            raise ValueError("backward_passes_per_step must be >= 1, got "
                             f"{backward_passes_per_step}")
        if sharded_update:
            if op not in (Sum, Average):
                raise ValueError(
                    f"sharded_update supports Sum or Average, got {op!r}")
            if backward_passes_per_step > 1:
                raise ValueError(
                    "sharded_update accumulates via make_train_step("
                    "accum_steps=...); backward_passes_per_step>1 would "
                    "stack a second accumulator on top")
        self.optimizer = optimizer
        self.axes = axes
        self.op = op
        self.hierarchical = hierarchical
        self.threshold_bytes = threshold_bytes
        self.backward_passes_per_step = backward_passes_per_step
        self.sharded_update = sharded_update
        # called with this rank's reduce-scattered shard of each bucket a
        # chunked wire (or ZeRO-1) sends, when set (the GSPMD LM step's
        # island reads the gradient norm from them)
        self.shard_sink = None
        # None defers to HOROVOD_WIRE_DTYPE at use; an explicit "none"
        # pins the exchange uncompressed
        wire = compression_lib.resolve(compression)
        self._wire_forced_off = compression is not None and wire is None
        if wire is not None:
            self._check_wire(wire)
        self._compression = wire
        self._config_wire_warned = False
        owned = [p for group in optimizer.param_groups
                 for p in group["params"]]
        perms = None
        if named_parameters is None:
            params = owned
        else:
            named = [tuple(item) for item in named_parameters]
            params = [item[1] for item in named]
            if any(len(item) > 2 for item in named):
                perms = tuple(convert.flax_perm(item[2] if len(item) > 2
                                                else None)
                              for item in named)
        if {id(p) for p in params} != {id(p) for p in owned}:
            raise ValueError("named_parameters must name exactly the "
                             "parameters the optimizer updates")
        self.params = params
        # each parameter's flax dim order, for the buckets where the order
        # of elements changes a result (None: torch's own layout)
        self.perms = perms
        self.last_buckets = ()
        self.zero_state = None
        if sharded_update:
            self.zero_state = zero.init(optimizer, params, zero.make_plan(
                params, op=op, threshold_bytes=threshold_bytes,
                perms=perms, axes=axes,
                hierarchical=self.hierarchical_resolved()))
        # backward_passes_per_step's running mean and counters, optax
        # MultiStepsState's acc_grads, mini_step and gradient_step
        self._acc, self._mini_step, self._gradient_step = None, 0, 0

    # the torch.optim.Optimizer surface is the inner optimizer's
    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @property
    def state(self):
        return self.optimizer.state

    @property
    def defaults(self):
        return self.optimizer.defaults

    def state_dict(self):
        sd = self.optimizer.state_dict()
        if self.zero_state is not None:
            schedule = self.zero_state.plan.schedule
            sd["zero"] = {"rank": mesh_lib.get_mesh().rank,
                          "world": schedule.world,
                          "row": zero.row_index(schedule),
                          "state": self.zero_state.inner.state_dict()}
        return sd

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        rows = state_dict.pop("zero", None)
        if (rows is None) != (self.zero_state is None):
            raise ValueError(
                "the state dict was saved with"
                + ("out" if rows is None else "")
                + " ZeRO-1 rows; this optimizer has sharded_update="
                f"{self.zero_state is not None}")
        if rows is not None:
            schedule = self.zero_state.plan.schedule
            row = zero.row_index(schedule)
            # rows saved before the row was recorded were flat: row = rank
            saved = (rows["world"], rows.get("row", rows["rank"]))
            if saved != (schedule.world, row):
                raise ValueError(
                    f"ZeRO-1 row {saved[1]} of {saved[0]} (rank "
                    f"{rows['rank']}) cannot load into row {row} of "
                    f"{schedule.world} (rank {mesh_lib.get_mesh().rank}): "
                    "restore through horovod_tpu_torch.ckpt, which "
                    "reshards")
            self.zero_state.inner.load_state_dict(rows["state"])
        self.optimizer.load_state_dict(state_dict)

    def add_param_group(self, param_group):
        raise ValueError("DistributedOptimizer packs a fixed parameter "
                         "list: add the group to the inner optimizer "
                         "before wrapping it")

    def _check_wire(self, wire):
        if wire.chunked and self.op not in (Sum, Average):
            raise ValueError(
                f"chunked wire format {wire.name!r} only composes with "
                f"Sum/Average reductions (got {self.op!r}): per-chunk "
                "scales cannot ride a Min, Max or Adasum reduction. Use a "
                "bf16/float16 (cast) wire or no compression.")

    @property
    def compression(self):
        """The resolved wire format, or None for uncompressed: the
        explicit argument if one was given, else ``HOROVOD_WIRE_DTYPE``
        read now (an unknown name raises ``ValueError``). A format from
        the environment that this optimizer's op cannot take is ignored
        with one warning; only an explicit argument raises for it."""
        if self._compression is not None or self._wire_forced_off:
            return self._compression
        cfg = basics._state.config
        if cfg is None or not cfg.wire_dtype:
            return None
        wire = compression_lib.by_name(cfg.wire_dtype)
        if wire is None:
            return None
        try:
            self._check_wire(wire)
        except ValueError as e:
            if not self._config_wire_warned:
                self._config_wire_warned = True
                warnings.warn(f"ignoring HOROVOD_WIRE_DTYPE="
                              f"{cfg.wire_dtype!r} for this optimizer "
                              f"(op={self.op!r}): {e}", stacklevel=2)
            return None
        return wire

    def reduce_axes(self):
        """The axes the gradients are reduced over: ZeRO-1's rows' (its
        schedule's scatter order), else ``axes``, resolved on the
        installed mesh (None: the data axes)."""
        axes = (self.zero_state.plan.schedule.axes
                if self.zero_state is not None else self.axes)
        return (mesh_lib.get_mesh().resolve(axes) if axes is None
                else ((axes,) if isinstance(axes, str) else tuple(axes)))

    def hierarchical_resolved(self):
        """``hierarchical``, or with None ``HOROVOD_HIERARCHICAL_ALLREDUCE``
        read now (False before ``init()``)."""
        return bool(fusion.hierarchical_default(self.hierarchical))

    def zero_grad(self, set_to_none=True):
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def _grads(self):
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self.params]

    @torch.no_grad()
    def synchronize(self):
        """Allreduce the gradients in place, at the resolved wire
        format."""
        for p, g in zip(self.params, self._grads()):
            p.grad = g
        self.last_buckets = tuple(fusion.fused_allreduce_(
            [p.grad for p in self.params], op=self.op,
            threshold_bytes=self.threshold_bytes,
            compression=self.compression, perms=self.perms,
            axes=self.axes, hierarchical=self.hierarchical_resolved(),
            on_shard=self.shard_sink))

    @torch.no_grad()
    def _accumulate(self):
        """Fold this call's gradients into the running mean; on the k-th
        call hand the mean to ``.grad`` and return True."""
        grads = self._grads()
        if self._acc is None:
            self._acc = [torch.zeros_like(g) for g in grads]
        n = self._mini_step
        for acc, g in zip(self._acc, grads):
            acc.add_((g - acc) / (n + 1))
        self._mini_step += 1
        if self._mini_step < self.backward_passes_per_step:
            return False
        for p, acc in zip(self.params, self._acc):
            p.grad = acc
        self._acc, self._mini_step = None, 0
        self._gradient_step += 1
        return True

    def step(self, closure=None):
        if closure is not None:
            raise ValueError("DistributedOptimizer.step takes no closure: "
                             "compute the loss and backward first")
        if self.backward_passes_per_step > 1 and not self._accumulate():
            return None
        if self.zero_state is not None:
            zero.sharded_update(self.zero_state, self._grads(),
                                wire=self.compression,
                                on_shard=self.shard_sink)
            return None
        self.synchronize()
        return self.optimizer.step()

    def update_preaveraged(self):
        """The inner step on gradients that are already reduced across
        ranks (the overlap pipeline of ``training.make_train_step``
        reduce-scatters and all-gathers them itself, at its own wire
        format), so nothing here is compressed."""
        if self.sharded_update or self.backward_passes_per_step > 1:
            raise ValueError("update_preaveraged is the plain-optimizer "
                             "tail of the overlap pipeline")
        return self.optimizer.step()


    def update_spmd(self, grads, plan, wire=None, ag_residuals=None,
                    on_reduced=None):
        """The GSPMD path's update (``training.make_train_step(spmd=True)``
        routes here; JAX ``hvd_jax.py:211-245``). ``grads`` (one per
        parameter of ``self.params``, in that order) are the global-batch
        mean as the placements leave it: ``Partial`` DTensors, or this
        rank's local-mean gradients. No allreduce is chained: ZeRO-1 goes
        through ``gspmd.apply_shards_spmd``, whose redistributions are the
        reduce-scatter and the all-gather, and plain data parallelism
        through ``gspmd.reduce_spmd`` (``Partial`` buckets redistributed
        to ``Replicate()``) and the inner optimizer, whose state keeps
        its structure, so that ``state_dict()`` and checkpoints are the
        explicit path's. ``wire``/``ag_residuals`` narrow ZeRO-1's
        exchange with a cast wire (``apply_shards_spmd``); on plain data
        parallelism the step narrows the gradients itself.
        ``on_reduced(tensors)`` is called with the reduced global-mean
        gradient before the inner step reads it: this rank's ZeRO-1
        shards, or every parameter's whole ``.grad`` (the train step's
        gradient norm). Returns the new residuals under ZeRO-1, else the
        inner step's result."""
        from horovod_tpu_torch.parallel import gspmd
        if self.sharded_update:
            return gspmd.apply_shards_spmd(self.zero_state, grads, plan,
                                           wire=wire,
                                           ag_residuals=ag_residuals,
                                           on_reduced=on_reduced)
        if self.backward_passes_per_step > 1:
            raise ValueError(
                "backward_passes_per_step>1 has no GSPMD path: its "
                "accumulator lives in the explicit pipeline; use "
                "make_train_step(accum_steps=...) there")
        if wire is not None or ag_residuals is not None:
            raise ValueError(
                "wire=/ag_residuals= narrow the ZeRO-1 "
                "(sharded_update=True) placement exchange; the plain "
                "path's cast narrowing lives in the train step itself")
        gspmd.reduce_spmd(grads, self.params, plan,
                          threshold_bytes=self.threshold_bytes)
        if on_reduced is not None:
            on_reduced([p.grad for p in self.params])
        return self.optimizer.step()


def _sync_axes(axes):
    """The axes of a startup sync: ``axes``, or with None every axis of
    the mesh (``Mesh.world_axes``). The JAX package's default is the
    data axes, but there a replicated parameter is one array on one
    controller; here every rank holds its own copy of the parameters and
    of their optimizer state, on a (data, model) mesh too, so the sync
    that makes the copies equal spans the world."""
    return mesh_lib.get_mesh().world_axes if axes is None else axes


@torch.no_grad()
def broadcast_parameters(state_dict, root_rank=0, axes=None):
    """Overwrite, in place, every tensor of ``state_dict`` with the value
    of the rank whose ``mesh_rank(axes)`` is ``root_rank`` (None: every
    axis, ``_sync_axes``), in the order of the names."""
    axes = _sync_axes(axes)
    for name in sorted(state_dict):
        collective.broadcast_(state_dict[name], root_rank=root_rank,
                              axes=axes)


@torch.no_grad()
def broadcast_variables(variables, root_rank=0, axes=None):
    """Overwrite, in place, every tensor of ``variables`` (an iterable of
    tensors, in order) with the value of the rank whose
    ``mesh_rank(axes)`` is ``root_rank`` (None: every axis,
    ``_sync_axes``): the startup sync of a list of tensors. Returns them
    as a list."""
    axes = _sync_axes(axes)
    variables = list(variables)
    for v in variables:
        collective.broadcast_(v, root_rank=root_rank, axes=axes)
    return variables


def distributed_value_and_grad(fun, op=Average, axes=None, compression=None):
    """``fun(params, *args) -> scalar`` made ``(value, grads)``, the
    gradients with respect to ``params`` (a list of tensors) reduced over
    the ranks of ``axes`` through the fused buckets (the JAX package's
    ``distributed_value_and_grad``, Horovod's ``DistributedGradientTape``)."""
    def wrapped(params, *args, **kwargs):
        params = list(params)
        with torch.enable_grad():
            value = fun(params, *args, **kwargs)
            grads = torch.autograd.grad(value, params,
                                        materialize_grads=True)
        return value.detach(), fusion.fused_allreduce(
            list(grads), op=op, axes=axes, compression=compression)
    return wrapped


@torch.no_grad()
def broadcast_optimizer_state(optimizer, root_rank=0, axes=None):
    """Overwrite, in place, the optimizer's per-parameter state tensors
    and its hyperparameters with those of the rank whose
    ``mesh_rank(axes)`` is ``root_rank`` (None: every axis,
    ``_sync_axes``); both travel over the same group. Tensors that live
    off this process's device (e.g. AdamW's ``step`` on the CPU) travel
    through the device and are copied back."""
    opt = getattr(optimizer, "optimizer", optimizer)
    m = mesh_lib.get_mesh()
    axes = _sync_axes(axes)
    group, src = collective.root_of(root_rank, axes)
    groups = [{k: v for k, v in g.items() if k != "params"}
              for g in opt.param_groups]
    obj = [groups]
    dist.broadcast_object_list(obj, src=src, group=group, device=m.device)
    for g, new in zip(opt.param_groups, obj[0]):
        g.update(new)
    params = [p for g in opt.param_groups for p in g["params"]]
    for p in params:
        for key in sorted(opt.state.get(p, {})):
            v = opt.state[p][key]
            if not torch.is_tensor(v):
                continue
            tmp = v.to(m.device)
            collective.broadcast_(tmp, root_rank=root_rank, axes=axes)
            if tmp is not v:
                v.copy_(tmp)


def _numeric(x):
    if isinstance(x, (bool, int, float)):
        return True
    if torch.is_tensor(x):
        return True
    dtype = getattr(x, "dtype", None)  # numpy arrays and scalars
    return getattr(dtype, "kind", None) in ("b", "i", "u", "f")


@torch.no_grad()
def allreduce_metrics(metrics, op=Average, axes=None):
    """Reduce scalar metrics across the ranks of ``axes`` (None: the data
    axes, as in the JAX package; the replicas along the other axes hold
    equal metrics) (Horovod's ``MetricAverageCallback``). ``metrics`` is
    any nest of dicts, lists and tuples; each numeric leaf comes back as a tensor on this process's
    device: fp32 under Average (an averaged count is a float), its own
    dtype under Sum for integers. Other leaves (strings, None) pass
    through unchanged."""
    m = mesh_lib.get_mesh()

    def one(x):
        if not _numeric(x):
            return x
        t = torch.as_tensor(x, device=m.device)
        if t.dtype == torch.bool:
            t = t.long()
        if op == Average or t.is_floating_point():
            t = t.float()
        return collective.allreduce(t, op=op, axes=axes)

    return _pytree.tree_map(one, metrics)


@torch.no_grad()
def join(grads, is_active, op=Average, axes=None):
    """Join-aware gradient allreduce for uneven data over the ranks of
    ``axes`` (None: the data axes, as in the JAX package): a rank whose
    data is exhausted passes ``is_active=False`` and contributes zeros,
    and the mean is over the active ranks only. Returns ``(reduced grads, number
    of active ranks)``; ``grads`` is any nest of tensors."""
    m = mesh_lib.get_mesh()
    active = torch.as_tensor(is_active, dtype=torch.float32,
                             device=m.device)
    n_active = collective.allreduce(active, op=Sum,
                                    axes=axes).clamp_min(1.0)

    def one(g):
        summed = collective.allreduce(g * active.to(g.dtype), op=Sum,
                                      axes=axes)
        if op == Average:
            summed = summed / n_active.to(summed.dtype)
        return summed

    return _pytree.tree_map(one, grads), n_active
