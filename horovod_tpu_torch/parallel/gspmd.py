"""The GSPMD path of the port: one logical mesh, the placements own the
exchange. The port of ``horovod_tpu/parallel/gspmd.py``.

In the JAX package the state is annotated with ``NamedSharding`` on one
mesh, the whole step is jitted, and XLA's partitioner inserts every
collective the shardings imply. Here the annotations are DTensor
placements (``torch.distributed.tensor``) on a ``DeviceMesh`` with the
port mesh's ranks, axis names and order:

=====================================  ====================================
JAX                                    port
=====================================  ====================================
``NamedSharding(mesh, P(...))``        ``Shard(0)`` for batch dims and ZeRO
                                       rows, ``Replicate()`` for
                                       parameters, ``Partial`` for a
                                       gradient not yet reduced
``with_sharding_constraint``           ``DTensor.redistribute``
                                       (:func:`constrain`)
the partitioner's collectives          DTensor's redistribution, which
                                       issues ``c10d_functional``
                                       collectives (NCCL on the card, gloo
                                       on the CPU)
``shard_map`` island                   ``local_map`` (:func:`shard_map_island`)
HLO byte accounting                    the functional collectives a
                                       dispatch mode sees in one call
                                       (:func:`record_collectives`)
=====================================  ====================================

This module is the plan layer of that path:

* :class:`GspmdPlan` holds the port mesh and its ``DeviceMesh``; batches
  shard over the data axes, parameters stay replicated, and ZeRO-1 rows
  shard over their schedule's axes on dim 0 of the same ``[world,
  shard]`` bucket layout the explicit path uses (each rank holds the
  bytes it holds there), so a checkpoint of either path restores into
  the other bit for bit.
* :func:`apply_shards_spmd` is the ZeRO-1 exchange with no collective
  call of its own: the gradient, packed into each bucket's rows as a
  ``Partial`` DTensor, is redistributed to ``Shard(0)`` (DTensor issues
  the reduce-scatter), the inner optimizer steps this rank's rows, and
  the deltas are redistributed to ``Replicate()`` (the all-gather).
  :func:`reduce_spmd` is plain data parallelism's: ``Partial`` buckets
  redistributed to ``Replicate()`` (one all-reduce a bucket).
* :func:`record_collectives` and :class:`CompiledProgramCache` account
  for the bytes: nothing here compiles, so the collectives are read off
  the first call of each batch signature.

``training.make_train_step(spmd=True)`` and ``make_lm_train_step(
spmd=True)`` are the consumers; ``DistributedOptimizer.update_spmd``
routes here. The placement program runs op by op: each op a DTensor
dispatch on the host (there is no compiled program to fuse them).

The exchanges run on a flat one-axis ``DeviceMesh`` over the axes they
reduce (:meth:`GspmdPlan.exchange_mesh`), made from the port mesh's own
group of those ranks: DTensor reduces a ``Partial`` over two mesh axes
with two sequential collectives, where the explicit path (and XLA) use
one. A hierarchical schedule's ICI-first order keeps its two stages.
"""

import dataclasses
import re
import time

import numpy as np
import torch

from horovod_tpu_torch.parallel import mesh as mesh_lib


def gspmd_supported():
    """``(ok, reason)``: whether this torch can run the GSPMD path (the
    JAX ``compat.gspmd_supported``, ``compat.py:75``): DTensor with
    ``Partial``, ``Replicate`` and ``Shard``, ``DeviceMesh.from_group``,
    ``implicit_replication`` and ``local_map`` taking
    ``in_grad_placements``."""
    import inspect
    try:
        from torch.distributed.tensor import (  # noqa: F401
            DeviceMesh, DTensor, Partial, Replicate, Shard)
    except ImportError as e:
        return False, f"torch.distributed.tensor lacks the DTensor API ({e})"
    if not hasattr(DeviceMesh, "from_group"):
        return False, ("DeviceMesh.from_group is unavailable: this torch "
                       "cannot build a mesh over existing groups")
    try:
        from torch.distributed.tensor.experimental import (
            implicit_replication, local_map)  # noqa: F401
    except ImportError as e:
        return False, f"torch lacks local_map or implicit_replication ({e})"
    if "in_grad_placements" not in inspect.signature(local_map).parameters:
        return False, ("local_map lacks in_grad_placements: an island "
                       "cannot state its gradients' placements")
    return True, ""


def is_dtensor(x):
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _device_mesh(mesh, axes):
    """A ``DeviceMesh`` over this rank's ranks of ``axes`` of the port
    mesh, in that order, from the port mesh's own process groups (no new
    communicator)."""
    from torch.distributed.device_mesh import DeviceMesh
    grid = np.arange(mesh.size).reshape(mesh.shape)
    idx = [mesh.axis_names.index(a) for a in axes]
    coords = mesh.coords
    sub = grid[tuple(slice(None) if i in idx else coords[i]
                     for i in range(len(mesh.shape)))]
    order = sorted(idx)
    sub = np.transpose(sub, [order.index(i) for i in idx])
    if len(axes) == 1:
        group = mesh.group_of(axes)[0]
    else:
        group = [mesh.group_of((a,))[0] for a in axes]
    return DeviceMesh.from_group(group, mesh.device.type,
                                 mesh=torch.as_tensor(sub),
                                 mesh_dim_names=tuple(axes))


@dataclasses.dataclass(frozen=True, eq=False)
class GspmdPlan:
    """The GSPMD path's logical mesh: ``mesh`` the port mesh,
    ``device_mesh`` the ``DeviceMesh`` over the same ranks, axis names
    and order, which axes batches (and ZeRO rows) shard over, and the
    axis, if any, tensor-parallel layers may shard weights over (JAX
    ``gspmd.py:57``). A spec is a ``PartitionSpec`` as a tuple: one entry
    per tensor dim, an axis name or a tuple of them (``()``: replicated
    everywhere)."""

    mesh: object
    device_mesh: object
    data_axes: tuple
    model_axis: str = None
    _meshes: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def batch_spec(self):
        """Leading (batch) dim sharded over every data axis. ZeRO-1 row
        specs belong to a ``ZeroState``'s schedule, not to the plan
        (:func:`state_partition_specs`)."""
        return _spec(self.data_axes)

    def world(self):
        return int(np.prod([self.mesh.axis_size(a) for a in
                            self.data_axes]))

    def exchange_mesh(self, axes=None):
        """The ``DeviceMesh`` an exchange over ``axes`` (None: the whole
        mesh) runs on: one flat dim named ``"+".join(axes)`` when
        ``axes`` are in mesh order (one collective over their group, as
        the explicit path's), else one dim an axis in the order given
        (a hierarchical schedule's ``("data", "dcn")``: chunk ``r`` to
        the rank whose row-major index over that order is ``r``)."""
        axes = self.mesh.axis_names if axes is None else (
            (axes,) if isinstance(axes, str) else tuple(axes))
        key = tuple(axes)
        if key not in self._meshes:
            ordered = tuple(sorted(key, key=self.mesh.axis_names.index))
            if key == ordered:
                from torch.distributed.device_mesh import DeviceMesh
                group, ranks = self.mesh.group_of(ordered)
                dm = DeviceMesh.from_group(
                    group, self.mesh.device.type,
                    mesh=torch.as_tensor(ranks),
                    mesh_dim_names=("+".join(key),))
            else:
                dm = _device_mesh(self.mesh, key)
            self._meshes[key] = dm
        return self._meshes[key]

    def placements(self, spec, device_mesh=None):
        """DTensor placements of ``spec`` on ``device_mesh`` (default the
        plan's): :func:`spec_placements`."""
        return spec_placements(spec, self.device_mesh if device_mesh is None
                               else device_mesh)


def spec_placements(spec, device_mesh):
    """DTensor placements of ``spec`` on ``device_mesh``: ``Shard(d)`` on
    each mesh dim whose axes (a flat dim's ``+``-joined names) tensor dim
    ``d``'s entry names, in that order, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    entries = [(e,) if isinstance(e, str) else tuple(e or ()) for e in spec]
    out, seen = [], {}
    for name in device_mesh.mesh_dim_names:
        parts = tuple(name.split("+"))
        hit = [d for d, e in enumerate(entries)
               if all(p in e for p in parts)]
        if not hit:
            out.append(Replicate())
            continue
        d = hit[0]
        seen.setdefault(d, []).extend(parts)
        out.append(Shard(d))
    for d, names in seen.items():
        want = [a for a in entries[d] if a in names]
        if names != want:
            raise ValueError(
                f"spec {spec!r}: dim {d} over {entries[d]} on a mesh of "
                f"dims {device_mesh.mesh_dim_names}; use exchange_mesh("
                f"{entries[d]!r})")
    return out


def _spec(axes):
    """The spec of a tensor whose dim 0 is sharded over ``axes``: one
    axis by its name, several as a tuple (``PartitionSpec``'s form)."""
    axes = tuple(axes)
    return (axes[0],) if len(axes) == 1 else (axes,)


def derive_plan(mesh=None, model_axis=None):
    """The :class:`GspmdPlan` of ``mesh`` (default: the installed mesh).
    Data axes are ``mesh.data_axis_names`` (``data``, plus ``dcn`` when
    present), the axes the explicit path reduces gradients over (JAX
    ``gspmd.py:87``). ``model_axis`` must name an axis of the mesh."""
    mesh = mesh if mesh is not None else mesh_lib.get_mesh()
    data_axes = mesh_lib.data_axis_names(mesh)
    if not data_axes:
        raise ValueError(
            f"mesh {mesh.axis_names!r} has no data/dcn axis to shard "
            "batches over; build it with parallel.mesh.build_mesh")
    if model_axis is not None and model_axis not in mesh.axis_names:
        raise ValueError(
            f"model_axis {model_axis!r} is not an axis of the mesh "
            f"{mesh.axis_names!r}")
    return GspmdPlan(mesh=mesh,
                     device_mesh=_device_mesh(mesh, mesh.axis_names),
                     data_axes=tuple(data_axes), model_axis=model_axis)


def _row_axes(zstate, mesh):
    axes = zstate.plan.schedule.axes
    return mesh.resolve(axes) if axes is None else tuple(axes)


def state_partition_specs(model, optimizer):
    """Specs of a training state, ``{"params": {name: spec}, "opt_state":
    {...}}``: everything replicated (``()``) except a ZeRO-1 state's row
    tensors, ``(schedule axes,)`` on dim 0 of their global ``[world,
    shard]`` row (JAX ``gspmd.py:109``). ``opt_state`` is the inner
    optimizer's per-parameter state by index, or under ZeRO-1 the rows'
    state by bucket (``"b0"``, ...)."""
    params = {name: () for name, _ in model.named_parameters()}
    inner = getattr(optimizer, "optimizer", optimizer)
    zstate = getattr(optimizer, "zero_state", None)
    if zstate is None:
        index = {id(p): i for i, p in enumerate(
            p for g in inner.param_groups for p in g["params"])}
        opt = {index[id(p)]: {k: () for k, v in st.items()
                              if torch.is_tensor(v)}
               for p, st in inner.state.items()}
        return {"params": params, "opt_state": opt}
    axes = _row_axes(zstate, mesh_lib.get_mesh())
    opt = {}
    for i, row in enumerate(zstate.rows):
        st = zstate.inner.state.get(row, {})
        opt[f"b{i}"] = {k: (_spec(axes) if v.dim() and
                            v.numel() == row.numel() else ())
                        for k, v in st.items() if torch.is_tensor(v)}
    return {"params": params, "opt_state": opt}


def state_shardings(plan, model, optimizer):
    """``(device_mesh, placements)`` for every leaf of
    :func:`state_partition_specs` (JAX ``gspmd.py:133``): rows on the
    exchange mesh of their schedule's axes."""
    specs = state_partition_specs(model, optimizer)
    zstate = getattr(optimizer, "zero_state", None)
    row_mesh = (plan.exchange_mesh(_row_axes(zstate, plan.mesh))
                if zstate is not None else None)

    def one(spec):
        dm = row_mesh if spec and row_mesh is not None else plan.device_mesh
        return dm, plan.placements(spec, dm)

    return {"params": {k: one(s) for k, s in specs["params"].items()},
            "opt_state": {k: {n: one(s) for n, s in d.items()}
                          for k, d in specs["opt_state"].items()}}


def place_state(plan, model, optimizer):
    """The training state as DTensors on its shardings (JAX
    ``gspmd.py:139``), each a view of the tensor this rank holds (no
    copy, no collective): parameters ``Replicate()``; a ZeRO-1 row's
    state ``Shard(0)`` of its global ``[world, shard]`` row, this rank's
    row the local ``[1, shard]`` block."""
    sh = state_shardings(plan, model, optimizer)
    params = {name: _view(p.detach(), *sh["params"][name])
              for name, p in model.named_parameters()}
    zstate = getattr(optimizer, "zero_state", None)
    opt = {}
    if zstate is None:
        inner = getattr(optimizer, "optimizer", optimizer)
        index = {id(p): i for i, p in enumerate(
            p for g in inner.param_groups for p in g["params"])}
        for p, st in inner.state.items():
            i = index[id(p)]
            opt[i] = {k: _view(v, *sh["opt_state"][i][k])
                      for k, v in st.items() if torch.is_tensor(v)}
    else:
        for i, row in enumerate(zstate.rows):
            st = zstate.inner.state.get(row, {})
            d = {}
            for k, v in st.items():
                if not torch.is_tensor(v):
                    continue
                dm, pl = sh["opt_state"][f"b{i}"][k]
                local = v.reshape(1, -1) if any(
                    p.is_shard() for p in pl) else v
                d[k] = _view(local, dm, pl)
            opt[f"b{i}"] = d
    return {"params": params, "opt_state": opt}


def _view(v, dm, placements):
    """``v`` as a DTensor on ``dm``; a tensor off the mesh's device (the
    optimizer's host-side step counters) stays as it is."""
    from torch.distributed.tensor import DTensor
    if v.device.type != dm.device_type:
        return v
    return DTensor.from_local(v, dm, placements, run_check=False)


def param_views(plan, named_params):
    """``{name: Replicate() DTensor}`` over ``named_params``: leaves that
    share each parameter's storage, so the optimizer's in-place update
    of the parameter is the DTensor's, and whose ``.grad`` collects the
    backward's ``Partial`` gradient."""
    from torch.distributed.tensor import DTensor, Replicate
    rep = [Replicate()] * plan.device_mesh.ndim
    return {name: DTensor.from_local(p.detach(), plan.device_mesh, rep,
                                     run_check=False).requires_grad_(
                                         p.requires_grad)
            for name, p in named_params}


def constrain(x, plan, spec):
    """``x`` (a DTensor) redistributed to ``spec`` on its own mesh: the
    only way this path asks for communication (JAX ``gspmd.py:158``,
    ``with_sharding_constraint``). The placements state where the value
    must live; DTensor decides the collective."""
    return x.redistribute(x.device_mesh,
                          spec_placements(spec, x.device_mesh))


class _PartialSpec(tuple):
    """The spec of a value not yet reduced: ``Partial()`` on every mesh
    dim (an island's gradient placements)."""


PARTIAL = _PartialSpec()


def shard_map_island(fn, plan, in_specs, out_specs, in_grad_specs=None,
                     device_mesh=None):
    """The one sanctioned ``local_map`` entry point of the GSPMD path (JAX
    ``gspmd.py:165``, ``shard_map_island``): ``fn`` runs on this rank's
    local tensors inside the placement program (over ``device_mesh``,
    default the plan's; ``plan`` may then be None), with its inputs and
    outputs placed by ``in_specs`` / ``out_specs`` (a spec each, None
    for an argument that is not a tensor) and its inputs' gradients by
    ``in_grad_specs`` (default: the inputs' own; :data:`PARTIAL` for a
    gradient each rank holds a summand of). It is where the path
    runs what no placement expresses: the chunked quantized exchange
    (per-shard partial gradients and per-chunk scales), the flash
    kernels (``ctypes`` launches that take raw pointers, with no DTensor
    sharding rule) and synchronized BatchNorm's statistics. Keeping it
    here, in one named entry point, keeps the training code from growing
    raw ``local_map`` call sites (``tests/test_torch_gspmd.py`` holds
    the tree to that)."""
    from torch.distributed.tensor.experimental import local_map
    dm = plan.device_mesh if device_mesh is None else device_mesh

    def pl(spec):
        if spec is None:
            return None
        if isinstance(spec, _PartialSpec):
            from torch.distributed.tensor import Partial
            return [Partial()] * dm.ndim
        return spec_placements(spec, dm)

    def pls(specs):
        return None if specs is None else tuple(pl(s) for s in specs)

    out = (tuple(pl(s) for s in out_specs)
           if isinstance(out_specs, list) else pl(out_specs))
    return local_map(fn, out_placements=out, in_placements=pls(in_specs),
                     in_grad_placements=pls(in_grad_specs), device_mesh=dm)


def _batch_spec_of(x):
    """The spec of a DTensor sharded on dim 0 (or replicated) over its
    mesh's dims, and the names of the dims it is sharded over."""
    axes = tuple(n for n, p in zip(x.device_mesh.mesh_dim_names,
                                   x.placements) if p.is_shard(0))
    if any(not (p.is_shard(0) or p.is_replicate()) for p in x.placements):
        raise ValueError(f"an island takes batch-sharded or replicated "
                         f"inputs, got {x.placements}")
    return (axes,), axes


def local_attention(fn, q, k, v, **kwargs):
    """``fn(q, k, v, **kwargs)`` (the flash kernels' attention) as an
    island: q, k, v and the output batch-sharded on dim 0, forward and
    backward. Attention over a batch-sharded [B, S, H, D] is wholly
    local to a rank's rows."""
    spec, _ = _batch_spec_of(q)
    island = shard_map_island(lambda a, b, c: fn(a, b, c, **kwargs),
                              None, (spec, spec, spec), spec,
                              device_mesh=q.device_mesh)
    return island(q, k, v)


def sync_batch_norm(x, weight, bias, eps):
    """Training BatchNorm over the global batch of a batch-sharded ``x``
    (NCHW): ``models.resnet._SyncBatchNorm``'s arithmetic (flax's
    ``BatchNorm(axis_name=...)``) over the axes ``x`` is sharded over, as
    an island. Returns ``(y, mean, var)``: ``y`` batch-sharded, the fp32
    statistics as this rank's (replicated) tensors. The weight and bias
    gradients leave the island ``Partial``: each rank's is its rows'
    sum. DTensor's own ``batch_norm`` rule would all-gather ``x``."""
    from horovod_tpu_torch.models.resnet import _SyncBatchNorm
    spec, axes = _batch_spec_of(x)
    island = shard_map_island(
        lambda a, w, b: _SyncBatchNorm.apply(a, w, b, eps, axes),
        None, (spec, (), ()), [spec, (), ()],
        in_grad_specs=(spec, PARTIAL, PARTIAL),
        device_mesh=x.device_mesh)
    y, mean, var = island(x, weight, bias)
    return y, mean.to_local(), var.to_local()


def _partial_parts(grads, world):
    """Each gradient as this rank's summand of the global-batch mean: a
    DTensor's local tensor under ``Partial("sum")``; under
    ``Partial("avg")``, or a plain local tensor (this rank's local mean,
    read as ``Partial("avg")``), divided by ``world``; a replicated one
    divided by ``world`` too."""
    from torch.distributed.tensor import DTensor
    out = []
    for g in grads:
        if not isinstance(g, DTensor):
            out.append(g / world)
            continue
        pl = [p for p in g.placements if not p.is_replicate()]
        if any(p.is_shard() for p in pl):
            raise ValueError(f"a gradient placed {g.placements} is not a "
                             "partial or replicated value")
        ops = {p.reduce_op for p in pl}
        local = g.to_local()
        if ops == {"sum"}:
            out.append(local)
        elif ops <= {"avg"}:
            out.append(local / world)
        else:
            raise ValueError(f"gradient reduce ops {ops}: the GSPMD step "
                             "takes sum or avg partials")
    return out


def narrow(g, dtype):
    """A gradient's local tensor cast to ``dtype`` (a cast wire's),
    keeping its placements: the plain path's narrowing, which
    :func:`reduce_spmd` then reduces at that width."""
    from torch.distributed.tensor import DTensor
    if not isinstance(g, DTensor):
        return g.to(dtype) if g.is_floating_point() else g
    local = g.to_local()
    if not local.is_floating_point():
        return g
    return DTensor.from_local(local.to(dtype), g.device_mesh, g.placements,
                              run_check=False)


@torch.no_grad()
def full_value(x, plan):
    """The global value of a replicated or partial DTensor on this rank
    (a step's loss): a partial one is redistributed to ``Replicate()`` on
    the exchange mesh of the plan's data axes, one collective; an
    ``avg`` partial is summed, then divided by the ranks, as the explicit
    path's ``Average``."""
    from torch.distributed.tensor import DTensor, Partial
    local = x.to_local().detach()
    partial = [p for p in x.placements if p.is_partial()]
    if not partial:
        return local
    ops = {p.reduce_op for p in partial}
    if not ops <= {"sum", "avg"}:
        raise ValueError(f"cannot read the value of a {ops} partial")
    dm = plan.exchange_mesh(plan.data_axes)
    total = constrain(DTensor.from_local(local, dm, [Partial("sum")],
                                         run_check=False), plan, ())
    total = total.to_local()
    return total / dm.size() if ops == {"avg"} else total


@torch.no_grad()
def reduce_spmd(grads, params, plan, threshold_bytes=None):
    """Plain data parallelism's exchange: every gradient (a ``Partial``
    DTensor, or this rank's local-mean gradient) packed into the forward
    buckets of ``fusion.plan_buckets``, each bucket a ``Partial`` DTensor
    on the exchange mesh redistributed to ``Replicate()`` (DTensor issues
    one all-reduce a bucket), and written to ``p.grad`` at each
    parameter's dtype. A gradient narrowed to a wire dtype is reduced at
    that width."""
    from torch.distributed.tensor import DTensor, Partial
    from horovod_tpu_torch.ops import fusion
    if len(grads) != len(params):
        raise ValueError(f"{len(grads)} gradients for {len(params)} "
                         "parameters")
    parts = _partial_parts([torch.zeros_like(p) if g is None else g
                            for g, p in zip(grads, params)], plan.world())
    dm = plan.exchange_mesh(plan.data_axes)
    for bucket in fusion.plan_buckets(parts,
                                      fusion._threshold(threshold_bytes)):
        flat = DTensor.from_local(fusion._pack(bucket, parts), dm,
                                  [Partial("sum")], run_check=False)
        flat = constrain(flat, plan, ()).to_local()
        for i, g in fusion._unpack(bucket, flat).items():
            params[i].grad = g.to(params[i].dtype)


def apply_shards_spmd(zstate, grads, plan, wire=None, ag_residuals=None,
                      on_reduced=None):
    """ZeRO-1 under the GSPMD path (JAX ``gspmd.py:184``): the explicit
    path's ``[world, shard]`` rows and inner-optimizer arithmetic
    (``zero.step_rows``), and no collective call of its own:

    1. each bucket of the gradients (``Partial`` DTensors, or local
       gradients read as ``Partial("avg")``) is packed into its padded
       rows in the schedule's (flax) order, wrapped as a ``Partial``
       DTensor on the exchange mesh of the schedule's axes and
       redistributed to ``Shard(0)``: DTensor issues the reduce-scatter;
    2. the inner optimizer steps this rank's rows;
    3. each row's delta, ``Shard(0)``, is redistributed to
       ``Replicate()``: the all-gather. The deltas are added to the
       parameters.

    ``wire`` (a cast compressor, bf16 or float16) narrows both halves:
    the rows are cast to ``wire.wire_dtype`` before each redistribution.
    ``ag_residuals`` (one fp32 shard-sized tensor a bucket) is delta
    error feedback on the all-gather half only: each delta's cast error
    is carried into the next step's delta. The reduce-scatter half stays
    stateless (a residual would have to be added before the reduction).
    A chunked wire (fp8, int8) raises: per-chunk scales have no
    placement; the train step runs that exchange as an island.
    ``on_reduced(shards)`` sees this rank's reduced shards before the
    inner optimizer steps them. Returns the new residuals (None without
    ``ag_residuals``)."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    from horovod_tpu_torch.ops import fusion
    from horovod_tpu_torch.parallel import zero

    if wire is not None and getattr(wire, "chunked", False):
        raise ValueError(
            f"chunked wire format {wire.name!r} has no placement form "
            "(per-chunk scales cannot ride a redistribution): the "
            "quantized exchange is the island that training."
            "make_train_step(spmd=True) runs; this path narrows cast "
            "wires only")
    schedule = zstate.plan.schedule
    if len(grads) != len(zstate.params):
        raise ValueError(
            f"{len(grads)} gradients for {len(zstate.params)} parameters; "
            "was the optimizer built over another parameter list?")
    parts = _partial_parts([torch.zeros_like(p) if g is None else g
                            for g, p in zip(grads, zstate.params)],
                           schedule.world)
    axes = _row_axes(zstate, plan.mesh)
    dm = plan.exchange_mesh(axes)
    row_spec = _spec(axes)
    world = schedule.world
    with torch.no_grad():
        shards = []
        for i in range(len(schedule.buckets)):
            rows = fusion.pack_padded(schedule, i, parts).reshape(world, -1)
            grad_dtype = rows.dtype
            if wire is not None and rows.is_floating_point():
                rows = rows.to(wire.wire_dtype)
            rows = DTensor.from_local(rows, dm, [Partial("sum")] * dm.ndim,
                                      run_check=False)
            shards.append(constrain(rows, plan, row_spec).to_local()
                          .reshape(-1).to(grad_dtype))
        if on_reduced is not None:
            on_reduced(shards)
        new_residuals = (list(ag_residuals) if ag_residuals is not None
                         else None)
        for i, delta in enumerate(zero.step_rows(zstate, shards)):
            out_dtype = delta.dtype
            x = delta
            if wire is not None and x.is_floating_point():
                if new_residuals is not None and new_residuals[i].numel():
                    x = x.float() + new_residuals[i].reshape(x.shape)
                    narrow = x.to(wire.wire_dtype)
                    new_residuals[i] = x - narrow.float()
                    x = narrow
                else:
                    x = x.to(wire.wire_dtype)
            x = DTensor.from_local(x.reshape(1, -1), dm,
                                   [Shard(0)] * dm.ndim, run_check=False)
            flat = constrain(x, plan, ()).to_local().reshape(-1)
            zero.add_bucket(zstate, i, flat.to(out_dtype))
    return new_residuals


# -- accounting of the collectives -----------------------------------------

# The collective kinds this framework prices and attributes, in one
# place (JAX gspmd.py:313): the accounting below and a trace's
# classification (chip_smoke.py's profile) derive their matching from
# this tuple and collective_kind.
COLLECTIVE_OPS = ("all-reduce", "reduce-scatter", "all-gather",
                  "all-to-all", "collective-permute")


def collective_label(op):
    """A kind as it appears in metric labels and summaries."""
    return op.replace("-", "_")


# torch's names: the functional collectives (``_c10d_functional.*``,
# which DTensor issues), the process-group ops (``c10d.*``, which
# ``torch.distributed``'s calls dispatch), and NCCL's device kernels
_TORCH_KINDS = {
    "all-reduce": ("all_reduce", "all_reduce_", "all_reduce_coalesced",
                   "all_reduce_coalesced_", "allreduce_",
                   "allreduce_coalesced_"),
    "reduce-scatter": ("reduce_scatter_tensor",
                       "reduce_scatter_tensor_coalesced",
                       "reduce_scatter_", "_reduce_scatter_base_",
                       "reduce_scatter_tensor_coalesced_"),
    "all-gather": ("all_gather_into_tensor", "all_gather_into_tensor_out",
                   "all_gather_into_tensor_coalesced", "allgather_",
                   "_allgather_base_", "allgather_coalesced_",
                   "allgather_into_tensor_coalesced_"),
    "all-to-all": ("all_to_all_single", "alltoall_", "alltoall_base_"),
    "collective-permute": ("send", "recv_", "recv_any_source_"),
}
_TORCH_OP = {name: kind for kind, names in _TORCH_KINDS.items()
             for name in names}
_NCCL_KINDS = {"AllReduce": "all-reduce", "ReduceScatter": "reduce-scatter",
               "AllGather": "all-gather", "AllToAll": "all-to-all",
               "SendRecv": "collective-permute"}


_COLLECTIVE_KIND_RE = re.compile(
    r"^(" + "|".join(re.escape(op) for op in COLLECTIVE_OPS) + r")"
    r"(-start|-done)?(?:[.\-_]|\d|$)")


def collective_kind(name):
    """Classify one op, kernel or trace-event name against
    :data:`COLLECTIVE_OPS` (JAX ``gspmd.py:327``): ``(kind,
    async_edge)``, or ``(None, None)`` for a name that is no collective.
    It reads XLA's names (``all-reduce-start.1``: the edge ``"start"``),
    torch's (``_c10d_functional.reduce_scatter_tensor.default``,
    ``c10d.allreduce_``; their ``wait_tensor`` is no collective) and
    NCCL's kernels (``ncclDevKernel_AllGather_RING_LL``,
    ``ncclKernel_AllReduce_RING_LL_Sum_float``); torch's and NCCL's carry
    no edge."""
    m = _COLLECTIVE_KIND_RE.match(name)
    if m:
        edge = m.group(2)
        return m.group(1), edge[1:] if edge else None
    if name.startswith("nccl"):
        head = name.split("_", 1)
        if len(head) == 2 and head[0] in ("ncclDevKernel", "ncclKernel"):
            # the kernel's name, without the argument list a trace adds
            # (ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>))
            tail = head[1].split("(", 1)[0]
            for key, k in _NCCL_KINDS.items():
                if tail == key or tail.startswith(key + "_"):
                    return k, None
        return None, None
    parts = name.split(".")
    if len(parts) >= 2 and parts[0] in ("_c10d_functional",
                                        "c10d_functional", "c10d"):
        kind = _TORCH_OP.get(parts[1])
        if kind is not None:
            return kind, None
    return None, None


def group_axes(groups, mesh):
    """The mesh axes a collective's rank groups span, in mesh axis order
    (JAX ``gspmd.py:477``): ``("data",)`` within a row, ``("dcn",)``
    across rows, both for a global collective. ``mesh`` is the port mesh
    (or anything with ``shape`` and ``axis_names``); ranks lie on it
    row-major. For a permute pass the source-target pairs."""
    shape = tuple(mesh.shape)
    varies = [False] * len(shape)
    for grp in groups:
        coords = [np.unravel_index(int(r), shape) for r in grp]
        for ax in range(len(shape)):
            if len({c[ax] for c in coords}) > 1:
                varies[ax] = True
    return tuple(a for a, v in zip(mesh.axis_names, varies) if v)


def _group_ranks(args, kwargs):
    """The global ranks of a collective op's process group: a functional
    collective names its group (a string), a ``c10d`` op passes the
    group object."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, dist.ProcessGroup):
            return dist.get_process_group_ranks(a)
    for a in reversed(args):
        if isinstance(a, str):
            try:
                return dist.get_process_group_ranks(
                    c10d._resolve_process_group(a))
            except (RuntimeError, ValueError, KeyError):
                return None
    return None


def _tensors(x):
    from torch.utils import _pytree
    return [t for t in _pytree.tree_leaves(x) if isinstance(t, torch.Tensor)]


def record_collectives(fn, *args, mesh=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under a dispatch mode that sees
    every collective it issues on this thread, and return ``(result,
    by_op, by_axes)``: ``by_op`` is ``{kind: {"calls", "bytes"}}``, the
    bytes of each collective's result on this rank (the JAX definition,
    ``gspmd.py:424-429``; an op that returns no tensor, such as an
    in-place all-to-all or a send, counts its output or input buffer);
    ``by_axes`` (with ``mesh``) is ``{label: {"calls", "bytes", "ops":
    {kind: bytes}}}``, the label the ``+``-joined axes of the op's group
    (:func:`group_axes`), ``"replica"`` for a group of one rank. DTensor
    skips a collective over a mesh dim of one rank, so a world of one
    reads ``{}``. Collectives run by autograd's device threads (a
    backward on the card) are not seen."""
    from torch.utils._python_dispatch import TorchDispatchMode

    by_op, by_axes = {}, {}

    class _Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            kind, _ = collective_kind(str(func))
            if kind is None:
                return out
            ts = _tensors(out) or _tensors(args[:1])
            nbytes = sum(t.numel() * t.element_size() for t in ts)
            slot = by_op.setdefault(kind, {"calls": 0, "bytes": 0})
            slot["calls"] += 1
            slot["bytes"] += nbytes
            if mesh is not None:
                ranks = _group_ranks(args, kwargs)
                axes = group_axes([ranks], mesh) if ranks else ()
                label = "+".join(axes) if axes else "replica"
                a = by_axes.setdefault(label, {"calls": 0, "bytes": 0,
                                               "ops": {}})
                a["calls"] += 1
                a["bytes"] += nbytes
                a["ops"][kind] = a["ops"].get(kind, 0) + nbytes
            return out

    with _Recorder():
        result = fn(*args, **kwargs)
    return result, by_op, (by_axes if mesh is not None else None)


def collective_bytes(fn, *args, **kwargs):
    """``{kind: {"calls", "bytes"}}`` of the collectives one call of
    ``fn`` issues (the counterpart of JAX ``collective_bytes_from_hlo``,
    ``gspmd.py:423``, which parses HLO text that torch does not have)."""
    return record_collectives(fn, *args, **kwargs)[1]


def collective_axis_bytes(fn, *args, mesh=None, **kwargs):
    """``{axes_label: {"calls", "bytes", "ops"}}`` of one call of ``fn``
    over ``mesh`` (default: the installed one; the counterpart of JAX
    ``collective_axis_bytes_from_hlo``, ``gspmd.py:494``)."""
    mesh = mesh if mesh is not None else mesh_lib.get_mesh()
    return record_collectives(fn, *args, mesh=mesh, **kwargs)[2]


class CompiledProgramCache:
    """The accounting of the GSPMD steps, keyed by the signature (shapes
    and dtypes) of a call's arguments (JAX ``gspmd.py:518``). Nothing is
    compiled here: the placement program runs op by op. The first call
    of each signature runs under :func:`record_collectives` and its
    collectives are kept; later calls of it run bare. ``last_collectives``
    and ``last_axis_collectives`` are the latest call's signature's.

    The first call of a signature is the port's counterpart of the JAX
    step's compile: its seconds go to the goodput ledger's ``compile``
    phase and ``hvd_compile_seconds_total`` (``record_compile``), and its
    collectives into ``hvd_collective_*`` under ``<prefix>_<kind>`` labels
    (``prefix`` "spmd" by default),
    once a signature (JAX ``record_compiled_collectives``)."""

    def __init__(self, prefix="spmd", mesh=None):
        self.prefix = prefix
        self.mesh = mesh
        self._seen = {}  # signature -> (by_op, by_axes)
        self.last_collectives = None
        self.last_axis_collectives = None

    @staticmethod
    def signature(args):
        return tuple((tuple(t.shape), str(t.dtype)) for t in _tensors(args))

    def run(self, fn, *args):
        key = self.signature(args)
        entry = self._seen.get(key)
        if entry is None:
            from horovod_tpu_torch.telemetry import instruments as _tele
            t0 = time.perf_counter()
            out, by_op, by_axes = record_collectives(fn, *args,
                                                     mesh=self.mesh)
            _tele.record_compile(time.perf_counter() - t0)
            for op, tot in by_op.items():
                _tele.record_compiled_collective(
                    f"{self.prefix}_{op}", calls=tot["calls"],
                    nbytes=tot["bytes"])
            self._seen[key] = entry = (by_op, by_axes)
        else:
            out = fn(*args)
        self.last_collectives, self.last_axis_collectives = entry
        return out
