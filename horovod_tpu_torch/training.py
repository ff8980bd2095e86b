"""Training-step builders: the Horovod programming model in PyTorch.

The port of ``horovod_tpu/training.py``'s ``softmax_cross_entropy``,
``create_train_state``, ``make_train_step`` (the explicit path, with its
microbatch loop and overlapped reduce-scatter pipeline) and
``make_lm_train_step`` (data-parallel, and sequence-parallel over a
``seq_axis``). The JAX step is a pure function returning a new
``TrainState``; here the step runs eagerly on this process's shard of
the batch and updates the model's parameters, its BatchNorm statistics
and the optimizer's state in place, and counts its calls in a
``StepState``, the counterpart of ``TrainState.step`` that a checkpoint
saves with them (``convert.train_state_to_flat``).

Telemetry and diagnosis (JAX ``training.py:555-640``, ``:1156-1262``,
``:1385-1420``, ``:1640-1650``): every step runs in a frame
(``_step_frame``) that marks its begin and end in the flight recorder,
brackets its collectives as the step's own (``collective.in_step``:
they book as compute, not exposed collective time), settles the goodput
ledger at its end (a GSPMD step also notes the compiled path), and
opens or closes a ``/profile`` capture window (``telemetry/xprof.py``).
With ``telemetry`` on (default: ``telemetry.enabled()``, a metrics
endpoint or ``HOROVOD_TELEMETRY=1``), ``make_train_step`` and
``make_lm_train_step`` also record ``hvd_step_*``, examples, the loss
and the gradient norm (deferred: kept as tensors and read only by a
scrape, so the step neither syncs nor changes a bit of its outputs), and
mark the step's dispatch and its buckets on the host timeline. Every
step carries ``step.xray(*args, k=3)``, which captures K steps with
``torch.profiler`` and attributes their device time.
"""

import contextlib
import dataclasses
import hashlib
import inspect
import time
import warnings

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch import basics, data, hvd_torch
from horovod_tpu_torch import telemetry as telemetry_lib
from horovod_tpu_torch.diag import recorder as _flightrec
from horovod_tpu_torch.ops import collective, fusion
from horovod_tpu_torch.ops.reduction import Average, Sum
from horovod_tpu_torch.parallel import mesh as mesh_lib
from horovod_tpu_torch.parallel import zero
from horovod_tpu_torch.telemetry import ledger as _ledger_lib
from horovod_tpu_torch.telemetry import xprof


@dataclasses.dataclass
class StepState:
    """The step count of a training run: the JAX ``TrainState.step``.
    A step builder adds one per call and keys the dropout masks by it,
    and a checkpoint saves and restores it with the model and the
    optimizer, so a restored run draws the masks an unbroken one
    would."""

    step: int = 0


def softmax_cross_entropy(logits, labels):
    """Mean cross-entropy with integer labels (fp32 log-softmax)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[..., None].long())[..., 0].mean()


def create_train_state(model, optimizer, root_rank=0):
    """Make every rank's replica start from ``root_rank``'s parameters and
    optimizer state (in place)."""
    hvd_torch.broadcast_parameters(model.state_dict(), root_rank=root_rank)
    hvd_torch.broadcast_optimizer_state(optimizer, root_rank=root_rank)


def _dropout_generator(device, *ints):
    """A generator on ``device`` seeded from ``ints`` (seed, step, rank,
    microbatch): one independent stream for each, as the JAX step folds
    them into its dropout key."""
    digest = hashlib.blake2b(repr(ints).encode(), digest_size=8).digest()
    gen = torch.Generator(device=device)
    gen.manual_seed(int.from_bytes(digest, "little") >> 1)
    return gen


@contextlib.contextmanager
def _step_frame(n, compiled_path=False):
    """One step's frame: the ``/profile`` window's open, the recorder's
    step begin, the step's collectives bracketed as its own, then (on
    success) the recorder's step end and the ledger's settle (the
    residual of the interval is compute), and (always) the window's
    close once its time has passed. A step run inside another (a GSPMD
    step's island) is the outer step's."""
    if collective._step_depth:
        yield
        return
    xprof.window_step_begin()
    try:
        _flightrec.step_begin(n)
        with collective.in_step():
            yield
        _flightrec.step_end(n)
        ledger = _ledger_lib.get_ledger()
        if compiled_path:
            ledger.note_compiled_path()
        ledger.settle_step()
    finally:
        xprof.window_step_end()


def _tele_on(telemetry):
    return telemetry_lib.enabled() if telemetry is None else bool(telemetry)


class _StepRecorder:
    """A step's telemetry (``telemetry=True``): ``StepInstruments``, and
    on the host timeline an enclosing ``step_dispatch`` slice with a flow
    that the bucket markers of ``ops/fusion.py`` join."""

    def __init__(self, accum_steps=1):
        self.instruments = telemetry_lib.StepInstruments(
            accum_steps=accum_steps)

    @contextlib.contextmanager
    def dispatch(self):
        tl = basics._state.timeline
        flow = None
        if tl is not None:
            tl.start_activity("marker", "step_dispatch")
            flow = tl.flow_start("step_dispatch")
            tl._step_flow_id = flow
        try:
            yield
        finally:
            if flow is not None:
                tl._step_flow_id = None
                tl.flow_end("step_dispatch", flow)
                tl.end_activity("marker")

    def record(self, batch, t0, loss, grad_norm):
        self.instruments.record_step(
            batch=int(batch), dispatch_s=time.perf_counter() - t0,
            loss=loss, grad_norm=grad_norm,
            timeline=basics._state.timeline,
            step_no=self.instruments.steps.value)


def _grad_norm(grads):
    """L2 norm of ``grads`` (fp32, one foreach pass; no sync)."""
    grads = [g for g in grads if g is not None]
    if not grads:
        return None
    norms = torch._foreach_norm(grads)
    return torch.linalg.vector_norm(torch.stack([n.float() for n in norms]))


def _shards_norm(shards, axes):
    """The exact norm of an averaged gradient partitioned into this
    rank's ``shards``: the sum over ranks of their squares (the pads are
    zero), one scalar all-reduce."""
    local_sq = sum(s.float().square().sum() for s in shards)
    return collective.allreduce_(local_sq, op=Sum, axes=axes).sqrt()


def _local_norm(grads, axes):
    """The JAX definition where only local gradients exist: the
    root-mean over ranks of each rank's squared local norm, one scalar
    all-reduce."""
    local = _grad_norm(grads)
    if local is None:
        return None
    return collective.allreduce_(local.square(), op=Average,
                                 axes=axes).sqrt()


def _attach_xray(step, collectives=None):
    # every step built here runs in _step_frame, which settles the
    # goodput ledger (elastic_train_loop settles only for other steps)
    step._settles_ledger = True

    def xray(*args, k=3, profile_dir=None):
        """Capture K steps of ``step(*args)`` with ``torch.profiler``
        (after one warm step outside the capture) and attribute their
        device time (``telemetry/xprof.xray_run``). Returns ``(last
        loss, summary)``; the summary lands in ``profile_dir`` as
        ``xray.rank<r>.json``."""
        return xprof.xray_run(step, args, k=k, profile_dir=profile_dir,
                              compiled_collectives=collectives)
    step.xray = xray


def _batch_stats(model):
    """The floating running-statistics buffers of the model's BatchNorm
    layers, in module order (integer counters such as
    ``num_batches_tracked`` are left out)."""
    return [b for m in model.modules()
            if isinstance(m, nn.modules.batchnorm._BatchNorm)
            for b in (m.running_mean, m.running_var)
            if b is not None and b.is_floating_point()]


def make_train_step(model, optimizer, loss_fn=softmax_cross_entropy,
                    dropout_seed=0, accum_steps=1, overlap_grads=False,
                    error_feedback=True, loader=None, spmd=False,
                    telemetry=None, *, batch_axes=None, mesh=None,
                    _norm_out=None):
    """Build a classification train step over the data axis.
    ``step(inputs, labels)`` takes this rank's shard of the batch, puts
    the model in training mode, runs forward, backward and the optimizer
    step, and returns the loss averaged over ranks (an fp32 scalar tensor
    on the device). ``step.state``, a ``StepState``, counts the calls
    that succeed.

    ``loader`` (a ``data.PrefetchLoader``) feeds the step: its producer
    thread stages each batch onto this rank's device
    (``data.device_placement``) while the previous step runs, and
    ``step()`` with no batch pulls ``(inputs, labels)`` from it; a loader
    whose batches are not pairs raises ``TypeError``, as does ``step()``
    without one.

    ``accum_steps=K`` splits the shard into K equal microbatches and
    accumulates their gradients (one optimizer step per call). Without
    ``overlap_grads`` they add up in ``.grad``, are scaled by 1/K, and
    ``optimizer.step()`` exchanges them. With ``overlap_grads=True`` the
    exchange is the bucketed reduce-scatter pipeline: as soon as a
    microbatch's backward ends, every bucket of the reverse-order
    schedule is packed and reduce-scattered asynchronously, in schedule
    order, so the next microbatch computes while they run (on the card,
    on NCCL's stream). The reduced shards are summed over microbatches and
    scaled by 1/K, then feed either the ZeRO-1 update
    (``DistributedOptimizer(sharded_update=True)``) or one all-gather per
    bucket and the inner optimizer. ``accum_steps > 1`` and
    ``overlap_grads`` need a ``DistributedOptimizer``.

    The schedule of the overlapped pipeline scatters over the
    optimizer's axes, ICI-first when ``optimizer.hierarchical_resolved()``
    and the mesh has a ``dcn`` axis (``fusion.bucket_schedule``); it
    reduce-scatters, so it takes Sum and Average only.

    BatchNorm: each microbatch's forward updates the running statistics
    in place, in microbatch order; after the optimizer step every
    floating statistics buffer is averaged over ranks (each rank
    normalizes over its own sub-batch, as Horovod's ranks do, unless the
    model synchronizes its BatchNorm: ``models.resnet.ResNet(
    bn_cross_replica_axes=...)``). torch's ``nn.SyncBatchNorm`` is
    refused.

    Wire compression (``DistributedOptimizer(compression=...)`` or
    ``HOROVOD_WIRE_DTYPE``) in the overlapped pipeline narrows every
    bucket collective: the reduce-scatter of gradient rows and the
    all-gather of gradient shards or of ZeRO-1's parameter deltas. The
    format is resolved here, once; if ``optimizer.compression`` later
    resolves to another, the step warns once and keeps its own. With
    ``error_feedback=True`` one fp32 residual per bucket and direction
    carries each exchange's quantization error into the next: allocated
    at the first step, kept outside the optimizer state, dropped by
    ``step.reset_error_feedback()`` (call it after restoring an earlier
    state) and by a step that raises. Without overlap, ``optimizer.step()``
    compresses statelessly.

    A model whose ``forward`` takes ``dropout_generator`` (such as
    ``models.simple.MNISTConvNet``) is given a generator seeded from
    ``dropout_seed``, ``state.step``, this rank and the microbatch index,
    so every rank and microbatch draws its own masks, and a run restored
    with its ``StepState`` draws the masks of the unbroken run.

    ``spmd=True`` builds the GSPMD step instead (``_make_spmd_train_step``,
    ``parallel/gspmd.py``): ``step(inputs, labels)`` takes the GLOBAL
    batch, the same on every rank, the placements own the exchange, the
    loss is the global-batch mean, BatchNorm normalizes with global-batch
    statistics and dropout draws one stream a step. It refuses
    ``accum_steps`` and ``overlap_grads``, the explicit pipeline's
    knobs.

    ``telemetry`` (None: ``telemetry.enabled()``) records the step's
    instruments (module docstring). Its gradient norm (``hvd_grad_norm``)
    is the norm of the averaged gradient wherever the step holds one:
    the overlapped pipeline's reduced shards (one scalar all-reduce, the
    JAX overlapped definition) and the gradients an allreduce left in
    ``.grad``; where only local gradients exist (ZeRO-1 without overlap,
    ``backward_passes_per_step > 1``, a plain torch optimizer) it is the
    JAX non-overlapped definition, the root-mean of the ranks' local
    norms. The GSPMD step's is the exact norm of the global-mean
    gradient, as the JAX GSPMD step's. Losses and parameters are bit for
    bit those of ``telemetry=False``.

    ``batch_axes`` and ``mesh`` are keyword-only, after the port's
    earlier parameters (JAX's signature puts them third and fifth).
    ``mesh`` is the installed mesh (None: the same; another is refused,
    as by ``make_lm_train_step``: the port's collectives run over the
    installed mesh's groups). ``batch_axes`` (None: the mesh's data axes, ``("data",)`` or
    ``("dcn", "data")``) are the axes the batch is split over, JAX's
    ``data_axes``: the loss is averaged, the BatchNorm statistics are
    averaged and the dropout streams are drawn over them, and nothing is
    averaged along the other axes (ranks there that take the same shard
    are replicas). Given, they must be the axes a
    ``DistributedOptimizer`` reduces over
    (``DistributedOptimizer(axes=batch_axes)``).

    ``_norm_out`` (internal: the GSPMD step's chunked island) is a
    one-item list each step writes that norm into, with or without
    telemetry."""
    mesh = _installed_mesh(mesh, "make_train_step")
    if batch_axes is not None:
        batch_axes = ((batch_axes,) if isinstance(batch_axes, str)
                      else tuple(batch_axes))
        if isinstance(optimizer, hvd_torch.DistributedOptimizer):
            _check_optimizer_axes(mesh, optimizer, batch_axes)
    if spmd:
        return _make_spmd_train_step(
            model, optimizer, loss_fn=loss_fn, batch_axes=batch_axes,
            dropout_seed=dropout_seed, accum_steps=accum_steps,
            overlap_grads=overlap_grads, error_feedback=error_feedback,
            loader=loader, telemetry=telemetry)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    pipelined = overlap_grads or accum_steps > 1
    is_hvd = isinstance(optimizer, hvd_torch.DistributedOptimizer)
    if pipelined:
        if not is_hvd:
            raise ValueError(
                "accum_steps>1 / overlap_grads=True need the optimizer "
                "built by DistributedOptimizer(...): the pipeline takes "
                "over its gradient reduction")
        if optimizer.backward_passes_per_step > 1:
            raise ValueError(
                "accum_steps and backward_passes_per_step are two "
                "accumulators for the same thing; use accum_steps")
        if overlap_grads:
            if not optimizer.sharded_update and \
                    optimizer.op not in (Sum, Average):
                # the pipeline reduce-scatters, as the JAX one does
                raise ValueError(
                    f"overlap_grads=True reduce-scatters its buckets, and "
                    f"reducescatter supports Sum or Average, got "
                    f"{optimizer.op!r}")
    if any(isinstance(m, nn.SyncBatchNorm) for m in model.modules()):
        raise NotImplementedError(
            "torch's nn.SyncBatchNorm keeps an unbiased running variance "
            "and synchronizes over its own process group; synchronize "
            "BatchNorm as the JAX package does with "
            "models.resnet.ResNet(bn_cross_replica_axes=('data',))")
    # the batch is split over the data axes: the loss, the BatchNorm
    # statistics and the dropout streams go by them (JAX's data_axes),
    # and the ranks along any other axis are replicas
    data_axes = mesh.resolve(batch_axes)
    data_rank = collective.mesh_rank(data_axes)
    # the wire format of the overlapped pipeline's bucket collectives,
    # resolved once; the other paths compress inside optimizer.step()
    wire = optimizer.compression if (is_hvd and overlap_grads) else None
    use_ef = wire is not None and error_feedback
    takes_rng = "dropout_generator" in inspect.signature(
        model.forward).parameters
    sharded = is_hvd and optimizer.sharded_update
    schedule = None
    if sharded:
        schedule = optimizer.zero_state.plan.schedule
    elif overlap_grads:
        # the flax dim orders only where the quantizer's chunks read them
        chunked = wire is not None and wire.chunked
        schedule = fusion.bucket_schedule(
            optimizer.params, collective.mesh_size(optimizer.axes),
            threshold_bytes=optimizer.threshold_bytes,
            perms=optimizer.perms if chunked else None,
            axes=optimizer.axes,
            hierarchical=optimizer.hierarchical_resolved())
    params = optimizer.params if is_hvd else None
    rs_op = optimizer.zero_state.plan.op if sharded else (
        optimizer.op if is_hvd else None)
    inv_k = 1.0 / accum_steps
    state = StepState()
    residuals = None  # {"rs": [...], "ag": [...]}, allocated lazily
    drift_warned = False

    def check_wire_drift():
        nonlocal drift_warned
        if not overlap_grads or drift_warned:
            return
        now = optimizer.compression
        if now is not wire:
            drift_warned = True
            warnings.warn(
                f"optimizer.compression resolves to "
                f"{getattr(now, 'name', None)!r} but this train step was "
                f"built with {getattr(wire, 'name', None)!r}: the wire "
                "format is fixed when make_train_step runs. Rebuild the "
                "step for the new format to take effect.", stacklevel=3)

    def new_residuals():
        """Zero fp32 residuals: ``rs`` the padded bucket (every
        ``[world, shard]`` row this rank encodes), ``ag`` the shard; a
        non-float bucket, never quantized, gets a zero-width one."""
        def zeros(i, n):
            floating = schedule.buckets[i].dtype.is_floating_point
            return torch.zeros(n if floating else 0, dtype=torch.float32,
                               device=mesh.device)
        return {"rs": [zeros(i, n)
                       for i, n in enumerate(schedule.padded_sizes)],
                "ag": [zeros(i, n)
                       for i, n in enumerate(schedule.shard_sizes)]}

    def forward(x, k):
        if not takes_rng:
            return model(x)
        return model(x, dropout_generator=_dropout_generator(
            mesh.device, dropout_seed, state.step, data_rank, k))

    def reduce_scatter(res):
        """Issue every bucket of this microbatch's gradients, in schedule
        order, then drop the gradients: the packed copies carry them.
        Each encode reads the residual the previous one wrote, on this
        stream, before its collective is issued."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        issued = []
        for i in range(len(schedule.buckets)):
            if wire is None:
                issued.append(fusion.reduce_scatter_bucket(
                    schedule, i, grads, op=rs_op, async_op=True))
                continue
            pending, new_r = fusion.reduce_scatter_bucket_compressed(
                schedule, i, grads, wire, op=rs_op,
                residual=res["rs"][i] if res else None, async_op=True)
            if res:
                res["rs"][i] = new_r
            issued.append(pending)
        for p in params:
            p.grad = None
        return issued

    def all_gather(shards, res):
        """One all-gather per bucket into the gradients, then the inner
        optimizer (the replicated tail of the overlapped pipeline)."""
        for i, s in enumerate(shards):
            if wire is None:
                flat = fusion.all_gather_bucket(schedule, i, s)
            else:
                flat, new_r = fusion.all_gather_bucket_compressed(
                    schedule, i, s, wire,
                    residual=res["ag"][i] if res else None)
                if res:
                    res["ag"][i] = new_r
            for j, g in fusion.unpack_bucket(schedule, i, flat,
                                             params).items():
                params[j].grad = g
        optimizer.update_preaveraged()

    def run(inputs, labels, res):
        """One step's work; returns ``(loss, grad norm or None)``."""
        model.train()
        inputs, labels = inputs.to(mesh.device), labels.to(mesh.device)
        if inputs.shape[0] % accum_steps:
            raise ValueError(
                f"per-rank batch {inputs.shape[0]} does not divide into "
                f"accum_steps={accum_steps} microbatches")
        micro = inputs.shape[0] // accum_steps
        optimizer.zero_grad(set_to_none=True)
        loss_sum, shards, pending = 0.0, None, None
        for k in range(accum_steps):
            part = slice(k * micro, (k + 1) * micro)
            loss_k = loss_fn(forward(inputs[part], k), labels[part])
            loss_k.backward()
            loss_sum = loss_sum + loss_k.detach()
            if overlap_grads:
                issued = reduce_scatter(res)
                if pending is not None:
                    shards = _add_waited(shards, pending)
                pending = issued
        gnorm = None
        with torch.no_grad():
            if overlap_grads:
                shards = [s * inv_k for s in _add_waited(shards, pending)]
                if want_norm:
                    gnorm = _shards_norm(shards, schedule.axes)
                if sharded:
                    new_ag = zero.apply_shards(
                        optimizer.zero_state, shards, wire=wire,
                        ag_residuals=res["ag"] if res else None)
                    if res:
                        res["ag"] = new_ag
                else:
                    all_gather(shards, res)
            else:
                if pipelined:
                    for p in params:
                        if p.grad is not None:
                            p.grad.mul_(inv_k)
                if want_norm:
                    grads = [p.grad for g in optimizer.param_groups
                             for p in g["params"]]
                    if not averaged_in_place:
                        gnorm = _local_norm(grads, norm_axes)
                optimizer.step()
                if want_norm and averaged_in_place:
                    gnorm = _grad_norm(grads)
            stats = _batch_stats(model)
            if stats:
                fusion.fused_allreduce_(stats, op=Average, axes=data_axes)
            return (collective.allreduce_(loss_sum * inv_k, op=Average,
                                          axes=data_axes), gnorm)

    # telemetry: the gradient norm reads the averaged gradients where
    # an allreduce leaves them in .grad (after optimizer.step()), else
    # the local ones (before it), as in the JAX non-overlapped step
    recorder = _StepRecorder(accum_steps) if _tele_on(telemetry) else None
    want_norm = recorder is not None or _norm_out is not None
    averaged_in_place = (is_hvd and not sharded
                         and optimizer.backward_passes_per_step == 1)
    norm_axes = optimizer.axes if is_hvd else None

    if loader is not None:
        loader.attach_placement(data.device_placement(mesh.device),
                                spec=mesh.device)

    def loader_batch():
        if loader is None:
            raise TypeError(
                "step() with no batch needs a loader: build the step with "
                "make_train_step(..., loader=...) or pass (inputs, labels)")
        batch = next(loader)
        if not (isinstance(batch, (tuple, list)) and len(batch) == 2):
            raise TypeError(
                "the loader's source must yield (inputs, labels) batches "
                f"for this step; got {type(batch).__name__} of "
                f"{len(batch) if hasattr(batch, '__len__') else '?'}")
        return data.ready(batch)

    def step(inputs=None, labels=None):
        nonlocal residuals
        if inputs is None and labels is None:
            inputs, labels = loader_batch()
        elif inputs is None or labels is None:
            raise TypeError("step() takes (inputs, labels), or nothing "
                            "when a loader feeds it")
        check_wire_drift()
        if use_ef and residuals is None:
            residuals = new_residuals()
        t0 = time.perf_counter()
        dispatch = (recorder.dispatch() if recorder is not None
                    else contextlib.nullcontext())
        try:
            with _step_frame(state.step), dispatch:
                loss, gnorm = run(inputs, labels, residuals)
        except BaseException:
            # a failed step may have consumed some residuals and not
            # others: restart the compensation from zeros
            residuals = None
            raise
        state.step += 1
        if _norm_out is not None:
            _norm_out[0] = gnorm
        if recorder is not None:
            recorder.record(inputs.shape[0], t0, loss, gnorm)
        return loss

    def reset_error_feedback():
        """Drop the carried residuals; the next step starts from zeros."""
        nonlocal residuals
        residuals = None

    step.schedule = schedule
    step.state = state
    step.wire = wire
    step.reset_error_feedback = reset_error_feedback
    step.residuals = lambda: residuals
    if recorder is not None:
        step.instruments = recorder.instruments
    _attach_xray(step)
    return step


def _installed_mesh(mesh, what):
    """The installed mesh; a ``mesh`` argument must be that one (the
    port's collectives run over the installed mesh's groups)."""
    installed = mesh_lib.get_mesh()
    if mesh is not None and mesh is not installed:
        raise ValueError(f"{what}(mesh=...) must be the installed mesh: "
                         "parallel.mesh.build_mesh installs the mesh it "
                         "builds")
    return installed


def _check_optimizer_axes(mesh, optimizer, step_axes):
    """A step whose batch is split over ``step_axes`` refuses an optimizer
    that reduces over other ranks."""
    if mesh.group_of(step_axes)[1] != mesh.group_of(optimizer.axes)[1]:
        raise ValueError(
            f"the optimizer reduces over {optimizer.axes!r}, the step over "
            f"{step_axes}: build DistributedOptimizer(axes={step_axes})")


def _add_waited(acc, pending):
    """Wait for one microbatch's reduce-scatters, in schedule order, and
    add their shards to ``acc`` (None for the first microbatch)."""
    shards = [p.wait() for p in pending]
    return shards if acc is None else [a + s for a, s in zip(acc, shards)]


def make_lm_train_step(model, optimizer, mesh=None, batch_axis=None,
                       seq_axis=None, spmd=False, telemetry=None,
                       _norm_out=None):
    """Build a language-model train step (next-token loss).
    ``optimizer`` is a ``DistributedOptimizer`` (any exchange: fused
    allreduce, ZeRO-1, ``backward_passes_per_step``) whose axes are the
    step's: ``(batch_axis,)``, or ``(batch_axis, seq_axis)``.
    ``step(tokens)`` takes this rank's block of the batch,
    ``[B_local, S_local]`` int tokens (``shard_lm_batch`` cuts it from the
    global batch), runs forward, backward and the optimizer step, and
    returns the loss averaged over those axes (an fp32 scalar tensor on
    the device). ``batch_axis`` may be a tuple; None is the mesh's data
    axes (``mesh.data_axis_names``: ``("data",)``, or ``("dcn",
    "data")`` on ``init()``'s mesh of a job across hosts), which a
    default ``DistributedOptimizer`` reduces over when the mesh has no
    ``seq_axis``. ``step.state`` counts the steps, as in
    ``make_train_step``. ``mesh`` is the installed mesh (``init()``'s, or
    ``parallel.mesh.build_mesh``'s), the default.

    With ``seq_axis`` the sequence is sharded over that axis, and the
    model's attention is ring attention over it
    (``TransformerConfig.sequence_axis``). The loss is still exact: each
    shard's last position is scored against the next shard's first token
    (one ``ppermute`` over ``seq_axis``), only the global last position
    is masked (on the last rank of the axis), and the sum is normalized
    by the global target count, so averaging the per-shard losses and
    gradients over both axes gives the full-sequence mean loss and
    gradient. The normalization is the same without ``seq_axis``: the
    local sum is scaled by ``n_shards / global_count``, exact even when
    ranks hold different numbers of targets.

    ``spmd=True`` builds the GSPMD LM step (``_make_spmd_lm_train_step``):
    ``step(tokens)`` takes the GLOBAL ``[B, S]`` batch and the
    placements own the exchange. It refuses ``seq_axis``: a sharded
    sequence needs the ring's collectives, which the explicit step
    runs.

    ``telemetry`` (None: ``telemetry.enabled()``) records the step's
    instruments, as ``make_train_step``'s (the JAX LM step only settles
    the ledger and marks the recorder; the port's records as its
    classification step does): the examples are this rank's sequences,
    and the gradient norm that of the averaged gradient, read from
    ``.grad`` after the allreduce (one foreach pass), or under ZeRO-1 or
    ``backward_passes_per_step > 1`` the root-mean of the ranks' local
    norms; the GSPMD step's is the exact norm of the global-mean
    gradient.

    ``_norm_out`` (internal: the GSPMD step's chunked island) is a
    one-item list each step writes a gradient norm into, with or without
    telemetry: under a chunked wire the exact norm of the global-mean
    gradient, from the shards its reduce-scatter leaves on each rank."""
    if spmd:
        if seq_axis is not None:
            raise ValueError(
                "make_lm_train_step(spmd=True) shards the batch only; a "
                "sequence axis is the explicit step's (spmd=False), whose "
                "ring attention moves the K/V blocks")
        return _make_spmd_lm_train_step(model, optimizer, mesh=mesh,
                                        batch_axis=batch_axis,
                                        telemetry=telemetry)
    if not isinstance(optimizer, hvd_torch.DistributedOptimizer):
        raise TypeError("make_lm_train_step needs a DistributedOptimizer")
    mesh = _installed_mesh(mesh, "make_lm_train_step")
    if batch_axis is None:
        batch_axis = mesh_lib.data_axis_names(mesh)
    batch_axes = ((batch_axis,) if isinstance(batch_axis, str)
                  else tuple(batch_axis))
    grad_axes = batch_axes + ((seq_axis,) if seq_axis else ())
    _check_optimizer_axes(mesh, optimizer, grad_axes)
    cfg_axis = getattr(getattr(model, "cfg", None), "sequence_axis", None)
    if cfg_axis is not None and cfg_axis != seq_axis:
        raise ValueError(f"the model's sequence_axis is {cfg_axis!r}, the "
                         f"step's seq_axis {seq_axis!r}")
    n_shards = collective.mesh_size(grad_axes)
    n_seq = mesh.axis_size(seq_axis) if seq_axis else 1
    # shard i's last target is shard i+1's first token
    next_first = [((i + 1) % n_seq, i) for i in range(n_seq)]
    state = StepState()

    def sharded_loss(tokens):
        nxt = collective.ppermute(tokens[:, :1], seq_axis, next_first)
        targets = torch.cat([tokens[:, 1:], nxt], dim=1)
        mask = torch.ones(targets.shape, device=mesh.device)
        if mesh.axis_index(seq_axis) == n_seq - 1:
            mask[:, -1] = 0.0  # the global last position
        global_count = collective.allreduce_(mask.sum(), op=Sum,
                                             axes=grad_axes)
        logp = F.log_softmax(model(tokens).float(), dim=-1)
        nll = -logp.gather(-1, targets[..., None])[..., 0]
        return (nll * mask).sum() * n_shards / global_count

    def loss_fn(tokens):
        if n_seq > 1:
            return sharded_loss(tokens)
        targets = tokens[:, 1:]
        local_count = torch.tensor(float(targets.numel()), device=mesh.device)
        global_count = collective.allreduce_(local_count.clone(), op=Sum,
                                             axes=grad_axes)
        local_mean = softmax_cross_entropy(model(tokens)[:, :-1], targets)
        return local_mean * local_count * n_shards / global_count

    recorder = _StepRecorder() if _tele_on(telemetry) else None
    want_norm = recorder is not None or _norm_out is not None
    averaged_in_place = (not optimizer.sharded_update
                         and optimizer.backward_passes_per_step == 1)

    def run(tokens):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(tokens)
        loss.backward()
        gnorm = None
        if want_norm:
            grads = [p.grad for p in optimizer.params]
            if not averaged_in_place:
                gnorm = _local_norm(grads, grad_axes)
        shards = [] if _norm_out is not None else None
        optimizer.shard_sink = None if shards is None else shards.append
        try:
            optimizer.step()  # reduces the gradients first
        finally:
            optimizer.shard_sink = None
        if shards:
            # a chunked wire's reduce-scatter: the shards partition the
            # global-mean gradient (the JAX GSPMD island's definition)
            gnorm = _shards_norm(shards, optimizer.reduce_axes())
        elif want_norm and averaged_in_place:
            gnorm = _grad_norm(grads)
        return collective.allreduce_(loss.detach(), op=Average,
                                     axes=grad_axes), gnorm

    def step(tokens):
        tokens = tokens.to(mesh.device)
        t0 = time.perf_counter()
        dispatch = (recorder.dispatch() if recorder is not None
                    else contextlib.nullcontext())
        with _step_frame(state.step), dispatch:
            loss, gnorm = run(tokens)
        state.step += 1
        if _norm_out is not None:
            _norm_out[0] = gnorm
        if recorder is not None:
            recorder.record(tokens.shape[0], t0, loss, gnorm)
        return loss

    step.state = state
    if recorder is not None:
        step.instruments = recorder.instruments
    _attach_xray(step)
    return step


def shard_lm_batch(tokens, batch_axis=None, seq_axis=None):
    """This rank's block of a global ``[B, S]`` batch: dim 0 cut by its
    coordinate on ``batch_axis``, dim 1 by its coordinate on ``seq_axis``
    (when given), the counterpart of the JAX step's
    ``PartitionSpec(batch_axis, seq_axis)``. A tuple ``batch_axis`` cuts
    dim 0 by this rank's row-major index over its axes; None is the
    installed mesh's data axes, as in ``make_lm_train_step``."""
    if batch_axis is None:
        batch_axis = mesh_lib.data_axis_names()
    for dim, axis in ((0, batch_axis), (1, seq_axis)):
        if axis is None:
            continue
        n, i = collective.mesh_size(axis), collective.mesh_rank(axis)
        if tokens.shape[dim] % n:
            raise ValueError(f"dim {dim} of the batch ({tokens.shape[dim]})"
                             f" does not divide by the {axis!r} axis ({n})")
        size = tokens.shape[dim] // n
        tokens = tokens.narrow(dim, i * size, size)
    return tokens


# -- the GSPMD steps (parallel/gspmd.py) ------------------------------------

def _spmd_gate(optimizer, what):
    """The GSPMD builders' checks (JAX ``training.py:661``): torch's
    DTensor API and the optimizer's contract. Returns the resolved wire
    format (None or a compressor: a chunked one runs as an island, a
    cast one narrows the placement exchange)."""
    from horovod_tpu_torch.parallel import gspmd

    ok, reason = gspmd.gspmd_supported()
    if not ok:
        raise RuntimeError(
            f"{what}(spmd=True) needs torch's DTensor API: {reason}. Use "
            "the explicit pipeline (spmd=False) on this torch; "
            "parallel/gspmd.gspmd_supported owns this gate.")
    if not isinstance(optimizer, hvd_torch.DistributedOptimizer):
        raise ValueError(
            f"{what}(spmd=True) needs the optimizer built by "
            "DistributedOptimizer(...): the GSPMD step routes its "
            "gradient exchange through the plan")
    if optimizer.op != Average:
        raise ValueError(
            f"the GSPMD step computes the global-batch mean loss, which is "
            f"op=Average; got {optimizer.op!r}. Adasum/Sum/Min/Max "
            "reductions live on the explicit path (spmd=False)")
    if optimizer.backward_passes_per_step > 1:
        raise ValueError(
            "backward_passes_per_step>1 has no GSPMD path: its "
            "accumulator lives in the explicit pipeline")
    return optimizer.compression


class _SpmdProgram:
    """What both GSPMD steps share (JAX ``_SpmdProgram``,
    ``training.py:691``, without the jit: the placement program runs op
    by op): the plan, the model's parameters as ``Replicate()`` DTensors,
    the batch placement, and the accounting of the collectives (one
    record per batch signature, ``gspmd.CompiledProgramCache``).

    The DTensor parameters share each parameter's storage
    (``gspmd.param_views``), and the model runs on them through
    ``torch.func.functional_call``; the module keeps its own parameters,
    which the optimizer updates in place. So the optimizer is never
    rebound: its state, hyperparameters, ``state_dict()`` and the
    checkpoints (``convert``) are the explicit path's, and a
    ``load_state_dict`` of the model or the optimizer is the step's next
    state. A parameter whose storage was replaced (``module.to``) gets a
    new view at the next step."""

    def __init__(self, plan, model, optimizer):
        from horovod_tpu_torch.parallel import gspmd
        self.plan = plan
        self.model = model
        names = {id(p): n for n, p in model.named_parameters()}
        missing = [i for i, p in enumerate(optimizer.params)
                   if id(p) not in names]
        if missing:
            raise ValueError(
                f"the optimizer's parameters {missing} are not the "
                "model's: the GSPMD step runs the model on its own "
                "parameters")
        self.order = [names[id(p)] for p in optimizer.params]
        self._params = dict(model.named_parameters())
        self._views = None
        self.views()  # the parameters' Replicate() DTensors, at build
        self._cache = gspmd.CompiledProgramCache(mesh=plan.mesh)
        self.batch_placements = plan.placements(plan.batch_spec)
        self.compiled_collectives = None
        self.compiled_axis_collectives = None

    def views(self):
        from horovod_tpu_torch.parallel import gspmd
        fresh = self._views is not None and all(
            self._views[n]._local_tensor.data_ptr() == p.data_ptr()
            for n, p in self._params.items())
        if not fresh:
            self._params = dict(self.model.named_parameters())
            self._views = gspmd.param_views(self.plan,
                                            self._params.items())
        return self._views

    def take_grads(self):
        """The views' gradients in the optimizer's order, cleared."""
        grads = []
        for n in self.order:
            v = self._views[n]
            grads.append(v.grad)
            v.grad = None
        return grads

    def place(self, x):
        """A global batch (the same on every rank) as this rank's rows of
        a batch-sharded DTensor, with no collective
        (``procmesh.shard_from_global``); a placed DTensor as it is."""
        from horovod_tpu_torch.cluster import procmesh
        if not torch.is_tensor(x):
            x = torch.as_tensor(x)
        return procmesh.place(x, self.plan.device_mesh,
                              self.batch_placements)

    def run(self, fn, *args):
        out = self._cache.run(fn, *args)
        self.compiled_collectives = self._cache.last_collectives
        self.compiled_axis_collectives = self._cache.last_axis_collectives
        return out


def _spmd_wire_drift_checker(optimizer, wire):
    """Warn once when ``optimizer.compression`` no longer resolves to the
    format the GSPMD step was built with (JAX ``training.py:773``): the
    step fixes its exchange (the island, the narrowed placements, or
    neither) when it is built."""
    warned = [False]

    def check():
        if warned[0]:
            return
        now = optimizer.compression
        if now is not wire:
            warned[0] = True
            built = (f"built with {wire.name!r}" if wire is not None
                     else "built uncompressed")
            warnings.warn(
                f"optimizer.compression now resolves to "
                f"{getattr(now, 'name', None)!r} but this GSPMD step was "
                f"{built}: the wire format is fixed when make_train_step "
                "runs. Rebuild the step after setting HOROVOD_WIRE_DTYPE "
                "for the new format to take effect.", stacklevel=3)

    return check


def _spmd_step_common(step, prog, plan, state, recorder):
    step.state = state
    step.plan = plan
    step.spmd = True
    step.compiled_collectives = None  # set at the first call
    step.compiled_axis_collectives = None
    step.program = prog
    if recorder is not None:
        step.instruments = recorder.instruments
    _attach_xray(step, collectives=lambda: step.compiled_collectives)


def _spmd_norm(norm, optimizer):
    """The GSPMD step's gradient norm, outside its recorded call: the
    exact norm of the global-mean gradient, as the JAX GSPMD step's.
    ``norm`` is that of what ``update_spmd`` reduced (its ``on_reduced``):
    plain data parallelism's whole gradients, or this rank's ZeRO-1
    shards, whose squares one scalar all-reduce sums over the ranks (the
    pads are zero)."""
    if norm is None or not optimizer.sharded_update:
        return norm
    return collective.allreduce_(
        norm.square(), op=Sum,
        axes=optimizer.zero_state.plan.schedule.axes).sqrt()


def _check_spmd_batch_axes(plan, batch_axes, what):
    """The GSPMD steps place the batch over the plan's data axes."""
    if set(batch_axes) != set(plan.data_axes):
        raise ValueError(f"the GSPMD {what} shards the batch over the data "
                         f"axes {plan.data_axes}, not {batch_axes}")


def _make_spmd_train_step(model, optimizer, loss_fn=softmax_cross_entropy,
                          batch_axes=None, dropout_seed=0, accum_steps=1,
                          overlap_grads=False, error_feedback=True,
                          loader=None, telemetry=None):
    """The GSPMD step behind ``make_train_step(spmd=True)`` (JAX
    ``training.py:804``). ``step(inputs, labels)`` takes the global batch,
    the same on every rank (or DTensors already placed); each rank keeps
    its rows (``procmesh.shard_from_global``). The model runs on
    ``Replicate()`` parameters (see ``_SpmdProgram``) and batch-sharded
    inputs; its parameters' gradients leave the backward ``Partial``, and
    ``DistributedOptimizer.update_spmd`` reduces them by redistributing
    (DTensor issues the all-reduce, or ZeRO-1's reduce-scatter and
    all-gather): the step's own code calls no collective. It returns the
    loss, the global-batch mean, as an fp32 scalar on this rank's device,
    the same on every rank (one scalar collective). ``step.state``,
    ``step.plan``, ``step.spmd`` and ``step.compiled_collectives`` /
    ``compiled_axis_collectives`` (the collectives of the first call of
    the latest batch signature) ride on the step.

    Semantics, as the JAX step's (``training.py:143-146``): the loss is
    the global-batch mean; BatchNorm normalizes with global-batch
    statistics (``models.resnet.BatchNorm`` runs
    ``gspmd.sync_batch_norm`` on a DTensor); a model that takes
    ``dropout_generator`` draws its masks from a generator keyed by
    ``dropout_seed`` and the step only, at the global batch's shape, so
    each rank's mask is its rows of one mask whatever the world.

    Wire compression is built in place, never a fallback:

    * a chunked quantizer (fp8, int8) runs the explicit overlapped step
      (per-shard forward and backward, the compressed bucket exchange,
      error feedback, per-shard BatchNorm statistics averaged after,
      per-rank dropout) as one island (``gspmd.shard_map_island``);
    * a cast wire (bf16, float16) keeps the placement program: ZeRO-1's
      rows are cast before both redistributions (delta error feedback on
      the all-gather half); plain data parallelism reduces its gradient
      buckets at the wire dtype (stateless).

    Telemetry as the explicit step's, with the JAX GSPMD step's frame:
    the ledger notes the compiled path (its collectives live inside the
    step), and the first call of a batch signature books as compile
    (``gspmd.CompiledProgramCache``). The gradient norm is the exact
    norm of the global-mean gradient, as the JAX GSPMD step's: of what
    ``update_spmd`` reduced (``_spmd_norm``), or in a chunked wire's
    island of the reduce-scattered shards (their squares summed over the
    ranks by one scalar all-reduce, JAX ``training.py:923-929``).
    """
    from horovod_tpu_torch.parallel import gspmd
    from torch.distributed.tensor.experimental import implicit_replication

    wire = _spmd_gate(optimizer, "make_train_step")
    if accum_steps != 1 or overlap_grads:
        raise ValueError(
            "accum_steps/overlap_grads are the explicit pipeline's "
            "microbatch knobs; the GSPMD step runs the whole batch through "
            "the placements")
    if any(isinstance(m, nn.SyncBatchNorm) for m in model.modules()):
        raise NotImplementedError(
            "torch's nn.SyncBatchNorm keeps an unbiased running variance; "
            "the GSPMD step normalizes models.resnet.BatchNorm over the "
            "global batch")
    mesh = mesh_lib.get_mesh()
    plan = gspmd.derive_plan(mesh)
    if batch_axes is not None:
        _check_spmd_batch_axes(plan, batch_axes, "step")
    sharded = optimizer.sharded_update
    chunked = wire is not None and wire.chunked
    use_ef = wire is not None and error_feedback and (chunked or sharded)
    prog = _SpmdProgram(plan, model, optimizer)
    check_wire_drift = _spmd_wire_drift_checker(optimizer, wire)
    takes_rng = "dropout_generator" in inspect.signature(
        model.forward).parameters
    residuals = None  # the cast + ZeRO-1 path's all-gather carry

    recorder = _StepRecorder() if _tele_on(telemetry) else None
    gnorm_box = [None]

    def on_reduced(reduced):
        if recorder is not None:
            gnorm_box[0] = _grad_norm(reduced)
    if chunked:
        # the explicit overlapped step, whole, as the island
        inner = make_train_step(model, optimizer, loss_fn=loss_fn,
                                dropout_seed=dropout_seed,
                                overlap_grads=True,
                                error_feedback=error_feedback,
                                telemetry=False,
                                _norm_out=(None if recorder is None
                                           else gnorm_box))
        state = inner.state
        spec = plan.batch_spec
        global_step = gspmd.shard_map_island(
            inner, plan, in_specs=(spec, spec), out_specs=())
    else:
        state = StepState()

        def global_step(inputs, labels):
            model.train()
            optimizer.zero_grad(set_to_none=True)  # free the last grads
            views = prog.views()
            kwargs = {}
            if takes_rng:
                kwargs["dropout_generator"] = _dropout_generator(
                    mesh.device, dropout_seed, state.step)
            with implicit_replication():
                logits = torch.func.functional_call(model, views, (inputs,),
                                                    kwargs)
                loss = loss_fn(logits, labels)
                # the backward of an op that mixed in a host tensor
                # (positions, a dropout mask) mixes it in again
                loss.backward()
            grads = prog.take_grads()
            with torch.no_grad():
                if wire is not None and not sharded:
                    grads = [None if g is None else
                             gspmd.narrow(g, wire.wire_dtype) for g in grads]
                if wire is not None and sharded:
                    new_ag = optimizer.update_spmd(
                        grads, plan, wire=wire,
                        ag_residuals=residuals if use_ef else None,
                        on_reduced=on_reduced)
                    if use_ef:
                        residuals[:] = new_ag
                else:
                    optimizer.update_spmd(grads, plan,
                                          on_reduced=on_reduced)
            return gspmd.full_value(loss, plan)

    if loader is not None:
        loader.attach_placement(data.device_placement(mesh.device),
                                spec=(plan.device_mesh,
                                      tuple(prog.batch_placements)))

    def loader_batch():
        if loader is None:
            raise TypeError(
                "step() with no batch needs a loader: build the step with "
                "make_train_step(..., loader=...) or pass (inputs, labels)")
        batch = next(loader)
        if not (isinstance(batch, (tuple, list)) and len(batch) == 2):
            raise TypeError(
                "the loader's source must yield (inputs, labels) batches "
                f"for this step; got {type(batch).__name__}")
        return data.ready(batch)

    def step(inputs=None, labels=None):
        nonlocal residuals
        if inputs is None and labels is None:
            inputs, labels = loader_batch()
        elif inputs is None or labels is None:
            raise TypeError("step() takes (inputs, labels), or nothing "
                            "when a loader feeds it")
        check_wire_drift()
        placed = (prog.place(inputs), prog.place(labels))
        if use_ef and not chunked and residuals is None:
            schedule = optimizer.zero_state.plan.schedule
            residuals = [torch.zeros(
                n if b.dtype.is_floating_point else 0, dtype=torch.float32,
                device=mesh.device)
                for b, n in zip(schedule.buckets, schedule.shard_sizes)]
        t0 = time.perf_counter()
        dispatch = (recorder.dispatch() if recorder is not None
                    else contextlib.nullcontext())
        n = state.step
        try:
            with _step_frame(n, compiled_path=True), dispatch:
                loss = prog.run(global_step, *placed)
                gnorm = (gnorm_box[0] if chunked
                         else _spmd_norm(gnorm_box[0], optimizer))
        except BaseException:
            residuals = None
            raise
        step.compiled_collectives = prog.compiled_collectives
        step.compiled_axis_collectives = prog.compiled_axis_collectives
        if chunked:
            loss = loss.to_local()
        else:
            state.step += 1
        if recorder is not None:
            recorder.record(placed[0].shape[0], t0, loss, gnorm)
        return loss

    def reset_error_feedback():
        """Drop the carried residuals; the next step starts from zeros."""
        nonlocal residuals
        residuals = None
        if chunked:
            inner.reset_error_feedback()

    _spmd_step_common(step, prog, plan, state, recorder)
    step.wire = wire
    step.reset_error_feedback = reset_error_feedback
    step.residuals = (inner.residuals if chunked else lambda: residuals)
    return step


def _make_spmd_lm_train_step(model, optimizer, mesh=None, batch_axis=None,
                             telemetry=None):
    """The GSPMD LM step behind ``make_lm_train_step(spmd=True)`` (JAX
    ``training.py:1248``): ``step(tokens)`` takes the global ``[B, S]``
    batch (the same on every rank, or a DTensor already placed), runs the
    model on ``Replicate()`` parameters and batch-sharded tokens, and
    returns the next-token loss, the global-batch mean, as an fp32
    scalar on this rank's device, the same on every rank. The flash
    kernels run as an island a layer (``gspmd.local_attention``, through
    ``ops/flash_attention.attention``); the step's own code calls no
    collective. The step carries what ``_make_spmd_train_step``'s does.

    Compression is built in place, as there, and stateless (no error
    feedback, as the explicit LM step's ``optimizer.step()``): a chunked
    wire runs the explicit LM step whole as an island; a cast wire
    narrows ZeRO-1's placement exchange, or the plain path's gradient
    buckets. Telemetry as ``_make_spmd_train_step``'s: a chunked wire's
    island records the exact norm of the global-mean gradient from the
    shards its reduce-scatters leave on each rank, as that step's
    island does."""
    from horovod_tpu_torch.parallel import gspmd
    from torch.distributed.tensor.experimental import implicit_replication

    wire = _spmd_gate(optimizer, "make_lm_train_step")
    mesh = _installed_mesh(mesh, "make_lm_train_step")
    if batch_axis is None:
        batch_axis = mesh_lib.data_axis_names(mesh)
    batch_axes = ((batch_axis,) if isinstance(batch_axis, str)
                  else tuple(batch_axis))
    _check_optimizer_axes(mesh, optimizer, batch_axes)
    plan = gspmd.derive_plan(mesh)
    _check_spmd_batch_axes(plan, batch_axes, "LM step")
    sharded = optimizer.sharded_update
    chunked = wire is not None and wire.chunked
    prog = _SpmdProgram(plan, model, optimizer)
    check_wire_drift = _spmd_wire_drift_checker(optimizer, wire)

    recorder = _StepRecorder() if _tele_on(telemetry) else None
    gnorm_box = [None]

    def on_reduced(reduced):
        if recorder is not None:
            gnorm_box[0] = _grad_norm(reduced)
    if chunked:
        inner = make_lm_train_step(model, optimizer, batch_axis=batch_axis,
                                   telemetry=False,
                                   _norm_out=(None if recorder is None
                                              else gnorm_box))
        state = inner.state
        global_step = gspmd.shard_map_island(
            inner, plan, in_specs=(plan.batch_spec,), out_specs=())
    else:
        state = StepState()

        def global_step(tokens):
            optimizer.zero_grad(set_to_none=True)  # free the last grads
            views = prog.views()
            with implicit_replication():
                logits = torch.func.functional_call(model, views, (tokens,))
                loss = softmax_cross_entropy(logits[:, :-1], tokens[:, 1:])
                loss.backward()
            grads = prog.take_grads()
            with torch.no_grad():
                if wire is not None and not sharded:
                    grads = [None if g is None else
                             gspmd.narrow(g, wire.wire_dtype) for g in grads]
                if wire is not None and sharded:
                    optimizer.update_spmd(grads, plan, wire=wire,
                                          on_reduced=on_reduced)
                else:
                    optimizer.update_spmd(grads, plan,
                                          on_reduced=on_reduced)
            return gspmd.full_value(loss, plan)

    def step(tokens):
        check_wire_drift()
        placed = prog.place(tokens)
        t0 = time.perf_counter()
        dispatch = (recorder.dispatch() if recorder is not None
                    else contextlib.nullcontext())
        with _step_frame(state.step, compiled_path=True), dispatch:
            loss = prog.run(global_step, placed)
            gnorm = (gnorm_box[0] if chunked
                     else _spmd_norm(gnorm_box[0], optimizer))
        step.compiled_collectives = prog.compiled_collectives
        step.compiled_axis_collectives = prog.compiled_axis_collectives
        if chunked:
            loss = loss.to_local()
        else:
            state.step += 1
        if recorder is not None:
            recorder.record(placed.shape[0], t0, loss, gnorm)
        return loss

    _spmd_step_common(step, prog, plan, state, recorder)
    step.wire = wire
    return step


def elastic_train_loop(elastic_state, train_step, batch_fn, num_steps,
                       commit_every=1, checkpoint_every=None,
                       on_step=None):
    """Drive ``train_step`` under the elastic retry loop
    (``hvd.elastic.run``): the JAX ``training.elastic_train_loop`` over
    an ``elastic.TorchState`` that holds the step's model, optimizer and
    ``StepState`` (``train_step.state``, adopted when the state was
    built without one). Commit / restore / sync come from the state,
    membership interrupts are taken at commit boundaries, and a worker
    failure rolls back to the last commit before the retry.

    ``batch_fn`` supplies the data: a callable ``batch_fn(step)``
    (indexed by the step, so a restored worker reads the right batch),
    returning the step's arguments (a tuple, or one tensor such as an
    LM's tokens), or a ``data.PrefetchLoader``, whose cursor the loop
    attaches to the state, so that it commits, restores and re-syncs
    with the model and a rollback replays the rolled-back steps'
    batches. ``on_step(step, loss)`` observes each step. Returns the
    last loss.

    ``checkpoint_every=K`` sets the disk cadence apart from the
    in-memory ``commit_every``: every K-th commit is saved through
    ``ckpt.AsyncCheckpointer`` (the state needs a ``directory``), and
    the final commit always reaches disk. After a restore (a rollback
    or a relaunch's disk restore) the step's error-feedback residuals
    are dropped (``reset_error_feedback``), or the next step would carry
    the error of a later step. A step not built by this module (which
    settles the goodput ledger in its frame) has the ledger settled,
    and with telemetry on its latency recorded, by the loop."""
    from horovod_tpu_torch import elastic as _elastic

    if checkpoint_every is not None:
        if not getattr(elastic_state, "_directory", None):
            raise ValueError(
                "checkpoint_every needs an elastic state with a "
                "checkpoint directory (TorchState(directory=...))")
        elastic_state.checkpoint_every = max(1, int(checkpoint_every))
    step_state = getattr(train_step, "state", None)
    if getattr(elastic_state, "step_state", None) is None:
        elastic_state.step_state = step_state
    elif step_state is not None and elastic_state.step_state is not \
            step_state:
        raise ValueError("the elastic state's step_state must be the "
                         "step's own (train_step.state)")
    counter = elastic_state.step_state
    if counter is None:
        raise ValueError("elastic_train_loop needs the step's StepState: "
                         "a step built here carries it as step.state, or "
                         "give TorchState(step_state=...)")

    loader = (batch_fn if hasattr(batch_fn, "cursor")
              and hasattr(batch_fn, "__next__") else None)
    if loader is not None and hasattr(elastic_state, "attach_loader"):
        elastic_state.attach_loader(loader)

    own = getattr(train_step, "_settles_ledger", False)
    own_instruments = None
    if not own and telemetry_lib.enabled():
        own_instruments = telemetry_lib.StepInstruments()
    reset_ef = getattr(train_step, "reset_error_feedback", None)
    seen_restores = [getattr(elastic_state, "restores", 0)]

    @_elastic.run
    def _loop(state):
        restores = getattr(state, "restores", 0)
        if restores != seen_restores[0]:
            seen_restores[0] = restores
            if reset_ef is not None:
                reset_ef()
        loss = None
        while counter.step < num_steps:
            batch = (next(loader) if loader is not None
                     else batch_fn(counter.step))
            args = tuple(batch) if isinstance(batch, (tuple, list)) \
                else (batch,)
            t0 = time.perf_counter()
            loss = train_step(*args)
            if not own:
                _ledger_lib.get_ledger().settle_step()
            if own_instruments is not None:
                first = args[0]
                own_instruments.record_step(
                    batch=int(first.shape[0]) if hasattr(first, "shape")
                    else 0, dispatch_s=time.perf_counter() - t0,
                    loss=loss, timeline=basics._state.timeline)
            done = counter.step
            if on_step is not None:
                on_step(done, float(loss))
            if done % commit_every == 0 or done >= num_steps:
                if done >= num_steps and hasattr(state, "checkpoint_every"):
                    # the final commit reaches disk whatever the cadence,
                    # which survives for a retry of this same state
                    cadence = state.checkpoint_every
                    state.checkpoint_every = 1
                    try:
                        state.commit()
                    finally:
                        state.checkpoint_every = cadence
                else:
                    state.commit()
        state.flush()  # drain the async saves before leaving the loop
        return loss

    return _loop(elastic_state)
