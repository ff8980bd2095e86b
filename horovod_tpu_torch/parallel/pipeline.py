"""Pipeline parallelism over a ``stage`` axis: GPipe and 1F1B. The port of
``horovod_tpu/parallel/pipeline.py``.

The layer stack's parameters are stacked on a leading dim
(``stack_params``) and cut into contiguous blocks of layers, one a stage
(``split_stages``). Activations move from stage to stage by the stage
axis's ``ppermute`` once a schedule tick, and every stage runs the same
tick program. A stage that idles on a tick computes nothing and launches
nothing: the ticks run in Python, which skips it.

Both schedules are written once over ``parallel/axis.py``'s axis objects,
as ring attention and the tensor-parallel blocks are: ``stage`` (and
``batch``) is a ``GroupAxis`` (one rank a stage) or a ``LocalAxis`` (every
stage in this process, as the tests and ``chip_smoke.py`` hold them).
Every argument that varies by shard is a list, one entry per shard of the
axes (``stage.indices``): ``stacked_params`` each shard's
``{name: [L / S, ...]}``, ``h`` each shard's activations ``[B / dp, ...]``.

* ``pipelined_forward`` — GPipe: ``n_micro + n_stages - 1`` ticks, stage
  ``s`` on micro ``t - s`` at tick ``t``; the last stage's outputs are
  replicated over the stage axis. Differentiable: one autograd function
  keeps each stage's graph of each micro (activation memory O(n_micro))
  and replays the ticks in reverse in its backward, each reverse tick one
  move to the left. Autograd alone would not do: on a stage before the
  last nothing links the rank's loss to its moves, so their backward
  would never run there. ``remat=True`` checkpoints each layer.
* ``pipeline_train_1f1b`` — 1F1B: one forward and backward step by the
  static table of ``_schedule_1f1b``, one forward and one backward slot a
  stage a tick; the backward slot recomputes the stage from its saved
  input and takes ``torch.autograd.grad``, so the stage keeps rings of
  ``n_stages`` micro activations (O(n_stages)), whatever ``n_micro``.

``block_fn(layer_params, xs) -> ys`` applies one layer to the shards of
one stage: lists, in shard order, of each shard's layer parameters and
activations. In the local form those are the shards whose stage index
is ``s``; the axes ``block_fn`` moves them over are those of the mesh
without the stage axis (a tensor-parallel block's model axis:
``parallel/tensor.py``'s cut weights come in as ``stacked_params`` and
the block uses the model axis's ``copy_to`` and ``reduce_from``).
``per_micro_loss(ys, m)`` scores the last stage's shards alike.

Over ``batch`` every shard holds its own replica of the parameters, as
its rank would, and receives the gradient summed over the axis: GPipe's
backward and 1F1B sum them with one all-reduce over ``batch`` at the end
(the JAX package's ``shard_map`` transpose sums them as it goes, so the
order of the sums differs).

The JAX file refuses the composed 1F1B on a JAX without varying-manual
axes (``compat.NATIVE_VMA``): a JAX-version hazard, with no counterpart
here.
"""

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint


def stack_params(param_trees):
    """Stack per-layer parameter dicts (``{name: tensor}``, one a layer)
    along a new leading dim: ``{name: [L, ...]}``, the layout the
    schedules cut over the stage axis. A layer's slice of a stacked
    tensor is a view, so a gradient taken through it lands there."""
    return {k: torch.stack([t[k] for t in param_trees])
            for k in param_trees[0]}


def _layers(params):
    return next(iter(params.values())).shape[0]


def split_stages(stacked, stage):
    """Each shard's block of the stacked layers: shard ``p`` gets layers
    ``[s L / S, (s + 1) L / S)`` of every leaf, ``s = stage.indices[p]``,
    as views of ``stacked``."""
    L = _layers(stacked)
    if L % stage.n:
        raise ValueError(f"{L} layers not divisible by {stage.n} stages")
    per = L // stage.n
    return [{k: v[s * per:(s + 1) * per] for k, v in stacked.items()}
            for s in stage.indices]


def _check_shapes(stacked_params, h, stage, n_micro, batch):
    dp = 1 if batch is None else batch.n
    B = h[0].shape[0] * dp
    if B % (n_micro * dp):
        raise ValueError(
            f"batch {B} not divisible by n_micro={n_micro} x dp={dp}")
    layers = sorted({_layers(p) for p in stacked_params})
    if len(layers) > 1:
        raise ValueError(f"the stages hold {layers} layers: the layers are "
                         f"not divisible by {stage.n} stages")


def _apply_local(block_fn, params, xs, remat=False):
    """This stage's slice of the layer stack, in order, on one stage's
    shards (``params`` each shard's ``{name: [L / S, ...]}``)."""
    for i in range(_layers(params[0])):
        layer = [{k: v[i] for k, v in p.items()} for p in params]
        if remat:
            xs = checkpoint(block_fn, layer, xs, use_reentrant=False)
        else:
            xs = block_fn(layer, xs)
    return list(xs)


def _stage_shards(stage):
    """The positions of the shards of each stage index, in shard order
    (none where this process holds no shard of the stage)."""
    out = [[] for _ in range(stage.n)]
    for p, s in enumerate(stage.indices):
        out[s].append(p)
    return out


def _add(acc, grads):
    """``acc`` (a dict, or None) plus ``grads`` key by key."""
    if acc is None:
        return dict(grads)
    return {k: acc[k] + g for k, g in grads.items()}


def _reduce_grads(grads, batch):
    """Each shard's gradients summed over ``batch``, key by key."""
    if batch is None or batch.n == 1:
        return grads
    summed = {k: batch.all_reduce([g[k] for g in grads]) for k in grads[0]}
    return [{k: summed[k][p] for k in grads[0]} for p in range(len(grads))]


class _GPipeRun:
    """One GPipe call: the forward ticks, which keep each stage's graph of
    each micro, and the backward, the ticks in reverse."""

    def __init__(self, block_fn, stage, n_micro, batch, remat, keys):
        self.block_fn, self.stage, self.batch = block_fn, stage, batch
        self.n_micro, self.remat, self.keys = n_micro, remat, keys
        self.stages = _stage_shards(stage)

    def _valid(self, t, s):
        return 0 <= t - s < self.n_micro

    def _senders(self, t):
        """The stages that hand an activation right at tick ``t``."""
        return [s for s in range(self.stage.n - 1) if self._valid(t, s)]

    def forward(self, tensors):
        S, M, nk = self.stage.n, self.n_micro, len(self.keys)
        self.width = width = len(tensors) // (nk + 1)
        h = tensors[width * nk:]
        self.params = [{k: tensors[p * nk + i].detach().requires_grad_()
                        for i, k in enumerate(self.keys)}
                       for p in range(width)]
        self.mb = mb = h[0].shape[0] // M
        self.blank = [x.new_zeros((mb,) + x.shape[1:]) for x in h]
        self.saved = {}
        state = list(self.blank)
        outs = [[] for _ in range(width)]
        for t in range(M + S - 1):
            send = list(self.blank)
            for s, ps in enumerate(self.stages):
                m = t - s
                if not ps or not self._valid(t, s):
                    continue  # a bubble: nothing to compute
                with torch.enable_grad():
                    xs = [(h[p][m * mb:(m + 1) * mb] if s == 0 else state[p])
                          .detach().requires_grad_() for p in ps]
                    ys = _apply_local(self.block_fn,
                                      [self.params[p] for p in ps], xs,
                                      self.remat)
                self.saved[s, m] = xs, ys
                for p, y in zip(ps, ys):
                    if s == S - 1:
                        outs[p].append(y.detach())
                    else:
                        send[p] = y.detach()
            state = self.stage.ppermute(
                send, [(s, s + 1) for s in self._senders(t)])
        return [torch.cat(o) if o else torch.zeros_like(x)
                for o, x in zip(outs, h)]

    def backward(self, g_outs, need_h):
        S, M, mb, width = self.stage.n, self.n_micro, self.mb, self.width
        grads = [None] * width
        dh = [[None] * M for _ in range(width)]
        g_state = list(self.blank)  # the gradient of what a stage received
        for t in reversed(range(M + S - 1)):
            g_y = self.stage.ppermute(
                g_state, [(s + 1, s) for s in self._senders(t)])
            g_state = list(self.blank)
            for s, ps in enumerate(self.stages):
                m = t - s
                if not ps or not self._valid(t, s):
                    continue
                xs, ys = self.saved.pop((s, m))
                gys = ([g_outs[p][m * mb:(m + 1) * mb] for p in ps]
                       if s == S - 1 else [g_y[p] for p in ps])
                leaves = [self.params[p][k] for p in ps for k in self.keys]
                want_x = s > 0 or need_h
                got = torch.autograd.grad(
                    ys, (xs if want_x else []) + leaves, gys,
                    materialize_grads=True)
                if want_x:
                    for p, gx in zip(ps, got[:len(ps)]):
                        if s == 0:
                            dh[p][m] = gx
                        else:
                            g_state[p] = gx
                    got = got[len(ps):]
                nk = len(self.keys)
                for i, p in enumerate(ps):
                    grads[p] = _add(grads[p], dict(zip(
                        self.keys, got[i * nk:(i + 1) * nk])))
        grads = _reduce_grads(grads, self.batch)
        flat = [g[k] for g in grads for k in self.keys]
        return flat + [torch.cat(d) if d[0] is not None else None
                       for d in dh]


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, *tensors):
        ctx.run = run
        return tuple(run.forward(tensors))

    @staticmethod
    def backward(ctx, *g_outs):
        run = ctx.run
        need_h = any(ctx.needs_input_grad[1 + run.width * len(run.keys):])
        grads = run.backward(g_outs, need_h)
        del ctx.run
        return (None,) + tuple(grads)


def pipelined_forward(block_fn, stacked_params, h, *, stage, n_micro=None,
                      batch=None, remat=False):
    """Run ``h`` through the stacked layers as a GPipe pipeline; returns
    each shard's output ``[B / dp, ...]``, the last stage's, replicated
    over the stage axis.

    ``block_fn(layer_params, xs) -> ys`` applies ONE layer to one stage's
    shards (module docstring). ``stacked_params`` holds each shard's
    stage's layers ``{name: [L / S, ...]}`` (``split_stages``); ``h``
    each shard's input, whose batch divides by ``n_micro`` (default: one
    microbatch a stage). Stage 0 reads it; its gradient reaches stage 0's
    shards only.

    ``batch``: ``h`` is sharded over this axis and each data slice runs
    its own pipeline; the parameters' gradients are summed over it.

    The outputs are replicated by ``stage.reduce_from``: the sum of the
    last stage's outputs and the others' zeros forward, the identity
    backward, so each rank's loss of its replica reaches the last stage's
    computation once (a ``psum`` there would send back every rank's
    gradient, ``n_stages`` times the one). Every rank must compute its
    loss from its replica and run the backward: its moves run there.

    ``remat=True`` checkpoints each layer (``torch.utils.checkpoint``):
    the backward recomputes a layer's internals from its input.
    """
    n_micro = stage.n if n_micro is None else n_micro
    _check_shapes(stacked_params, h, stage, n_micro, batch)
    keys = sorted(stacked_params[0])
    run = _GPipeRun(block_fn, stage, n_micro, batch, remat, keys)
    outs = _GPipe.apply(run, *[p[k] for p in stacked_params for k in keys],
                        *h)
    return stage.reduce_from(list(outs))


def _schedule_1f1b(n_stages, n_micro):
    """Static 1F1B schedule table (the JAX package's, entry for entry).

    Greedy lockstep simulation (one F or B slot per stage per tick): a
    stage prefers backward once its in-flight count reaches
    ``min(n_micro, n_stages - s)``: warmup, steady 1F1B, cooldown.
    Returns ``(fwd, bwd)`` int arrays ``[T, n_stages]`` holding the
    microbatch each stage processes (-1 = idle), with peak in-flight
    microbatches per stage <= n_stages by construction.
    """
    fdone = [0] * n_stages
    bdone = [0] * n_stages
    f_tick = [[-1] * n_micro for _ in range(n_stages)]
    b_tick = [[-1] * n_micro for _ in range(n_stages)]
    fwd, bwd = [], []
    t = 0
    while bdone[0] < n_micro:
        frow = [-1] * n_stages
        brow = [-1] * n_stages
        for s in range(n_stages):
            m_f, m_b = fdone[s], bdone[s]
            f_ready = m_f < n_micro and (
                s == 0 or (0 <= f_tick[s - 1][m_f] < t))
            if s == n_stages - 1:
                b_ready = m_b < n_micro and 0 <= f_tick[s][m_b] < t
            else:
                b_ready = m_b < n_micro and 0 <= b_tick[s + 1][m_b] < t
            inflight = m_f - m_b
            max_inflight = min(n_micro, n_stages - s)
            # in-flight never exceeds max_inflight: the rings are sized
            # by it, so a stage at capacity idles until its next backward
            # is ready rather than overwrite a live slot
            if b_ready and (inflight >= max_inflight or m_f == n_micro):
                brow[s] = m_b
            elif f_ready and inflight < max_inflight:
                frow[s] = m_f
            elif b_ready:
                brow[s] = m_b
        for s in range(n_stages):
            if frow[s] >= 0:
                f_tick[s][frow[s]] = t
                fdone[s] += 1
            if brow[s] >= 0:
                b_tick[s][brow[s]] = t
                bdone[s] += 1
        fwd.append(frow)
        bwd.append(brow)
        t += 1
        if t > 4 * (n_micro + n_stages) + 8:
            raise RuntimeError("1F1B schedule did not converge")
    return np.asarray(fwd, np.int32), np.asarray(bwd, np.int32)


def pipeline_train_1f1b(block_fn, stacked_params, h, per_micro_loss, *,
                        stage, n_micro=None, batch=None,
                        with_input_grad=False):
    """One 1F1B training step: ``(losses, grads)``, each a list over the
    shards.

    Unlike ``pipelined_forward`` (differentiate it yourself), this is the
    forward and the backward: each tick a stage runs at most one forward
    and one backward slot, the backward recomputes the stage's forward
    from its saved input and takes ``torch.autograd.grad``, and every
    buffer is a ring of ``n_stages`` micro activations.

    ``per_micro_loss(ys, m) -> losses`` scores the last stage's outputs
    for microbatch ``m`` (one scalar a shard). ``losses`` (replicated over
    every axis) and ``grads`` (each shard's ``{name: [L / S, ...]}``,
    summed over ``batch``) are the SUM over microbatches and ``batch``
    slices: normalize inside ``per_micro_loss`` for a mean. The loss sums
    in fp32. ``with_input_grad=True`` appends each shard's d(loss)/d(h),
    replicated over the stage axis.
    """
    S = stage.n
    M = S if n_micro is None else n_micro
    _check_shapes(stacked_params, h, stage, M, batch)
    fwd, bwd = _schedule_1f1b(S, M)
    stages = _stage_shards(stage)
    width, mb = len(h), h[0].shape[0] // M
    keys = sorted(stacked_params[0])
    params = [{k: p[k].detach().requires_grad_() for k in keys}
              for p in stacked_params]
    blank = [x.new_zeros((mb,) + x.shape[1:]) for x in h]
    # rings of n_stages micro activations, slot m % n_stages
    inbox_f = [[None] * S for _ in range(width)]
    saved_x = [[None] * S for _ in range(width)]
    inbox_b = [[None] * S for _ in range(width)]
    grads = [None] * width
    losses = [torch.zeros((), dtype=torch.float32, device=x.device)
              for x in h]
    dh = [[None] * M for _ in range(width)]
    for frow, brow in zip(fwd.tolist(), bwd.tolist()):
        y_send, dx_send = list(blank), list(blank)
        for s, ps in enumerate(stages):
            if not ps:
                continue
            f_m, b_m = frow[s], brow[s]
            # ---- forward slot
            if f_m >= 0:
                xs = [h[p][f_m * mb:(f_m + 1) * mb] if s == 0
                      else inbox_f[p][f_m % S] for p in ps]
                for p, x in zip(ps, xs):
                    saved_x[p][f_m % S] = x
                # the last stage's forward output is never read: its
                # backward slot recomputes from the saved input
                if s < S - 1:
                    with torch.no_grad():
                        ys = _apply_local(block_fn, [params[p] for p in ps],
                                          xs)
                    for p, y in zip(ps, ys):
                        y_send[p] = y
            # ---- backward slot: recompute the stage from its input
            if b_m >= 0:
                want_x = s > 0 or with_input_grad
                leaves = [params[p][k] for p in ps for k in keys]
                with torch.enable_grad():
                    xs = [saved_x[p][b_m % S].detach().requires_grad_()
                          for p in ps]
                    ys = _apply_local(block_fn, [params[p] for p in ps], xs)
                    if s == S - 1:
                        outs = [loss.float()
                                for loss in per_micro_loss(ys, b_m)]
                        seeds = [torch.ones_like(loss) for loss in outs]
                    else:
                        outs = ys
                        seeds = [inbox_b[p][b_m % S] for p in ps]
                    got = torch.autograd.grad(
                        outs, (xs if want_x else []) + leaves, seeds,
                        materialize_grads=True)
                if s == S - 1:
                    for p, loss in zip(ps, outs):
                        losses[p] = losses[p] + loss.detach()
                if want_x:
                    for p, gx in zip(ps, got[:len(ps)]):
                        dx_send[p] = gx
                        if s == 0:
                            dh[p][b_m] = gx
                    got = got[len(ps):]
                for i, p in enumerate(ps):
                    grads[p] = _add(grads[p], dict(zip(
                        keys, got[i * len(keys):(i + 1) * len(keys)])))
        # ---- exchange: activations right, cotangents left; a receiver
        # reads the arriving micro from the sender's row
        y_right = stage.ppermute(
            y_send, [(s, s + 1) for s in range(S - 1) if frow[s] >= 0])
        dx_left = stage.ppermute(
            dx_send, [(s, s - 1) for s in range(1, S) if brow[s] >= 0])
        for s, ps in enumerate(stages):
            for p in ps:
                if s > 0 and frow[s - 1] >= 0:
                    inbox_f[p][frow[s - 1] % S] = y_right[p]
                if s < S - 1 and brow[s + 1] >= 0:
                    inbox_b[p][brow[s + 1] % S] = dx_left[p]
    # the loss lives on the last stage, dh on stage 0: replicate both
    losses = stage.all_reduce(losses)
    if batch is not None:
        losses = batch.all_reduce(losses)
    grads = _reduce_grads(grads, batch)
    if not with_input_grad:
        return losses, grads
    dh = stage.all_reduce([torch.cat(d) if d[0] is not None
                           else torch.zeros_like(x) for d, x in zip(dh, h)])
    return losses, grads, dh
