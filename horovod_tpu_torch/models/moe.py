"""Mixture-of-Experts layer with expert parallelism: the port of
``horovod_tpu/models/moe.py``.

Routing is top-k with a static per-expert capacity C: ``top_k=1`` is
Switch (the combine weight is the raw gate probability), ``top_k >= 2``
GShard (weights renormalized over the chosen experts; the k-th choices
queue behind every earlier choice for capacity, GShard's yield rule).
Tokens are dispatched in ``num_groups`` independent groups (GShard's
grouping): the dispatch and combine tensors are ``[G, T/G, E, C]`` with
``C = ceil(T/G / E * capacity_factor)``. Capacity and the queue
positions are per group, so the math depends only on ``(num_groups,
capacity_factor)`` and the global token count, never on the mesh: a
one-device layer with the same ``num_groups`` is the oracle of every
sharded one.

The JAX layer gets its collectives from GSPMD through the weights'
``PartitionSpec(expert, None, None)``. Here they are explicit, GShard's
schedule over ``parallel/axis.py``'s operators, written once for an axis
of process groups (``GroupAxis``) and for every shard in one process
(``LocalAxis``):

* the expert-major weights ``w_in [E, d, f]`` and ``w_out [E, f, d]`` are
  cut over the expert axis, ``E / N`` experts a shard; the gate is
  replicated;
* every expert rank routes the same tokens the same way (the routing is
  computed once on replicated tokens, so no rank can route a token
  differently), dispatches them to its own experts only, and the
  combine's sum over the experts is one ``reduce_from``;
* the combine weights and the dispatched tokens enter the sharded part
  through ``copy_to``, so the gate's gradient (and the input's) sums the
  combine part over the experts and counts the auxiliary terms, which
  every rank computes alike from all the tokens, once.

Two token layouts: ``make_tp_lm_train_step``'s, tokens replicated over
the expert axis and sharded over a data axis (groups held whole on a data
rank route there, with the auxiliary statistics summed over the data
axis; otherwise the tokens are gathered over it); and the JAX layer
tests', tokens sharded over the expert axis itself (``tokens_sharded``).
There, where the axis divides the groups, GShard's layout
(``tokens_all_to_all``): each shard routes its own groups and two
all-to-alls carry the dispatched tokens to their experts and back;
otherwise the long way (``tokens_gathered``): the tokens gathered over
the axis (``gather_to``), routed on every shard, and the result
reduce-scattered (``reduce_scatter_to``).

Flax's ``sow`` of the two fp32 auxiliary terms becomes the attribute
``MoE.sown`` (``{"load_balance": ..., "router_z": ...}``), written by each
call: ``aux_loss(model)`` sums them, and a caller that ignores it gets the
plain output. Each call also leaves ``MoE.dropped``, the share of its
token choices that found their expert full (a detached device scalar).
The forward's dispatch and combine run under the profiler range
``DISPATCH_RANGE``, the experts' FFN under ``EXPERTS_RANGE``.
Parameters are fp32 and cast to ``dtype`` at use, as every layer of the
port's transformer (the JAX layer keeps them in ``dtype``: at fp32 the
two are the same).
"""

import logging
import warnings

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.models.transformer import lecun_normal_
from horovod_tpu_torch.parallel import axis as axis_lib

_GROUP_FALLBACKS = set()  # (T, num_groups) pairs already logged
_A2A_FALLBACKS = set()  # (G, axis size) pairs already logged
# the profiler ranges of the dispatch and combine (the one-hot tensors
# and their two einsums) and of the experts' FFN, forward
DISPATCH_RANGE = "horovod_tpu_torch.moe_dispatch"
EXPERTS_RANGE = "horovod_tpu_torch.moe_experts"


def effective_groups(T, num_groups):
    """The group count of ``T`` tokens: the largest divisor of ``T`` at
    most ``num_groups`` (an upper bound, not a contract, as in the JAX
    layer), with one info line per ``(T, num_groups)`` when it differs and
    a warning when it lost most of the grouping at a real token count."""
    G = max(1, min(num_groups, T))
    while T % G != 0:
        G -= 1
    if G != num_groups:
        key = (T, num_groups)
        if key not in _GROUP_FALLBACKS:
            _GROUP_FALLBACKS.add(key)
            logging.getLogger("horovod_tpu_torch").info(
                "MoE grouped dispatch: T=%d not divisible by num_groups=%d; "
                "using G=%d (affects per-group capacity and routing/drop "
                "numerics)", T, num_groups, G)
    if T > 1024 and 2 * G <= num_groups:
        warnings.warn(
            f"MoE grouped dispatch: T={T} has no divisor near "
            f"num_groups={num_groups}; using G={G}. Dispatch memory scales "
            f"O(T^2/G) — pad/choose batch*seq so it divides by num_groups.",
            stacklevel=3)
    return G


def capacity(t, num_experts, capacity_factor):
    """Slots per expert and group: ``ceil(t * cf / E)`` as the JAX layer
    computes it (Python's float floor division), at least 1."""
    return max(1, int(-(-t * capacity_factor // num_experts)))


class MoE(nn.Module):
    """Top-k MoE FFN: ``[T, d_model] -> [T, d_model]``.

    Weights are drawn from ``generator`` with flax's initializers
    (``lecun_normal``, whose ``fan_in`` counts the leading expert dim as a
    receptive field: ``d * E`` for ``w_in``, ``f * E`` for ``w_out``), all
    of them, then cut to ``expert_shard = (index, size)``: experts
    ``[index * E/size, (index + 1) * E/size)`` (``moe_param_specs``).
    ``forward`` moves shards over the installed mesh's axis
    ``expert_axis`` when ``size > 1``, the tokens replicated over it, or
    sharded over it with ``tokens_sharded``; ``moe_shards`` takes axis
    objects (the transformer's blocks call it with their batch axis)."""

    def __init__(self, num_experts, d_model, d_ff, capacity_factor=2.0,
                 num_groups=1, top_k=1, dtype=torch.float32, generator=None,
                 device=None, expert_shard=(0, 1), expert_axis="expert",
                 tokens_sharded=False):
        super().__init__()
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k={top_k} must be in [1, {num_experts}]")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.num_experts, self.d_model, self.d_ff = num_experts, d_model, d_ff
        self.capacity_factor, self.num_groups = capacity_factor, num_groups
        self.top_k, self.dtype = top_k, dtype
        self.expert_axis, self.tokens_sharded = expert_axis, tokens_sharded
        E, d, f = num_experts, d_model, d_ff
        self.gate = nn.Parameter(lecun_normal_(torch.empty(d, E), d,
                                               generator))
        self.w_in = nn.Parameter(lecun_normal_(torch.empty(E, d, f), d * E,
                                               generator))
        self.w_out = nn.Parameter(lecun_normal_(torch.empty(E, f, d), f * E,
                                                generator))
        self.expert_index, self.expert_size = expert_shard
        if self.expert_size > 1:
            from horovod_tpu_torch import convert
            convert.cut_module(self, moe_param_specs(self, expert_axis),
                               {expert_axis: expert_shard})
        self.sown, self.dropped = {}, None
        if device is not None:
            self.to(device)

    @property
    def experts(self):
        """The experts this shard holds: ``range(lo, hi)`` as ``(lo, hi)``."""
        local = self.w_in.shape[0]
        return self.expert_index * local, (self.expert_index + 1) * local

    def forward(self, x):
        eaxis = axis_lib.group_axis(
            self.expert_axis if self.expert_size > 1 else None)
        return moe_shards([self], [x], eaxis, axis_lib.single_axis(),
                          tokens_sharded=self.tokens_sharded)[0]


def _route(moe, x, G, gate=None):
    """One shard's routing of ``x [T, d]`` in ``G`` groups, the JAX
    layer's arithmetic: ``(probs, logits, first-choice one-hot, [queue
    position of each choice], combine weights [K, G, t])``. ``gate``: the
    gate weight to route with (``moe.gate`` by default)."""
    E, K = moe.num_experts, moe.top_k
    T, d = x.shape
    xg = x.reshape(G, T // G, d)
    gate = moe.gate if gate is None else gate
    logits = (xg @ gate.to(x.dtype)).float()                 # [G, t, E]
    probs = torch.softmax(logits, dim=-1)
    remaining, ohs, raw_w = probs, [], []
    for _ in range(K):  # k-th choices by iterated masked argmax
        choice = remaining.argmax(dim=-1)                      # [G, t]
        oh = F.one_hot(choice, E).float()                      # [G, t, E]
        ohs.append(oh)
        raw_w.append((probs * oh).sum(dim=-1))                 # [G, t]
        remaining = remaining * (1.0 - oh)
    if K == 1:  # Switch keeps the raw gate probability
        weights = raw_w
    else:       # GShard renormalizes over the chosen experts
        denom = torch.clamp(sum(raw_w), min=1e-9)
        weights = [w / denom for w in raw_w]
    # queue positions: the k-th choices count after every earlier
    # choice's tokens (GShard's yield rule)
    base = torch.zeros((G, 1, E), device=x.device)
    queued = []
    for oh in ohs:
        queued.append((torch.cumsum(oh, dim=1) + base) * oh)   # [G, t, E]
        base = base + oh.sum(dim=1, keepdim=True)
    return probs, logits, ohs[0], queued, torch.stack(weights)


def moe_shards(moes, xs, eaxis, baxis, tokens_sharded=False):
    """The MoE layer over shards: ``moes`` each shard's layer (its
    experts ``moe.experts`` of the axis ``eaxis``), ``xs`` each shard's
    tokens ``[T_local, d]``, ``baxis`` the axis the tokens are sharded
    over besides (an axis of one where they are not). Returns each
    shard's output and writes each layer's ``sown`` terms.

    ``tokens_sharded``: the tokens are sharded over ``eaxis`` itself.
    Where the axis divides the groups, ``tokens_all_to_all`` (GShard's
    layout); otherwise ``tokens_gathered``, logged once. Otherwise the
    tokens are replicated over ``eaxis``: the groups of the global
    ``T_local * baxis.n`` tokens run on the data rank that holds them
    whole, or, where a group straddles data ranks, the tokens are
    gathered over ``baxis`` (its backward the sum over the ranks) and
    each rank keeps its rows of the output."""
    if tokens_sharded:
        G = effective_groups(xs[0].shape[0] * eaxis.n, moes[0].num_groups)
        if G % eaxis.n == 0:
            return tokens_all_to_all(moes, xs, eaxis)
        key = (G, eaxis.n)
        if key not in _A2A_FALLBACKS:
            _A2A_FALLBACKS.add(key)
            logging.getLogger("horovod_tpu_torch").info(
                "MoE all-to-all dispatch: G=%d groups do not divide over "
                "the expert axis of %d; gathering the tokens instead", G,
                eaxis.n)
        return tokens_gathered(moes, xs, eaxis)
    T_local = xs[0].shape[0]
    G = effective_groups(T_local * baxis.n, moes[0].num_groups)
    if G % baxis.n == 0:
        return _core(moes, xs, eaxis, baxis, G // baxis.n, eaxis.reduce_from)
    single = axis_lib.single_axis(len(xs))
    outs = _core(moes, baxis.all_gather(xs), eaxis, single, G,
                 eaxis.reduce_from)
    return [o.narrow(0, i * T_local, T_local)
            for o, i in zip(outs, baxis.indices)]


def tokens_gathered(moes, xs, eaxis):
    """The layer with its tokens sharded over ``eaxis``, the long way:
    every shard gathers all ``T`` tokens over the axis (``gather_to``),
    routes all ``G`` groups, runs its experts on them, and the outputs
    are reduce-scattered back (``reduce_scatter_to``): each rank moves
    ``(R - 1) / R`` of ``T d`` elements in the gather and as many in the
    reduce-scatter, and routes ``R`` times the groups it needs."""
    full = eaxis.gather_to(xs)
    G = effective_groups(full[0].shape[0], moes[0].num_groups)
    return _core(moes, full, eaxis, axis_lib.single_axis(len(xs)), G,
                 eaxis.reduce_scatter_to)


def tokens_all_to_all(moes, xs, eaxis):
    """The layer with its tokens sharded over ``eaxis`` in GShard's
    layout (the two all-to-alls that GSPMD places for the JAX layer's
    sharding constraints on ``expert_in`` and ``out_e``): each of the
    ``R`` shards routes its own ``G / R`` groups (``R`` must divide the
    effective ``G``; the groups are blocks of the global token order, so
    shard ``i`` holds groups ``[i G/R, (i+1) G/R)``), builds ``expert_in
    [G/R, E, C, d]``, sends expert block ``j`` to shard ``j``
    (``all_to_all`` split on E, concatenated on G: ``[G, E/R, C, d]``),
    runs its experts, sends group block ``j`` of their output back, and
    combines locally. Routing, capacity and the queues are per group, so
    this is the gather form's arithmetic: at top-1 every dispatch and
    combine sum has one non-zero term and the experts see the same
    ``[G, E/R, C, d]``, so the outputs and the expert weights' gradients
    are the gather form's bits; the gate's gradient sums the shards'
    partial ones (``copy_to``), and the auxiliary terms are the shards'
    local means summed over the axis (``reduce_from``: every shard's loss
    reads the global terms, and the gradient of each shard's reaches its
    own tokens, so the sum over the shards counts them once, as the gather
    form's replicated terms are counted). Each all-to-all moves ``(R - 1)
    / R`` of a ``[G/R, E, C, d]`` tensor a shard."""
    m0 = moes[0]
    E, K, R = m0.num_experts, m0.top_k, eaxis.n
    T_local, d = xs[0].shape
    G = effective_groups(T_local * R, m0.num_groups) // R
    t = T_local // G
    C = capacity(t, E, m0.capacity_factor)
    gates = eaxis.copy_to([m.gate for m in moes])
    routes = [_route(m, x, G, gate) for m, x, gate in zip(moes, xs, gates)]
    _sow_terms(moes, routes, eaxis, eaxis.reduce_from)
    with torch.no_grad():  # the share of the axis's choices dropped
        kept = eaxis.all_reduce([_kept(r[3], C) for r in routes])
    for m, k in zip(moes, kept):
        m.dropped = 1.0 - k / (T_local * R * K)
    ins, combines = [], []
    for x, (_, _, _, queued, w) in zip(xs, routes):
        with torch.profiler.record_function(DISPATCH_RANGE):
            disp, combine = _dispatch(queued, w, 0, E, C, x.dtype)
            ins.append(torch.einsum("gtec,gtd->gecd", disp,
                                    x.reshape(G, t, d)))
        combines.append(combine)
    # expert block j to shard j: [G/R, E, C, d] -> [G, E/R, C, d]
    ins = eaxis.all_to_all(ins, split_dim=1, concat_dim=0)
    outs = [_experts(m, x_in) for m, x_in in zip(moes, ins)]
    # group block j back to shard j: [G, E/R, C, d] -> [G/R, E, C, d]
    outs = eaxis.all_to_all(outs, split_dim=0, concat_dim=1)
    parts = []
    for combine, out_e in zip(combines, outs):
        with torch.profiler.record_function(DISPATCH_RANGE):
            parts.append(torch.einsum("gtec,gecd->gtd", combine,
                                      out_e).reshape(T_local, d))
    return parts


def _sow_terms(moes, routes, axis, reduce):
    """Write each layer's auxiliary terms, fp32 over every token before
    capacity: E sum_e f_e P_e (f_e the share of tokens whose first choice
    is e, P_e the mean router probability of e) and mean(logsumexp^2).
    Over an ``axis`` of more than one shard of the tokens, the global
    means are the local means summed over it (``reduce``) and divided by
    its size, so that every shard's loss reads the global terms."""
    E = moes[0].num_experts
    stats = [(first.mean(dim=(0, 1)), probs.mean(dim=(0, 1)),
              torch.mean(torch.logsumexp(logits, dim=-1) ** 2))
             for probs, logits, first, _, _ in routes]
    if axis.n > 1:
        inv = 1.0 / axis.n
        frac = axis.all_reduce([s[0] for s in stats])
        mean_prob = reduce([s[1] for s in stats])
        z = reduce([s[2] for s in stats])
        stats = [(f * inv, mp * inv, zz * inv)
                 for f, mp, zz in zip(frac, mean_prob, z)]
    for m, (frac, mean_prob, z) in zip(moes, stats):
        m.sown = {"load_balance": E * torch.sum(frac * mean_prob),
                  "router_z": z}


def _kept(queued, C):
    """How many token choices found a slot below capacity (fp32)."""
    with torch.no_grad():
        return sum(((pos > 0) & (pos <= C)).sum(dtype=torch.float32)
                   for pos in queued)


def _dispatch(queued, w, lo, hi, C, dt):
    """The dispatch and combine tensors ``[G, t, e, C]`` of the experts
    ``[lo, hi)``: each kept choice's one-hot slot, and that times its
    combine weight, summed over the choices."""
    slots = torch.arange(C, device=queued[0].device)
    disp = combine = None
    for k, pos in enumerate(queued):
        pos = pos[..., lo:hi]                                  # [G, t, e]
        keep = (pos > 0) & (pos <= C)
        d_k = ((pos - 1.0).to(torch.int32)[..., None] == slots) \
            .to(dt) * keep.to(dt)[..., None]                   # [G, t, e, C]
        c_k = d_k * w[k].to(dt)[..., None, None]
        disp = d_k if disp is None else disp + d_k
        combine = c_k if combine is None else combine + c_k
    return disp, combine


def _experts(m, expert_in):
    """The expert FFN of ``m``'s experts on ``expert_in [G, e, C, d]``."""
    dt = expert_in.dtype
    with torch.profiler.record_function(EXPERTS_RANGE):
        h = F.gelu(torch.einsum("gecd,edf->gecf", expert_in,
                                m.w_in.to(dt)), approximate="tanh")
        return torch.einsum("gecf,efd->gecd", h, m.w_out.to(dt))


def _core(moes, xs, eaxis, baxis, G, reduce):
    """Route each shard's ``xs`` in ``G`` local groups, run its experts,
    and sum the combine over the experts with ``reduce``."""
    m0 = moes[0]
    E, K = m0.num_experts, m0.top_k
    T, d = xs[0].shape
    t = T // G
    C = capacity(t, E, m0.capacity_factor)
    routes = [_route(m, x, G) for m, x in zip(moes, xs)]
    # the auxiliary terms: tokens on other data ranks read through a
    # psum, so that every rank's replicated loss and its gradient read
    # the global terms
    _sow_terms(moes, routes, baxis, baxis.psum)
    weights = eaxis.copy_to([r[4] for r in routes])
    xds = eaxis.copy_to(xs)
    parts = []
    for m, x, (_, _, _, queued, _), w in zip(moes, xds, routes, weights):
        lo, hi = m.experts
        m.dropped = 1.0 - _kept(queued, C) / (T * K)
        with torch.profiler.record_function(DISPATCH_RANGE):
            disp, combine = _dispatch(queued, w, lo, hi, C, x.dtype)
            expert_in = torch.einsum("gtec,gtd->gecd", disp,
                                     x.reshape(G, t, d))
        out_e = _experts(m, expert_in)
        with torch.profiler.record_function(DISPATCH_RANGE):
            parts.append(torch.einsum("gtec,gecd->gtd", combine,
                                      out_e).reshape(T, d))
    return reduce(parts)


def aux_loss(source, load_balance_weight=0.01, router_z_weight=1e-3):
    """The weighted sum of the auxiliary terms of ``source``: a module
    (every ``MoE`` inside it, in the order of their flax paths, as
    ``jax.tree_util`` walks the JAX ``"losses"`` collection), one
    ``sown`` dict, or a list of them. fp32 zero when nothing was sown (a
    dense model), so a caller can add it unconditionally."""
    if isinstance(source, nn.Module):
        named = [(_flax_path(name), m.sown) for name, m
                 in source.named_modules() if isinstance(m, MoE)]
        source = [sown for _, sown in sorted(named, key=lambda p: p[0])]
    elif isinstance(source, dict):
        source = [source]
    total = None
    for sown in source:
        for key in sorted(sown):
            w = (load_balance_weight if key == "load_balance"
                 else router_z_weight)
            total = w * sown[key] if total is None else total + w * sown[key]
    return torch.zeros((), dtype=torch.float32) if total is None else total


def _flax_path(name):
    """``blocks.3.moe`` -> ``block_3/moe``: the module's flax path."""
    parts = name.split(".")
    if len(parts) >= 2 and parts[0] == "blocks":
        return "/".join([f"block_{parts[1]}"] + parts[2:])
    return "/".join(parts)


def expert_major_spec(param_path, expert_axis):
    """The one copy of the expert-weight sharding rule (here and in
    ``parallel.tensor.transformer_param_specs``): the spec of an
    expert-major weight, ``(expert_axis, None, None)``, or None for
    anything else (the gate, norms, ...)."""
    if param_path.endswith("w_in") or param_path.endswith("w_out"):
        return (expert_axis, None, None)
    return None


def moe_param_specs(params, expert_axis="expert"):
    """The specs of ``MoE`` params (a flax tree, or the module), flax's
    ``PartitionSpec``s as tuples: the expert-major weights over
    ``expert_axis``, the gate replicated."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    return {name: expert_major_spec(name, expert_axis) or ()
            for name in params}


def shard_moe_params(params, index, size, expert_axis="expert"):
    """Shard ``index`` of ``size`` of a flax ``MoE`` tree (numpy arrays)
    by ``moe_param_specs``: what ``convert.params_from_flax`` loads into
    ``MoE(expert_shard=(index, size))``."""
    from horovod_tpu_torch import convert
    return convert.shard_flax(params, moe_param_specs(params, expert_axis),
                              {expert_axis: (index, size)})
