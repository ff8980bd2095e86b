"""Continuous-batching inference engine: the port of
``horovod_tpu/serve/engine.py``.

Two static-shaped programs — **prefill** (one chunk of one sequence's
prompt) and **decode** (one new token for every running sequence) —
driven by an iteration-level scheduler (Orca's continuous batching):
requests join and leave the running decode batch **between** program
dispatches, never inside one.

One scheduler iteration (:meth:`ServeEngine.step`):

1. **weight swap** — staged params (``serve/loader.py``'s
   ``ReloadWatcher``) replace the live ones; in-flight sequences keep
   their KV and continue under the new weights.
2. **admission** — FIFO from the waiting queue into free batch slots,
   all-or-nothing reserving ``ceil((prompt + max_new) / block_size)``
   KV blocks, so a running sequence can never die of pool exhaustion; a
   queue head that cannot get its reservation waits (KV backpressure).
3. **prefill** — ONE chunk of the longest-waiting prefilling request, so
   a huge prompt cannot starve the decode batch.
4. **decode** — one token for every sequence in the decode state, in one
   batched dispatch; finished sequences (``max_new_tokens`` / EOS) are
   retired and their blocks return to the pool.

The programs are plain functions on tensors (:func:`decode_program`,
:func:`prefill_program`, and the copy-on-write fork
``kvcache.copy_block``), run eagerly on the engine's one device. Their
shapes stay static — all ``max_slots`` rows every decode, one
``prefill_chunk`` a prefill — so a row's arithmetic does not depend on
what else is in the batch. The pool is one tensor pair on the device,
written in place. The model runs with the engine's parameters through
``torch.func.functional_call``, so one module serves any number of
engines and weight versions, as one flax module serves the JAX
package's.

Each process holds one device. Over a mesh of more than one rank (one
process a card, ``hvdrun-torch -np N``) every rank runs the same engine
on a replicated pool, and the decode slots are split over the data
ranks as the JAX engine's ``batch_spec`` splits them (``max_slots``
divided by the data axes' size; an indivisible count runs every row on
every rank, logged once): each rank decodes its rows, and one
all-gather over the data axes hands every rank every slot's next token
and new K/V rows, which it writes into its own pool, as the JAX decode
program's replicated outputs do. Prefill and the copy-on-write fork run
replicated. The scheduler's decisions stay equal on every rank because
they are taken from one stream of inputs: requests enter on rank 0,
and at the head of each iteration rank 0 broadcasts what arrived since
the last one (with its arrival stamps), its draining flag, a staged
weight swap and its stop; the other ranks follow (``follow()``). The
stop goes out from the thread that drives rank 0's iterations, after
its last one, and also when a dispatch breaks the engine, so the
followers never wait on a rank that has ended.
Several cards may also serve as a fleet (``serve/fleet/``), one engine
a card.

Sampling defaults to greedy (argmax) — deterministic, which is what
makes "continuous-batched decode equals a single-shot decode" a testable
contract. Real sampling (``serve/sampling.py``) rides the same decode
dispatch: per-slot seed/temperature/top-p tensors, per-slot keys folded
from ``(seed, absolute token index)``; a slot at temperature 0 takes the
bitwise argmax lane, and a batch with no sampled slot skips the draws.

Prefix caching (``kvcache.PrefixCache``) short-circuits prefill:
admission maps a prompt's already-cached full blocks into the
sequence's block table (ref-counted shares; the one partially reused
block is forked copy-on-write) and prefill resumes at the first
uncached token.

A request may **replay** (``Request(replay=k)``): the last ``k`` tokens
of its prompt were generated by a decode of this same request on an
engine that is gone (a fleet re-dispatch). The engine prefills the rest
of the prompt and feeds the ``k`` tokens through decode iterations,
emitting nothing, so their K/V are computed as the first engine
computed them and the stream goes on as it would have there (bit for
bit where the prompt's prefill chunks fell alike), in bf16 as in fp32,
where a prefill of the same tokens (other shapes, another reduction
order) could round the logits apart.
"""

import collections
import itertools
import logging
import queue
import threading
import time
from collections import deque

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch.parallel import mesh as mesh_lib
from horovod_tpu_torch.serve import kvcache
from horovod_tpu_torch.serve import sampling as sampling_lib
from horovod_tpu_torch.telemetry import instruments as instruments_lib

logger = logging.getLogger("horovod_tpu_torch")


class RequestError(RuntimeError):
    """A generate request failed (invalid, or the engine stopped)."""


class Request:
    """One generate request and its token stream.

    The engine appends events to a thread-safe queue as it produces
    them; :meth:`stream` yields token ids until the terminal
    ``done``/``error`` event. Timing fields (``arrival``,
    ``first_token_time``, ``token_times``) are stamped with the ENGINE's
    clock. ``replay`` (module docstring): the last ``replay`` prompt
    tokens are fed through decode, not prefilled."""

    _ids = itertools.count()

    def __init__(self, tokens, max_new_tokens, eos_id=None,
                 request_id=None, sampling=None, trace=False, replay=0):
        self.id = (next(self._ids) if request_id is None
                   else request_id)
        self.prompt = [int(t) for t in tokens]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.sampling = (sampling_lib.GREEDY if sampling is None
                         else sampling)
        self.replay = int(replay)
        self.generated = []
        self.state = "new"  # new|queued|prefill|decode|done|failed
        self.finish_reason = None
        self.error = None
        self.slot = None
        self.blocks = None
        self.prefilled = 0  # prompt tokens whose KV is in the pool
        self.cached_prompt_tokens = 0  # of those, served by prefix cache
        self.arrival = None
        self.admitted_at = None  # KV reservation granted (TTFT base 2)
        self.first_token_time = None
        self.token_times = []
        # request-scoped tracing (serve/tracing.py): ``trace_requested``
        # is the per-request force flag; ``trace`` the attached
        # RequestTrace (the router pre-attaches one for fleet requests).
        # The engine finishes only traces it began itself (_trace_owned).
        self.trace_requested = bool(trace)
        self.trace = None
        self._trace_owned = False
        self._trace_live = False  # counted in the engine's live total
        self._replay_at = None  # next prompt index a decode feeds
        self._events = queue.Queue()

    @property
    def prefill_len(self):
        """Prompt tokens the prefill program computes (the rest replay
        through decode)."""
        return len(self.prompt) - self.replay

    def _emit(self, kind, value=None):
        self._events.put((kind, value))

    def stream(self, timeout=120.0):
        """Yield generated token ids as they arrive. Raises
        :class:`RequestError` when the request failed, ``TimeoutError``
        when the engine goes silent for ``timeout`` seconds."""
        while True:
            try:
                kind, value = self._events.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    f"request {self.id}: no event for {timeout:.0f}s "
                    f"(state {self.state})") from None
            if kind == "token":
                yield value
            elif kind == "done":
                return
            else:
                raise RequestError(value)

    def result(self, timeout=120.0):
        """Drain the stream; returns the full generated token list."""
        return list(self.stream(timeout=timeout))


# -- the programs -------------------------------------------------------------

def _forward(model, params, tokens, positions, pool, tables, ctx_positions):
    """The model's incremental decode step with ``params``, its context
    gathered from the pool layer by layer as the block loop reaches it."""
    cache = (kvcache.LayerContext(pool["k"], tables),
             kvcache.LayerContext(pool["v"], tables), ctx_positions)
    return torch.func.functional_call(
        model, params, (tokens,),
        {"positions": positions, "kv_cache": cache})


def _select(logits, sampling, indices):
    """``[B, V]`` -> ``[B]`` int32 tokens: argmax, or ``sampling``'s
    ``(seeds, temps, top_ps)`` lanes at the absolute ``indices``."""
    if sampling is None:
        return sampling_lib.greedy_tokens(logits)
    seeds, temps, top_ps = sampling
    return sampling_lib.sample_tokens(logits, seeds, indices, temps, top_ps)


def decode_rows(model, params, pool, tokens, lengths, tables, sampling,
                max_context):
    """The decode program's work on some rows, without the pool write:
    ``tokens`` ``[b]`` the last tokens at positions ``lengths`` ``[b]``,
    ``tables`` ``[b, max_blocks_per_seq]``. Returns ``(next tokens [b],
    new K [L, b, 1, H, D], new V)``; a row's results do not depend on the
    other rows, so a rank of a mesh runs its own rows only."""
    logits, (nk, nv) = _forward(
        model, params, tokens[:, None], lengths[:, None], pool, tables,
        kvcache.context_positions(lengths, max_context))
    # the token being sampled sits at absolute index len+1 (the fed
    # token occupies len) — the index the per-slot RNG key is folded from
    return _select(logits[:, -1, :], sampling, lengths + 1), nk, nv


def decode_program(model, params, pool, tokens, lengths, tables, sampling,
                   max_context):
    """One new token for every slot: ``tokens`` ``[B]`` the last tokens at
    positions ``lengths`` ``[B]`` (0: an inactive slot, whose write goes to
    the null block and whose token the host ignores), ``tables`` ``[B,
    max_blocks_per_seq]``. Writes the fed tokens' K/V into the pool and
    returns the ``[B]`` next tokens (``sampling`` None: all greedy)."""
    nxt, nk, nv = decode_rows(model, params, pool, tokens, lengths, tables,
                              sampling, max_context)
    kvcache.write_tokens(pool, tables, lengths, nk, nv,
                         mask=(lengths > 0)[:, None])
    return nxt


def prefill_program(model, params, pool, tokens, start, total, table,
                    sampling, max_context):
    """One chunk of one sequence: ``tokens`` ``[1, C]`` (pad past the
    prompt) at absolute positions ``start..start+C-1`` (host ints
    ``start`` and ``total``, the prompt tokens to prefill); the context is
    the sequence's own already-prefilled tokens. Writes the chunk's K/V
    and, on the chunk that holds the last prompt token, returns its
    sampled successor (absolute index ``total``) as a ``[1]`` tensor;
    None on the other chunks."""
    c = tokens.shape[1]
    dev = tokens.device
    positions = (start + torch.arange(c, dtype=torch.int32,
                                      device=dev))[None, :]
    start_t = torch.tensor([start], dtype=torch.int32, device=dev)
    logits, (nk, nv) = _forward(
        model, params, tokens, positions, pool, table,
        kvcache.context_positions(start_t, max_context))
    kvcache.write_tokens(pool, table, start_t, nk, nv,
                         mask=positions < total)
    if start + c < total:
        return None
    last = min(max(total - 1 - start, 0), c - 1)
    index = torch.tensor([total], dtype=torch.int32, device=dev)
    return _select(logits[0, last][None], sampling, index)


def engine_mesh(mesh=None, device=None):
    """The mesh an engine runs over: ``mesh``, else, unless a ``device``
    is given without one, the installed one after ``init()``; None
    without either."""
    if mesh is None and device is None:
        try:
            mesh = mesh_lib.get_mesh()
        except RuntimeError:
            mesh = None
    return mesh


def engine_device(mesh=None, device=None):
    """The device an engine computes on: ``device``, else the mesh's
    (``engine_mesh``), else the current CUDA device. No card and no
    device raises: nothing falls back to the CPU unasked."""
    mesh = engine_mesh(mesh, device)
    if device is not None:
        return torch.device(device)
    if mesh is not None:
        return torch.device(mesh.device)
    if not torch.cuda.is_available():
        raise RuntimeError("serve: no CUDA device; pass device='cpu' to "
                           "serve on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def decode_layout(mesh, max_slots):
    """``(rows, world, sharded)`` of this rank's decode rows over
    ``mesh`` (None: one rank): the data axes split the ``max_slots``
    rows into ``world`` equal blocks, block ``i`` to the rank whose
    row-major index over them is ``i``, as the JAX engine's
    ``batch_spec``; an indivisible count leaves every row on every rank
    (``sharded`` False)."""
    if mesh is None or mesh.size == 1:
        return slice(0, max_slots), 1, False
    _, ranks = mesh.group_of(None)  # the data axes, row-major
    world, index = len(ranks), ranks.index(mesh.rank)
    if max_slots % world:
        return slice(0, max_slots), world, False
    b = max_slots // world
    return slice(index * b, (index + 1) * b), world, True


class ServeEngine:
    """Continuous-batching scheduler over one model + paged KV pool.

    ``model`` is the port's ``Transformer`` (its own weights are not
    used), ``params`` its parameters by name (a ``state_dict``, as
    ``serve.loader.load_params`` or ``convert.params_from_flax`` give
    them), placed on the engine's device (:func:`engine_device`).
    ``max_slots`` is the decode batch width (static — inactive slots are
    masked); ``prefill_chunk`` the per-iteration prompt chunk.
    ``clock`` is injectable for deterministic scheduler tests. Drive it
    either with :meth:`start`/:meth:`stop` (background thread — the HTTP
    frontend's mode) or by calling :meth:`step` yourself.

    ``mesh`` (None: the installed one after ``init()``, unless a
    ``device`` is given without it) of more than one rank makes this a
    rank of one engine over the mesh (module docstring): rank 0 takes
    the requests and drives it; every other rank calls :meth:`follow`,
    which returns when rank 0's engine stops."""

    def __init__(self, model, params, kv_config, mesh=None, max_slots=4,
                 prefill_chunk=16, clock=time.monotonic, registry=None,
                 weights_version=None, prefix_caching=True,
                 name="default", tracer=None, device=None):
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        mesh = engine_mesh(mesh, device)
        self.device = engine_device(mesh, device)
        self._mesh = mesh if mesh is not None and mesh.size > 1 else None
        self._rows, world, self._sharded = decode_layout(self._mesh,
                                                         int(max_slots))
        if self._mesh is not None and not self._sharded:
            # an indivisible slot count replicates the decode batch —
            # correct everywhere, parallel nowhere; say so once
            logger.info(
                "serve: max_slots=%d does not divide the %d-way data "
                "mesh — decode batch replicated (pick a multiple for "
                "batch sharding)", int(max_slots), world)
        self.leader = self._mesh is None or self._mesh.rank == 0
        # rank 0's requests since the last iteration's broadcast
        self._inbox = []
        self._on_request = None
        self._stop_sent = False
        # host seconds of the decode steps' token and K/V exchange (over
        # gloo the copies through the host and the wait for the other
        # ranks; over NCCL only the issue, the collective being async)
        self.exchange_seconds = 0.0
        self._model = model
        self._kv = kv_config
        self._clock = clock
        self.name = str(name)
        self.max_slots = int(max_slots)
        self.prefill_chunk = int(prefill_chunk)

        self.instruments = instruments_lib.serve_instruments(
            registry, replica=self.name)
        self.allocator = kvcache.BlockAllocator(kv_config.num_blocks)
        self.prefix_cache = (
            kvcache.PrefixCache(self.allocator, kv_config.block_size)
            if prefix_caching else None)
        # cumulative cached-prefill accounting (the cached-prefill
        # fraction = cached / prompt tokens)
        self.prompt_tokens = 0
        self.cached_prefill_tokens = 0
        # programs run, by name (prefill / decode / fork)
        self.dispatches = collections.Counter()
        # per-slot scheduler state (host): block table rows, cached-token
        # counts, last sampled token, sampling knobs — the mirror of
        # what the device programs consume each iteration
        self._tables = np.zeros(
            (self.max_slots, kv_config.max_blocks_per_seq), np.int32)
        self._lengths = np.zeros((self.max_slots,), np.int32)
        self._last_token = np.zeros((self.max_slots,), np.int32)
        self._seeds = np.zeros((self.max_slots,), np.int64)  # uint32s
        self._temps = np.zeros((self.max_slots,), np.float32)
        self._top_ps = np.ones((self.max_slots,), np.float32)
        self._slots = [None] * self.max_slots
        self._waiting = deque()
        self.draining = False  # refusing admission (drain / staging)

        # request tracing (serve/tracing.py). _live_traces is the hot-
        # path gate: with no traced request in flight the per-iteration
        # cost of tracing is one int comparison, and with tracer=None
        # (the default) no request ever records. Tracing is pure host
        # bookkeeping: the programs launch the same operations either way
        self._tracer = tracer
        self._live_traces = 0

        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self._staged = None  # (placed params, version) awaiting swap
        self.weights_version = weights_version
        self._stop = threading.Event()
        self._thread = None
        self._broken = None  # fatal engine error (pool state unknown)

        # run-level time attribution (every second of a serving run
        # lands in exactly one phase)
        self.time_breakdown = {"prefill": 0.0, "decode": 0.0,
                               "overhead": 0.0, "idle": 0.0}
        self._idle_since = None  # run-loop wait in progress since

        self._params = self._place(params)
        self._pool = kvcache.init_pool(kv_config, self.device)

    def _place(self, params):
        """``params`` on the device: a torch ``state_dict``, or the flax
        tree of the JAX package's layout (``serve.loader.load_params``'s)
        carried across by ``convert.params_from_flax``."""
        if any(isinstance(v, dict) for v in params.values()):
            from horovod_tpu_torch import convert
            params = convert.params_from_flax(params, self._model)
        return {name: torch.as_tensor(p).detach().to(self.device)
                for name, p in params.items()}

    def _to_device(self, x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _sync(self):
        # a non-final prefill chunk returns nothing to the host: wait for
        # it here, so its device time is charged to prefill, not to the
        # next dispatch that reads a result
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sampling(self, rows, active):
        """The ``(seeds, temps, top_ps)`` tensors of ``rows`` when one of
        the ``active`` slots samples, else None (every lane greedy: no
        draws)."""
        if not (self._temps[active] > 0).any():
            return None
        return tuple(self._to_device(a[rows]) for a in
                     (self._seeds, self._temps, self._top_ps))

    # -- request intake ------------------------------------------------------
    def submit(self, request):
        """Queue a request; returns it. Invalid requests (empty prompt,
        or a reservation no pool state could ever satisfy) fail
        immediately — loudly to the caller AND on the request's own
        stream."""
        kv = self._kv
        if not self.leader:
            raise RequestError("requests enter a serve engine over a mesh "
                               "on rank 0; this rank follows it")
        with self._work:
            request.arrival = self._clock()
            err = None
            if self._stop.is_set() or self._broken is not None:
                err = "serve engine is stopped"
            elif self.draining:
                err = "serve engine is draining"
            elif not request.prompt:
                err = "empty prompt"
            elif request.max_new_tokens < 1:
                err = "max_new_tokens must be >= 1"
            elif not 0 <= request.replay < len(request.prompt):
                err = (f"replay of {request.replay} tokens needs a longer "
                       f"prompt than {len(request.prompt)}")
            else:
                need = kv.blocks_for(len(request.prompt)
                                     + request.max_new_tokens)
                if (need > kv.max_blocks_per_seq
                        or need > self.allocator.capacity):
                    err = (f"request needs {need} KV blocks "
                           f"({len(request.prompt)} prompt + "
                           f"{request.max_new_tokens} new tokens), the "
                           f"pool allows min(max_blocks_per_seq="
                           f"{kv.max_blocks_per_seq}, capacity="
                           f"{self.allocator.capacity})")
            if err is not None:
                self._fail(request, err)
                raise RequestError(err)
            request.state = "queued"
            tr = request.trace  # router-attached (fleet requests)
            if tr is None and self._tracer is not None:
                tr = self._tracer.begin(request.id,
                                        force=request.trace_requested)
                if tr is not None:
                    request.trace = tr
                    request._trace_owned = True
            if tr is not None:
                request._trace_live = True
                self._live_traces += 1
                tr.phase(request.arrival, "queued")
                tr.event("submit", request.arrival, actor=self.name)
            # over a mesh a request joins the queue at the next
            # iteration's head, on every rank at once
            (self._inbox if self._mesh is not None
             else self._waiting).append(request)
            self.instruments.submitted.inc()
            self.instruments.queue_depth.set(self.queue_depth)
            self._work.notify_all()
        return request

    def generate(self, tokens, max_new_tokens, eos_id=None,
                 sampling=None):
        """Convenience: build + submit, returns the :class:`Request`."""
        return self.submit(Request(tokens, max_new_tokens, eos_id=eos_id,
                                   sampling=sampling))

    @property
    def kv_config(self):
        return self._kv

    def blocks_needed(self, prompt_len, max_new_tokens):
        """KV blocks a request of this shape reserves at admission —
        the router's headroom arithmetic (serve/fleet/router.py)."""
        return self._kv.blocks_for(int(prompt_len) + int(max_new_tokens))

    def set_draining(self, flag):
        """Enter/leave the draining state: a draining engine refuses
        NEW admissions (submit fails loudly, queued requests stay
        queued) while in-flight sequences run to completion — the
        preempt-drain and weight-staging window ``/healthz`` reports
        as 503 ``draining``."""
        with self._work:
            changed = self.draining != bool(flag)
            self.draining = bool(flag)
            if changed and self._live_traces:
                now = self._clock()
                for r in list(self._slots) + list(self._waiting):
                    if r is not None and r.trace is not None:
                        r.trace.event("drain", now, actor=self.name,
                                      on=self.draining)
            self._work.notify_all()

    # -- rolling weight reload ----------------------------------------------
    def install_weights(self, params, version=None):
        """Stage new parameters; the swap happens at the top of the next
        scheduler iteration — never inside a dispatch — so in-flight
        requests see a clean cut: tokens up to the swap from the old
        weights, tokens after it from the new, KV cache carried over."""
        placed = self._place(params)
        with self._work:
            self._staged = (placed, version)
            self._work.notify_all()

    def _apply_staged_weights(self):
        if self._staged is not None:
            self._params, self.weights_version = self._staged
            self._staged = None
            logger.info("serve: weights swapped in (version %s), "
                        "%d request(s) in flight",
                        self.weights_version, self.active_count)
            return True
        return False

    # -- scheduler -----------------------------------------------------------
    def step(self):
        """One scheduler iteration; returns a stats dict (empty/falsy
        when there was nothing to do)."""
        if self._broken is not None:
            raise RuntimeError(
                "serve engine is broken (a dispatch failed mid-write of "
                "the pool)") from self._broken
        t0 = self._clock()
        stats = {}
        compute_s = 0.0
        try:
            # admission is inside the failure boundary: the CoW fork it
            # may dispatch writes the pool like the two programs below
            with self._lock:
                if self._mesh is not None and not self._sync_iteration():
                    return {"stopped": True}
                swapped = False
                if self._staged is not None:
                    t_sw = self._clock()
                    swapped = self._apply_staged_weights()
                    t_sw_end = self._clock()
                    self.instruments.weight_swap_seconds.observe(
                        t_sw_end - t_sw)
                    if self._live_traces:
                        for r in self._slots:
                            if r is not None and r.trace is not None:
                                r.trace.span(
                                    "weight_swap", t_sw, t_sw_end,
                                    actor=self.name,
                                    version=self.weights_version)
                admitted = self._admit()
                prefill_req = min(
                    (r for r in self._slots
                     if r is not None and r.state == "prefill"),
                    key=lambda r: (r.arrival, r.id), default=None)
                decoding = [i for i, r in enumerate(self._slots)
                            if r is not None and r.state == "decode"]
            if swapped:
                stats["swapped"] = True
            if admitted:
                stats["admitted"] = len(admitted)
            if prefill_req is not None:
                t = self._clock()
                self._prefill_step(prefill_req)
                dt = self._clock() - t
                self.time_breakdown["prefill"] += dt
                compute_s += dt
                stats["prefilled"] = prefill_req.id
            if decoding:
                t = self._clock()
                self._decode_step(decoding)
                dt = self._clock() - t
                self.time_breakdown["decode"] += dt
                compute_s += dt
                stats["decoded"] = len(decoding)
        except Exception as e:
            # the pool may hold a half-written dispatch — the engine
            # cannot continue; fail every live request so clients unblock
            self._broken = e
            with self._lock:
                for r in list(self._slots) + list(self._waiting):
                    if r is not None and r.state not in ("done", "failed"):
                        self._fail(r, f"engine dispatch failed: {e}")
                self._waiting.clear()
            # over a mesh, end the other ranks' follow() with this one
            self._send_stop()
            raise
        # whatever the iteration spent outside the two dispatches
        # (admission, bookkeeping, streaming) is scheduler overhead —
        # every second of a serving run lands in exactly one phase
        self.time_breakdown["overhead"] += max(
            0.0, self._clock() - t0 - compute_s)
        return stats

    # -- the ranks of an engine over a mesh -----------------------------------
    def _bcast(self, obj):
        """``obj`` of rank 0 on every rank of the mesh."""
        box = [obj]
        dist.broadcast_object_list(
            box, src=0, group=self._mesh.group,
            device=self.device if dist.get_backend(self._mesh.group)
            == "nccl" else None)
        return box[0]

    def _sync_iteration(self):
        """The head of an iteration over a mesh (under the lock): rank 0
        moves its inbox into the queue and broadcasts what every rank's
        scheduler reads from outside (the new requests with their
        arrival stamps, the draining flag, a staged weight swap, the
        stop); the others take them. Returns False at the stop."""
        if self.leader:
            msg = {"new": [_request_spec(r) for r in self._inbox],
                   "draining": self.draining, "stop": False,
                   "swap": self._staged is not None,
                   "version": (self._staged[1] if self._staged is not None
                               else None)}
            self._waiting.extend(self._inbox)
            self._inbox = []
            self._bcast(msg)
        else:
            msg = self._bcast(None)
            if msg["stop"]:
                return False
            for spec in msg["new"]:
                req = _request_from_spec(spec)
                self._waiting.append(req)
                self.instruments.submitted.inc()
                if self._on_request is not None:
                    self._on_request(req)
            self.draining = msg["draining"]
        if msg["swap"]:
            # rank 0's staged parameters, tensor by tensor in name order
            params = (self._staged[0] if self.leader else
                      {k: torch.empty_like(v)
                       for k, v in self._params.items()})
            for name in sorted(params):
                self._bcast_tensor(params[name])
            self._staged = (params, msg["version"])
        return True

    def _bcast_tensor(self, t):
        group = self._mesh.group
        if t.is_cuda and dist.get_backend(group) != "nccl":
            host = t.cpu()
            dist.broadcast(host, src=0, group=group)
            t.copy_(host)
        else:
            dist.broadcast(t, src=0, group=group)

    def _send_stop(self):
        if self._mesh is None or not self.leader or self._stop_sent:
            return
        self._stop_sent = True
        self._bcast({"stop": True})

    def _gather_rows(self, nxt, nk, nv):
        """Every rank's decode rows on every rank: the next tokens and the
        new K/V rows, packed as bytes into one ``[b, n]`` buffer a row
        and all-gathered over the data axes (through the host where the
        group is gloo and the tensors are on a card: gloo all-gathers
        host memory only)."""
        dtype = self._pool["k"].dtype
        b = nxt.shape[0]
        parts = [nxt.to(torch.int32).reshape(b, 1),
                 nk.to(dtype).transpose(0, 1).reshape(b, -1),
                 nv.to(dtype).transpose(0, 1).reshape(b, -1)]
        widths = [p.shape[1] * p.element_size() for p in parts]
        buf = torch.cat([p.contiguous().view(torch.uint8) for p in parts],
                        dim=1)
        group, ranks = self._mesh.group_of(None)  # the data axes
        host = buf.is_cuda and dist.get_backend(group) != "nccl"
        if host:
            # the copy to the host waits for this rank's decode anyway:
            # wait first, so the clock times the exchange alone (and the
            # wait for the other ranks inside it)
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        if host:
            buf = buf.cpu()
        out = buf.new_empty((len(ranks) * b, buf.shape[1]))
        dist.all_gather_into_tensor(out, buf, group=group)
        if host:
            out = out.to(self.device)
        self.exchange_seconds += time.perf_counter() - t0
        cols = torch.split(out, widths, dim=1)
        L, shape = nk.shape[0], nk.shape[2:]
        full = out.shape[0]

        def kv(c):
            return c.contiguous().view(dtype).reshape(
                (full, L) + tuple(shape)).transpose(0, 1)

        return (cols[0].contiguous().view(torch.int32).reshape(full),
                kv(cols[1]), kv(cols[2]))

    def follow(self, on_request=None):
        """A rank other than 0 of an engine over a mesh: run the
        iterations rank 0 leads, until it stops; then fail what is left,
        as :meth:`stop` does. ``on_request`` is called with each request
        as it reaches this rank (its stream is rank 0's)."""
        if self.leader:
            raise RuntimeError("rank 0 leads the engine; follow() is the "
                               "other ranks'")
        self._on_request = on_request
        while not self.step().get("stopped"):
            pass
        self._stop.set()
        self._fail_all("serve engine stopped")

    def note_idle(self, seconds):
        """Attribute wait-for-work time (the run loop's, or a load generator's
        sleeps) to the idle phase."""
        self.time_breakdown["idle"] += max(0.0, float(seconds))

    def _admit(self):
        admitted = []
        while self._waiting and not self.draining:
            req = self._waiting[0]
            free = next((i for i, r in enumerate(self._slots)
                         if r is None), None)
            if free is None:
                break
            total = self._kv.blocks_for(len(req.prompt)
                                        + req.max_new_tokens)
            # prefix-cache lookup: map already-cached full prompt
            # blocks into this sequence's table instead of allocating
            # + re-prefilling them (a replayed tail is never matched:
            # its K/V come from decode iterations)
            cached_len, shared = 0, []
            if self.prefix_cache is not None:
                cached_len, shared = self.prefix_cache.match(
                    req.prompt[:req.prefill_len])
                # the final prompt token always prefills: its logits
                # produce the first generated token
                cached_len = min(cached_len, req.prefill_len - 1)
                # pin the match BEFORE any release(): an LRU eviction
                # under pressure may drop a matched entry whose sole
                # holder is the cache — unpinned, its block returns to
                # the free list and the retry alloc can hand it back
                # as a fresh WRITABLE block
                self.allocator.retain(shared)
            # a shared block the sequence will WRITE INTO (the trailing
            # block when the match is cut mid-block) must be forked —
            # copy-on-write
            cow = bool(shared) and \
                cached_len < len(shared) * self._kv.block_size
            n_fresh = total - len(shared) + (1 if cow else 0)
            blocks = self.allocator.alloc(n_fresh)
            if blocks is None and self.prefix_cache is not None:
                # cache-held blocks are reclaimable memory: drop LRU
                # entries until the reservation fits (live sequences'
                # refs — and the pin above — keep their blocks safe)
                dropped = self.prefix_cache.release(n_fresh)
                blocks = self.allocator.alloc(n_fresh)
                if dropped and req.trace is not None:
                    req.trace.event("cache_evict", self._clock(),
                                    actor=self.name, entries=dropped)
            if blocks is None:
                if shared:
                    self.allocator.free(shared)  # drop the pin
                if req.trace is not None:
                    req.trace.phase(self._clock(), "kv_wait")
                break  # FIFO head backpressured on KV blocks
            if cow:
                fork = blocks[0]
                kvcache.copy_block(self._pool, shared[-1], fork)
                self.dispatches["fork"] += 1
                self.allocator.free([shared[-1]])  # seq's ref only
                seq_blocks = shared[:-1] + [fork] + blocks[1:]
            else:
                seq_blocks = shared + blocks
            self._waiting.popleft()
            req.slot, req.blocks = free, seq_blocks
            req.state = "prefill"
            req.prefilled = cached_len
            req.cached_prompt_tokens = cached_len
            now = self._clock()
            req.admitted_at = now
            if req.trace is not None:
                req.trace.phase(now, "prefilling")
                req.trace.event("admitted", now, actor=self.name,
                                cached_tokens=cached_len,
                                blocks=len(seq_blocks), cow=cow)
            self._slots[free] = req
            row = np.zeros((self._kv.max_blocks_per_seq,), np.int32)
            row[:len(seq_blocks)] = seq_blocks
            self._tables[free] = row
            self._lengths[free] = cached_len
            self._last_token[free] = 0
            sp = req.sampling
            self._seeds[free] = int(sp.seed) & 0xFFFFFFFF
            self._temps[free] = np.float32(sp.temperature)
            self._top_ps[free] = np.float32(sp.top_p)
            self.prompt_tokens += len(req.prompt)
            if cached_len:
                self.cached_prefill_tokens += cached_len
                self.instruments.cached_prefill_tokens.inc(cached_len)
            admitted.append(req)
        self.instruments.queue_depth.set(self.queue_depth)
        self.instruments.kv_blocks.set(self.allocator.in_use)
        return admitted

    def _prefill_step(self, req):
        start = req.prefilled
        c = self.prefill_chunk
        total = req.prefill_len
        chunk = req.prompt[start:min(start + c, total)]
        tokens = np.zeros((1, c), np.int32)
        tokens[0, :len(chunk)] = chunk
        slot = req.slot
        tr = req.trace
        t0 = self._clock() if tr is not None else 0.0
        with torch.no_grad():
            nxt = prefill_program(
                self._model, self._params, self._pool,
                self._to_device(tokens), start, total,
                self._to_device(self._tables[slot:slot + 1]),
                self._sampling([slot], [slot]), self._kv.max_context)
        self.dispatches["prefill"] += 1
        req.prefilled = min(start + c, total)
        self._lengths[slot] = req.prefilled
        final = nxt is not None
        # final chunk: the last prompt token's logits yield the first
        # generated token — TTFT stops here
        tok = int(nxt.cpu()[0]) if final else None
        if not final:
            self._sync()
        if tr is not None:
            # recorded here, BEFORE _append_token can retire the
            # request and finish the trace — else the final compute
            # span would be lost
            tr.span("prefill", t0, self._clock(), actor=self.name,
                    chunk=[start, req.prefilled])
        if final:
            req.state = "decode"
            if self.prefix_cache is not None:
                # every full prompt block is now immutable pool
                # content — index it for later prompts
                n_full = total // self._kv.block_size
                if n_full:
                    with self._lock:
                        self.prefix_cache.insert(
                            req.prompt[:total],
                            [int(b) for b in self._tables[slot][:n_full]])
            now = self._clock()
            if tr is not None:
                tr.phase(now, "decoding")
            if req.replay:
                # the successor is the first replayed token, already
                # streamed by the engine that generated it
                self._last_token[slot] = req.prompt[total]
                req._replay_at = total + 1
            else:
                req._replay_at = len(req.prompt)
                self._last_token[slot] = tok
                self._append_token(req, tok, now)

    def _decode_step(self, decoding):
        active = np.zeros((self.max_slots,), bool)
        active[decoding] = True
        lengths = np.where(active, self._lengths, 0).astype(np.int32)
        traced = self._live_traces > 0  # the one hot-path check
        t0 = self._clock() if traced else 0.0
        with torch.no_grad():
            # this rank's rows (every row, unless sharded), then, sharded,
            # every rank's, written into the pool, replicated on every rank
            rows = self._rows
            lengths_d = self._to_device(lengths)
            tables_d = self._to_device(self._tables)
            nxt, nk, nv = decode_rows(
                self._model, self._params, self._pool,
                self._to_device(self._last_token[rows]),
                lengths_d[rows], tables_d[rows],
                self._sampling(rows, decoding), self._kv.max_context)
            if self._sharded:
                nxt, nk, nv = self._gather_rows(nxt, nk, nv)
            kvcache.write_tokens(self._pool, tables_d, lengths_d, nk, nv,
                                 mask=(lengths_d > 0)[:, None])
        self.dispatches["decode"] += 1
        nxt = nxt.cpu().numpy()
        now = self._clock()
        if traced:
            # before the append loop — _append_token may retire a
            # request and finish its trace
            for i in decoding:
                tr = self._slots[i].trace
                if tr is not None:
                    tr.span("decode", t0, now, actor=self.name,
                            batch=len(decoding))
        for i in decoding:
            req = self._slots[i]
            self._lengths[i] += 1  # the fed token's KV is now cached
            if req._replay_at < len(req.prompt):
                # replay: feed the next generated-elsewhere token
                self._last_token[i] = req.prompt[req._replay_at]
                req._replay_at += 1
                continue
            tok = int(nxt[i])
            self._last_token[i] = tok
            self._append_token(req, tok, now)

    def _append_token(self, req, tok, now):
        req.generated.append(tok)
        req.token_times.append(now)
        if req.first_token_time is None:
            req.first_token_time = now
            self.instruments.ttft_seconds.observe(now - req.arrival)
            if req.admitted_at is not None:
                # second TTFT base: admission -> first token isolates
                # prefill; the arrival-based histogram folds queue wait in
                self.instruments.ttft_admission_seconds.observe(
                    now - req.admitted_at)
        else:
            self.instruments.inter_token_seconds.observe(
                now - req.token_times[-2])
        self.instruments.tokens.inc()
        req._emit("token", tok)
        if req.eos_id is not None and tok == req.eos_id:
            self._retire(req, "eos")
        elif len(req.generated) >= req.max_new_tokens:
            self._retire(req, "length")

    def _retire(self, req, reason):
        with self._work:
            self.allocator.free(req.blocks)
            self._slots[req.slot] = None
            self._tables[req.slot] = 0
            self._lengths[req.slot] = 0
            self._last_token[req.slot] = 0
            self._seeds[req.slot] = 0
            self._temps[req.slot] = 0.0
            self._top_ps[req.slot] = 1.0
            req.blocks = None
            req.state = "done"
            req.finish_reason = reason
            self.instruments.completed.inc()
            self.instruments.kv_blocks.set(self.allocator.in_use)
            req._emit("done")
            self._finish_trace(req, "done", reason=reason)
            self._work.notify_all()  # blocks freed: admission may proceed

    def _fail(self, req, message):
        req.state = "failed"
        req.error = message
        self.instruments.failed.inc()
        req._emit("error", message)
        self._finish_trace(req, "failed", error=message)

    def _finish_trace(self, req, outcome, **attrs):
        """Close out a request's trace participation. Only a counted
        request decrements the live total (a submit-validation failure
        never incremented), and only a trace this engine began is
        finished here — the router finishes fleet-owned traces (a
        retryable failure is a hop, not the end of the request)."""
        tr = req.trace
        if tr is None:
            return
        now = self._clock()
        tr.event(outcome, now, actor=self.name, **attrs)
        if req._trace_live:
            req._trace_live = False
            self._live_traces = max(0, self._live_traces - 1)
        if req._trace_owned:
            req._trace_owned = False
            if self._tracer is not None:
                self._tracer.finish(tr, end=now)

    # -- run loop -------------------------------------------------------------
    @property
    def active_count(self):
        return sum(1 for r in self._slots if r is not None)

    @property
    def queue_depth(self):
        return len(self._waiting) + len(self._inbox)

    def _has_work_locked(self):
        if self._staged is not None or self._inbox:
            return True
        if any(r is not None for r in self._slots):
            return True
        # a waiting request counts as work only if admission could
        # succeed — a backpressured head must not busy-spin (a draining
        # engine admits nothing, so its queue is not work either)
        if self._waiting and not self.draining:
            req = self._waiting[0]
            need = self._kv.blocks_for(len(req.prompt)
                                       + req.max_new_tokens)
            # sole-reference cache entries count as reclaimable headroom
            reclaimable = (self.prefix_cache.reclaimable()
                           if self.prefix_cache is not None else 0)
            return (any(r is None for r in self._slots)
                    and need <= self.allocator.available + reclaimable)
        return False

    def _loop(self):
        try:
            while not self._stop.is_set():
                stats = self.step()
                if not stats:
                    with self._work:
                        if self._stop.is_set() or self._has_work_locked():
                            continue
                        t = self._clock()
                        self._idle_since = t
                        self._work.wait(timeout=0.05)
                        self._idle_since = None
                        self.note_idle(self._clock() - t)
        finally:
            # over a mesh, the other ranks' follow() ends with this one:
            # sent from the thread that issues the engine's collectives
            self._send_stop()

    def attribution_snapshot(self):
        """``time_breakdown`` including the run loop's in-progress idle
        wait, exact as of now — so a measurement window boundary doesn't
        mis-charge the wait tick it lands inside."""
        snap = dict(self.time_breakdown)
        since = self._idle_since
        if since is not None:
            snap["idle"] += max(0.0, self._clock() - since)
        return snap

    def start(self):
        """Run the scheduler on a background thread (the HTTP
        frontend's mode)."""
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="hvd_serve_engine",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """Stop the scheduler; queued and in-flight requests fail with
        "engine stopped" so no client blocks forever."""
        self._stop.set()
        with self._work:
            self._work.notify_all()
        if self._thread is not None:
            # the loop thread sends the mesh's stop as it exits
            self._thread.join(timeout=30)
            self._thread = None
        else:
            # step() driven by the caller: over a mesh, the other ranks'
            # follow() ends with this one
            self._send_stop()
        self._fail_all("serve engine stopped")

    def _fail_all(self, message):
        with self._work:
            for req in list(self._waiting) + self._inbox + [
                    r for r in self._slots if r is not None]:
                if req.state not in ("done", "failed"):
                    if req.blocks:
                        self.allocator.free(req.blocks)
                        req.blocks = None
                    if req.slot is not None:
                        self._slots[req.slot] = None
                    self._fail(req, message)
            self._waiting.clear()
            self._inbox = []


def _request_spec(req):
    """What a rank other than 0 needs to rebuild ``req``: its id,
    tokens, limits, sampling knobs, replay count and rank 0's arrival
    stamp (the scheduler's prefill order reads it)."""
    sp = req.sampling
    return {"id": req.id, "prompt": req.prompt,
            "max_new_tokens": req.max_new_tokens, "eos_id": req.eos_id,
            "sampling": (float(sp.temperature), float(sp.top_p),
                         int(sp.seed)),
            "replay": req.replay, "arrival": req.arrival}


def _request_from_spec(spec):
    t, p, seed = spec["sampling"]
    req = Request(spec["prompt"], spec["max_new_tokens"],
                  eos_id=spec["eos_id"], request_id=spec["id"],
                  sampling=sampling_lib.SamplingParams(
                      temperature=t, top_p=p, seed=seed),
                  replay=spec["replay"])
    req.state = "queued"
    req.arrival = spec["arrival"]
    return req
