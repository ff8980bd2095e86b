"""Fleet router: dispatch, drain, re-dispatch — zero dropped requests.
The port of ``horovod_tpu/serve/fleet/router.py``.

The router is a thin, deliberately boring layer: all batching
intelligence lives in the engines; the router only decides WHICH
engine, and owns the failure story. Three mechanisms:

* **Dispatch** — a background dispatcher pulls queued
  :class:`FleetRequest`\\ s and scores every ``ready`` replica by
  ``(has KV headroom, queue depth + active, -free blocks)``: KV
  headroom first (a request that cannot reserve its blocks would sit
  in engine backpressure while another replica could run it NOW), load
  second, free pool as the tiebreak. A request a draining/dead replica
  refuses is simply scored elsewhere; with no live replica at all the
  queue waits (capacity may return) unless every replica is ``dead``.
* **Drain** (spot preemption, chaos eviction, weight staging) — the
  doomed replica flips to ``draining``: the engine refuses new
  admissions (503 ``draining`` on its ``/healthz``), the router stops
  dispatching to it, and in-flight sequences run to completion inside
  the grace budget. Whatever is still unfinished at eviction fails
  over to the re-dispatch path.
* **Re-dispatch** — a request cut mid-stream by an eviction is NOT an
  error the client sees: the router resubmits it to a survivor as a
  continuation (``prompt + generated so far``, remaining token
  budget). Greedy decoding is trivially resumable; sampled decoding
  resumes EXACTLY because ``serve/sampling.py`` keys every token on
  ``(seed, absolute position)`` — the continuation's next token draws
  the same RNG key it would have drawn on the dead replica. The
  survivor REPLAYS the generated tokens through its decode program
  (``engine.Request(replay=...)``) instead of prefilling them, so their
  K/V and later logits come out as the dead replica's did (bit for bit
  where the prompt's prefill chunks fell alike) — in bf16 too, where a
  prefill of the same tokens rounds differently and can flip a
  near-tied greedy token. The client's stream just keeps going;
  ``hvd_serve_requests_total`` counts the hop under ``redispatched``,
  not ``failed``.

Rolling weight reload composes the same drain: ``install_weights``
stages one replica at a time (drain → stage → swap → ready), so a
checkpoint roll never leaves the fleet without an admitting replica —
``serve/loader.ReloadWatcher`` can point at the router exactly as it
would at a single engine.
"""

import itertools
import logging
import queue
import threading
import time
from collections import OrderedDict, deque

from horovod_tpu_torch.serve import engine as engine_lib
from horovod_tpu_torch.serve import sampling as sampling_lib
from horovod_tpu_torch.serve.fleet import replica as replica_lib
from horovod_tpu_torch.telemetry import instruments as instruments_lib
from horovod_tpu_torch.telemetry.registry import get_registry

logger = logging.getLogger("horovod_tpu_torch")

# engine refusals that mean "try another replica", not "bad request"
_RETRYABLE = ("draining", "stopped", "dispatch failed")


def _retryable(message):
    return any(marker in str(message) for marker in _RETRYABLE)


class FleetRequest:
    """A client request at fleet scope: same event-queue stream
    protocol as the engine's :class:`~horovod_tpu_torch.serve.engine.
    Request`, but it survives its current engine — the router may play
    it through several replicas; ``generated`` accumulates across
    hops and the stream never repeats or skips a token."""

    _ids = itertools.count()

    def __init__(self, tokens, max_new_tokens, eos_id=None,
                 sampling=None, request_id=None, trace=False):
        self.id = (f"fleet-{next(self._ids)}" if request_id is None
                   else request_id)
        self.prompt = [int(t) for t in tokens]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.sampling = (sampling_lib.GREEDY if sampling is None
                         else sampling)
        self.generated = []
        self.state = "new"  # new|queued|running|done|failed
        self.finish_reason = None
        self.error = None
        self.replica = None     # replica currently (last) running it
        self.hops = 0           # re-dispatches survived
        # client-observable latency (what a caller on the other side
        # of the frontend would measure — TTFT spans router queueing,
        # dispatch, engine queueing AND any re-dispatch). Stamped with
        # the ROUTER's clock (installed at submit) so fake-clock tests
        # and benches see one time base fleet-wide.
        self.arrival = None
        self.admitted_at = None  # first engine admission (TTFT base 2)
        self.first_token_time = None
        self.token_times = []
        # request-scoped tracing (serve/tracing.py): the router owns a
        # fleet request's trace for its WHOLE life — the same
        # RequestTrace rides every per-hop engine request, so a cut and
        # its continuation land on one timeline
        self.trace_requested = bool(trace)
        self.trace = None
        self._trace_owned = False
        self._clock = time.monotonic
        self._events = queue.Queue()

    def _emit(self, kind, value=None):
        if kind == "token":
            now = self._clock()
            if self.first_token_time is None:
                self.first_token_time = now
            self.token_times.append(now)
        self._events.put((kind, value))

    def stream(self, timeout=120.0):
        """Yield token ids until done. Raises
        :class:`~horovod_tpu_torch.serve.engine.RequestError` on terminal
        failure, ``TimeoutError`` on fleet silence."""
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
                raise engine_lib.RequestError(value)

    def result(self, timeout=120.0):
        return list(self.stream(timeout=timeout))


class FleetRouter:
    """Replica registry + dispatcher + failure handling (module
    docstring). ``clock`` is injectable like the engine's. Replicas
    are added ready; :meth:`submit`/:meth:`generate` are the client
    surface, :meth:`drain`/:meth:`evict`/:meth:`preempt` the
    lifecycle surface, :meth:`install_weights` the reload surface."""

    def __init__(self, registry=None, clock=time.monotonic,
                 grace=None, stream_timeout=120.0,
                 stage_timeout=30.0, tracer=None):
        self.registry = registry if registry is not None \
            else get_registry()
        self._clock = clock
        self._tracer = tracer
        self._grace = grace
        self._stream_timeout = float(stream_timeout)
        self._stage_timeout = float(stage_timeout)
        self._replicas = OrderedDict()  # name -> Replica
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._queue = deque()
        self._stop_evt = threading.Event()
        self._thread = None
        self._replica_gauge = instruments_lib.serve_replicas_gauge(
            self.registry)
        self._requests = self.registry.counter(
            instruments_lib.SERVE_REQUESTS,
            "Generate requests by lifecycle event (submitted / "
            "completed / failed)", label_names=("event",))
        self._redispatch_counter = \
            instruments_lib.serve_redispatch_counter(self.registry)
        self._swap_seconds = \
            instruments_lib.serve_weight_swap_histogram(self.registry)
        self.redispatched = 0  # request hops survived (not failures)
        self.dropped = 0       # terminally failed AFTER running (SLO: 0)

    # -- replica registry ----------------------------------------------------
    def add_replica(self, name, engine, notice_file=None,
                    notice_url=None, grace=None, poll_interval=None,
                    env=None):
        """Register an engine as a fleet replica and arm its
        preemption handler (always armed — chaos and the ``preempt``
        API drive unarmed-by-notice replicas via ``trigger``)."""
        with self._lock:
            if name in self._replicas:
                raise ValueError(f"duplicate replica name {name!r}")
            rep = replica_lib.Replica(name, engine, clock=self._clock)
            rep.arm_preempt(
                on_drain=lambda timeout, n=name: self.drain_traffic(
                    n, grace=timeout),
                on_evict=lambda n=name: self.evict(n),
                notice_file=notice_file, notice_url=notice_url,
                grace=grace if grace is not None else self._grace,
                poll_interval=poll_interval, env=env)
            self._replicas[name] = rep
            self._update_replica_gauge()
            self._cond.notify_all()
        return rep

    def replica(self, name):
        return self._replicas[name]

    @property
    def replicas(self):
        return list(self._replicas.values())

    def _update_replica_gauge(self):
        counts = {s: 0 for s in replica_lib.STATES}
        for rep in self._replicas.values():
            counts[rep.state] += 1
        for state, n in counts.items():
            self._replica_gauge.labels(state).set(n)

    # -- client surface ------------------------------------------------------
    def submit(self, request):
        """Queue a :class:`FleetRequest` for dispatch; returns it."""
        with self._cond:
            if self._stop_evt.is_set():
                request.state = "failed"
                request.error = "fleet router is stopped"
                request._emit("error", request.error)
                raise engine_lib.RequestError(request.error)
            request.state = "queued"
            request._clock = self._clock
            request.arrival = self._clock()
            if request.trace is None and self._tracer is not None:
                tr = self._tracer.begin(request.id,
                                        force=request.trace_requested)
                if tr is not None:
                    request.trace = tr
                    request._trace_owned = True
            if request.trace is not None:
                request.trace.phase(request.arrival, "queued")
                request.trace.event("submit", request.arrival,
                                    actor="router")
            self._queue.append(request)
            self._cond.notify_all()
        return request

    def generate(self, tokens, max_new_tokens, eos_id=None,
                 sampling=None):
        return self.submit(FleetRequest(tokens, max_new_tokens,
                                        eos_id=eos_id,
                                        sampling=sampling))

    # -- dispatch ------------------------------------------------------------
    def _pick(self, freq):
        """Best ready replica for this request: KV headroom beats
        load beats free-pool size. None when nobody is ready."""
        ready = [r for r in self._replicas.values()
                 if r.state == replica_lib.READY]
        if not ready:
            return None
        need = None
        best, best_score = None, None
        for rep in ready:
            need = rep.engine.blocks_needed(len(freq.prompt)
                                            + len(freq.generated),
                                            freq.max_new_tokens
                                            - len(freq.generated))
            score = (0 if rep.headroom_for(need) else 1,
                     rep.load, -rep.engine.allocator.available)
            if best_score is None or score < best_score:
                best, best_score = rep, score
        return best

    def _dispatch(self, freq):
        """Submit ``freq``'s (continuation) engine request to the best
        replica and start its pump. Returns False when no ready
        replica exists (requeue); terminal failures are handled."""
        remaining = freq.max_new_tokens - len(freq.generated)
        tr = freq.trace
        while True:
            t_pick = self._clock() if tr is not None else 0.0
            with self._lock:
                rep = self._pick(freq)
                all_dead = all(r.state == replica_lib.DEAD
                               for r in self._replicas.values())
            if rep is None:
                if self._replicas and all_dead:
                    self._fail(freq, "no live replica in the fleet")
                    return True
                return False
            # the generated tokens replay through the survivor's decode
            # (engine.Request replay): their K/V, and so the stream, come
            # out as on the dead replica
            ereq = engine_lib.Request(
                freq.prompt + freq.generated, remaining,
                eos_id=freq.eos_id, sampling=freq.sampling,
                replay=len(freq.generated))
            # the fleet trace rides every per-hop engine request, so
            # engine spans (admission, prefill chunks, decode batches)
            # land on the one fleet timeline
            ereq.trace = tr
            try:
                rep.engine.submit(ereq)
            except engine_lib.RequestError as e:
                if _retryable(e):
                    # a replica the router believes ready but whose
                    # engine is gone (broken program, stopped) will
                    # refuse forever — retire it so the re-pick
                    # converges instead of spinning on the same score
                    if (rep.engine._broken is not None
                            or rep.engine._stop.is_set()):
                        self.evict(rep.name)
                    continue  # replica flipped under us; score again
                self._fail(freq, str(e))
                return True
            freq.state = "running"
            freq.replica = rep.name
            if tr is not None:
                tr.span("dispatch", t_pick, self._clock(),
                        actor="router", replica=rep.name, hop=freq.hops)
            pump = threading.Thread(
                target=self._pump, args=(freq, ereq),
                name=f"hvd_fleet_pump_{freq.id}", daemon=True)
            pump.start()
            return True

    def _loop(self):
        while not self._stop_evt.is_set():
            with self._cond:
                while not self._queue and not self._stop_evt.is_set():
                    self._cond.wait(timeout=0.1)
                if self._stop_evt.is_set():
                    return
                freq = self._queue.popleft()
            if not self._dispatch(freq):
                # nobody ready right now — requeue at the FRONT (FIFO
                # fairness for the interrupted) and let states settle
                with self._cond:
                    self._queue.appendleft(freq)
                    self._cond.wait(timeout=0.02)

    def _pump(self, freq, ereq):
        """Forward one engine run's tokens into the fleet request;
        on a retryable failure, hand the remainder back to the
        dispatcher as a continuation."""
        try:
            first = True
            for tok in ereq.stream(timeout=self._stream_timeout):
                if first:
                    first = False
                    if freq.admitted_at is None:
                        freq.admitted_at = ereq.admitted_at
                    if freq.trace is not None and freq.hops:
                        # first token after a hop closes its window
                        freq.trace.event("resumed", self._clock(),
                                         actor=freq.replica or "",
                                         hop=freq.hops)
                freq.generated.append(tok)
                freq._emit("token", tok)
            self._finish(freq, ereq.finish_reason)
        except engine_lib.RequestError as e:
            if _retryable(e):
                self._continue_elsewhere(freq)
            else:
                self._fail(freq, str(e))
        except TimeoutError as e:
            # a silent engine is as dead as a stopped one
            self._continue_elsewhere(freq, note=str(e))

    def _continue_elsewhere(self, freq, note=None):
        remaining = freq.max_new_tokens - len(freq.generated)
        if remaining <= 0:
            self._finish(freq, "length")
            return
        if (freq.eos_id is not None and freq.generated
                and freq.generated[-1] == freq.eos_id):
            self._finish(freq, "eos")
            return
        with self._cond:
            if self._stop_evt.is_set():
                self._fail(freq, "fleet router is stopped")
                return
            freq.hops += 1
            self.redispatched += 1
            self._requests.labels("redispatched").inc()
            self._redispatch_counter.inc()
            if freq.trace is not None:
                now = self._clock()
                freq.trace.phase(now, "redispatching")
                attrs = {"note": note} if note else {}
                freq.trace.event("cut", now, actor=freq.replica or "",
                                 hop=freq.hops, **attrs)
            freq.state = "queued"
            self._queue.appendleft(freq)
            self._cond.notify_all()
        logger.info("fleet: request %s re-dispatched (hop %d, %d/%d "
                    "tokens done%s)", freq.id, freq.hops,
                    len(freq.generated), freq.max_new_tokens,
                    f"; {note}" if note else "")

    def _finish(self, freq, reason):
        freq.state = "done"
        freq.finish_reason = reason
        freq._emit("done")
        self._finish_trace(freq, "done", reason=reason)

    def _fail(self, freq, message):
        # a drop is a request the fleet ACCEPTED and then lost: it ran
        # (or survived a hop) and still failed — queued-never-ran
        # refusals are load shedding, not drops
        if freq.state == "running" or freq.generated or freq.hops:
            self.dropped += 1
        freq.state = "failed"
        freq.error = message
        freq._emit("error", message)
        self._finish_trace(freq, "failed", error=message)

    def _finish_trace(self, freq, outcome, **attrs):
        tr = freq.trace
        if tr is None:
            return
        now = self._clock()
        tr.event(outcome, now, actor="router", **attrs)
        if freq._trace_owned:
            freq._trace_owned = False
            if self._tracer is not None:
                self._tracer.finish(tr, end=now)

    # -- lifecycle: drain / evict / preempt ----------------------------------
    def drain_traffic(self, name, grace=None):
        """The in-grace-window drain: stop dispatch + admission to
        ``name``, then wait (bounded) for its in-flight sequences to
        finish. Called by the preemption handler as its force-commit;
        callable directly for a planned drain."""
        rep = self._replicas[name]
        with self._lock:
            if rep.state == replica_lib.DEAD:
                return
            rep.state = replica_lib.DRAINING
            rep.engine.set_draining(True)
            rep.drain_started_at = self._clock()
            self._update_replica_gauge()
        budget = grace if grace is not None else \
            (self._grace if self._grace is not None else 30.0)
        deadline = self._clock() + max(0.0, float(budget))
        while self._clock() < deadline:
            if rep.engine.active_count == 0:
                break
            time.sleep(0.01)
        remaining = rep.engine.active_count
        if remaining == 0:
            logger.info("fleet: replica %s drained within its grace "
                        "budget", name)
        else:
            logger.warning("fleet: replica %s grace budget expired "
                           "with %d still in flight (they fail over "
                           "to re-dispatch at eviction)", name,
                           remaining)

    def evict(self, name):
        """Kill the replica NOW. In-flight/queued engine requests fail
        over to the re-dispatch path — their pumps see the engine-
        stopped error and queue continuations."""
        rep = self._replicas[name]
        with self._lock:
            if rep.state == replica_lib.DEAD:
                return
            rep.state = replica_lib.DEAD
            self._update_replica_gauge()
        rep.engine.stop()
        rep.stopped_at = self._clock()
        with self._cond:
            self._cond.notify_all()
        logger.warning("fleet: replica %s evicted", name)

    def preempt(self, name, kind="notice:router"):
        """Deliver a preemption notice to ``name``: the armed
        ``elastic/preempt.py`` handler runs the full graceful path
        (grace-bounded drain as its force-commit, metrics, then
        eviction). Returns the eviction thread."""
        thread = self._replicas[name].trigger_preempt(kind)
        if thread is None:  # already evicting/evicted
            return None
        return thread

    # -- rolling weight reload ----------------------------------------------
    @property
    def weights_version(self):
        versions = [r.engine.weights_version
                    for r in self._replicas.values()
                    if r.state != replica_lib.DEAD]
        return min((v for v in versions if v is not None), default=None)

    def install_weights(self, params, version=None):
        """Fleet-wide rolling reload: one replica at a time drains
        admission, stages, swaps, and returns to ready — the duck-type
        ``serve/loader.ReloadWatcher`` expects, so one watcher rolls
        the whole fleet."""
        for name, rep in list(self._replicas.items()):
            if rep.state != replica_lib.READY:
                continue  # draining/dead replicas are not staged
            t_roll = self._clock()
            with self._lock:
                rep.state = replica_lib.DRAINING
                rep.engine.set_draining(True)
                rep.drain_started_at = t_roll
                self._update_replica_gauge()
            try:
                rep.engine.install_weights(params, version=version)
                if version is not None:
                    deadline = self._clock() + self._stage_timeout
                    while (rep.engine.weights_version != version
                           and self._clock() < deadline):
                        time.sleep(0.005)
            finally:
                with self._lock:
                    if rep.state == replica_lib.DRAINING:
                        rep.state = replica_lib.READY
                        rep.engine.set_draining(False)
                        self._update_replica_gauge()
                # the whole drain -> stage -> swap -> ready window this
                # replica was out of rotation — the rolling-reload
                # stall /metrics can show (the engine separately
                # observes its in-step swap application)
                self._swap_seconds.observe(self._clock() - t_roll)
                with self._cond:
                    self._cond.notify_all()
            logger.info("fleet: replica %s rolled to weights version "
                        "%s", name, rep.engine.weights_version)

    # -- fleet health --------------------------------------------------------
    def healthz(self):
        replicas = {name: rep.health()
                    for name, rep in self._replicas.items()}
        ready = sum(1 for r in self._replicas.values()
                    if r.state == replica_lib.READY)
        status = "ok" if ready else (
            "down" if not self._replicas or all(
                r.state == replica_lib.DEAD
                for r in self._replicas.values()) else "draining")
        with self._lock:
            depth = len(self._queue)
        return {"status": status, "ready_replicas": ready,
                "router_queue_depth": depth,
                "weights_version": self.weights_version,
                "redispatched": self.redispatched,
                "dropped": self.dropped, "replicas": replicas}

    # -- run loop ------------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return self
        self._stop_evt.clear()
        for rep in self._replicas.values():
            rep.engine.start()
        self._thread = threading.Thread(target=self._loop,
                                        name="hvd_fleet_router",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """Stop dispatching, disarm preempt handlers, stop engines.
        Queued fleet requests fail loudly (stream-side too)."""
        self._stop_evt.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        with self._lock:
            pending = list(self._queue)
            self._queue.clear()
        for freq in pending:
            self._fail(freq, "fleet router is stopped")
        # reverse arm order restores any chained signal handlers clean
        for rep in reversed(list(self._replicas.values())):
            rep.disarm()
            rep.engine.stop()
