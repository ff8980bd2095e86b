"""Request-scoped tracing for the serving plane: the port of
``horovod_tpu/serve/tracing.py``, the same code, so both packages' dumps
read alike in either package's ``hvd-doctor serve``.

The training side can explain every second of wall clock (goodput
ledger, flight recorder, ``hvd-doctor perf``); this module brings the
same per-event attribution to the request path, modeled on Horovod's
Timeline: every phase a request passes through — router queue, scoring
and dispatch, KV admission (or backpressure), each prefill chunk and
decode iteration it rode, weight-swap windows it overlapped, eviction
hops, HTTP first-byte — becomes a span on one per-request timeline.

Design constraints, in order:

* **Tracing off costs nothing.** ``ServeTracer.from_env()`` returns
  ``None`` when no knob is set; untraced requests carry ``trace=None``
  and every engine hot-path hook is gated behind a single attribute /
  int check. The serving programs never see tracing (it is pure host-side
  bookkeeping), so the operations they launch are the same — the same
  discipline the train step enforces (tests assert both).
* **Recording is lock-cheap.** :class:`RequestTrace` records via plain
  ``list.append`` (atomic under the GIL); the engine scheduler thread,
  the router, the pump and the HTTP frontend all record into one trace
  concurrently without taking a lock. Sorting, gap classification and
  attribution happen once, in :meth:`RequestTrace.finalize`.
* **Attribution tiles the timeline.** Solid spans cover measured work;
  :meth:`finalize` computes the complement gaps inside
  ``[start, end]`` and classifies each by the phase the request was in
  when the gap opened (queued -> ``queue``, admitted-but-waiting ->
  ``prefill_wait`` / ``decode_wait``, cut -> ``redispatch``, ...). Only
  a gap with no known phase stays unattributed, which is what the
  bench's >= 98 % ``tail_attribution`` gate polices.

Sampling: ``HOROVOD_SERVE_TRACE`` (``1``/``all`` or a fraction),
per-request ``trace=true``, and — when ``HOROVOD_SERVE_TRACE_SLO_MS``
is set — tail sampling: every request records cheaply, but only those
finishing over the SLO (plus sampled/forced ones) are kept.

Export: ndjson dumps (one finalized trace per line — the input format
of ``hvd-doctor serve``, diag/serve_doctor.py) and Chrome traces
through the existing ``telemetry/merge.py`` machinery — one pid per
actor (router, then replicas), clock-sync alignment, and request-hop
flow arrows in :data:`~horovod_tpu_torch.telemetry.merge.GLOBAL_FLOW_CAT`
so the merge keeps them crossing pids.
"""

import collections
import itertools
import json
import os
import threading
import time

from horovod_tpu_torch.telemetry import merge as merge_lib

# The span-name table. Every kind emitted anywhere in the serving stack
# must be listed here, and every entry must have a phase in
# diag/serve_doctor.py's PHASE_OF_KIND classifier (the tests hold the
# two to each other in both directions).
SPAN_KINDS = (
    "queue",         # waiting for admission (router and/or engine queue)
    "dispatch",      # router scoring + handoff to a replica engine
    "kv_wait",       # at the admission head, backpressured on KV blocks
    "prefill",       # one prefill-chunk dispatch the request rode
    "prefill_wait",  # admitted, waiting for its next prefill turn
    "decode",        # one batched decode iteration the request rode
    "decode_wait",   # decoding, waiting for its next iteration
    "weight_swap",   # a staged-weight swap window the request overlapped
    "redispatch",    # cut by an eviction, resuming on a survivor
    "stream",        # HTTP frontend first-byte / frame write
)

UNATTRIBUTED = "unattributed"

# phase marks (RequestTrace.phase) -> the gap kind charged while the
# request sits in that phase with no solid span covering the time
_GAP_KIND_OF_PHASE = {
    "queued": "queue",
    "kv_wait": "kv_wait",
    "prefilling": "prefill_wait",
    "decoding": "decode_wait",
    "redispatching": "redispatch",
}

TRACE_ENV = "HOROVOD_SERVE_TRACE"
TRACE_DIR_ENV = "HOROVOD_SERVE_TRACE_DIR"
TRACE_SLO_ENV = "HOROVOD_SERVE_TRACE_SLO_MS"

NDJSON_NAME = "servetrace.ndjson"

_ON = ("1", "true", "on", "all", "yes")
_OFF = ("", "0", "false", "off", "no", "none")


class RequestTrace:
    """Span recorder for ONE request's lifetime across actors.

    The record path (:meth:`span` / :meth:`event` / :meth:`phase`) is
    plain list appends — no lock; concurrent recorders interleave
    safely under the GIL and :meth:`finalize` sorts once at the end.
    Timestamps come from the owning tracer's injectable monotonic
    clock (the router's, fleet-wide), never ``time.time``.
    """

    __slots__ = ("request_id", "keep", "start", "end", "result",
                 "_clock", "_spans", "_events", "_phases")

    def __init__(self, request_id, clock=time.monotonic, keep=True,
                 start=None):
        self.request_id = str(request_id)
        self.keep = keep
        self._clock = clock
        self.start = clock() if start is None else start
        self.end = None
        self.result = None
        self._spans = []   # (kind, t0, t1, actor, attrs-or-None)
        self._events = []  # (name, t, attrs-or-None)
        self._phases = []  # (t, phase)

    def now(self):
        return self._clock()

    def span(self, kind, t0, t1, actor=None, **attrs):
        """Record a closed [t0, t1] span of measured work."""
        self._spans.append((kind, t0, t1, actor, attrs or None))

    def event(self, name, t, **attrs):
        """Record an instant (submit, admitted, cut, resumed, done...)."""
        self._events.append((name, t, attrs or None))

    def phase(self, t, phase):
        """Mark a phase transition — classifies later gaps at >= t."""
        if self._phases and self._phases[-1][1] == phase:
            return
        self._phases.append((t, phase))

    @staticmethod
    def _phase_at(phases, t):
        cur = None
        for pt, name in phases:
            if pt <= t + 1e-9:
                cur = name
            else:
                break
        return cur

    def finalize(self, end=None):
        """Sort spans, tile ``[start, end]`` with solid spans + classified
        gaps, pair cut/resumed events into hop windows, and cache the
        JSON-ready dict. Idempotent."""
        if self.result is not None:
            return self.result
        self.end = self._clock() if end is None else end
        start, end_t = self.start, max(self.end, self.start)
        phases = sorted(self._phases)
        solid = sorted((s for s in self._spans if s[2] > s[1]),
                       key=lambda s: (s[1], s[2]))
        spans_out = []
        for kind, t0, t1, actor, attrs in solid:
            d = {"kind": kind, "t0": t0, "t1": t1}
            if actor:
                d["actor"] = actor
            if attrs:
                d.update(attrs)
            spans_out.append(d)
        # complement gaps inside [start, end], classified by the phase
        # in force when each gap opens
        gaps, cursor = [], start
        for _kind, t0, t1, _actor, _attrs in solid:
            if t0 > cursor:
                gaps.append((cursor, min(t0, end_t)))
            cursor = max(cursor, t1)
            if cursor >= end_t:
                break
        if cursor < end_t:
            gaps.append((cursor, end_t))
        unattributed = 0.0
        for g0, g1 in gaps:
            if g1 <= g0:
                continue
            kind = _GAP_KIND_OF_PHASE.get(self._phase_at(phases, g0))
            if kind is None:
                kind = UNATTRIBUTED
                unattributed += g1 - g0
            spans_out.append({"kind": kind, "t0": g0, "t1": g1,
                              "gap": True})
        spans_out.sort(key=lambda s: (s["t0"], s["t1"]))
        events = sorted(self._events, key=lambda e: e[1])
        events_out = []
        for name, t, attrs in events:
            d = {"name": name, "t": t}
            if attrs:
                d.update(attrs)
            events_out.append(d)
        # a hop window opens at each "cut" and closes at the next
        # "resumed" (first token on the survivor) or the end — the
        # doctor charges everything inside it to the re-dispatch hop.
        # The open edge reaches back to the drain notice that doomed
        # the replica (when one was recorded): time spent parked on a
        # draining replica that then cut the stream was eviction-caused
        # from the notice, not just from the grace expiry.
        cuts = [(t, a.get("actor")) for n, t, a in events if n == "cut"]
        resumes = [t for n, t, _ in events if n == "resumed"]
        drains = [(t, a.get("actor")) for n, t, a in events
                  if n == "drain" and a.get("on")]
        hop_windows = []
        prev_end = start
        for c, actor in cuts:
            c0 = c
            for dt, dactor in drains:
                if prev_end <= dt <= c and dactor == actor:
                    c0 = min(c0, dt)
                    break
            r = next((t for t in resumes if t > c), end_t)
            hop_windows.append([c0, max(c0, r)])
            prev_end = hop_windows[-1][1]
        latency = max(0.0, end_t - start)
        attributed = max(0.0, latency - unattributed)
        self.result = {
            "request_id": self.request_id,
            "start": start,
            "end": end_t,
            "latency_s": latency,
            "attributed_s": attributed,
            "attributed_fraction":
                1.0 if latency <= 0.0 else attributed / latency,
            "hops": len(hop_windows),
            "hop_windows": hop_windows,
            "spans": spans_out,
            "events": events_out,
        }
        return self.result


class ServeTracer:
    """Sampling controller + sink for :class:`RequestTrace` objects.

    ``begin`` decides whether a request records at all (forced /
    deterministically sampled / SLO tail-armed); ``finish`` finalizes,
    applies the SLO keep-upgrade, retains the dict in a bounded deque
    and appends an ndjson line when ``out_dir`` is set. Whoever called
    ``begin`` owns the trace and must call ``finish`` exactly once —
    the engine for direct submits, the router for fleet requests.
    """

    def __init__(self, sample=1.0, slo_ms=None, out_dir=None,
                 clock=time.monotonic, max_keep=10000):
        self.sample = max(0.0, min(1.0, float(sample)))
        self.slo_ms = None if slo_ms is None else float(slo_ms)
        self.out_dir = out_dir
        self._clock = clock
        # chrome ts=0 <-> unix anchor, captured together at construction
        self._base_t = clock()
        self._base_unix_us = time.time() * 1e6
        self._lock = threading.Lock()
        self._count = 0
        self._flow_ids = itertools.count(1)
        self._kept = collections.deque(maxlen=max_keep)
        self._ndjson = None

    @classmethod
    def from_env(cls, env=None, clock=time.monotonic, out_dir=None):
        """Build a tracer from the HOROVOD_SERVE_TRACE* knobs; ``None``
        when every knob is unset/off (the zero-cost default)."""
        env = os.environ if env is None else env
        raw = (env.get(TRACE_ENV) or "").strip().lower()
        slo = (env.get(TRACE_SLO_ENV) or "").strip()
        out = out_dir or env.get(TRACE_DIR_ENV) or None
        if raw in _OFF and not slo and not out:
            return None
        if raw in _ON:
            sample = 1.0
        elif raw in _OFF:
            # dir/SLO alone arm tail-or-forced tracing, sample nothing
            sample = 0.0
        else:
            try:
                sample = float(raw)
            except ValueError:
                sample = 1.0
        try:
            slo_ms = float(slo) if slo else None
        except ValueError:
            slo_ms = None
        return cls(sample=sample, slo_ms=slo_ms, out_dir=out, clock=clock)

    def begin(self, request_id, force=False):
        """A :class:`RequestTrace` when this request should record,
        else ``None``. ``keep`` starts False for SLO-armed-only traces
        (tail sampling: record now, decide at finish)."""
        with self._lock:
            self._count += 1
            n = self._count
        f = self.sample
        sampled = f >= 1.0 or (f > 0.0
                               and int(n * f) > int((n - 1) * f))
        if not (force or sampled or self.slo_ms is not None):
            return None
        return RequestTrace(request_id, clock=self._clock,
                            keep=bool(force or sampled))

    def finish(self, trace, end=None):
        """Finalize and retain (or drop, for under-SLO tail samples)."""
        if trace is None:
            return None
        result = trace.finalize(end=end)
        if self.slo_ms is not None \
                and result["latency_s"] * 1e3 >= self.slo_ms:
            trace.keep = True
            result["slo_exceeded"] = True
        if not trace.keep:
            return None
        with self._lock:
            self._kept.append(result)
            if self.out_dir is not None:
                if self._ndjson is None:
                    os.makedirs(self.out_dir, exist_ok=True)
                    self._ndjson = open(
                        os.path.join(self.out_dir, NDJSON_NAME), "a")
                self._ndjson.write(json.dumps(result) + "\n")
                self._ndjson.flush()
        return result

    def traces(self):
        with self._lock:
            return list(self._kept)

    def clear(self):
        with self._lock:
            self._kept.clear()

    def close(self):
        with self._lock:
            if self._ndjson is not None:
                self._ndjson.close()
                self._ndjson = None

    def write_ndjson(self, path):
        """Dump every kept trace as one-JSON-per-line — the input
        format of ``hvd-doctor serve``."""
        traces = self.traces()
        with open(path, "w") as fh:
            for tr in traces:
                fh.write(json.dumps(tr) + "\n")
        return len(traces)

    # -- Chrome export ---------------------------------------------------

    def _ts_us(self, t):
        return (t - self._base_t) * 1e6

    def chrome_files(self, out_dir, traces=None):
        """One Chrome-trace JSON array per actor (pid = actor index;
        router first, replicas sorted after), each with the standard
        clock-sync event so ``telemetry/merge.py`` aligns and labels
        them; request hops become cross-pid flow arrows in
        ``GLOBAL_FLOW_CAT``. Returns the written paths."""
        traces = self.traces() if traces is None else list(traces)
        actors = set()
        for tr in traces:
            for sp in tr["spans"]:
                if sp.get("actor"):
                    actors.add(sp["actor"])
            for ev in tr["events"]:
                # a cut replica may have queued the stream without ever
                # running it — no spans, but its lane must exist for
                # the hop arrow to land on
                if ev.get("actor") and ev["name"] in ("cut", "resumed"):
                    actors.add(ev["actor"])
        actors = sorted(actors, key=lambda a: (a != "router", a))
        if not actors:
            actors = ["router"]
        index = {a: i for i, a in enumerate(actors)}
        per_actor = {a: [] for a in actors}
        tids = {}
        for tr in traces:
            tid = tids.setdefault(tr["request_id"], len(tids) + 1)
            for sp in tr["spans"]:
                actor = sp.get("actor") or actors[0]
                if actor not in index:  # dump merged from another fleet
                    continue
                args = {k: v for k, v in sp.items()
                        if k not in ("kind", "t0", "t1", "actor")}
                args["request"] = tr["request_id"]
                per_actor[actor].append({
                    "name": sp["kind"], "cat": "hvd_serve", "ph": "X",
                    "ts": round(self._ts_us(sp["t0"]), 3),
                    "dur": round(max(0.0, sp["t1"] - sp["t0"]) * 1e6, 3),
                    "tid": tid, "args": args})
            # one arrow per hop: the "cut" event on the doomed replica
            # -> the next "resumed" event on its survivor, one
            # GLOBALLY-allocated id so the merge keeps it crossing pids
            # (event-based: a stream cut while still queued has no span
            # on the doomed replica at all)
            resumes = [e for e in tr["events"] if e["name"] == "resumed"
                       and e.get("actor") in index]
            for ce in tr["events"]:
                if ce["name"] != "cut" or ce.get("actor") not in index:
                    continue
                re_ = next((r for r in resumes if r["t"] > ce["t"]),
                           None)
                if re_ is None:
                    continue
                with self._lock:
                    fid = next(self._flow_ids)
                per_actor[ce["actor"]].append({
                    "name": "redispatch", "cat": merge_lib.GLOBAL_FLOW_CAT,
                    "ph": "s", "id": fid, "tid": tid,
                    "ts": round(self._ts_us(ce["t"]), 3)})
                per_actor[re_["actor"]].append({
                    "name": "redispatch", "cat": merge_lib.GLOBAL_FLOW_CAT,
                    "ph": "f", "bp": "e", "id": fid, "tid": tid,
                    "ts": round(self._ts_us(re_["t"]), 3)})
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for actor in actors:
            rank = index[actor]
            events = [
                {"name": merge_lib.CLOCK_SYNC, "ph": "i", "s": "g",
                 "ts": 0, "pid": rank, "tid": 0,
                 "args": {"unix_time_us": self._base_unix_us,
                          "rank": rank}},
                {"name": "process_name", "ph": "M", "pid": rank,
                 "args": {"name": f"serve {actor}"}},
                {"name": "process_sort_index", "ph": "M", "pid": rank,
                 "args": {"sort_index": rank}},
            ] + per_actor[actor]
            path = os.path.join(out_dir, f"servetrace.rank{rank}.json")
            with open(path, "w") as fh:
                json.dump(events, fh)
            paths.append(path)
        return paths

    def write_chrome(self, out_path, traces=None):
        """Per-actor files + the telemetry merge -> one Perfetto-loadable
        trace at ``out_path``. Returns the merged event list."""
        out_dir = os.path.dirname(os.path.abspath(out_path)) or "."
        paths = self.chrome_files(out_dir, traces=traces)
        return merge_lib.merge_traces(paths, out_path)
