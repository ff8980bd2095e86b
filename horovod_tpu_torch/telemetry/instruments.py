"""The framework's standard instrument catalogue.

The port of ``horovod_tpu/telemetry/instruments.py``: the same metric
names (``hvd_*``, with ``LEGACY_ALIASES``), help texts and label sets,
so one dashboard reads both packages' ranks, the serving plane's
``hvd_serve_*`` family (``ServeInstruments``) included. What differs,
and why:

* ``hvd_build_info`` labels a rank with torch's version, CUDA's and the
  device's name (``version``, ``torch``, ``cuda``, ``device``,
  ``world``) where the JAX package names jax's version and backend;
* there is no XLA compile to listen to: :func:`record_compile` books
  the port's counterparts, the CUDA kernels' build at first use
  (``_build.py``) and a GSPMD step's first call of each batch signature
  (``parallel/gspmd.CompiledProgramCache``), into
  ``hvd_compile_seconds_total``, the cache counters and the goodput
  ledger's ``compile`` phase;
* a deferred scalar is a tensor, read (``.item()``) only when something
  scrapes, so recording a step never synchronizes the card.

Enablement: per-step instrumentation (the gradient norm a step computes
for ``hvd_grad_norm``) is gated on :func:`enabled` — on when a metrics
endpoint is configured (``HOROVOD_METRICS_PORT``) or
``HOROVOD_TELEMETRY=1``. Registry writes themselves are always safe to
make.
"""

import os
import time

from horovod_tpu_torch.telemetry.registry import get_registry

# Names are canonically ``hvd_*``. The catalogue used to mix
# ``horovod_*`` (step/collective/elastic) and ``hvd_*`` (wire/ckpt/data)
# prefixes; the old names remain available for ONE release as scrape-
# time aliases (``LEGACY_ALIASES`` below, rendered by the registry with
# a deprecation HELP line) and are then removed — re-point dashboards at
# the ``hvd_*`` names (docs/OBSERVABILITY.md deprecation note).
# -- step / training plane --------------------------------------------------
STEP_TOTAL = "hvd_step_total"
STEP_SECONDS = "hvd_step_latency_seconds"
STEP_DISPATCH_SECONDS = "hvd_step_dispatch_seconds"
MICROBATCH_SECONDS = "hvd_microbatch_seconds"
EXAMPLES_TOTAL = "hvd_examples_total"
EXAMPLES_PER_SEC = "hvd_examples_per_second"
LOSS = "hvd_loss"
GRAD_NORM = "hvd_grad_norm"
# -- compilation ------------------------------------------------------------
COMPILE_CACHE_HITS = "hvd_compile_cache_hits_total"
COMPILE_CACHE_MISSES = "hvd_compile_cache_misses_total"
COMPILE_SECONDS = "hvd_compile_seconds_total"
# -- collectives / fusion ---------------------------------------------------
COLLECTIVE_CALLS = "hvd_collective_calls_total"
COLLECTIVE_BYTES = "hvd_collective_bytes_total"
COLLECTIVE_LOGICAL_BYTES = "hvd_collective_logical_bytes_total"
BUCKET_FILL_RATIO = "hvd_bucket_fill_ratio"
BUCKET_DISPATCH_SECONDS = "hvd_bucket_dispatch_seconds"
# -- wire compression (ops/compression.py + the fusion pipeline) ------------
WIRE_BYTES = "hvd_wire_bytes_total"
WIRE_LOGICAL_BYTES = "hvd_wire_logical_bytes_total"
WIRE_COMPRESSION_RATIO = "hvd_wire_compression_ratio"
# -- elastic ----------------------------------------------------------------
RENDEZVOUS_EPOCHS = "hvd_rendezvous_epochs_total"
BLACKLIST_HOSTS = "hvd_blacklist_hosts"
RECOVERY_SECONDS = "hvd_recovery_seconds"
STRAGGLER_RATIO = "hvd_straggler_step_time_ratio"
# -- preemption / graceful eviction (elastic/preempt.py, chaos soak) --------
PREEMPTIONS_TOTAL = "hvd_preemptions_total"
DRAIN_SECONDS = "hvd_drain_seconds"
GRACE_COMMIT_SECONDS = "hvd_grace_commit_seconds"
# -- stall inspector --------------------------------------------------------
STALLED_RANKS = "hvd_stalled_ranks"
# -- async sharded checkpointing (horovod_tpu/ckpt) -------------------------
CKPT_SAVE_SECONDS = "hvd_ckpt_save_seconds"
CKPT_BLOCKING_SECONDS = "hvd_ckpt_blocking_seconds"
CKPT_BYTES_WRITTEN = "hvd_ckpt_bytes_written"
CKPT_INFLIGHT = "hvd_ckpt_inflight"
# -- data plane (horovod_tpu/data prefetch loaders) -------------------------
DATA_WAIT_SECONDS = "hvd_data_wait_seconds"
DATA_QUEUE_DEPTH = "hvd_data_queue_depth"
DATA_BYTES_STAGED = "hvd_data_bytes_staged_total"
DATA_BATCHES = "hvd_data_batches_total"
DATA_LOAD_SECONDS = "hvd_data_load_seconds"
# -- serving plane (horovod_tpu_torch/serve) --------------------------------
SERVE_REQUESTS = "hvd_serve_requests_total"
SERVE_TOKENS = "hvd_serve_tokens_total"
SERVE_QUEUE_DEPTH = "hvd_serve_queue_depth"
SERVE_KV_BLOCKS = "hvd_serve_kv_blocks_in_use"
SERVE_TTFT_SECONDS = "hvd_serve_ttft_seconds"
SERVE_TTFT_ADMISSION_SECONDS = "hvd_serve_ttft_admission_seconds"
SERVE_INTER_TOKEN_SECONDS = "hvd_serve_inter_token_seconds"
SERVE_CACHED_PREFILL_TOKENS = "hvd_serve_cached_prefill_tokens_total"
SERVE_REPLICAS = "hvd_serve_replicas"
SERVE_REDISPATCH_TOTAL = "hvd_serve_redispatch_total"
SERVE_WEIGHT_SWAP_SECONDS = "hvd_serve_weight_swap_seconds"
# -- goodput ledger (telemetry/ledger.py, docs/OBSERVABILITY.md) ------------
TIME_SECONDS = "hvd_time_seconds_total"
GOODPUT_RATIO = "hvd_goodput_ratio"
# -- compiled-step X-ray (telemetry/xprof.py, hvd-doctor-torch xray) --------
XRAY_DEVICE_SECONDS = "hvd_xray_device_seconds"
XRAY_BUCKETED_FRACTION = "hvd_xray_bucketed_fraction"
XRAY_EXPOSED_SECONDS = "hvd_xray_exposed_collective_seconds"
XRAY_COLLECTIVE_GBPS = "hvd_xray_collective_bandwidth_gbps"
# -- process identity -------------------------------------------------------
BUILD_INFO = "hvd_build_info"

# canonical -> deprecated name, served as scrape-time duplicates for one
# release (the registry renders each aliased family twice)
LEGACY_ALIASES = {
    STEP_TOTAL: "horovod_step_total",
    STEP_SECONDS: "horovod_step_latency_seconds",
    STEP_DISPATCH_SECONDS: "horovod_step_dispatch_seconds",
    MICROBATCH_SECONDS: "horovod_microbatch_seconds",
    EXAMPLES_TOTAL: "horovod_examples_total",
    EXAMPLES_PER_SEC: "horovod_examples_per_second",
    LOSS: "horovod_loss",
    GRAD_NORM: "horovod_grad_norm",
    COMPILE_CACHE_HITS: "horovod_compile_cache_hits_total",
    COMPILE_CACHE_MISSES: "horovod_compile_cache_misses_total",
    COMPILE_SECONDS: "horovod_compile_seconds_total",
    COLLECTIVE_CALLS: "horovod_collective_calls_total",
    COLLECTIVE_BYTES: "horovod_collective_bytes_total",
    COLLECTIVE_LOGICAL_BYTES: "horovod_collective_logical_bytes_total",
    BUCKET_FILL_RATIO: "horovod_bucket_fill_ratio",
    BUCKET_DISPATCH_SECONDS: "horovod_bucket_dispatch_seconds",
    RENDEZVOUS_EPOCHS: "horovod_rendezvous_epochs_total",
    BLACKLIST_HOSTS: "horovod_blacklist_hosts",
    RECOVERY_SECONDS: "horovod_recovery_seconds",
    STRAGGLER_RATIO: "horovod_straggler_step_time_ratio",
    STALLED_RANKS: "horovod_stalled_ranks",
}

# every metric the port registers, in catalogue order: the JAX package's
# catalogue (tests/test_torch_telemetry.py holds the two together)
CATALOGUE = (
    STEP_TOTAL, STEP_SECONDS, STEP_DISPATCH_SECONDS, MICROBATCH_SECONDS,
    EXAMPLES_TOTAL, EXAMPLES_PER_SEC, LOSS, GRAD_NORM,
    COMPILE_CACHE_HITS, COMPILE_CACHE_MISSES, COMPILE_SECONDS,
    COLLECTIVE_CALLS, COLLECTIVE_BYTES, COLLECTIVE_LOGICAL_BYTES,
    WIRE_BYTES, WIRE_LOGICAL_BYTES, WIRE_COMPRESSION_RATIO,
    BUCKET_FILL_RATIO, BUCKET_DISPATCH_SECONDS,
    RENDEZVOUS_EPOCHS, BLACKLIST_HOSTS, RECOVERY_SECONDS, STRAGGLER_RATIO,
    PREEMPTIONS_TOTAL, DRAIN_SECONDS, GRACE_COMMIT_SECONDS,
    STALLED_RANKS,
    CKPT_BLOCKING_SECONDS, CKPT_SAVE_SECONDS, CKPT_BYTES_WRITTEN,
    CKPT_INFLIGHT,
    DATA_WAIT_SECONDS, DATA_LOAD_SECONDS, DATA_QUEUE_DEPTH,
    DATA_BYTES_STAGED, DATA_BATCHES,
    SERVE_REQUESTS, SERVE_TOKENS, SERVE_QUEUE_DEPTH, SERVE_KV_BLOCKS,
    SERVE_TTFT_SECONDS, SERVE_TTFT_ADMISSION_SECONDS,
    SERVE_INTER_TOKEN_SECONDS,
    SERVE_CACHED_PREFILL_TOKENS, SERVE_REPLICAS,
    SERVE_REDISPATCH_TOTAL, SERVE_WEIGHT_SWAP_SECONDS,
    TIME_SECONDS, GOODPUT_RATIO,
    XRAY_DEVICE_SECONDS, XRAY_BUCKETED_FRACTION,
    XRAY_EXPOSED_SECONDS, XRAY_COLLECTIVE_GBPS,
    BUILD_INFO,
)

# the default registry serves the legacy names on every scrape until the
# deprecation window closes
get_registry().install_aliases(LEGACY_ALIASES)


def enabled(env=None):
    """True when program-shaping / per-step instrumentation should be on."""
    env = env if env is not None else os.environ
    if env.get("HOROVOD_TELEMETRY", "").lower() not in ("", "0", "false",
                                                        "no", "off"):
        return True
    try:
        from horovod_tpu_torch import basics
        cfg = basics._state.config
        if cfg is not None:
            return cfg.metrics_port is not None
    except Exception:
        pass
    return env.get("HOROVOD_METRICS_PORT", "") != ""


class StepInstruments:
    """Per-train-step recorder shared by ``make_train_step`` wrappers and
    ``elastic_train_loop``. One instance per built step function; all
    instances feed the same registry families.

    Step *latency* is the wall time between successive step calls (in
    steady state the dispatch queue is full, so inter-call time IS the
    device step time); step *dispatch* is the time the jitted call itself
    held the host. Loss and grad-norm are stashed as device arrays and
    only read back when something scrapes (deferred gauges) — recording a
    step never forces a sync."""

    def __init__(self, registry=None, accum_steps=1):
        r = registry if registry is not None else get_registry()
        self.registry = r
        self._accum = max(1, accum_steps)
        self.steps = r.counter(STEP_TOTAL, "Completed train-step calls")
        self.examples = r.counter(EXAMPLES_TOTAL,
                                  "Examples consumed by train steps")
        self.step_seconds = r.histogram(
            STEP_SECONDS, "Wall time between successive train-step calls "
            "(steady-state device step time)")
        self.dispatch_seconds = r.histogram(
            STEP_DISPATCH_SECONDS,
            "Host time spent dispatching the compiled step")
        self.micro_seconds = r.histogram(
            MICROBATCH_SECONDS,
            "Per-microbatch share of the step wall time (step/accum)")
        self.examples_per_sec = r.gauge(
            EXAMPLES_PER_SEC, "Examples/sec from the last step interval")
        self.loss = r.gauge(LOSS, "Last step loss (deferred readback)")
        self.grad_norm = r.gauge(
            GRAD_NORM, "Gradient L2 norm of the last step "
            "(deferred readback; see docs/OBSERVABILITY.md for the "
            "per-path definition)")
        self._last_call = None

    def record_step(self, batch, dispatch_s, loss=None, grad_norm=None,
                    timeline=None, step_no=None):
        now = time.perf_counter()
        self.steps.inc()
        self.examples.inc(batch)
        self.dispatch_seconds.observe(dispatch_s)
        interval = None
        if self._last_call is not None:
            interval = now - self._last_call
            self.step_seconds.observe(interval)
            self.micro_seconds.observe(interval / self._accum)
            if interval > 0:
                self.examples_per_sec.set(batch / interval)
        self._last_call = now
        if loss is not None:
            self.loss.set_function(_deferred_scalar(loss))
        if grad_norm is not None:
            self.grad_norm.set_function(_deferred_scalar(grad_norm))
        if timeline is not None:
            if interval:  # same zero guard as the gauge above
                timeline.counter("step", {
                    "step_ms": round(interval * 1e3, 3),
                    "examples_per_sec": round(batch / interval, 1)})
            if step_no is not None:
                timeline.instant("STEP_DISPATCH",
                                 args={"step": int(step_no),
                                       "dispatch_ms":
                                           round(dispatch_s * 1e3, 3)})


def _deferred_scalar(x):
    """Collect-time readback of a (possibly device) scalar: a tensor is
    read (``.item()``, a sync) by the scrape, never by the step."""
    def read():
        try:
            return float(x.item() if hasattr(x, "item") else x)
        except Exception:
            return float("nan")
    return read


# per-(metric, label) child handles, resolved once and reused — the
# cached-child discipline registry.py prescribes for hot callers (the
# eager path dispatches collectives per step)
_child_cache = {}


def _calls_child(op_name):
    child = _child_cache.get(("calls", op_name))
    if child is None:
        child = get_registry().counter(
            COLLECTIVE_CALLS, "Collective op dispatches (trace-time for "
            "compiled programs, per-call for eager)",
            label_names=("op",)).labels(op_name)
        _child_cache[("calls", op_name)] = child
    return child


def _bytes_child(op_name):
    child = _child_cache.get(("bytes", op_name))
    if child is None:
        child = get_registry().counter(
            COLLECTIVE_BYTES, "Wire bytes moved by collective dispatches "
            "(COMPRESSED width when a wire format is active)",
            label_names=("op",)).labels(op_name)
        _child_cache[("bytes", op_name)] = child
    return child


def _logical_bytes_child(op_name):
    child = _child_cache.get(("logical", op_name))
    if child is None:
        child = get_registry().counter(
            COLLECTIVE_LOGICAL_BYTES,
            "Uncompressed (logical) bytes behind each collective dispatch; "
            "equals " + COLLECTIVE_BYTES + " when no wire compression is "
            "active — the per-op compression ratio is logical/wire",
            label_names=("op",)).labels(op_name)
        _child_cache[("logical", op_name)] = child
    return child


def _wire_dtype_children(dtype_name):
    pair = _child_cache.get(("wire_dtype", dtype_name))
    if pair is None:
        r = get_registry()
        pair = (
            r.counter(WIRE_BYTES,
                      "Bytes actually put on the interconnect per LOGICAL "
                      "payload dtype (wire payload + quantizer scales; "
                      "non-float leaves ride at full width)",
                      label_names=("dtype",)).labels(dtype_name),
            r.counter(WIRE_LOGICAL_BYTES,
                      "Uncompressed bytes of the same payloads, per "
                      "logical dtype",
                      label_names=("dtype",)).labels(dtype_name),
        )
        _child_cache[("wire_dtype", dtype_name)] = pair
    return pair


_ratio_gauge_installed = False


def _ensure_ratio_gauge():
    """``hvd_wire_compression_ratio``: cumulative logical/wire byte ratio
    across every collective dispatch (1.0 = nothing compressed). Derived
    at collect time from the two counter families so it can never drift
    from them."""
    global _ratio_gauge_installed
    if _ratio_gauge_installed:
        return
    r = get_registry()

    def _total(fam):
        if fam is None:
            return 0.0
        s = fam.sample()
        return sum(s.values()) if isinstance(s, dict) else float(s)

    def ratio():
        w = _total(r.get(COLLECTIVE_BYTES))
        lg = _total(r.get(COLLECTIVE_LOGICAL_BYTES))
        return (lg / w) if w > 0 else 1.0

    r.gauge(WIRE_COMPRESSION_RATIO,
            "Cumulative logical/wire byte ratio over all collective "
            "dispatches (1.0 = uncompressed)").set_function(ratio)
    _ratio_gauge_installed = True


def _bucket_children(kind):
    pair = _child_cache.get(("bucket", kind))
    if pair is None:
        r = get_registry()
        pair = (
            r.histogram(BUCKET_FILL_RATIO, "Used fraction of each fusion "
                        "bucket's padded size",
                        buckets=tuple(i / 10 for i in range(1, 11)),
                        label_names=("kind",)).labels(kind),
            r.histogram(BUCKET_DISPATCH_SECONDS,
                        "Host time to pack+dispatch one bucket collective",
                        label_names=("kind",)).labels(kind),
        )
        _child_cache[("bucket", kind)] = pair
    return pair


def record_collective(op_name, nbytes, logical_nbytes=None):
    """Per-op call count + wire bytes. Called from the collective
    dispatch functions, i.e. at TRACE time on the compiled path (the
    counts describe the collectives baked into each compiled program)
    and per call on the eager path — docs/OBSERVABILITY.md explains how
    to read the two.

    ``nbytes`` is what actually crosses the interconnect (COMPRESSED
    width when a wire format is active); ``logical_nbytes`` is the
    uncompressed payload behind it (defaults to ``nbytes``) — the
    compression ratio is derivable from the two counters, and
    ``hvd_wire_compression_ratio`` pre-derives the cumulative one."""
    _calls_child(op_name).inc()
    _bytes_child(op_name).inc(max(0, int(nbytes)))
    _logical_bytes_child(op_name).inc(
        max(0, int(nbytes if logical_nbytes is None else logical_nbytes)))
    _ensure_ratio_gauge()


def record_compiled_collective(op_name, calls, nbytes, logical_nbytes=None):
    """Account collectives read off a COMPILED module (the GSPMD path —
    ``parallel/gspmd.record_compiled_collectives``): there is no Python
    dispatch to count per call, so the whole module's per-op totals are
    recorded at once, in the same ``hvd_collective_*`` families the
    per-dispatch path uses. Recorded once per compile — like the
    trace-time counters, the numbers describe one compiled step."""
    _calls_child(op_name).inc(max(0, int(calls)))
    _bytes_child(op_name).inc(max(0, int(nbytes)))
    _logical_bytes_child(op_name).inc(
        max(0, int(nbytes if logical_nbytes is None else logical_nbytes)))
    _ensure_ratio_gauge()


def record_bucket(kind, fill_ratio, nbytes, dispatch_s=None,
                  logical_nbytes=None, dtype=None):
    """Bucketed reduce-scatter/all-gather pipeline instrumentation.
    ``nbytes`` is wire width, ``logical_nbytes`` uncompressed width, and
    ``dtype`` the bucket's LOGICAL dtype — feeding the per-dtype
    logical-vs-wire accounting (non-float buckets are never narrowed, so
    their two counters advance in lockstep)."""
    fill, dispatch = _bucket_children(kind)
    fill.observe(fill_ratio)
    wire = max(0, int(nbytes))
    logical = max(0, int(nbytes if logical_nbytes is None
                         else logical_nbytes))
    _bytes_child(f"bucket_{kind}").inc(wire)
    _logical_bytes_child(f"bucket_{kind}").inc(logical)
    if dtype is not None:
        w_child, l_child = _wire_dtype_children(str(dtype))
        w_child.inc(wire)
        l_child.inc(logical)
    _ensure_ratio_gauge()
    if dispatch_s is not None:
        dispatch.observe(dispatch_s)


def record_xray(summary, registry=None):
    """Mirror a compiled-step X-ray summary (``telemetry/xprof.py``)
    into the ``hvd_xray_*`` gauge family so the last capture's
    attribution rides every scrape: per-category device seconds (idle
    included), the bucketed-fraction honesty gate, and per-collective
    exposed seconds + effective exchange bandwidth. Gauges, not
    counters — each capture REPLACES the previous one's values (an
    X-ray is a snapshot of K steps, not a running total)."""
    r = registry if registry is not None else get_registry()
    dev = r.gauge(XRAY_DEVICE_SECONDS,
                  "Device time per op category over the last X-ray "
                  "capture (K compiled steps)",
                  label_names=("category",))
    for cat, sec in summary.get("device_seconds", {}).items():
        dev.labels(cat).set(sec)
    r.gauge(XRAY_BUCKETED_FRACTION,
            "Share of last-capture device time the X-ray classifier "
            "could name (1 - unattributed; gated at 0.95 by "
            "bench.py --spmd)").set(summary.get("bucketed_fraction", 0.0))
    exposed = r.gauge(XRAY_EXPOSED_SECONDS,
                      "Collective in-flight time NOT hidden behind "
                      "compute over the last X-ray capture",
                      label_names=("op",))
    gbps = r.gauge(XRAY_COLLECTIVE_GBPS,
                   "Effective exchange bandwidth per collective over "
                   "the last X-ray capture (aggregate HLO bytes / "
                   "in-flight seconds)",
                   label_names=("op",))
    for op, slot in summary.get("collectives", {}).items():
        exposed.labels(op).set(slot.get("exposed_seconds", 0.0))
        if "effective_gbps" in slot:
            gbps.labels(op).set(slot["effective_gbps"])


class CkptInstruments:
    """The checkpoint subsystem's four instruments, resolved once per
    ``AsyncCheckpointer``: end-to-end save latency (snapshot through
    manifest commit), the training-thread stall alone (snapshot + any
    in-flight-budget wait — the number the async design minimizes),
    cumulative shard bytes, and the current in-flight save count."""

    def __init__(self, registry=None):
        r = registry if registry is not None else get_registry()
        self.save_seconds = r.histogram(
            CKPT_SAVE_SECONDS,
            "End-to-end checkpoint save seconds (snapshot -> shard write "
            "-> manifest commit), overlapped with training")
        self.blocking_seconds = r.histogram(
            CKPT_BLOCKING_SECONDS,
            "Seconds the TRAINING thread was blocked per save (device->"
            "host snapshot + in-flight-budget wait)")
        self.bytes_written = r.counter(
            CKPT_BYTES_WRITTEN, "Checkpoint shard bytes written by this "
            "rank (serialized msgpack, pre-filesystem)")
        self.inflight = r.gauge(
            CKPT_INFLIGHT, "Checkpoint saves snapshotted but not yet "
            "manifest-committed")


def ckpt_instruments(registry=None):
    return CkptInstruments(registry)


class DataInstruments:
    """The prefetch loader's instruments (docs/DATA.md): the seconds the
    TRAINING thread blocked waiting for a batch (the number the prefetch
    design minimizes — in a healthy pipeline it is ~0 and step time is
    pure compute), the producer-side assembly+staging time per batch,
    the prefetch queue depth after each fetch (persistently 0 = the
    producer can't keep up; ~depth = compute-bound, the good case), and
    the cumulative batches / bytes staged onto device."""

    def __init__(self, registry=None):
        r = registry if registry is not None else get_registry()
        self.wait_seconds = r.histogram(
            DATA_WAIT_SECONDS,
            "Seconds the training thread blocked waiting for the next "
            "batch (0 when the prefetch queue had one ready)")
        self.load_seconds = r.histogram(
            DATA_LOAD_SECONDS,
            "Producer-thread seconds to assemble + stage one batch "
            "(source gather, host->device placement)")
        self.queue_depth = r.gauge(
            DATA_QUEUE_DEPTH,
            "Prefetched batches still queued right after a fetch "
            "(0 persistently = input-bound, ~depth = compute-bound)")
        self.bytes_staged = r.counter(
            DATA_BYTES_STAGED,
            "Cumulative bytes of batch data staged by the prefetch "
            "producer (host numpy width, pre-placement)")
        self.batches = r.counter(
            DATA_BATCHES, "Batches delivered to the training thread")


def data_instruments(registry=None):
    return DataInstruments(registry)


class ServeInstruments:
    """The inference server's request-level instruments: request
    lifecycle counts by event, generated-token throughput, scheduler
    queue depth, paged-KV pool occupancy, prefix-cache hits, and the two
    latencies a serving SLO is written against — time-to-first-token
    (arrival -> first streamed token: queueing + prefill) and inter-token
    latency (the steady-state decode cadence).

    ``replica`` labels the per-engine GAUGES (queue depth, KV
    occupancy): a fleet's replicas share one registry, and unlabeled
    gauges would clobber each other on every scheduler tick. Counters
    and histograms stay fleet-wide families."""

    def __init__(self, registry=None, replica="default"):
        r = registry if registry is not None else get_registry()
        self.registry = r
        self.replica = str(replica)
        self._requests = r.counter(
            SERVE_REQUESTS,
            "Generate requests by lifecycle event (submitted / "
            "completed / failed)", label_names=("event",))
        self.submitted = self._requests.labels("submitted")
        self.completed = self._requests.labels("completed")
        self.failed = self._requests.labels("failed")
        self.tokens = r.counter(
            SERVE_TOKENS, "Tokens generated and streamed to clients")
        self.cached_prefill_tokens = r.counter(
            SERVE_CACHED_PREFILL_TOKENS,
            "Prompt tokens whose prefill was skipped via prefix-cache "
            "block reuse (kvcache.PrefixCache)")
        self.queue_depth = r.gauge(
            SERVE_QUEUE_DEPTH,
            "Requests admitted-pending (queued behind KV blocks or "
            "batch slots), per engine replica",
            label_names=("replica",)).labels(self.replica)
        self.kv_blocks = r.gauge(
            SERVE_KV_BLOCKS, "Paged-KV pool blocks currently allocated "
            "to live sequences, per engine replica",
            label_names=("replica",)).labels(self.replica)
        self.ttft_seconds = r.histogram(
            SERVE_TTFT_SECONDS,
            "Time to first token: request arrival -> first streamed "
            "token (queueing + prefill)")
        self.ttft_admission_seconds = r.histogram(
            SERVE_TTFT_ADMISSION_SECONDS,
            "Time to first token from KV admission -> first streamed "
            "token (prefill only; the arrival-based histogram folds "
            "queue wait in, this one separates it)")
        self.inter_token_seconds = r.histogram(
            SERVE_INTER_TOKEN_SECONDS,
            "Gap between successive streamed tokens of one request "
            "(steady-state decode cadence)",
            buckets=(.001, .0025, .005, .01, .025, .05, .1, .25, .5,
                     1.0, 2.5))
        self.weight_swap_seconds = serve_weight_swap_histogram(r)


def serve_instruments(registry=None, replica="default"):
    return ServeInstruments(registry, replica=replica)


def serve_replicas_gauge(registry=None):
    """The one declaration of ``hvd_serve_replicas`` — fleet replica
    counts by state (``ready`` / ``draining`` / ``dead``), recorded by
    the fleet router (serve/fleet/router.py)."""
    r = registry if registry is not None else get_registry()
    return r.gauge(SERVE_REPLICAS,
                   "Serve-fleet replicas by state (ready / draining / "
                   "dead)", label_names=("state",))


def serve_redispatch_counter(registry=None):
    """The one declaration of ``hvd_serve_redispatch_total`` — streams
    cut by a replica eviction and continued on a survivor
    (serve/fleet/router.py zero-drop re-dispatch hops)."""
    r = registry if registry is not None else get_registry()
    return r.counter(
        SERVE_REDISPATCH_TOTAL,
        "Streams cut mid-generation and re-dispatched onto a surviving "
        "replica (each count is one hop)")


def serve_weight_swap_histogram(registry=None):
    """The one declaration of ``hvd_serve_weight_swap_seconds``, shared
    by the engine (in-step staged-swap application) and the router (the
    per-replica drain -> stage -> swap -> ready rolling-reload window) so
    both record into one family."""
    r = registry if registry is not None else get_registry()
    return r.histogram(
        SERVE_WEIGHT_SWAP_SECONDS,
        "Weight-swap stall windows: engine in-step staged-swap "
        "application and router per-replica rolling-reload "
        "(drain -> stage -> swap -> ready)",
        buckets=(.001, .005, .01, .05, .1, .5, 1.0, 5.0, 15.0, 60.0))


def build_info_labels(config=None):
    """The process's identity labels for ``hvd_build_info`` (and for the
    goodput report header): framework version, torch's version, CUDA's
    version, the device's name and the world size. Values degrade to
    "unknown" rather than raising — identity must never break startup."""
    def safe(fn):
        try:
            return str(fn())
        except Exception:
            return "unknown"

    def world():
        if config is not None and getattr(config, "size", None):
            return config.size
        return int(os.environ.get("HOROVOD_SIZE", "1"))

    def version():
        import horovod_tpu_torch
        return horovod_tpu_torch.__version__

    def torch_version():
        import torch
        return torch.__version__

    def cuda_version():
        import torch
        return torch.version.cuda or "none"

    def device():
        import torch
        if not torch.cuda.is_available():
            return "cpu"
        from horovod_tpu_torch import basics
        dev = (basics._state.mesh.device if basics._state.mesh is not None
               else torch.device("cuda", torch.cuda.current_device()))
        if dev.type != "cuda":
            return "cpu"
        return torch.cuda.get_device_name(dev)

    return {"version": safe(version), "torch": safe(torch_version),
            "cuda": safe(cuda_version), "device": safe(device),
            "world": safe(world)}


BUILD_INFO_LABELS = ("version", "torch", "cuda", "device", "world")


def build_info_gauge(config=None, registry=None):
    """Register the standard-practice ``hvd_build_info`` gauge: constant
    1 with the identity as labels, so every scrape (and every dump that
    embeds the labels) is self-describing."""
    r = registry if registry is not None else get_registry()
    labels = build_info_labels(config)
    g = r.gauge(BUILD_INFO,
                "Constant 1; the labels identify this build/process "
                "(framework version, torch version, CUDA version, device, "
                "world size)",
                label_names=BUILD_INFO_LABELS)
    g.labels(*(labels[k] for k in BUILD_INFO_LABELS)).set(1)
    return g


def stalled_ranks_gauge(registry=None):
    """The one declaration of ``hvd_stalled_ranks`` — the stall
    inspector records into it; ``runtime/services.py`` pre-registers it
    so scrapes expose 0 before (or without) an inspector."""
    r = registry if registry is not None else get_registry()
    return r.gauge(STALLED_RANKS,
                   "Ranks whose last progress is older than the stall "
                   "warning threshold")


def kv_snapshot(registry=None):
    """Compact per-rank snapshot for the elastic KV heartbeat path —
    just what the driver's cluster view needs (step progress, step-time
    quantiles, examples/sec, wire bytes), a few hundred bytes riding a
    channel that already exists."""
    r = registry if registry is not None else get_registry()
    out = {}
    steps = r.get(STEP_TOTAL)
    if steps is not None:
        out["step"] = steps.value
    hist = r.get(STEP_SECONDS)
    if hist is not None and hist.count:
        out["step_seconds_p50"] = hist.quantile(0.5)
        out["step_seconds_p90"] = hist.quantile(0.9)
    eps = r.get(EXAMPLES_PER_SEC)
    if eps is not None:
        out["examples_per_sec"] = eps.value
    cbytes = r.get(COLLECTIVE_BYTES)
    if cbytes is not None:
        sample = cbytes.sample()
        if isinstance(sample, dict):
            out["collective_bytes"] = sum(sample.values())
    # the goodput ledger's phase totals (telemetry/ledger.py) ride the
    # same heartbeat so the driver's cluster_view can aggregate a live
    # fleet-wide goodput gauge — nonzero phases only, rounded compact
    tsec = r.get(TIME_SECONDS)
    if tsec is not None:
        sample = tsec.sample()
        if isinstance(sample, dict):
            phases = {lv[0]: round(v, 3) for lv, v in sample.items()
                      if v > 0}
            if phases:
                out["goodput"] = phases
    return out


def _compile_children(registry=None):
    r = registry if registry is not None else get_registry()
    return (r.counter(COMPILE_CACHE_HITS,
                      "jax compilation-cache hits this process"),
            r.counter(COMPILE_CACHE_MISSES,
                      "jax compilation-cache misses this process"),
            r.counter(COMPILE_SECONDS,
                      "Cumulative seconds spent in XLA compilation"))


def install_compile_listeners():
    """Register the compile families so a scrape shows them at zero
    before anything compiled. The JAX package listens to
    ``jax.monitoring`` here; the port has no XLA compile, and its
    compile-time sources call :func:`record_compile` themselves.
    Idempotent."""
    _compile_children()


def record_compile(seconds, cache_hit=False):
    """Book ``seconds`` of the port's compile time: the CUDA kernels'
    build (or the load of a cached build) at first use, or a GSPMD
    step's first call of a batch signature. A cache hit counts a hit,
    anything else a miss; positive seconds go to
    ``hvd_compile_seconds_total`` and the goodput ledger's ``compile``
    phase. Help texts are the JAX package's, so both packages' families
    carry one description."""
    hits, misses, compile_s = _compile_children()
    (hits if cache_hit else misses).inc()
    if seconds > 0:
        compile_s.inc(seconds)
        from horovod_tpu_torch.telemetry import ledger as ledger_lib
        ledger_lib.get_ledger().charge("compile", seconds)
