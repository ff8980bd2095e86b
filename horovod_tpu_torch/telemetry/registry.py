"""Rank-local metrics registry: counters, gauges, histograms.

The port of ``horovod_tpu/telemetry/registry.py``, the same code: the
same sequence of operations renders the same Prometheus text, byte for
byte, so one dashboard reads both packages' ranks.

The reference exposes job health through four disconnected channels (the
coordinator Timeline, the stall inspector's log lines, the autotuner CSV,
and whatever the user's own loop prints). This registry is the single
substrate they all feed here: every subsystem records into process-local
metric objects, and the same data leaves the process three ways —

* the Prometheus text endpoint (``telemetry/server.py``),
* compact snapshots on the elastic KV heartbeat path
  (``elastic/worker.py`` -> ``elastic/driver.py`` cluster view),
* Chrome-trace counter events (``utils/timeline.py`` "C" phase).

Hot-path discipline: recording a sample is a lock acquire + a float add
(counters/gauges) or a bisect into STATIC bucket bounds plus one slot
write into a PREALLOCATED reservoir (histograms). No dicts, lists, or
strings are allocated per observation; label children are resolved once
at instrument-creation time and cached by the caller.
"""

import bisect
import math
import threading

# Default latency buckets (seconds): 1 ms .. ~107 s, x2 per bucket —
# wide enough for both a step (ms) and an elastic recovery (tens of s).
DEFAULT_BUCKETS = tuple(0.001 * (2 ** i) for i in range(18))


def _fmt(v):
    """Prometheus float formatting: integers bare, +Inf spelled."""
    if v == math.inf:
        return "+Inf"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(float(v))


def _fmt_labels(names, values):
    if not names:
        return ""
    inner = ",".join(
        '%s="%s"' % (n, str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for n, v in zip(names, values))
    return "{" + inner + "}"


class _Metric:
    """Common base: a named family with optional label dimensions.

    A family with labels holds one child per label-value tuple; a family
    without labels is its own single child. ``labels(...)`` is meant to be
    called ONCE at instrument-creation time (the returned child is the
    zero-allocation handle the hot path keeps)."""

    kind = "untyped"

    def __init__(self, name, help="", label_names=()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._children = {}  # label values tuple -> child

    def labels(self, *values):
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {values!r}")
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._new_child()
                self._children[key] = child
            return child

    def _self_child(self):
        """The label-less singleton child."""
        if self.label_names:
            raise ValueError(
                f"{self.name} has labels {self.label_names}; use .labels()")
        return self.labels()

    def _each(self):
        with self._lock:
            return list(self._children.items())


class Counter(_Metric):
    """Monotonically increasing count (Prometheus counter)."""

    kind = "counter"

    class _Child:
        __slots__ = ("_lock", "value")

        def __init__(self):
            self._lock = threading.Lock()
            self.value = 0.0

        def inc(self, n=1.0):
            if n < 0:
                raise ValueError("counters only go up")
            with self._lock:
                self.value += n

    def _new_child(self):
        return Counter._Child()

    def inc(self, n=1.0):
        self._self_child().inc(n)

    @property
    def value(self):
        return self._self_child().value

    def render(self, out, name=None):
        name = name or self.name
        for lv, child in self._each():
            out.append("%s%s %s" % (name,
                                    _fmt_labels(self.label_names, lv),
                                    _fmt(child.value)))

    def sample(self):
        if not self.label_names:
            return self.value
        return {lv: c.value for lv, c in self._each()}


class Gauge(_Metric):
    """Point-in-time value. ``set_function`` registers a collect-time
    callback — the trick that lets a gauge report a value living in a
    device array (last loss, last grad-norm) WITHOUT forcing a host sync
    on the training hot path: the readback happens when something
    scrapes, not when the step runs."""

    kind = "gauge"

    class _Child:
        __slots__ = ("_lock", "_value", "_fn")

        def __init__(self):
            self._lock = threading.Lock()
            self._value = 0.0
            self._fn = None

        def set(self, v):
            with self._lock:
                self._value = float(v)
                self._fn = None

        def inc(self, n=1.0):
            with self._lock:
                self._value += n

        def dec(self, n=1.0):
            self.inc(-n)

        def set_function(self, fn):
            with self._lock:
                self._fn = fn

        @property
        def value(self):
            with self._lock:
                fn = self._fn
                if fn is None:
                    return self._value
            try:
                return float(fn())
            except Exception:
                return float("nan")

    def _new_child(self):
        return Gauge._Child()

    def set(self, v):
        self._self_child().set(v)

    def inc(self, n=1.0):
        self._self_child().inc(n)

    def dec(self, n=1.0):
        self._self_child().dec(n)

    def set_function(self, fn):
        self._self_child().set_function(fn)

    @property
    def value(self):
        return self._self_child().value

    def render(self, out, name=None):
        name = name or self.name
        for lv, child in self._each():
            out.append("%s%s %s" % (name,
                                    _fmt_labels(self.label_names, lv),
                                    _fmt(child.value)))

    def sample(self):
        if not self.label_names:
            return self.value
        return {lv: c.value for lv, c in self._each()}


class Histogram(_Metric):
    """Prometheus histogram (cumulative static buckets + _sum/_count)
    with a bounded reservoir for quantile estimates in snapshots.

    The reservoir is PREALLOCATED and overwritten in place (algorithm R:
    after it fills, sample i replaces a uniformly random slot with
    probability size/i) — observing never allocates, and the snapshot's
    p50/p90 stay representative of the whole run, not just the tail."""

    kind = "histogram"

    def __init__(self, name, help="", label_names=(),
                 buckets=DEFAULT_BUCKETS, reservoir_size=256):
        super().__init__(name, help, label_names)
        self._buckets = tuple(sorted(buckets))
        self._reservoir_size = reservoir_size

    class _Child:
        __slots__ = ("_lock", "bounds", "counts", "sum", "count",
                     "_res", "_res_n", "_rng")

        def __init__(self, bounds, reservoir_size):
            import random
            self._lock = threading.Lock()
            self.bounds = bounds
            self.counts = [0] * (len(bounds) + 1)  # +1 for +Inf
            self.sum = 0.0
            self.count = 0
            self._res = [0.0] * reservoir_size
            self._res_n = 0
            self._rng = random.Random(0x5EED)

        def observe(self, v):
            v = float(v)
            with self._lock:
                self.counts[bisect.bisect_left(self.bounds, v)] += 1
                self.sum += v
                self.count += 1
                n, size = self._res_n, len(self._res)
                if n < size:
                    self._res[n] = v
                else:
                    j = self._rng.randrange(n + 1)
                    if j < size:
                        self._res[j] = v
                self._res_n = n + 1

        def quantile(self, q):
            with self._lock:
                n = min(self._res_n, len(self._res))
                if not n:
                    return 0.0
                vals = sorted(self._res[:n])
            return vals[min(int(q * n), n - 1)]

    def _new_child(self):
        return Histogram._Child(self._buckets, self._reservoir_size)

    def observe(self, v):
        self._self_child().observe(v)

    @property
    def count(self):
        return self._self_child().count

    @property
    def sum(self):
        return self._self_child().sum

    def quantile(self, q):
        return self._self_child().quantile(q)

    def render(self, out, name=None):
        name = name or self.name
        for lv, child in self._each():
            with child._lock:
                counts = list(child.counts)
                total, s = child.count, child.sum
            cum = 0
            for bound, c in zip(child.bounds, counts):
                cum += c
                lv_le = lv + (_fmt(bound),)
                out.append("%s_bucket%s %d" % (
                    name,
                    _fmt_labels(self.label_names + ("le",), lv_le), cum))
            out.append("%s_bucket%s %d" % (
                name,
                _fmt_labels(self.label_names + ("le",), lv + ("+Inf",)),
                total))
            out.append("%s_sum%s %s" % (
                name, _fmt_labels(self.label_names, lv), _fmt(s)))
            out.append("%s_count%s %d" % (
                name, _fmt_labels(self.label_names, lv), total))

    def sample(self):
        def one(child):
            return {"count": child.count, "sum": child.sum,
                    "p50": child.quantile(0.50),
                    "p90": child.quantile(0.90),
                    "max": child.quantile(1.0)}
        if not self.label_names:
            return one(self._self_child())
        return {lv: one(c) for lv, c in self._each()}


class MetricsRegistry:
    """Name -> metric family. Creation is get-or-create so subsystems can
    declare the same instrument independently; a kind/label mismatch on
    an existing name is a programming error and raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}
        self._aliases = {}  # canonical name -> deprecated scrape alias

    def install_aliases(self, aliases):
        """Serve each canonical family under a deprecated name too
        (scrape-time only: snapshots and heartbeats stay canonical).
        The one-release migration path for the ``horovod_*`` ->
        ``hvd_*`` rename (docs/OBSERVABILITY.md deprecation note)."""
        with self._lock:
            self._aliases.update(aliases)

    def _get_or_create(self, cls, name, help, label_names, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or \
                        m.label_names != tuple(label_names):
                    raise ValueError(
                        f"metric {name!r} re-registered as {cls.__name__} "
                        f"labels={tuple(label_names)} but exists as "
                        f"{type(m).__name__} labels={m.label_names}")
                return m
            m = cls(name, help=help, label_names=label_names, **kwargs)
            if not m.label_names:
                m._self_child()  # a zero-valued family must still render
            self._metrics[name] = m
            return m

    def counter(self, name, help="", label_names=()):
        return self._get_or_create(Counter, name, help, label_names)

    def gauge(self, name, help="", label_names=()):
        return self._get_or_create(Gauge, name, help, label_names)

    def histogram(self, name, help="", label_names=(),
                  buckets=DEFAULT_BUCKETS, reservoir_size=256):
        return self._get_or_create(Histogram, name, help, label_names,
                                   buckets=buckets,
                                   reservoir_size=reservoir_size)

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def unregister(self, name):
        with self._lock:
            self._metrics.pop(name, None)

    def clear(self):
        with self._lock:
            self._metrics.clear()

    def render_prometheus(self):
        """The Prometheus text exposition format (version 0.0.4).
        Aliased families render twice: canonically, then under the
        deprecated name with a HELP line pointing migrations at the
        canonical one."""
        with self._lock:
            metrics = sorted(self._metrics.items())
            aliases = dict(self._aliases)
        lines = []
        for name, m in metrics:
            if m.label_names and not m._each():
                # A labelled family with no children yet would emit a
                # HELP/TYPE header with zero sample lines — invalid for
                # strict expfmt parsers. Unlabelled families always have
                # their self-child, so they still render at zero.
                continue
            if m.help:
                lines.append("# HELP %s %s" % (
                    name, m.help.replace("\\", "\\\\").replace("\n", " ")))
            lines.append("# TYPE %s %s" % (name, m.kind))
            m.render(lines)
        for name, m in metrics:
            legacy = aliases.get(name)
            if legacy is None:
                continue
            if m.label_names and not m._each():
                continue
            lines.append("# HELP %s DEPRECATED alias of %s; the "
                         "horovod_* names are removed next release"
                         % (legacy, name))
            lines.append("# TYPE %s %s" % (legacy, m.kind))
            m.render(lines, name=legacy)
        return "\n".join(lines) + "\n"

    def snapshot(self):
        """Plain-dict view of every metric: counters/gauges -> float,
        histograms -> {count, sum, p50, p90, max}. Labelled families map
        'name{a=x,b=y}' -> value. This is what rides the elastic KV
        heartbeats and the BENCH json ``telemetry`` block."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        out = {}
        for name, m in metrics:
            s = m.sample()
            if m.label_names and isinstance(s, dict):
                for lv, v in s.items():
                    key = name + _fmt_labels(m.label_names, lv)
                    out[key] = v
            else:
                out[name] = s
        return out


_default = MetricsRegistry()


def get_registry():
    """The process-wide default registry (every built-in instrument
    records here)."""
    return _default
