"""Step X-ray: device-trace time attribution over ``torch.profiler``
captures.

The port of ``horovod_tpu/telemetry/xprof.py``. The host-side planes see
a step as one lump (the goodput ledger books it as ``compute``); this
module answers "where did the device's time go" from the framework's own
captures. What it keeps from the JAX module: the categories
(:data:`CATEGORIES`), the honesty gate (:data:`BUCKETED_GATE` 0.95), the
verdicts and their thresholds, innermost-wins self time,
:func:`attribute`, :func:`verdict`, :func:`join_collective_bytes`,
:func:`find_capture`, :func:`xray_run`, and the capture layout
(``<dir>/plugins/profile/<timestamp>/<host>.trace.json.gz``), so that
``hvd-doctor-torch xray <dir>``, like JAX's ``hvd-doctor xray``, reads a
directory of either package.

What changes is where device lanes are found and how events are named,
since a torch trace is not an XLA one:

* **On the card** a device lane is a ``(pid, tid)`` lane of events whose
  ``cat`` is ``kernel``, ``gpu_memcpy`` or ``gpu_memset``: one lane a
  CUDA stream. ``gpu_user_annotation`` events sit on those lanes too,
  but they are host ranges projected onto a stream, not device work, and
  they nest around kernels: kept in a lane, innermost-wins self time
  would book the gaps between kernels to them. They are left out.
* **On the CPU** (the tests) a torch trace has no device lanes; the
  counterpart of XLA:CPU's executor lanes is the lanes of ``cpu_op``
  events, whose nested ``aten::`` calls resolve by the same
  innermost-wins self time. ``python_function`` and ``user_annotation``
  events stay host.
* **Names** go through one table, :func:`event_category`:

  ============================================  ====================
  event (``cat``: name)                          category
  ============================================  ====================
  ``kernel``: ``ncclDevKernel_*``,               its collective
  ``ncclKernel_*``; ``cpu_op``: ``c10d::*``,     (``gspmd.collective_kind``)
  ``_c10d_functional::*``
  ``kernel``: ``nvjet*``, ``sm90_xmma*``,        ``matmul_conv``
  ``*gemm*``, ``cutlass*``, ``*cudnn*``,
  ``*conv*``
  ``cpu_op``: ``aten::mm``, ``addmm``, ``bmm``,  ``matmul_conv``
  ``baddbmm``, ``addbmm``, ``convolution``,
  ``_convolution``, ``mkldnn_convolution``
  ``kernel``: ``triton_*`` (Inductor's fused     ``fusion``
  kernels)
  ``gpu_memcpy``, ``gpu_memset``; ``cpu_op``:    ``copy``
  ``aten::copy_``, ``aten::_to_copy``
  any other ``kernel`` (K1-K3's                  ``other_op``
  ``flash_*_sm90*``, torch's elementwise,
  reduction and foreach kernels) or ``cpu_op``
  ``gpu_user_annotation``, ``user_annotation``,  not device work: no
  ``python_function``                            lane
  anything else on a device lane                 ``unattributed``
  ============================================  ====================

  There is no catch-all: an event of a lane that is neither a kernel, a
  copy nor an operator stays ``unattributed`` and pulls the gate down.
  (``runtime`` keeps its place in the table; no torch event lands
  there.)

Captures are taken around whole steps, on the thread that runs them:
torch's profiler records CPU operators only on the thread that enabled
it, so a capture started on the metrics server's thread would see no
lanes on the CPU. :func:`xray_run` wraps K steps itself; the server's
``/profile?seconds=N`` opens a :class:`ProfileWindow` that the step
wrappers (``training.py``) open at the next step's start and close at
the end of the first step past N seconds.
"""

import glob
import gzip
import json
import logging
import os
import re
import socket
import threading
import time

from horovod_tpu_torch.parallel.gspmd import (COLLECTIVE_OPS,
                                              collective_kind,
                                              collective_label)

logger = logging.getLogger("horovod_tpu_torch")

# every category a device-lane second can land in (idle is derived —
# window minus busy — but reported in the same table)
COLLECTIVE_CATEGORIES = tuple(collective_label(op)
                              for op in COLLECTIVE_OPS)
CATEGORIES = COLLECTIVE_CATEGORIES + (
    "matmul_conv", "fusion", "other_op", "copy", "runtime",
    "unattributed", "idle")

# categories whose intervals count as "compute the scheduler can hide a
# collective behind" for the exposed-vs-overlapped split
COMPUTE_CATEGORIES = ("matmul_conv", "fusion", "other_op")

# a capture whose named share of device time is below this fails
BUCKETED_GATE = 0.95

# the trace categories of device work on the card, and of operators on
# the CPU
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CPU_OP_CAT = "cpu_op"
# host ranges that ride a device or operator lane without being work
HOST_CATS = ("gpu_user_annotation", "user_annotation", "python_function")

_MATMUL_KERNEL = re.compile(
    r"^nvjet|^sm\d+_xmma|xmma_|gemm|cutlass|cudnn|conv(?!ert)")
_MATMUL_OPS = ("mm", "addmm", "bmm", "baddbmm", "addbmm", "convolution",
               "_convolution", "mkldnn_convolution")
_COPY_OPS = ("copy_", "_to_copy")

SUMMARY_PREFIX = "xray.rank"
VERDICTS = ("comms-bound", "compute-bound", "overlap-broken",
            "copy-bound", "idle-bound", "empty-capture")

# verdict thresholds, as fractions of total attributed device time
# (self time + idle) — the JAX package's
EXPOSED_COMMS_BOUND = 0.25   # exposed collective time alone
OVERLAP_BROKEN_COLL = 0.10   # collective window share where ...
OVERLAP_BROKEN_EXPOSED = 0.5 # ... this share of it being exposed is broken
COPY_BOUND = 0.15
IDLE_BOUND = 0.35


def _kind(name):
    """A collective kind of a kernel or operator name: NCCL's kernels as
    they are, torch's operators with ``::`` read as ``.``."""
    kind, _edge = collective_kind(name)
    if kind is None and "::" in name:
        kind, _edge = collective_kind(name.replace("::", "."))
    return kind


def event_category(name, cat):
    """The category of one trace event (the table in the module
    docstring), or None for a host range that is no device work."""
    if cat in HOST_CATS:
        return None
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "copy"
    if cat == "kernel":
        kind = _kind(name)
        if kind is not None:
            return collective_label(kind)
        bare = name[5:] if name.startswith("void ") else name
        if _MATMUL_KERNEL.search(bare.lower()):
            return "matmul_conv"
        if bare.startswith("triton_"):
            return "fusion"
        return "other_op"
    if cat == CPU_OP_CAT:
        kind = _kind(name)
        if kind is not None:
            return collective_label(kind)
        op = name.split("::", 1)[1] if "::" in name else name
        if op in _MATMUL_OPS:
            return "matmul_conv"
        if op in _COPY_OPS:
            return "copy"
        return "other_op"
    return "unattributed"


# -- trace loading -----------------------------------------------------------

def load_trace_file(path):
    """One Chrome trace (gz or plain) → its ``traceEvents`` list.
    Torn/truncated captures raise ``ValueError`` with the path."""
    try:
        if path.endswith(".gz"):
            with gzip.open(path, "rt") as f:
                doc = json.load(f)
        else:
            with open(path) as f:
                doc = json.load(f)
    except (OSError, EOFError, json.JSONDecodeError) as e:
        raise ValueError(f"unreadable trace {path}: {e}") from e
    events = doc.get("traceEvents") if isinstance(doc, dict) else None
    if not isinstance(events, list):
        raise ValueError(f"{path} has no traceEvents list")
    return events


def find_capture(profile_dir):
    """The NEWEST capture under ``profile_dir`` and its trace files:
    ``plugins/profile/<timestamp>/<host>.trace.json.gz`` per capture.
    Returns ``(run_dir, [paths])`` or ``(None, [])`` when nothing was
    captured. ``profile_dir`` may also BE a run dir (or hold loose
    ``*.trace.json`` files)."""
    runs = sorted(glob.glob(os.path.join(
        glob.escape(profile_dir), "plugins", "profile", "*")))
    candidates = ([r for r in runs if os.path.isdir(r)] or [profile_dir])
    for run in reversed(candidates):
        paths = sorted(
            glob.glob(os.path.join(glob.escape(run), "*.trace.json.gz"))
            + glob.glob(os.path.join(glob.escape(run), "*.trace.json")))
        if paths:
            return run, paths
    return None, []


# -- attribution -------------------------------------------------------------

def _merge_intervals(intervals):
    """Sorted union of ``[(start, end)]`` — total covered length is
    ``sum(e - s)`` of the result."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _overlap_seconds(window, merged):
    """Length of ``window ∩ merged`` (merged = sorted disjoint)."""
    lo, hi = window
    covered = 0.0
    for s, e in merged:
        if e <= lo:
            continue
        if s >= hi:
            break
        covered += min(e, hi) - max(s, lo)
    return covered


def _self_times(lane_events):
    """Innermost-wins self time per event of ONE lane: each event's
    duration minus the spans of events nested inside it (an
    ``aten::linear`` must not double-count the ``aten::addmm`` it ran).
    Partial overlaps are clipped to the enclosing span. Returns
    ``[(event, self_s)]``."""
    evs = sorted(lane_events, key=lambda e: (e["ts"], -e["dur"]))
    out = []
    stack = []  # indices into out, open ancestry
    for ev in evs:
        start, end = ev["ts"], ev["ts"] + ev["dur"]
        while stack and out[stack[-1]][0]["ts"] + \
                out[stack[-1]][0]["dur"] <= start:
            stack.pop()
        if stack:
            parent = out[stack[-1]]
            p_end = parent[0]["ts"] + parent[0]["dur"]
            parent[1] -= max(0.0, min(end, p_end) - start)
        out.append([ev, float(ev["dur"])])
        stack.append(len(out) - 1)
    return [(ev, max(0.0, s)) for ev, s in out]


def _device_lanes(events):
    """Group raw trace events into device lanes: the ``(pid, tid)`` lanes
    holding ``kernel``/``gpu_memcpy``/``gpu_memset`` events when the
    trace has any (the card), else the lanes holding ``cpu_op`` events
    (the CPU). Host ranges (:data:`HOST_CATS`) are dropped from them.
    Returns ``{(pid, tid): [event]}`` with events normalized to ``{ts,
    dur, name, cat}`` in SECONDS."""
    lanes = {}
    kinds = {}
    for e in events:
        if not e or not isinstance(e, dict):
            continue  # profilers emit empty tail elements; torn dumps
        if e.get("ph") != "X" or "ts" not in e:
            continue
        try:
            ts = float(e["ts"]) * 1e-6
            dur = float(e.get("dur", 0.0)) * 1e-6
        except (TypeError, ValueError):
            continue
        key = (e.get("pid"), e.get("tid"))
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            kinds.setdefault(key, set()).add("device")
        elif cat == CPU_OP_CAT:
            kinds.setdefault(key, set()).add("cpu")
        lanes.setdefault(key, []).append(
            {"ts": ts, "dur": max(0.0, dur),
             "name": str(e.get("name", "")), "cat": cat})
    mark = ("device" if any("device" in k for k in kinds.values())
            else "cpu")
    return {key: [ev for ev in lane if ev["cat"] not in HOST_CATS]
            for key, lane in lanes.items()
            if mark in kinds.get(key, ())}


def _collective_windows(lane):
    """In-flight windows ``[(kind, start, end)]`` of one lane: a
    collective's window is its event's span (NCCL's kernels and torch's
    collective operators have no async start/done pair)."""
    out = []
    for ev in lane:
        kind = _kind(ev["name"])
        if kind is not None and event_category(ev["name"],
                                               ev["cat"]) is not None:
            out.append((kind, ev["ts"], ev["ts"] + ev["dur"]))
    return sorted(out, key=lambda w: w[1])


def attribute(events, steps=None):
    """The X-ray summary of one capture's raw trace events (every host
    file concatenated): per-category device self-time, idle, the
    exposed-vs-overlapped split per collective kind, and the
    ``bucketed_fraction`` honesty gate. Pure function — the synthetic-
    fixture tests drive it without a profiler run."""
    lanes = _device_lanes(events)
    categories = {c: 0.0 for c in CATEGORIES}
    compute_intervals = []
    busy_intervals = []
    windows = []
    span_lo, span_hi = None, None
    for lane in lanes.values():
        for ev, self_s in _self_times(lane):
            cat = event_category(ev["name"], ev["cat"])
            categories[cat] += self_s
            end = ev["ts"] + ev["dur"]
            busy_intervals.append((ev["ts"], end))
            if cat in COMPUTE_CATEGORIES:
                compute_intervals.append((ev["ts"], end))
            span_lo = ev["ts"] if span_lo is None else min(span_lo,
                                                           ev["ts"])
            span_hi = end if span_hi is None else max(span_hi, end)
        windows.extend(_collective_windows(lane))
    window_seconds = (span_hi - span_lo) if span_lo is not None else 0.0
    busy = _merge_intervals(busy_intervals)
    busy_seconds = sum(e - s for s, e in busy)
    idle = max(0.0, window_seconds - busy_seconds)
    categories["idle"] = idle
    compute = _merge_intervals(compute_intervals)

    collectives = {}
    for kind, s, e in windows:
        slot = collectives.setdefault(collective_label(kind), {
            "seconds": 0.0, "exposed_seconds": 0.0,
            "overlapped_seconds": 0.0, "events": 0})
        dur = max(0.0, e - s)
        hidden = _overlap_seconds((s, e), compute)
        slot["seconds"] += dur
        slot["overlapped_seconds"] += hidden
        slot["exposed_seconds"] += max(0.0, dur - hidden)
        slot["events"] += 1

    total = sum(categories.values())
    bucketed = ((total - categories["unattributed"]) / total
                if total > 0 else 0.0)
    summary = {
        "xray": 1,
        "device_lanes": len(lanes),
        "window_seconds": round(window_seconds, 9),
        "busy_seconds": round(busy_seconds, 9),
        "device_seconds": {c: round(s, 9)
                           for c, s in categories.items()},
        "bucketed_fraction": round(bucketed, 6),
        "unattributed_seconds": round(categories["unattributed"], 9),
        "collectives": {k: {f: (round(v, 9) if f != "events" else v)
                            for f, v in slot.items()}
                        for k, slot in sorted(collectives.items())},
    }
    if steps is not None:
        summary["steps"] = int(steps)
    summary["verdict"] = verdict(summary)
    return summary


def verdict(summary):
    """Name the step's dominant sink from an attribution summary (the
    JAX package's rules and thresholds):

    * ``comms-bound``    — exposed collective time ≥ 25% of device time;
    * ``overlap-broken`` — collectives take ≥ 10% of device time and
      over half of it is exposed;
    * ``copy-bound``     — host↔device copies ≥ 15%;
    * ``idle-bound``     — no device lane busy ≥ 35% of the window (the
      host is not feeding the device);
    * ``compute-bound``  — none of the above;
    * ``empty-capture``  — no device events parsed at all."""
    cats = summary["device_seconds"]
    total = sum(cats.values())
    if total <= 0 or summary["device_lanes"] == 0:
        return "empty-capture"
    coll_total = sum(c["seconds"]
                     for c in summary["collectives"].values())
    exposed = sum(c["exposed_seconds"]
                  for c in summary["collectives"].values())
    if exposed / total >= EXPOSED_COMMS_BOUND:
        return "comms-bound"
    if coll_total / total >= OVERLAP_BROKEN_COLL \
            and coll_total > 0 \
            and exposed / coll_total >= OVERLAP_BROKEN_EXPOSED:
        return "overlap-broken"
    if cats.get("copy", 0.0) / total >= COPY_BOUND:
        return "copy-bound"
    if cats.get("idle", 0.0) / total >= IDLE_BOUND:
        return "idle-bound"
    return "compute-bound"


def dominant_sink(summary):
    """The largest device-time category of a summary —
    ``(category, seconds)``."""
    cats = {c: s for c, s in summary["device_seconds"].items() if s > 0}
    if not cats:
        return None, 0.0
    cat = max(cats, key=cats.get)
    return cat, cats[cat]


def join_collective_bytes(summary, compiled_collectives, steps=None):
    """Join per-collective device time against the step's byte
    accounting (``step.compiled_collectives``: ``{kind: {"calls",
    "bytes"}}``): each kind gains ``bytes_per_step`` and
    ``effective_gbps`` — aggregate bytes moved across all device lanes
    over the captured steps, divided by aggregate in-flight seconds. The
    byte keys accept raw op names and ``spmd_``-prefixed labels."""
    if not compiled_collectives:
        return summary
    steps = steps if steps is not None else summary.get("steps") or 1
    lanes = max(1, summary.get("device_lanes", 1))
    by_label = {}
    for op, tot in compiled_collectives.items():
        name = op[5:] if op.startswith("spmd_") else op
        kind, _ = collective_kind(name)
        if kind is None:  # telemetry labels are underscore-form
            kind, _ = collective_kind(name.replace("_", "-"))
        if kind is None:
            continue
        slot = by_label.setdefault(collective_label(kind), 0)
        by_label[collective_label(kind)] = slot + int(
            tot.get("bytes", 0) if isinstance(tot, dict) else tot)
    for label, slot in summary["collectives"].items():
        nbytes = by_label.get(label)
        if nbytes is None:
            continue
        slot["bytes_per_step"] = nbytes
        if slot["seconds"] > 0:
            slot["effective_gbps"] = round(
                nbytes * steps * lanes / slot["seconds"] / 1e9, 3)
    return summary


# -- capture orchestration ---------------------------------------------------

def analyze_capture(profile_dir, steps=None):
    """Parse the newest capture under ``profile_dir`` into an attribution
    summary (all host trace files concatenated). Raises ``ValueError``
    when no capture exists or every file is torn."""
    run, paths = find_capture(profile_dir)
    if not paths:
        raise ValueError(f"no trace capture under {profile_dir} "
                         "(expected plugins/profile/<run>/"
                         "*.trace.json[.gz])")
    events, errors = [], []
    for p in paths:
        try:
            events.extend(load_trace_file(p))
        except ValueError as e:
            errors.append(str(e))
    if not events and errors:
        raise ValueError("; ".join(errors))
    summary = attribute(events, steps=steps)
    summary["capture_dir"] = run
    if errors:
        summary["torn_files"] = errors
    return summary


def _on_card():
    import torch
    if not torch.cuda.is_available():
        return False
    from horovod_tpu_torch import basics
    mesh = basics._state.mesh
    return mesh is None or mesh.device.type == "cuda"


def start_profiler(on_card=None):
    """A started ``torch.profiler.profile``: CUDA activity on the card
    (the kernels, copies and memsets; host operators would slow the
    host and inflate the device's idle share), CPU operators on the
    CPU. Call on the thread that runs the steps."""
    from torch.profiler import ProfilerActivity, profile
    on_card = _on_card() if on_card is None else on_card
    prof = profile(activities=[ProfilerActivity.CUDA if on_card
                               else ProfilerActivity.CPU])
    prof.__enter__()
    prof.hvd_on_card = on_card
    return prof


def stop_profiler(prof, profile_dir):
    """Synchronize the card, stop ``prof`` and export its trace into a
    new capture directory, ``<profile_dir>/plugins/profile/<timestamp>/
    <host>.trace.json.gz``. Returns the run directory."""
    import torch
    if prof.hvd_on_card:
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    stamp = time.strftime("%Y_%m_%d_%H_%M_%S") + \
        "_%06d" % (time.time_ns() // 1000 % 1_000_000)
    run = os.path.join(profile_dir, "plugins", "profile", stamp)
    os.makedirs(run, exist_ok=True)
    raw = os.path.join(run, f".{socket.gethostname()}.trace.json")
    prof.export_chrome_trace(raw)
    out = os.path.join(run, f"{socket.gethostname()}.trace.json.gz")
    with open(raw, "rb") as src, gzip.open(out, "wb") as dst:
        dst.write(src.read())
    os.remove(raw)
    return run


def capture_steps(run_once, steps, profile_dir):
    """Run ``run_once(i)`` K times inside one capture into
    ``profile_dir``, each iteration forced to completion
    (``torch.cuda.synchronize`` on the card) so the device lanes hold
    exactly the K steps. Returns the last result."""
    import torch
    out = None
    prof = start_profiler()
    try:
        for i in range(steps):
            out = run_once(i)
            if prof.hvd_on_card:
                torch.cuda.synchronize()
    finally:
        stop_profiler(prof, profile_dir)
    return out


def write_summary(summary, directory, rank=0):
    """Atomically drop ``xray.rank<r>.json`` into ``directory`` — the
    artifact ``hvd-doctor-torch xray <dir>`` aggregates."""
    payload = dict(summary)
    payload["rank"] = int(rank)
    path = os.path.join(directory, f"{SUMMARY_PREFIX}{int(rank)}.json")
    try:
        os.makedirs(directory, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
    except OSError:
        logger.warning("xray: summary dump to %s failed", path,
                       exc_info=True)
        return None
    return path


def _rank():
    from horovod_tpu_torch import basics
    return basics._state.config.rank if basics._state.initialized else 0


def xray_run(step_fn, step_args, k=3, profile_dir=None,
             compiled_collectives=None, rank=None):
    """The ``step.xray(k)`` engine: one warm call OUTSIDE the capture (a
    first batch signature's accounting call, a first kernel build), then
    K captured steps, parse, join bytes, record the ``hvd_xray_*``
    gauges and write the summary next to the capture. The port's steps
    update their model in place, so there is no state to thread:
    returns ``(last loss, summary)``."""
    import tempfile

    if k < 1:
        raise ValueError(f"xray needs at least one step, got k={k}")
    if profile_dir is None:
        profile_dir = tempfile.mkdtemp(prefix="hvd_xray_")
    step_fn(*step_args)  # warm outside the capture
    out = capture_steps(lambda _i: step_fn(*step_args), k, profile_dir)
    summary = analyze_capture(profile_dir, steps=k)
    coll = (compiled_collectives() if callable(compiled_collectives)
            else compiled_collectives)
    join_collective_bytes(summary, coll, steps=k)
    from horovod_tpu_torch.telemetry import instruments as _tele
    _tele.record_xray(summary)
    write_summary(summary, profile_dir, rank=_rank() if rank is None
                  else rank)
    return out, summary


# -- the server's window: a capture opened and closed by the steps -----------

class ProfileWindow:
    """One ``/profile?seconds=N`` request: the next step to start opens a
    capture (on its own thread), and the first step to end ``seconds``
    after that closes it and writes the trace; ``done`` is set then, or
    on :meth:`cancel`. ``run_dir`` is the capture written (None if no
    step ran) and ``steps`` the steps it covers."""

    def __init__(self, profile_dir, seconds, clock=time.monotonic):
        self.profile_dir = profile_dir
        self.seconds = float(seconds)
        self._clock = clock
        self.done = threading.Event()
        self.steps = 0
        self.run_dir = None
        self.error = None
        self._prof = None
        self._t0 = None
        self._cancelled = False

    def cancel(self):
        self._cancelled = True
        if self._prof is None:
            self.done.set()

    def step_begin(self):
        if self._prof is None and not self.done.is_set():
            try:
                self._prof = start_profiler()
            except Exception as e:  # a failed capture must not fail a step
                self.error = f"profiler failed to start: {e}"
                self.done.set()
                return
            self._t0 = self._clock()

    def step_end(self):
        if self._prof is None:
            return False
        self.steps += 1
        if not self._cancelled and \
                self._clock() - self._t0 < self.seconds:
            return False
        prof, self._prof = self._prof, None
        try:
            self.run_dir = stop_profiler(prof, self.profile_dir)
        except Exception as e:  # a failed capture must not fail a step
            self.error = f"profiler failed to stop: {e}"
        self.done.set()
        return True


_window = None
_window_lock = threading.Lock()


def open_window(profile_dir, seconds):
    """Arm a :class:`ProfileWindow` for the steps to open; returns it, or
    None while another window is armed."""
    global _window
    with _window_lock:
        if _window is not None and not _window.done.is_set():
            return None
        _window = ProfileWindow(profile_dir, seconds)
        return _window


def window_step_begin():
    """Called by the step wrappers before a step: opens an armed
    window's capture. One global load and a None check otherwise."""
    w = _window
    if w is not None:
        w.step_begin()


def window_step_end():
    """Called by the step wrappers after a step: closes the capture once
    its window has passed."""
    global _window
    w = _window
    if w is not None and w.step_end():
        with _window_lock:
            if _window is w:
                _window = None
