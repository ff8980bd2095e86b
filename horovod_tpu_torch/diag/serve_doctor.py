"""``hvd-doctor serve`` — the tail-latency doctor for the serve fleet:
the port of ``horovod_tpu/diag/serve_doctor.py``, the same code, so it
reads either package's dumps and reports alike.

The serving twin of ``hvd-doctor perf``: where the perf doctor loads
goodput-ledger dumps and names each rank's dominant time sink, this one
loads per-request trace dumps (``servetrace*.ndjson``, written by
``serve/tracing.py``) and names each SLOW request's dominant phase:

* ``queue``                 — router/engine queue + dispatch scoring
* ``kv_backpressure``       — admission head blocked on KV blocks
* ``prefill_starved``       — admitted but waiting for prefill turns
* ``decode_batch_dilation`` — waiting between decode iterations
* ``weight_swap_stall``     — rolling-reload windows it overlapped
* ``redispatch_hop``        — cut by an eviction, resumed elsewhere

plus the compute phases (``prefill``, ``decode``, ``stream``) that are
work, not stalls. "Slow" is latency >= the SLO when one is given, else
the p99. Span time inside a hop window (a ``cut`` event until the
first token on the survivor) is re-attributed to ``redispatch_hop`` —
the survivor-side requeue, re-admission and re-prefill of a cut stream
all happened BECAUSE of the eviction, whatever their span kind says.

Every span kind ``serve/tracing.py`` can emit must have an entry in
:data:`PHASE_OF_KIND` and vice versa (the tests hold the table and this
classifier together both ways).

CLI::

    python -m horovod_tpu_torch.diag.doctor serve <dir-or-ndjson> \
        [--slo-ms 250] [--json]
"""

import argparse
import glob as _glob
import json
import os
import sys

DUMP_GLOB = "servetrace*.ndjson"

# span kind (serve/tracing.py SPAN_KINDS + the unattributed residue)
# -> report phase. Several kinds may share a phase; the doctor reports
# phases, the trace keeps the finer kinds.
PHASE_OF_KIND = {
    "queue": "queue",
    "dispatch": "queue",
    "kv_wait": "kv_backpressure",
    "prefill": "prefill",
    "prefill_wait": "prefill_starved",
    "decode": "decode",
    "decode_wait": "decode_batch_dilation",
    "weight_swap": "weight_swap_stall",
    "redispatch": "redispatch_hop",
    "stream": "stream",
}

# the phases that are STALLS — a slow request's verdict is its largest
# stall, never its (necessary) compute
STALL_PHASES = ("queue", "kv_backpressure", "prefill_starved",
                "decode_batch_dilation", "weight_swap_stall",
                "redispatch_hop")

UNATTRIBUTED = "unattributed"


def find_dumps(path):
    """``servetrace*.ndjson`` files under a directory (recursively), or
    the file itself."""
    if os.path.isfile(path):
        return [path]
    return sorted(_glob.glob(os.path.join(path, "**", DUMP_GLOB),
                             recursive=True))


def load_traces(paths):
    """Parse every trace line; a half-written trailing line (a fleet
    killed mid-dump) is skipped, not fatal."""
    traces, skipped = [], 0
    for path in paths:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    traces.append(json.loads(line))
                except json.JSONDecodeError:
                    skipped += 1
    return traces, skipped


def phase_totals(trace):
    """Seconds per report phase for one trace. Span time overlapping a
    hop window is charged to ``redispatch_hop`` regardless of kind."""
    windows = trace.get("hop_windows") or []
    totals = {}
    for sp in trace.get("spans", ()):
        t0, t1 = float(sp["t0"]), float(sp["t1"])
        dur = max(0.0, t1 - t0)
        if dur <= 0.0:
            continue
        in_hop = 0.0
        for w0, w1 in windows:
            in_hop += max(0.0, min(t1, w1) - max(t0, w0))
        in_hop = min(in_hop, dur)
        phase = PHASE_OF_KIND.get(sp["kind"], UNATTRIBUTED)
        if in_hop > 0.0:
            totals["redispatch_hop"] = \
                totals.get("redispatch_hop", 0.0) + in_hop
        if dur - in_hop > 0.0:
            totals[phase] = totals.get(phase, 0.0) + (dur - in_hop)
    return totals


def dominant_stall(totals):
    """(phase, seconds) of the largest stall; ("none", 0.0) for a
    request that never waited."""
    best, best_s = "none", 0.0
    for phase in STALL_PHASES:
        s = totals.get(phase, 0.0)
        if s > best_s:
            best, best_s = phase, s
    return best, best_s


def _percentile(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def aggregate(traces, slo_ms=None):
    """The fleet tail report: per-request phase totals, the slow bucket
    (>= SLO, else >= p99), each slow request's dominant stall, and the
    fleet-wide verdict."""
    requests = []
    for tr in traces:
        totals = phase_totals(tr)
        dom, dom_s = dominant_stall(totals)
        latency_ms = float(tr.get("latency_s", 0.0)) * 1e3
        requests.append({
            "request_id": tr.get("request_id"),
            "latency_ms": latency_ms,
            "hops": int(tr.get("hops", 0)),
            "attributed_fraction":
                float(tr.get("attributed_fraction", 0.0)),
            "dominant_phase": dom,
            "dominant_ms": dom_s * 1e3,
            "phases_ms": {k: v * 1e3 for k, v in sorted(totals.items())},
        })
    lat = sorted(r["latency_ms"] for r in requests)
    p50 = _percentile(lat, 0.50)
    p99 = _percentile(lat, 0.99)
    threshold = float(slo_ms) if slo_ms is not None else p99
    slow = [r for r in requests if r["latency_ms"] >= threshold]
    phase_counts = {}
    slow_totals = {}
    for r in slow:
        phase_counts[r["dominant_phase"]] = \
            phase_counts.get(r["dominant_phase"], 0) + 1
        for phase, ms in r["phases_ms"].items():
            slow_totals[phase] = slow_totals.get(phase, 0.0) + ms
    verdict = max(phase_counts.items(),
                  key=lambda kv: (kv[1], kv[0]))[0] if phase_counts \
        else "none"
    return {
        "requests": len(requests),
        "p50_ms": p50,
        "p99_ms": p99,
        "slow_threshold_ms": threshold,
        "slow_threshold_kind": "slo" if slo_ms is not None else "p99",
        "slow": sorted(slow, key=lambda r: -r["latency_ms"]),
        "slow_dominant_counts": dict(sorted(phase_counts.items())),
        "slow_phase_totals_ms": dict(sorted(slow_totals.items())),
        "verdict": verdict,
        "min_attributed_fraction":
            min((r["attributed_fraction"] for r in requests),
                default=0.0),
        "per_request": requests,
    }


def format_report(report):
    lines = ["== hvd-doctor serve: request tail report =="]
    lines.append(
        f"requests: {report['requests']} traced, "
        f"p50 {report['p50_ms']:.1f} ms, p99 {report['p99_ms']:.1f} ms, "
        f"min attributed {report['min_attributed_fraction'] * 100:.1f}%")
    kind = report["slow_threshold_kind"]
    lines.append(
        f"slow bucket (latency >= {report['slow_threshold_ms']:.1f} ms "
        f"[{kind}]): {len(report['slow'])} request(s)")
    for r in report["slow"]:
        lines.append(
            f"  {r['request_id']}: {r['latency_ms']:.1f} ms, "
            f"{r['hops']} hop(s), dominant {r['dominant_phase']} "
            f"({r['dominant_ms']:.1f} ms), attributed "
            f"{r['attributed_fraction'] * 100:.1f}%")
    if report["slow_phase_totals_ms"]:
        totals = ", ".join(
            f"{k} {v:.1f}" for k, v in sorted(
                report["slow_phase_totals_ms"].items(),
                key=lambda kv: -kv[1]))
        lines.append(f"slow-bucket phase totals (ms): {totals}")
    counts = report["slow_dominant_counts"]
    n_slow = max(1, len(report["slow"]))
    lines.append(
        f"verdict: {report['verdict']} dominates "
        f"{counts.get(report['verdict'], 0)}/{n_slow} slow request(s)")
    return "\n".join(lines)


def run(path, slo_ms=None, stream=None):
    """Load dumps under ``path`` and print the tail report. Returns the
    report dict, or None when there is nothing to report."""
    stream = stream or sys.stderr
    paths = find_dumps(path)
    if not paths:
        print(f"serve doctor: no {DUMP_GLOB} dumps under {path}",
              file=stream)
        return None
    traces, skipped = load_traces(paths)
    if skipped:
        print(f"serve doctor: skipped {skipped} unparseable trace "
              f"line(s)", file=stream)
    if not traces:
        print(f"serve doctor: no traces in {len(paths)} dump file(s)",
              file=stream)
        return None
    report = aggregate(traces, slo_ms=slo_ms)
    print(format_report(report), file=stream)
    return report


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="hvd-doctor serve",
        description="Name each slow request's dominant phase from "
                    "per-request serve trace dumps "
                    "(servetrace*.ndjson).")
    p.add_argument("path", help="trace dump directory (searched "
                                "recursively) or one ndjson file")
    p.add_argument("--slo-ms", type=float, default=None,
                   help="slow threshold in ms (default: the p99)")
    p.add_argument("--json", action="store_true",
                   help="print the full report as JSON instead")
    args = p.parse_args(argv)
    if args.json:
        paths = find_dumps(args.path)
        traces, _ = load_traces(paths)
        if not traces:
            print(f"serve doctor: no traces under {args.path}",
                  file=sys.stderr)
            return 2
        print(json.dumps(aggregate(traces, slo_ms=args.slo_ms),
                         indent=2))
        return 0
    report = run(args.path, slo_ms=args.slo_ms, stream=sys.stdout)
    return 2 if report is None else 0


if __name__ == "__main__":
    sys.exit(main())
