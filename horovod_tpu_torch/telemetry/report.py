"""The end-of-run goodput report: aggregate per-rank ledgers, name the
dominant time sink.

The port of ``horovod_tpu/telemetry/report.py``, the same code: the same
dumps give the same text, and it reads either package's dumps.

    hvd-doctor-torch perf <logdir>
    hvdrun-torch --goodput-report <logdir>
    python -m horovod_tpu_torch.telemetry.report <logdir>

Each rank's ``TimeLedger`` (``telemetry/ledger.py``) writes a
``goodput.rank<r>.json`` next to the flight-recorder dumps at shutdown
(``runtime/services.stop``). This module loads them, sums the phase
ledgers fleet-wide, names the dominant non-compute sink per rank and
overall, and cross-checks each rank's accounted wall time against a
merged Chrome trace when one is present — the perf mirror of the desync
doctor's hang report.

``goodput_block()`` is the BENCH json contract: the same snapshot with
the *sum ≈ wall* invariant enforced — an unattributed gap above
``UNATTRIBUTED_TOLERANCE`` of wall raises :class:`GoodputInvariantError`
so a perf regression can never hide in unaccounted time.
"""

import argparse
import json
import os
import sys

from horovod_tpu_torch.telemetry.ledger import (DUMP_PREFIX, PHASES,
                                          dominant_sink as _dominant_sink)

# the bench invariant: phases must explain all but this fraction of wall
UNATTRIBUTED_TOLERANCE = 0.02

# a trace whose span disagrees with the ledger wall by more than this is
# flagged in the report (clock domains differ; this is a sanity bound,
# not a precision check)
TRACE_SKEW_TOLERANCE = 0.25


class GoodputInvariantError(RuntimeError):
    """The phase sum failed to explain ~100% of wall time."""


def find_dumps(logdir):
    """All ``goodput.rank*.json`` paths under ``logdir`` (recursive —
    elastic jobs write per-epoch subdirectories)."""
    out = []
    for root, _dirs, files in os.walk(logdir):
        for f in files:
            if f.startswith(DUMP_PREFIX) and f.endswith(".json") \
                    and ".tmp" not in f:
                out.append(os.path.join(root, f))
    return sorted(out)


def load_dumps(logdir):
    """Parse dumps. A rank with multiple dumps (one per elastic *life*
    — each relaunched process writes its own, in its epoch's dump dir)
    is SUMMED across them: the lives cover disjoint wall-clock windows,
    and dropping the pre-kill ones would hide exactly the recovery cost
    this report exists to expose. Returns ``(dumps_by_rank, skipped)``;
    merged entries carry ``lives`` and the newest dump's identity."""
    dumps, skipped = {}, []
    for path in find_dumps(logdir):
        try:
            with open(path) as f:
                d = json.load(f)
            if not d.get("goodput"):
                raise ValueError("not a goodput-ledger dump")
        except (OSError, ValueError) as e:
            skipped.append((path, str(e)))
            continue
        d["_path"] = path
        d["lives"] = 1
        r = int(d.get("rank", -1))
        prev = dumps.get(r)
        if prev is None:
            dumps[r] = d
            continue
        newest, older = ((d, prev) if d.get("wall_clock", 0)
                         >= prev.get("wall_clock", 0) else (prev, d))
        merged = dict(newest)  # newest life's identity/build_info wins
        merged["phases"] = {
            p: (newest.get("phases", {}).get(p, 0.0)
                + older.get("phases", {}).get(p, 0.0))
            for p in set(newest.get("phases", {}))
            | set(older.get("phases", {}))}
        for key in ("wall_seconds", "unattributed_seconds", "steps",
                    "lives"):
            merged[key] = (newest.get(key) or 0) + (older.get(key) or 0)
        attributed = sum(merged["phases"].values())
        merged["goodput_ratio"] = (
            merged["phases"].get("compute", 0.0) / attributed
            if attributed else 1.0)
        dumps[r] = merged
    return dumps, skipped


def aggregate(dumps):
    """Build the report dict from ``{rank: dump}`` — per-rank and
    fleet-wide phase totals, goodput ratios, dominant sinks. Pure
    function of the dumps (unit-testable on synthesized ledgers)."""
    per_rank = {}
    fleet = {p: 0.0 for p in PHASES}
    fleet_wall = 0.0
    fleet_unattributed = 0.0
    for r in sorted(dumps):
        d = dumps[r]
        phases = {p: float(d.get("phases", {}).get(p, 0.0)) for p in PHASES}
        wall = float(d.get("wall_seconds", sum(phases.values())))
        sink, sink_s = _dominant_sink(phases)
        attributed = sum(phases.values())
        per_rank[r] = {
            "phases": phases,
            "wall_seconds": wall,
            "unattributed_seconds": float(
                d.get("unattributed_seconds", max(0.0, wall - attributed))),
            "goodput_ratio": float(d.get(
                "goodput_ratio",
                phases["compute"] / attributed if attributed else 1.0)),
            "dominant_sink": sink,
            "dominant_sink_seconds": sink_s,
            "steps": d.get("steps"),
            "build_info": d.get("build_info"),
            "compiled_path": bool(d.get("compiled_path")),
            "path": d.get("_path"),
        }
        for p in PHASES:
            fleet[p] += phases[p]
        fleet_wall += wall
        fleet_unattributed += per_rank[r]["unattributed_seconds"]
    f_attr = sum(fleet.values())
    f_sink, f_sink_s = _dominant_sink(fleet)
    return {
        "ranks": per_rank,
        "fleet": {
            "phases": fleet,
            "wall_seconds": fleet_wall,
            "unattributed_seconds": fleet_unattributed,
            "goodput_ratio": fleet["compute"] / f_attr if f_attr else 1.0,
            "dominant_sink": f_sink,
            "dominant_sink_seconds": f_sink_s,
            "compiled_path": any(i["compiled_path"]
                                 for i in per_rank.values()),
        },
    }


def crosscheck_trace(report, trace_path):
    """Sanity-check the ledger against a merged Chrome trace
    (``hvdrun --merge-timeline``): each rank's event span in the trace
    should be within :data:`TRACE_SKEW_TOLERANCE` of its accounted wall
    time. Annotates and returns ``report['trace_check']``."""
    from horovod_tpu_torch.telemetry.merge import load_events
    spans = {}
    for ev in load_events(trace_path):
        try:
            pid, ts = int(ev["pid"]), float(ev["ts"])
        except (KeyError, TypeError, ValueError):
            continue
        lo, hi = spans.get(pid, (ts, ts))
        spans[pid] = (min(lo, ts), max(hi, ts))
    check = {"trace": trace_path, "ranks": {}, "mismatched": []}
    for r, info in report["ranks"].items():
        if r not in spans:
            continue
        trace_s = (spans[r][1] - spans[r][0]) / 1e6  # us -> s
        wall = info["wall_seconds"]
        ok = (abs(trace_s - wall)
              <= TRACE_SKEW_TOLERANCE * max(wall, 1e-9))
        check["ranks"][r] = {"trace_span_seconds": trace_s,
                             "ledger_wall_seconds": wall, "ok": ok}
        if not ok:
            check["mismatched"].append(r)
    report["trace_check"] = check
    return check


def _pct(seconds, wall):
    return 100.0 * seconds / wall if wall > 0 else 0.0


def format_report(report):
    lines = []
    add = lines.append
    add("==== horovod_tpu goodput report " + "=" * 33)
    fleet = report["fleet"]
    wall = fleet["wall_seconds"]
    add(f"ranks: {sorted(report['ranks'])}; fleet rank-seconds: "
        f"{wall:.2f}")
    add(f"fleet goodput: {100 * fleet['goodput_ratio']:.1f}% compute")
    order = sorted(PHASES, key=lambda p: -fleet["phases"][p])
    for p in order:
        s = fleet["phases"][p]
        if s <= 0:
            continue
        add(f"  {p:<20} {s:>10.2f}s  {_pct(s, wall):5.1f}%")
    if fleet["unattributed_seconds"] > 0.005 * max(wall, 1e-9):
        add(f"  {'(unattributed)':<20} "
            f"{fleet['unattributed_seconds']:>10.2f}s  "
            f"{_pct(fleet['unattributed_seconds'], wall):5.1f}%")
    if fleet.get("compiled_path") and \
            fleet["phases"].get("exposed_collective", 0.0) == 0.0:
        add("note: compiled-path (GSPMD) run — collective time is "
            "inside the compiled step and books as compute; "
            "exposed_collective=0 is structural, not 'no comms'. "
            "Run `hvd-doctor xray` for the device-side split.")
    if fleet["dominant_sink"]:
        add(f"DOMINANT TIME SINK (fleet): {fleet['dominant_sink']} — "
            f"{fleet['dominant_sink_seconds']:.2f}s "
            f"({_pct(fleet['dominant_sink_seconds'], wall):.1f}% of wall)")
    else:
        add("DOMINANT TIME SINK (fleet): none — pure compute")
    for r, info in sorted(report["ranks"].items()):
        sink = (f"{info['dominant_sink']} "
                f"({_pct(info['dominant_sink_seconds'], info['wall_seconds']):.1f}%)"
                if info["dominant_sink"] else "none")
        add(f"rank {r}: wall {info['wall_seconds']:.2f}s, goodput "
            f"{100 * info['goodput_ratio']:.1f}%, dominant sink: {sink}"
            + (f", steps {info['steps']}"
               if info.get("steps") is not None else ""))
    bi = next((i["build_info"] for i in report["ranks"].values()
               if i.get("build_info")), None)
    if bi:
        add("build: " + ", ".join(f"{k}={v}" for k, v in sorted(bi.items())))
    tc = report.get("trace_check")
    if tc:
        if tc["mismatched"]:
            add(f"TRACE CROSS-CHECK: rank(s) {tc['mismatched']} ledger "
                f"wall disagrees with the merged trace span by more than "
                f"{int(TRACE_SKEW_TOLERANCE * 100)}% — attribution for "
                "them is suspect")
        else:
            add(f"trace cross-check: ledger wall matches {tc['trace']} "
                f"for rank(s) {sorted(tc['ranks'])}")
    add("=" * 66)
    return "\n".join(lines)


def run(logdir, trace=None, stream=None):
    """Load dumps under ``logdir``, print the report. Returns the
    report dict, or None when no dumps exist."""
    stream = stream or sys.stderr
    dumps, skipped = load_dumps(logdir)
    for path, err in skipped:
        print(f"goodput: skipping {path}: {err}", file=stream)
    if not dumps:
        print(f"goodput: no {DUMP_PREFIX}*.json dumps under {logdir}",
              file=stream)
        return None
    report = aggregate(dumps)
    if trace is None:
        # pick up the merged trace if one sits next to the dumps
        cand = os.path.join(logdir, "merged.json")
        trace = cand if os.path.exists(cand) else None
    if trace:
        try:
            crosscheck_trace(report, trace)
        except (OSError, ValueError) as e:
            print(f"goodput: trace cross-check skipped: {e}", file=stream)
    print(format_report(report), file=stream)
    return report


# -- the BENCH json block ----------------------------------------------------

def validate_goodput_block(block, tolerance=UNATTRIBUTED_TOLERANCE):
    """Enforce the *sum ≈ wall* invariant on a BENCH ``goodput`` block:
    raises :class:`GoodputInvariantError` when the unattributed gap
    exceeds ``tolerance`` of wall time (or the phase sum exceeds wall
    by more than float noise)."""
    wall = float(block.get("wall_seconds", 0.0))
    phases = block.get("phases", {})
    attributed = sum(float(v) for v in phases.values())
    if wall <= 0:
        raise GoodputInvariantError(
            f"goodput block has no wall time (wall_seconds={wall})")
    gap = wall - attributed
    if gap > tolerance * wall:
        raise GoodputInvariantError(
            f"goodput phases explain only {attributed:.3f}s of "
            f"{wall:.3f}s wall ({100 * gap / wall:.1f}% unattributed > "
            f"{100 * tolerance:.0f}% tolerance) — a phase hook is not "
            "charging its time")
    if attributed > wall * (1 + tolerance):
        raise GoodputInvariantError(
            f"goodput phases sum to {attributed:.3f}s, MORE than the "
            f"{wall:.3f}s wall — double-charged time")
    return block


def goodput_block(ledger=None, validate=True):
    """The BENCH json ``goodput`` block: finalize the (process) ledger
    and return its phase breakdown; with ``validate`` the sum≈wall
    invariant is enforced loudly (bench.py's contract — unattributed
    gaps >2% are an error, never silence)."""
    from horovod_tpu_torch.telemetry import ledger as ledger_lib
    led = ledger_lib.get_ledger() if ledger is None else ledger
    snap = led.finalize()
    block = {
        "phases": {p: round(s, 4) for p, s in snap["phases"].items()},
        "wall_seconds": round(snap["wall_seconds"], 4),
        "unattributed_seconds": round(snap["unattributed_seconds"], 4),
        "goodput_ratio": round(snap["goodput_ratio"], 4),
        "steps": snap["steps"],
        "compiled_path": snap.get("compiled_path", False),
    }
    if validate:
        validate_goodput_block(block)
    return block


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="hvd-doctor-torch perf",
        description="Aggregate per-rank goodput-ledger dumps "
                    "(goodput.rank*.json) into an end-of-run time-"
                    "attribution report naming the dominant time sink.")
    p.add_argument("logdir", help="directory containing goodput.rank*."
                                  "json dumps (searched recursively)")
    p.add_argument("--trace", default=None,
                   help="merged Chrome trace (hvdrun-torch --merge-timeline "
                        "output) to cross-check ledger wall times "
                        "against (default: <logdir>/merged.json when "
                        "present)")
    p.add_argument("--json", action="store_true",
                   help="print the report dict as JSON on stdout "
                        "(the human-readable report moves to stderr)")
    args = p.parse_args(argv)
    report = run(args.logdir, trace=args.trace,
                 stream=sys.stderr if args.json else sys.stdout)
    if report is not None and args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    return 2 if report is None else 0


if __name__ == "__main__":
    sys.exit(main())
