"""Bench-trajectory tooling (the JAX package's ``telemetry/trend.py``):
diff the ``BENCH_*.json`` and ``SCALING_*.json`` rounds and flag
regressions.

It loads every round, extracts the comparable series (headline
throughput, ``step_ms_*`` medians, MFU, goodput ratio, serve tokens/s
and TTFT, per-world scaling points), and compares each metric's latest
value against the previous round that reported it: a change worse than
:data:`REGRESSION_THRESHOLD` in the metric's bad direction is a
REGRESSION row and a nonzero exit.

Round files come in two shapes and both are read: a command's record
``{"cmd", "parsed": {...}, "rc", ...}`` and a raw bench result dict.
Metric direction is inferred from the name — ``*_ms``/``*_over_*`` are
lower-is-better, throughput/MFU/goodput higher-is-better — so a new
bench key joins the trend without registration. The report and its text
are the JAX tool's, so both read the same rounds alike.

CLI::

    python -m horovod_tpu_torch.telemetry.trend [dir-or-files...] [--json]
"""

import argparse
import glob
import json
import os
import sys

# flag a change worse than this fraction in the bad direction
REGRESSION_THRESHOLD = 0.05

# substrings that make a metric lower-is-better; everything else
# numeric is treated as higher-is-better (throughput, MFU, goodput)
_LOWER_IS_BETTER = ("_ms", "ttft", "step_ms", "_over_", "latency",
                    "stall", "blocking", "unattributed")

# keys that are configuration/identity, never a perf series
_SKIP = ("devices", "repeats", "rc", "n", "per_chip_batch", "requests",
         "max_new_tokens", "max_slots", "prefill_chunk", "kv_block_size",
         "kv_pool_blocks", "kv_pool_mib", "kv_pool", "seq_len", "layers",
         "d_model", "heads", "vocab", "batch", "shared_prefix",
         "prompt_len_mean", "empirical_peak_matmul_n", "rate_rps",
         "steps", "lives", "events", "wall_clock", "wall_seconds",
         "lm_seq_len", "attributed_seconds")


def direction(name):
    """``-1`` when lower is better (latencies, parity ratios), ``+1``
    when higher is better (throughput, MFU, goodput)."""
    low = name.lower()
    if any(s in low for s in _LOWER_IS_BETTER):
        return -1
    return 1


def _flatten(doc, prefix="", out=None):
    out = {} if out is None else out
    for key, val in doc.items():
        if key.startswith("_") or key in _SKIP:
            continue
        name = f"{prefix}{key}"
        if isinstance(val, bool):
            continue
        if isinstance(val, (int, float)):
            out[name] = float(val)
        elif isinstance(val, dict) and key in ("goodput", "single",
                                               "fleet"):
            _flatten(val, prefix=f"{name}.", out=out)
    return out


def _flatten_scaling(doc):
    """The comparable series of one ``SCALING_*.json`` sweep
    (bench_scaling.py): per-world efficiency, step time, per-chip
    throughput and goodput, keyed ``scaling.<world>.<metric>`` so a
    bent curve shows up as a regressed per-world point. ``efficiency``
    carries no lower-is-better substring -> higher-is-better, exactly
    right."""
    out = {}
    for world in doc.get("worlds", ()):
        name = world.get("world")
        if not name:
            continue
        prefix = f"scaling.{name}."
        for key in ("efficiency", "img_per_sec_per_chip",
                    "step_ms_median"):
            if isinstance(world.get(key), (int, float)):
                out[prefix + key] = float(world[key])
        goodput = world.get("goodput") or {}
        for key in ("ratio", "unattributed_frac"):
            if isinstance(goodput.get(key), (int, float)):
                out[f"{prefix}goodput.{key}"] = float(goodput[key])
    return out


def extract_metrics(doc):
    """The comparable numeric series of one round document (wrapper
    unwrapped, nested goodput/serve blocks dotted in; scaling sweeps
    dotted per world)."""
    if isinstance(doc, dict) and isinstance(doc.get("parsed"), dict):
        doc = doc["parsed"]
    if not isinstance(doc, dict):
        return {}
    if doc.get("bench") == "scaling" or "efficiency_curve" in doc:
        return _flatten_scaling(doc)
    return _flatten(doc)


def find_rounds(paths=None):
    """Resolve ``paths`` (files, dirs, or None for the repo root this
    process runs in) to the sorted list of ``BENCH_*.json`` then
    ``SCALING_*.json`` files — name order IS round order
    (``BENCH_r01`` … ``BENCH_r09``, ``SCALING_r01`` …). Scaling sweeps
    sort after the bench rounds: their metric keys (``scaling.*``)
    never collide with bench keys, so interleaving order between the
    two families is irrelevant to the diff."""
    if not paths:
        paths = ["."]
    out = []
    for p in paths:
        if os.path.isdir(p):
            root = glob.escape(p)
            out.extend(sorted(glob.glob(os.path.join(root, "BENCH_*.json"))))
            out.extend(sorted(glob.glob(
                os.path.join(root, "SCALING_*.json"))))
        else:
            out.append(p)
    return out


def load_rounds(paths):
    """``[(round_name, metrics)]`` in round order; unreadable files are
    reported in the second return value, never silently dropped."""
    rounds, skipped = [], []
    for path in paths:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            skipped.append((path, str(e)))
            continue
        name = os.path.splitext(os.path.basename(path))[0]
        rounds.append((name, extract_metrics(doc)))
    return rounds, skipped


def compare(rounds, threshold=REGRESSION_THRESHOLD):
    """The trend report: for every metric two or more rounds share,
    the full series plus the latest-vs-previous delta, flagged as a
    regression when it moves more than ``threshold`` in the metric's
    bad direction. Pure function of the loaded rounds."""
    series = {}
    for name, metrics in rounds:
        for key, val in metrics.items():
            series.setdefault(key, []).append((name, val))
    report = {"rounds": [n for n, _m in rounds], "metrics": {},
              "regressions": []}
    for key in sorted(series):
        points = series[key]
        if len(points) < 2:
            continue
        (prev_round, prev), (last_round, last) = points[-2], points[-1]
        entry = {
            "series": {n: v for n, v in points},
            "previous": {"round": prev_round, "value": prev},
            "latest": {"round": last_round, "value": last},
        }
        if prev != 0:
            change = (last - prev) / abs(prev)
            entry["change_pct"] = round(100 * change, 2)
            worse = -direction(key) * change
            entry["regressed"] = bool(worse > threshold)
            if entry["regressed"]:
                report["regressions"].append(key)
        report["metrics"][key] = entry
    return report


def format_trend(report, threshold=REGRESSION_THRESHOLD):
    lines = []
    add = lines.append
    add("==== horovod_tpu bench trend " + "=" * 36)
    add(f"rounds: {', '.join(report['rounds'])}")
    for key, entry in report["metrics"].items():
        if "change_pct" not in entry:
            continue
        arrow = "REGRESSION" if entry.get("regressed") else (
            "ok" if abs(entry["change_pct"]) <= 100 * threshold
            else "improved")
        add(f"  {key:<44} {entry['previous']['value']:>12.3f} -> "
            f"{entry['latest']['value']:>12.3f}  "
            f"{entry['change_pct']:+7.2f}%  {arrow}  "
            f"({entry['previous']['round']} -> "
            f"{entry['latest']['round']})")
    if report["regressions"]:
        add(f"REGRESSIONS (> {threshold:.0%} worse): "
            + ", ".join(report["regressions"]))
    else:
        add(f"no metric regressed more than {threshold:.0%} between its "
            "last two rounds")
    add("=" * 66)
    return "\n".join(lines)


def run(paths=None, threshold=REGRESSION_THRESHOLD, stream=None):
    """Load, compare, print. Returns the report dict, or None when
    fewer than two rounds exist."""
    stream = stream or sys.stderr
    rounds, skipped = load_rounds(find_rounds(paths))
    for path, err in skipped:
        print(f"trend: skipping {path}: {err}", file=stream)
    if len(rounds) < 2:
        print(f"trend: need at least two BENCH_*.json rounds, found "
              f"{len(rounds)}", file=stream)
        return None
    report = compare(rounds, threshold=threshold)
    print(format_trend(report, threshold=threshold), file=stream)
    return report


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.telemetry.trend",
        description="Diff the checked-in BENCH_*.json perf rounds and "
                    "flag >5% regressions (step_ms, MFU, goodput, "
                    "serve tokens/s).")
    p.add_argument("paths", nargs="*",
                   help="round files or directories holding "
                        "BENCH_*.json (default: current directory)")
    p.add_argument("--threshold", type=float,
                   default=100 * REGRESSION_THRESHOLD,
                   help="regression threshold in percent (default 5)")
    p.add_argument("--json", action="store_true",
                   help="print the trend report as JSON on stdout "
                        "(prose moves to stderr)")
    args = p.parse_args(argv)
    report = run(args.paths, threshold=args.threshold / 100.0,
                 stream=sys.stderr if args.json else sys.stdout)
    if report is None:
        return 2
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    return 1 if report["regressions"] else 0


if __name__ == "__main__":
    sys.exit(main())
