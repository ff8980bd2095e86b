"""``hvd-doctor-torch xray`` — where did my step's device time go.

The port of ``horovod_tpu/diag/xray.py``: the device-side twin of
``hvd-doctor-torch perf``, over ``torch.profiler`` captures
(``telemetry/xprof.py`` does the parsing). It accepts either:

* a directory holding ``xray.rank<r>.json`` summaries (what
  ``step.xray(k)`` or ``/profile`` wrote next to their capture, in
  either package) — reprinted without re-parsing; or
* a raw capture (``/profile?seconds=N``'s output dir, or any dir with
  ``plugins/profile/<run>/*.trace.json[.gz]``) — parsed fresh; pass
  ``--bytes <file>`` (a JSON ``{kind: {"calls", "bytes"}}``, such as a
  GSPMD step's ``step.compiled_collectives``) to join per-collective
  bytes and get effective-bandwidth rows. The JAX doctor's ``--hlo``
  reads compiled HLO text, which torch has not.

Output: the verdict (comms-bound / compute-bound / overlap-broken /
copy-bound / idle-bound / empty-capture), the per-category device-time
table gated by ``bucketed_fraction``, and the per-collective
exposed-vs-overlapped + bandwidth table. ``--json`` prints the summary
dict on stdout (report prose moves to stderr).

CLI::

    python -m horovod_tpu_torch.diag.doctor xray <dir> [--steps K]
        [--bytes collectives.json] [--json]
"""

import argparse
import glob
import json
import os
import sys

from horovod_tpu_torch.telemetry import xprof

_PCT = "{:5.1f}%"


def find_summaries(directory):
    """``xray.rank*.json`` paths directly under ``directory`` or its
    capture subdirs (non-recursive beyond the profiler layout)."""
    pats = [os.path.join(glob.escape(directory),
                         f"{xprof.SUMMARY_PREFIX}*.json"),
            os.path.join(glob.escape(directory), "plugins", "profile",
                         "*", f"{xprof.SUMMARY_PREFIX}*.json")]
    return sorted(p for pat in pats for p in glob.glob(pat)
                  if ".tmp" not in p)


def load_summaries(directory):
    """Parse the checked summaries — ``[(path, summary)]``, skipping
    files that are not X-ray summaries."""
    out = []
    for path in find_summaries(directory):
        try:
            with open(path) as f:
                d = json.load(f)
            if d.get("xray"):
                out.append((path, d))
        except (OSError, ValueError):
            continue
    return out


def format_summary(summary, source=None):
    lines = []
    add = lines.append
    add("==== horovod_tpu compiled-step x-ray " + "=" * 28)
    if source:
        add(f"capture: {source}")
    total = sum(summary["device_seconds"].values())
    add(f"device lanes: {summary['device_lanes']}; window "
        f"{summary['window_seconds'] * 1e3:.2f}ms"
        + (f"; steps {summary['steps']}" if summary.get("steps") else ""))
    gate = summary["bucketed_fraction"]
    flag = "" if gate >= xprof.BUCKETED_GATE else \
        f"  << BELOW {xprof.BUCKETED_GATE:.0%} GATE"
    add(f"bucketed: {gate:.1%} of device time named{flag}")
    for cat in xprof.CATEGORIES:
        s = summary["device_seconds"].get(cat, 0.0)
        if s <= 0:
            continue
        pct = 100.0 * s / total if total > 0 else 0.0
        add(f"  {cat:<20} {s * 1e3:>10.3f}ms  {pct:5.1f}%")
    colls = summary.get("collectives", {})
    if colls:
        add("collectives (exposed = not hidden behind compute):")
        for op, c in sorted(colls.items()):
            row = (f"  {op:<20} {c['seconds'] * 1e3:>8.3f}ms  "
                   f"exposed {c['exposed_seconds'] * 1e3:>8.3f}ms  "
                   f"overlapped {c['overlapped_seconds'] * 1e3:>8.3f}ms")
            if "effective_gbps" in c:
                row += (f"  {c['effective_gbps']:>7.2f} GB/s "
                        f"({c.get('bytes_per_step', 0)} B/step/device)")
            add(row)
    if summary.get("torn_files"):
        add(f"torn trace files skipped: {len(summary['torn_files'])}")
    sink_cat, sink_s = xprof.dominant_sink(summary)
    if sink_cat is not None:
        pct = 100.0 * sink_s / total if total > 0 else 0.0
        add(f"dominant sink: {sink_cat} — {sink_s * 1e3:.3f}ms "
            f"({pct:.1f}% of device time)")
    add(f"VERDICT: {summary['verdict']}")
    add("=" * 66)
    return "\n".join(lines)


def run(directory, steps=None, byte_file=None, stream=None):
    """Summaries if present, else parse the raw capture. Returns the
    list of ``(source, summary)`` printed, or None when the directory
    holds neither."""
    stream = stream or sys.stderr
    found = load_summaries(directory)
    if found:
        for path, summary in found:
            print(format_summary(summary, source=path), file=stream)
        return found
    try:
        summary = xprof.analyze_capture(directory, steps=steps)
    except ValueError as e:
        print(f"xray: {e}", file=stream)
        return None
    if byte_file:
        try:
            with open(byte_file) as f:
                xprof.join_collective_bytes(summary, json.load(f),
                                            steps=steps)
        except (OSError, ValueError) as e:
            print(f"xray: --bytes unreadable, bandwidth rows skipped: {e}",
                  file=stream)
    print(format_summary(summary, source=summary.get("capture_dir")),
          file=stream)
    return [(summary.get("capture_dir"), summary)]


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="hvd-doctor-torch xray",
        description="Attribute compiled-step device time from a "
                    "torch.profiler capture: per-category buckets, "
                    "exposed vs overlapped collective time, effective "
                    "exchange bandwidth, and a verdict.")
    p.add_argument("dir", help="profiler dump dir (/profile output or "
                               "step.xray's profile_dir), or a dir "
                               "holding xray.rank*.json summaries")
    p.add_argument("--steps", type=int, default=None,
                   help="steps the capture covers (scales the "
                        "bandwidth join; summaries carry their own)")
    p.add_argument("--bytes", dest="byte_file", default=None,
                   help="JSON {kind: {calls, bytes}} of one step's "
                        "collectives to join (raw captures only)")
    p.add_argument("--json", action="store_true",
                   help="print the summary JSON on stdout (report "
                        "prose moves to stderr)")
    args = p.parse_args(argv)
    found = run(args.dir, steps=args.steps, byte_file=args.byte_file,
                stream=sys.stderr if args.json else sys.stdout)
    if found is None:
        return 2
    if args.json:
        payload = ([s for _src, s in found] if len(found) > 1
                   else found[0][1])
        print(json.dumps(payload, indent=2, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
