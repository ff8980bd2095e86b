"""Merge per-rank Chrome traces into one Perfetto-loadable trace.

The port of ``horovod_tpu/telemetry/merge.py``, the same code: the same
events give the same merged JSON, and it merges either package's traces.

Each rank writes its own host trace (``utils/timeline.py``; per-rank
paths are derived from ``HOROVOD_TIMELINE`` by ``runtime/services.py``).
This tool unifies them:

* **repair** — a crashed or still-running rank leaves a JSON array with
  no closing ``]`` (or a half-written final event). :func:`load_events`
  parses what is recoverable instead of failing the whole merge.
* **pid assignment** — every event of rank r lands under ``pid=r`` with
  ``process_name`` / ``process_sort_index`` metadata, so Perfetto shows
  one labelled track group per rank.
* **clock alignment** — each trace carries a ``clock_sync`` event
  recording the Unix time at its local ``ts=0`` (``Timeline`` emits it
  at construction). All ranks are shifted onto the earliest rank's
  clock, so cross-rank causality (a straggler's step finishing late, a
  membership interrupt landing mid-step) reads directly off the merged
  view. NTP-quality alignment only — good to ~ms across hosts, exact
  within one host.

CLI::

    python -m horovod_tpu_torch.telemetry.merge -o merged.json trace.rank*.json
    hvdrun-torch --merge-timeline merged.json trace.rank*.json
"""

import argparse
import glob as _glob
import json
import re
import sys

CLOCK_SYNC = "hvd_clock_sync"
# Flow events in this category carry GLOBALLY allocated ids (the serve
# tracer's request-hop arrows, serve/tracing.py): one id deliberately
# spans several pids, so the merge must NOT per-rank-namespace it.
GLOBAL_FLOW_CAT = "hvd_global_flow"
_RANK_RE = re.compile(r"\.rank(\d+)\.")


def load_events(path):
    """Load one trace file, repairing truncation: trailing-``]`` repair
    first, then progressively dropping half-written tail events."""
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    t = text.strip()
    if t.startswith("{"):  # object-format trace from another tool
        raise ValueError(f"{path}: unrecoverable non-array trace")
    if not t.startswith("["):
        raise ValueError(f"{path}: not a Chrome trace JSON array")
    # cut back to the last complete event object, then close the array;
    # a few iterations cover a half-written event containing nested "}"
    end = len(t)
    for _ in range(64):
        cut = t.rfind("}", 0, end)
        if cut < 0:
            return []  # nothing complete — an empty-but-valid trace
        candidate = t[:cut + 1].rstrip().rstrip(",") + "\n]"
        try:
            return json.loads(candidate)
        except json.JSONDecodeError:
            end = cut
    raise ValueError(f"{path}: could not repair truncated trace")


def _rank_of(path, events, fallback):
    """Rank identity: the clock_sync event's args win, else the
    ``.rank<N>.`` filename convention, else positional order."""
    for ev in events:
        if ev.get("name") == CLOCK_SYNC:
            rank = ev.get("args", {}).get("rank")
            if rank is not None:
                return int(rank)
    m = _RANK_RE.search(path)
    if m:
        return int(m.group(1))
    return fallback


def _clock_base_us(events):
    """Unix microseconds at this trace's ts=0, from clock_sync."""
    for ev in events:
        if ev.get("name") == CLOCK_SYNC:
            args = ev.get("args", {})
            if "unix_time_us" in args:
                return float(args["unix_time_us"]) - float(ev.get("ts", 0))
    return None


def merge_traces(paths, out_path=None):
    """Merge ``paths`` (repairing each) into one event list; write it to
    ``out_path`` when given. Returns the merged event list."""
    if not paths:
        raise ValueError("no trace files to merge")
    loaded = []
    for i, path in enumerate(paths):
        events = load_events(path)
        rank = _rank_of(path, events, fallback=i)
        loaded.append((rank, path, events, _clock_base_us(events)))
    known = [base for _, _, _, base in loaded if base is not None]
    zero_us = min(known) if known else 0.0

    merged = []
    for rank, path, events, base in loaded:
        shift = (base - zero_us) if base is not None else 0.0
        named = False
        for ev in events:
            ev = dict(ev)
            ev["pid"] = rank
            if "ts" in ev:
                ev["ts"] = ev["ts"] + shift
            if ev.get("ph") in ("s", "t", "f") and "id" in ev \
                    and ev.get("cat") != GLOBAL_FLOW_CAT:
                # flow ids are per-rank counters; Chrome binds s/t/f
                # globally by (cat, id), so un-namespaced ids would draw
                # bogus cross-rank arrows. GLOBAL_FLOW_CAT ids are
                # allocated fleet-wide and WANT to cross pids (a
                # re-dispatched request's hop arrow).
                ev["id"] = int(ev["id"]) + rank * 1_000_000
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                named = True
            merged.append(ev)
        if not named:
            merged.append({"name": "process_name", "ph": "M", "pid": rank,
                           "args": {"name": f"rank {rank}"}})
            merged.append({"name": "process_sort_index", "ph": "M",
                           "pid": rank, "args": {"sort_index": rank}})
    if out_path is not None:
        with open(out_path, "w") as f:
            json.dump(merged, f)
    return merged


def expand_inputs(inputs):
    """Expand globs (the launcher shell may not have) and dedupe."""
    paths = []
    for item in inputs:
        hits = sorted(_glob.glob(item)) if any(c in item for c in "*?[") \
            else [item]
        for h in hits:
            if h not in paths:
                paths.append(h)
    return paths


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.telemetry.merge",
        description="Merge per-rank horovod_tpu Chrome traces into one "
                    "Perfetto-loadable trace with aligned clocks.")
    parser.add_argument("-o", "--output", required=True,
                        help="merged trace output path")
    parser.add_argument("traces", nargs="+",
                        help="per-rank trace files (globs ok)")
    args = parser.parse_args(argv)
    paths = expand_inputs(args.traces)
    if not paths:
        print("merge-timeline: no input traces matched", file=sys.stderr)
        return 1
    events = merge_traces(paths, args.output)
    print(f"merged {len(paths)} trace(s), {len(events)} events "
          f"-> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
