"""The desync doctor: aggregate per-rank flight-recorder dumps into one
hang report.

    hvd-doctor-torch <logdir>
    hvd-doctor-torch hang|perf|serve|xray <dir>
    hvdrun-torch --doctor <logdir>
    python -m horovod_tpu_torch.diag.doctor [hang|perf|serve|xray] <dir>

The port of ``horovod_tpu/diag/doctor.py``, the same code: it reads the
dumps of either package (one schema), and its ``--json`` report is the
JAX doctor's on the same dumps.

The doctor answers, from dumps alone (no live processes needed): which
ranks never dumped (hard-killed — SIGKILL and OOM leave no black box),
the last ``collective_seq`` every surviving rank completed, the
collective each straggler is parked in, whether the collective schedules
diverged (desync), and a probable-cause classification:

* ``dead rank``    — expected ranks left no dump; survivors are parked in
  a collective the dead rank never joined (the post-mortem analogue of
  the reference stall inspector's "missing ranks" warning,
  ``stall_inspector.cc``).
* ``desync``       — all ranks alive but their op/name/shape schedules
  forked (the mismatch the reference controller would have rejected at
  negotiation time, ``controller.cc:55-346``).
* ``data stall``   — a rank finished its step and never started the next
  one (input pipeline starved) while peers wait in a collective.
* ``compile stall``— a rank entered a step and emitted no collective
  since (stuck in compilation / first dispatch) while peers progressed.
* ``graceful eviction`` — rank(s) ran the preemption drain path
  (``elastic/preempt.py``): a spot notice / SIGTERM triggered a bounded
  grace commit and a clean exit. NOT a failure — the verdict exists so a
  drained host is never misreported as a dead rank.
* ``healthy``      — every rank dumped via clean exit paths with nothing
  left open.

``hvdrun-torch`` runs this automatically when a job exits non-zero and dumps
are present (opt out with ``--no-doctor``).
"""

import argparse
import json
import os
import sys

from horovod_tpu_torch.diag import desync as desync_lib
from horovod_tpu_torch.diag.recorder import DUMP_PREFIX

TIMELINE_EVENTS_PER_RANK = 12
CLEAN_REASONS = ("exit", "shutdown")


def find_dumps(logdir):
    """All ``flightrec.rank*.json`` paths under ``logdir`` (recursive —
    elastic jobs write per-epoch subdirectories)."""
    out = []
    for root, _dirs, files in os.walk(logdir):
        for f in files:
            if f.startswith(DUMP_PREFIX) and f.endswith(".json") \
                    and ".tmp." not in f:
                out.append(os.path.join(root, f))
    return sorted(out)


def load_dumps(logdir):
    """Parse dumps; on duplicate ranks (elastic epochs) keep the most
    recent by wall clock. Returns ``(dumps_by_rank, skipped_paths)``."""
    dumps, skipped = {}, []
    for path in find_dumps(logdir):
        try:
            with open(path) as f:
                d = json.load(f)
            if not d.get("flightrec"):
                raise ValueError("not a flight-recorder dump")
        except (OSError, ValueError) as e:
            skipped.append((path, str(e)))
            continue
        d["_path"] = path
        r = int(d.get("rank", -1))
        prev = dumps.get(r)
        if prev is None or (d.get("clock", {}).get("wall", 0)
                            >= prev.get("clock", {}).get("wall", 0)):
            dumps[r] = d
    return dumps, skipped


def _parked(dump):
    """(seq, op) of the collective this rank is parked in, or None: the
    highest-seq eager entry without a matching exit."""
    open_c = dump.get("open_collectives") or {}
    if not open_c:
        return None
    seq = max(int(s) for s in open_c)
    return seq, open_c[str(seq)]


def _last_event(dump, kinds=None):
    for ev in reversed(dump.get("events") or []):
        if kinds is None or ev.get("k") in kinds:
            return ev
    return None


def _data_state(dump):
    """The input-pipeline picture of one rank's dump: the producer batch
    still open (``data`` B with no matching E — the prefetch thread was
    mid-assembly when the dump fired) and the consumer stall still open
    (``data_wait`` B with no E — the TRAINING thread was starved). The
    loaders emit both (data/loader.py), which is what lets
    a data-stall verdict indict a named producer instead of guessing."""
    open_batch = open_wait = None
    for ev in dump.get("events") or []:
        k = ev.get("k")
        if k == "data":
            open_batch = ev if ev.get("ph") == "B" else None
        elif k == "data_wait":
            open_wait = ev if ev.get("ph") == "B" else None
    return open_batch, open_wait


def _open_ckpt_saves(dump):
    """Checkpoint steps this rank BEGAN saving (``ckpt`` ph=B) with no
    matching commit/failure (ph=E) in the ring: saves the crash
    interrupted. Their manifest was never written, so restore falls back
    to the previous complete step — worth saying out loud. Paired in
    event order, not by set membership: a step saved twice (failed or
    torn once, re-saved after restore) is open again after its later
    B, no matter how its first attempt ended."""
    open_ = {}
    for ev in dump.get("events") or []:
        if ev.get("k") != "ckpt":
            continue
        if ev.get("ph") == "B" and ev.get("step") is not None:
            open_[ev["step"]] = ev
        elif ev.get("ph") == "E":
            open_.pop(ev.get("step"), None)
    return sorted(open_)


def diagnose(dumps, expected_size=None):
    """Build the report dict from ``{rank: dump}`` (see
    :func:`load_dumps`). Pure function of the dumps — unit-testable with
    synthesized recorders on a fake clock."""
    ranks = sorted(dumps)
    expected = expected_size or max(
        [d.get("size", 0) for d in dumps.values()] + [len(dumps)])
    dead = [r for r in range(expected) if r not in dumps]

    per_rank = {}
    for r in ranks:
        d = dumps[r]
        last = _last_event(d, kinds=("coll", "step", "epoch", "heartbeat"))
        failed = None
        if (last and last.get("k") == "coll" and last.get("ph") == "E"
                and last.get("ok") is False):
            failed = (last.get("seq"), last.get("op"))
        open_batch, open_wait = _data_state(d)
        preempt_ev = _last_event(d, kinds=("preempt",))
        evicted_rank = (preempt_ev is not None
                        or "preempt" in (d.get("dump_reasons") or []))
        per_rank[r] = {
            "seq": d.get("collective_seq", 0),
            "completed": d.get("last_completed_seq", 0),
            "parked": _parked(d),
            "failed": failed,
            "last_event": last,
            "data_open": open_batch,
            "data_wait_open": open_wait,
            "preempt": preempt_ev,
            "evicted": evicted_rank,
            "dump_reasons": d.get("dump_reasons") or [],
            "config_crc": d.get("config_crc"),
            "host": d.get("host"),
            "path": d.get("_path"),
        }

    completed = [i["completed"] for i in per_rank.values()]
    entered = [i["seq"] for i in per_rank.values()]
    last_common = (min(completed) if any(completed)
                   else (min(entered) if entered else 0))

    digest_view = desync_lib.cross_check(
        {r: dumps[r].get("digest") or {} for r in ranks})

    crcs = {i["config_crc"] for i in per_rank.values()
            if i["config_crc"] is not None}
    config_mismatch = sorted(crcs) if len(crcs) > 1 else None

    parked = {r: i["parked"] for r, i in per_rank.items() if i["parked"]}
    clean = [r for r, i in per_rank.items()
             if not i["parked"]
             and any(x in CLEAN_REASONS for x in i["dump_reasons"])]

    evicted = sorted(r for r, i in per_rank.items() if i["evicted"])
    cause, why = _classify(expected, dead, digest_view, per_rank, parked,
                           clean, evicted)

    interrupted_saves = {}
    for r in ranks:
        pend = _open_ckpt_saves(dumps[r])
        if pend:
            interrupted_saves[r] = pend

    timeline = []
    for r in ranks:
        for ev in (dumps[r].get("events") or [])[-TIMELINE_EVENTS_PER_RANK:]:
            timeline.append({"rank": r, **ev})
    timeline.sort(key=lambda ev: ev.get("t", 0))

    return {
        "expected_size": expected,
        "ranks_with_dumps": ranks,
        "dead_ranks": dead,
        "last_common_seq": last_common,
        "per_rank": per_rank,
        "desync": digest_view,
        "config_mismatch": config_mismatch,
        "classification": cause,
        "explanation": why,
        "evicted_ranks": evicted,
        "interrupted_saves": interrupted_saves,
        "timeline": timeline,
    }


def _classify(expected, dead, digest_view, per_rank, parked, clean,
              evicted=()):
    parked_ops = sorted({op for _s, op in parked.values()})
    failed = {r: i["failed"] for r, i in per_rank.items()
              if i.get("failed")}
    if dead:
        why = f"rank(s) {dead} left no flight-recorder dump (hard-killed: " \
              "SIGKILL/OOM leave no black box)"
        if parked:
            seqs = sorted({s for s, _op in parked.values()})
            why += (f"; surviving rank(s) {sorted(parked)} are parked in "
                    f"{'/'.join(parked_ops)} (seq {seqs[-1]}) waiting for "
                    "them")
        if failed:
            ops = sorted({op for _s, op in failed.values()})
            why += (f"; rank(s) {sorted(failed)} saw {'/'.join(ops)} fail "
                    "under them when the peer vanished")
        return "dead rank", why
    if digest_view.get("desynced"):
        return "desync", digest_view.get("detail") or (
            f"ranks {digest_view['desynced']} diverged from the majority "
            "collective schedule")
    if evicted:
        # planned drain, not a failure: the eviction dump is the proof
        # the rank exited on purpose — never report it as dead/hung
        kinds, outcomes = [], []
        for r in evicted:
            ev = per_rank[r].get("preempt") or {}
            if ev.get("kind"):
                kinds.append(str(ev["kind"]))
            if ev.get("outcome"):
                outcomes.append(f"rank {r}: {ev['outcome']}")
        why = (f"rank(s) {list(evicted)} ran the graceful-eviction path "
               "(preemption notice -> bounded grace commit -> clean "
               "exit; elastic/preempt.py)")
        if kinds:
            why += f"; notice kind(s): {'/'.join(sorted(set(kinds)))}"
        if outcomes:
            why += f"; commit outcome(s): {', '.join(outcomes)}"
        bystanders = sorted(set(parked) - set(evicted))
        if bystanders:
            why += (f"; rank(s) {bystanders} were parked in "
                    f"{'/'.join(parked_ops)} awaiting the next rendezvous "
                    "when their dump fired")
        return "graceful eviction", why
    if len(clean) == len(per_rank) and per_rank:
        return "healthy", "every rank dumped on a clean exit path with " \
                          "no collective left open"
    if parked and len(parked) < len(per_rank):
        idle = sorted(set(per_rank) - set(parked))
        for r in idle:
            last = per_rank[r]["last_event"] or {}
            if last.get("k") == "step" and last.get("ph") == "B":
                return "compile stall", (
                    f"rank {r} entered step {last.get('step')} and emitted "
                    f"no collective since, while rank(s) {sorted(parked)} "
                    f"wait in {'/'.join(parked_ops)}: stuck compiling or "
                    "dispatching")
        detail = []
        for r in idle:
            wait = per_rank[r].get("data_wait_open")
            prod = per_rank[r].get("data_open")
            if wait:
                detail.append(
                    f"rank {r}'s training thread was starved waiting on "
                    f"batch {wait.get('batch')} of epoch "
                    f"{wait.get('epoch')} from its "
                    f"{wait.get('source')} producer")
            if prod:
                detail.append(
                    f"rank {r}'s producer ({prod.get('source')}) was "
                    f"still assembling epoch {prod.get('epoch')} batch "
                    f"{prod.get('batch')} when the dump fired")
        why = (
            f"rank(s) {idle} finished their last step and never entered "
            f"the next collective (input pipeline starved) while rank(s) "
            f"{sorted(parked)} wait in {'/'.join(parked_ops)}")
        if detail:
            why += "; " + "; ".join(detail)
        return "data stall", why
    if parked:
        seqs = sorted({s for s, _op in parked.values()})
        return "collective hang", (
            f"every rank is parked in {'/'.join(parked_ops)} "
            f"(seq {seqs[-1]}) with no dead or desynced rank: suspect the "
            "transport/runtime under the collective")
    return "unknown", "no dead, desynced, parked or cleanly-exited " \
                      "pattern matched; read the timeline below"


def _fmt_event(ev):
    parts = [f"{ev.get('t', 0):.6f}", f"rank {ev.get('rank')}",
             str(ev.get("k"))]
    for key in ("ph", "seq", "op", "name", "step", "reason", "signum",
                "epoch", "batch", "source", "kind", "outcome"):
        if ev.get(key) is not None:
            parts.append(f"{key}={ev[key]}")
    if ev.get("ok") is False:
        parts.append("ERROR")
    return "  ".join(parts)


def format_report(report):
    lines = []
    add = lines.append
    add("==== horovod_tpu doctor report " + "=" * 34)
    add(f"ranks expected: {report['expected_size']}, dumps found: "
        f"{len(report['ranks_with_dumps'])} "
        f"(ranks {report['ranks_with_dumps']})")
    if report["dead_ranks"]:
        add("DEAD (no flight-recorder dump): rank(s) "
            + ", ".join(str(r) for r in report["dead_ranks"]))
    add(f"last common collective_seq: {report['last_common_seq']}")
    for r, info in sorted(report["per_rank"].items()):
        state = ""
        if info.get("evicted"):
            ev = info.get("preempt") or {}
            state = ("EVICTED"
                     + (f" ({ev.get('kind')}" if ev.get("kind") else "")
                     + (f", commit {ev['outcome']})" if ev.get("outcome")
                        else (")" if ev.get("kind") else "")))
        elif info["parked"]:
            seq, op = info["parked"]
            state = f"PARKED in {op} (seq {seq})"
        elif info.get("failed"):
            seq, op = info["failed"]
            state = f"FAILED in {op} (seq {seq})"
        else:
            last = info["last_event"] or {}
            state = (f"last event: {last.get('k')}"
                     + (f" {last.get('ph')}" if last.get("ph") else "")
                     + (f" step={last.get('step')}"
                        if last.get("step") is not None else ""))
        add(f"rank {r}: seq entered {info['seq']}, completed "
            f"{info['completed']}; {state}; dump reasons "
            f"{info['dump_reasons']}")
    if report["desync"].get("desynced"):
        add("DESYNC: " + (report["desync"].get("detail") or
                          str(report["desync"]["desynced"])))
    if report.get("config_mismatch"):
        add("CONFIG MISMATCH: ranks ran with differing config "
            f"fingerprints {report['config_mismatch']} — check HOROVOD_* "
            "env parity")
    for r, steps in sorted((report.get("interrupted_saves") or {}).items()):
        add(f"INTERRUPTED CHECKPOINT SAVE: rank {r} was mid-save of "
            f"step(s) {steps} when the job died — no manifest was "
            "committed, so restore falls back to the last complete "
            "checkpoint (the torn dir is ignored and later GC'd)")
    add(f"probable cause: {report['classification']} — "
        f"{report['explanation']}")
    add("timeline (clock-aligned, last events per rank):")
    for ev in report["timeline"]:
        add("  " + _fmt_event(ev))
    add("=" * 66)
    return "\n".join(lines)


def run(logdir, expected_size=None, stream=None):
    """Load dumps under ``logdir``, print the report. Returns the report
    dict, or None when no dumps exist."""
    stream = stream or sys.stderr
    dumps, skipped = load_dumps(logdir)
    for path, err in skipped:
        print(f"doctor: skipping {path}: {err}", file=stream)
    if not dumps:
        print(f"doctor: no {DUMP_PREFIX}*.json dumps under {logdir}",
              file=stream)
        return None
    report = diagnose(dumps, expected_size=expected_size)
    print(format_report(report), file=stream)
    return report


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="hvd-doctor-torch",
        description="Aggregate per-rank flight-recorder dumps into a "
                    "hang/crash report.")
    p.add_argument("logdir", help="directory containing "
                                  "flightrec.rank*.json dumps (searched "
                                  "recursively)")
    p.add_argument("--expected-size", type=int, default=None,
                   help="world size to check for missing ranks (default: "
                        "from the dumps)")
    p.add_argument("--json", action="store_true",
                   help="print the report dict as JSON on stdout (the "
                        "human-readable report moves to stderr)")
    args = p.parse_args(argv)
    report = run(args.logdir, expected_size=args.expected_size,
                 stream=sys.stderr if args.json else sys.stdout)
    if report is not None and args.json:
        import json as _json
        print(_json.dumps(report, indent=2, sort_keys=True, default=str))
    return 2 if report is None else 0


def _perf_main(argv):
    from horovod_tpu_torch.telemetry import report
    return report.main(argv)


def _serve_main(argv):
    from horovod_tpu_torch.diag import serve_doctor
    return serve_doctor.main(argv)


def _xray_main(argv):
    from horovod_tpu_torch.diag import xray
    return xray.main(argv)


# ONE dispatch table for every doctor, all sharing the same
# conventions: a dump-dir positional, --json for machine output (report
# prose moves to stderr), exit 2 when the dir holds nothing readable
SUBCOMMANDS = {
    "hang": main,          # flight-recorder hang/crash report (default)
    "perf": _perf_main,    # goodput-ledger host-time attribution
    "serve": _serve_main,  # per-request tail-latency attribution
    "xray": _xray_main,    # compiled-step device-time attribution
}


def doctor_cli(argv=None):
    """The ``hvd-doctor-torch`` entry point (``bin/hvd-doctor-torch``,
    ``python -m horovod_tpu_torch.diag.doctor``) — ``hvd-doctor-torch
    <subcommand> <dir> [--json]`` with the subcommands in
    :data:`SUBCOMMANDS`; a bare ``hvd-doctor-torch <dir>`` means
    ``hang``, as JAX's ``hvd-doctor <dir>`` does."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in SUBCOMMANDS:
        return SUBCOMMANDS[argv[0]](argv[1:])
    return main(argv)


if __name__ == "__main__":
    sys.exit(doctor_cli())
