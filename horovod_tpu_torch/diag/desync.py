"""Cross-rank digest comparison: name the diverged rank while it hangs.

The port of ``horovod_tpu/diag/desync.py``, the same code.

Every rank's flight recorder maintains a rolling CRC chain over the
op/name/shape/dtype sequence of its collective dispatches
(``diag/recorder.py``). Two ranks that dispatched the same
schedule hold identical ``(seq, hash)`` pairs; the first divergent
dispatch forks the chain forever after. Ranks publish the compact digest
on the elastic KV heartbeats (``elastic/worker.py``); the driver's
cluster view feeds the collected digests through :func:`cross_check` —
the launcher-side mirror of the reference controller's shape/dtype
mismatch rejection (``controller.cc:55-346``), but one that works
post-hoc and for the compiled plane (whose schedule is recorded at trace
time).

The same function powers the doctor's offline analysis of per-rank
dumps, so online (hang in progress) and post-mortem (dumps on disk)
diagnosis cannot disagree about what a desync is.
"""


def _hist_map(digest):
    """``seq -> hash`` for one rank's digest (history + current)."""
    out = {}
    for pair in digest.get("hist") or []:
        try:
            s, h = pair
            out[int(s)] = int(h)
        except (TypeError, ValueError):
            continue
    if digest.get("seq") is not None and digest.get("hash") is not None:
        out[int(digest["seq"])] = int(digest["hash"])
    return out


def cross_check(digests, prev=None):
    """Compare per-rank schedule digests.

    ``digests`` is ``{rank: {"seq", "hash", "hist"}}``; ``prev`` is the
    previous call's ``digests`` (optional) for stopped-advancing
    detection. Returns::

        {"seqs": {rank: seq},
         "last_common_seq": int | None,   # highest seq seen by ALL ranks
         "desynced": [rank, ...],         # hash minority at that seq
         "stuck": [rank, ...],            # seq frozen while others moved
         "detail": str | None}

    Desync naming is majority-vote: at the highest seq present in every
    rank's (bounded) history, ranks whose hash disagrees with the largest
    agreeing group are named. Ranks so far apart that their histories no
    longer overlap produce no hash verdict — they show up through
    ``stuck``/progress instead.
    """
    digests = {int(r): d for r, d in digests.items() if d}
    out = {"seqs": {r: int(d.get("seq", 0)) for r, d in digests.items()},
           "last_common_seq": None, "desynced": [], "stuck": [],
           "detail": None}
    if len(digests) < 2:
        return out
    maps = {r: _hist_map(d) for r, d in digests.items()}
    common = set.intersection(*[set(m) for m in maps.values()])
    common.discard(0)
    if common:
        s = max(common)
        out["last_common_seq"] = s
        groups = {}
        for r, m in maps.items():
            groups.setdefault(m[s], []).append(r)
        if len(groups) > 1:
            # the largest group is "the schedule"; deterministic
            # tie-break by lowest member rank
            majority = max(groups.values(),
                           key=lambda rs: (len(rs), -min(rs)))
            out["desynced"] = sorted(r for rs in groups.values()
                                     if rs is not majority for r in rs)
            out["detail"] = (
                f"collective schedules diverged at seq {s}: "
                + "; ".join(
                    f"ranks {sorted(rs)} hash {h:#010x}"
                    for h, rs in sorted(groups.items(),
                                        key=lambda kv: sorted(kv[1]))))
    if prev:
        prev_seqs = {int(r): int(d.get("seq", 0))
                     for r, d in prev.items() if d}
        moved = [r for r, s in out["seqs"].items()
                 if s > prev_seqs.get(r, 0)]
        if moved:
            out["stuck"] = sorted(
                r for r, s in out["seqs"].items()
                if r in prev_seqs and s == prev_seqs[r] and r not in moved)
    return out
