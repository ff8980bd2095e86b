"""``hvd-lint-torch`` — the port's static-analysis CLI (the JAX
package's ``hvd-lint``, docs/ANALYSIS.md), also run as ``python -m
horovod_tpu_torch.analysis.cli``.

    hvd-lint-torch                              # the port's surface from cwd
    hvd-lint-torch horovod_tpu_torch/elastic    # lint a subtree
    hvd-lint-torch --rules HVD-MESH             # one pass only
    hvd-lint-torch --format json                # structured findings
    hvd-lint-torch --baseline write             # re-ratchet the debt ledger

Exit codes (matches the conventions of bin/hvd-doctor-torch and
bin/hvd-serve-torch): 0 clean, 1 findings (or stale baseline entries —
the ratchet), 2 engine error (unparseable file, bad baseline, rule
crash).
"""

import argparse
import json
import os
import sys

from horovod_tpu_torch.analysis import engine
from horovod_tpu_torch.analysis import rules as _rules  # noqa: F401

BASELINE_NAME = ".hvd-lint-torch-baseline.json"


def _parser():
    p = argparse.ArgumentParser(
        prog="hvd-lint-torch",
        description="project-native static analysis: collective-desync,"
                    " host-sync, lock-order, signal-safety, broad-except"
                    ", off-mesh and metric-drift passes")
    p.add_argument("paths", nargs="*",
                   help="files/directories to lint (default: "
                        "horovod_tpu_torch/ and chip_smoke.py under "
                        "--root)")
    p.add_argument("--root", default=None,
                   help="project root anchoring relative paths and the "
                        "baseline (default: cwd)")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule subset (e.g. HVD-MESH)")
    p.add_argument("--baseline", default=None, choices=("write",),
                   help="'write' regenerates the baseline from current "
                        "findings (the only way the debt ledger may "
                        "change); entries outside this run's scope are "
                        "preserved")
    p.add_argument("--baseline-file", default=None,
                   help=f"debt ledger path (default: <root>/"
                        f"{BASELINE_NAME})")
    p.add_argument("--no-baseline", action="store_true",
                   help="report every finding, ignoring the ledger")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--jobs", type=int, default=None,
                   help="parallel file-walk width (1 = deterministic "
                        "sequential)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalogue and exit")
    return p


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.list_rules:
        for name, rule in sorted(engine.all_rules().items()):
            doc = " ".join((rule.doc or "").split())
            print(f"{name:15s} [{rule.scope}] {doc}")
        return 0
    # everything through the baseline write sits inside one guard: any
    # engine failure OR environment failure (unreadable root, unwritable
    # baseline) is exit 2 — never mistakable for "findings present"
    try:
        root = os.path.abspath(args.root or os.getcwd())
        paths = args.paths or engine.default_targets(root)
        if not paths:
            print("hvd-lint-torch: nothing to lint (no default targets under "
                  f"{root})", file=sys.stderr)
            return 2
        baseline_file = args.baseline_file or os.path.join(
            root, BASELINE_NAME)
        rules = None
        if args.rules:
            rules = {r.strip().upper() for r in args.rules.split(",")
                     if r.strip()}
        result = engine.run_lint(
            paths, root=root, rules=rules,
            baseline_path=None if args.no_baseline else baseline_file,
            jobs=args.jobs)
        if args.baseline == "write":
            previous = engine.load_baseline(
                baseline_file if os.path.exists(baseline_file) else None)
            entries = engine.write_baseline(
                baseline_file,
                [f for f in result.all_findings
                 if f.rule != engine.SUPPRESS_RULE],
                previous=previous,
                keep=[e for e in previous
                      if not engine.entry_in_scope(e, result, root)])
            print(f"hvd-lint-torch: wrote {len(entries)} baseline entr"
                  f"{'y' if len(entries) == 1 else 'ies'} to "
                  f"{baseline_file}")
            unsupp = [f for f in result.all_findings
                      if f.rule == engine.SUPPRESS_RULE]
            for f in unsupp:
                print(f.format())
            return 1 if unsupp else 0
    except (engine.LintError, OSError) as e:
        print(f"hvd-lint-torch: error: {e}", file=sys.stderr)
        return 2

    if args.format == "json":
        print(json.dumps(result.as_json(), indent=1))
    else:
        for f in result.findings:
            print(f.format())
        for e in result.stale_baseline:
            print(f"{e['file']}: STALE-BASELINE {e['rule']} x"
                  f"{e['count']} (`{e['fingerprint']}`, dated "
                  f"{e['date']}) no longer found — the ratchet: run "
                  "`hvd-lint-torch --baseline write` so the fixed finding "
                  "cannot silently come back")
        tail = (f"{result.files} files, "
                f"{len(result.findings)} finding(s), "
                f"{len(result.suppressed)} suppressed, "
                f"{len(result.baselined)} baselined, "
                f"{len(result.stale_baseline)} stale")
        print(("clean: " if result.clean else "FAILED: ") + tail)
    return 0 if result.clean else 1


if __name__ == "__main__":
    sys.exit(main())
