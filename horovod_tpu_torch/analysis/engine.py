"""The hvd-lint engine of the port (the JAX package's
``analysis/engine.py``): rule registry, parallel walk, suppressions,
dated baseline with ratchet semantics (docs/ANALYSIS.md).

Design contract (mirrors the runtime diagnosis plane's "post-hoc and
online diagnosis cannot disagree" rule): a pass that lands before the
tree is clean ships its pre-existing findings in the committed baseline
file, every baseline entry is dated, and baseline *shrinkage is a
ratchet* — when a baselined finding disappears from the tree, the stale
entry fails the run until the baseline is re-written, so the removed
defect cannot silently come back under old slack. Inline suppressions
(``# hvd-lint: disable=RULE -- justification``) require a non-empty
justification; a bare disable is itself a finding (HVD-SUPPRESS).
"""

import ast
import concurrent.futures
import dataclasses
import io
import json
import os
import re
import time
import tokenize

# the rule a malformed / unjustified suppression is reported under —
# engine-level, cannot itself be suppressed
SUPPRESS_RULE = "HVD-SUPPRESS"

_SUPPRESS_RE = re.compile(
    r"#\s*hvd-lint:\s*disable=([A-Za-z0-9,\-]+)"
    r"(?:\s+--\s*(?P<why>.*\S))?\s*$")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One defect at one site. ``fingerprint`` is the stripped source
    line — line-number independent, so baselines survive unrelated
    edits above the finding."""
    rule: str
    file: str
    line: int
    col: int
    message: str
    hint: str = ""
    fingerprint: str = ""

    def format(self):
        s = f"{self.file}:{self.line}:{self.col}: {self.rule} {self.message}"
        if self.hint:
            s += f"\n    hint: {self.hint}"
        return s

    def as_json(self):
        return dataclasses.asdict(self)


class LintError(Exception):
    """Engine-level failure (unreadable file, bad baseline, rule crash)
    — the CLI maps this to exit code 2, never to a findings exit."""


@dataclasses.dataclass
class ParsedFile:
    path: str        # as walked (absolute or as given)
    rel: str         # relative to the lint root — the baseline key
    tree: ast.AST
    source: str
    lines: list      # 1-indexed access via lines[lineno - 1]


@dataclasses.dataclass
class Rule:
    name: str
    scope: str       # "file" | "project"
    doc: str
    check: object    # file: f(ParsedFile) -> [Finding]; project: f({rel: ParsedFile}, root) -> [Finding]
    # project rules may anchor findings in files the walk never parses
    # (HVD-METRIC: the docs table). scope_files(parsed, root) names the
    # extra files the rule ACTUALLY examined this run, so baseline
    # entries for them stay matchable (and ratchetable) — without it a
    # docs-anchored entry would never spend its budget.
    scope_files: object = None


_RULES = {}


def register(name, scope="file", doc="", scope_files=None):
    """Decorator: register a pass under its HVD-* name."""
    def deco(fn):
        if name in _RULES:
            raise LintError(f"duplicate rule {name}")
        _RULES[name] = Rule(name=name, scope=scope, doc=doc or fn.__doc__
                            or "", check=fn, scope_files=scope_files)
        return fn
    return deco


def all_rules():
    return dict(_RULES)


# ---------------------------------------------------------------------------
# walk + parse


def default_targets(root):
    """The port's lint surface: the package and ``chip_smoke.py``."""
    out = []
    for name in ("horovod_tpu_torch", "chip_smoke.py"):
        p = os.path.join(root, name)
        if os.path.exists(p):
            out.append(p)
    return out


def _collect(paths):
    files, seen = [], set()

    def add(path):
        real = os.path.realpath(path)
        if real not in seen:  # overlapping targets: parse once
            seen.add(real)
            files.append(path)

    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, names in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if d != "__pycache__"
                               and not d.startswith(".")]
                for n in sorted(names):
                    if n.endswith(".py"):
                        add(os.path.join(dirpath, n))
        elif os.path.isfile(p):
            add(p)
        else:
            raise LintError(f"no such lint target: {p}")
    return files


def _parse_one(path, root):
    try:
        with open(path, encoding="utf-8") as f:
            source = f.read()
        tree = ast.parse(source, filename=path)
    except (OSError, SyntaxError, ValueError) as e:
        raise LintError(f"cannot parse {path}: {e}")
    rel = os.path.relpath(path, root)
    if rel.startswith(".."):
        rel = path  # outside the root: keep the full path as the key
    # baseline keys and finding paths are ALWAYS forward-slash — the
    # committed ledger must match on every platform
    rel = rel.replace(os.sep, "/")
    return ParsedFile(path=path, rel=rel, tree=tree, source=source,
                      lines=source.splitlines())


# ---------------------------------------------------------------------------
# suppressions


def _comment_tokens(pf):
    """``[(lineno, col, text)]`` for real COMMENT tokens only — a
    suppression-shaped line inside a string literal or docstring (e.g.
    documentation showing the syntax) must neither suppress nor be
    flagged as malformed. Falls back to a per-line scan restricted to
    lines the tokenizer never saw if tokenization fails (it should
    not: the file already parsed)."""
    try:
        return [(tok.start[0], tok.start[1], tok.string)
                for tok in tokenize.generate_tokens(
                    io.StringIO(pf.source).readline)
                if tok.type == tokenize.COMMENT]
    except (tokenize.TokenError, IndentationError):  # pragma: no cover
        return [(i, t.index("#"), t[t.index("#"):])
                for i, t in enumerate(pf.lines, start=1) if "#" in t]


def _suppressions(pf):
    """``({lineno: rules}, [malformed findings])``. A comment on its
    own line covers the NEXT line; a trailing comment covers its own
    line. A disable without a ``-- justification`` is itself a finding
    (HVD-SUPPRESS) — the justification is the suppression's contract."""
    covered, malformed = {}, []
    for lineno, col, text in _comment_tokens(pf):
        m = _SUPPRESS_RE.search(text)
        if not m:
            continue
        rules = {r.strip().upper() for r in m.group(1).split(",")
                 if r.strip()}
        why = m.group("why")
        own_line = pf.lines[lineno - 1].lstrip().startswith("#")
        target = lineno + 1 if own_line else lineno
        if not why:
            malformed.append(Finding(
                rule=SUPPRESS_RULE, file=pf.rel, line=lineno,
                col=col + 1,
                message="suppression without a justification",
                hint="write `# hvd-lint: disable=RULE -- <why this is "
                     "safe>` — the justification is load-bearing "
                     "(docs/ANALYSIS.md)",
                fingerprint=text.strip()))
            continue
        covered.setdefault(target, set()).update(rules)
    return covered, malformed


# ---------------------------------------------------------------------------
# baseline


def load_baseline(path):
    if path is None or not os.path.exists(path):
        return []
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        entries = data["entries"]
        for e in entries:
            for key in ("rule", "file", "fingerprint", "count", "date"):
                if key not in e:
                    raise KeyError(key)
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise LintError(f"bad baseline file {path}: {e!r}")
    return entries


def write_baseline(path, findings, previous=None, date=None, keep=()):
    """Serialize ``findings`` as the new baseline. Entries that already
    existed keep their original date (the date records when the debt was
    incurred, not when the file was last rewritten). ``keep`` carries
    prior entries that were OUTSIDE the producing run's scope — they
    are written back verbatim so a partial-target or rule-restricted
    ``--baseline write`` cannot delete another subtree's debt."""
    date = date or time.strftime("%Y-%m-%d")
    prev_dates = {}
    for e in previous or []:
        prev_dates[(e["rule"], e["file"], e["fingerprint"])] = e["date"]
    counts = {}
    for f in findings:
        key = (f.rule, f.file, f.fingerprint)
        counts[key] = counts.get(key, 0) + 1
    entries = [
        {"rule": rule, "file": file, "fingerprint": fp, "count": n,
         "date": prev_dates.get((rule, file, fp), date)}
        for (rule, file, fp), n in sorted(counts.items())]
    entries = sorted(
        entries + [dict(e) for e in keep],
        key=lambda e: (e["rule"], e["file"], e["fingerprint"]))
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": 1,
                   "comment": "hvd-lint debt ledger — shrink-only "
                              "(docs/ANALYSIS.md); regenerate with "
                              "`hvd-lint-torch --baseline write`",
                   "entries": entries}, f, indent=1, sort_keys=False)
        f.write("\n")
    return entries


def _apply_baseline(findings, entries):
    """Split findings into (unbaselined, baselined) and compute stale
    entries (the ratchet: a baselined finding that no longer exists)."""
    budget = {}
    for e in entries:
        key = (e["rule"], e["file"], e["fingerprint"])
        budget[key] = budget.get(key, 0) + int(e["count"])
    spent = {}
    new, old = [], []
    for f in findings:
        key = (f.rule, f.file, f.fingerprint)
        if spent.get(key, 0) < budget.get(key, 0):
            spent[key] = spent.get(key, 0) + 1
            old.append(f)
        else:
            new.append(f)
    stale = []
    for e in entries:
        key = (e["rule"], e["file"], e["fingerprint"])
        used = min(spent.get(key, 0), int(e["count"]))
        spent[key] = spent.get(key, 0) - used
        if used < int(e["count"]):
            stale.append(dict(e, count=int(e["count"]) - used))
    return new, old, stale


# ---------------------------------------------------------------------------
# the run


@dataclasses.dataclass
class LintResult:
    findings: list          # unsuppressed, unbaselined — these fail the run
    suppressed: list        # (finding, justification-covered)
    baselined: list
    stale_baseline: list    # ratchet violations — these ALSO fail the run
    all_findings: list      # post-suppression, pre-baseline (--baseline write input)
    files: int = 0
    walked: frozenset = frozenset()   # rel paths parsed OR examined by
    #                                   a project rule (scope_files)
    rules: frozenset = frozenset()    # rule names this run executed

    @property
    def clean(self):
        return not self.findings and not self.stale_baseline

    def as_json(self):
        return {
            "clean": self.clean,
            "files": self.files,
            "findings": [f.as_json() for f in self.findings],
            "suppressed": len(self.suppressed),
            "baselined": len(self.baselined),
            "stale_baseline": self.stale_baseline,
        }


def _check_file(rule, pf):
    try:
        return list(rule.check(pf))
    except LintError:
        raise
    except Exception as e:  # hvd-lint: disable=HVD-EXCEPT -- a rule crash must surface as an engine error (exit 2) with the rule named, not kill the whole run anonymously
        raise LintError(f"rule {rule.name} crashed on {pf.rel}: {e!r}")


def run_lint(paths, root=None, rules=None, baseline_path=None,
             jobs=None):
    """Run the registered passes over ``paths``.

    ``root`` anchors the relative file keys used by baselines and
    findings (default: cwd). ``rules`` restricts to a subset of rule
    names. ``baseline_path`` points at the committed debt ledger.
    """
    root = os.path.abspath(root or os.getcwd())
    selected = all_rules()
    if rules is not None:
        unknown = set(rules) - set(selected)
        if unknown:
            raise LintError(f"unknown rule(s): {sorted(unknown)}")
        selected = {n: r for n, r in selected.items() if n in rules}
    if not selected:
        raise LintError("no rules registered — import "
                        "horovod_tpu_torch.analysis (not .engine) to load "
                        "the passes")
    files = _collect(list(paths))
    file_rules = [r for r in selected.values() if r.scope == "file"]
    proj_rules = [r for r in selected.values() if r.scope == "project"]

    parsed = {}
    raw = []

    def _one(path):
        pf = _parse_one(path, root)
        out = []
        for r in file_rules:
            out.extend(_check_file(r, pf))
        return pf, out

    # per-file parallel walk: parse + file-scoped passes fan out over a
    # thread pool (the AST work is pure-Python but I/O and the many
    # small files still overlap; jobs=1 gives a deterministic
    # single-threaded walk for debugging)
    jobs = jobs or min(8, (os.cpu_count() or 2))
    if jobs <= 1 or len(files) <= 1:
        results = [_one(p) for p in files]
    else:
        with concurrent.futures.ThreadPoolExecutor(jobs) as ex:
            results = list(ex.map(_one, files))
    for pf, founds in results:
        parsed[pf.rel] = pf
        raw.extend(founds)
    for r in proj_rules:
        try:
            raw.extend(r.check(parsed, root))
        except LintError:
            raise
        except Exception as e:  # hvd-lint: disable=HVD-EXCEPT -- same contract as _check_file: name the crashed rule, exit 2
            raise LintError(f"rule {r.name} crashed: {e!r}")

    # suppressions (per file), then the baseline
    kept, suppressed = [], []
    sup_cache = {}
    for f in raw:
        pf = parsed.get(f.file)
        if pf is None:
            kept.append(f)
            continue
        if f.file not in sup_cache:
            covered, malformed = _suppressions(pf)
            sup_cache[f.file] = covered
            kept.extend(malformed)
        covered = sup_cache[f.file]
        if f.rule != SUPPRESS_RULE and f.rule in covered.get(f.line, ()):
            suppressed.append(f)
        else:
            kept.append(f)
    # files with malformed suppressions but zero findings still report
    for rel, pf in parsed.items():
        if rel not in sup_cache:
            covered, malformed = _suppressions(pf)
            sup_cache[rel] = covered
            kept.extend(malformed)

    # scope the baseline to this run: entries for rules that did not
    # run are inert, and entries for files that exist under the root
    # but were not walked (a partial-target run) neither spend budget
    # nor count as stale. Entries for files that no longer exist at
    # all DO count as stale — a deleted file's debt must leave the
    # ledger with it (the ratchet). Project rules extend the scope
    # with the non-walked files they examined (HVD-METRIC: the docs
    # table), else their doc-anchored findings could never baseline.
    in_scope = frozenset(parsed)
    for r in proj_rules:
        if r.scope_files is not None:
            in_scope |= frozenset(r.scope_files(parsed, root))
    entries = [e for e in load_baseline(baseline_path)
               if e["rule"] in selected and e["rule"] != SUPPRESS_RULE
               and (e["file"] in in_scope
                    or not os.path.exists(os.path.join(root, e["file"])))]
    baselinable = [f for f in kept if f.rule != SUPPRESS_RULE]
    unsupp = [f for f in kept if f.rule == SUPPRESS_RULE]
    new, old, stale = _apply_baseline(baselinable, entries)
    new.extend(unsupp)
    new.sort(key=lambda f: (f.file, f.line, f.rule))
    return LintResult(findings=new, suppressed=suppressed, baselined=old,
                      stale_baseline=stale, all_findings=kept,
                      files=len(files), walked=in_scope,
                      rules=frozenset(selected))


def entry_in_scope(entry, result, root):
    """Was this baseline entry within ``result``'s run scope? (Same
    predicate the run itself applies.) Out-of-scope entries — rules
    that did not run, files that exist under the root but were not
    walked — must be PRESERVED by ``--baseline write``, or a partial
    run would silently delete another subtree's debt (and its incurred
    dates) from the ledger."""
    return entry["rule"] in result.rules and (
        entry["file"] in result.walked
        or not os.path.exists(os.path.join(root, entry["file"])))
