"""HVD-METRIC: metric-name drift — the former
tests/test_telemetry.py docs↔code pytest guard as an engine pass, plus
a use-site check the pytest version could not do.

Three checks against ``telemetry/instruments.py``'s CATALOGUE (parsed
from the AST, no imports — the pass must run without torch installed):

1. a name documented in docs/OBSERVABILITY.md's metric tables but not
   in CATALOGUE (a documented ghost), flagged at the table row;
2. a CATALOGUE name missing from the docs, flagged at the CATALOGUE
   tuple;
3. a registry registration (``.counter(``/``.gauge(``/``.histogram(``)
   whose name is a string literal not in CATALOGUE, flagged at the use
   site — the drift the old guard only caught if the author also
   remembered to touch the docs.

Plus the serving-trace twin of the same contract: every span kind in
``serve/tracing.py``'s SPAN_KINDS must have an entry in the serve
doctor's PHASE_OF_KIND classifier (``diag/serve_doctor.py``) and vice
versa — a kind the tracer emits but the doctor cannot classify lands
in the slow-request report as dead weight, and a classifier entry for
a kind the tracer never emits is documentation rot. Both directions
are flagged; the sub-check is skipped when either file is absent from
the parsed tree (partial-tree runs).
"""

import ast
import os
import re

from horovod_tpu_torch.analysis import engine
from horovod_tpu_torch.analysis.rules import common

_INSTRUMENTS_SUFFIX = "telemetry/instruments.py"
_TRACING_SUFFIX = "serve/tracing.py"
_SERVE_DOCTOR_SUFFIX = "diag/serve_doctor.py"
_DOC = "docs/OBSERVABILITY.md"  # forward-slash: baseline/finding key
_DOC_ROW = re.compile(r"^\|\s*`(hvd_[a-z0-9_]+)`\s*\|")
_REGISTER_CALLS = frozenset({"counter", "gauge", "histogram"})
_NAME_RE = re.compile(r"hvd_[a-z0-9_]+\Z")


def _catalogue(pf):
    """(names, catalogue_lineno, legacy_values) parsed from the
    instruments module's AST."""
    consts, catalogue, lineno, legacy = {}, [], 1, set()
    for node in pf.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if isinstance(node.value, ast.Constant) and isinstance(
                    node.value.value, str):
                consts[name] = node.value.value
            elif name == "CATALOGUE" and isinstance(node.value,
                                                    ast.Tuple):
                lineno = node.lineno
                for el in node.value.elts:
                    if isinstance(el, ast.Name) and el.id in consts:
                        catalogue.append(consts[el.id])
                    elif isinstance(el, ast.Constant) and isinstance(
                            el.value, str):
                        # a direct string element is as catalogued as
                        # a named constant
                        catalogue.append(el.value)
            elif name == "LEGACY_ALIASES" and isinstance(node.value,
                                                         ast.Dict):
                for v in node.value.values:
                    if isinstance(v, ast.Constant) and isinstance(
                            v.value, str):
                        legacy.add(v.value)
    return catalogue, lineno, legacy


def _find_instruments(parsed):
    return next((pf for rel, pf in sorted(parsed.items())
                 if rel.replace("\\", "/").endswith(_INSTRUMENTS_SUFFIX)),
                None)


def _find_suffix(parsed, suffix):
    return next((pf for rel, pf in sorted(parsed.items())
                 if rel.replace("\\", "/").endswith(suffix)), None)


def _tuple_of_strings(pf, target):
    """(values, lineno) of a module-level ``TARGET = ("a", "b", ...)``
    assignment, or (None, 1) when absent/unparseable."""
    for node in pf.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id == target and \
                isinstance(node.value, (ast.Tuple, ast.List)):
            vals = [el.value for el in node.value.elts
                    if isinstance(el, ast.Constant) and
                    isinstance(el.value, str)]
            return vals, node.lineno
    return None, 1


def _dict_string_keys(pf, target):
    """(keys, lineno) of a module-level ``TARGET = {"a": ..., ...}``
    assignment, or (None, 1) when absent/unparseable."""
    for node in pf.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id == target and \
                isinstance(node.value, ast.Dict):
            keys = [k.value for k in node.value.keys
                    if isinstance(k, ast.Constant) and
                    isinstance(k.value, str)]
            return keys, node.lineno
    return None, 1


def _span_table_findings(parsed):
    """SPAN_KINDS (serve/tracing.py) ↔ PHASE_OF_KIND
    (diag/serve_doctor.py) two-way drift."""
    tracing = _find_suffix(parsed, _TRACING_SUFFIX)
    doctor = _find_suffix(parsed, _SERVE_DOCTOR_SUFFIX)
    if tracing is None or doctor is None:
        return []  # partial-tree run: contract not checkable
    kinds, kinds_line = _tuple_of_strings(tracing, "SPAN_KINDS")
    phases, phases_line = _dict_string_keys(doctor, "PHASE_OF_KIND")
    if kinds is None or phases is None:
        pf = tracing if kinds is None else doctor
        line = kinds_line if kinds is None else phases_line
        missing = "SPAN_KINDS" if kinds is None else "PHASE_OF_KIND"
        return [engine.Finding(
            rule="HVD-METRIC", file=pf.rel, line=line, col=1,
            message=f"could not parse {missing} as a module-level "
                    "string table",
            hint="keep the span table a literal tuple/dict so the "
                 "drift check can read it without imports",
            fingerprint=f"span-table:{missing}")]
    findings = []
    for kind in kinds:
        if kind not in phases:
            findings.append(engine.Finding(
                rule="HVD-METRIC", file=tracing.rel, line=kinds_line,
                col=1,
                message=f"span kind `{kind}` has no entry in the serve "
                        "doctor's PHASE_OF_KIND classifier",
                hint="hvd-doctor-torch serve must name a phase for every "
                     "kind the tracer can emit — add the mapping in "
                     "diag/serve_doctor.py",
                fingerprint=f"SPAN_KINDS:{kind}"))
    for kind in phases:
        if kind not in kinds:
            findings.append(engine.Finding(
                rule="HVD-METRIC", file=doctor.rel, line=phases_line,
                col=1,
                message=f"PHASE_OF_KIND classifies span kind `{kind}` "
                        "that serve/tracing.py never emits",
                hint="drop the ghost entry or add the kind to "
                     "SPAN_KINDS — the classifier mirrors the span "
                     "table exactly, both ways",
                fingerprint=f"PHASE_OF_KIND:{kind}"))
    return findings


def _doc_path(root):
    return os.path.join(root, *_DOC.split("/"))


def _scope_files(parsed, root):
    """The non-walked file this pass examines: with instruments.py in
    the run, the docs table is part of the checked surface — its
    baseline entries must stay matchable (engine.Rule.scope_files)."""
    inst = _find_instruments(parsed)
    if inst is None or not os.path.exists(_doc_path(root)):
        return ()
    return (_DOC,)


@engine.register(
    "HVD-METRIC", scope="project",
    doc="metric-name drift: docs vs CATALOGUE vs use sites",
    scope_files=_scope_files)
def check(parsed, root):
    inst = _find_instruments(parsed)
    if inst is None:
        # the span-table contract is independent of instruments.py
        return _span_table_findings(parsed)
    catalogue, cat_line, legacy = _catalogue(inst)
    if not catalogue:
        return [engine.Finding(
            rule="HVD-METRIC", file=inst.rel, line=cat_line, col=1,
            message="could not parse CATALOGUE from instruments.py",
            hint="keep CATALOGUE a module-level tuple of the string "
                 "constants defined above it",
            fingerprint=common.fingerprint(inst, cat_line))]
    known = set(catalogue)
    findings = []

    # 1+2: the docs/OBSERVABILITY.md two-way drift contract
    doc_path = _doc_path(root)
    if os.path.exists(doc_path):
        with open(doc_path, encoding="utf-8") as f:
            doc_lines = f.read().splitlines()
        documented = {}
        for i, text in enumerate(doc_lines, start=1):
            m = _DOC_ROW.match(text)
            if m:
                documented.setdefault(m.group(1), i)
        for name, line in sorted(documented.items()):
            if name not in known:
                findings.append(engine.Finding(
                    rule="HVD-METRIC", file=_DOC, line=line, col=1,
                    message=f"documented metric `{name}` is not in "
                            "instruments.CATALOGUE (documented ghost)",
                    hint="remove the row or register the family — the "
                         "catalogue is the one authority "
                         "(docs/OBSERVABILITY.md header)",
                    fingerprint=doc_lines[line - 1].strip()))
        for name in catalogue:
            if name not in documented:
                findings.append(engine.Finding(
                    rule="HVD-METRIC", file=inst.rel, line=cat_line,
                    col=1,
                    message=f"catalogued metric `{name}` has no row in "
                            "docs/OBSERVABILITY.md's metric tables",
                    hint="every registered family gets a documented "
                         "row (the tier-1 drift contract)",
                    fingerprint=f"CATALOGUE:{name}"))

    # 3: string-literal registrations outside the catalogue —
    # instruments.py itself included (a literal registration there
    # dodges the CATALOGUE↔docs comparison just as easily)
    for rel, pf in sorted(parsed.items()):
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.Call):
                continue
            if common.call_name(node) not in _REGISTER_CALLS:
                continue
            if not isinstance(node.func, ast.Attribute):
                continue
            if not node.args or not isinstance(node.args[0],
                                               ast.Constant):
                continue
            val = node.args[0].value
            if not isinstance(val, str) or not _NAME_RE.fullmatch(val):
                continue
            if val in known or val in legacy:
                continue
            findings.append(engine.Finding(
                rule="HVD-METRIC", file=pf.rel, line=node.lineno,
                col=node.col_offset + 1,
                message=f"metric `{val}` registered here is not in "
                        "instruments.CATALOGUE",
                hint="add the name to the catalogue (and its "
                     "docs/OBSERVABILITY.md row), or reuse an existing "
                     "family — uncatalogued names dodge the drift "
                     "contract",
                fingerprint=common.fingerprint(pf, node.lineno)))

    # 4: the serving span-table twin of the same two-way contract
    findings.extend(_span_table_findings(parsed))
    return findings
