"""HVD-LOCKORDER: the cross-module lock-acquisition graph. Collects
every ``threading.Lock``/``RLock`` definition and every ``with lock:``
held region, then reports (a) locks held across blocking calls —
``Thread.join``, bounded ``queue.put``/``get``, ``Event.wait``,
``time.sleep``, and any collective dispatch — and (b) lock-order
cycles (A taken under B here, B taken under A there). The
recorder-watcher SIGTERM deadlock (handler re-raising while the watcher
held the dump lock mid-write) is exactly shape (a); this pass is its
static twin.

Limitations (documented in docs/ANALYSIS.md): held regions are ``with``
blocks only (bare ``.acquire()`` spans are not tracked), nested
function bodies are excluded (a closure defined under a lock does not
run there), and ``Condition.wait`` — which releases its lock — is
excluded by receiver-name heuristic."""

import ast

from horovod_tpu_torch.analysis import engine
from horovod_tpu_torch.analysis.rules import common

_LOCK_CTORS = frozenset({"Lock", "RLock", "Semaphore",
                         "BoundedSemaphore"})


def _modname(rel):
    return rel[:-3].replace("\\", "/").replace("/", ".") \
        if rel.endswith(".py") else rel


def _lock_defs(pf):
    """``{local_ident: global_key}`` for locks visible in this file.
    Idents are ``name`` (module scope) or ``self.attr`` (class scope);
    keys are ``module::name`` / ``module::Class.attr``. Lock-named
    imports (``from a import run_lock``) resolve to the DEFINING
    module's key, so an A→B nesting here and a B→A nesting in another
    importer close a detectable cross-module cycle."""
    defs = {}
    mod = _modname(pf.rel)
    for node in pf.tree.body:
        if isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                if common.ident_is_lockish(alias.name):
                    defs[alias.asname or alias.name] = \
                        f"{node.module}::{alias.name}"

    def visit(node, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, child.name)
                continue
            if isinstance(child, ast.Assign) and isinstance(
                    child.value, ast.Call):
                ctor = common.call_name(child.value)
                if ctor in _LOCK_CTORS:
                    for tgt in child.targets:
                        if isinstance(tgt, ast.Name):
                            defs[tgt.id] = f"{mod}::{tgt.id}"
                        elif isinstance(tgt, ast.Attribute) and \
                                isinstance(tgt.value, ast.Name) and \
                                tgt.value.id == "self" and cls:
                            defs[f"self.{tgt.attr}"] = \
                                f"{mod}::{cls}.{tgt.attr}"
            visit(child, cls)

    visit(pf.tree, None)
    return defs


def _expr_ident(expr):
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        parts = [expr.attr]
        cur = expr.value
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if isinstance(cur, ast.Name):
            parts.append(cur.id)
            return ".".join(reversed(parts))
    return None


def _lock_key(expr, defs, rel):
    """Resolve a with-context expression to a lock key, or None when it
    is not lock-like. Unknown-but-lock-named objects (imported, passed
    in) get a synthetic per-name key so nesting is still tracked."""
    ident = _expr_ident(expr)
    if ident is None:
        return None, None
    if ident in defs:
        return defs[ident], ident
    short = ident.replace("self.", "", 1)
    if f"self.{short}" in defs:
        return defs[f"self.{short}"], ident
    if common.ident_is_lockish(ident):
        return f"{rel}::~{short}", ident
    return None, None


def _blocking_reason(node):
    """Why this Call blocks while a lock is held, or None."""
    name = common.call_name(node)
    recv = common.receiver_ident(node) or ""
    coll = common.is_collective_call(node)
    if coll:
        return (f"collective dispatch `{coll}()` — a peer that never "
                "arrives parks this rank while it holds the lock")
    core = common.blocking_core_reason(node)
    if core:
        return core
    if name == "wait" and recv and not any(
            t in recv.lower() for t in ("cond", "cv")):
        return f"`{recv}.wait()`"
    if name == "acquire" and common.ident_is_lockish(recv) \
            and not common.kwarg_is_false(node, "blocking", arg_index=0):
        return f"`{recv}.acquire()`"
    return None


@engine.register(
    "HVD-LOCKORDER", scope="project",
    doc="lock-order cycles and locks held across blocking calls")
def check(parsed, root):
    findings = []
    edges = {}  # (outer_key, inner_key) -> (rel, lineno, outer_i, inner_i)

    def flag(pf, node, msg, hint):
        findings.append(engine.Finding(
            rule="HVD-LOCKORDER", file=pf.rel, line=node.lineno,
            col=node.col_offset + 1, message=msg, hint=hint,
            fingerprint=common.fingerprint(pf, node.lineno)))

    def scan_with(pf, defs, node, held):
        """``held`` is the stack of (key, ident) currently held. Items
        of one ``with a, b:`` acquire left-to-right, so each later item
        orders after the earlier ones too — ``held`` grows item by
        item, not per statement."""
        for item in node.items:
            key, ident = _lock_key(item.context_expr, defs, pf.rel)
            if key is not None:
                for okey, oident in held:
                    if okey != key:
                        edges.setdefault((okey, key), (
                            pf.rel, item.context_expr.lineno, oident,
                            ident))
                held = held + [(key, ident)]
        for child in node.body:
            scan_stmt(pf, defs, child, held)

    def scan_stmt(pf, defs, node, held):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # a nested def's body runs when called, not under this lock
            inner_held = []
            body = node.body if not isinstance(node, ast.Lambda) else []
            for child in body:
                scan_stmt(pf, defs, child, inner_held)
            return
        if isinstance(node, ast.With):
            scan_with(pf, defs, node, held)
            return
        if isinstance(node, ast.Call) and held:
            reason = _blocking_reason(node)
            # `.wait()` on the very object being held is a Condition
            # wait — it RELEASES the lock while parked, so it is not a
            # held-across-blocking hazard
            if reason and common.call_name(node) == "wait" and \
                    common.receiver_ident(node) in \
                    {i for _, i in held}:
                reason = None
            if reason:
                key, ident = held[-1]
                flag(pf, node,
                     f"lock `{ident}` ({key}) held across blocking "
                     f"call {reason}",
                     "a blocked holder wedges every other acquirer — "
                     "move the blocking call outside the critical "
                     "section, or bound it with a timeout and document "
                     "why (runtime twin: the recorder-watcher "
                     "SIGTERM deadlock, docs/ANALYSIS.md)")
        for child in ast.iter_child_nodes(node):
            scan_stmt(pf, defs, child, held)

    for pf in parsed.values():
        defs = _lock_defs(pf)
        for stmt in pf.tree.body:
            scan_stmt(pf, defs, stmt, [])

    # lock-order cycles over the cross-module edge set (2-cycles and
    # longer, found by DFS from each node; report each cycle once)
    graph = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
    seen_cycles = set()

    def dfs(start, node, path):
        for nxt in sorted(graph.get(node, ())):
            if nxt == start:
                cyc = tuple(sorted(path))
                if cyc in seen_cycles:
                    continue
                seen_cycles.add(cyc)
                steps = []
                for i, a in enumerate(path):
                    b = path[(i + 1) % len(path)]
                    rel, line, oident, iident = edges[(a, b)]
                    steps.append(f"`{oident}`→`{iident}` at {rel}:{line}")
                rel, line, _, _ = edges[(path[0], path[1 % len(path)])]
                pf = parsed[rel]
                findings.append(engine.Finding(
                    rule="HVD-LOCKORDER", file=rel, line=line, col=1,
                    message="lock-order cycle: " + "; ".join(steps),
                    hint="two threads taking these locks in opposite "
                         "orders deadlock — pick one global order "
                         "(docs/ANALYSIS.md)",
                    fingerprint=common.fingerprint(pf, line)))
            elif nxt not in path and len(path) < 6:
                dfs(start, nxt, path + [nxt])

    for node in sorted(graph):
        dfs(node, node, [node])
    return findings
