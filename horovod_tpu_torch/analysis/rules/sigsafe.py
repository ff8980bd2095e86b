"""HVD-SIGSAFE: blocking locking or I/O inside a registered signal
handler. A Python signal handler runs *on the main thread between
bytecodes* — if it blocks on a lock another thread holds (or that the
interrupted frame itself holds, for a non-reentrant Lock), the process
wedges exactly when it was told to die. The flight recorder's
``acquire(blocking=False)`` + bounded ``wait_for_dump`` dance
(``diag/recorder.py``) is the compliant pattern this pass enforces
everywhere else."""

import ast

from horovod_tpu_torch.analysis import engine
from horovod_tpu_torch.analysis.rules import common


def _handler_names(tree):
    """Function names registered via ``signal.signal(SIG, fn)`` and
    inline lambdas (returned as AST nodes)."""
    names, lambdas = set(), []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if common.call_name(node) != "signal":
            continue
        recv = common.receiver_ident(node)
        if recv != "signal" or len(node.args) < 2:
            continue
        handler = node.args[1]
        if isinstance(handler, ast.Name):
            names.add(handler.id)
        elif isinstance(handler, ast.Lambda):
            lambdas.append(handler)
        elif isinstance(handler, ast.Attribute):
            names.add(handler.attr)
    return names, lambdas


@engine.register(
    "HVD-SIGSAFE",
    doc="blocking lock / I/O inside a registered signal handler")
def check(pf):
    names, lambdas = _handler_names(pf.tree)
    if not names and not lambdas:
        return []
    findings = []

    def flag(node, what):
        findings.append(engine.Finding(
            rule="HVD-SIGSAFE", file=pf.rel, line=node.lineno,
            col=node.col_offset + 1,
            message=f"{what} inside a signal handler",
            hint="handlers run between bytecodes on the main thread — "
                 "use acquire(blocking=False) / os.write, or set a "
                 "flag and do the work on a watcher thread "
                 "(diag/recorder.py is the compliant pattern)",
            fingerprint=common.fingerprint(pf, node.lineno)))

    def scan(body_nodes):
        for top in body_nodes:
            if isinstance(top, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                # a def INSIDE the handler runs when called (on a
                # watcher thread — the recommended fix pattern), not
                # in the handler itself
                continue
            for node in [top] + list(common.walk_skipping_defs(top)):
                if isinstance(node, ast.With):
                    for item in node.items:
                        ident = _with_ident(item.context_expr)
                        if ident and common.ident_is_lockish(ident):
                            flag(item.context_expr,
                                 f"blocking `with {ident}:`")
                if not isinstance(node, ast.Call):
                    continue
                name = common.call_name(node)
                recv = common.receiver_ident(node) or ""
                core = common.blocking_core_reason(node)
                if name == "acquire" and not common.kwarg_is_false(
                        node, "blocking", arg_index=0):
                    flag(node, f"blocking `{recv}.acquire()`")
                elif name == "open" and isinstance(node.func, ast.Name):
                    flag(node, "`open()` (allocates + blocks on the "
                               "filesystem)")
                elif name == "print" and isinstance(node.func, ast.Name):
                    flag(node, "`print()` (takes the stdout lock)")
                elif core:
                    flag(node, core)
                elif recv in ("logging", "logger") or \
                        recv.endswith(".logger"):
                    flag(node, f"logging call `{recv}.{name}()` "
                               "(module lock + allocation)")

    def _with_ident(expr):
        if isinstance(expr, ast.Name):
            return expr.id
        if isinstance(expr, ast.Attribute):
            return expr.attr
        return None

    for node in ast.walk(pf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name in names:
            scan(node.body)
    for lam in lambdas:
        scan([lam.body])
    return findings
