"""HVD-DESYNC: collective dispatch reachable under rank-dependent
control flow — the static twin of the runtime desync doctor
(``diag/desync.py``). Horovod's core contract is that every rank
executes an *identical* collective schedule; a collective under
``if hvd.rank() == 0`` (or after a rank-conditional early return) forks
the schedule and parks every other rank in the op forever — the hang
the flight recorder can only name after the fact."""

import ast

from horovod_tpu_torch.analysis import engine
from horovod_tpu_torch.analysis.rules import common


def _contains_exit(stmts, kinds, skip_loops=False):
    """Does any statement (recursively — ``if rank: with x: return``
    still exits) contain an exit of ``kinds``? Nested function bodies
    never count (they exit the closure, not this scope); with
    ``skip_loops`` nested loop bodies are excluded too (a break/
    continue inside an INNER loop does not exit the current one),
    which is what the break/continue check needs."""
    stack = list(stmts)
    while stack:
        n = stack.pop()
        if isinstance(n, kinds):
            return True
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            continue
        if skip_loops and isinstance(n, (ast.For, ast.AsyncFor,
                                         ast.While)):
            continue
        stack.extend(ast.iter_child_nodes(n))
    return False


@engine.register(
    "HVD-DESYNC",
    doc="collective dispatch under rank-dependent control flow")
def check(pf):
    findings = []

    def flag(node, name, why):
        findings.append(engine.Finding(
            rule="HVD-DESYNC", file=pf.rel, line=node.lineno,
            col=node.col_offset + 1,
            message=f"collective `{name}` {why}",
            hint="every rank must dispatch an identical collective "
                 "schedule — hoist the call out of the rank branch, or "
                 "make the branch world-common (runtime twin: "
                 "diag/desync.py)",
            fingerprint=common.fingerprint(pf, node.lineno)))

    class Scope:
        """One function (or the module top level): tracks the stack of
        rank-conditional regions and the rank-conditional early exits
        seen so far, in statement order. ``return``/``raise`` exits
        taint the rest of the FUNCTION; ``break``/``continue`` only
        end an iteration, so they taint the rest of the enclosing LOOP
        body and nothing after it."""

        def __init__(self):
            self.cond_stack = []   # linenos of enclosing rank-dep tests
            self.early_exits = []  # function-scope exits (return/raise)
            self.loop_exits = []   # one list per enclosing loop

        def tainted(self):
            if self.early_exits:
                return self.early_exits[-1]
            for exits in reversed(self.loop_exits):
                if exits:
                    return exits[-1]
            return None

    def visit(node, scope):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            inner = Scope()
            body = node.body if not isinstance(node, ast.Lambda) \
                else [node.body]
            for child in body:
                visit(child, inner)
            return
        if isinstance(node, (ast.For, ast.AsyncFor)):
            # a loop body: break/continue exits recorded inside it
            # expire when the loop ends. `for i in range(rank())`
            # iterates a rank-dependent number of times — its body is
            # rank-conditional.
            dep = common.expr_is_rank_dependent(node.iter)
            body = list(node.body)
            for child in ast.iter_child_nodes(node):
                if child in body:
                    continue
                visit(child, scope)
            if dep:
                scope.cond_stack.append(node.iter.lineno)
            scope.loop_exits.append([])
            for child in body:
                visit(child, scope)
            scope.loop_exits.pop()
            if dep:
                scope.cond_stack.pop()
            return
        if isinstance(node, (ast.If, ast.While)):
            dep = common.expr_is_rank_dependent(node.test)
            visit(node.test, scope)
            if dep:
                scope.cond_stack.append(node.test.lineno)
            is_loop = isinstance(node, ast.While)
            if is_loop:
                scope.loop_exits.append([])
            for child in node.body + getattr(node, "orelse", []):
                visit(child, scope)
            if is_loop:
                scope.loop_exits.pop()
            if dep:
                scope.cond_stack.pop()
                # a rank-conditional branch that exits: return/raise
                # taint the rest of the function; break/continue only
                # the rest of the enclosing loop body
                if isinstance(node, ast.If):
                    stmts = node.body + node.orelse
                    if _contains_exit(stmts, (ast.Return, ast.Raise)):
                        scope.early_exits.append(node.test.lineno)
                    elif scope.loop_exits and _contains_exit(
                            stmts, (ast.Break, ast.Continue),
                            skip_loops=True):
                        scope.loop_exits[-1].append(node.test.lineno)
            return
        if isinstance(node, ast.IfExp):
            dep = common.expr_is_rank_dependent(node.test)
            visit(node.test, scope)
            if dep:
                scope.cond_stack.append(node.test.lineno)
            visit(node.body, scope)
            visit(node.orelse, scope)
            if dep:
                scope.cond_stack.pop()
            return
        if isinstance(node, ast.BoolOp):
            # `rank == 0 and allreduce(x)`: operands after a rank-dep
            # operand only evaluate on some ranks
            dep_from = None
            for i, v in enumerate(node.values):
                if dep_from is not None:
                    scope.cond_stack.append(v.lineno)
                visit(v, scope)
                if dep_from is not None:
                    scope.cond_stack.pop()
                if dep_from is None and common.expr_is_rank_dependent(v):
                    dep_from = i
            return
        if isinstance(node, ast.Call):
            name = common.is_collective_call(node)
            if name is not None:
                taint = scope.tainted()
                if scope.cond_stack:
                    flag(node, name,
                         "dispatched under rank-dependent control flow "
                         f"(condition at line {scope.cond_stack[-1]})")
                elif taint is not None:
                    flag(node, name,
                         "reachable after a rank-conditional early "
                         f"exit (line {taint}) — some "
                         "ranks never arrive")
        for child in ast.iter_child_nodes(node):
            visit(child, scope)

    top = Scope()
    for stmt in pf.tree.body:
        visit(stmt, top)
    return findings
