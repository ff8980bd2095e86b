"""Shared AST helpers for the hvd-lint passes: the JAX package's
vocabulary (``analysis/rules/common.py``) and the names that
``torch.distributed`` and the port use."""

import ast
import re

# every collective dispatch entry point on the explicit plane (eager,
# traced, and fusion-bucket) plus the jax primitives they lower to, the
# torch.distributed calls and the port's in-place forms — the schedule
# these build is what diag/desync.py digests at runtime
COLLECTIVE_NAMES = frozenset({
    "allreduce", "allgather", "all_gather", "broadcast", "reducescatter",
    "reduce_scatter", "alltoall", "all_to_all", "barrier",
    "psum", "pmean", "pmax", "pmin", "psum_scatter", "ppermute",
    "all_gather_bucket", "reduce_scatter_bucket", "fused_allreduce",
    "grouped_allreduce", "allreduce_", "grouped_allreduce_",
    "all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
    "all_to_all_single", "broadcast_object_list", "broadcast_",
    "fused_allreduce_",
})
COLLECTIVE_PREFIXES = ("reduce_scatter_bucket", "all_gather_bucket")


def call_name(node):
    """The rightmost identifier of a Call's func (``hvd.allreduce`` →
    ``allreduce``), or None."""
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def is_collective_call(node):
    name = call_name(node)
    if name is None:
        return None
    if name in COLLECTIVE_NAMES or name.startswith(COLLECTIVE_PREFIXES):
        return name
    return None


_RANK_CALLS = frozenset({"rank", "local_rank", "cross_rank", "node_rank",
                         "mesh_rank", "process_index", "axis_index",
                         "get_rank"})


def _ident_tokens(ident):
    return set(re.split(r"[_\d]+", ident.lower())) - {""}


# identifiers that name WHICH rank an op targets (``root_rank``,
# ``src_rank``) are world-common parameters, not this rank's identity
_TARGET_TOKENS = frozenset({"root", "src", "dst", "target", "peer"})


def ident_is_rankish(ident):
    """True for ``rank``/``local_rank``/``rank0`` — NOT for plural
    collections like ``stalled_ranks`` (a list of ranks is world-common
    state) and NOT for target-rank parameters like ``root_rank``
    (every rank passes the same value)."""
    toks = _ident_tokens(ident)
    return "rank" in toks and not (toks & _TARGET_TOKENS)


def expr_is_rank_dependent(expr):
    """Does this expression's value depend on which rank evaluates it?"""
    for n in ast.walk(expr):
        if isinstance(n, ast.Call):
            name = call_name(n)
            if name in _RANK_CALLS:
                return True
        elif isinstance(n, ast.Name) and ident_is_rankish(n.id):
            return True
        elif isinstance(n, ast.Attribute) and ident_is_rankish(n.attr):
            return True
    return False


def receiver_ident(node):
    """For an Attribute call ``x.y.z(...)`` return the identifier chain
    of the receiver (``x.y``) as a dotted string, else None."""
    fn = node.func
    if not isinstance(fn, ast.Attribute):
        return None
    parts = []
    cur = fn.value
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
    elif isinstance(cur, ast.Constant):
        return "<const>"
    else:
        return None
    return ".".join(reversed(parts))


def ident_is_lockish(ident):
    toks = _ident_tokens(ident.rsplit(".", 1)[-1])
    return bool(toks & {"lock", "mutex", "mu"})


def ident_is_queueish(ident):
    toks = _ident_tokens(ident.rsplit(".", 1)[-1])
    return bool(toks & {"q", "queue"})


def kwarg_is_false(node, name, arg_index=None):
    """True when the call passes ``name=False`` — by keyword, or (when
    ``arg_index`` is given) positionally: ``lock.acquire(False)`` and
    ``q.put(ev, False)`` are the same non-blocking request as their
    keyword spellings."""
    for kw in node.keywords:
        if kw.arg == name and isinstance(kw.value, ast.Constant) \
                and kw.value.value is False:
            return True
    if arg_index is not None and len(node.args) > arg_index:
        arg = node.args[arg_index]
        if isinstance(arg, ast.Constant) and arg.value is False:
            return True
    return False


def blocking_core_reason(node):
    """The blocking-call classification HVD-LOCKORDER and HVD-SIGSAFE
    share: thread joins (``str.join`` excluded — it always takes a
    positional arg), bounded queue put/get (keyword OR positional
    ``block=False`` recognized as non-blocking), and sleeps. Each rule
    layers its pass-specific extras (collectives, lock acquires, I/O)
    on top — one classifier, so the passes cannot drift apart on the
    same call site."""
    name = call_name(node)
    recv = receiver_ident(node) or ""
    if name == "join" and recv and recv != "<const>" and not node.args:
        return f"`{recv}.join()`"
    if name in ("put", "get") and ident_is_queueish(recv) \
            and not kwarg_is_false(node, "block",
                                   arg_index=1 if name == "put" else 0):
        return f"bounded-queue `{recv}.{name}()`"
    if name == "sleep" and recv in ("time", ""):
        return "`time.sleep()`"
    return None


def fingerprint(pf, lineno):
    try:
        return pf.lines[lineno - 1].strip()
    except IndexError:
        return ""


def walk_skipping_defs(node):
    """Yield descendant nodes WITHOUT descending into nested function /
    lambda bodies — code inside a nested def does not execute in the
    enclosing region (it runs whenever the closure is called)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(n))
