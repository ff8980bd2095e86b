"""HVD-HOSTSYNC, the torch twin of the JAX package's rule: host
synchronization inside functions that flow into the train step
(``make_train_step``, ``make_lm_train_step``) or ``torch.compile`` —
``.item()``, ``.tolist()``, ``.cpu()``, ``float()``/``int()`` of a
tensor, ``np.asarray``, ``torch.cuda.synchronize()`` and blocking I/O.
Each waits for the card to drain its queue and copies to the host on
every step (or breaks the compiled graph), the stall the goodput ledger
(runtime twin) can only bill after the fact."""

import ast

from horovod_tpu_torch.analysis import engine
from horovod_tpu_torch.analysis.rules import common

_STEP_BUILDERS = frozenset({"make_train_step", "make_lm_train_step"})

# attribute calls that force a device->host transfer on any receiver
_SYNC_ATTRS = frozenset({"item", "tolist", "cpu"})
# numpy-ish module receivers whose asarray/array pulls a tensor
_NP_RECEIVERS = frozenset({"np", "numpy", "onp"})
_BLOCKING_NAMES = frozenset({"print", "open", "input"})
# host-side metadata of a tensor: converting it reads no device memory
_METADATA_CALLS = frozenset({"numel", "dim", "size", "len",
                             "element_size"})


def _host_metadata(arg):
    """``x.numel()``, ``len(x)``, ``x.size(0)``, ``x.shape[0]``: a
    number the host already holds."""
    if isinstance(arg, ast.Call):
        return common.call_name(arg) in _METADATA_CALLS
    if isinstance(arg, ast.Subscript):
        arg = arg.value
    return isinstance(arg, ast.Attribute) and arg.attr == "shape"


def _is_torch_compile(node):
    """``torch.compile`` (or ``torch.compile(...)`` called for its
    options) as an expression."""
    if isinstance(node, ast.Call):
        node = node.func
    return isinstance(node, ast.Attribute) and node.attr == "compile" \
        and isinstance(node.value, ast.Name) and node.value.id == "torch"


def _step_entry_names(tree):
    """Names of functions that flow into the step in this module:
    decorated with ``@torch.compile``/``@torch.compile(...)``/
    ``@partial(torch.compile, ...)``, or passed by name to
    ``torch.compile(...)`` or a step builder."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                if _is_torch_compile(dec):
                    names.add(node.name)
                elif isinstance(dec, ast.Call) and \
                        common.call_name(dec) == "partial" and \
                        any(_is_torch_compile(a) for a in dec.args):
                    names.add(node.name)
        elif isinstance(node, ast.Call):
            if _is_torch_compile(node.func) or \
                    common.call_name(node) in _STEP_BUILDERS:
                for a in list(node.args) + [k.value for k in
                                            node.keywords]:
                    if isinstance(a, ast.Name):
                        names.add(a.id)
    return names


@engine.register(
    "HVD-HOSTSYNC",
    doc="host sync / blocking I/O inside a compiled or train-step function")
def check(pf):
    entries = _step_entry_names(pf.tree)
    if not entries:
        return []
    findings = []

    def flag(node, what):
        findings.append(engine.Finding(
            rule="HVD-HOSTSYNC", file=pf.rel, line=node.lineno,
            col=node.col_offset + 1,
            message=f"{what} inside a compiled or train-step function",
            hint="this waits for the card and copies to the host on "
                 "the hot path (or breaks the compiled graph) — return "
                 "the tensor and read it outside the step, or use a "
                 "deferred telemetry gauge (runtime twin: the goodput "
                 "ledger can only bill this stall)",
            fingerprint=common.fingerprint(pf, node.lineno)))

    def scan(fn):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            name = common.call_name(node)
            recv = common.receiver_ident(node)
            if name in _SYNC_ATTRS and recv is not None:
                flag(node, f"`.{name}()`")
            elif name in ("asarray", "array") and recv in _NP_RECEIVERS:
                flag(node, f"`{recv}.{name}()` on a tensor")
            elif name == "synchronize" and recv in ("torch.cuda",
                                                     "cuda"):
                flag(node, "`torch.cuda.synchronize()`")
            elif name in ("float", "int", "bool") and isinstance(
                    node.func, ast.Name) and node.args and not isinstance(
                    node.args[0], ast.Constant) and not _host_metadata(
                    node.args[0]):
                flag(node, f"`{name}()` scalar conversion")
            elif name in _BLOCKING_NAMES and isinstance(node.func,
                                                        ast.Name):
                flag(node, f"blocking `{name}()`")
            elif name == "sleep" and (recv == "time" or isinstance(
                    node.func, ast.Name)):
                flag(node, "`time.sleep()`")

    for node in ast.walk(pf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name in entries:
            scan(node)
    return findings
