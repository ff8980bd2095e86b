"""HVD-EXCEPT: bare / broad exception handlers. On the collective
plane a swallowed exception is worse than a crash: the rank that ate
the error stops dispatching collectives while its peers park in the
next one forever — the desync doctor then names it at 3am. A broad
handler is acceptable only when it (a) re-raises, or (b) carries an
inline justification saying why this plane must never propagate
(telemetry/forensics paths that ride the liveness channel). Bare
``except:`` and ``except BaseException:`` additionally swallow
``KeyboardInterrupt``/``SystemExit`` — control flow, not errors."""

import ast

from horovod_tpu_torch.analysis import engine
from horovod_tpu_torch.analysis.rules import common

_BROAD = frozenset({"Exception", "BaseException"})


def _names_in(type_node):
    if type_node is None:
        return {"<bare>"}
    out = set()
    nodes = type_node.elts if isinstance(type_node, ast.Tuple) \
        else [type_node]
    for n in nodes:
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
    return out


def _reraises(handler):
    for node in common.walk_skipping_defs(handler):
        if isinstance(node, ast.Raise):
            return True
    return False


@engine.register(
    "HVD-EXCEPT",
    doc="broad exception handler that swallows control flow")
def check(pf):
    findings = []
    for node in ast.walk(pf.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        caught = _names_in(node.type)
        broad = caught & _BROAD
        bare = "<bare>" in caught
        if not broad and not bare:
            continue
        if _reraises(node):
            continue
        if bare or "BaseException" in broad:
            what = "bare `except:`" if bare else "`except BaseException`"
            msg = (f"{what} swallows KeyboardInterrupt/SystemExit — "
                   "a rank told to die keeps running (and desyncs)")
        else:
            msg = ("broad `except Exception` without re-raise — a "
                   "swallowed error here turns into a silent desync "
                   "hang on the collective plane")
        findings.append(engine.Finding(
            rule="HVD-EXCEPT", file=pf.rel, line=node.lineno,
            col=node.col_offset + 1, message=msg,
            hint="catch the specific exceptions, re-raise, or suppress "
                 "with a justification naming why this plane must "
                 "never propagate (docs/ANALYSIS.md)",
            fingerprint=common.fingerprint(pf, node.lineno)))
    return findings
