"""HVD-DISTINIT, the torch twin of the JAX package's rule:
``init_process_group`` call sites outside the one sanctioned entry
point, ``cluster/procmesh.ensure_distributed``.

Joining the process group is a process-global, once-only act: a second
call raises or, with another store, joins another world, and every such
bug shows only under a real multi-process launch, the most expensive
place to debug it. ``ensure_distributed`` owns the idempotence record
and the refusal of a foreign join; everything else in the tree goes
through it.
"""

import ast

from horovod_tpu_torch.analysis import engine
from horovod_tpu_torch.analysis.rules import common

_SANCTIONED_SUFFIXES = ("horovod_tpu_torch/cluster/procmesh.py",)


@engine.register(
    "HVD-DISTINIT",
    doc="init_process_group outside cluster.ensure_distributed")
def check(pf):
    rel = pf.rel.replace("\\", "/")
    if rel.endswith(_SANCTIONED_SUFFIXES):
        return []
    findings = []
    for node in ast.walk(pf.tree):
        if isinstance(node, ast.Call) and \
                common.call_name(node) == "init_process_group":
            findings.append(engine.Finding(
                rule="HVD-DISTINIT", file=pf.rel, line=node.lineno,
                col=node.col_offset + 1,
                message="torch.distributed.init_process_group outside "
                        "the sanctioned cluster entry point",
                hint="join the process group through "
                     "cluster.ensure_distributed() — it owns the "
                     "idempotence record and the refusal of a foreign "
                     "join",
                fingerprint=common.fingerprint(pf, node.lineno)))
    return findings
