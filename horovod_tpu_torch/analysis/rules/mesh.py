"""HVD-MESH, the torch twin of the JAX package's rule: raw
``new_group(``, ``DeviceMesh(`` and ``init_device_mesh(`` call sites
outside the mesh layer. The port's mesh (``parallel/mesh.py``) creates
the process group of every set of axes once, collectively, on every
rank; ``parallel/axis.py`` and ``parallel/gspmd.py`` (the DTensor
``DeviceMesh`` built from those groups) are the layer above it. A group
made anywhere else is one the mesh does not know: its members must all
call it, in the same order, or every rank hangs, and no ``axes=``
collective can name it. Those three files are excluded by design."""

import ast

from horovod_tpu_torch.analysis import engine
from horovod_tpu_torch.analysis.rules import common

_EXCLUDED_SUFFIXES = ("horovod_tpu_torch/parallel/mesh.py",
                      "horovod_tpu_torch/parallel/axis.py",
                      "horovod_tpu_torch/parallel/gspmd.py")
_MESH_CALLS = frozenset({"new_group", "DeviceMesh", "init_device_mesh"})


@engine.register(
    "HVD-MESH",
    doc="raw process group / DeviceMesh call site off the port's mesh")
def check(pf):
    rel = pf.rel.replace("\\", "/")
    if rel.endswith(_EXCLUDED_SUFFIXES):
        return []
    findings = []
    for node in ast.walk(pf.tree):
        if isinstance(node, ast.Call):
            name = common.call_name(node)
            if name in _MESH_CALLS:
                findings.append(engine.Finding(
                    rule="HVD-MESH", file=pf.rel, line=node.lineno,
                    col=node.col_offset + 1,
                    message=f"explicit `{name}(` call site off the "
                            "logical mesh",
                    hint="build groups through parallel/mesh.build_mesh "
                         "and name them by axes (a DeviceMesh through "
                         "parallel/gspmd.py) — justify any new raw group "
                         "in the change",
                    fingerprint=common.fingerprint(pf, node.lineno)))
    return findings
