"""Single-file checkpoints, written by rank 0: the port of
``horovod_tpu/checkpoint.py``, the same ``ckpt-<step>.msgpack`` file.

* Only rank 0 writes; a write is atomic (tmp + fsync + rename +
  directory fsync).
* The resume step is found on rank 0 and broadcast, so every worker
  starts at the same step.
* After a restore on rank 0, the parameters and the optimizer state are
  broadcast from it, so every worker starts identical.

The file is flax's ``to_bytes`` of ``{"step", "params", "opt_state",
"meta"}``: ``params`` and ``opt_state`` are the JAX ``TrainState``'s
trees as flax's ``to_state_dict`` writes them
(``convert.train_state_trees``), so the JAX package's
``restore_checkpoint`` reads a file the port wrote, and the other way
round; a tensor- or expert-parallel state goes in whole and is cut again
at each rank's coordinates on restore. Here a model and its
``DistributedOptimizer`` (or a model shard and its plain optimizer) are
the state:
saving reads them and restoring writes into them, in place. The
successor is ``ckpt`` (async per-rank shards, resharded restore).
"""

import json
import os
import re

import numpy as np
import torch

from horovod_tpu_torch import basics, convert
from horovod_tpu_torch.ckpt import _msgpack, sharded
from horovod_tpu_torch.ckpt.manifest import fsync_dir
from horovod_tpu_torch.ops import collective
from horovod_tpu_torch.parallel import mesh as mesh_lib

_STEP_RE = re.compile(r"ckpt-(\d+)\.msgpack$")


def _fmt(directory, step):
    return os.path.join(directory, f"ckpt-{step}.msgpack")


def _host_trees(model, optimizer):
    """Host copies of ``(params, opt_state)``."""
    trees = convert.train_state_trees(model, optimizer)
    return sharded.tree_unflatten(
        trees, sharded._to_host(sharded.tree_flatten(trees)))


def save_checkpoint(directory, step, model, optimizer=None, meta=None,
                    keep=None):
    """Write ``ckpt-<step>.msgpack`` from rank 0 only; None elsewhere.
    A tensor- or expert-parallel state is gathered whole first, on every
    rank (``convert.gathers_across_ranks``: the gathers are collectives),
    as the JAX package's file holds it.

    ``meta`` is a small JSON-able dict (e.g. epoch, seed). ``keep`` (int)
    prunes all but the newest N checkpoints after a successful write."""
    if basics.rank() != 0 and not convert.gathers_across_ranks(model,
                                                               optimizer):
        return None
    trees = _host_trees(model, optimizer)
    if basics.rank() != 0:
        return None
    return write_checkpoint(directory, step, model, optimizer=optimizer,
                            meta=meta, keep=keep, trees=trees)


def write_checkpoint(directory, step, model, optimizer=None, meta=None,
                     keep=None, trees=None):
    """Rank-agnostic checkpoint write (atomic tmp + rename); returns the
    path. ``trees``: the host ``(params, opt_state)`` when already read."""
    os.makedirs(directory, exist_ok=True)
    params, opt_state = trees or _host_trees(model, optimizer)
    # meta rides as one JSON string leaf, as the JAX package writes it
    payload = {"step": np.asarray(step, dtype=np.int64), "params": params,
               "opt_state": opt_state, "meta": json.dumps(meta or {})}
    data = _msgpack.serialize(payload, sort_keys=False)
    path = _fmt(directory, step)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)
    fsync_dir(directory)
    if keep:
        _prune(directory, keep)
    return path


def _prune(directory, keep):
    """Keep the newest ``keep`` complete checkpoints; sweep ``.tmp``
    debris older than the newest one (a newer one may be in flight)."""
    steps = list_steps(directory)
    for old in steps[:-keep]:
        try:
            os.remove(_fmt(directory, old))
        except OSError:
            pass
    if not steps:
        return
    newest = steps[-1]
    for name in os.listdir(directory):
        m = re.match(r"^ckpt-(\d+)\.msgpack\.tmp$", name)
        if m and int(m.group(1)) < newest:
            try:
                os.remove(os.path.join(directory, name))
            except OSError:
                pass


def list_steps(directory):
    """Steps with a complete checkpoint in ``directory`` (rank-local)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_RE.match,
                                               os.listdir(directory)) if m)


def resume_step(directory, default=0):
    """The step every worker resumes from: rank 0 scans the directory and
    broadcasts what it found."""
    if basics.rank() == 0:
        steps = list_steps(directory)
        step = steps[-1] if steps else default
    else:
        step = default
    if basics.size() > 1:
        t = torch.tensor([step], dtype=torch.int64, device=basics.device())
        collective.broadcast_(t, root_rank=0,
                              axes=mesh_lib.get_mesh().world_axes)
        step = int(t.item())
    return step


def _read(directory, step):
    """``(params, opt_state, meta)`` of ``ckpt-<step>``, as numpy trees in
    flax layout (rank-local read)."""
    with open(_fmt(directory, step), "rb") as f:
        restored = _msgpack.restore(f.read())
    return (restored["params"], restored["opt_state"],
            json.loads(restored["meta"] or "{}"))


def restore_checkpoint(directory, step, model, optimizer=None):
    """Load ``ckpt-<step>`` into ``model`` and ``optimizer`` in place;
    returns its meta. Rank-local: see ``restore_or_init`` for the
    broadcast."""
    params, opt_state, meta = _read(directory, step)
    if optimizer is None:
        opt_state = None
    convert.load_train_state_trees(model, optimizer, None, params, opt_state)
    return meta


def restore_or_init(directory, model, optimizer=None, axes=None):
    """The resume convention in one call: rank 0 finds the newest
    checkpoint and the step is broadcast; if there is one, rank 0 reads
    it; then every leaf of the parameters and the optimizer state is
    broadcast from rank 0 and loaded on every rank, so every worker
    starts identical, restored or freshly initialized. ``axes`` is
    accepted and ignored, as JAX's ``restore_or_init`` ignores it: the
    broadcast goes over the whole world. Returns ``(step, meta)``: 0 and
    ``{}`` when there was no checkpoint; meta is rank 0's (``{}``
    elsewhere)."""
    meta = {}
    step = resume_step(directory)
    world = basics.size()
    if step == 0 and world == 1:
        return step, meta
    params, opt_state = _host_trees(model, optimizer)
    if step > 0 and basics.rank() == 0:
        params, opt_state, meta = _read(directory, step)
        if optimizer is None:
            opt_state = {}
    if world > 1:
        trees = (params, opt_state)
        leaves = []
        for leaf in sharded.tree_flatten(trees):
            t = torch.as_tensor(np.asarray(leaf)).to(basics.device())
            collective.broadcast_(t, root_rank=0,
                                  axes=mesh_lib.get_mesh().world_axes)
            leaves.append(t.cpu().numpy())
        params, opt_state = sharded.tree_unflatten(trees, leaves)
    convert.load_train_state_trees(model, optimizer, None, params,
                                   opt_state)
    return step, meta
