"""Per-rank shard files + deterministic N→M reshard-on-load: the port of
``horovod_tpu/ckpt/sharded.py``, writing and reading the same bytes.

**The tree.** A state is a tree of dicts (keys sorted, as JAX flattens
them), lists and tuples whose leaves are arrays (numpy or torch, any
device), numpy scalars, ``ZeroLeaf``s and ``GatheredLeaf``s:
``convert.train_state_to_flat`` gives the JAX ``TrainState``'s flat leaf
list in this form, a ``ZeroLeaf`` standing where JAX flattens a
``ZeroState`` as one leaf, a ``GatheredLeaf`` for a leaf that a tensor-
or expert-parallel state holds cut over ranks and the JAX package writes
whole (its ``_host`` is ``device_get`` of the global array): a gathered
leaf is a replicated leaf.

**What a shard holds.** Replicated leaf ``i`` lives in shard
``i % world``. Inside each ``ZeroLeaf`` the ``[world, shard]`` bucket
leaves are split by ownership: process ``rank`` of ``world`` writes the
contiguous block of the schedule's rows it owns (``_owned_rows``), keyed
by row index; one process a rank writes exactly its own row, the one it
holds. The replicated inner leaves (the step count) ride in rank 0's
shard. The payload is ``{"format": 2, "rank", "world", "repl",
"zero"}``, serialized as flax's msgpack (``_msgpack.py``).

**N→M reshard.** The bucket partition depends only on the parameters
and the fusion threshold, not on the world; only each bucket's padding
to a multiple of the world does. So the N saved rows of a bucket
concatenate to its ``used`` elements plus padding: restore truncates to
``used``, re-pads for M and reshapes to ``[M, shard_M]``, carrying the
optimizer state over bit for bit. The manifest records each bucket's
used and padded sizes, so a model or threshold that differs fails
loudly.

Every shard file carries a CRC32, recorded in its ``.ok`` marker and
aggregated into the manifest; restore checks each shard against the
manifest before it decodes it.
"""

import logging
import os
import time
import zlib

import numpy as np
import torch

from horovod_tpu_torch.ckpt import _msgpack
from horovod_tpu_torch.ckpt import manifest as manifest_lib

logger = logging.getLogger("horovod_tpu_torch")


class ShardValidationError(ValueError):
    """A shard of a manifest-complete step is unusable: missing, or it
    fails its manifest CRC32. Restore falls back to an older complete
    step for it, while a layout or tree mismatch stays loud."""


step_dir = manifest_lib.step_dir


def shard_path(root, step, rank, world):
    return os.path.join(manifest_lib.step_dir(root, step),
                        manifest_lib.shard_name(rank, world))


class ZeroLeaf:
    """ZeRO-1's optimizer state as one leaf of the flat state, the
    port's counterpart of a JAX ``ZeroState``: the bucket ``schedule``
    (``ops.fusion.BucketSchedule``), ``rank``, the row of each bucket
    this process holds (its rank, or under a hierarchical schedule its
    ``(data, dcn)``-major index), and ``entries``, ``(key, bucket index or None, value)`` in the
    order JAX flattens the inner optax state, each key its
    ``jax.tree_util.keystr``. A bucket entry's value is ``{row index:
    [shard] array}`` of the rows held (to save), or the whole
    ``[world, shard]`` array (restored); a replicated entry's is its
    array. ``replica`` is this process's index among the ranks that hold
    the same row (``Mesh.replica_index`` of the schedule's axes: rows
    laid out over a part of the mesh, such as ``("data",)`` on a
    ``(data, model)`` mesh, are replicated along the other axes); the
    rows are written once, by replica 0. None: the rows are laid out
    over every process of the save."""

    def __init__(self, schedule, rank, entries, replica=None):
        self.schedule, self.rank = schedule, rank
        self.entries = list(entries)
        self.replica = replica

    @property
    def used_sizes(self):
        return [int(sum(b.sizes)) for b in self.schedule.buckets]

    def __repr__(self):
        return (f"ZeroLeaf(buckets={len(self.schedule.buckets)}, "
                f"world={self.schedule.world}, rank={self.rank})")


class GatheredLeaf:
    """A leaf that a tensor- or expert-parallel state holds cut over the
    model or expert axes, saved whole as the JAX package writes it
    (``convert._shard_tree``): ``gather()`` returns the whole leaf on the
    device; ``shape``, ``dtype`` and ``device`` are the whole leaf's.
    With ``collective`` the gather runs over process groups, so every
    rank of the save calls it, in leaf order, whether it writes the leaf
    or not. A save gathers one leaf at a time and copies it to the host
    before it gathers the next, so the device holds at most one whole
    leaf beyond the state."""

    def __init__(self, gather, shape, dtype, device, collective=False):
        self.gather = gather
        self.shape, self.dtype, self.device = tuple(shape), dtype, device
        self.collective = collective

    def __repr__(self):
        return (f"GatheredLeaf(shape={self.shape}, dtype={self.dtype}, "
                f"collective={self.collective})")


def tree_flatten(tree):
    """The leaves of ``tree`` in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_flatten(v)]
    if tree is None:
        return []
    return [tree]


def tree_unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` in its leaves' places."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        if node is None:
            return None
        return next(it)

    return build(tree)


class Staging:
    """Host buffers kept from one save to the next: a pinned buffer for
    each of the card's tensors (a plain one for the CPU's), made on the
    first save and reused by every later save whose tensor in that
    place has the same shape, dtype and device kind. Pinning host
    memory is most of a first save's stall; a reused buffer is only
    copied into. A save's payload is views of these buffers, so a
    staging set serves one save in flight at a time. ``pin_s``,
    ``gather_s`` and ``copy_s`` are the latest save's seconds making
    buffers, gathering ``GatheredLeaf``s (the card's time between events
    around each gather; the host's on the CPU) and copying into the
    buffers (the device-to-host copy and the wait for it)."""

    def __init__(self):
        self.buffers = []  # per leaf: ((shape, dtype, on card), tensor)
        self.pin_s = self.gather_s = self.copy_s = 0.0


class _GatherOnly:
    """A collective ``GatheredLeaf`` that another rank writes: this rank
    joins its gather and keeps nothing."""

    def __init__(self, leaf):
        self.leaf = leaf


def _gather(x, gathers):
    """``x.gather()``, timed: the card's events around it appended to
    ``gathers``, or the host's seconds."""
    if x.device.type == "cuda":
        marks = (torch.cuda.Event(enable_timing=True),
                 torch.cuda.Event(enable_timing=True))
        marks[0].record()
        out = x.gather()
        marks[1].record()
        gathers.append(marks)
        return out, 0.0
    t0 = time.perf_counter()
    out = x.gather()
    return out, time.perf_counter() - t0


def _to_host(leaves, staging=None):
    """Host numpy copies of ``leaves`` that share no memory with them:
    each tensor copied into its buffer of ``staging`` (fresh buffers
    when None), the card's tensors into pinned buffers with one event
    waited for at the end; other leaves copied by numpy. A
    ``GatheredLeaf`` is gathered here, in order, each before the next; a
    ``_GatherOnly`` is gathered and gives None."""
    staging = Staging() if staging is None else staging
    t0 = time.perf_counter()
    bufs = staging.buffers
    bufs[len(leaves):] = []
    bufs += [None] * (len(leaves) - len(bufs))
    for j, x in enumerate(leaves):
        if torch.is_tensor(x) or isinstance(x, GatheredLeaf):
            cuda = x.device.type == "cuda"
            key = (tuple(x.shape), x.dtype, cuda)
            if bufs[j] is None or bufs[j][0] != key:
                bufs[j] = (key, torch.empty(x.shape, dtype=x.dtype,
                                            pin_memory=cuda))
    t1 = time.perf_counter()
    out, event, gathers, gather_s = [], None, [], 0.0
    for x, slot in zip(leaves, bufs):
        if isinstance(x, _GatherOnly):
            gather_s += _gather(x.leaf, gathers)[1]
            out.append(None)
            continue
        if isinstance(x, GatheredLeaf):
            x, seconds = _gather(x, gathers)
            gather_s += seconds
        if torch.is_tensor(x):
            host = slot[1]
            host.copy_(x.detach(), non_blocking=x.is_cuda)
            if x.is_cuda:
                event = event or torch.cuda.Event()
            out.append(host.numpy())
        else:
            out.append(np.array(x))
    if event is not None:
        event.record()
        event.synchronize()
    for a, b in gathers:
        b.synchronize()
        gather_s += a.elapsed_time(b) / 1e3
    staging.pin_s, staging.gather_s = t1 - t0, gather_s
    staging.copy_s = time.perf_counter() - t1 - gather_s
    return out


def _owned_rows(sched_world, rank, world):
    """The contiguous block of a schedule's ``[world, shard]`` rows that
    process ``rank`` of ``world`` saves (one process a rank: its own)."""
    lo = rank * sched_world // world
    hi = (rank + 1) * sched_world // world
    return range(lo, hi)


def _zero_infos(leaves):
    """The manifest's description of each ZeroLeaf: the reshard
    validator."""
    infos = []
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, ZeroLeaf):
            sched = leaf.schedule
            infos.append({
                "leaf": i,
                "world": int(sched.world),
                "used_sizes": leaf.used_sizes,
                "padded_sizes": [int(p) for p in sched.padded_sizes],
            })
    return infos


def snapshot_payload(tree, rank, world, staging=None):
    """The synchronous half of a save: a host copy of this rank's share
    of ``tree``. Returns ``(payload, zero_info)``: the payload is nested
    dicts of host numpy arrays that share no memory with the live state
    (which torch updates in place), so everything after this call may
    run on another thread while training goes on. ``staging`` (a
    ``Staging``) keeps the host buffers for the next save; the payload
    is views of them until then."""
    leaves = tree_flatten(tree)
    picked = []  # (where, value): where names the payload slot
    z = 0
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, ZeroLeaf):
            sched_world = int(leaf.schedule.world)
            # one rank a row: the row it holds, once however many
            # replicas hold it; else a block of rows
            if leaf.replica is not None and sched_world < world:
                held = [leaf.rank] if leaf.replica == 0 else []
            elif sched_world == world:
                held = [leaf.rank]
            else:
                held = _owned_rows(sched_world, rank, world)
            for key, bucket, value in leaf.entries:
                if bucket is not None:
                    for r in held:
                        if r not in value:
                            raise ValueError(
                                f"rank {rank} of {world} saves row {r} of "
                                f"{key!r}, which this process does not "
                                "hold")
                        picked.append((("rows", z, key, str(r)), value[r]))
                elif rank == 0:
                    picked.append((("zrepl", z, key), value))
            z += 1
        elif i % world == rank:
            picked.append((("repl", str(i)), leaf))
        elif isinstance(leaf, GatheredLeaf) and leaf.collective:
            picked.append((None, _GatherOnly(leaf)))
    host = _to_host([v for _, v in picked], staging)
    repl, zeros = {}, {str(k): {"rows": {}, "repl": {}} for k in range(z)}
    for (where, _), arr in zip(picked, host):
        if where is None:
            continue
        if where[0] == "repl":
            repl[where[1]] = arr
        elif where[0] == "zrepl":
            zeros[str(where[1])]["repl"][where[2]] = arr
        else:
            rows = zeros[str(where[1])]["rows"].setdefault(where[2], {})
            rows[where[3]] = arr
    payload = {"format": manifest_lib.FORMAT_VERSION, "rank": int(rank),
               "world": int(world), "repl": repl, "zero": zeros}
    return payload, _zero_infos(leaves)


def write_shard(root, step, payload):
    """Serialize + CRC + durably write one rank's shard, then its ``.ok``
    marker (the phase-1 ack). Returns ``{file, crc32, bytes}``."""
    rank, world = payload["rank"], payload["world"]
    sdir = manifest_lib.step_dir(root, step)
    os.makedirs(sdir, exist_ok=True)
    data = _msgpack.serialize(payload)
    crc = zlib.crc32(data) & 0xFFFFFFFF
    manifest_lib.atomic_write(
        os.path.join(sdir, manifest_lib.shard_name(rank, world)), data)
    manifest_lib.write_ok(root, step, rank, world, crc, len(data))
    return {"file": manifest_lib.shard_name(rank, world),
            "crc32": crc, "bytes": len(data)}


def save_sharded(root, step, tree, rank=0, world=1, meta=None, keep=None,
                 timeout=120.0):
    """Synchronous save: snapshot + write + commit, this rank's part of
    the two-phase protocol. Returns the manifest dict."""
    manifest_lib.clear_stale_ack(root, step, rank, world)
    payload, zero_info = snapshot_payload(tree, rank, world)
    write_shard(root, step, payload)
    return manifest_lib.commit(root, step, rank, world, meta=meta,
                               zero_info=zero_info, keep=keep,
                               timeout=timeout)


# -- restore ----------------------------------------------------------------

def _read_shard(root, step, rank, world, expect):
    path = shard_path(root, step, rank, world)
    with open(path, "rb") as f:
        data = f.read()
    crc = zlib.crc32(data) & 0xFFFFFFFF
    if expect is not None and crc != int(expect.get("crc32", crc)):
        raise ShardValidationError(
            f"checkpoint shard {path} failed its CRC32 check "
            f"(manifest {expect['crc32']:#010x}, file {crc:#010x}): the "
            "shard is corrupt or torn; restore a different step")
    payload = _msgpack.restore(data)
    fmt = int(payload.get("format", 1))
    if fmt > manifest_lib.FORMAT_VERSION:
        raise ValueError(
            f"checkpoint shard {path} was written with format {fmt}, this "
            f"reader understands <= {manifest_lib.FORMAT_VERSION}")
    return payload


def _shape_of(leaf):
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def _fit(saved, leaf, what):
    """The saved array in the target leaf's shape (a same-size
    difference, such as a 0-d array read back, is reshaped)."""
    want = _shape_of(leaf)
    if np.shape(saved) != want:
        if np.size(saved) != int(np.prod(want, dtype=np.int64)):
            raise ValueError(f"{what} has shape {np.shape(saved)} in the "
                             f"checkpoint, the restore target expects "
                             f"{want}")
        saved = np.asarray(saved).reshape(want)
    return saved


def _assemble_zero(target, z, payloads, info):
    """Re-slice one ZeroLeaf's rows for the target's world."""
    sched = target.schedule
    used = target.used_sizes
    if info is None or info.get("used_sizes") != used:
        raise ValueError(
            "checkpoint ZeRO bucket layout does not match the restore "
            f"target (saved used_sizes={info and info.get('used_sizes')}, "
            f"target={used}): the bucket partition is a function of the "
            "parameters and the fusion threshold; restore with the same "
            "model and HOROVOD_FUSION_THRESHOLD it was saved under")
    src_world = int(info["world"])
    zkey = str(z)
    entries = []
    for key, bucket, leaf in target.entries:
        if bucket is None:
            try:
                saved = payloads[0]["zero"][zkey]["repl"][key]
            except KeyError:
                raise ValueError(f"checkpoint is missing replicated "
                                 f"optimizer leaf {key!r} of ZeroState "
                                 f"#{z}") from None
            entries.append((key, None, _fit(
                saved, leaf, f"replicated optimizer leaf {key!r}")))
            continue
        rows = {}
        for p in payloads:
            saved = p.get("zero", {}).get(zkey, {}).get("rows", {}).get(key)
            if saved is None:
                continue
            if isinstance(saved, dict):
                rows.update({int(r): a for r, a in saved.items()})
            else:  # format 1: one unkeyed row, the saving rank's
                rows[int(p["rank"])] = saved
        missing = [r for r in range(src_world) if r not in rows]
        if missing:
            raise ValueError(f"checkpoint is missing bucket row(s) "
                             f"{missing} of {key!r} in ZeroState #{z} "
                             f"(saved schedule world {src_world})")
        flat = np.concatenate([np.asarray(rows[r]).reshape(-1)
                               for r in range(src_world)])
        n_used = used[bucket]
        if flat.shape[0] < n_used:
            raise ValueError(f"checkpoint rows for bucket {bucket} of "
                             f"ZeroState #{z} hold {flat.shape[0]} "
                             f"elements < used {n_used}")
        out = np.zeros((sched.padded_sizes[bucket],), dtype=flat.dtype)
        out[:n_used] = flat[:n_used]
        entries.append((key, bucket, out.reshape(
            sched.world, sched.shard_sizes[bucket])))
    return ZeroLeaf(sched, target.rank, entries, replica=target.replica)


def restore_sharded(root, target, step=None):
    """Load a sharded checkpoint into the structure of ``target`` (every
    rank reads every shard it needs; nothing is broadcast). ``step=None``
    takes the newest manifest-complete step and falls back to older
    complete ones when its shards fail validation; an explicit ``step``
    fails loudly. The target may be built for another world than the
    checkpoint's: ZeRO rows are re-sliced. Returns ``(step, tree,
    meta)``, the tree's leaves numpy arrays (a ``ZeroLeaf`` holding
    whole ``[world, shard]`` rows)."""
    if step is not None:
        if not manifest_lib.is_complete(root, step):
            raise FileNotFoundError(
                f"step {step} under {root} has no "
                f"{manifest_lib.MANIFEST_NAME} (incomplete/torn "
                "checkpoint)")
        return _restore_step(root, target, step)
    steps = manifest_lib.list_complete_steps(root)
    if not steps:
        raise FileNotFoundError(
            f"no manifest-complete checkpoint under {root}")
    last_err = None
    for s in reversed(steps):
        try:
            return _restore_step(root, target, s)
        except (OSError, ShardValidationError) as e:
            logger.warning("ckpt: step %d under %s is unrestorable (%s); "
                           "falling back to the previous complete step",
                           s, root, e)
            last_err = e
    raise ValueError(
        f"no restorable checkpoint under {root}: all {len(steps)} "
        f"manifest-complete step(s) failed validation") from last_err


def _restore_step(root, target, step):
    man = manifest_lib.read_manifest(root, step)
    src_world = int(man["world"])
    shards = man.get("shards") or {}
    payloads = [_read_shard(root, step, r, src_world, shards.get(str(r)))
                for r in range(src_world)]
    zero_by_index = {int(i["leaf"]): i for i in (man.get("zero") or [])}
    leaves = tree_flatten(target)
    out, z = [], 0
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, ZeroLeaf):
            out.append(_assemble_zero(leaf, z, payloads,
                                      zero_by_index.get(i)))
            z += 1
            continue
        try:
            saved = payloads[i % src_world]["repl"][str(i)]
        except KeyError:
            raise ValueError(
                f"checkpoint step {step} has no leaf {i}: it was saved "
                f"from a different state tree ({len(leaves)} target "
                "leaves)") from None
        out.append(_fit(saved, leaf, f"checkpoint leaf {i}"))
    return step, tree_unflatten(target, out), man.get("meta") or {}
