"""Checkpoint layout + the two-phase manifest commit: the port of
``horovod_tpu/ckpt/manifest.py``, the same files, markers and protocol,
so either package commits and reads the other's checkpoints.

Layout (one directory per step under the checkpoint root)::

    <root>/ckpt-<step>/shard-<r>-of-<w>.msgpack   per-rank payload
    <root>/ckpt-<step>/shard-<r>-of-<w>.ok        durability marker + CRC
    <root>/ckpt-<step>/MANIFEST.json              written LAST, by rank 0
    <root>/latest                                 pointer (human/tooling aid)

**Two-phase commit.** Phase 1: every rank writes its shard (tmp + fsync
+ rename + directory fsync) and then its ``.ok`` marker carrying the
shard's CRC32 and byte count — the marker is the durable "my shard is
on disk" ack. Phase 2: rank 0 waits for all ``w`` markers, aggregates
their CRCs into ``MANIFEST.json`` (tmp + fsync + rename + dir fsync),
updates ``latest``, and runs retention GC. **A checkpoint without a
manifest never happened**: the loader only ever considers
manifest-complete steps, so a crash at any point mid-save leaves either
the previous complete checkpoint (torn dir ignored, later GC'd) or the
new complete one — never a half-read.

**The barrier.** The phase-1→2 barrier is the ``.ok`` markers on the
shared checkpoint filesystem itself — sharded restore already requires
every rank to read every shard, so a shared FS is a subsystem invariant
and the markers double as the ack channel. It deliberately does NOT
ride the collective plane: commits run on a background thread
(``snapshot.AsyncCheckpointer``), and a background collective would
race the training step's collectives into a desync. When the launcher's
key-value store is configured (``HOROVOD_GLOO_RENDEZVOUS_ADDR/PORT``),
each rank additionally publishes a best-effort ``ckpt/ack/<step>/<rank>``
key through ``run/rendezvous.py``'s client, so the launcher's side can
observe checkpoint progress — but durability decisions never depend on
it.

Retention GC (rank 0, after each commit): keeps the newest ``keep``
manifest-COMPLETE checkpoints; manifest-less dirs older than the newest
complete step — by step number AND by dir mtime against that step's
recorded commit time — are dead torn writes and are removed too. A
manifest-less dir newer by either measure is (or may be) an in-flight
save and is never touched: step numbering can run backwards after a
fallback restore past a damaged newest step.
"""

import json
import logging
import os
import re
import shutil
import time

logger = logging.getLogger("horovod_tpu_torch")

MANIFEST_NAME = "MANIFEST.json"
LATEST_NAME = "latest"
# 1: one unkeyed ZeroState row per rank shard (the pre-GSPMD layout).
# 2: ZeroState rows keyed by ROW index, each shard carrying the block
#    of schedule rows its process owns (sharded.py _owned_rows) — a
#    single GSPMD process saves every row. Readers accept <= their own
#    version (v2 restores v1 shards); a payload from a NEWER writer
#    fails loudly by version, not by a misleading shape error.
FORMAT_VERSION = 2

_DIR_RE = re.compile(r"^ckpt-(\d+)$")
_POLL_S = 0.02


def step_dir(root, step):
    return os.path.join(root, f"ckpt-{int(step)}")


def shard_name(rank, world):
    return f"shard-{int(rank)}-of-{int(world)}.msgpack"


def ok_name(rank, world):
    return shard_name(rank, world) + ".ok"


def fsync_dir(path):
    """fsync a DIRECTORY so a rename into it is durable across power
    loss (rename alone only orders metadata in the page cache)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass  # some filesystems refuse dir fsync; best effort
    finally:
        os.close(fd)


def atomic_write(path, data, fsync_parent=True):
    """tmp + fsync + rename (+ parent dir fsync): the write either fully
    exists under its final name or not at all, and survives a crash."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)
    if fsync_parent:
        fsync_dir(os.path.dirname(path))


# -- discovery (the torn-write-recovery read side) --------------------------

def _step_dirs(root):
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = _DIR_RE.match(name)
        if m and os.path.isdir(os.path.join(root, name)):
            out.append(int(m.group(1)))
    return sorted(out)


def is_complete(root, step):
    return os.path.isfile(os.path.join(step_dir(root, step), MANIFEST_NAME))


def list_complete_steps(root):
    """Steps with a committed MANIFEST under ``root`` — the ONLY steps a
    loader may consider (manifest-less dirs are torn writes)."""
    return [s for s in _step_dirs(root) if is_complete(root, s)]


def latest_complete_step(root, default=None):
    """Newest committed step by SCANNING for manifests — the ``latest``
    pointer file is advisory (for humans and external tooling); the
    manifest set is the truth a crashed pointer update cannot skew."""
    steps = list_complete_steps(root)
    return steps[-1] if steps else default


def read_manifest(root, step):
    with open(os.path.join(step_dir(root, step), MANIFEST_NAME)) as f:
        return json.load(f)


def manifest_path(root, step):
    return os.path.join(step_dir(root, step), MANIFEST_NAME)


def manifest_mtime(root, step):
    """mtime of a step's committed MANIFEST, or ``None`` when the step
    dir is manifest-less (torn/in-flight — it never happened). A pure
    ``stat``: cheap enough to poll."""
    try:
        return os.path.getmtime(manifest_path(root, step))
    except OSError:
        return None


def complete_manifests(root):
    """Stat-only probe: ``[(step, manifest_mtime), ...]`` for every
    manifest-complete step under ``root``, ascending by step — no shard is
    opened, so watchers can poll it often. Torn (manifest-less) dirs are
    invisible, as for the loaders. The mtime tells a RE-commit of the same
    step number (fallback-restore step numbering can run backwards) from
    nothing new, and is the recency key a rolling-reload watcher ranks by
    when the highest-numbered step is unloadable (``serve/loader.py``)."""
    out = []
    for s in _step_dirs(root):
        mt = manifest_mtime(root, s)
        if mt is not None:
            out.append((s, mt))
    return out


def latest_manifest(root):
    """Cheap newest-complete probe: ``(step, manifest_mtime)`` of the
    newest (by step number) manifest-complete step, or ``None``."""
    probes = complete_manifests(root)
    return probes[-1] if probes else None


# -- the commit -------------------------------------------------------------

def write_ok(root, step, rank, world, crc32, nbytes):
    """Phase-1 ack: ``shard-<r>-of-<w>.ok`` with the shard's CRC32 +
    size. Written AFTER the shard file is durable; atomic itself."""
    sdir = step_dir(root, step)
    payload = {"rank": int(rank), "world": int(world),
               "file": shard_name(rank, world),
               "crc32": int(crc32), "bytes": int(nbytes)}
    atomic_write(os.path.join(sdir, ok_name(rank, world)),
                 json.dumps(payload).encode())
    _kv_announce(f"ckpt/ack/{int(step)}/{int(rank)}", payload)


def clear_stale_ack(root, step, rank, world):
    """A dir left by a previous incarnation of this job may still hold
    this rank's OLD phase-1 ack (crash mid-save, then restore + re-save
    of the same step number). A new save into that dir must clear it
    BEFORE any fresh bytes land, or a peer's commit barrier could pair
    a fresh manifest with this rank's stale shard CRC. A
    manifest-COMPLETE dir can be re-entered too: restore falling back
    past a CRC-damaged newest step resumes training BELOW it, and the
    resumed counter re-reaches the damaged step number — the old
    MANIFEST must go first (the dir becomes torn again, invisible to
    restore), or every rank's commit barrier would be satisfied
    instantly by the stale acks it pairs with. Safe ordering: rank 0's
    NEW manifest needs every rank's fresh ack, and each rank's fresh
    ack postdates that rank's clear — so no clear can remove a new
    manifest."""
    sdir = step_dir(root, step)
    man = os.path.join(sdir, MANIFEST_NAME)
    ok = os.path.join(sdir, ok_name(rank, world))
    for stale in (man, ok):
        if os.path.isfile(stale):
            try:
                os.remove(stale)
                fsync_dir(sdir)
            except OSError:
                pass


def _await(predicate, timeout, what):
    deadline = time.monotonic() + timeout
    while True:
        got = predicate()
        if got is not None:
            return got
        if time.monotonic() >= deadline:
            raise TimeoutError(f"checkpoint commit: timed out after "
                               f"{timeout:.0f}s waiting for {what}")
        time.sleep(_POLL_S)


def _read_oks(root, step, world):
    sdir = step_dir(root, step)
    infos = {}
    for r in range(world):
        p = os.path.join(sdir, ok_name(r, world))
        if not os.path.isfile(p):
            return None
        try:
            with open(p) as f:
                infos[str(r)] = json.load(f)
        except (OSError, ValueError):
            return None  # racing the rename; retry
    return infos


def commit(root, step, rank, world, meta=None, zero_info=None, keep=None,
           timeout=120.0):
    """Run this rank's half of phase 2. Rank 0 barriers on every
    ``.ok`` marker, writes MANIFEST + ``latest`` and GCs; other ranks
    wait for the manifest to appear. Returns the manifest dict."""
    sdir = step_dir(root, step)
    if rank == 0:
        infos = _await(lambda: _read_oks(root, step, world), timeout,
                       f"{world} shard .ok markers in {sdir}")
        manifest = {
            "format": FORMAT_VERSION,
            "step": int(step),
            "world": int(world),
            "time": time.time(),
            "meta": meta or {},
            "shards": infos,
            "zero": zero_info or [],
        }
        atomic_write(os.path.join(sdir, MANIFEST_NAME),
                     json.dumps(manifest, indent=1).encode())
        atomic_write(os.path.join(root, LATEST_NAME),
                     (str(int(step)) + "\n").encode())
        _kv_announce(f"ckpt/manifest/{int(step)}", {"world": int(world)})
        if keep:
            retention_gc(root, keep)
        return manifest
    _await(lambda: (True if is_complete(root, step) else None), timeout,
           f"rank 0's {MANIFEST_NAME} in {sdir}")
    return read_manifest(root, step)


def retention_gc(root, keep):
    """Prune to the newest ``keep`` COMPLETE checkpoints. Manifest-less
    dirs older than the newest complete step are dead torn writes and
    go too; newer ones are in-flight saves and are left alone. "Older"
    is judged by the dir's mtime against the newest manifest's recorded
    commit time, not by step NUMBER alone: after a fallback restore past
    a damaged newest step, resumed training re-uses lower step numbers,
    and a peer may be mid-write into such a dir right now."""
    complete = list_complete_steps(root)
    if not complete:
        return []
    doomed = set(complete[:-keep]) if keep else set()
    newest = complete[-1]
    try:
        newest_time = float(read_manifest(root, newest).get("time", 0.0))
    except (OSError, ValueError):
        newest_time = 0.0
    for s in _step_dirs(root):
        if is_complete(root, s) or s >= newest:
            continue
        try:
            mtime = os.path.getmtime(step_dir(root, s))
        except OSError:
            continue  # vanished under us (a peer's GC)
        if mtime < newest_time:
            doomed.add(s)  # torn write, predates the newest commit — dead
    removed = []
    for s in sorted(doomed):
        shutil.rmtree(step_dir(root, s), ignore_errors=True)
        removed.append(s)
    if removed:
        logger.info("ckpt: retention GC removed step(s) %s from %s",
                    removed, root)
    return removed


def _kv_announce(key, payload):
    """Best-effort progress ack on the elastic rendezvous KV (the
    ``run/allocation`` plane) so the driver can observe checkpoint
    progress. Never load-bearing; never raises."""
    addr = os.environ.get("HOROVOD_GLOO_RENDEZVOUS_ADDR")
    port = os.environ.get("HOROVOD_GLOO_RENDEZVOUS_PORT")
    if not addr or not port:
        return
    try:
        from horovod_tpu_torch.run import rendezvous, secret
        rendezvous.kv_put(addr, int(port), key, json.dumps(payload).encode(),
                          auth_key=secret.key_from_env())
    except Exception:  # best effort, off the commit path
        pass
