"""Elastic worker state: commit / restore / sync. The port of
``horovod_tpu/elastic/state.py``.

A ``State`` is what the training loop commits at batch boundaries. On a
peer's failure the elastic loop calls ``restore()`` (back to the last
commit, the half-applied batch discarded); on a membership change it
keeps the state and only ``sync()``-s, so that new workers start from
the survivors' progress.

``sync()`` broadcasts from the **lowest committed rank** over the
collective plane (``hvd.broadcast_variables``), so a (re)spawned worker
adopts the survivors' state; :class:`TorchState`'s disk commits ride ``ckpt`` (the JAX
package's format), so the state also survives the loss of every
process.
"""

import copy
import json
import logging
import os

import numpy as np
import torch

logger = logging.getLogger("horovod_tpu_torch")

# "No committed state" in the lowest-committed-rank election: beats any
# real rank in a Min reduction.
_UNCOMMITTED = 1 << 30


def _env_rank_world():
    from horovod_tpu_torch.ckpt.snapshot import _env_rank_world as rw
    return rw()


def _multiprocess():
    from horovod_tpu_torch import basics
    return basics.is_initialized() and basics.size() > 1


class State:
    """The base elastic state: subclasses say what ``save`` / ``restore``
    / ``sync`` mean for their payload.

    ``commit()`` is the batch-boundary hook: it saves a restore point,
    publishes a heartbeat, then surfaces any pending membership
    interrupt, so an interrupt never lands inside a batch and the commit
    always holds a completed one."""

    def __init__(self, notification_manager=None):
        if notification_manager is None:
            from horovod_tpu_torch.elastic.notification import \
                notification_manager as default_manager
            notification_manager = default_manager
        self._notification_manager = notification_manager
        self._reset_callbacks = []

    def register_reset_callbacks(self, callbacks):
        """Callbacks the elastic loop runs after a reset (re-rendezvous),
        e.g. to rebuild a step for a new world size."""
        self._reset_callbacks.extend(callbacks)

    def on_reset(self):
        # an async save still in flight must reach durability before the
        # world changes shape, or the new world could restore a step the
        # old one never committed. BOUNDED: when a peer died its shard
        # never lands and the two-phase commit cannot complete; on
        # timeout the save is abandoned (its manifest-less directory is
        # invisible to restore)
        try:
            self.flush(timeout=float(
                os.environ.get("HOROVOD_CKPT_RESET_TIMEOUT", "10")))
        except Exception as e:  # a failed flush must not block recovery
            logger.warning("elastic: checkpoint flush before reset "
                           "failed: %s; abandoning the in-flight save "
                           "(restore falls back to the last complete "
                           "manifest)", e)
            self._abandon_pending_saves()
        # the meshes (and their process groups) built over the old world
        # must not carry the next collective
        from horovod_tpu_torch import basics
        basics.invalidate_meshes()
        self.reset()
        for cb in self._reset_callbacks:
            cb()

    def commit(self):
        self.save()
        self._heartbeat()
        self.check_host_updates()

    def _heartbeat(self):
        """Every commit is a liveness signal too: with a stall inspector
        (``init()`` under ``HOROVOD_ELASTIC=1``) it feeds
        ``record_progress``, which resets the watchdog and fires its
        listeners, the KV heartbeat among them; without one the
        heartbeat is published directly."""
        step = self._progress_step()
        from horovod_tpu_torch import basics
        inspector = basics._state.stall_inspector
        if inspector is not None:
            inspector.record_progress(step)
        from horovod_tpu_torch.elastic import worker
        ctx = worker.get_worker_context()
        if ctx is not None and not (inspector is not None
                                    and ctx.attached_to_inspector):
            ctx.report_progress(step)

    def _progress_step(self):
        """The heartbeat's step: a ``step`` attribute of the state, or of
        a value it holds (a ``StepState`` under ``step_state``)."""
        candidates = [getattr(self, "step", None)]
        candidates += [getattr(getattr(self, k, None), "step", None)
                       for k in ("step_state",)
                       + tuple(getattr(self, "_state_keys", ()))]
        for cand in candidates:
            if cand is None:
                continue
            try:
                return int(np.asarray(cand))
            except (TypeError, ValueError):
                continue
        return None

    def check_host_updates(self):
        """Raise ``HostsUpdatedInterrupt`` if the driver flagged a
        membership change since the last check."""
        self._notification_manager.check()

    def flush(self, timeout=None):
        """Force asynchronous persistence to durability; base states
        have nothing pending."""

    def _abandon_pending_saves(self):
        """Drop persistence that cannot complete; base states have
        none."""

    # -- the payload's hooks -------------------------------------------------
    def save(self):
        raise NotImplementedError

    def restore(self):
        raise NotImplementedError

    def sync(self):
        raise NotImplementedError

    def reset(self):
        pass


class ObjectState(State):
    """Plain attribute state: every keyword becomes an attribute; commit
    deep-copies them, restore puts the copies back, sync adopts the
    lowest committed rank's values over the collective plane (no
    pickle: the values are tensors, numpy arrays, numbers and
    containers of them)."""

    def __init__(self, notification_manager=None, **kwargs):
        super().__init__(notification_manager=notification_manager)
        self._saved_state = None
        self._state_keys = sorted(kwargs)
        for k, v in kwargs.items():
            setattr(self, k, v)

    def _capture(self):
        return {k: copy.deepcopy(getattr(self, k))
                for k in self._state_keys}

    def _adopt(self, values):
        for k in self._state_keys:
            setattr(self, k, copy.deepcopy(values[k]))

    def save(self):
        self._saved_state = self._capture()

    def restore(self):
        if self._saved_state is not None:
            self._adopt(self._saved_state)

    def has_commit(self):
        return self._saved_state is not None

    def _fresh_start(self):
        epoch = int(os.environ.get("HOROVOD_ELASTIC_EPOCH", "0") or 0)
        if epoch > 1:
            # after a driver's relaunch this is almost surely LOST
            # progress (a checkpoint directory not on shared storage)
            logger.warning(
                "elastic: no committed state found on any rank after a "
                "relaunch (epoch %d); training restarts from the fresh "
                "initialization. Put TorchState(directory=...) on "
                "storage every replacement worker can read.", epoch)

    def sync(self, root_rank=None):
        """Adopt the committed state of ``root_rank`` (default: the
        lowest rank that has committed; the election and the broadcast
        are collectives). Returns the rank adopted from."""
        root = _elect_root(root_rank, self.has_commit())
        if root is None:
            # nobody has progress: the fresh initialization, broadcast
            # from rank 0 so rank-dependent initializations agree
            self._fresh_start()
            self._adopt(_broadcast_tree(self._capture(), 0))
            self.save()
            return 0
        payload = (self._saved_state if self.has_commit()
                   else self._capture())
        self._adopt(_broadcast_tree(payload, root))
        self._saved_state = self._capture()
        return root


class TorchState(ObjectState):
    """The PyTorch elastic state, the counterpart of the JAX
    ``JaxState``: a ``model``, its ``optimizer`` (a
    ``DistributedOptimizer``, ZeRO-1's rows included) and the
    ``step_state`` (a step's ``StepState``), saved and restored through
    ``convert.train_state_to_flat`` / ``train_state_from_flat`` as the
    JAX ``TrainState``; keyword values (scalars, arrays) ride beside it
    as ``ObjectState``'s do.

    * **commit**: a real host copy of every leaf (torch updates the
      state in place, so references or views would be overwritten by
      the next step; the copies go into two sets of host buffers used in
      turn, pinned for the card's tensors, which no checkpointer shares)
      and, with ``directory``, a save through ``ckpt.AsyncCheckpointer``
      (every rank its shard, ZeRO rows included; the write and the
      two-phase commit overlap training). ``checkpoint_every=K`` saves
      every K-th commit; ``async_save=False`` waits for the commit.
    * **restore**: the last in-memory commit, else the newest complete
      manifest on disk, resharding ZeRO rows when the world changed
      N→M.
    * **sync**: the lowest committed rank's state broadcast to all, with
      its commit counter and the loader's cursor (a rank's own ZeRO rows
      stay its own: every rank restored the same commit).
    * **flush**: in-flight saves to durability; the elastic loop calls
      it before every re-rendezvous.

    The disk commit is the tree ``{"train_state": <the TrainState's
    leaves>, **keywords}``, the JAX ``JaxState(train_state=...,
    **keywords)``'s, so either package restores the other's. A
    ``data.PrefetchLoader`` given as ``loader=`` (or through
    :meth:`attach_loader`) makes the input position part of the state:
    its cursor is captured at each commit, saved in the manifest's
    ``meta["data_cursor"]``, rolled back by ``restore()``, adopted from
    the root by ``sync()`` and re-sharded on ``reset()``.
    """

    def __init__(self, model=None, optimizer=None, step_state=None,
                 directory=None, keep=3, notification_manager=None,
                 async_save=True, checkpoint_every=1, loader=None,
                 **kwargs):
        super().__init__(notification_manager=notification_manager,
                         **kwargs)
        self.model = model
        self.optimizer = optimizer
        self.step_state = step_state
        self._directory = directory
        self._keep = keep
        self._async_save = async_save
        self.checkpoint_every = max(1, int(checkpoint_every))
        self._commit_count = 0
        self._ckpt = None
        self._loader = loader
        self._saved_cursor = None
        self._buffers = [{}, {}]  # the host copies' two sets, in turn
        self._turn = 0
        self.restores = 0  # commits adopted by restore(), for the loop
        self.last_blocking_s = None  # the last commit's host copy + save()
        self.last_restore_s = None   # the last disk restore

    def attach_loader(self, loader):
        """Adopt ``loader``'s cursor into the commit / restore / sync
        cycle (``training.elastic_train_loop`` calls this when given a
        loader). A cursor already restored from disk is applied now."""
        self._loader = loader
        if loader is not None and self._saved_cursor is not None:
            loader.set_cursor(self._saved_cursor)

    # -- the tree ------------------------------------------------------------
    def _live(self):
        """``{"train_state": live leaves, **keywords}``: views of the
        state (``train_state_to_flat``), not copies."""
        from horovod_tpu_torch import convert
        tree = {k: getattr(self, k) for k in self._state_keys}
        if self.model is not None:
            tree["train_state"] = convert.train_state_to_flat(
                self.model, self.optimizer, self.step_state)
        return tree

    def _host(self, x, key):
        """A host copy of one leaf in this turn's buffer ``key``."""
        from horovod_tpu_torch import ckpt
        if isinstance(x, ckpt.GatheredLeaf):
            x = x.gather()
        if not torch.is_tensor(x):
            return np.array(x)
        bufs = self._buffers[self._turn]
        cuda = x.device.type == "cuda"
        buf = bufs.get(key)
        if buf is None or buf.shape != x.shape or buf.dtype != x.dtype:
            buf = bufs[key] = torch.empty(x.shape, dtype=x.dtype,
                                          pin_memory=cuda)
        buf.copy_(x.detach(), non_blocking=cuda)
        return buf.numpy()

    def _capture(self):
        from horovod_tpu_torch import ckpt
        live = self._live()
        out = {k: np.array(v) if not torch.is_tensor(v)
               else v.detach().to("cpu", copy=True).numpy()
               for k, v in live.items() if k != "train_state"}
        if "train_state" in live:
            leaves = []
            for i, x in enumerate(live["train_state"]):
                if isinstance(x, ckpt.ZeroLeaf):
                    entries = []
                    for key, b, value in x.entries:
                        if b is None:
                            entries.append((key, b, self._host(
                                value, (i, key))))
                        else:
                            entries.append((key, b, {r: self._host(
                                v, (i, key, r)) for r, v in value.items()}))
                    leaves.append(ckpt.ZeroLeaf(x.schedule, x.rank, entries,
                                                replica=x.replica))
                else:
                    leaves.append(self._host(x, i))
            if torch.cuda.is_available():
                torch.cuda.synchronize()  # the non-blocking copies landed
            out["train_state"] = leaves
        self._turn ^= 1  # the next commit writes the other set
        return out

    def _adopt(self, values):
        from horovod_tpu_torch import convert
        for k in self._state_keys:
            v = values[k]
            cur = getattr(self, k)
            if torch.is_tensor(cur):
                cur = cur.new_tensor(torch.from_numpy(np.array(v)))
            elif isinstance(cur, (bool, int, float)):
                cur = type(cur)(np.asarray(v).item())
            else:
                cur = np.array(v)
            setattr(self, k, cur)
        if self.model is not None:
            convert.train_state_from_flat(self.model, self.optimizer,
                                          self.step_state,
                                          values["train_state"])

    # -- disk ----------------------------------------------------------------
    def _checkpointer(self):
        from horovod_tpu_torch import ckpt
        rank, world = _env_rank_world()
        if self._ckpt is not None and (self._ckpt.rank != rank
                                       or self._ckpt.world != world):
            # the world changed under us (a re-rendezvous): drain the old
            # writer (bounded: its barrier may wait on ranks that left)
            self._ckpt.close(timeout=5.0)
            self._ckpt = None
        if self._ckpt is None:
            self._ckpt = ckpt.AsyncCheckpointer(
                self._directory, keep=self._keep, rank=rank, world=world)
        return self._ckpt

    def save(self):
        import time
        t0 = time.perf_counter()
        self._saved_state = self._capture()
        if self._loader is not None:
            self._saved_cursor = self._loader.cursor()
        self._commit_count += 1
        if self._directory and \
                self._commit_count % self.checkpoint_every == 0:
            meta = {"commit": self._commit_count}
            if self._saved_cursor is not None:
                # the input position rides the manifest: a restore
                # resumes the batch stream where this commit left it
                meta["data_cursor"] = self._saved_cursor
            # the live leaves: the checkpointer's own pinned copy of the
            # card's tensors is faster than a host-to-host copy of ours
            self._checkpointer().save(
                self._commit_count, self._live(), meta=meta,
                block=not self._async_save)
        self.last_blocking_s = time.perf_counter() - t0

    def flush(self, timeout=None):
        if self._ckpt is not None:
            self._ckpt.flush(timeout=timeout)

    def _abandon_pending_saves(self):
        if self._ckpt is not None:
            self._ckpt.abandon()
            self._ckpt = None

    def restore(self):
        if self._saved_state is None:
            self._restore_from_disk()
        if self._saved_state is not None:
            self._adopt(self._saved_state)
            self.restores += 1
        if self._loader is not None and self._saved_cursor is not None:
            # the input position rolls back with the model: the retried
            # steps replay the batches of the discarded ones
            self._loader.set_cursor(self._saved_cursor)

    def reset(self):
        super().reset()
        if self._loader is not None:
            try:
                # the membership changed: re-shard the remaining samples
                self._loader.on_reset()
            except Exception:  # never block recovery
                logger.warning("elastic: loader reshard on reset failed",
                               exc_info=True)

    def _restore_from_disk(self):
        if not self._directory:
            return False
        # a rank rebuilding itself from a checkpoint is not serving: the
        # bracket books the time as rendezvous_recovery and flips
        # /healthz to 503 with phase="ckpt_restore"
        from horovod_tpu_torch.telemetry import ledger as ledger_lib
        with ledger_lib.get_ledger().phase("ckpt_restore",
                                           charge="rendezvous_recovery"):
            return self._restore_from_disk_inner()

    def _restore_from_disk_inner(self):
        import time
        from horovod_tpu_torch import ckpt
        if self._ckpt is not None:
            self._ckpt.flush()  # never restore past an in-flight save
        if ckpt.latest_complete_step(self._directory) is None:
            return False
        t0 = time.perf_counter()
        step, restored, meta = ckpt.restore_sharded(self._directory,
                                                    self._live())
        self._saved_state = restored
        self._commit_count = int(meta.get("commit", step))
        self._saved_cursor = meta.get("data_cursor") or self._saved_cursor
        self.last_restore_s = time.perf_counter() - t0
        logger.info("elastic: restored commit %d from the sharded "
                    "checkpoint %s", self._commit_count, self._directory)
        return True

    def sync(self, root_rank=None):
        # a respawned worker first picks up the on-disk commit, so that
        # the election sees its real progress
        if self._saved_state is None and self._restore_from_disk():
            self._adopt(self._saved_state)
            self.restores += 1
        root = _elect_root(root_rank, self.has_commit())
        if not _multiprocess():
            if root is None:
                self._fresh_start()
                self.save()
            return 0
        if root is None:
            self._fresh_start()
            self._broadcast_live(0)
            self.save()
            return 0
        if self.has_commit():
            self._adopt(self._saved_state)
        self._broadcast_live(root)
        self._saved_state = self._capture()
        # the root's commit counter too: ranks that disagree on it
        # would write their next shards under different steps, a
        # two-phase commit barrier that never completes
        self._commit_count = _broadcast_int(self._commit_count, root)
        self._sync_cursor(root)
        return root

    def _broadcast_live(self, root):
        """The live state of ``root`` to every rank: each tensor leaf of
        the train state (ZeRO rows excepted: a rank's rows are its own)
        and each keyword value."""
        from horovod_tpu_torch import basics, ckpt, convert, hvd_torch
        dev = basics.device()
        me = basics.rank()
        for k in self._state_keys:
            v = getattr(self, k)
            t = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                else v).to(dev).clone()
            hvd_torch.broadcast_variables([t], root_rank=root)
            if me != root:
                setattr(self, k, _like(v, t))
        if self.model is None:
            return
        leaves = convert.train_state_to_flat(self.model, self.optimizer,
                                             self.step_state)
        out = []
        for x in leaves:
            if isinstance(x, ckpt.ZeroLeaf):
                # this rank's rows stay its own (written back as they are)
                out.append(ckpt.ZeroLeaf(x.schedule, x.rank, [
                    (key, b, _np(v) if b is None
                     else {r: _np(row) for r, row in v.items()})
                    for key, b, v in x.entries], replica=x.replica))
                continue
            if isinstance(x, ckpt.GatheredLeaf):
                x = x.gather()
            t = (x.detach() if torch.is_tensor(x)
                 else torch.as_tensor(np.asarray(x))).to(dev).contiguous()
            t = t.clone()
            hvd_torch.broadcast_variables([t], root_rank=root)
            out.append(t.cpu().numpy())
        if me != root:
            convert.train_state_from_flat(self.model, self.optimizer,
                                          self.step_state, out)

    def _sync_cursor(self, root):
        """Adopt ``root``'s committed data cursor (JSON over the
        collective plane: a length broadcast sizes the byte buffer)."""
        if self._loader is None:
            # loader attachment is part of the program (the same on
            # every rank), so this branch is uniform across ranks
            return
        payload = b""
        if self._saved_cursor is not None:
            payload = json.dumps(self._saved_cursor,
                                 sort_keys=True).encode()
        length = _broadcast_int(len(payload), root)
        if length <= 0:
            return
        buf = (np.frombuffer(payload, dtype=np.uint8).copy()
               if len(payload) == length
               else np.zeros(length, dtype=np.uint8))
        from horovod_tpu_torch import basics, hvd_torch
        t = torch.from_numpy(buf).to(basics.device())
        hvd_torch.broadcast_variables([t], root_rank=root)
        try:
            cur = json.loads(bytes(t.cpu().numpy()).decode())
        except (ValueError, UnicodeDecodeError):
            logger.warning("elastic: undecodable data cursor from rank "
                           "%s; keeping the local one", root)
            return
        self._saved_cursor = cur
        self._loader.set_cursor(cur)


def _np(x):
    """A numpy copy of a tensor (or array)."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


def _like(old, t):
    """``t`` (a broadcast tensor) in the type of ``old``."""
    if torch.is_tensor(old):
        return t.to(old.device)
    arr = t.cpu().numpy()
    if isinstance(old, (bool, int, float)):
        return type(old)(arr.item())
    return arr


def _broadcast_int(value, root):
    from horovod_tpu_torch import basics, hvd_torch
    t = torch.tensor([int(value)], dtype=torch.int64,
                     device=basics.device())
    hvd_torch.broadcast_variables([t], root_rank=root)
    return int(t.item())


def _elect_root(root_rank, has_commit):
    """The broadcast's root: ``root_rank``, or the lowest rank that has a
    commit (a Min all-reduce); None when no rank has one (one process:
    this process's own view)."""
    if root_rank is not None:
        return root_rank
    if not _multiprocess():
        return 0 if has_commit else None
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.ops import collective
    from horovod_tpu_torch.ops.reduction import Min
    me = basics.rank() if has_commit else _UNCOMMITTED
    t = torch.tensor([me], dtype=torch.int64, device=basics.device())
    from horovod_tpu_torch.parallel import mesh as mesh_lib
    # over the world, whatever axes the training reduces over
    root = int(collective.allreduce_(
        t, op=Min, axes=mesh_lib.get_mesh().world_axes).item())
    return None if root >= _UNCOMMITTED else root


def _broadcast_tree(tree, root):
    """Every tensor, array and number of ``tree`` (dicts, lists, tuples
    of them) from ``root`` over the collective plane; the identity in
    one process."""
    if not _multiprocess():
        return tree
    from horovod_tpu_torch import basics, hvd_torch
    dev = basics.device()

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if not (torch.is_tensor(node) or isinstance(
                node, (np.ndarray, np.generic, bool, int, float))):
            raise TypeError(f"elastic state values must be tensors, "
                            f"arrays or numbers; got {type(node).__name__}")
        t = torch.as_tensor(np.asarray(node) if not torch.is_tensor(node)
                            else node.detach()).to(dev).clone()
        hvd_torch.broadcast_variables([t], root_rank=root)
        return _like(node, t)

    return walk(tree)
