"""Serve-side weight loading: ckpt manifest -> the serving engine. The
port of ``horovod_tpu/serve/loader.py``.

A training checkpoint is a sharded ``TrainState`` (params, optimizer
state, batch stats, step — ``ckpt/sharded.py``), written by either
package in the flax layout (``convert.train_state_to_flat``). Serving
needs one slice of it: the params. Two properties of the layout make
that slice cheap and world-independent:

* the state flattens with ``params`` FIRST, and replicated leaves are
  round-robin-assigned by flat leaf index — so the params occupy flat
  indices ``0..n_params-1`` whatever optimizer trained them. The loader
  never reconstructs the optimizer's state; ZeRO bucket rows are never
  assembled.
* an N-rank training checkpoint loads in one serving process by reading
  the N shards' round-robin homes.

The params come back as the flax tree (numpy leaves) the JAX package's
loader returns; ``ServeEngine`` takes it as it is (through
``convert.params_from_flax``) or a torch ``state_dict``.

:class:`ReloadWatcher` is the rolling-reload half: it polls the
checkpoint root with the stat-only ``manifest.complete_manifests`` probe,
loads the params of a NEW complete manifest, and stages them into the
engine — which swaps between scheduler iterations, dropping no in-flight
request.
"""

import logging
import threading

import numpy as np
import torch

from horovod_tpu_torch import convert
from horovod_tpu_torch.ckpt import manifest as manifest_lib
from horovod_tpu_torch.ckpt import sharded as sharded_lib

logger = logging.getLogger("horovod_tpu_torch")


def abstract_params(model):
    """Shape-only params tree of ``model`` (the port's ``Transformer``):
    its flax tree of meta tensors (``convert.flax_shapes``) — the restore
    target :func:`load_params` slices a checkpoint against, no weight
    read or drawn."""
    return convert.flax_shapes(model)


def _np_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _assemble(root, step, targets, target_tree):
    man = manifest_lib.read_manifest(root, step)
    src_world = int(man["world"])
    shards = man.get("shards") or {}
    n = len(targets)
    # params are the tree PREFIX: leaf i lives in shard i % src_world —
    # only those shards are read (each CRC-checked against the manifest)
    needed = sorted({i % src_world for i in range(n)})
    payloads = {r: sharded_lib._read_shard(root, step, r, src_world,
                                           shards.get(str(r)))
                for r in needed}
    out = []
    for i, leaf in enumerate(targets):
        try:
            saved = payloads[i % src_world]["repl"][str(i)]
        except KeyError:
            raise ValueError(
                f"checkpoint step {step} has no replicated leaf {i} of "
                f"{n} — the params-prefix contract expects a TrainState "
                "checkpoint (ckpt/sharded.py) whose params tree matches "
                "the serving model") from None
        saved = np.asarray(saved)
        want = tuple(leaf.shape)
        if saved.shape != want:
            # msgpack round-trips 0-d arrays as shape (1,); any
            # same-size difference is a benign layout artifact
            if saved.size == int(np.prod(want, dtype=np.int64)):
                saved = saved.reshape(want)
            else:
                raise ValueError(
                    f"checkpoint params leaf {i} has shape {saved.shape}, "
                    f"the serving model expects {want} — wrong model "
                    "config for this checkpoint")
        dtype = _np_dtype(leaf.dtype)
        if saved.dtype != dtype:
            saved = saved.astype(dtype)
        out.append(saved)
    return sharded_lib.tree_unflatten(target_tree, out), \
        man.get("meta") or {}


def load_params(root, params_target, step=None):
    """Load ONLY the parameter tree of a sharded checkpoint.

    ``params_target`` is a shape/dtype tree (:func:`abstract_params`, or
    a live flax-layout tree). ``step=None`` picks the newest
    manifest-complete step, falling back past steps whose shards fail
    validation (the restore side's torn-write policy); an explicit
    ``step`` fails loudly. Returns ``(step, params, meta)``: the flax
    tree with numpy leaves cast to the target dtypes (same-dtype loads
    are bitwise)."""
    targets = sharded_lib.tree_flatten(params_target)
    if step is not None:
        if not manifest_lib.is_complete(root, step):
            raise FileNotFoundError(
                f"step {step} under {root} has no "
                f"{manifest_lib.MANIFEST_NAME} (incomplete/torn "
                "checkpoint)")
        params, meta = _assemble(root, step, targets, params_target)
        return step, params, meta
    steps = manifest_lib.list_complete_steps(root)
    if not steps:
        raise FileNotFoundError(
            f"no manifest-complete checkpoint under {root}")
    last_err = None
    for s in reversed(steps):
        try:
            params, meta = _assemble(root, s, targets, params_target)
            return s, params, meta
        except (OSError, sharded_lib.ShardValidationError) as e:
            logger.warning(
                "serve: ckpt step %d under %s is unloadable (%s) — "
                "falling back to the previous complete step", s, root, e)
            last_err = e
    raise ValueError(
        f"no loadable checkpoint under {root}: all {len(steps)} "
        "manifest-complete step(s) failed validation") from last_err


class ReloadWatcher:
    """Rolling weight reload: poll ``root`` for a newer complete
    manifest, load its params, stage them into the engine (or a fleet
    router: anything with ``install_weights``).

    Candidates are ranked by **manifest mtime**, not step number: recency
    by commit time survives backwards step numbering (a damaged
    highest-numbered step forces training's fallback restore, after
    which fresh commits carry LOWER step numbers with newer mtimes). The
    ``(step, mtime)`` key also catches a re-commit of the same step
    number. A probe whose shards fail validation is remembered (and
    dropped once its dir is GC'd) and not retried; the engine keeps
    serving the weights it has."""

    def __init__(self, root, engine, params_target, poll_s=2.0,
                 on_reload=None):
        self._root = root
        self._engine = engine
        self._target = params_target
        self._poll_s = float(poll_s)
        self._on_reload = on_reload
        self._seen = None    # (step, mtime) last installed
        self._bad = set()    # (step, mtime) probes that failed to load
        self._stop = threading.Event()
        self._thread = None

    def poll_once(self):
        """One probe+maybe-reload cycle; returns the newly installed
        step or None. Synchronous — the deterministic test surface."""
        probes = manifest_lib.complete_manifests(self._root)
        self._bad &= set(probes)  # GC'd/re-committed dirs drop out
        candidates = [p for p in probes if p not in self._bad]
        if not candidates:
            return None
        probe = max(candidates, key=lambda p: (p[1], p[0]))
        if probe == self._seen:
            return None
        step = probe[0]
        try:
            loaded_step, params, _ = load_params(self._root,
                                                 self._target, step=step)
        # a bad checkpoint is remembered and skipped; the current
        # weights keep serving
        except Exception as e:
            logger.warning(
                "serve: reload of ckpt step %d failed (%s) — keeping "
                "the current weights", step, e)
            self._bad.add(probe)
            return None
        self._engine.install_weights(params, version=loaded_step)
        self._seen = probe
        logger.info("serve: staged reloaded weights from ckpt step %d",
                    loaded_step)
        if self._on_reload is not None:
            self._on_reload(loaded_step)
        return loaded_step

    def mark_current(self, step):
        """Record the step already installed at startup so the first
        poll doesn't re-load it."""
        mt = manifest_lib.manifest_mtime(self._root, step)
        if mt is not None:
            self._seen = (step, mt)

    def _loop(self):
        while not self._stop.wait(self._poll_s):
            try:
                self.poll_once()
            # keep watching; serving must not die of a poll
            except Exception:
                logger.warning("serve: reload poll failed",
                               exc_info=True)

    def start(self):
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop,
                                            name="hvd_serve_reload",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
