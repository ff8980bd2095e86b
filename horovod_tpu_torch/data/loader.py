"""The prefetch loader: double-buffered, cursor-addressable input. The
port of ``horovod_tpu/data/loader.py``.

``PrefetchLoader`` runs a background producer thread that assembles this
rank's next batches from a source (``sources.py``) and stages them on
the device (the placement that ``training.make_train_step(loader=...)``
installs: ``device_placement``) while the current step runs. The
training thread pulls from a bounded queue of ``depth`` batches.

**Determinism.** Which indices make up batch ``b`` is a pure function of
the cursor ``(seed, epoch, offset, batch_index)`` and the membership
``(rank, world)``: the ``(seed, epoch)`` permutation of
``sharding.shard_indices``, strided across ranks, the same numpy draws
as the JAX package's. ``cursor()`` names the next batch the training
thread will receive, and a loader set to that cursor replays the same
remaining stream, in either package.

**Elastic resharding.** ``on_reset(new_world)`` retires what this
membership consumed into ``offset`` and re-strides the rest of the
epoch across the new world; ``set_cursor`` with a cursor of another
world does the same.

**Placement on the card.** ``device_placement(device)`` copies each
batch, on the producer thread, into pinned host memory and from there
``non_blocking`` onto the device on the loader's own CUDA stream, and
records an event; ``ready(batch)`` makes the consuming stream wait for
that event before the step reads the batch.

The JAX package's telemetry instruments, goodput ledger and
flight-recorder events of the loader are not ported (they come with the
telemetry plane): ``PrefetchLoader(telemetry=...)`` raises
``NotImplementedError``.
"""

import logging
import queue
import threading

import numpy as np
import torch

from horovod_tpu_torch.data import sharding

logger = logging.getLogger("horovod_tpu_torch")

CURSOR_VERSION = 1
# queue poll granularity of the consumer and of a producer's bounded put
_GET_POLL_S = 0.05


def epoch_order(n, *, seed=0, epoch=0, shuffle=True):
    """The epoch's global example order — identical on every rank (the
    ``shard_indices`` permutation, pre-sharding)."""
    if shuffle:
        return np.random.default_rng((seed, epoch)).permutation(n)
    return np.arange(n)


def segment(n, *, seed=0, epoch=0, offset=0, world=1, batch_size=1,
            shuffle=True, drop_last=False):
    """The remaining sample space of ``epoch`` past ``offset``, shaped
    for ``world`` ranks taking ``batch_size`` examples per step: sized
    to a multiple of one GLOBAL batch (``world * batch_size``) — trimmed
    when ``drop_last``, wrap-padded otherwise, so with
    ``drop_last=False`` no example is ever dropped (the tail global
    batch repeats a few head examples instead — DistributedSampler's
    padding trade-off at batch granularity, which is what static SPMD
    shapes require). Rank ``r`` owns ``segment[r::world]`` — the
    strided split keeps consumption lockstep-interleaved, so "the first
    k global batches" is always a prefix of this array."""
    order = epoch_order(n, seed=seed, epoch=epoch, shuffle=shuffle)
    seg = order[int(offset):]
    if len(seg) == 0:
        return seg
    chunk = world * batch_size
    rem = len(seg) % chunk
    if drop_last:
        seg = seg[:len(seg) - rem] if rem else seg
    elif rem:
        seg = np.concatenate([seg, np.resize(seg, chunk - rem)])
    return seg


class PrefetchLoader:
    """Background-prefetching, cursor-addressable batch iterator.

    Parameters
    ----------
    source : a ``sources.py`` source (``len`` +
        ``batch(indices)``).
    batch_size : this RANK's per-step batch (for the compiled SPMD step
        that is the per-process share of the global batch).
    depth : bounded prefetch queue size, >= 2 for real double buffering
        (1 still overlaps a single batch).
    rank, world : membership; default to the initialized horovod_tpu_torch
        world exactly like ``shard_indices``.
    seed, shuffle, drop_last : stream identity knobs (``shard_indices``
        semantics; ``drop_last`` applies at the cross-rank tail AND the
        ragged final batch).
    epochs : stop after this many epochs (None = run forever).
    placement : optional callable run on the PRODUCER thread to stage
        the assembled numpy batch onto the device;
        ``training.make_train_step(loader=...)`` installs
        ``device_placement`` here, so the host-to-device copy overlaps
        the step too.
    telemetry : the JAX package's ``hvd_data_*`` instruments, not
        ported: anything but None raises ``NotImplementedError``.
    """

    def __init__(self, source, batch_size, *, depth=2, rank=None,
                 world=None, seed=0, shuffle=True, drop_last=True,
                 epochs=None, placement=None, telemetry=None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._source = source
        self._batch_size = int(batch_size)
        self._depth = int(depth)
        self._world, self._rank = sharding._world(world, rank)
        self._seed = int(seed)
        self._shuffle = bool(shuffle)
        self._drop_last = bool(drop_last)
        self._epochs = None if epochs is None else int(epochs)
        self._placement = placement
        self.placement_spec = None
        self._epoch = 0
        self._offset = 0
        self._batch_index = 0
        self._lock = threading.Lock()
        # serializes whole halts (detach + join): see _halt_producer
        self._halt_lock = threading.Lock()
        self._queue = None
        self._thread = None
        self._stop = None
        self._gen = 0
        self._closed = False
        self._exhausted = False
        if telemetry is not None:
            raise NotImplementedError(
                "PrefetchLoader(telemetry=...): the data plane's telemetry "
                "comes with the port's telemetry plane (ROADMAP Queue 1 "
                "item 5)")

    # -- stream identity ----------------------------------------------------
    @property
    def batch_size(self):
        return self._batch_size

    @property
    def rank(self):
        return self._rank

    @property
    def world(self):
        return self._world

    def batches_remaining_in_epoch(self):
        """Full batches this rank has left in the current epoch."""
        seg = segment(len(self._source), seed=self._seed,
                      epoch=self._epoch, offset=self._offset,
                      world=self._world, batch_size=self._batch_size,
                      shuffle=self._shuffle, drop_last=self._drop_last)
        nb = (len(seg) // self._world) // self._batch_size
        return max(nb - self._batch_index, 0)

    def _plan(self, epoch, offset, batch_index):
        """Yield ``(indices, cursor_after)`` from the given cursor on.
        Pure function of (cursor, membership) — the determinism anchor
        for prefetch, resume and resharding alike."""
        e, o, b = int(epoch), int(offset), int(batch_index)
        n = len(self._source)
        B, w = self._batch_size, self._world
        while self._epochs is None or e < self._epochs:
            seg = segment(n, seed=self._seed, epoch=e, offset=o,
                          world=w, batch_size=B, shuffle=self._shuffle,
                          drop_last=self._drop_last)
            mine = seg[self._rank::w]
            nb = len(mine) // B
            if nb == 0 and o == 0:
                raise ValueError(
                    f"dataset of {n} examples yields zero full batches "
                    f"for world={w} x batch_size={B}")
            while b < nb:
                idx = mine[b * B:(b + 1) * B]
                b += 1
                after = (e, o, b) if b < nb else (e + 1, 0, 0)
                yield idx, after
            e, o, b = e + 1, 0, 0

    # -- the producer -------------------------------------------------------
    def _produce(self, gen, q, stop, start):
        place = self._placement
        try:
            for idx, after in self._plan(*start):
                if stop.is_set():
                    return
                batch = self._source.batch(idx)
                if place is not None:
                    batch = place(batch)
                if not _put(q, (gen, "batch", batch, after), stop):
                    return
                start = after
            _put(q, (gen, "end", None, None), stop)
        except BaseException as e:  # noqa: BLE001 - raised on the consumer
            _put(q, (gen, "error", e, None), stop)

    def _ensure_producer(self):
        # steady path: a live producer needs no halt coordination —
        # the consumer checks under self._lock alone and stays out of
        # any in-flight halt's way
        if self._closed:
            raise RuntimeError("PrefetchLoader is closed")
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
        # (re)start path: serialize with halts — a consumer must not
        # spawn a NEW producer while a halt is still joining the old
        # one (two threads concurrently inside source.batch(), or a
        # producer born after close() detached the stream). Same
        # _halt_lock → _lock order as _halt_producer, so no cycle.
        with self._halt_lock:
            self._ensure_producer_locked()

    def _ensure_producer_locked(self):
        if self._closed:
            raise RuntimeError("PrefetchLoader is closed")
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            if self._thread is not None and self._queue is not None \
                    and not self._queue.empty():
                # the producer ran its plan to completion and exited;
                # its queue still holds staged batches (+ the end
                # marker) — restarting now would throw them away and
                # re-stage them. Drain first; the end/error item halts
                # and clears the thread, and only then may we restart.
                return
            if self._thread is not None or self._queue is None:
                # fresh generation: a dead/halted producer's queue may
                # hold stale batches from a pre-set_cursor stream
                self._gen += 1
                self._queue = queue.Queue(maxsize=self._depth)
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._produce,
                args=(self._gen, self._queue, self._stop,
                      (self._epoch, self._offset, self._batch_index)),
                daemon=True, name=f"hvd_data_prefetch_r{self._rank}")
            self._thread.start()

    def _halt_producer(self):
        # detach under self._lock, JOIN OUTSIDE it:
        # a producer parked in a slow storage read
        # (FileSource delay_s simulates exactly this) used to hold
        # every other loader entry point — including the elastic reset
        # path, whose recovery time is otherwise carefully bounded —
        # hostage for the whole read. The queue is generation-keyed, so
        # __next__ ignores anything the detached producer still emits.
        #
        # _halt_lock serializes WHOLE halts (and producer (re)starts):
        # every _halt_producer caller mutates cursor/source state right
        # after it returns (set_cursor, on_reset, close), so a second
        # halter must park here until the previous halt's producer has
        # really died — not skip ahead on seeing _thread already None
        # and call source.set_state() under a zombie's in-flight
        # batch() read. Consumers on the steady path (live producer)
        # only take self._lock and stay unblocked; a consumer that
        # needs a (re)start parks behind the halt by design.
        with self._halt_lock:
            with self._lock:
                t, q, stop = self._thread, self._queue, self._stop
                self._thread = None
                self._queue = None
                self._gen += 1
                if t is None:
                    return
                stop.set()
            while t.is_alive():
                try:  # unblock a producer parked in q.put
                    q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.05)

    # -- the consumer -------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise RuntimeError("PrefetchLoader is closed")
        if self._exhausted:
            # don't spin up a producer just to re-emit the end marker;
            # set_cursor / on_reset clear this and re-arm the stream
            raise StopIteration
        self._ensure_producer()
        q, gen = self._queue, self._gen
        while True:
            try:
                item = q.get(timeout=_GET_POLL_S)
            except queue.Empty:
                t = self._thread
                if (t is None or not t.is_alive()) and q.empty():
                    raise RuntimeError(
                        "prefetch producer thread died without a "
                        "result — see the rank log for its traceback")
                continue
            g, kind, payload, after = item
            if g != gen:
                continue  # stale generation raced the restart
            break
        if kind == "error":
            self._halt_producer()
            raise payload
        if kind == "end":
            self._exhausted = True
            self._halt_producer()
            raise StopIteration
        self._epoch, self._offset, self._batch_index = after
        return payload

    # -- cursor / checkpoint ------------------------------------------------
    def cursor(self):
        """The (JSON-able) position of the NEXT batch the training
        thread will receive — prefetched-but-undelivered batches are
        deliberately not counted, so a restore never skips them."""
        return {
            "version": CURSOR_VERSION,
            "seed": self._seed,
            "shuffle": self._shuffle,
            "drop_last": self._drop_last,
            "batch_size": self._batch_size,
            "world": self._world,
            "epoch": self._epoch,
            "offset": self._offset,
            "batch_index": self._batch_index,
            "source": self._source.state(),
        }

    def set_cursor(self, cur):
        """Reposition the stream to ``cur`` (from :meth:`cursor`, the
        checkpoint manifest, or a peer's elastic sync). Stream-identity
        knobs (batch size, shuffle, drop_last, seed) are adopted from
        the cursor — they define WHICH stream the position is in.

        The cursor records the membership its ``batch_index`` counted
        against: restoring it into a loader with a DIFFERENT world
        (elastic N→M restore) automatically retires the old
        membership's consumption into ``offset`` and re-strides the
        remaining epoch across this loader's world — the same
        arithmetic as :meth:`on_reset`."""
        if cur is None:
            return
        v = cur.get("version", CURSOR_VERSION)
        if v != CURSOR_VERSION:
            raise ValueError(f"unknown data cursor version {v}")
        if int(cur.get("batch_size", self._batch_size)) \
                != self._batch_size:
            raise ValueError(
                f"cursor batch_size {cur['batch_size']} != loader "
                f"batch_size {self._batch_size}: the cursor names a "
                "position in a different batch stream")
        self._halt_producer()
        self._seed = int(cur.get("seed", self._seed))
        self._shuffle = bool(cur.get("shuffle", self._shuffle))
        self._drop_last = bool(cur.get("drop_last", self._drop_last))
        self._epoch = int(cur.get("epoch", 0))
        self._offset = int(cur.get("offset", 0))
        self._batch_index = int(cur.get("batch_index", 0))
        cur_world = int(cur.get("world", self._world))
        if cur_world != self._world:
            consumed = self._batch_index * self._batch_size * cur_world
            self._offset = min(self._offset + consumed,
                               len(self._source))
            self._batch_index = 0
        self._exhausted = False
        try:
            self._source.set_state(cur.get("source") or {})
        except Exception:
            logger.warning("data: source rejected its cursor state",
                           exc_info=True)

    # -- elastic ------------------------------------------------------------
    def on_reset(self, new_world=None, new_rank=None):
        """Re-shard the REMAINING sample space over a new membership
        (elastic N→M). Everything this membership consumed is retired
        into ``offset``; the epoch tail re-strides across the new world
        so no remaining example is dropped or revisited. Defaults to
        re-reading rank/world from the (re)initialized horovod_tpu_torch
        world, which is what the elastic reset path wants."""
        self._halt_producer()
        consumed = self._batch_index * self._batch_size * self._world
        self._offset = min(self._offset + consumed, len(self._source))
        self._batch_index = 0
        self._world, self._rank = sharding._world(new_world, new_rank)
        self._exhausted = False

    # -- placement ----------------------------------------------------------
    def attach_placement(self, placement, spec=None):
        """Install (or replace) the producer-side staging function.
        ``training.make_train_step(loader=...)`` calls this with
        ``device_placement`` of its device, so batches land on the card.
        ``spec`` names what the staging targets (the device), exposed as
        ``placement_spec``. Replacing the placement restarts the
        producer from the consumer cursor: batches already queued were
        staged the old way and are discarded, never delivered."""
        if placement is self._placement:
            # no-op re-attach: keep the recorded spec unless the caller
            # supplied a fresh one (a default None must not clobber it)
            if spec is not None:
                self.placement_spec = spec
            return
        self._halt_producer()
        self._placement = placement
        self.placement_spec = spec

    def close(self):
        # closed BEFORE the halt: a consumer parked behind the halt in
        # _ensure_producer must observe the close when it resumes, not
        # spawn a post-close producer (leaked thread doing I/O)
        self._closed = True
        self._halt_producer()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _put(q, item, stop):
    """Bounded put that stays responsive to a halt: returns False when
    the producer should exit instead of blocking forever on a full
    queue nobody will drain."""
    while not stop.is_set():
        try:
            q.put(item, timeout=_GET_POLL_S)
            return True
        except queue.Full:
            continue
    return False


def _map(batch, fn):
    if isinstance(batch, dict):
        return {k: _map(v, fn) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map(v, fn) for v in batch)
    return fn(batch)


class Staged(tuple):
    """A batch staged on the card: its tensors (a tuple, as the source's
    batch) and the event recorded on the loader's stream after their
    copies. ``ready`` waits for it."""

    event = None


def device_placement(device):
    """The producer-thread staging onto ``device``: each numpy leaf of a
    batch becomes a tensor there. On the card, through a pinned host
    copy and a ``non_blocking`` copy on the loader's own CUDA stream,
    followed by an event (a ``Staged`` batch); on the CPU, a tensor over
    the numpy array. ``ready`` hands the tensors to the step."""
    device = torch.device(device)
    if device.type != "cuda":
        return lambda batch: _map(batch, lambda x: torch.as_tensor(
            np.asarray(x)))
    stream = torch.cuda.Stream(device)

    def place(batch):
        with torch.cuda.device(device), torch.cuda.stream(stream):
            out = _map(batch, lambda x: torch.from_numpy(
                np.ascontiguousarray(x)).pin_memory().to(
                    device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(stream)
        if not isinstance(out, tuple):
            out = (out,)
        staged = Staged(out)
        staged.event = event
        return staged

    return place


def ready(batch):
    """A batch from the loader, safe to read on the current stream: a
    ``Staged`` batch makes the current stream wait for its copies, and
    its tensors are marked as used there (the allocator then keeps their
    memory until this stream is done with them)."""
    if not isinstance(batch, Staged):
        return batch
    current = torch.cuda.current_stream()
    current.wait_event(batch.event)

    def mark(t):
        t.record_stream(current)
        return t

    return tuple(_map(tuple(batch), mark))
