"""Per-rank input sharding: the port of ``horovod_tpu/data/sharding.py``.

* ``shard_indices``: a deterministic per-epoch shuffle (numpy's
  ``default_rng((seed, epoch))``, the JAX package's), padded or trimmed
  to a multiple of the world and split strided, so every rank of either
  package gets the same indices;
* ``DistributedSampler``: the torch sampler protocol over it;
* ``shard_dataset``: a dataset's own ``shard(num_shards, index)``;
* ``local_batches``: this rank's batches of numpy arrays.

Rank and size default to the initialized ``horovod_tpu_torch`` world.
"""

import numpy as np


def _world(num_shards, shard_id):
    if num_shards is None or shard_id is None:
        from horovod_tpu_torch import basics
        if basics.is_initialized():
            num_shards = basics.size() if num_shards is None else num_shards
            shard_id = basics.rank() if shard_id is None else shard_id
        else:
            num_shards = 1 if num_shards is None else num_shards
            if shard_id is None:
                if num_shards != 1:
                    # silently defaulting to shard 0 would hand EVERY
                    # process the same 1/N of the data with no error
                    raise ValueError(
                        f"num_shards={num_shards} but no shard_id and "
                        "horovod_tpu_torch is not initialized; pass "
                        "shard_id explicitly (or call hvd.init() so rank() "
                        "supplies it)")
                shard_id = 0
    if not 0 <= shard_id < num_shards:
        raise ValueError(f"shard_id {shard_id} not in [0, {num_shards})")
    return num_shards, shard_id


def shard_indices(n, num_shards=None, shard_id=None, *, epoch=0,
                  shuffle=True, seed=0, drop_last=False):
    """This shard's dataset indices for ``epoch``.

    Semantics of ``torch.utils.data.distributed.DistributedSampler``
    (the reference's input sharder): the order is a deterministic
    function of ``(seed, epoch)`` and identical on every rank; with
    ``drop_last=False`` the order is wrapped to the next multiple of
    ``num_shards`` so all shards get the same count and every example
    appears at least once per epoch; with ``drop_last=True`` the tail is
    trimmed instead. Shards take strided slices — pairwise disjoint by
    construction.
    """
    num_shards, shard_id = _world(num_shards, shard_id)
    if shuffle:
        order = np.random.default_rng((seed, epoch)).permutation(n)
    else:
        order = np.arange(n)
    if drop_last:
        order = order[:n - n % num_shards]
    elif n % num_shards:
        order = np.concatenate([order, order[:num_shards - n % num_shards]])
    return order[shard_id::num_shards]


class DistributedSampler:
    """Torch-sampler-protocol wrapper over ``shard_indices``.

    ``dataset`` may be a length (int) or anything with ``__len__``. Use
    as ``DataLoader(ds, sampler=DistributedSampler(ds))`` and call
    ``set_epoch(e)`` at each epoch start (same contract as torch's:
    forgetting it reuses epoch-0's shuffle order every epoch).
    """

    def __init__(self, dataset, num_replicas=None, rank=None, *,
                 shuffle=True, seed=0, drop_last=False):
        self._n = dataset if isinstance(dataset, int) else len(dataset)
        self.num_replicas, self.rank = _world(num_replicas, rank)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = int(epoch)

    def __iter__(self):
        return iter(shard_indices(
            self._n, self.num_replicas, self.rank, epoch=self.epoch,
            shuffle=self.shuffle, seed=self.seed,
            drop_last=self.drop_last).tolist())

    def __len__(self):
        if self.drop_last:
            return self._n // self.num_replicas
        return -(-self._n // self.num_replicas)


def shard_dataset(dataset, num_shards=None, shard_id=None):
    """Per-rank shard of a ``tf.data.Dataset`` / grain dataset — anything
    exposing ``shard(num_shards, index)`` (the reference pattern for TF
    input pipelines: shard FIRST, then shuffle/augment per rank)."""
    num_shards, shard_id = _world(num_shards, shard_id)
    return dataset.shard(num_shards, shard_id)


def local_batches(arrays, batch_size, num_shards=None, shard_id=None, *,
                  epoch=0, shuffle=True, seed=0, drop_last=True):
    """Yield this rank's batches as tuples of numpy views.

    ``arrays`` is a sequence of equal-length arrays (images, labels, ...).
    Batch boundaries fall inside the rank's shard, so ranks never see
    overlapping examples; ``drop_last=True`` (default) keeps every step's
    batch full — the SPMD-friendly choice (static shapes).

    ``drop_last`` governs BOTH trims, consistently: the cross-shard tail
    (``shard_indices`` would otherwise wrap-pad the shard, handing this
    rank duplicated examples within one epoch) and the ragged final
    batch. With ``drop_last=True`` an example therefore appears AT MOST
    once per rank per epoch; with ``drop_last=False`` the wrap padding
    keeps every example covered at the cost of a few duplicates near the
    epoch tail (DistributedSampler semantics)."""
    arrays = [np.asarray(a) for a in arrays]
    n = len(arrays[0])
    for a in arrays:
        if len(a) != n:
            raise ValueError("all arrays must share their leading dim")
    idx = shard_indices(n, num_shards, shard_id, epoch=epoch,
                        shuffle=shuffle, seed=seed, drop_last=drop_last)
    end = len(idx) - len(idx) % batch_size if drop_last else len(idx)
    for i in range(0, end, batch_size):
        b = idx[i:i + batch_size]
        yield tuple(a[b] for a in arrays)
