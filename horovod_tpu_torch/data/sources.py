"""Batch sources: the supply side of the prefetch loader. The port of
``horovod_tpu/data/sources.py``.

A source is random-access storage for a dataset, addressed by global
example index:

* ``len(source)``: the example count;
* ``source.batch(indices)``: the examples at ``indices`` (a 1-d numpy
  int array) stacked into numpy arrays, a tuple (or a dict); called on
  the loader's producer thread;
* ``source.state()`` / ``source.set_state(d)``: source-specific cursor
  extras (JSON-able) that ride the loader's cursor; ``{}`` for the
  sources here, which are pure functions of their indices.

``ArraySource`` gathers rows of in-memory arrays; ``FileSource``
memory-maps ``.npy`` volumes on first touch. Both take ``delay_s``, a
simulated storage latency per ``batch()``.
"""

import os
import time

import numpy as np


class Source:
    """Protocol base: subclasses implement ``__len__`` and ``_gather``."""

    def __init__(self, delay_s=0.0):
        self.delay_s = float(delay_s)

    def batch(self, indices):
        """Assemble the examples at ``indices`` (producer-thread call)."""
        if self.delay_s > 0:
            time.sleep(self.delay_s)
        return self._gather(np.asarray(indices))

    def state(self):
        """Source-specific cursor extras (JSON-able). Pure sources: {}."""
        return {}

    def set_state(self, state):
        del state

    def _gather(self, indices):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class ArraySource(Source):
    """In-memory arrays (images, labels, ...) behind the source protocol.

    ``arrays`` is a sequence (or dict) of equal-leading-dim numpy
    arrays; ``batch`` stacks the requested rows into the same structure
    as a tuple (or dict) of numpy arrays.
    """

    def __init__(self, arrays, delay_s=0.0):
        super().__init__(delay_s=delay_s)
        if isinstance(arrays, dict):
            self._keys = tuple(sorted(arrays))
            items = [arrays[k] for k in self._keys]
        else:
            self._keys = None
            items = list(arrays)
        if not items:
            raise ValueError("ArraySource needs at least one array")
        self._arrays = [np.asarray(a) for a in items]
        n = len(self._arrays[0])
        for a in self._arrays:
            if len(a) != n:
                raise ValueError("all arrays must share their leading dim")
        self._n = n

    def __len__(self):
        return self._n

    def _gather(self, indices):
        rows = tuple(a[indices] for a in self._arrays)
        if self._keys is not None:
            return dict(zip(self._keys, rows))
        return rows


class FileSource(Source):
    """File-backed source over ``.npy`` volumes (one stacked array per
    file, possibly uneven lengths), memory-mapped on first touch.

    ``groups`` maps each field name to an ordered list of file paths;
    file ``k`` of every field must hold the same number of examples
    (the fields are parallel). Global example index ``i`` resolves to
    ``(file, row)`` through the cumulative lengths of the first field.

        FileSource({"images": ["a_img.npy", "b_img.npy"],
                    "labels": ["a_lbl.npy", "b_lbl.npy"]})

    A single flat list is shorthand for one anonymous field (batches
    come back as a 1-tuple). ``delay_s`` adds a synthetic per-batch
    storage latency on top of the real I/O.
    """

    def __init__(self, groups, delay_s=0.0):
        super().__init__(delay_s=delay_s)
        if not isinstance(groups, dict):
            groups = {None: list(groups)}
        if not groups or any(not paths for paths in groups.values()):
            raise ValueError("FileSource needs at least one file per field")
        nfiles = {len(paths) for paths in groups.values()}
        if len(nfiles) != 1:
            raise ValueError("every field needs the same number of files "
                             f"(got {sorted(nfiles)})")
        self._fields = sorted(groups, key=lambda k: (k is None, k))
        self._paths = {f: [os.fspath(p) for p in groups[f]]
                       for f in self._fields}
        self._mmaps = {f: [None] * len(groups[f]) for f in self._fields}
        first = self._fields[0]
        lengths = [self._file_len(first, k)
                   for k in range(len(self._paths[first]))]
        for field in self._fields[1:]:
            # file k of EVERY field must hold the same examples — a
            # mismatched split would silently pair rows of one field
            # with the wrong rows of another for the whole run
            other = [self._file_len(field, k)
                     for k in range(len(self._paths[field]))]
            if other != lengths:
                raise ValueError(
                    f"field {field!r} file lengths {other} do not match "
                    f"field {self._fields[0]!r} lengths {lengths}: "
                    "parallel fields must be split identically")
        self._starts = np.concatenate([[0], np.cumsum(lengths)])
        self._n = int(self._starts[-1])

    def _file_len(self, field, k):
        # mmap'ing reads the header only; rows fault in at first gather
        return int(self._mmap(field, k).shape[0])

    def _mmap(self, field, k):
        m = self._mmaps[field][k]
        if m is None:
            m = np.load(self._paths[field][k], mmap_mode="r")
            self._mmaps[field][k] = m
        return m

    def __len__(self):
        return self._n

    def _gather(self, indices):
        files = np.searchsorted(self._starts, indices, side="right") - 1
        rows = indices - self._starts[files]
        out = []
        for field in self._fields:
            # gather per touched file, scattered back into request order
            got = None
            for k in np.unique(files):
                sel = files == k
                chunk = np.asarray(self._mmap(field, int(k))[rows[sel]])
                if got is None:
                    got = np.empty((len(indices),) + chunk.shape[1:],
                                   chunk.dtype)
                got[sel] = chunk
            out.append(got)
        if self._fields == [None]:
            return (out[0],)
        return dict(zip(self._fields, out))
