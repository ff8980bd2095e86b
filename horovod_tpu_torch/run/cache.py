"""The launcher's pre-flight cache: the port of
``horovod_tpu/run/cache.py``. A multi-host launch would probe NIC
reachability every time, though the answer changes only with the
cluster; it is kept for 60 minutes under ``~/.horovod_tpu``
(``--disable-cache`` skips it) as JSON, never as a pickle, so nothing
executable is read from a shared home directory. The file and its keys
are the JAX package's, so either launcher reads the other's answers.
"""

import json
import os
import tempfile
import time

DEFAULT_DIR = os.path.expanduser("~/.horovod_tpu")
DEFAULT_TTL = 60 * 60


class Cache:
    """A small persistent ``{key: (timestamp, value)}`` store. A corrupt
    or unreadable file reads as empty: a cache must never fail a
    launch."""

    def __init__(self, folder=DEFAULT_DIR, ttl=DEFAULT_TTL):
        self._path = os.path.join(folder, "cache.json")
        self._ttl = ttl

    def _load(self):
        try:
            with open(self._path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def get(self, key):
        """The cached value of ``key``, or None when absent or expired."""
        entry = self._load().get(key)
        if not entry:
            return None
        ts, value = entry
        if time.time() - ts > self._ttl:
            return None
        return value

    def put(self, key, value):
        data = self._load()
        data[key] = (time.time(), value)
        try:
            os.makedirs(os.path.dirname(self._path), exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(self._path))
            with os.fdopen(fd, "w") as f:
                json.dump(data, f)
            os.replace(tmp, self._path)
        except OSError:
            pass  # caching is best-effort
