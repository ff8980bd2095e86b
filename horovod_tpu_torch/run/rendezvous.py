"""The client of the launcher's HTTP key-value store: the port of
``kv_get``, ``kv_put`` and ``kv_wait`` of ``horovod_tpu/run/rendezvous.py``
(the store itself is the launcher's). A key is the path ``/<key>``; GET
of a missing key answers 404, so a client polls. With the run's secret
key every request is signed (``run/secret.py``)."""

import time
import urllib.error
import urllib.request

from horovod_tpu_torch.run import secret

AUTH_HEADER = "X-HVD-Auth"


def _headers(auth_key, method, key, body=b""):
    if auth_key is None:
        return {}
    return {AUTH_HEADER: secret.sign(auth_key, method, "/" + key, body)}


def kv_get(addr, port, key, timeout=5.0, auth_key=None):
    """The value of ``key``, or None while it is not set."""
    if auth_key is None:
        auth_key = secret.key_from_env()
    req = urllib.request.Request(f"http://{addr}:{port}/{key}",
                                 headers=_headers(auth_key, "GET", key))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.read()
    except urllib.error.HTTPError as e:
        if e.code == 404:
            return None
        raise


def kv_put(addr, port, key, value, auth_key=None):
    if auth_key is None:
        auth_key = secret.key_from_env()
    req = urllib.request.Request(
        f"http://{addr}:{port}/{key}", data=value, method="PUT",
        headers=_headers(auth_key, "PUT", key, value))
    urllib.request.urlopen(req, timeout=5.0).read()


def kv_wait(addr, port, key, timeout=60.0, poll=0.1, auth_key=None):
    """Poll ``key`` until it is set; its value."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = kv_get(addr, port, key, auth_key=auth_key)
        if v is not None:
            return v
        time.sleep(poll)
    raise TimeoutError(f"key {key} not published within {timeout}s")
