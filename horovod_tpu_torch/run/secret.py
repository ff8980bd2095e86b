"""Per-run secret keys and HMAC request signing: the port of
``horovod_tpu/run/secret.py``. Requests to the run's HTTP key-value store
carry an ``X-HVD-Auth`` header, the hex HMAC-SHA256 over ``method \\n
path \\n body`` under the run's key, which travels to the workers
hex-encoded in ``HOROVOD_SECRET_KEY``."""

import hashlib
import hmac
import os

SECRET_ENV = "HOROVOD_SECRET_KEY"


def key_from_env(env=None):
    """The run's key from the environment, or None when the run is
    unauthenticated (single-host loopback jobs)."""
    val = (env or os.environ).get(SECRET_ENV)
    return bytes.fromhex(val) if val else None


def sign(key, method, path, body=b""):
    """Hex HMAC-SHA256 over the request triple."""
    msg = method.encode() + b"\n" + path.encode() + b"\n" + body
    return hmac.new(key, msg, hashlib.sha256).hexdigest()
