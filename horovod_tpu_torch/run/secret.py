"""Per-run secret keys and HMAC request signing: the port of
``horovod_tpu/run/secret.py``. Requests to the run's HTTP key-value store
carry an ``X-HVD-Auth`` header, the hex HMAC-SHA256 over ``method \\n
path \\n body`` under the run's key, which travels to the workers
hex-encoded in ``HOROVOD_SECRET_KEY``. The bytes signed are the JAX
package's, so a client of either package talks to a server of either.

Signatures carry no nonce or timestamp: an on-path observer can replay a
captured request for the run's lifetime, as with the reference's framed
digests. Keys are per run and the store holds idempotent puts and gets.
"""

import hashlib
import hmac
import os

SECRET_LENGTH = 32  # bytes
SECRET_ENV = "HOROVOD_SECRET_KEY"


def make_secret_key():
    """A fresh per-run key."""
    return os.urandom(SECRET_LENGTH)


def encode_key(key):
    return key.hex()


def decode_key(text):
    return bytes.fromhex(text)


def key_from_env(env=None):
    """The run's key from the environment, or None when the run is
    unauthenticated (single-host loopback jobs)."""
    val = (env or os.environ).get(SECRET_ENV)
    return decode_key(val) if val else None


def sign(key, method, path, body=b""):
    """Hex HMAC-SHA256 over the request triple."""
    msg = method.encode() + b"\n" + path.encode() + b"\n" + body
    return hmac.new(key, msg, hashlib.sha256).hexdigest()


def verify(key, method, path, body, digest_hex):
    """Constant-time check of a request's digest. Compares bytes:
    ``compare_digest`` raises on non-ASCII ``str``, which a hostile header
    could otherwise use to end the handler's thread."""
    if not digest_hex:
        return False
    expected = sign(key, method, path, body)
    return hmac.compare_digest(expected.encode(), digest_hex.encode())
