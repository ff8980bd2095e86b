"""The launcher's HTTP key-value store and its client: the port of
``horovod_tpu/run/rendezvous.py``.

An in-memory store over HTTP GET/PUT/DELETE, a key being the path
``/<key>``. GET of a missing key answers 404, so a client polls. The
launcher ships pickled functions and collects results through it, and a
multi-process ``init()`` finds its TCP store there. With the run's secret
key every request must carry a valid ``X-HVD-Auth`` header (``secret.py``)
or it is refused with 403; the store carries pickles, so a job that
spans hosts always has a key. The paths, methods, status codes and
header are the JAX package's, byte for byte.
"""

import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from horovod_tpu_torch.run import secret

AUTH_HEADER = "X-HVD-Auth"


class _Handler(BaseHTTPRequestHandler):
    store = None  # class attributes set per server
    lock = None
    auth_key = None

    # Legitimate payloads (pickled functions, addresses, results) stay far
    # below this. The signature covers the body, so it is read before it
    # is verified: the cap and the header's shape bound what a garbage
    # request makes the server buffer.
    MAX_BODY = 64 << 20

    def log_message(self, *args):
        pass

    def _key(self):
        return self.path.lstrip("/")

    def _authorized(self, body=b""):
        if self.auth_key is None:
            return True
        return secret.verify(self.auth_key, self.command, self.path, body,
                             self.headers.get(AUTH_HEADER))

    def _reject(self):
        self.send_response(403)
        self.end_headers()

    def _header_plausible(self):
        sig = self.headers.get(AUTH_HEADER, "")
        return len(sig) == 64 and all(c in "0123456789abcdef" for c in sig)

    def do_GET(self):
        if not self._authorized():
            return self._reject()
        with self.lock:
            val = self.store.get(self._key())
        if val is None:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(val)))
        self.end_headers()
        self.wfile.write(val)

    def do_PUT(self):
        length = int(self.headers.get("Content-Length", 0))
        if length > self.MAX_BODY or (
                self.auth_key is not None and not self._header_plausible()):
            return self._reject()
        body = self.rfile.read(length)
        if not self._authorized(body):
            return self._reject()
        with self.lock:
            self.store[self._key()] = body
        self.send_response(200)
        self.end_headers()

    def do_DELETE(self):
        if not self._authorized():
            return self._reject()
        with self.lock:
            self.store.pop(self._key(), None)
        self.send_response(200)
        self.end_headers()


class KVStoreServer:
    """Threaded HTTP key-value server; ``port=0`` binds an ephemeral port.
    It binds loopback unless told otherwise: pass ``host="0.0.0.0"`` only
    when the job spans hosts, and then with ``auth_key``."""

    def __init__(self, port=0, host="127.0.0.1", auth_key=None):
        handler = type("Handler", (_Handler,),
                       {"store": {}, "lock": threading.Lock(),
                        "auth_key": auth_key})
        self._handler_cls = handler
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._thread = None

    @property
    def port(self):
        return self._httpd.server_address[1]

    def start(self):
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join()

    # direct access for the launcher's own process
    def get(self, key):
        with self._handler_cls.lock:
            return self._handler_cls.store.get(key)

    def put(self, key, value):
        with self._handler_cls.lock:
            self._handler_cls.store[key] = value

    def delete(self, key):
        with self._handler_cls.lock:
            self._handler_cls.store.pop(key, None)


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
