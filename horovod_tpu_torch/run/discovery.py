"""NIC discovery and the election of the interfaces routable between
hosts: the port of ``horovod_tpu/run/discovery.py``, the same protocol
over the same keys, so the tasks and driver of either package interoperate.

A host may have several interfaces and not all are mutually routable
(NAT, docker bridges, fabrics of one kind only). Each task registers its
``{interface: [(ip, port)]}`` map in the launcher's signed key-value
store under ``disc/``, pings the next task of the ring through a small
HMAC-framed TCP ``PingServer`` (JSON payloads, never pickles) that
reports the source address it saw, and the driver intersects the
interfaces that answered on every link and publishes the common set,
which the launcher puts into the workers' ``HOROVOD_COMMON_INTERFACES``.
Every message is signed with the run's key; a frame with a bad digest is
dropped.
"""

import fcntl
import hashlib
import hmac
import json
import socket
import socketserver
import struct
import threading
import time

from horovod_tpu_torch.run.rendezvous import kv_get, kv_put, kv_wait

SIOCGIFADDR = 0x8915


def local_interfaces(port=0, nic=None):
    """``{interface: [(ip, port)]}`` for every AF_INET interface on this
    host (reference ``network.py:127-141`` ``_get_local_addresses``), from
    ioctls, with no dependency on psutil."""
    result = {}
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for _idx, name in socket.if_nameindex():
            if nic and name != nic:
                continue
            try:
                packed = fcntl.ioctl(
                    s.fileno(), SIOCGIFADDR,
                    struct.pack("256s", name.encode()[:255]))
            except OSError:
                continue  # interface has no IPv4 address
            ip = socket.inet_ntoa(packed[20:24])
            result.setdefault(name, []).append((ip, port))
    finally:
        s.close()
    if not result and nic:
        raise RuntimeError(
            f"no usable IPv4 address on requested interface {nic!r}")
    return result


def host_hash(salt=None):
    """Stable identifier for 'same physical host' used to group ranks for
    shared-memory locality (reference ``util/host_hash.py``). Salt lets
    tests simulate distinct hosts on one machine."""
    base = socket.gethostname()
    if salt:
        base = f"{base}-{salt}"
    return hashlib.md5(base.encode()).hexdigest()


# ---------------------------------------------------------------------------
# HMAC-framed JSON ping protocol (digest || u32 len || json)
# ---------------------------------------------------------------------------

_DIGEST_LEN = 32


def _send_frame(sock, key, obj):
    body = json.dumps(obj).encode()
    digest = hmac.new(key, body, hashlib.sha256).digest()
    sock.sendall(digest + struct.pack("<I", len(body)) + body)


def _recv_frame(sock, key):
    header = _recv_exact(sock, _DIGEST_LEN + 4)
    if header is None:
        return None
    digest, (length,) = header[:_DIGEST_LEN], struct.unpack(
        "<I", header[_DIGEST_LEN:])
    if length > 1 << 20:
        return None
    body = _recv_exact(sock, length)
    if body is None:
        return None
    if not hmac.compare_digest(
            hmac.new(key, body, hashlib.sha256).digest(), digest):
        return None
    return json.loads(body)


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


# Public names for the signed frame protocol.
send_frame = _send_frame
recv_frame = _recv_frame


class PingServer:
    """Per-task reachability prober target (the role of the reference
    task service's PingRequest handler, ``network.py:115-117``): answers a
    signed ping with the service name and the source address it saw, so
    the prober can detect NAT (observed source != any local address of
    the interface it used)."""

    def __init__(self, service_name, key, host="0.0.0.0", port=0):
        self._name = service_name
        self._key = key
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                req = _recv_frame(self.request, outer._key)
                if req is None or req.get("op") != "ping":
                    return  # bad digest or garbage: drop silently
                _send_frame(self.request, outer._key,
                            {"service": outer._name,
                             "source": self.client_address[0]})

        self._server = socketserver.ThreadingTCPServer((host, port),
                                                       _Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def port(self):
        return self._server.socket.getsockname()[1]

    def shutdown(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join()


def probe(addresses, key, service_name, match_intf=False,
          local_addrs=None, timeout=3.0, retries=2):
    """Try every candidate ``(ip, port)`` of every interface; return the
    map of interfaces that answered a correctly-signed ping (reference
    ``BasicClient._probe`` / ``_probe_one``, ``network.py:180-245``).

    With ``match_intf`` the observed source address must belong to the
    same-named local interface — the reference's NAT filter. Candidates
    are probed concurrently, as in the reference."""
    if match_intf and local_addrs is None:
        local_addrs = local_interfaces()
    reachable = {}
    lock = threading.Lock()

    def _one(intf, addr):
        for _ in range(retries):
            try:
                with socket.create_connection(tuple(addr),
                                              timeout=timeout) as sock:
                    _send_frame(sock, key, {"op": "ping"})
                    resp = _recv_frame(sock, key)
                if resp is None or resp.get("service") != service_name:
                    return
                if match_intf:
                    mine = [ip for ip, _p in local_addrs.get(intf, [])]
                    if resp.get("source") not in mine:
                        return  # reached it through a different interface
                with lock:
                    reachable.setdefault(intf, []).append(tuple(addr))
                return
            except OSError:
                continue
    threads = [threading.Thread(target=_one, args=(intf, addr), daemon=True)
               for intf, addrs in addresses.items() for addr in addrs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return reachable


# ---------------------------------------------------------------------------
# Driver / task registration over the signed KV
# ---------------------------------------------------------------------------

class DriverService:
    """Launcher-side aggregation (reference ``BasicDriverService``):
    collects task registrations from the KV, groups ranks by host hash,
    and elects the common routable interface set."""

    def __init__(self, num_tasks, kv_addr, kv_port, key, liveness=None):
        self.num_tasks = num_tasks
        self._kv = (kv_addr, kv_port)
        self._key = key
        self._liveness = liveness
        """Optional callable returning False when a discovery task died —
        turns a would-be full-timeout stall into an immediate error."""

    def _get(self, key_path, timeout):
        deadline = time.time() + timeout
        while time.time() < deadline:
            v = kv_get(*self._kv, key_path, auth_key=self._key)
            if v is not None:
                return v
            if self._liveness is not None and not self._liveness():
                raise RuntimeError(
                    "a discovery task exited before completing the "
                    "protocol (ssh failure or crash on a remote host)")
            time.sleep(0.2)
        raise TimeoutError(f"{key_path} not published within {timeout}s")

    def wait_for_registrations(self, timeout=60.0):
        """Block until every task has registered; returns
        ``{index: {"addresses": ..., "host_hash": ...}}``
        (reference ``wait_for_initial_registration``)."""
        regs = {}
        for i in range(self.num_tasks):
            regs[i] = json.loads(self._get(f"disc/task/{i}", timeout))
        # publish the full registry so tasks can find their ring successor
        kv_put(*self._kv, "disc/all",
               json.dumps(regs).encode(), auth_key=self._key)
        return regs

    def wait_for_probes(self, timeout=60.0):
        """Collect each task's ring-probe result and intersect interface
        names (reference ``driver_service.py`` task-to-task updates +
        ``gloo_run.py`` common-intf intersection)."""
        common = None
        for i in range(self.num_tasks):
            reach = json.loads(self._get(f"disc/reach/{i}", timeout))
            names = set(reach.keys())
            common = names if common is None else (common & names)
        common = sorted(common or ())
        kv_put(*self._kv, "disc/common",
               json.dumps(common).encode(), auth_key=self._key)
        return common

    def host_hash_indices(self, regs):
        """``{host_hash: [sorted indices]}`` — which ranks share a host
        (reference ``task_host_hash_indices``)."""
        groups = {}
        for idx, reg in regs.items():
            groups.setdefault(reg["host_hash"], []).append(int(idx))
        return {h: sorted(v) for h, v in groups.items()}


class TaskAgent:
    """Task-side protocol (reference ``task_fn._task_fn``): start a ping
    server, register with the driver, probe the ring successor with
    interface matching, and report the surviving interfaces."""

    def __init__(self, index, num_tasks, kv_addr, kv_port, key,
                 nic=None, addresses=None, host_salt=None):
        self.index = index
        self.num_tasks = num_tasks
        self._kv = (kv_addr, kv_port)
        self._key = key
        self._server = PingServer(f"task-{index}", key)
        if addresses:  # test fakes carry ip but not the live port
            self._addresses = {
                intf: [(ip, self._server.port) for ip, _p in addrs]
                for intf, addrs in addresses.items()}
        else:
            self._addresses = local_interfaces(port=self._server.port,
                                               nic=nic)
        self._host_salt = host_salt

    @property
    def addresses(self):
        return self._addresses

    def register(self):
        payload = {"addresses": self._addresses,
                   "host_hash": host_hash(self._host_salt)}
        kv_put(*self._kv, f"disc/task/{self.index}",
               json.dumps(payload).encode(), auth_key=self._key)

    def run_ring_probe(self, timeout=60.0):
        """Probe task ``(index+1) % n`` across all its candidate
        addresses and publish the interfaces that worked."""
        all_regs = json.loads(kv_wait(*self._kv, "disc/all",
                                      timeout=timeout, auth_key=self._key))
        succ = (self.index + 1) % self.num_tasks
        succ_addrs = all_regs[str(succ)]["addresses"]
        reach = probe(succ_addrs, self._key, f"task-{succ}",
                      match_intf=True, local_addrs=self._addresses)
        kv_put(*self._kv, f"disc/reach/{self.index}",
               json.dumps({k: [list(a) for a in v]
                           for k, v in reach.items()}).encode(),
               auth_key=self._key)
        return reach

    def common_interfaces(self, timeout=60.0):
        return json.loads(kv_wait(*self._kv, "disc/common",
                                  timeout=timeout, auth_key=self._key))

    def shutdown(self):
        self._server.shutdown()


def discover(num_tasks, kv_addr, kv_port, key, indices=None,
             host_salts=None, timeout=60.0):
    """Run the whole task-side protocol for the given indices in this
    process (used by in-process launch modes and tests); returns the
    common interface list."""
    agents = [TaskAgent(i, num_tasks, kv_addr, kv_port, key,
                        host_salt=(host_salts or {}).get(i))
              for i in (indices or range(num_tasks))]
    try:
        for a in agents:
            a.register()
        driver = DriverService(num_tasks, kv_addr, kv_port, key)
        regs = driver.wait_for_registrations(timeout)
        threads = [threading.Thread(target=a.run_ring_probe, daemon=True)
                   for a in agents]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        common = driver.wait_for_probes(timeout)
        return common, driver.host_hash_indices(regs)
    finally:
        for a in agents:
            a.shutdown()
