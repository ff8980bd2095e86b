"""Process spawning, monitoring and failure fan-out: the port of
``horovod_tpu/run/launcher.py``. One process per slot with the env
contract, local slots by subprocess, remote slots by ssh, each behind the
orphan-reaping middleman (``safe_exec.py``); a monitor thread per
process; any non-zero exit terminates the whole job; SIGTERM fans out to
every child and escalates to SIGKILL after a grace period.
"""

import os
import shlex
import signal
import subprocess
import sys
import threading
import time

from horovod_tpu_torch.run.secret import SECRET_ENV

LOCAL_HOSTS = ("localhost", "127.0.0.1")
MIDDLEMAN = "horovod_tpu_torch.run.safe_exec"

# A forwarded SIGTERM waits this many seconds for the workers to finish,
# then SIGKILLs the survivors: one worker that ignores SIGTERM must not
# park the launcher for ever.
GRACE_ENV = "HOROVOD_GRACE_SECONDS"
DEFAULT_GRACE_SECONDS = 30.0


def grace_seconds(env=None):
    raw = (env if env is not None else os.environ).get(GRACE_ENV)
    if not raw:
        return DEFAULT_GRACE_SECONDS
    try:
        return max(0.0, float(raw))
    except ValueError:
        return DEFAULT_GRACE_SECONDS


def slot_env(slot, controller_addr, controller_port, rendezvous_addr=None,
             rendezvous_port=None, extra_env=None):
    """The worker env contract, key for key the JAX package's."""
    env = {
        "HOROVOD_RANK": str(slot.rank),
        "HOROVOD_SIZE": str(slot.size),
        "HOROVOD_LOCAL_RANK": str(slot.local_rank),
        "HOROVOD_LOCAL_SIZE": str(slot.local_size),
        "HOROVOD_CROSS_RANK": str(slot.cross_rank),
        "HOROVOD_CROSS_SIZE": str(slot.cross_size),
        "HOROVOD_CONTROLLER_ADDR": controller_addr,
        "HOROVOD_CONTROLLER_PORT": str(controller_port),
        "HOROVOD_HOSTNAME": slot.hostname,
    }
    if rendezvous_addr is not None:
        env["HOROVOD_GLOO_RENDEZVOUS_ADDR"] = rendezvous_addr
        env["HOROVOD_GLOO_RENDEZVOUS_PORT"] = str(rendezvous_port)
    if extra_env:
        env.update(extra_env)
    # the launcher's HOROVOD_METRICS_PORT is a BASE port: each rank's is
    # base + local_rank, so ranks of one host never collide (0: each rank
    # binds its own ephemeral port)
    base = env.get("HOROVOD_METRICS_PORT")
    if base:
        try:
            base_port = int(base)
        except ValueError:
            base_port = 0
        if base_port > 0:
            env["HOROVOD_METRICS_PORT"] = str(base_port + slot.local_rank)
    return env


def build_command(hostname, command, env, ssh_port=None, cwd=None,
                  remote_middleman=False):
    """Local hosts run the command directly; remote hosts wrap it in ssh
    with inline env exports. Returns ``(cmd, proc_env, stdin_payload)``.

    The run's secret never rides the ssh argv (readable by anyone in
    ``/proc/*/cmdline``): it leaves the inline exports and goes over the
    ssh channel's stdin, read into the env by the remote shell before the
    command runs. The remote string runs under ``/bin/sh -c`` so that a
    csh or fish login shell cannot break the POSIX prefix."""
    if hostname in LOCAL_HOSTS:
        return command, env, None
    env = dict(env)
    payload = None
    prefix = ""
    if SECRET_ENV in env:
        payload = (env.pop(SECRET_ENV) + "\n").encode()
        prefix = f"IFS= read -r {SECRET_ENV}; export {SECRET_ENV}; "
    exports = " ".join(f"{k}={shlex.quote(v)}" for k, v in env.items())
    remote_cwd = cwd or os.getcwd()
    if remote_middleman:
        # EOF on the ssh channel's stdin (the launcher died, the connection
        # dropped) reaps the training process tree on the far side
        command = ["python3", "-m", MIDDLEMAN, "--watch-stdin",
                   "--"] + list(command)
    remote = (prefix + f"cd {shlex.quote(remote_cwd)} && env {exports} " +
              " ".join(shlex.quote(c) for c in command))
    ssh = ["ssh", "-o", "StrictHostKeyChecking=no"]
    if ssh_port:
        ssh += ["-p", str(ssh_port)]
    ssh += [hostname, f"exec /bin/sh -c {shlex.quote(remote)}"]
    return ssh, {}, payload


def spawn(hostname, command, env, ssh_port=None, stdout=None,
          middleman=False):
    """Build and start one host's process: the env merge and the
    secret-over-stdin contract in one place.

    With ``middleman=True`` the command runs behind the orphan-reaping
    middleman: if this launcher dies, even by SIGKILL, the training tree
    is terminated, not orphaned. Locally the middleman watches an
    inherited pipe whose write end lives in this process; over ssh it
    watches the channel's stdin for EOF."""
    local = hostname in LOCAL_HOSTS
    death_r = death_w = None
    if middleman and local:
        death_r, death_w = os.pipe()
        command = [sys.executable, "-m", MIDDLEMAN, str(death_r),
                   "--"] + list(command)
    cmd, proc_env, payload = build_command(
        hostname, command, env, ssh_port=ssh_port,
        remote_middleman=middleman and not local)
    full_env = dict(os.environ)
    full_env.update(proc_env if cmd[0] == "ssh" else env)
    hold_stdin = middleman and not local  # ssh stdin EOF = launcher died
    proc = subprocess.Popen(
        cmd, env=full_env, stdout=stdout,
        stderr=subprocess.STDOUT if stdout else None,
        stdin=subprocess.PIPE if (payload or hold_stdin) else None,
        pass_fds=(death_r,) if death_r is not None else ())
    if payload:
        proc.stdin.write(payload)
        proc.stdin.flush()
    if proc.stdin is not None and not hold_stdin:
        proc.stdin.close()
    if death_r is not None:
        os.close(death_r)
        # the write end lives exactly as long as the process is watched:
        # the Popen holds it until the monitor closes it
        proc._hvd_death_w = death_w
    return proc


class Job:
    """A running multi-process job."""

    def __init__(self):
        self.procs = []
        self.slots = []  # the Slot of each process, in the same order
        self._failed = threading.Event()
        self.first_failure = None
        self.failed_at = None  # wall time the first failure was seen
        self.exit_codes = {}
        self._lock = threading.Lock()

    def kill_all(self, sig=signal.SIGTERM):
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.send_signal(sig)
                except OSError:
                    pass

    def escalate_after_grace(self, grace=None, clock=time.monotonic,
                             sleep=time.sleep):
        """Wait up to ``grace`` seconds (``HOROVOD_GRACE_SECONDS``) for
        every process to exit, then SIGKILL the survivors. Returns the
        ranks killed. ``clock`` and ``sleep`` are for fake-clock tests."""
        grace = grace_seconds() if grace is None else grace
        deadline = clock() + grace
        while clock() < deadline:
            if all(p.poll() is not None for p in self.procs):
                return []
            sleep(min(0.2, max(0.01, deadline - clock())))
        killed = []
        for rank, p in enumerate(self.procs):
            if p.poll() is None:
                try:
                    p.kill()
                    killed.append(rank)
                except OSError:
                    pass
        if killed:
            sys.stderr.write(
                f"hvdrun: rank(s) {killed} survived SIGTERM past the "
                f"{grace:.0f}s grace deadline; SIGKILLed\n")
        return killed

    def _monitor(self, rank, proc):
        rc = proc.wait()
        with self._lock:
            self.exit_codes[rank] = rc
        # release the middleman's death-pipe write end (spawn()), or a
        # long-lived driver leaks one descriptor per worker
        death_w = getattr(proc, "_hvd_death_w", None)
        if death_w is not None:
            try:
                os.close(death_w)
            except OSError:
                pass
            proc._hvd_death_w = None
        if rc != 0 and not self._failed.is_set():
            with self._lock:
                if self.first_failure is None:
                    self.first_failure = (rank, rc)
                    self.failed_at = time.time()
            self._failed.set()
            self.kill_all()

    def wait(self):
        """Block until every process exits; raise on any failure."""
        self.join()
        if self.first_failure is not None:
            rank, rc = self.first_failure
            raise RuntimeError(
                f"hvdrun: process with rank {rank} exited with code {rc}; "
                f"remaining processes were terminated")

    def join(self):
        """Like :meth:`wait`, but return ``{rank: exit_code}`` instead of
        raising; ``first_failure`` names the first rank that failed (the
        others died of the fan-out's SIGTERM)."""
        threads = [threading.Thread(target=self._monitor, args=(r, p))
                   for r, p in enumerate(self.procs)]
        for t in threads:
            t.start()
        try:
            for t in threads:
                t.join()
        except KeyboardInterrupt:
            self.kill_all(signal.SIGINT)
            for t in threads:
                t.join()
            raise
        return dict(self.exit_codes)


def this_host_addr():
    """This machine's address as remote workers should dial it."""
    import socket
    return socket.gethostbyname(socket.gethostname())


def repo_pythonpath(base_env=None):
    """PYTHONPATH with this checkout's root (two levels above this file)
    first, keeping whatever the caller had."""
    root = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                        os.pardir, os.pardir))
    existing = [p for p in (base_env or os.environ).get(
        "PYTHONPATH", "").split(os.pathsep) if p]
    return os.pathsep.join([root] + existing)


def launcher_addr(slots):
    """Where workers reach the services of the launcher's machine (the
    key-value store): loopback for an all-local job, this host's address
    otherwise."""
    if all(s.hostname in LOCAL_HOSTS for s in slots):
        return "127.0.0.1"
    return this_host_addr()


def launch(slots, command, controller_addr, controller_port,
           rendezvous_addr=None, rendezvous_port=None, extra_env=None,
           ssh_port=None, stdout=None, output_dir=None, middleman=True):
    """Spawn one process per slot and return a Job. Every worker runs
    behind the orphan-reaping middleman unless ``middleman=False``;
    ``output_dir`` takes each rank's output as ``rank.<r>.log``."""
    job = Job()
    if rendezvous_port is not None and rendezvous_addr is None:
        rendezvous_addr = launcher_addr(slots)
    for slot in slots:
        env = slot_env(slot, controller_addr, controller_port,
                       rendezvous_addr=rendezvous_addr,
                       rendezvous_port=rendezvous_port, extra_env=extra_env)
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            # the child holds its own copy of the descriptor
            with open(os.path.join(output_dir, f"rank.{slot.rank}.log"),
                      "wb") as out:
                proc = spawn(slot.hostname, command, env, ssh_port=ssh_port,
                             stdout=out, middleman=middleman)
        else:
            proc = spawn(slot.hostname, command, env, ssh_port=ssh_port,
                         stdout=stdout, middleman=middleman)
        job.procs.append(proc)
        job.slots.append(slot)
    # fan out SIGTERM (only the main thread may set a handler)
    if threading.current_thread() is threading.main_thread():
        def _forward(signum, frame):
            job.kill_all(signum)
            # the escalation runs on its own non-daemon thread: the handler
            # must not block, and the interpreter waits for the thread
            # after the SystemExit below, so it can still SIGKILL a worker
            # that ignores the forwarded SIGTERM
            threading.Thread(target=job.escalate_after_grace,
                             name="hvd_torch_grace").start()
            sys.exit(128 + signum)
        try:
            signal.signal(signal.SIGTERM, _forward)
        except ValueError:
            pass
    return job
