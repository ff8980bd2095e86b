"""The middleman between launcher and training process: no orphans
survive the launcher. The port of ``horovod_tpu/run/safe_exec.py``.

When the launcher dies (SIGKILL, a reboot of the launch host, a dropped
ssh connection) every descendant of the training command is terminated
instead of orphaned onto the machine. The launcher holds the write end
of a pipe; when it exits for any reason the kernel closes it, the
middleman's blocking read returns EOF, and the middleman reaps the tree:
SIGTERM, then SIGKILL after a grace period. The command runs in its own
session, so one ``killpg`` reaches the group; processes that left it by
``setsid()`` are found by walking ``/proc``.

Modes:

* ``python -m horovod_tpu_torch.run.safe_exec <death_fd> -- cmd...``:
  local, ``death_fd`` is the inherited read end of the launcher's pipe.
* ``python -m horovod_tpu_torch.run.safe_exec --watch-stdin -- cmd...``:
  remote, EOF on stdin (the ssh connection died) starts the reap. The
  secret-over-stdin prefix has consumed only the first line.
"""

import os
import signal
import subprocess
import sys
import threading
import time

GRACEFUL_TERMINATION_TIME_S = 5.0


def term_grace(env=None):
    """Seconds between the SIGTERM the middleman forwards and its SIGKILL:
    ``GRACEFUL_TERMINATION_TIME_S``, or for an elastic worker
    (``HOROVOD_ELASTIC=1``) or a run that set ``HOROVOD_GRACE_SECONDS``
    that eviction budget (30 s by default) and a second more, so the
    graceful-eviction handler's bounded force-commit
    (``elastic/preempt.py``) is not cut short. (The JAX middleman kills
    after 5 s whatever the budget.)"""
    env = os.environ if env is None else env
    raw = env.get("HOROVOD_GRACE_SECONDS")
    if not raw and env.get("HOROVOD_ELASTIC") != "1":
        return GRACEFUL_TERMINATION_TIME_S
    try:
        budget = max(0.0, float(raw)) if raw else 30.0
    except ValueError:
        budget = 30.0
    return max(GRACEFUL_TERMINATION_TIME_S, budget + 1.0)


def _children_of(pid_set):
    """Direct children of any pid in ``pid_set``, from ``/proc``."""
    kids = set()
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
            # the field after the state, past the parenthesized command
            # name (which may hold spaces), is the parent's pid
            ppid = int(stat.rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        if ppid in pid_set:
            kids.add(int(entry))
    return kids


def descendants(pid):
    """Every live descendant of ``pid``."""
    seen = {pid}
    frontier = {pid}
    while frontier:
        frontier = _children_of(frontier) - seen
        seen |= frontier
    seen.discard(pid)
    return seen


def _alive_set(pids):
    out = set()
    for p in pids:
        try:
            os.kill(p, 0)
            out.add(p)
        except OSError:
            pass
    return out


def terminate_tree(proc, grace=GRACEFUL_TERMINATION_TIME_S, known=None):
    """SIGTERM the command's whole tree, wait up to ``grace``, then
    SIGKILL what is left. ``known`` holds pids seen as descendants
    earlier: a process whose parent has exited was reparented and a
    ``/proc`` walk no longer finds it."""
    known = set(known or ())
    if proc.poll() is not None and not (descendants(proc.pid) | known):
        return
    tree = descendants(proc.pid) | known | {proc.pid}
    try:
        os.killpg(proc.pid, signal.SIGTERM)  # the command leads its session
    except ProcessLookupError:
        pass
    for p in tree:
        try:
            os.kill(p, signal.SIGTERM)
        except ProcessLookupError:
            pass
    deadline = time.time() + grace
    while time.time() < deadline:
        if proc.poll() is not None and not _alive_set(tree - {proc.pid}):
            break
        time.sleep(0.1)
    tree = descendants(proc.pid) | _alive_set(known) | {proc.pid}
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    for p in tree:
        try:
            os.kill(p, signal.SIGKILL)
        except ProcessLookupError:
            pass


def run_middleman(command, death_fd=None, watch_stdin=False, env=None):
    """Run ``command`` in its own session and guard it; returns its exit
    code (a signal's death as 128 + the signal, as a shell does)."""
    proc = subprocess.Popen(command, env=env, start_new_session=True)
    fired = threading.Event()

    # every descendant ever seen, so that one whose parent died (and was
    # reparented, out of a /proc walk's reach) is still reaped
    known = set()
    known_lock = threading.Lock()

    def _track():
        while proc.poll() is None and not fired.is_set():
            seen = descendants(proc.pid)
            with known_lock:
                known.update(seen)
            time.sleep(1.0)

    threading.Thread(target=_track, daemon=True).start()

    def _reap():
        if not fired.is_set():
            fired.set()
            with known_lock:
                snapshot = set(known)
            terminate_tree(proc, grace=term_grace(env), known=snapshot)

    def _on_signal(signum, frame):
        threading.Thread(target=_reap, daemon=True).start()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)

    def _watch(fd):
        try:
            while os.read(fd, 1):
                pass  # discard until EOF
        except OSError:
            pass
        _reap()  # the launcher is gone

    if death_fd is not None:
        threading.Thread(target=_watch, args=(death_fd,),
                         daemon=True).start()
    if watch_stdin:
        threading.Thread(target=_watch, args=(sys.stdin.fileno(),),
                         daemon=True).start()

    rc = proc.wait()
    return 128 - rc if rc < 0 else rc


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if "--" not in argv:
        print("usage: safe_exec (<death_fd>|--watch-stdin) -- cmd...",
              file=sys.stderr)
        return 2
    split = argv.index("--")
    opts, command = argv[:split], argv[split + 1:]
    death_fd = None
    watch_stdin = False
    for o in opts:
        if o == "--watch-stdin":
            watch_stdin = True
        else:
            death_fd = int(o)
    return run_middleman(command, death_fd=death_fd,
                         watch_stdin=watch_stdin)


if __name__ == "__main__":
    sys.exit(main())
