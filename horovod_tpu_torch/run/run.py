"""The hvdrun CLI of the port: the port of ``horovod_tpu/run/run.py``.

    python -m horovod_tpu_torch.run -np 2 python train.py
    hvdrun-torch -np 8 -H host1:4,host2:4 python train.py
    hvdrun-torch -np 4 --config-file cfg.yaml python train.py

The parser is the JAX package's, so one argv parses to the same
namespace in both. The launch is the fixed-size one, or with
``--min-np``, ``--max-np`` or ``--host-discovery-script`` the elastic
one (JAX ``run.py:252-290``, ``:571-630``): an ``elastic.ElasticDriver``
owns discovery, blame and a rendezvous an epoch, and each epoch launches
the command through the launcher with the elastic env
(``HOROVOD_ELASTIC``, ``_EPOCH``, ``_MIN_NP``, ``_MAX_NP``):

    hvdrun-torch --min-np 1 --max-np 2 -H localhost:2 python train.py

``--chaos SPEC`` arms a seeded fault injector (``chaos/``) against the
job's workers, retargeted at each epoch's. ``--spmd-procs N
--spmd-local-devices K`` launches N x K ranks as one ``(dcn N, data K)``
process mesh (``cluster/procmesh.py``): the JAX package's N processes of
K devices, one rank to a device; it is fixed-size. Tuning flags set the
same ``HOROVOD_*`` env as the JAX package's; of each the port's
``init()`` does not read, hvdrun says so on stderr.

The diagnosis flags are the JAX launcher's (``run/run.py:181-205``,
``:447-480``): ``--doctor LOGDIR`` (the hang report,
``diag/doctor.py``), ``--goodput-report LOGDIR`` (``telemetry/report.py``)
and ``--merge-timeline OUT traces...`` (``telemetry/merge.py``) run their
tool and exit. A launch gives its ranks a flight-recorder directory
(``--output-dir``, an exported ``HOROVOD_FLIGHTREC_DIR``, else a
temporary one removed after a clean run), and after a failed job runs
the doctor over it (``--no-doctor`` suppresses it). ``--metrics-port``
is a base port: rank r binds base + its local rank, each probed here
first.
"""

import argparse
import os
import socket
import sys

from horovod_tpu_torch.config import ACTED_ON
from horovod_tpu_torch.run import allocation, config_parser, launcher
from horovod_tpu_torch.run import cache as run_cache
from horovod_tpu_torch.run import secret as _secret
from horovod_tpu_torch.run.discovery import DriverService
from horovod_tpu_torch.run.rendezvous import KVStoreServer

TASK_FN = "horovod_tpu_torch.run.task_fn"


def _version():
    from horovod_tpu_torch import __version__
    return f"hvdrun-torch (horovod_tpu_torch) {__version__}"


def check_build():
    """Print the planes this installation has: PyTorch and CUDA, the
    process-group backends, the native host core (built here from
    ``cxx/`` if it is not yet) with its ring collectives, and the CUDA
    compiler the kernels build with."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch import _build, _core

    def box(ok):
        return "X" if ok else " "

    try:
        nvcc = _build.nvcc_path()
    except RuntimeError:
        nvcc = None
    core_ok = _core.core_available()
    lines = [
        _version(),
        "",
        "Available frameworks:",
        f"    [X] PyTorch {torch.__version__}",
        f"    [{box(torch.cuda.is_available())}] CUDA "
        f"({torch.cuda.device_count()} device(s), "
        f"CUDA {torch.version.cuda})",
        "",
        "Available controllers:",
        f"    [{box(dist.is_available())}] torch.distributed "
        "(TCP store, found through the launcher's key-value store)",
        f"    [{box(core_ok)}] TCP (native host core)",
        "",
        "Available tensor operations:",
        f"    [{box(dist.is_available() and dist.is_nccl_available())}] "
        "NCCL",
        f"    [{box(dist.is_available() and dist.is_gloo_available())}] "
        "gloo",
        f"    [{box(core_ok)}] host ring collectives "
        "(allreduce/allgatherv/broadcast/alltoall/reducescatter/Adasum)",
        "",
        "Kernel build:",
        f"    [{box(nvcc)}] nvcc{f' ({nvcc})' if nvcc else ''}",
    ]
    try:
        print("\n".join(lines))
    except BrokenPipeError:  # `hvdrun -cb | head` closing early is fine
        pass


def build_parser():
    p = argparse.ArgumentParser(
        prog="hvdrun-torch",
        description="Launch a horovod_tpu_torch training job "
                    "(one process per slot; no MPI required).")
    p.add_argument("-v", "--version", action="version",
                   version=_version(),
                   help="show the horovod_tpu_torch version and exit")
    p.add_argument("-cb", "--check-build", action="store_true",
                   help="print which planes this installation has, then "
                        "exit")
    p.add_argument("-np", "--num-proc", type=int,
                   help="total number of training processes")
    p.add_argument("-H", "--hosts", default=None,
                   help='host slots, e.g. "h1:4,h2:4" (default: localhost)')
    p.add_argument("--hostfile", default=None,
                   help="file with lines 'hostname slots=N'")
    p.add_argument("-p", "--ssh-port", type=int, default=None)
    p.add_argument("--start-timeout", type=int, default=600)
    p.add_argument("--output-dir", default=None,
                   help="write per-rank logs to this directory")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--config-file", default=None,
                   help="YAML file providing any of the tuning params")
    p.add_argument("--jax-coordinator", action="store_true",
                   help="name the job's rendezvous in "
                        "HOROVOD_COORDINATOR_ADDR, so that init() installs "
                        "one process mesh over every rank "
                        "(cluster/procmesh.py)")
    p.add_argument("--spmd-procs", type=int, default=None, metavar="N",
                   help="run the job as ONE logical (dcn, data) mesh of N "
                        "rows (hosts) of --spmd-local-devices ranks each "
                        "(implies --jax-coordinator; defaults -np to N x "
                        "K)")
    p.add_argument("--spmd-local-devices", type=int, default=None,
                   metavar="K",
                   help="ranks in each --spmd-procs row (sets "
                        "HOROVOD_SPMD_LOCAL_DEVICES; one rank drives one "
                        "device, so on the CPU the K ranks of a row stand "
                        "in for a host's devices)")
    p.add_argument("--network-interface", "--nic", dest="nic", default=None,
                   help="restrict control-plane traffic to this interface "
                        "(skips automatic interface discovery)")
    p.add_argument("--no-interface-discovery", action="store_true",
                   help="skip the multi-host NIC discovery pre-flight")

    el = p.add_argument_group(
        "elastic (Horovod's horovodrun --min-np/--max-np/"
        "--host-discovery-script)")
    el.add_argument("--min-np", type=int, default=None,
                    help="minimum worker count: the job keeps running as "
                         "long as this many slots remain after failures/"
                         "blacklisting (enables elastic mode)")
    el.add_argument("--max-np", type=int, default=None,
                    help="maximum worker count when discovery reports "
                         "more slots than needed")
    el.add_argument("--host-discovery-script", default=None,
                    help="executable printing the current 'host:slots' "
                         "set, one per line; polled for membership "
                         "changes (enables elastic mode)")
    el.add_argument("--elastic-poll-interval", type=float, default=2.0,
                    help="seconds between host-discovery polls")

    tune = p.add_argument_group("tuning (sets HOROVOD_* env)")
    tune.add_argument("--fusion-threshold-mb", type=int, default=None)
    tune.add_argument("--cycle-time-ms", type=float, default=None)
    tune.add_argument("--cache-capacity", type=int, default=None)
    tune.add_argument("--disable-cache", action="store_true",
                      help="disable the launcher's NIC-discovery cache "
                           "(a fresh probe) and set "
                           "HOROVOD_CACHE_CAPACITY=0")
    tune.add_argument("--hierarchical-allreduce", action="store_true")
    tune.add_argument("--hierarchical-allgather", action="store_true")
    tune.add_argument("--autotune", action="store_true")
    tune.add_argument("--autotune-log-file", default=None)
    tune.add_argument("--autotune-warmup-samples", type=int, default=None)
    tune.add_argument("--autotune-steps-per-sample", type=int, default=None)
    tune.add_argument("--autotune-sample-repeats", type=int, default=None)
    tune.add_argument("--autotune-bayes-opt-max-samples", type=int,
                      default=None)
    tune.add_argument("--autotune-gaussian-process-noise", type=float,
                      default=None)
    tune.add_argument("--timeline-filename", default=None)
    tune.add_argument("--timeline-mark-cycles", action="store_true")
    tune.add_argument("--metrics-port", type=int, default=None)
    tune.add_argument("--metrics-addr", default=None)
    tune.add_argument("--no-stall-check", action="store_true")
    tune.add_argument("--stall-warning-time-seconds", type=float,
                      default=None)
    tune.add_argument("--stall-shutdown-time-seconds", type=float,
                      default=None)
    tune.add_argument("--log-level", default=None,
                      choices=["trace", "debug", "info", "warning",
                               "error", "fatal"])

    p.add_argument("--chaos", metavar="SPEC", default=None,
                   help="arm a seeded fault injector against this job's "
                        "worker processes (chaos soak): SPEC is a JSON "
                        "plan file or an inline "
                        "'seed=7,interval=2.5,kinds=sigterm+sigkill,"
                        "count=6' knob list; kinds are sigterm/sigkill/"
                        "stall/slow_disk. In elastic mode the remaining "
                        "injections retarget each new epoch's workers")
    p.add_argument("--doctor", metavar="LOGDIR", default=None,
                   help="aggregate the flight-recorder dumps "
                        "(flightrec.rank*.json) under LOGDIR into one "
                        "hang/crash report, then exit (python -m "
                        "horovod_tpu_torch.diag.doctor)")
    p.add_argument("--no-doctor", action="store_true",
                   help="do not run the doctor when a job exits non-zero "
                        "with flight-recorder dumps present")
    p.add_argument("--goodput-report", metavar="LOGDIR", default=None,
                   help="aggregate the goodput-ledger dumps "
                        "(goodput.rank*.json) under LOGDIR into the "
                        "end-of-run time-attribution report, then exit")
    p.add_argument("--merge-timeline", metavar="OUT", default=None,
                   help="merge per-rank Chrome trace files (the command "
                        "arguments) into one trace with aligned clocks, "
                        "then exit")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="training command, e.g. python train.py")
    return p


def parse_args(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]  # `hvdrun -np 4 -- python ...`
    if args.config_file:
        defaults = {a.dest: a.default for a in parser._actions}
        config_parser.load_config_file(args.config_file, args, defaults)
    args.elastic = _validate_elastic_args(parser, args)
    if args.spmd_procs is not None:
        # the JAX launcher's N processes of K devices are N x K ranks
        # here, a rank to a device (run/run.py:220-236 of the JAX package)
        if args.spmd_procs < 1:
            parser.error(f"--spmd-procs must be >= 1 "
                         f"(got {args.spmd_procs})")
        if args.elastic:
            parser.error("--spmd-procs is fixed-size: one process mesh "
                         "cannot resize mid-job; drop the elastic flags")
        local = args.spmd_local_devices or 1
        if local < 1:
            parser.error(f"--spmd-local-devices must be >= 1 (got {local})")
        ranks = args.spmd_procs * local
        if args.num_proc is None:
            args.num_proc = ranks
        elif args.num_proc != ranks:
            parser.error(f"--spmd-procs ({args.spmd_procs}) x "
                         f"--spmd-local-devices ({local}) must equal -np "
                         f"({args.num_proc}): one rank per device of the "
                         "mesh")
        args.jax_coordinator = True
    elif args.spmd_local_devices is not None:
        parser.error("--spmd-local-devices requires --spmd-procs")
    if args.chaos is not None:
        from horovod_tpu_torch.chaos import parse_spec
        try:
            parse_spec(args.chaos)  # reject a malformed spec pre-launch
        except ValueError as e:
            parser.error(str(e))
    # after the config overlay: the YAML may supply num-proc
    if (not args.check_build and not args.elastic
            and args.merge_timeline is None and args.doctor is None
            and args.goodput_report is None and args.num_proc is None):
        parser.error("-np/--num-proc is required")
    return args


def _validate_elastic_args(parser, args):
    """Reject invalid elastic flag combinations with the JAX launcher's
    messages; returns True when the job is elastic (any elastic flag
    present), with the min/max/np defaults filled in."""
    elastic = (args.min_np is not None or args.max_np is not None
               or args.host_discovery_script is not None)
    if not elastic:
        return False
    if args.host_discovery_script is not None:
        if args.hosts or args.hostfile:
            parser.error("--host-discovery-script replaces -H/--hostfile: "
                         "the script is the source of truth for the host "
                         "set; pass one or the other")
        script = args.host_discovery_script
        if not os.path.isfile(script):
            parser.error(f"--host-discovery-script {script!r} does not "
                         "exist")
        if not os.access(script, os.X_OK):
            parser.error(f"--host-discovery-script {script!r} is not "
                         "executable (chmod +x it)")
    if args.min_np is None:
        if args.num_proc is None:
            parser.error("elastic mode requires --min-np (or -np, which "
                         "defaults --min-np)")
        args.min_np = args.num_proc
    if args.min_np < 1:
        parser.error(f"--min-np must be >= 1 (got {args.min_np})")
    if args.max_np is not None and args.max_np < args.min_np:
        parser.error(f"--max-np ({args.max_np}) must be >= --min-np "
                     f"({args.min_np})")
    if args.num_proc is not None:
        if args.num_proc < args.min_np:
            parser.error(f"-np ({args.num_proc}) must be >= --min-np "
                         f"({args.min_np})")
        if args.max_np is not None and args.num_proc > args.max_np:
            parser.error(f"-np ({args.num_proc}) must be <= --max-np "
                         f"({args.max_np})")
    else:
        args.num_proc = args.min_np
    return True


def free_port():
    """A TCP port that was free when asked (bound to port 0 and released):
    the launcher's pick for a service it starts on this host."""
    s = socket.socket()
    s.bind(("0.0.0.0", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _check_metrics_ports(args, slots):
    """Per-rank metrics ports (base + local_rank), each probed with a
    bind where the slot is local (a remote host fails loudly when its
    rank binds). Prints the scrape targets. Returns the ``(host, port)``
    list."""
    if args.metrics_port is None:
        return []
    targets = [(s.hostname, args.metrics_port + s.local_rank)
               for s in slots]
    if args.metrics_port > 0:
        for host, port in targets:
            if host not in launcher.LOCAL_HOSTS:
                continue
            probe = socket.socket()
            try:
                probe.bind((args.metrics_addr or "127.0.0.1", port))
            except OSError as e:
                raise RuntimeError(
                    f"hvdrun: metrics port {port} (base "
                    f"{args.metrics_port} + local_rank) is not bindable "
                    f"on {host}: {e}; pick another --metrics-port")
            finally:
                probe.close()
        print("hvdrun: metrics scrape targets: "
              + ", ".join(f"{h}:{p}" for h, p in targets),
              file=sys.stderr)
    else:
        print("hvdrun: metrics on ephemeral ports (base 0); check each "
              "rank's log for its bound port", file=sys.stderr)
    return targets


def _flightrec_dir(args, extra_env):
    """Where this run's flight-recorder dumps land: ``--output-dir``
    (beside the rank logs), an exported ``HOROVOD_FLIGHTREC_DIR``, else
    a temporary directory, so the doctor after a failure has a place to
    look. Returns ``(dir, the temporary directory or None)``."""
    import tempfile
    if args.output_dir:
        extra_env.setdefault("HOROVOD_FLIGHTREC_DIR", args.output_dir)
        return args.output_dir, None
    explicit = os.environ.get("HOROVOD_FLIGHTREC_DIR")
    if explicit:
        return explicit, None
    d = tempfile.mkdtemp(prefix="hvdrun_flightrec_")
    extra_env["HOROVOD_FLIGHTREC_DIR"] = d
    return d, d


def _maybe_doctor(args, dump_dir, multi_host=False):
    """Run the doctor over this run's dumps after a failed job (unless
    ``--no-doctor``): the report naming the dead rank and the collective
    the survivors are parked in. A job across hosts sees only this
    host's dumps, so the report says that ranks elsewhere may read as
    dead."""
    if getattr(args, "no_doctor", False) or not dump_dir:
        return
    try:
        from horovod_tpu_torch.diag import doctor as doctor_mod
        if not doctor_mod.find_dumps(dump_dir):
            return
        print(f"hvdrun: flight-recorder dumps found in {dump_dir}; "
              "doctor report (suppress with --no-doctor):",
              file=sys.stderr)
        if multi_host:
            print("hvdrun: MULTI-HOST job — only this host's dumps are "
                  "visible below; ranks on other hosts may be wrongly "
                  "listed as DEAD. Collect each host's dump dir into one "
                  "place and rerun `hvdrun-torch --doctor <dir>` for the real "
                  "verdict.", file=sys.stderr)
        doctor_mod.run(dump_dir, expected_size=args.num_proc,
                       stream=sys.stderr)
    except Exception as e:  # the report must never mask the real failure
        print(f"hvdrun: doctor failed: {e}", file=sys.stderr)


def _cleanup_tmp_flightrec(tmp_dir):
    """A clean run's temporary dump directory holds clean-exit dumps
    only: remove it. A failed run keeps its (the doctor names it)."""
    if tmp_dir:
        import shutil
        shutil.rmtree(tmp_dir, ignore_errors=True)


def _discover_interfaces(hosts, auth_key, kv_port, args, extra_env):
    """The multi-host pre-flight: one discovery task per host, a ring
    probe, and the interface names routable between every pair of
    adjacent hosts."""
    launcher_ip = launcher.this_host_addr()
    env = {_secret.SECRET_ENV: _secret.encode_key(auth_key),
           "PYTHONPATH": extra_env.get("PYTHONPATH",
                                       os.environ.get("PYTHONPATH", ""))}
    procs = []
    for idx, h in enumerate(hosts):
        cmd = [sys.executable, "-m", TASK_FN, str(idx), str(len(hosts)),
               launcher_ip, str(kv_port), str(args.start_timeout)]
        procs.append(launcher.spawn(h.hostname, cmd, env,
                                    ssh_port=args.ssh_port))

    def _alive():  # a non-zero exit means an ssh or start-up failure
        return not any(p.poll() not in (None, 0) for p in procs)

    driver = DriverService(len(hosts), launcher_ip, kv_port, auth_key,
                           liveness=_alive)
    try:
        driver.wait_for_registrations(timeout=args.start_timeout)
        common = driver.wait_for_probes(timeout=args.start_timeout)
        if not common:
            raise RuntimeError(
                "interface discovery found NO interface routable across "
                "all hosts (interfaces must share a name on every host; "
                "NAT'ed paths are rejected)")
    except (TimeoutError, RuntimeError) as e:
        for p in procs:
            p.kill()
        raise RuntimeError(
            f"hvdrun: interface discovery failed: {e}\n"
            f"Check ssh connectivity and interface naming, or pass "
            f"--network-interface / --no-interface-discovery") from e
    for p in procs:
        p.wait()
    if args.verbose:
        print(f"hvdrun: common routable interfaces: {common}",
              file=sys.stderr)
    return common


def _nic_cache_key(hosts):
    """The NIC pre-flight's cache key, which names the launching host
    too: the elected set is over paths from this machine."""
    return ("nics:" + socket.gethostname() + ":"
            + ",".join(sorted({h.hostname for h in hosts})))


def _common_interfaces(args, hosts, discover_fn):
    """The same host set within the cache's lifetime has the same
    routable NICs; ``--disable-cache`` forces a fresh probe."""
    cache_key = _nic_cache_key(hosts)
    nic_cache = run_cache.Cache()
    common = (None if getattr(args, "disable_cache", False)
              else nic_cache.get(cache_key))
    if common is None:
        common = sorted(discover_fn())
        nic_cache.put(cache_key, common)
    elif args.verbose:
        print(f"hvdrun: cached routable interfaces: {common}",
              file=sys.stderr)
    return common


def _host_list_from_args(args):
    if args.hostfile:
        return allocation.parse_hostfile(args.hostfile)
    if args.hosts:
        return allocation.parse_hosts(args.hosts)
    return [allocation.HostSlots("localhost", args.num_proc)]


def _start_kv(all_local):
    """The job's key-value store: across hosts with a per-run key and a
    network bind; on this host alone loopback and unauthenticated.
    Returns ``(kv, auth_key, port)``."""
    auth_key = None if all_local else _secret.make_secret_key()
    kv = KVStoreServer(host="127.0.0.1" if all_local else "0.0.0.0",
                       auth_key=auth_key)
    return kv, auth_key, kv.start()


def _base_worker_env(args, auth_key, all_local, hosts, rendezvous_port):
    """The workers' extra env: the tuning knobs, the run's secret, and
    HOROVOD_COMMON_INTERFACES (``--nic``, or the NIC pre-flight of a job
    across hosts)."""
    extra_env = config_parser.args_to_env(args)
    for var in sorted(set(extra_env) - set(ACTED_ON)):
        print(f"hvdrun: horovod_tpu_torch does not act on {var} yet",
              file=sys.stderr)
    if auth_key is not None:
        extra_env[_secret.SECRET_ENV] = _secret.encode_key(auth_key)
    if args.nic:
        extra_env["HOROVOD_COMMON_INTERFACES"] = args.nic
    elif not all_local and hosts and not args.no_interface_discovery:
        common = _common_interfaces(
            args, hosts,
            lambda: _discover_interfaces(hosts, auth_key, rendezvous_port,
                                         args, extra_env))
        if common:
            extra_env["HOROVOD_COMMON_INTERFACES"] = ",".join(common)
    return extra_env


def spmd_env(args, controller_addr, rendezvous_port):
    """The workers' env of one process mesh across rows: the job's
    rendezvous (the key-value store the launcher already runs) as
    ``HOROVOD_COORDINATOR_ADDR``, and ``HOROVOD_SPMD_PROCS`` /
    ``HOROVOD_SPMD_LOCAL_DEVICES`` (``cluster/procmesh.py`` reads them)."""
    env = {}
    if args.jax_coordinator:
        env["HOROVOD_COORDINATOR_ADDR"] = f"{controller_addr}:" \
                                          f"{rendezvous_port}"
    if args.spmd_procs is not None:
        env["HOROVOD_SPMD_PROCS"] = str(args.spmd_procs)
        if args.spmd_local_devices:
            env["HOROVOD_SPMD_LOCAL_DEVICES"] = str(args.spmd_local_devices)
    return env


def _start_chaos(args):
    """The fault injector of ``--chaos``, built and not armed: its clock
    starts at the first ``attach()``, once workers exist."""
    if args.chaos is None:
        return None
    from horovod_tpu_torch.chaos import ChaosMonkey, parse_spec
    return ChaosMonkey(parse_spec(args.chaos))


def _run(args):
    if not args.command:
        raise SystemExit("hvdrun: no training command given")
    if args.elastic:
        return _run_elastic(args)
    hosts = _host_list_from_args(args)
    slots = allocation.allocate(hosts, args.num_proc)
    # rank 0's host; port 0: a JAX worker's native core binds there and
    # publishes its port through the key-value store
    controller_addr = slots[0].hostname
    if controller_addr in launcher.LOCAL_HOSTS:
        controller_addr = "127.0.0.1"
    all_local = all(s.hostname in launcher.LOCAL_HOSTS for s in slots)
    kv, auth_key, rendezvous_port = _start_kv(all_local)
    try:
        extra_env = _base_worker_env(args, auth_key, all_local, hosts,
                                     rendezvous_port)
        extra_env.update(spmd_env(args, controller_addr, rendezvous_port))
        _check_metrics_ports(args, slots)
        dump_dir, tmp_dump_dir = _flightrec_dir(args, extra_env)
        if args.verbose:
            print(f"hvdrun: launching {args.num_proc} processes: "
                  f"{[(s.rank, s.hostname, s.local_rank) for s in slots]}",
                  file=sys.stderr)
        job = launcher.launch(slots, args.command, controller_addr, 0,
                              rendezvous_port=rendezvous_port,
                              extra_env=extra_env, ssh_port=args.ssh_port,
                              output_dir=args.output_dir)
        monkey = _start_chaos(args)
        if monkey is not None:
            monkey.attach(job)
        try:
            job.wait()
        except RuntimeError:
            _maybe_doctor(args, dump_dir, multi_host=not all_local)
            raise
        finally:
            if monkey is not None:
                monkey.stop()
        _cleanup_tmp_flightrec(tmp_dump_dir)
    finally:
        kv.stop()


def _run_elastic(args):
    """The elastic launch path: an ``ElasticDriver`` owns discovery,
    blacklisting and a rendezvous an epoch; each epoch launches
    ``args.command`` through the launcher with the elastic env on top
    (``HOROVOD_ELASTIC``, ``_EPOCH``, ``_MIN_NP``, ``_MAX_NP``)."""
    from horovod_tpu_torch.elastic.discovery import (FixedHosts,
                                                     ScriptDiscovery)
    from horovod_tpu_torch.elastic.driver import (ElasticDriver,
                                                  default_launch_fn)

    if args.host_discovery_script:
        discovery = ScriptDiscovery(args.host_discovery_script)
    else:
        discovery = FixedHosts(_host_list_from_args(args))
    initial_hosts = discovery.find_available_hosts_and_slots()
    # membership may add remote hosts later: only a fixed set on this
    # host gets the loopback-bound, unauthenticated store
    all_local = (not args.host_discovery_script and
                 all(h in launcher.LOCAL_HOSTS for h in initial_hosts))
    kv, auth_key, rendezvous_port = _start_kv(all_local)
    monkey = driver = None
    try:
        # the NIC pre-flight runs against the INITIAL host set; hosts that
        # join later are taken to share the elected interface names
        initial_host_list = [allocation.HostSlots(h, n)
                             for h, n in sorted(initial_hosts.items())]
        extra_env = _base_worker_env(args, auth_key, all_local,
                                     initial_host_list, rendezvous_port)
        if args.metrics_port is not None and args.metrics_port > 0:
            print(f"hvdrun: elastic metrics base port {args.metrics_port}"
                  ": each epoch's scrape targets are host:(base + "
                  "local_rank) over that epoch's slots", file=sys.stderr)
        # without --max-np the job never grows beyond -np: the size asked
        # for is the ceiling, elasticity only rides out losses
        max_np = args.max_np if args.max_np is not None else args.num_proc
        driver = ElasticDriver(
            discovery, args.min_np, max_np=max_np, kv=kv,
            auth_key=auth_key, poll_interval=args.elastic_poll_interval,
            start_timeout=args.start_timeout)
        launch = default_launch_fn(
            args.command, controller_port=0,
            rendezvous_addr=("127.0.0.1" if all_local
                             else launcher.this_host_addr()),
            rendezvous_port=rendezvous_port, extra_env=extra_env,
            ssh_port=args.ssh_port, output_dir=args.output_dir,
            jax_coordinator=args.jax_coordinator)
        monkey = _start_chaos(args)
        if monkey is not None:
            inner_launch = launch

            def launch(slots, epoch, env):
                # the remaining injections target this epoch's workers
                job = inner_launch(slots, epoch, env)
                monkey.attach(job)
                return job
        dump_dir, tmp_dump_dir = _flightrec_dir(args, extra_env)
        try:
            epochs = driver.run_job(launch)
        except (RuntimeError, TimeoutError):
            _maybe_doctor(args, dump_dir, multi_host=not all_local)
            raise
        if args.verbose:
            print(f"hvdrun: elastic job completed after {epochs} "
                  "epoch(s)", file=sys.stderr)
        _cleanup_tmp_flightrec(tmp_dump_dir)
    finally:
        if monkey is not None:
            monkey.stop()
        if driver is not None:
            driver.stop()
        kv.stop()


def main(argv=None):
    args = parse_args(argv)
    if args.check_build:
        check_build()
        return 0
    if args.doctor is not None:
        from horovod_tpu_torch.diag import doctor as doctor_mod
        argv_d = [args.doctor]
        if args.num_proc:
            argv_d += ["--expected-size", str(args.num_proc)]
        return doctor_mod.main(argv_d)
    if args.goodput_report is not None:
        from horovod_tpu_torch.telemetry import report as report_mod
        return report_mod.main([args.goodput_report])
    if args.merge_timeline is not None:
        from horovod_tpu_torch.telemetry import merge as merge_mod
        traces = [c for c in args.command if c != "--"]
        if not traces:
            print("hvdrun: --merge-timeline needs the per-rank trace "
                  "files as the command arguments", file=sys.stderr)
            return 1
        return merge_mod.main(["-o", args.merge_timeline] + traces)
    try:
        _run(args)
    except (RuntimeError, TimeoutError) as e:
        print(str(e), file=sys.stderr)
        return 1
    except KeyboardInterrupt:
        return 130
    return 0


if __name__ == "__main__":
    sys.exit(main())
