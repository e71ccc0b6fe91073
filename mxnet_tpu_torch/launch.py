"""The port's launcher: start a distributed job, one process a rank
(counterpart of the JAX package's ``tools/launch.py``; reference:
tools/launch.py, the dmlc-tracker front end that spawned scheduler,
server and worker processes over ssh / mpi / yarn / sge).

    python -m mxnet_tpu_torch.launch -n 2 [--launcher local|ssh|mpi] -- \\
        python train.py ...

There are no parameter servers: every process is a worker of one
`torch.distributed` group (`parallel.collectives.init_process_group`,
which ``kv.create("dist_sync")`` calls). Modes:

  --launcher local   N processes on this host
  --launcher ssh     a process a hostfile slot over ssh (``-H`` with
                     ``host`` or ``host:slots`` lines, ``--ssh-cmd``); rank
                     0's host serves the rendezvous, so its address must be
                     reachable from every host
  --launcher mpi     placement by mpirun (``--mpi-cmd``); each rank reads
                     its rank from ``OMPI_COMM_WORLD_RANK`` / ``PMI_RANK``

Every mode gives the workers this environment, which
`init_process_group` reads:

  MXTPU_COORDINATOR          host:port of rank 0's rendezvous
  MXTPU_NUM_WORKERS          group size        (alias: DMLC_NUM_WORKER)
  MXTPU_PROCESS_ID           this process's rank (alias: DMLC_WORKER_ID)
  MXTPU_RESTART_GENERATION   the supervised respawn (0 = first launch)
  DMLC_ROLE                  worker

Supervision: the first rank that fails (a nonzero exit, or a spawn that
fails) takes the others down, and its exit code is the launcher's. The
teardown sends each worker's process group SIGUSR1 first when
``MXTPU_TELEMETRY_DIR`` is set (the port installs the flight recorder's
dump handler at import there, so every live rank writes its dump and
goes on) and waits ``MXTPU_DUMP_GRACE`` seconds (1) for the dumps, then
SIGTERM, then SIGKILL after ``MXTPU_TEARDOWN_GRACE`` seconds (10).
With ``--max-restarts N`` the whole group is started again up to N
times, after ``--restart-backoff`` seconds doubling to 60,
on a fresh rendezvous port. A worker that exits with the preemption code
(``MXTPU_PREEMPT_EXIT_CODE``, 83) restarts the group without using the
budget, the backoff reset. A SIGTERM to the launcher tears its workers
down the same way. Local and ssh workers' output is prefixed with
their rank. With ``MXTPU_TELEMETRY_DIR`` set, the launcher appends its
events (``launcher_generation_start`` / ``_exit``, ``launcher_restart``,
``preempt``, ``launcher_downtime``, ``launcher_teardown`` with
``dump_first``, ``launcher_restarts_exhausted``) to
``launcher-events.jsonl`` there. The launch is one trace: each
generation is a ``launch.generation`` span (component "launcher",
written to that file when the generation exits), and the workers get
its context as ``MXTPU_TRACE_CONTEXT``, so their ``train.step`` roots
join the trace (recorded when ``MXTPU_TRACE_SAMPLE`` >= 1 in the
launcher's environment).

Not ported: ``--compile-cache`` (the persistent compile tier, ROADMAP
queue 1 item 13) and ``--sharded-step`` (the fused sharded step, item
2); both raise.

The launcher's own code is the standard library's and the variable
registry (`env`): it supervises processes only.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import shlex
import signal
import socket
import subprocess
import sys
import threading
import time


def _load_env():
    """The package's variable registry (`env`, which imports only `os`),
    also when this file runs as a script outside its package."""
    if __package__:
        from . import env
        return env
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_mxtpu_torch_env",
        os.path.join(os.path.dirname(os.path.abspath(__file__)), "env.py"))
    env = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(env)
    return env


_env = _load_env()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _remote_port():
    """A rendezvous port for a remote rank 0, which cannot be probed from
    here: below Linux's ephemeral range (32768+); ``--port`` pins one."""
    return random.randint(10000, 29999)


def _protocol_env(n, coord, extra, rank=None, generation=0):
    """The workers' environment; with ``rank`` None only its
    rank-independent half (mpi: the process manager gives the ranks)."""
    env = {
        "MXTPU_COORDINATOR": coord,
        "MXTPU_NUM_WORKERS": str(n),
        "MXTPU_RESTART_GENERATION": str(generation),
        # the workers' step spans join the launch trace under this
        # generation's span
        "MXTPU_TRACE_CONTEXT": _generation_trace_context(generation),
        "DMLC_NUM_WORKER": str(n),
        "DMLC_ROLE": "worker",
    }
    if rank is not None:
        env["MXTPU_PROCESS_ID"] = str(rank)
        env["DMLC_WORKER_ID"] = str(rank)
    for kv in extra:
        k, _, v = kv.partition("=")
        env[k] = v
    return env


def _parse_hostfile(path):
    """``host`` or ``host:slots`` a line ('#' comments): one entry a
    slot."""
    slots = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            host, _, n = line.partition(":")
            slots.extend([host.strip()] * (int(n) if n else 1))
    return slots


def _log(msg):
    sys.stderr.write("[launcher] %s\n" % msg)
    sys.stderr.flush()


def _emit_event(kind, **fields):
    """Append one JSON event to ``$MXTPU_TELEMETRY_DIR/launcher-events.jsonl``
    (the JAX launcher's record shape); nothing without the variable."""
    directory = os.environ.get("MXTPU_TELEMETRY_DIR")
    if not directory:
        return
    try:
        os.makedirs(directory, exist_ok=True)
        with open(os.path.join(directory, "launcher-events.jsonl"), "a") as f:
            f.write(json.dumps({
                "kind": "event", "ts": time.time(), "event": kind,
                "pid": os.getpid(), "fields": fields}) + "\n")
    except OSError:
        pass   # the events never stop supervision


_PUMP_LOCK = threading.Lock()


# -- the launch trace: one trace id a launcher run, a span a generation,
# written as the `{"kind": "event", "event": "span"}` record that
# tools/trace_merge.py reads (the launcher imports nothing of the port)
_LAUNCH_TRACE = "%032x" % random.getrandbits(128)
_GEN_SPANS = {}   # generation -> (span_id, start_wall)


def _launch_sampled():
    """Whether the launcher's environment samples the run (the workers
    read the flag and record their step spans)."""
    try:
        return float(os.environ.get("MXTPU_TRACE_SAMPLE") or 0) >= 1.0
    except ValueError:
        return False


def _generation_trace_context(generation):
    span_id, _ = _GEN_SPANS.get(generation) or (None, None)
    if span_id is None:
        span_id = "%016x" % random.getrandbits(64)
        _GEN_SPANS[generation] = (span_id, time.time())
    return "%s-%s-%02d" % (_LAUNCH_TRACE, span_id,
                           1 if _launch_sampled() else 0)


def _emit_generation_span(generation, rc):
    """Close ``generation``'s span, now that its duration is known."""
    span_id, start = _GEN_SPANS.get(generation) or (None, None)
    if span_id is None:
        return
    _emit_event("span", name="launch.generation", trace=_LAUNCH_TRACE,
                span=span_id, parent=None, component="launcher",
                ts=start, dur_us=(time.time() - start) * 1e6,
                attrs={"generation": generation, "rc": rc})


def _pump(stream, label):
    """Copy one worker's merged output to ours, each line prefixed with
    its rank."""
    out = sys.stdout.buffer if hasattr(sys.stdout, "buffer") else None
    prefix = ("[%s] " % label).encode()
    for line in iter(stream.readline, b""):
        with _PUMP_LOCK:
            if out is not None:
                out.write(prefix + line)
                out.flush()
            else:   # a text-only stdout (a capture)
                sys.stdout.write((prefix + line).decode("utf-8", "replace"))
                sys.stdout.flush()
    stream.close()


def _signal_group(procs, sig):
    """``sig`` to each live worker's process group (workers lead their
    own sessions), so their children go with them."""
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, sig)
            except OSError:
                try:
                    p.send_signal(sig)
                except OSError:
                    pass


def _teardown(procs, grace=None, generation=None):
    """With ``MXTPU_TELEMETRY_DIR`` set, SIGUSR1 to every live worker
    first (each writes its flight-recorder dump and lives on) and
    ``MXTPU_DUMP_GRACE`` seconds (1) for the dumps; then SIGTERM, and
    SIGKILL to those alive ``grace`` seconds later
    (``MXTPU_TEARDOWN_GRACE``, 10): a rank stuck in a collective with a
    dead peer never blocks the launcher, and leaves a dump that says
    where it was stuck. Without the directory SIGUSR1's default action
    would kill a worker at once and rob it of its SIGTERM grace, so it is
    not sent."""
    survivors = [p for p in procs if p.poll() is None]
    if not survivors:
        return
    if grace is None:
        grace = float(os.environ.get("MXTPU_TEARDOWN_GRACE", "10"))
    dump_first = hasattr(signal, "SIGUSR1") and \
        bool(os.environ.get("MXTPU_TELEMETRY_DIR"))
    _log("tearing down %d live worker(s): %sSIGTERM, SIGKILL after %.0fs"
         % (len(survivors),
            "SIGUSR1 (flight-recorder dump), then " if dump_first else "",
            grace))
    _emit_event("launcher_teardown", live=len(survivors), grace_s=grace,
                dump_first=dump_first, generation=generation)
    if dump_first:
        _signal_group(procs, signal.SIGUSR1)
        # the handlers write their dumps before SIGTERM lands
        deadline = time.time() + float(
            os.environ.get("MXTPU_DUMP_GRACE", "1.0"))
        while time.time() < deadline and any(p.poll() is None
                                             for p in procs):
            time.sleep(0.05)
    _signal_group(procs, signal.SIGTERM)
    deadline = time.time() + grace
    while time.time() < deadline and any(p.poll() is None for p in procs):
        time.sleep(0.05)
    survivors = [p for p in procs if p.poll() is None]
    if survivors:
        _log("%d worker(s) survived SIGTERM for %.0fs; sending SIGKILL"
             % (len(survivors), grace))
        _signal_group(survivors, signal.SIGKILL)
    for p in procs:
        try:
            p.wait(timeout=10)
        except (subprocess.TimeoutExpired, OSError):
            pass


def _preempt_exit_code():
    return _env.get("MXTPU_PREEMPT_EXIT_CODE")


def _run_generation(cmds, preempt_rc=None, generation=None):
    """Start every (argv, env, label) and poll: the first failure tears
    the rest down. Returns (rc, preempted): ``preempted`` when any
    worker's last exit code is ``preempt_rc`` (read after the teardown:
    the preempted rank may have exited a moment before the peer whose
    failure was seen first)."""
    procs, pumps = [], []
    rc = 0
    try:
        for argv, env, label in cmds:
            p = subprocess.Popen(
                argv, env=env, start_new_session=True,
                stdout=subprocess.PIPE if label else None,
                stderr=subprocess.STDOUT if label else None)
            procs.append(p)
            if label:
                t = threading.Thread(target=_pump, args=(p.stdout, label),
                                     daemon=True)
                t.start()
                pumps.append(t)
        pending = list(procs)
        while pending and not rc:
            for p in list(pending):
                r = p.poll()
                if r is not None:
                    pending.remove(p)
                    rc = rc or r
            if pending and not rc:
                time.sleep(0.1)
    finally:
        _teardown(procs, generation=generation)
        for t in pumps:
            t.join(timeout=5)
    preempted = preempt_rc is not None and any(
        p.returncode == preempt_rc for p in procs)
    return rc, preempted


def _spawn_and_wait(make_cmds, max_restarts=0, backoff=1.0):
    """Run generation after generation (``make_cmds(generation)`` gives
    each its commands, on a fresh port) until one exits 0, the restarts
    are spent, or a generation fails without restarts left; a preempted
    generation restarts for free."""
    generation = 0
    restarts_used = 0
    initial_delay = max(backoff, 0.0)
    delay = initial_delay
    prev_exit = None   # (ts, rc, preempted) of the previous generation
    while True:
        if generation:
            _log("spawning generation %d" % generation)
        if prev_exit is not None:
            _emit_event("launcher_downtime", generation=generation,
                        cause="preempt" if prev_exit[2] else "crash",
                        rc=prev_exit[1],
                        down_s=round(time.time() - prev_exit[0], 3))
        _emit_event("launcher_generation_start", generation=generation,
                    max_restarts=max_restarts)
        rc, preempted = _run_generation(make_cmds(generation),
                                        _preempt_exit_code(),
                                        generation=generation)
        prev_exit = (time.time(), rc, preempted)
        _emit_event("launcher_generation_exit", generation=generation, rc=rc,
                    preempted=preempted)
        _emit_generation_span(generation, rc)
        if rc == 0:
            return 0
        if preempted and max_restarts > 0:
            generation += 1
            delay = initial_delay
            _log("group preempted (rc=%d); free restart as generation %d in "
                 "%.1fs (restart budget untouched: %d/%d used)"
                 % (rc, generation, delay, restarts_used, max_restarts))
            _emit_event("preempt", generation=generation, rc=rc,
                        restarts_used=restarts_used, backoff_s=delay)
            if delay:
                time.sleep(delay)
            continue
        if restarts_used >= max_restarts:
            if max_restarts:
                _log("group failed (rc=%d); %d restart(s) exhausted, giving "
                     "up" % (rc, max_restarts))
            _emit_event("launcher_restarts_exhausted", generation=generation,
                        rc=rc)
            return rc
        generation += 1
        restarts_used += 1
        _log("group failed (rc=%d); restarting (%d/%d) in %.1fs on a fresh "
             "rendezvous port" % (rc, restarts_used, max_restarts, delay))
        _emit_event("launcher_restart", generation=generation, rc=rc,
                    backoff_s=delay)
        if delay:
            time.sleep(delay)
        delay = min(max(delay, 0.5) * 2, 60.0)


def _launch_local(args):
    def make_cmds(generation):
        coord = "127.0.0.1:%d" % (args.port or _free_port())
        cmds = []
        for rank in range(args.num_workers):
            env = dict(os.environ)
            env.update(_protocol_env(args.num_workers, coord, args.env, rank,
                                     generation))
            cmds.append((args.command, env, "rank %d" % rank))
        return cmds

    return _spawn_and_wait(make_cmds, args.max_restarts, args.restart_backoff)


def _launch_ssh(args):
    """One ssh session a rank: the environment rides inline as ``env
    K=V`` (sshd forwards few variables), and the remote directory is this
    one (a shared file system or identical checkouts)."""
    if not args.hostfile:
        raise SystemExit("--launcher ssh requires -H/--hostfile")
    slots = _parse_hostfile(args.hostfile)
    if len(slots) < args.num_workers:
        raise SystemExit("hostfile provides %d slots < -n %d"
                         % (len(slots), args.num_workers))
    cwd = os.getcwd()
    ssh = shlex.split(args.ssh_cmd)

    def make_cmds(generation):
        coord = "%s:%d" % (slots[0], args.port or _remote_port())
        cmds = []
        for rank in range(args.num_workers):
            env = _protocol_env(args.num_workers, coord, args.env, rank,
                                generation)
            if os.environ.get("PYTHONPATH"):
                env.setdefault("PYTHONPATH", os.environ["PYTHONPATH"])
            envs = " ".join("%s=%s" % (k, shlex.quote(v))
                            for k, v in sorted(env.items()))
            remote = "cd %s && env %s %s" % (
                shlex.quote(cwd), envs,
                " ".join(shlex.quote(c) for c in args.command))
            cmds.append((ssh + [slots[rank], remote], dict(os.environ),
                         "rank %d" % rank))
        return cmds

    return _spawn_and_wait(make_cmds, args.max_restarts, args.restart_backoff)


# how each mpi flavour exports one variable
_MPI_ENV_FLAG = {
    "openmpi": lambda k, v: ["-x", k],
    "mpich": lambda k, v: ["-genv", k, v],
    "none": lambda k, v: [],
}


def _launch_mpi(args):
    """One mpirun for every rank: ranks come from the process manager's
    environment. Rank 0 serves the rendezvous: the hostfile's first host
    when there is one, else this host (``--coordinator-host`` and
    ``--port`` override)."""
    def make_cmds(generation):
        if args.coordinator_host:
            host, port = args.coordinator_host, args.port or _remote_port()
        elif args.hostfile:
            host = _parse_hostfile(args.hostfile)[0]
            port = args.port or _remote_port()
        else:
            host, port = "127.0.0.1", args.port or _free_port()
        proto = _protocol_env(args.num_workers, "%s:%d" % (host, port),
                              args.env, generation=generation)
        env = dict(os.environ)
        env.update(proto)
        cmd = shlex.split(args.mpi_cmd) + ["-np", str(args.num_workers)]
        if args.hostfile:
            cmd += ["--hostfile", args.hostfile]
        flag = _MPI_ENV_FLAG[args.mpi_flavor]
        export = set(proto)
        if "PYTHONPATH" in env:
            export.add("PYTHONPATH")
        for var in sorted(export):
            cmd += flag(var, env[var])
        # mpirun frames its ranks' output itself: no prefix
        return [(cmd + args.command, env, None)]

    return _spawn_and_wait(make_cmds, args.max_restarts, args.restart_backoff)


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.launch",
        description="Launch a distributed job (local/ssh/mpi)")
    parser.add_argument("-n", "--num-workers", required=True, type=int)
    parser.add_argument("--launcher", default="local",
                        choices=["local", "ssh", "mpi"])
    parser.add_argument("-H", "--hostfile",
                        help="hosts, one `host` or `host:slots` a line "
                             "(ssh: required; mpi: given to mpirun)")
    parser.add_argument("--port", type=int, default=0,
                        help="rendezvous port (default: a free local port "
                             "for local / mpi, a random 10000-29999 one "
                             "for ssh)")
    parser.add_argument("--coordinator-host", default=None,
                        help="mpi: the address of rank 0's rendezvous")
    parser.add_argument("--ssh-cmd", default="ssh -o StrictHostKeyChecking=no",
                        help="the ssh client command")
    parser.add_argument("--mpi-cmd", default="mpirun",
                        help="the mpi launcher command")
    parser.add_argument("--mpi-flavor", default="openmpi",
                        choices=sorted(_MPI_ENV_FLAG),
                        help="how variables are exported: openmpi `-x VAR`, "
                             "mpich `-genv VAR VAL`, none")
    parser.add_argument("--env", action="append", default=[],
                        help="extra KEY=VAL for every worker")
    parser.add_argument("--compile-cache", nargs="?", const="1",
                        default=None, metavar="DIR",
                        help="not ported (ROADMAP queue 1 item 13)")
    parser.add_argument("--sharded-step", action="store_true",
                        help="not ported (ROADMAP queue 1 item 2)")
    parser.add_argument("--max-restarts", type=int, default=0,
                        help="start the whole group again up to N times "
                             "after a failure, on a fresh port")
    parser.add_argument("--restart-backoff", type=float, default=1.0,
                        help="seconds before the first restart (doubling, "
                             "at most 60; reset after a preemption)")
    parser.add_argument("command", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    if args.command and args.command[0] == "--":
        args.command = args.command[1:]
    if not args.command:
        parser.error("no command given")
    if args.compile_cache is not None:
        parser.error("--compile-cache: the persistent compile tier is not "
                     "ported yet (ROADMAP queue 1 item 13)")
    if args.sharded_step:
        parser.error("--sharded-step: the fused sharded step is not ported "
                     "yet (ROADMAP queue 1 item 2)")
    # a SIGTERM to the launcher takes its workers down first
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(128 + signal.SIGTERM))
    return {"local": _launch_local,
            "ssh": _launch_ssh,
            "mpi": _launch_mpi}[args.launcher](args)


if __name__ == "__main__":
    sys.exit(main())
