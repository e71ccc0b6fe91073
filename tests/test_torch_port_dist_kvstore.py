"""The port's distributed kvstore, its server roles and its launcher, on
the CPU: real processes over gloo, started by ``python -m
mxnet_tpu_torch.launch``.

The workers are this file run as a script (``--worker NAME``); they import
the port only, never JAX. Their checks are `chip_smoke.dist_kv_checks`
and `chip_smoke.dist_trainer_run` (the card's ``dist_kv`` phase runs the
same on card arrays), the port's copies of the JAX package's
``tests/dist_sync_kvstore_worker.py`` and ``tests/dist_trainer_worker.py``:
a dense push, a list push, row_sparse_pull and 2-bit compression with
error feedback summed over the ranks, each equal to the JAX worker's
expectations (rtol 1e-6, as there), and linear regression through
`gluon.Trainer` over a ``dist_sync`` store whose ranks start from other
draws and end bit-identical, within 0.05 of the true weights (the JAX
test's bar). Then the launcher as the JAX package's
``tests/test_dist_kvstore.py`` drives ``tools/launch.py``: a failing rank
fails the launch, the ssh and mpi modes through local shims, restarts on a
fresh port and preemptions, its events; a ``DMLC_ROLE=server`` process
exits 0 at import; ``dist_async`` raises; a missing peer raises
`MXNetError` within ``MXTPU_RENDEZVOUS_TIMEOUT``. Each launch has its own
``timeout=`` and a rendezvous bound of 60 s.
"""
import json
import os
import re
import socket
import subprocess
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RESTARTS = ["--max-restarts", "2", "--restart-backoff", "0.5"]
_TIMEOUT = 240


def _env(**extra):
    env = dict(os.environ)
    env.setdefault("MXTPU_RENDEZVOUS_TIMEOUT", "60")
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    for k in ("MXTPU_NUM_WORKERS", "MXTPU_PROCESS_ID", "MXTPU_COORDINATOR",
              "DMLC_ROLE", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    env.update(extra)
    return env


def _launch(args, command, timeout=_TIMEOUT, **env):
    proc = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.launch"] + args + ["--"]
        + command, cwd=_ROOT, env=_env(**env), capture_output=True,
        text=True, timeout=timeout)
    return proc.returncode, proc.stdout + proc.stderr


def _worker(name):
    return [sys.executable, os.path.abspath(__file__), "--worker", name]


def _port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("n", [2, 3])
def test_dist_sync_kvstore_numerics(n):
    rc, out = _launch(["-n", str(n)] + _RESTARTS, _worker("kv"))
    assert rc == 0, out[-4000:]
    for r in range(n):
        assert "DIST_KV_OK rank=%d/%d" % (r, n) in out, out[-4000:]


def test_dist_trainer_ranks_end_bit_identical():
    rc, out = _launch(["-n", "2"] + _RESTARTS, _worker("trainer"))
    assert rc == 0, out[-4000:]
    found = dict(re.findall(r"DIST_TRAINER_OK rank=(\d)/2 w=(\S+)", out))
    assert set(found) == {"0", "1"}, out[-4000:]
    assert found["0"] == found["1"], "ranks diverged: %s" % found


def test_launch_propagates_failure():
    rc, out = _launch(["-n", "2"], [sys.executable, "-c",
                                    "import sys; sys.exit(3)"], timeout=120)
    assert rc == 3, out
    # rank 1 fails while rank 0 would sleep for minutes: the launcher
    # takes rank 0 down and returns rank 1's code
    rc, out = _launch(["-n", "2"], [
        sys.executable, "-c",
        "import os, sys, time\n"
        "if os.environ['MXTPU_PROCESS_ID'] == '1': sys.exit(5)\n"
        "time.sleep(600)"], timeout=120, MXTPU_TEARDOWN_GRACE="2")
    assert rc == 5, out
    assert "tearing down 1 live worker" in out, out


def test_launch_restarts_preemptions_and_events(tmp_path):
    """A failed generation restarts on a fresh port (the generation in
    MXTPU_RESTART_GENERATION), a preemption code restarts without using
    the budget, and the events land in launcher-events.jsonl."""
    # each rank waits for both ranks' marks before it ends its generation,
    # so a rank that exits first cannot have the other torn down before it
    # printed its line
    script = ("import os, sys, time\n"
              "g = int(os.environ['MXTPU_RESTART_GENERATION'])\n"
              "print('GEN', g, os.environ['MXTPU_COORDINATOR'], flush=True)\n"
              "mark = os.path.join(%r, 'g%%d-r%%s')\n"
              "open(mark %% (g, os.environ['MXTPU_PROCESS_ID']), 'w').close()\n"
              "t0 = time.time()\n"
              "while time.time() - t0 < 60 and not all(\n"
              "        os.path.exists(mark %% (g, r)) for r in (0, 1)):\n"
              "    time.sleep(0.01)\n"
              "sys.exit({0: 83, 1: 4}.get(g, 0))\n" % str(tmp_path))
    rc, out = _launch(["-n", "2", "--max-restarts", "1",
                       "--restart-backoff", "0"],
                      [sys.executable, "-c", script], timeout=120,
                      MXTPU_TELEMETRY_DIR=str(tmp_path))
    assert rc == 0, out
    gens = re.findall(r"\[rank 0\] GEN (\d) (\S+)", out)
    assert [g for g, _ in gens] == ["0", "1", "2"], out
    events = [json.loads(line)["event"] for line in
              (tmp_path / "launcher-events.jsonl").read_text().splitlines()]
    assert events.count("launcher_generation_start") == 3
    assert "preempt" in events and "launcher_restart" in events
    assert "launcher_downtime" in events
    # no budget: the failure is final
    rc, out = _launch(["-n", "1"], [sys.executable, "-c", script],
                      timeout=120)
    assert rc == 83, out


def test_launch_refuses_unported_flags():
    for flag, item in (("--compile-cache", "item 13"),
                       ("--sharded-step", "item 2")):
        rc, out = _launch(["-n", "1", flag], [sys.executable, "-c", "0"],
                          timeout=120)
        assert rc == 2 and item in out, out


def test_launch_ssh_mode(tmp_path):
    """--launcher ssh through a local ssh shim that drops the host and runs
    the remote command here: the hostfile, the environment inline and the
    quoting, with the kvstore workers."""
    shim = tmp_path / "fake-ssh"
    shim.write_text("#!/bin/sh\n# $1=host, $2=remote command string\n"
                    "shift\nexec /bin/sh -c \"$1\"\n")
    shim.chmod(0o755)
    hostfile = tmp_path / "hosts"
    hostfile.write_text("# two slots on one 'machine'\n127.0.0.1:2\n")
    rc, out = _launch(["-n", "2", "--launcher", "ssh", "-H", str(hostfile),
                       "--port", str(_port()), "--ssh-cmd", str(shim)]
                      + _RESTARTS, _worker("kv"))
    assert rc == 0, out[-4000:]
    for r in range(2):
        assert "DIST_KV_OK rank=%d/2" % r in out, out[-4000:]


def test_launch_mpi_mode(tmp_path):
    """--launcher mpi through a local mpirun shim that starts -np copies
    with OMPI_COMM_WORLD_RANK / SIZE set: the ranks come from those, not
    from MXTPU_PROCESS_ID."""
    shim = tmp_path / "fake-mpirun"
    shim.write_text("""#!%s
import os, subprocess, sys
args = sys.argv[1:]
np_ = 0
cmd = []
i = 0
while i < len(args):
    if args[i] == "-np":
        np_ = int(args[i + 1]); i += 2
    elif args[i] in ("-x", "--hostfile"):
        i += 2
    else:
        cmd = args[i:]; break
procs = []
for r in range(np_):
    env = dict(os.environ)
    assert "MXTPU_PROCESS_ID" not in env
    env["OMPI_COMM_WORLD_RANK"] = str(r)
    env["OMPI_COMM_WORLD_SIZE"] = str(np_)
    procs.append(subprocess.Popen(cmd, env=env))
sys.exit(max(p.wait() for p in procs))
""" % sys.executable)
    shim.chmod(0o755)
    rc, out = _launch(["-n", "2", "--launcher", "mpi", "--mpi-cmd",
                       str(shim), "--coordinator-host", "127.0.0.1",
                       "--port", str(_port())] + _RESTARTS, _worker("kv"))
    assert rc == 0, out[-4000:]
    for r in range(2):
        assert "DIST_KV_OK rank=%d/2" % r in out, out[-4000:]


@pytest.mark.parametrize("role", ["server", "scheduler"])
def test_server_role_exits_zero(role):
    """A reference launch script's server and scheduler processes exit 0
    at import and never reach the script's body."""
    proc = subprocess.run(
        [sys.executable, "-c", "import mxnet_tpu_torch\nprint('BODY')\n"
         "raise SystemExit(7)"], cwd=_ROOT, env=_env(DMLC_ROLE=role),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BODY" not in proc.stdout
    proc = subprocess.run(
        [sys.executable, "-c", "import mxnet_tpu_torch\nprint('BODY')"],
        cwd=_ROOT, env=_env(DMLC_ROLE="worker"), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0 and "BODY" in proc.stdout


def test_dist_async_raises_and_one_process_is_rank_0():
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.base import MXNetError

    with pytest.raises(MXNetError, match="dist_async is not supported"):
        mx.kv.create("dist_async")
    kv = mx.kv.create("dist_sync")
    assert (kv.rank, kv.num_workers, kv.type) == (0, 1, "dist_sync")
    with mx.cpu():
        kv.init(0, mx.nd.ones((2,)))
        kv.push(0, [mx.nd.ones((2,)), mx.nd.ones((2,))])
        out = mx.nd.zeros((2,))
        kv.pull(0, out=out)
    assert out.asnumpy().tolist() == [2.0, 2.0]
    kv.barrier()


def test_missing_peer_raises_within_the_rendezvous_timeout():
    code = ("import mxnet_tpu_torch as mx\n"
            "from mxnet_tpu_torch.base import MXNetError\n"
            "try:\n"
            "    mx.kv.create('dist_sync')\n"
            "except MXNetError as e:\n"
            "    print('RAISED', e)\n")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=_ROOT, capture_output=True,
        text=True, timeout=120, env=_env(
            MXTPU_NUM_WORKERS="2", MXTPU_PROCESS_ID="0",
            MXTPU_COORDINATOR="127.0.0.1:%d" % _port(),
            MXTPU_RENDEZVOUS_TIMEOUT="3"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "RAISED distributed rendezvous failed" in proc.stdout, \
        proc.stdout + proc.stderr


# -- the workers ------------------------------------------------------------

def _run_worker(name):
    sys.path.insert(0, _ROOT)
    import hashlib

    import chip_smoke
    import mxnet_tpu_torch as mx

    if name == "kv":
        r, n = chip_smoke.dist_kv_checks(mx, mx.cpu())
        print("DIST_KV_OK rank=%d/%d" % (r, n), flush=True)
    elif name == "trainer":
        w, err = chip_smoke.dist_trainer_run(mx, mx.cpu())
        kv = mx.kv.create("dist_sync")
        assert err < 0.05, "rank %d did not converge: %g" % (kv.rank, err)
        print("DIST_TRAINER_OK rank=%d/%d w=%s"
              % (kv.rank, kv.num_workers,
                 hashlib.sha256(w.tobytes()).hexdigest()), flush=True)
    else:
        raise SystemExit("unknown worker %r" % name)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        _run_worker(sys.argv[2])
