"""Replica pools of the port under faults, on the CPU (processes).

The JAX package's chaos runs (`tests/test_serving.py`) on the port's pools
of ``--stub echo`` replicas (``--device cpu`` from the test's
``context.scope(cpu())``): ``kill_replica`` and ``wedge_replica`` under a
closed-loop workload, an unauthenticated connection, ``slow_reply``; and
``python -m mxnet_tpu_torch.serving --replicas 2`` draining on SIGTERM and
leaving no replica process behind. The timeouts are longer than the JAX
test's, which flakes when the machine is loaded.
"""
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.gluon.model_zoo.transformer import lm_mini
from mxnet_tpu_torch.serving import (DeadlineExceededError, ModelRepository,
                                     ServedModel, ServingServer, save_lm)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB = ["--stub", "echo", "--input", "x=2", "--max-batch", "4"]


def _post(url, body, timeout=30):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _wait(cond, timeout):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.05)
    return cond()


def test_pool_survives_kill_and_wedge_under_load():
    """Two stub replicas under ``kill_replica@batch=3,replica=0
    wedge_replica@batch=5,replica=1`` serve four closed-loop clients: no
    500, every 200 correct, at least 20 of them; both replicas ejected
    (one died, one wedged) and respawned; the pool back at full health."""
    reg = telemetry.get_registry()
    labels = {"model": "chaos/1"}
    failovers = reg.counter("mxtpu_serve_failover_total", labels)
    requeued = reg.counter("mxtpu_serve_failover_requeued_total", labels)
    restarts = reg.counter("mxtpu_serve_replica_restart_total", labels)
    base = (failovers.value, requeued.value, restarts.value)
    with mx.context.scope(mx.cpu()):
        model = ServedModel.pooled(
            "chaos", 1, None, 2, worker_args=STUB, heartbeat_ms=250,
            backoff_ms=50, teardown_grace=1.0, spawn_timeout_s=120,
            max_delay_ms=2, queue_depth=64, wedge_timeout_ms=2500,
            extra_env={"MXTPU_FAULT_INJECT":
                       "kill_replica@batch=3,replica=0 "
                       "wedge_replica@batch=5,replica=1"})
    repo = ModelRepository()
    repo.add(model)
    srv = ServingServer(repo, port=0, addr="127.0.0.1").start()
    url = "http://127.0.0.1:%d/v1/models/chaos:predict" % srv.port
    lock = threading.Lock()
    codes, bad = {}, []

    def client(tid, n_requests=10):
        for i in range(n_requests):
            x = float(tid * 100 + i)
            try:
                code, resp = _post(url, {"inputs": {"x": [[x, x]]},
                                         "timeout_ms": 4000})
                ok = resp["outputs"][0][0] == [2 * x, 2 * x]
            except urllib.error.HTTPError as e:
                e.read()
                code, ok = e.code, True  # a deterministic rejection
            with lock:
                codes[code] = codes.get(code, 0) + 1
                if not ok:
                    bad.append((tid, i))

    try:
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(240)
        assert not any(t.is_alive() for t in threads)
        assert not bad, bad
        assert set(codes) <= {200, 429, 503, 504}, codes
        assert codes.get(200, 0) >= 20, codes
        assert _wait(lambda: restarts.value - base[2] >= 2
                     and model.pool.healthy_count == 2, 120)
        assert failovers.value - base[0] >= 1
        assert 1 <= requeued.value - base[1] <= sum(codes.values())
        ring = [dict(e["fields"], event=e["event"])
                for e in telemetry.events()
                if e["fields"].get("model") == "chaos/1"]
        ejects = [e for e in ring if e["event"] == "serve_replica_eject"]
        assert {e["replica"] for e in ejects} == {0, 1}, ejects
        assert any(e["reason"] in ("died_mid_batch", "died")
                   for e in ejects), ejects
        assert any(e["reason"] in ("wedged", "heartbeat_missed")
                   for e in ejects), ejects
        respawns = [e for e in ring if e["event"] == "serve_replica_ready"
                    and e["generation"] >= 1]
        assert len(respawns) >= 2, ring
        desc = model.pool.describe()
        assert desc["healthy"] == 2, desc
        assert all(g >= 1 for g in desc["generations"].values()), desc
        assert telemetry.snapshot()[
            'mxtpu_serve_pool_healthy{model="chaos/1"}']["value"] == 2
        code, resp = _post(url, {"inputs": {"x": [[7.0, 7.0]]},
                                 "timeout_ms": 10000})
        assert code == 200 and resp["outputs"][0][0] == [14.0, 14.0]
    finally:
        srv.shutdown()
        model.close(drain=False, timeout=0)


def test_unauthenticated_connection_dropped_and_slow_reply_cancels():
    """The listener reads nothing from a connection without the pool's
    secret; a replica that wakes past a batch's deadline answers
    ``expired`` (504) and is not ejected."""
    restarts = telemetry.get_registry().counter(
        "mxtpu_serve_replica_restart_total", {"model": "slowauth/1"})
    with mx.context.scope(mx.cpu()):
        model = ServedModel.pooled(
            "slowauth", 1, None, 1,
            worker_args=["--stub", "echo", "--input", "x=1",
                         "--max-batch", "2"],
            heartbeat_ms=400, backoff_ms=50, teardown_grace=1.0,
            spawn_timeout_s=120, max_delay_ms=1, queue_depth=8,
            extra_env={"MXTPU_FAULT_INJECT": "slow_reply@batch=1,ms=300"})
    try:
        addr = model.pool._listener.getsockname()
        s = socket.create_connection(addr, timeout=10)
        s.sendall(b"X" * 32 + b"\x00\x00\x00\x04evil")
        s.settimeout(10)
        try:
            assert s.recv(1) == b""   # closed, nothing unpickled
        except ConnectionResetError:
            pass                      # closed with our frame unread
        s.close()
        # batch 1: the 300 ms injected sleep overruns a 150 ms deadline
        with pytest.raises(DeadlineExceededError):
            model.predict({"x": np.ones((1, 1), np.float32)},
                          timeout_ms=150)
        # batch 2: the same replica and generation answer
        out = model.predict({"x": np.full((1, 1), 3.0, np.float32)},
                            timeout_ms=10000)
        assert np.all(out[0] == 6.0)
        assert restarts.value == 0
        assert model.pool.describe()["generations"] == {0: 0}
    finally:
        model.close(drain=False, timeout=0)


def _children(pid):
    """Pids whose parent is ``pid`` (read from /proc)."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open("/proc/%s/stat" % d) as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid:
            out.append(int(d))
    return out


def _gone(pid):
    try:
        os.killpg(pid, 0)
    except ProcessLookupError:
        return True
    return False


def test_serving_module_with_replicas_drains_on_sigterm(tmp_path):
    """``python -m mxnet_tpu_torch.serving --replicas 2 --device cpu``
    answers through its pool, exits 0 after a SIGTERM drain, and leaves no
    replica process group behind."""
    lm = lm_mini(vocab_size=96, device="cpu").initialize(3)
    prefix = save_lm(lm, str(tmp_path / "lm"))
    env = dict(os.environ, PYTHONPATH=_ROOT, OMP_NUM_THREADS="1",
               MXTPU_SERVE_KV_PAGES="32",
               MXTPU_SERVE_KV_PAGE_SIZE="4", MXTPU_SERVE_MAX_PROMPT="8",
               MXTPU_SERVE_MAX_NEW_TOKENS="12", MXTPU_SERVE_MAX_BATCH="4")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.serving", "--model",
         "lm=%s@generate" % prefix, "--port", "0", "--addr", "127.0.0.1",
         "--device", "cpu", "--replicas", "2"],
        env=env, stderr=subprocess.PIPE, text=True)
    replicas = []
    try:
        port = None
        for line in proc.stderr:
            m = re.search(r"on 127\.0\.0\.1:(\d+)", line)
            if m:
                port = int(m.group(1))
                break
        assert port, "server never reported its port"
        code, resp = _post("http://127.0.0.1:%d/v1/models/lm:generate"
                           % port, {"tokens": [2, 7], "max_new_tokens": 4})
        assert code == 200 and len(resp["tokens"]) == 4
        with urllib.request.urlopen("http://127.0.0.1:%d/v1/models/lm"
                                    % port, timeout=30) as r:
            desc = json.loads(r.read())
        assert desc["pool"]["replicas"] == 2
        assert desc["pool"]["healthy"] == 2
        replicas = _children(proc.pid)
        assert len(replicas) == 2, replicas
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err[-2000:]
        assert "drained; bye" in err
        assert _wait(lambda: all(_gone(p) for p in replicas), 30), replicas
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
        for p in replicas:
            if not _gone(p):
                os.killpg(p, signal.SIGKILL)
