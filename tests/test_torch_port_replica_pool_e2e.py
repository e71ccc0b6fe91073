"""Replica pools of the port on the CPU, against the JAX package (processes).

Each pool's replicas are processes of ``python -m
mxnet_tpu_torch.serving.replica_worker`` started with ``--device cpu``,
the device the test's ``context.scope(cpu())`` gives the pool; they import
the port only. Here: a generation pool serving an LM the JAX package saved,
token for token against the JAX one-request greedy oracle, before and after
a replica is killed; a predict pool serving a block the JAX package
exported, against the JAX `Predictor`; one traced request whose spans from
three processes merge into one timeline; and the refusal to build a pool
with no card and no CPU scope. The stub chaos runs are in
`test_torch_port_replica_pool_chaos.py`.
"""
import importlib.util
import json
import os
import signal
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo.transformer import lm_mini as jax_lm_mini
from mxnet_tpu.predict import Predictor as JaxPredictor
from mxnet_tpu.serving import save_lm as jax_save_lm
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import (ModelRepository, ServedModel,
                                     ServingServer)
from mxnet_tpu_torch.serving.replica_pool import ReplicaPool
from mxnet_tpu_torch.telemetry import tracing

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one intra-op thread a replica: the suite runs several files at once, and
# these tiny models gain nothing from more
ONE_THREAD = {"OMP_NUM_THREADS": "1"}
POOL = dict(heartbeat_ms=500, backoff_ms=50, teardown_grace=1.0,
            spawn_timeout_s=120)
# max_batch 2: a replica decodes two sequences at a time and queues the
# rest, so a replica killed after the first reply still holds work
GEOM = dict(num_pages=32, page_size=4, max_prompt=8, max_new_tokens=16,
            max_batch=2)
PROMPTS = [[3, 5, 7], [2], [9, 4, 6, 1, 8], [1, 2, 3, 4], [8, 8], [5],
           [7, 6, 5, 4, 3], [1]]
BUDGETS = [5, 9, 3, 7, 4, 8, 6, 2]


def _jax_greedy(lm, prompt, n):
    """The JAX one-request greedy oracle: one whole forward a token."""
    toks, out = list(prompt), []
    for _ in range(n):
        logits = lm(jmx.nd.array([toks], dtype="int32")).asnumpy()[0, -1]
        t = int(np.argmax(logits))
        out.append(t)
        toks.append(t)
    return out


@pytest.fixture(scope="module")
def jax_lm_artifact(tmp_path_factory):
    lm = jax_lm_mini(vocab_size=96)
    lm.initialize(jmx.init.Xavier())
    prefix = jax_save_lm(lm, str(tmp_path_factory.mktemp("jaxlm") / "lm"))
    oracles = [_jax_greedy(lm, p, n) for p, n in zip(PROMPTS, BUDGETS)]
    return prefix, oracles


def _post(url, body, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read()), dict(r.headers)


def _run_clients(url, on_first_reply=None):
    """Six clients at once and two late joiners; ``on_first_reply`` runs
    once, in the thread that got the first reply."""
    results = [None] * len(PROMPTS)
    first = threading.Lock()
    fired = []

    def client(i, delay=0.0):
        if delay:
            time.sleep(delay)
        _, results[i], _ = _post(url, {"tokens": PROMPTS[i],
                                       "max_new_tokens": BUDGETS[i],
                                       "timeout_ms": 120000})
        if on_first_reply is not None:
            with first:
                if not fired:
                    fired.append(i)
                    on_first_reply()

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    threads += [threading.Thread(target=client, args=(i, 0.15))
                for i in (6, 7)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(240)
    assert not any(t.is_alive() for t in threads)
    return results


def _wait(cond, timeout):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.05)
    return cond()


def test_lm_pool_equals_jax_greedy_with_and_without_a_kill(jax_lm_artifact):
    prefix, oracles = jax_lm_artifact
    labels = {"model": "poollm/1"}
    reg = telemetry.get_registry()
    failovers = reg.counter("mxtpu_serve_failover_total", labels)
    restarts = reg.counter("mxtpu_serve_replica_restart_total", labels)
    repo = ModelRepository()
    with mx.context.scope(mx.cpu()):
        model = repo.load("poollm", prefix, generate=True, replicas=2,
                          generate_opts=GEOM, extra_env=ONE_THREAD, **POOL)
    srv = ServingServer(repo, port=0, addr="127.0.0.1").start()
    url = "http://127.0.0.1:%d/v1/models/poollm:generate" % srv.port
    pool = model.pool
    try:
        desc = model.describe()
        assert desc["pool"]["mode"] == "generate"
        assert desc["meta"]["device"] == "cpu"
        assert model.generate_info["max_prompt"] == GEOM["max_prompt"]
        clean = _run_clients(url)
        assert [r["tokens"] for r in clean] == oracles
        assert all(r["finish_reason"] == "length" for r in clean)
        assert (failovers.value, restarts.value) == (0, 0)

        victim = []

        def kill_busiest():
            busy = {r: reg.gauge("mxtpu_serve_replica_inflight",
                                 {"model": "poollm/1",
                                  "replica": str(r)}).value
                    for r in pool.replica_ids()}
            rid = max(busy, key=busy.get)
            victim.append((rid, busy[rid]))
            os.killpg(pool.replica_pid(rid), signal.SIGKILL)

        chaos = _run_clients(url, on_first_reply=kill_busiest)
        assert [r["tokens"] for r in chaos] == oracles
        (rid, held), = victim
        assert held >= 1
        assert _wait(lambda: pool.healthy_count == 2, 120)
        assert failovers.value >= 1 and restarts.value == 1
        assert pool.describe()["generations"][rid] == 1
        ejects = [e["fields"] for e in telemetry.events()
                  if e["event"] == "serve_replica_eject"
                  and e["fields"].get("model") == "poollm/1"]
        assert [e["replica"] for e in ejects] == [rid]
        for r in pool.replica_ids():
            s = pool.replica_stats(r, timeout=30)
            assert s is not None, r
            assert (s["kv_pages_used"], s["pending"], s["jit_after_warm"],
                    s["launches"], s["warm_launches"],
                    s["max_memory_allocated"]) == (0, 0, 0, 0, 0, None), s
    finally:
        srv.shutdown()
        assert repo.unload("poollm", timeout=30)
    assert not any(s.proc.alive() for s in pool._slots)


def test_predict_pool_equals_jax_predictor(tmp_path):
    """A HybridBlock the JAX package exported, served by a port pool of 2:
    every row within 1e-5 of the JAX Predictor (f32)."""
    net = jgluon.nn.HybridSequential()
    net.add(jgluon.nn.Dense(16, activation="relu"), jgluon.nn.Dense(3))
    net.initialize(jmx.init.Xavier())
    net.hybridize()
    net(jmx.nd.zeros((1, 5)))
    prefix = str(tmp_path / "blk")
    net.export(prefix, epoch=0)
    x = np.random.RandomState(0).uniform(-1, 1, (12, 5)).astype(np.float32)
    ref = JaxPredictor(prefix + "-symbol.json", prefix + "-0000.params",
                       input_shapes={"data": (12, 5)})
    want = ref.forward(data=x).get_output(0).asnumpy()
    repo = ModelRepository()
    with mx.context.scope(mx.cpu()):
        model = repo.load("blk", prefix, input_shapes={"data": (5,)},
                          max_batch=4, replicas=2, max_delay_ms=2,
                          extra_env=ONE_THREAD, **POOL)
    try:
        assert model.buckets == [1, 2, 4] and model.warmed
        assert model.describe()["pool"]["healthy"] == 2
        got = [None] * 6

        def one(i):
            got[i] = model.predict({"data": x[2 * i:2 * i + 2]},
                                   timeout_ms=60000)[0]

        threads = [threading.Thread(target=one, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        np.testing.assert_allclose(np.concatenate(got), want, rtol=0,
                                   atol=1e-5)
    finally:
        assert repo.unload("blk", timeout=30)


def _load_trace_merge():
    spec = importlib.util.spec_from_file_location(
        "trace_merge", os.path.join(_ROOT, "tools", "trace_merge.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def clean_tracing():
    tracing.configure()
    tracing.set_collector(None)
    tracing.drain_pending()
    yield tracing
    tracing.configure()
    tracing.set_collector(None)
    tracing.drain_pending()


def test_one_request_traced_across_three_processes(clean_tracing, tmp_path):
    """One request through a 2-replica stub pool: the server's and the
    router's spans (this process) and the worker's compute span (a replica
    process, from its JSONL) share one trace id and merge through
    `tools/trace_merge.py` into one timeline with three lanes."""
    tdir = str(tmp_path / "tm")
    tracing.configure(sample=1.0)
    collected = []
    tracing.set_collector(collected.append)
    with mx.context.scope(mx.cpu()):
        model = ServedModel.pooled(
            "traced", 1, None, 2,
            worker_args=["--stub", "echo", "--input", "x=2",
                         "--max-batch", "4"],
            max_delay_ms=2, queue_depth=16,
            extra_env=dict(ONE_THREAD, MXTPU_TELEMETRY_DIR=tdir,
                           MXTPU_TELEMETRY_FLUSH_S="0.25"), **POOL)
    repo = ModelRepository()
    repo.add(model)
    srv = ServingServer(repo, port=0, addr="127.0.0.1").start()
    try:
        url = "http://127.0.0.1:%d/v1/models/traced:predict" % srv.port
        code, resp, headers = _post(url, {"inputs": {"x": [[3.0, 4.0]]},
                                          "timeout_ms": 10000})
        assert code == 200 and resp["outputs"][0][0] == [6.0, 8.0]
        hdr = {k.lower(): v for k, v in headers.items()}[tracing.HEADER]
        tid = tracing.parse_header(hdr).trace_id
        assert _wait(lambda: any(s["name"] == "serve.request"
                                 and s["trace"] == tid for s in collected),
                     10)
        local = {s["name"]: s for s in collected if s["trace"] == tid}
        assert {"serve.request", "serve.queue", "serve.assembly",
                "serve.dispatch", "serve.unpad"} <= set(local), sorted(local)

        worker_spans = []

        def read_worker_spans():
            for fname in (os.listdir(tdir) if os.path.isdir(tdir) else []):
                with open(os.path.join(tdir, fname)) as f:
                    for line in f:
                        rec = json.loads(line)
                        if rec.get("kind") == "span" \
                                and rec.get("trace") == tid:
                            worker_spans.append(rec)
            return bool(worker_spans)

        assert _wait(read_worker_spans, 30), "no worker span flushed"
        compute = worker_spans[0]
        assert compute["name"] == "serve.compute"
        assert compute["component"] == "worker"
        root = local["serve.request"]
        assert root["parent"] is None and root["component"] == "server"
        for name in ("serve.queue", "serve.assembly", "serve.dispatch",
                     "serve.unpad"):
            assert local[name]["parent"] == root["span"], name
            assert local[name]["component"] == "router"
        assert compute["parent"] == local["serve.dispatch"]["span"]
        assert compute["pid"] != root["pid"] == os.getpid()

        assert telemetry.flush(tdir)   # the server's and router's spans
        tm = _load_trace_merge()
        out = str(tmp_path / "merged.json")
        files = [os.path.join(tdir, f) for f in os.listdir(tdir)
                 if f.endswith(".jsonl")]
        assert tm.main(files + ["-o", out, "--trace", tid]) == 0
        with open(out) as f:
            xs = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
        assert len(xs) >= 6
        assert {e["args"]["trace"] for e in xs} == {tid}
        assert {e["cat"] for e in xs} >= {"server", "router", "worker"}
        assert len({e["pid"] for e in xs}) >= 3
    finally:
        srv.shutdown()
        model.close(drain=False, timeout=0)


def test_pool_without_a_card_or_a_cpu_scope_raises(monkeypatch, tmp_path):
    """The pool resolves its workers' device before any process starts:
    no card and no CPU scope raises, and nothing was spawned."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spawned = []
    monkeypatch.setattr("subprocess.Popen",
                        lambda *a, **k: spawned.append(a))
    with pytest.raises(MXNetError, match="no CUDA device"):
        ReplicaPool("nocard/1", ["--stub", "echo", "--input", "x=1"], 2)
    with pytest.raises(MXNetError, match="no CUDA device"):
        ServedModel.pooled("nocard", 1, None, 1,
                           worker_args=["--stub", "echo", "--input", "x=1"])
    repo = ModelRepository()
    with pytest.raises(MXNetError, match="no CUDA device"):
        repo.load("nocard", str(tmp_path / "lm"), generate=True, replicas=2)
    assert spawned == [] and repo.names() == []
