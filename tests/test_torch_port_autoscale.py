"""The port's autoscaler against the JAX package's, and elastic pools on
the CPU.

1. One scripted verdict sequence drives ``Autoscaler.evaluate_once(now=,
   verdicts=)`` over the same fake pool and repository in both packages:
   both take the same decisions (up after ``up_windows`` breached laps,
   the cooldown, ``blocked`` by the memory budget once an episode, idle
   down never below ``min_replicas``, ``blocked`` at ``max_replicas``).
2. The chaos end to end on stub-echo workers (processes of ``python -m
   mxnet_tpu_torch.serving.replica_worker --device cpu``): a
   ``load_surge`` against a 1-replica pool breaches its p99 objective,
   the autoscaler grows the pool in place, the verdict recovers, and idle
   drains it back to 1, with no 5xx and every request answered.
3. A pooled tiny LM (``lm_mini``: 2 layers, width 32, saved by the JAX
   package) grown 1 -> 2 by the autoscaler: its greedy replies equal the
   JAX one-request oracle before and after the growth, and the added
   replica serves.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.base import MXNetError as JaxError
from mxnet_tpu.gluon.model_zoo.transformer import lm_mini as jax_lm_mini
from mxnet_tpu.serving import Autoscaler as JaxAutoscaler
from mxnet_tpu.serving import ModelRepository as JaxRepository
from mxnet_tpu.serving import save_lm as jax_save_lm
from mxnet_tpu.telemetry import core as jcore
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.base import MXNetError as PortError
from mxnet_tpu_torch.parallel import resilience
from mxnet_tpu_torch.serving import (Autoscaler, ModelRepository,
                                     ServedModel, ServingServer)
from mxnet_tpu_torch.telemetry import core as pcore
from mxnet_tpu_torch.telemetry import slo

POOL = dict(heartbeat_ms=500, backoff_ms=50, teardown_grace=1.0,
            spawn_timeout_s=120, extra_env={"OMP_NUM_THREADS": "1"})


# ---------------------------------------------------------------------------
# 1. decisions against the JAX package's
# ---------------------------------------------------------------------------

class _Pool:
    def __init__(self, size, error):
        self.size = size
        self._error = error

    def add_replica(self):
        self.size += 1
        return self.size - 1

    def remove_replica(self, replica_id=None, drain=True, timeout=None,
                       floor=1):
        assert drain
        if self.size <= max(1, floor):
            raise self._error("cannot shrink below floor")
        self.size -= 1
        return self.size


class _Model:
    def __init__(self, error, loaded_at):
        self.name, self.version = "fa", 1
        self.pool = _Pool(1, error)
        self.memory_bytes = 1000
        self.min_replicas = 1
        self.max_replicas = 3
        self.pinned = False
        self.loaded_at = loaded_at

    @property
    def resident_copies(self):
        return self.pool.size

    @property
    def effective_memory_bytes(self):
        return self.memory_bytes * self.pool.size

    def pending(self):
        return 0

    def close(self, drain=True, timeout=None):
        return True


def _script(t0):
    """(now, paging?, budget) laps: two breaches scale up; the cooldown
    holds the next; the budget blocks the third replica once an episode;
    calm idle drains to the floor; a larger budget grows to the ceiling,
    where the breach is blocked."""
    laps = [(0, True, "2500"), (1, False, "2500"), (2, True, "2500"),
            (3, True, "2500"), (4, True, "2500"), (5, True, "2500"),
            (9, True, "2500"), (10, True, "2500"), (11, True, "2500"),
            (12, False, "2500"), (13, False, "2500"), (20, True, "10000"),
            (21, True, "10000"), (27, True, "10000"), (28, True, "10000"),
            (34, True, "10000"), (35, True, "10000"), (36, True, "10000")]
    return [(t0 + k, page, budget) for k, page, budget in laps]


def _decide(core, repo_cls, scaler_cls, error, t0, monkeypatch):
    monkeypatch.setattr(core, "_REGISTRY", core.Registry())
    monkeypatch.setattr(core, "_STATE", core._State())
    repo = repo_cls()
    model = _Model(error, t0 - 100.0)
    repo.add(model)
    asc = scaler_cls(repo, interval_ms=100, up_windows=2, idle_s=30.0,
                     cooldown_s=5.0, start=False)
    trail = []
    for now, page, budget in _script(t0):
        monkeypatch.setenv("MXTPU_SERVE_MEMORY_BUDGET", budget)
        verdicts = [{"slo": "serve-p99:fa/1", "page": page,
                     "labels": {"model": "fa/1"}},
                    {"slo": "serve-p99:other/1", "page": True,
                     "labels": {"model": "other/1"}}]
        for d in asc.evaluate_once(now=now, verdicts=verdicts):
            trail.append(dict(d))
        trail.append(("size", now - t0, model.pool.size))
    described = asc.describe()
    return trail, {k: v for k, v in described.items() if k != "models"}


def test_decisions_equal_jax(monkeypatch):
    t0 = time.time()
    want = _decide(jcore, JaxRepository, JaxAutoscaler, JaxError, t0,
                   monkeypatch)
    got = _decide(pcore, ModelRepository, Autoscaler, PortError, t0,
                  monkeypatch)
    assert got == want
    actions = [(d["action"], d.get("reason"), d["ts"] - t0)
               for d in got[0] if isinstance(d, dict)]
    assert actions == [("up", None, 3), ("blocked", "memory_budget", 9),
                       ("down", "idle", 12), ("up", None, 21),
                       ("up", None, 28), ("blocked", "max_replicas", 35)]


# ---------------------------------------------------------------------------
# 2. the chaos end to end on stub workers
# ---------------------------------------------------------------------------

def _post(url, body, timeout=20):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _wait(cond, timeout):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.05)
    return cond()


@pytest.fixture
def slo_cadence(monkeypatch):
    """Windows of a fraction of a second, so breach and recovery fit in
    seconds; a fresh evaluator picks the cadence up."""
    monkeypatch.setenv("MXTPU_SLO", "1")
    monkeypatch.setenv("MXTPU_SLO_WINDOW_MS", "200")
    monkeypatch.setenv("MXTPU_SLO_EVAL_MS", "150")
    monkeypatch.setenv("MXTPU_SLO_FAST_WINDOWS", "2")
    monkeypatch.setenv("MXTPU_SLO_SLOW_WINDOW_S", "30")
    monkeypatch.setenv("MXTPU_SLO_SERVE_P99_MS", "400")
    monkeypatch.delenv("MXTPU_SERVE_MEMORY_BUDGET", raising=False)
    slo.stop()
    yield
    slo.stop()


def test_surge_scales_up_recovers_and_drains_back(slo_cadence,
                                                  monkeypatch):
    # open loop 250 requests/s for 2 s against one replica that takes 40
    # ms a batch of up to 4 (~100 requests/s): queue and p99 breach
    monkeypatch.setenv("MXTPU_FAULT_INJECT",
                       "load_surge@after=0,rps=250,duration=2")
    monkeypatch.setattr(resilience, "_fault_cache", resilience._UNPARSED)
    monkeypatch.setenv("MXTPU_SERVE_TIMEOUT_MS", "3000")
    with mx.context.scope(mx.cpu()):
        model = ServedModel.pooled(
            "elastic", 1, None, 1,
            worker_args=["--stub", "echo", "--input", "x=2", "--max-batch",
                         "4", "--stub-delay-ms", "40"],
            queue_depth=64, max_delay_ms=1, **POOL)
    model.min_replicas, model.max_replicas = 1, 3
    repo = ModelRepository()
    srv = ServingServer(repo, port=0, addr="127.0.0.1").start()
    asc = srv.attach_autoscaler(Autoscaler(
        repo, interval_ms=250, up_windows=2, idle_s=2.0, cooldown_s=1.0))
    url = "http://127.0.0.1:%d" % srv.port
    pool = model.pool
    codes, bad, lock = {}, [], threading.Lock()

    def client(tid, n=12):
        for i in range(n):
            x = float(tid * 100 + i)
            try:
                code, resp = _post(url + "/v1/models/elastic:predict",
                                   {"inputs": {"x": [[x, x]]},
                                    "timeout_ms": 3000})
                ok = resp["outputs"][0][0] == [2 * x, 2 * x]
            except urllib.error.HTTPError as e:
                e.read()
                code, ok = e.code, True   # a deterministic rejection
            with lock:
                codes[code] = codes.get(code, 0) + 1
                if not ok:
                    bad.append((tid, i))
            # the clients outlast the 2 s surge, which fills the queue
            time.sleep(0.3)

    try:
        repo.add(model)   # the publish arms the surge
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(3)]
        for t in threads:
            t.start()
        # the pool grows before the decision lands in the trail
        assert _wait(lambda: any(d["action"] == "up" for d in
                                 asc.describe()["decisions"]), 30), \
            asc.describe()["decisions"]
        assert pool.size >= 2
        ups = [d for d in asc.describe()["decisions"] if d["action"] == "up"]
        assert ups[0]["slos"], "the up decision names its SLOs"
        assert _wait(lambda: pool.healthy_count == pool.size, 30)
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)

        def recovered():
            v = next((v for v in slo.verdicts()
                      if v["slo"] == "serve-p99:elastic/1"), None)
            return v is not None and v["healthy"] and not v["no_data"]

        assert _wait(recovered, 30), "the p99 verdict never recovered"
        # the pool shrinks as a drain starts, the decision lands after it
        assert _wait(lambda: any(
            d["action"] == "down" and d["size"] == 1
            for d in asc.describe()["decisions"]), 30), \
            asc.describe()["decisions"]
        assert pool.size == 1
        downs = [d for d in asc.describe()["decisions"]
                 if d["action"] == "down"]
        assert downs[-1]["reason"] == "idle"
        assert not bad, bad
        assert set(codes) <= {200, 429, 503, 504}, codes
        assert codes.get(200, 0) >= 10, codes
        code, resp = _post(url + "/v1/models/elastic:predict",
                           {"inputs": {"x": [[7.0, 7.0]]}, "timeout_ms": 5000})
        assert code == 200 and resp["outputs"][0][0] == [14.0, 14.0]
        with urllib.request.urlopen(url + "/statusz", timeout=10) as r:
            doc = json.loads(r.read())
        acts = [d["action"] for d in doc["autoscaler"]["decisions"]]
        assert "up" in acts and "down" in acts
        assert any(v["slo"] == "serve-p99:elastic/1"
                   for v in doc["slo"]["verdicts"])
        snap = telemetry.snapshot()
        assert snap['mxtpu_serve_replicas{model="elastic/1"}']["value"] == 1
        assert snap['mxtpu_autoscale_decisions_total{action="down"}'][
            "value"] >= 1
        done = [e for e in telemetry.events()
                if e["event"] == "fault_load_surge_done"
                and e["fields"]["model"] == "elastic"]
        assert done and done[-1]["fields"]["fired"] > 100
    finally:
        srv.shutdown()   # stops and joins the autoscaler too
        model.close(drain=False, timeout=0)
        monkeypatch.setattr(resilience, "_fault_cache", resilience._UNPARSED)
    assert not asc.running()
    assert not any(s.proc.alive() for s in pool._slots)


# ---------------------------------------------------------------------------
# 3. a pooled LM grown 1 -> 2, token for token against the JAX oracle
# ---------------------------------------------------------------------------

PROMPTS = [[3, 5, 7], [2], [9, 4, 6, 1, 8], [1, 2, 3, 4]]
BUDGETS = [12, 14, 10, 13]   # long enough to overlap on two replicas


def _jax_greedy(lm, prompt, n, length=24):
    """The JAX one-request greedy oracle: one whole forward a token. The
    sequence is zero-padded to ``length`` (one compiled shape); the LM is
    causal, so the padding changes no logit it reads."""
    toks, out = list(prompt), []
    for _ in range(n):
        buf = np.zeros((1, length), np.int32)
        buf[0, :len(toks)] = toks
        logits = lm(jmx.nd.array(buf, dtype="int32")).asnumpy()[0,
                                                               len(toks) - 1]
        t = int(np.argmax(logits))
        out.append(t)
        toks.append(t)
    return out


def test_pooled_lm_grows_and_replies_equal_the_jax_oracle(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("MXTPU_SLO", "0")   # the verdicts are scripted
    lm = jax_lm_mini(vocab_size=96)
    lm.initialize(jmx.init.Xavier())
    prefix = jax_save_lm(lm, str(tmp_path / "lm"))
    oracles = [_jax_greedy(lm, p, n) for p, n in zip(PROMPTS, BUDGETS)]
    repo = ModelRepository()
    with mx.context.scope(mx.cpu()):
        model = repo.load("growlm", prefix, generate=True, replicas=1,
                          min_replicas=1, max_replicas=2,
                          generate_opts=dict(num_pages=32, page_size=4,
                                             max_prompt=8, max_new_tokens=16,
                                             max_batch=2),
                          # two requests in flight a replica: of four at
                          # once, the old member cannot take them all
                          gen_outstanding=2, **POOL)
    pool = model.pool
    assert model.memory_bytes == (model.generate_info["kv_bytes"]
                                  + model.generate_info["param_bytes"])
    assert sorted(model.bucket_memory) == [1, 2]
    asc = Autoscaler(repo, up_windows=1, idle_s=3600, cooldown_s=0.0,
                     start=False)

    def replies():
        out = [None] * len(PROMPTS)

        def one(i):
            out[i] = model.generate(PROMPTS[i], max_new_tokens=BUDGETS[i],
                                    timeout_ms=60000)["tokens"]

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        return out

    try:
        assert replies() == oracles
        breach = [{"slo": "serve-p99:growlm/1", "page": True,
                   "labels": {"model": "growlm/1"}}]
        (d,) = asc.evaluate_once(verdicts=breach)
        assert (d["action"], d["size"]) == ("up", 2)
        assert model.effective_memory_bytes == 2 * model.memory_bytes
        assert _wait(lambda: pool.healthy_count == 2, 120)
        added = d["replica"]
        # its dispatch loop answers: it is in the rotation
        assert pool.replica_stats(added, timeout=30)["requests"] == 0
        assert replies() == oracles
        # the added replica took requests, and gave its KV pages back
        stats = pool.replica_stats(added, timeout=30)
        assert stats is not None and stats["requests"] >= 1, stats
        assert (stats["kv_pages_used"], stats["pending"]) == (0, 0)
        # at the ceiling the next breach is blocked
        (d,) = asc.evaluate_once(verdicts=breach)
        assert (d["action"], d["reason"]) == ("blocked", "max_replicas")
    finally:
        assert repo.unload("growlm", timeout=30)
    assert not any(s.proc.alive() for s in pool._slots)
