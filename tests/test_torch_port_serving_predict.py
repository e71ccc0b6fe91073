"""Predict serving of the PyTorch port (`DynamicBatcher`, `ServedModel`,
`ModelRepository.load`, the ``:predict`` route and ``python -m
mxnet_tpu_torch.serving``) against the JAX package's, on the CPU.

The served model is the word LM's scoring graph at vocab 50, 8 units, 2
layers and 5 steps: ``data`` (N, 5) int32 -> Embedding -> FusedRNNCell
unrolled batch-major -> FullyConnected(flatten=False) -> log_softmax ->
pick(``label``), each token's log-likelihood, with the names of
``train_lstm_bucketing.lm_sym_gen``. Its parameters are drawn from a seed
with numpy and checkpointed by each package; each package's repository
serves the other's checkpoint at max_batch 4 (buckets 1, 2, 4). The JAX
side runs its Pallas LSTM in interpret mode (``MXTPU_PALLAS_LSTM=1``, by
monkeypatch), the port the plain versions its kernel wrappers take for CPU
tensors; replies agree within rtol 1e-4 with an absolute floor of 1e-4 x
the largest magnitude (f32 on both sides, summed in other orders). The
batcher cases are those of the JAX package's tests (coalescing, never
overfilling, validation, queue-full and deadline, an expired head), and
the HTTP status codes are held to the JAX server's on the same requests.
"""
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import serving as jserving

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import (DeadlineExceededError, DrainingError,
                                     DynamicBatcher, MemoryBudgetError,
                                     ModelRepository, QueueFullError,
                                     ServedModel, ServingServer,
                                     power_of_two_buckets)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
VOCAB, UNITS, LAYERS, SEQ = 50, 8, 2, 5
LM_SHAPES = {"data": (SEQ,), "label": (SEQ,)}
LM_DTYPES = {"data": "int32", "label": "int32"}


@pytest.fixture(autouse=True)
def no_jax_slo(monkeypatch):
    # the JAX batcher would start the JAX package's SLO evaluator thread,
    # which outlives the test
    monkeypatch.setenv("MXTPU_SLO", "0")


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    floor = TOL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=floor, err_msg=what)


def score_graph(m):
    """The word LM's scoring graph in package ``m``."""
    with m.name.NameManager():
        embed = m.sym.Embedding(m.sym.var("data"), input_dim=VOCAB,
                                output_dim=UNITS, name="embed")
        cell = m.rnn.FusedRNNCell(UNITS, num_layers=LAYERS, mode="lstm",
                                  prefix="lstm_")
        out, _ = cell.unroll(SEQ, inputs=embed, layout="NTC",
                             merge_outputs=True)
        pred = m.sym.FullyConnected(out, num_hidden=VOCAB, flatten=False,
                                    name="pred")
        return m.sym.pick(m.sym.log_softmax(pred, axis=-1),
                          m.sym.var("label"), axis=-1)


@pytest.fixture(scope="module")
def lm_artifacts(tmp_path_factory):
    """The scoring LM checkpointed by each package with the same values:
    {"jax": prefix, "port": prefix}."""
    tsym, jsym = score_graph(mx), score_graph(jmx)
    assert tsym.list_arguments() == jsym.list_arguments() == [
        "data", "embed_weight", "lstm_parameters", "pred_weight",
        "pred_bias", "label"]
    shapes = tsym.infer_shape(data=(1, SEQ), label=(1, SEQ))[0]
    rng = np.random.RandomState(0)
    params = {k: (rng.randn(*s) * 0.4).astype(np.float32)
              for k, s in zip(tsym.list_arguments(), shapes)
              if k not in LM_SHAPES}
    d = tmp_path_factory.mktemp("lm")
    prefixes = {"jax": str(d / "jax"), "port": str(d / "port")}
    jmx.model.save_checkpoint(prefixes["jax"], 0, jsym,
                              {k: jmx.nd.array(v) for k, v in params.items()},
                              {})
    with mx.context.scope(mx.cpu()):
        mx.model.save_checkpoint(prefixes["port"], 0, tsym,
                                 {k: mx.nd.array(v)
                                  for k, v in params.items()}, {})
    return prefixes


def _sentences(seed, n):
    rng = np.random.RandomState(seed)
    return {"data": rng.randint(0, VOCAB, (n, SEQ)).astype(np.int32),
            "label": rng.randint(0, VOCAB, (n, SEQ)).astype(np.int32)}


# ---------------------------------------------------------------------------
# the batcher (the JAX package's tests/test_serving.py cases)
# ---------------------------------------------------------------------------

def test_batcher_coalesces_pads_and_splits_as_jax_does():
    """Three requests of 1, 2 and 3 examples submitted together coalesce
    into one bucket-8 dispatch in both packages' batchers, and each comes
    back with its own rows."""
    results = {}
    for pkg, cls in (("jax", jserving.DynamicBatcher),
                     ("port", DynamicBatcher)):
        calls = []

        def runner(arrays, bucket, n):
            calls.append((bucket, n, arrays["x"].shape[0]))
            return [arrays["x"] * 2.0,
                    arrays["x"].sum(axis=1, keepdims=True)]

        b = cls(runner, power_of_two_buckets(8), max_delay_ms=50,
                queue_depth=64, name="unit-%s" % pkg)
        try:
            reqs = [b.submit({"x": np.full((i + 1, 2), float(i))},
                             deadline=time.monotonic() + 5)
                    for i in range(3)]
            outs = [r.wait(5) for r in reqs]
            results[pkg] = (calls, outs, reqs[0].bucket)
        finally:
            b.close()
    calls, outs, bucket = results["port"]
    assert calls == results["jax"][0] == [(8, 6, 8)]
    assert bucket == results["jax"][2] == 8
    for i, (o, jo) in enumerate(zip(outs, results["jax"][1])):
        assert o[0].shape == (i + 1, 2) and np.all(o[0] == 2.0 * i)
        assert o[1].shape == (i + 1, 1) and np.all(o[1] == 2.0 * i)
        for a, ja in zip(o, jo):
            np.testing.assert_array_equal(a, ja)
    snap = telemetry.snapshot()
    assert snap['mxtpu_serve_batches_total{model="unit-port"}'][
        "value"] == 1
    assert snap['mxtpu_serve_examples_total{model="unit-port"}'][
        "value"] == 6


def test_batcher_never_overfills_max_batch():
    sizes = []

    def runner(arrays, bucket, n):
        sizes.append((bucket, n))
        return [arrays["x"]]

    b = DynamicBatcher(runner, power_of_two_buckets(4), max_delay_ms=20,
                       queue_depth=64, name="unit2")
    reqs = [b.submit({"x": np.zeros((3, 1), np.float32)}) for _ in range(3)]
    for r in reqs:
        r.wait(5)
    b.close()
    # 3 + 3 > 4 and requests are never split: each dispatches alone
    assert sizes == [(4, 3)] * 3, sizes


def test_batcher_input_validation_and_unported_hooks():
    b = DynamicBatcher(lambda a, bkt, n: [a["x"]], [1, 2], max_delay_ms=1,
                       queue_depth=4, name="unit3")
    try:
        with pytest.raises(MXNetError, match="1..2"):
            b.submit({"x": np.zeros((3, 1))})
        with pytest.raises(MXNetError, match="inconsistent"):
            b.submit({"x": np.zeros((1, 1)), "y": np.zeros((2, 1))})
        with pytest.raises(MXNetError, match="no input"):
            b.submit({})
        # the replica pools' hooks are ported: an empty failover puts
        # nothing back
        assert b.requeue([]) == 0
    finally:
        b.close()
    with pytest.raises(DrainingError):
        b.submit({"x": np.zeros((1, 1))})
    for kw in ({"dispatcher": print}, {"admission_gate": lambda q: None}):
        DynamicBatcher(None, [1], name="unit3b", **kw).close()


def test_batcher_queue_overflow_and_deadline():
    gate = threading.Event()

    def runner(arrays, bucket, n):
        gate.wait(10)
        return [arrays["x"]]

    b = DynamicBatcher(runner, [1], max_delay_ms=1, queue_depth=2,
                       name="unit4")
    try:
        first = b.submit({"x": np.zeros((1, 1), np.float32)})
        time.sleep(0.05)  # the worker pops `first` and parks in the runner
        queued = [b.submit({"x": np.zeros((1, 1), np.float32)},
                           deadline=time.monotonic() + 0.05)
                  for _ in range(2)]
        with pytest.raises(QueueFullError):
            b.submit({"x": np.zeros((1, 1), np.float32)})
        with pytest.raises(DeadlineExceededError):
            queued[0].wait(0.2)
        gate.set()
        assert first.wait(5)[0].shape == (1, 1)
        with pytest.raises(DeadlineExceededError):
            queued[1].wait(5)   # expired in the queue: 504, never run
    finally:
        gate.set()
        b.close()


def test_batcher_expired_head_never_overfills_and_worker_survives():
    gate = threading.Event()
    sizes = []

    def runner(arrays, bucket, n):
        gate.wait(10)
        sizes.append((bucket, n))
        return [arrays["x"] * 2.0]

    b = DynamicBatcher(runner, power_of_two_buckets(4), max_delay_ms=30,
                       queue_depth=16, name="overfill")
    try:
        warm = b.submit({"x": np.zeros((1, 1), np.float32)})
        time.sleep(0.05)  # the worker parks in the gated runner
        d = b.submit({"x": np.full((1, 1), 3.0, np.float32)})
        e = b.submit({"x": np.zeros((2, 1), np.float32)},
                     deadline=time.monotonic() + 0.01)
        f = b.submit({"x": np.full((4, 1), 5.0, np.float32)})
        time.sleep(0.05)  # e's deadline passes while the worker is stuck
        gate.set()
        assert np.all(d.wait(5)[0] == 6.0)
        with pytest.raises(DeadlineExceededError):
            e.wait(5)
        assert np.all(f.wait(5)[0] == 10.0)
        warm.wait(5)
        assert all(n <= bkt <= 4 for bkt, n in sizes), sizes
        # a failing runner answers 500 and the worker lives on
        b._runner = lambda a, bkt, n: 1 / 0
        with pytest.raises(Exception, match="ZeroDivisionError"):
            b.submit({"x": np.ones((1, 1), np.float32)}).wait(5)
        b._runner = lambda a, bkt, n: [a["x"] * 2.0]
        again = b.submit({"x": np.ones((1, 1), np.float32)})
        assert np.all(again.wait(5)[0] == 2.0)
    finally:
        gate.set()
        b.close()


def test_abort_pending_resolves_stranded_requests():
    gate = threading.Event()
    b = DynamicBatcher(lambda a, bkt, n: gate.wait(10) and [a["x"]], [1],
                       max_delay_ms=1, queue_depth=4, name="abort")
    try:
        running = b.submit({"x": np.zeros((1, 1), np.float32)})
        time.sleep(0.05)
        queued = b.submit({"x": np.zeros((1, 1), np.float32)})
        assert b.pending() == 2
        assert not b.drain(timeout=0.05)
        assert b.abort_pending() == 2
        for r in (running, queued):
            with pytest.raises(DrainingError):
                r.wait(1)
    finally:
        gate.set()
        b.close(drain=False)


# ---------------------------------------------------------------------------
# the repository and the served scoring LM
# ---------------------------------------------------------------------------

def test_scoring_lm_served_in_both_packages(monkeypatch, lm_artifacts):
    """Each package's repository serves the other's checkpoint (buckets 1,
    2, 4, warmed before publishing); requests of 1 to 3 sentences (so a
    bucket pads) get the same log-likelihoods from both, and the port's
    equal its own `Predictor` at the request's batch (padded rows never
    reach a reply). The bucket clones bind one copy of the weights."""
    from mxnet_tpu_torch.predict import Predictor

    monkeypatch.setenv("MXTPU_PALLAS_LSTM", "1")
    jrepo, repo = jserving.ModelRepository(), ModelRepository()
    jmodel = jrepo.load("lm", lm_artifacts["port"], input_shapes=LM_SHAPES,
                        input_dtypes=LM_DTYPES, max_batch=4)
    model = repo.load("lm", lm_artifacts["jax"], input_shapes=LM_SHAPES,
                      input_dtypes=LM_DTYPES, max_batch=4, ctx=mx.cpu())
    try:
        assert model.buckets == jmodel.buckets == [1, 2, 4]
        assert model.warmed and model.warm_seconds > 0
        desc = repo.describe()["models"][0]
        assert desc["kind"] == "predict" and desc["inputs"]["data"] == {
            "shape": [SEQ], "dtype": "int32"}
        preds = model._runner.predictors
        proto = preds[4]
        for b in (1, 2):
            for k in ("embed_weight", "lstm_parameters", "pred_weight"):
                assert preds[b]._args[k]._data.data_ptr() == \
                    proto._args[k]._data.data_ptr()
            assert preds[b]._args["data"]._data.data_ptr() != \
                proto._args["data"]._data.data_ptr()
        for i, n in enumerate((1, 3, 2)):
            req = _sentences(10 + i, n)
            (got,) = model.predict(req)
            (want,) = jmodel.predict(req)
            assert got.shape == (n, SEQ) and got.dtype == np.float32
            _close(got, want, "request of %d sentences" % n)
            solo = Predictor(lm_artifacts["port"] + "-symbol.json",
                             lm_artifacts["port"] + "-0000.params",
                             ctx=mx.cpu(), input_dtypes=LM_DTYPES,
                             input_shapes={k: (n, SEQ) for k in LM_SHAPES})
            np.testing.assert_allclose(
                solo.forward(**req).get_output(0).asnumpy(), got,
                rtol=1e-6, atol=1e-6)
            assert (got < 0).all()
        with pytest.raises(MXNetError, match="per-example shape"):
            model.predict({"data": np.zeros((1, 4)),
                           "label": np.zeros((1, 4))})
        with pytest.raises(MXNetError, match="model inputs"):
            model.predict({"data": np.zeros((1, SEQ))})
    finally:
        assert repo.unload("lm", timeout=5.0)
        jrepo.unload("lm", timeout=5.0)
    assert repo.names() == []


def test_repository_predict_load_knobs(monkeypatch, lm_artifacts,
                                       tmp_path):
    """Versions auto-increment; the newest ``-NNNN.params`` is served; the
    autoscaling knobs land on the model; the memory budget admits what
    fits and answers 507 otherwise; the parts that are not ported raise
    naming their queue item; a failed load publishes nothing; predict-only
    knobs refuse a generate load."""
    import shutil

    prefix = str(tmp_path / "lm")
    shutil.copy(lm_artifacts["port"] + "-symbol.json",
                prefix + "-symbol.json")
    shutil.copy(lm_artifacts["port"] + "-0000.params",
                prefix + "-0003.params")
    repo = ModelRepository()
    kw = dict(input_shapes=LM_SHAPES, input_dtypes=LM_DTYPES, max_batch=2,
              device="cpu")
    try:
        a = repo.load("lm", prefix + "-symbol.json", warm=False, **kw)
        assert a.meta["param_file"].endswith("-0003.params")
        assert not a.warmed
        b = repo.load("lm", prefix, **kw)
        assert (a.version, b.version) == (1, 2)
        assert repo.get("lm").version == 2
        assert (b.min_replicas, b.max_replicas, b.pinned) == (None, None,
                                                               False)
        for bad, match in (({"heartbeat_ms": 5}, "replica pool"),
                           ({"ctx": mx.cpu()}, "not both")):
            with pytest.raises(MXNetError, match=match):
                repo.load("lm", prefix, **dict(kw, **bad))
        with pytest.raises(MXNetError, match="generate_opts"):
            repo.load("g", prefix, generate=True, input_shapes=LM_SHAPES)
        with pytest.raises(MXNetError, match="no artifact"):
            repo.load("x", str(tmp_path / "none"), **kw)
        with open(str(tmp_path / "m.mxc"), "wb") as f:
            f.write(b"MXTPUAOT1\n")
        with pytest.raises(MXNetError, match="not ported"):
            repo.load("x", str(tmp_path / "m.mxc"), **kw)
        # nothing idle past the thresholds: nothing to reclaim
        assert repo.reclaim_memory(1) == 0
        with monkeypatch.context() as mp:
            mp.setenv("MXTPU_SERVE_MEMORY_BUDGET", "1")
            with pytest.raises(MemoryBudgetError) as ei:
                repo.load("over", prefix, **kw)
            assert ei.value.status == 507
            assert ei.value.details["requested_bytes"] > 1
            mp.setenv("MXTPU_SERVE_MEMORY_BUDGET", "1G")
            c = repo.load("lm", prefix, min_replicas=1, max_replicas=2,
                          pinned=True, **kw)
            assert (c.min_replicas, c.max_replicas, c.pinned) == (1, 2, True)
            assert c.effective_memory_bytes == c.memory_bytes > 0
        assert repo.names() == ["lm"]
    finally:
        repo.drain_all(5.0)


def test_cpu_served_model_never_touches_cuda(monkeypatch, lm_artifacts):
    """Loaded on the CPU, warmed and driven from the batcher's worker
    thread (which has no device scope of its own), the model asks nothing
    of CUDA."""
    def touched(*args, **kwargs):
        raise AssertionError("a CPU-served model touched torch.cuda")

    monkeypatch.setattr(torch.cuda, "is_available", touched)
    monkeypatch.setattr(torch.cuda, "current_device", touched)
    repo = ModelRepository()
    model = repo.load("lm", lm_artifacts["port"], input_shapes=LM_SHAPES,
                      input_dtypes=LM_DTYPES, max_batch=2, device="cpu")
    try:
        (out,) = model.predict(_sentences(3, 2))
        assert out.shape == (2, SEQ) and np.isfinite(out).all()
    finally:
        repo.unload("lm", timeout=5.0)


# ---------------------------------------------------------------------------
# HTTP
# ---------------------------------------------------------------------------

def _request(url, body=None, raw=None):
    """(status, parsed JSON reply or None)."""
    data = raw if raw is not None else \
        (None if body is None else json.dumps(body).encode())
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=data),
                                    timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        e.read()
        return e.code, None


def _stub_model(pkg, gate):
    """A one-input model of each package whose runner doubles its input
    once ``gate`` is set (max_batch 1, queue depth 1)."""
    return pkg.ServedModel(
        "stub", 1, lambda a, bkt, n: gate.wait(10) and [a["x"] * 2.0], [1],
        {"x": (2,)}, max_delay_ms=1, queue_depth=1)


def _stub_codes(pkg, server_cls):
    """The status codes of the same requests to each package's server:
    a 200, malformed bodies, an unknown model, a timeout, a full queue,
    and draining."""
    gate = threading.Event()
    repo = pkg.ModelRepository()
    repo.add(_stub_model(pkg, gate))
    srv = server_cls(repo, port=0, addr="127.0.0.1").start()
    url = "http://127.0.0.1:%d/v1/models/stub:predict" % srv.port
    codes = []
    try:
        gate.set()
        codes.append(_request(url, {"instances": [[1, 2]]})[0])
        for body, raw in (({}, None), (None, b"{nope"), ([1, 2], None),
                          ({"inputs": [1]}, None),
                          ({"inputs": {"x": [[1, 2, 3]]}}, None),
                          ({"inputs": {"y": [[1, 2]]}}, None),
                          ({"inputs": {"x": [[1, 2]]}, "timeout_ms": "x"},
                           None)):
            codes.append(_request(url, body, raw)[0])
        codes.append(_request(url.replace("stub", "nope"),
                              {"instances": [[1, 2]]})[0])
        codes.append(_request(url.replace(":predict", ":generate"),
                              {"tokens": [1]})[0])
        gate.clear()
        # the worker parks on the gate; one request fills the queue
        held = [threading.Thread(target=_request, args=(
            url, {"instances": [[1, 2]], "timeout_ms": 3000}))
            for _ in range(2)]
        for t in held:
            t.start()
            time.sleep(0.2)
        codes.append(_request(url, {"instances": [[1, 2]],
                                    "timeout_ms": 3000})[0])   # 429
        codes.append(_request(url.replace("stub", "stub/versions/1"),
                              {"instances": [[1, 2]],
                               "timeout_ms": 1})[0])   # 429 or 504
        gate.set()
        for t in held:
            t.join(30)
        codes.append(_request(url, {"instances": [[1, 2]],
                                    "timeout_ms": 1e-6})[0])   # 504
        srv.drain(timeout=5.0)
        codes.append(_request(url, {"instances": [[1, 2]]})[0])   # 503
    finally:
        gate.set()
        srv.shutdown()
        repo.drain_all(5.0)
    return codes


def test_http_status_codes_match_the_jax_server():
    want = [200] + [400] * 7 + [404, 400, 429]
    port = _stub_codes(mx.serving, ServingServer)
    jax = _stub_codes(jserving, jserving.ServingServer)
    assert port[:len(want)] == want, port
    assert port[-2:] == [504, 503], port
    assert port[len(want)] in (429, 504)
    # the JAX server takes a non-number timeout_ms to a 500; the port
    # answers 400 as for the generate route's knobs
    assert jax[:7] + jax[8:] == port[:7] + port[8:], (jax, port)


def test_http_predict_round_trip(lm_artifacts):
    """``inputs`` (two inputs, so ``instances`` is refused) over HTTP with
    JSON lists of ints: the reply equals `ServedModel.predict`; the listing
    holds the model; a generate verb answers 400."""
    repo = ModelRepository()
    model = repo.load("lm", lm_artifacts["port"], input_shapes=LM_SHAPES,
                      input_dtypes=LM_DTYPES, max_batch=2, device="cpu")
    srv = ServingServer(repo, port=0, addr="127.0.0.1").start()
    base = "http://127.0.0.1:%d/v1/models" % srv.port
    try:
        req = _sentences(5, 2)
        code, reply = _request(base + "/lm:predict", {"inputs": {
            k: v.tolist() for k, v in req.items()}})
        assert code == 200 and (reply["model"], reply["version"]) == \
            ("lm", 1)
        np.testing.assert_allclose(np.asarray(reply["outputs"][0]),
                                   model.predict(req)[0], rtol=1e-6,
                                   atol=1e-6)
        assert _request(base + "/lm:predict", {"instances": [[1] * SEQ]})[
            0] == 400
        assert _request(base + "/lm:generate", {"tokens": [1]})[0] == 400
        code, listing = _request(base)
        assert code == 200 and listing["models"][0]["buckets"] == [1, 2]
    finally:
        srv.shutdown()
        repo.unload("lm", timeout=5.0)


def test_serving_module_serves_predict_and_drains_on_sigterm(lm_artifacts):
    """``python -m mxnet_tpu_torch.serving --model NAME=PREFIX@in=DIMS:dtype
    --device cpu`` serves the JAX package's checkpoint and exits 0 after a
    SIGTERM drain."""
    env = dict(os.environ, PYTHONPATH=_ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.serving", "--model",
         "lm=%s@data=%d:int32,label=%d:int32" % (lm_artifacts["jax"], SEQ,
                                                 SEQ),
         "--port", "0", "--addr", "127.0.0.1", "--device", "cpu",
         "--max-batch", "2", "--delay-ms", "1", "--queue-depth", "8"],
        env=env, stderr=subprocess.PIPE, text=True)
    try:
        port = None
        for line in proc.stderr:
            m = re.search(r"on 127\.0\.0\.1:(\d+)", line)
            if m:
                port = int(m.group(1))
                break
        assert port, "server never reported its port"
        req = _sentences(6, 1)
        code, reply = _request(
            "http://127.0.0.1:%d/v1/models/lm:predict" % port,
            {"inputs": {k: v.tolist() for k, v in req.items()}})
        assert code == 200
        out = np.asarray(reply["outputs"][0])
        assert out.shape == (1, SEQ) and (out < 0).all()
        proc.send_signal(signal.SIGTERM)
        proc.stderr.read()
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
