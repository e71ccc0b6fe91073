"""Generation serving of the PyTorch port against the JAX package (CPU).

The port's engine and the JAX package's engine decode the same prompts
with the same weights (carried by `convert.params_from_jax`); greedy
decoding is deterministic, so the token sequences must be equal. Around
the engine: the scheduler's admission errors, the HTTP surface with its
400/404 mapping, ``python -m mxnet_tpu_torch.serving`` end to end, the
rule that entry points never fall back to the CPU, and the rule that the
port imports neither JAX nor the JAX package.
"""
import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import env as jax_env
from mxnet_tpu.gluon.model_zoo.transformer import lm_mini as jax_lm_mini
from mxnet_tpu.serving import GenerateScheduler as JaxScheduler
from mxnet_tpu.serving import TransformerLMEngine as JaxEngine
from mxnet_tpu_torch import context, convert, telemetry
from mxnet_tpu_torch import env as port_env
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerLM
from mxnet_tpu_torch.serving import (DeadlineExceededError, GenerateScheduler,
                                     KVPageAllocator, ModelRepository,
                                     QueueFullError, ServedLM, ServingServer,
                                     TransformerLMEngine, save_lm)
from mxnet_tpu_torch.serving.__main__ import parse_model_spec

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOM = dict(num_pages=32, page_size=4, max_prompt=8, max_new_tokens=12,
            max_batch=4)
PROMPTS = [[3, 5, 7], [2], [9, 4, 6, 1, 8], [1, 2, 3, 4]]
BUDGETS = [5, 9, 3, 7]


@pytest.fixture(scope="module")
def jax_lm():
    lm = jax_lm_mini(vocab_size=96)
    lm.initialize(mx.init.Xavier())
    return lm


@pytest.fixture(scope="module")
def port_lm(jax_lm):
    lm = TransformerLM(**jax_lm.config)
    lm.load_state_dict(convert.params_from_jax(jax_lm.decode_params()))
    return lm.eval()


def _greedy(lm, prompt, n):
    """Full-sequence greedy oracle: one whole forward per new token."""
    toks, out = list(prompt), []
    with torch.no_grad():
        for _ in range(n):
            t = int(torch.argmax(lm(torch.tensor([toks]))[0, -1]))
            out.append(t)
            toks.append(t)
    return out


def _run_batched(sched):
    reqs = [sched.submit(p, max_new_tokens=n)
            for p, n in zip(PROMPTS, BUDGETS)]
    return [r.wait(60) for r in reqs]


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

def test_engine_greedy_matches_jax_engine_batched(monkeypatch, jax_lm,
                                                  port_lm):
    """Four prompts with unequal budgets, submitted together so they share
    decode steps: the port's tokens equal the JAX engine's, and both equal
    the port's full-sequence oracle (batch invariance)."""
    # the JAX scheduler would wire SLO objectives and start the JAX
    # package's evaluator thread, which outlives the test; a later test that
    # forks in this process must not inherit a lock that thread holds
    monkeypatch.setenv("MXTPU_SLO", "0")
    jsched = JaxScheduler(JaxEngine(lm=jax_lm, **GEOM), name="torchport-jax/1",
                          queue_depth=16)
    try:
        jax_outs = _run_batched(jsched)
    finally:
        jsched.close(drain=False, timeout=0)
    sched = GenerateScheduler(
        TransformerLMEngine(lm=port_lm, device="cpu", **GEOM),
        name="torchport/1", queue_depth=16)
    try:
        outs = _run_batched(sched)
        assert sched.allocator.used_pages == 0
    finally:
        sched.close(drain=False, timeout=0)
    assert outs == jax_outs
    assert outs == [_greedy(port_lm, p, n) for p, n in zip(PROMPTS, BUDGETS)]
    snap = telemetry.snapshot()
    steps = snap['mxtpu_serve_decode_steps_total{model="torchport/1"}']
    tokens = snap['mxtpu_serve_generated_tokens_total{model="torchport/1"}']
    assert tokens["value"] == sum(BUDGETS)
    # every token past each request's first comes from a shared decode step
    assert max(BUDGETS) - 1 <= steps["value"] <= sum(BUDGETS) - len(BUDGETS)


def test_engine_params_path_matches_lm_path(jax_lm, port_lm):
    """``params=`` + ``config=`` (the JAX ``decode_params`` dict) builds the
    same engine as ``lm=``."""
    a = TransformerLMEngine(lm=port_lm, device="cpu", **GEOM)
    b = TransformerLMEngine(params=jax_lm.decode_params(),
                            config=jax_lm.config, device="cpu", **GEOM)
    row = np.arange(a.max_pages_per_seq, dtype=np.int32)
    toks = [eng.prefill([4, 8, 15], row, (0.0, 0, 1.0), None)
            for eng in (a, b)]
    assert toks[0] == toks[1]
    assert torch.equal(a._kv, b._kv)
    assert a.geometry()["param_bytes"] == b.geometry()["param_bytes"]


def test_decode_padding_row_writes_nothing(port_lm):
    """A padding row (destination page ``num_pages``, length 0) is dropped
    from the in-place K/V write, as JAX's ``mode="drop"``; the live row
    writes exactly its one slot in every layer."""
    eng = TransformerLMEngine(lm=port_lm, device="cpu", **GEOM)
    before = eng._kv.clone()
    maxp = eng.max_pages_per_seq
    tables = np.zeros((2, maxp), np.int32)
    tables[0, 0] = 5
    out = eng.decode_step(
        np.asarray([7, 0], np.int32), np.asarray([2, 0], np.int32),
        np.asarray([5, eng.num_pages], np.int32),
        np.asarray([2, 0], np.int32), tables, np.asarray([3, 0], np.int32),
        np.zeros(2, np.float32), np.zeros(2, np.int32),
        np.ones(2, np.float32), None)
    assert out.dtype == np.int32 and out.shape == (2,)
    changed = (eng._kv != before).any(dim=(1, 3, 5))   # (layers, pages, ps)
    expect = torch.zeros_like(changed)
    expect[:, 5, 2] = True
    assert torch.equal(changed, expect)


def test_bf16_kv_engine_samples_within_top_k(port_lm):
    sched = GenerateScheduler(
        TransformerLMEngine(lm=port_lm, device="cpu", kv_dtype="bfloat16",
                            **GEOM),
        name="torchport-bf16/1", queue_depth=16)
    try:
        greedy = sched.submit([5, 6], max_new_tokens=6)
        sampled = sched.submit([5, 6], max_new_tokens=6, temperature=0.8,
                               top_k=4)
        assert len(greedy.wait(60)) == 6
        out = sampled.wait(60)
        assert len(out) == 6 and all(0 <= t < 96 for t in out)
        assert sched.allocator.used_pages == 0
    finally:
        sched.close(drain=False, timeout=0)
    with pytest.raises(MXNetError):
        TransformerLMEngine(lm=port_lm, device="cpu", kv_dtype="float16",
                            **GEOM)


# ---------------------------------------------------------------------------
# scheduler units (stub engine)
# ---------------------------------------------------------------------------

class _StubEngine:
    buckets = [1, 2]
    num_pages, page_size, max_pages_per_seq = 8, 4, 4
    max_prompt, max_new_tokens, vocab_size, eos_id = 8, 8, 16, None
    device = torch.device("cpu")

    def __init__(self, delay):
        self.delay = delay

    def warm(self):
        return 0.0

    def prefill(self, tokens, page_row, sampling, generator):
        time.sleep(self.delay)
        return 1

    def decode_step(self, tokens, *args):
        time.sleep(self.delay)
        return np.full(len(tokens), 2, np.int32)


def test_kv_allocator_grants_and_double_free():
    a = KVPageAllocator(8, 4, name="torchport-alloc/1")
    assert a.pages_for(1) == 1 and a.pages_for(5) == 2
    g1, g2 = a.alloc(3), a.alloc(5)
    assert not set(g1) & set(g2) and a.free_pages == 0
    assert a.alloc(1) is None
    a.free(g1)
    with pytest.raises(MXNetError):
        a.free(g1)
    assert set(a.alloc(2)) <= set(g1)


def test_scheduler_queue_full_and_deadline():
    sched = GenerateScheduler(_StubEngine(0.1), name="torchport-stub/1",
                              queue_depth=1)
    try:
        with pytest.raises(MXNetError):
            sched.submit([99])                    # out of vocabulary
        with pytest.raises(MXNetError):
            sched.submit([1], max_new_tokens=9)   # over the cap
        late = sched.submit([1], max_new_tokens=8,
                            deadline=time.monotonic() + 0.05)
        rejected = 0
        for _ in range(4):
            try:
                sched.submit([1, 2], max_new_tokens=2)
            except QueueFullError:
                rejected += 1
        assert rejected >= 1
        with pytest.raises(DeadlineExceededError):
            late.wait(30)
    finally:
        sched.close(drain=False, timeout=0)
    assert sched.allocator.used_pages == 0


# ---------------------------------------------------------------------------
# HTTP, the command line, and devices
# ---------------------------------------------------------------------------

def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _code(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=data),
                                    timeout=30) as r:
            r.read()
            return r.status
    except urllib.error.HTTPError as e:
        e.read()
        return e.code


def test_http_generate_round_trip_and_errors(port_lm, tmp_path):
    prefix = save_lm(port_lm, str(tmp_path / "lm"))
    repo = ModelRepository()
    repo.load("lm", prefix, generate=True, generate_opts=GEOM, device="cpu")
    srv = ServingServer(repo, port=0, addr="127.0.0.1").start()
    base = "http://127.0.0.1:%d" % srv.port
    url = base + "/v1/models/lm:generate"
    try:
        resp = _post(url, {"tokens": [3, 1, 4], "max_new_tokens": 6,
                           "timeout_ms": 60000})
        assert resp["tokens"] == _greedy(port_lm, [3, 1, 4], 6)
        assert resp["num_generated"] == 6
        assert resp["finish_reason"] == "length"
        assert (resp["model"], resp["version"]) == ("lm", 1)
        desc = json.loads(urllib.request.urlopen(base + "/v1/models",
                                                 timeout=30).read())
        (model,) = desc["models"]
        assert model["kind"] == "generate" and model["kv"]["pages_used"] == 0
        assert model["generate"]["device"] == "cpu"
        assert _code(base + "/healthz") == 200
        # malformed bodies are the client's fault: 400, not 500
        for bad in ({"tokens": "abc"}, {"tokens": []},
                    {"tokens": [1], "max_new_tokens": 0},
                    {"tokens": [1], "max_new_tokens": "abc"},
                    {"tokens": [1], "temperature": []}, {}):
            assert _code(url, bad) == 400, bad
        assert _code(base + "/v1/models/nope:generate", {"tokens": [1]}) == 404
        assert _code(base + "/v1/models/lm:predict", {"data": [1]}) == 400
    finally:
        srv.shutdown()
        assert repo.unload("lm", timeout=5.0)


def test_serving_module_serves_and_drains_on_sigterm(port_lm, tmp_path):
    """``python -m mxnet_tpu_torch.serving`` loads an artifact, answers a
    request, and exits 0 after a SIGTERM drain."""
    prefix = save_lm(port_lm, str(tmp_path / "lm"))
    env = dict(os.environ, PYTHONPATH=_ROOT, MXTPU_SERVE_KV_PAGES="32",
               MXTPU_SERVE_KV_PAGE_SIZE="4", MXTPU_SERVE_MAX_PROMPT="8",
               MXTPU_SERVE_MAX_NEW_TOKENS="12", MXTPU_SERVE_MAX_BATCH="4")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mxnet_tpu_torch.serving", "--model",
         "lm=%s@generate" % prefix, "--port", "0", "--addr", "127.0.0.1",
         "--device", "cpu"],
        env=env, stderr=subprocess.PIPE, text=True)
    try:
        port = None
        for line in proc.stderr:
            m = re.search(r"on 127\.0\.0\.1:(\d+)", line)
            if m:
                port = int(m.group(1))
                break
        assert port, "server never reported its port"
        resp = _post("http://127.0.0.1:%d/v1/models/lm:generate" % port,
                     {"tokens": [2, 7], "max_new_tokens": 4})
        assert resp["tokens"] == _greedy(port_lm, [2, 7], 4)
        proc.send_signal(signal.SIGTERM)
        proc.stderr.read()
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()


def test_model_spec_parsing():
    """``@generate`` specs and the predict specs of ``tools/serve.py``
    (``in=DIMS[:dtype]``, 'x'-separated, per example) parse; compiled
    artifacts are refused."""
    assert parse_model_spec("lm=/m/lm@generate") == \
        ("lm", "/m/lm", "generate", None)
    assert parse_model_spec("mlp=/m/mlp@data=8") == \
        ("mlp", "/m/mlp", {"data": (8,)}, None)
    assert parse_model_spec("rn=/m/rn@data=3x32x32") == \
        ("rn", "/m/rn", {"data": (3, 32, 32)}, None)
    assert parse_model_spec("lm=/m/lm@data=35:int32,label=35:int32") == \
        ("lm", "/m/lm", {"data": (35,), "label": (35,)},
         {"data": "int32", "label": "int32"})
    for bad in ("lm", "lm=/m/lm", "lm=/m/lm@data=1,3", "lm=/m/lm.mxc"):
        with pytest.raises(ValueError):
            parse_model_spec(bad)


def test_entry_points_raise_without_a_card(monkeypatch, port_lm, tmp_path):
    """Entry points default to the card and raise without one; they never
    run on the CPU unless asked to: generation and predict loads alike."""
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.predict import Predictor

    clf = str(tmp_path / "clf")
    with tmx.context.scope(tmx.cpu()):
        fc = tmx.sym.FullyConnected(tmx.sym.var("data"), num_hidden=3,
                                    name="fc")
        tmx.model.save_checkpoint(clf, 0, fc,
                                  {"fc_weight": tmx.nd.zeros((3, 4)),
                                   "fc_bias": tmx.nd.zeros((3,))}, {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prefix = save_lm(port_lm, str(tmp_path / "lm"))
    with pytest.raises(MXNetError, match="no CUDA device"):
        context.resolve_device()
    with pytest.raises(MXNetError, match="no CUDA device"):
        TransformerLMEngine(lm=port_lm, **GEOM)
    with pytest.raises(MXNetError, match="no CUDA device"):
        ServedLM.load("lm", 1, prefix, **GEOM)
    repo = ModelRepository()
    with pytest.raises(MXNetError, match="no CUDA device"):
        repo.load("lm", prefix, generate=True, generate_opts=GEOM)
    with pytest.raises(MXNetError, match="no CUDA device"):
        repo.load("clf", clf, input_shapes={"data": (4,)}, max_batch=2)
    with pytest.raises(MXNetError, match="no CUDA device"):
        Predictor(clf + "-symbol.json", clf + "-0000.params",
                  input_shapes={"data": (1, 4)})
    assert repo.names() == []
    assert context.resolve_device("cpu") == torch.device("cpu")


# ---------------------------------------------------------------------------
# the package's boundaries
# ---------------------------------------------------------------------------

_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|mxnet_tpu)(\.|\s|$)",
                        re.M)


def test_port_imports_neither_jax_nor_the_jax_package():
    files = [os.path.join(_ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(_ROOT, "mxnet_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    offenders = []
    for path in files:
        with open(path) as f:
            offenders += ["%s: %s" % (path, m.group(0).strip())
                          for m in _FORBIDDEN.finditer(f.read())]
    assert len(files) > 15 and offenders == []


@pytest.mark.parametrize("name", port_env.names())
def test_env_registry_matches_jax_package(name):
    """Same names and defaults as the JAX package's registry; and no kernel
    gate that could send a CUDA tensor to the plain version. The one
    exception is the ResNet zoo's graph switch: the JAX default `auto`
    picks a lowering the port does not have, and the port's default is
    unset, which builds the reference graph in both zoos (held in
    `test_torch_port_resnet.py`)."""
    ref = jax_env.registry()[name]
    var = port_env.registry()[name]
    assert var.vtype == ref.vtype
    if name == "MXTPU_PALLAS_CONV_EPILOGUE":
        assert var.default == ""
    else:
        assert var.default == ref.default
    assert "MXTPU_PALLAS_DECODE" not in port_env.names()
